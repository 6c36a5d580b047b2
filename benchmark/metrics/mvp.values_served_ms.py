"""p50 over the window's requests of `device.mvp_values`: the MvP graph's
mark after the backbone to its mark after the values (the feature
pixels' rays, RayConv and the value projection of the three levels)."""

from benchmark.core import intervals


def read(run):
    return intervals.device_p50(run, "device.mvp_values")
