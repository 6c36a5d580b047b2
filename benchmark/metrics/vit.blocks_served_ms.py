"""p50 over the window's requests of `device.vit_blocks`: the served
graph's mark after the ViTPose's patch embedding to its mark after the
last block (image graphs of a ViTPose only)."""

from benchmark.core import intervals


def read(run):
    return intervals.device_p50(run, "device.vit_blocks")
