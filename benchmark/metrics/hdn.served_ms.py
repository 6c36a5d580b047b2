"""p50 over the window's requests of `device.hdn`: the served graph's
mark before the whole-space projection (its start, or after the
backbone) to its mark after the HDN's proposals."""

from benchmark.core import spans


def read(run):
    return spans.device_p50(run, "device.hdn")
