"""p50 over the window's requests of `device.mvp_decoder`: the MvP graph's
mark after the values to its end (the queries, the decoder layers with
their projective attention, the refinement and the class head)."""

from benchmark.core import intervals


def read(run):
    return intervals.device_p50(run, "device.mvp_decoder")
