"""p50 over the window's requests of `device.cpn`: the VoxelPose graph's
start to its mark after the proposals (whole-space sampling in the
bounded mode, the CPN's V2VNet, NMS and top K)."""

from benchmark.core import intervals


def read(run):
    return intervals.device_p50(run, "device.cpn")
