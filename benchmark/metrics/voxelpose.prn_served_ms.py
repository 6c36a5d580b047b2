"""p50 over the window's requests of `device.prn`: the VoxelPose graph's
mark after the proposals to its end (the K cubes sampled, the PRN's
V2VNet over every slot, soft-argmax)."""

from benchmark.core import intervals


def read(run):
    return intervals.device_p50(run, "device.prn")
