"""p50 over the window's requests of `device.vit_head`: the served
graph's mark after the ViTPose's last block to its mark after
`images_to_heatmaps` (`last_norm`, the head, the float32 cast)."""

from benchmark.core import intervals


def read(run):
    return intervals.device_p50(run, "device.vit_head")
