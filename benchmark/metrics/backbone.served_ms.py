"""p50 over the window's requests of `device.backbone`: the served
graph's start mark to its mark after `images_to_heatmaps` (image graphs
only)."""

from benchmark.core import spans


def read(run):
    return spans.device_p50(run, "device.backbone")
