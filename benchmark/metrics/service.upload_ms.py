"""p50 over the window's requests of `device.upload`: CUDA events around
the copy of the request's input into the served graph's input."""

from benchmark.core import spans


def read(run):
    return spans.device_p50(run, "device.upload")
