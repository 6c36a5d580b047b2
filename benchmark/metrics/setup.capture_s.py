"""Seconds of `setup.capture` of the service that served the window: the
capture of the cell's graph with its eager forwards before it (the
first also loads the port's CUDA library, `setup.kernels`)."""

from benchmark.core import spans


def read(run):
    s = spans.setup_spans(run, "setup.capture")
    return sum(s) if s else None
