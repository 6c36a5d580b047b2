"""Seconds of `setup.build` of the service that served the window: its
model and backbone built on the host, weights converted and loaded, the
move to the card."""

from benchmark.core import spans


def read(run):
    s = spans.setup_spans(run, "setup.build")
    return sum(s) if s else None
