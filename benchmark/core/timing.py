"""Device time of one stage of the program, captured alone in a CUDA
graph and replayed between two CUDA events."""

from __future__ import annotations

from typing import Callable

import torch


def graph_ms(fn: Callable[[], object], replays: int = 20, reps: int = 5) -> float:
    """ms per call of fn(): 3 eager calls on a side stream, one capture,
    then `reps` timings of `replays` back-to-back replays; the least."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.inference_mode():
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode(), torch.cuda.graph(graph):
        fn()
    best = float("inf")
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(replays):
            graph.replay()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / replays)
    del graph
    return best
