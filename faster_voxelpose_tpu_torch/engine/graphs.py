"""CUDA-graph capture shared by the engine's compiled steps: the service's
batch-1 forwards (`engine/service.py`), the trainer's step
(`engine/trainer.py`) and the validator's eval step
(`engine/validator.py`).  The counterpart of the JAX package's
`jax.jit`: a step is captured once and each later call replays it, so
the host issues one graph launch in place of the step's kernels.

- `run_on(stream, fn)`: an eager call on a side stream, joined back to
  the caller's stream (PyTorch's recipe warms a step up there, so that
  cuDNN, cuBLAS and the caching allocator settle outside the graph).
- `capture(fn, stream)`: fn() captured into a CUDA graph; the kernel
  wrappers' launch counts taken during the capture, where nothing ran,
  are taken back and kept as what one replay launches.
- `GraphedStep`: a step of static-shape tensor inputs that runs eagerly
  on a side stream for its first calls, is then captured once, and is
  replayed on every later call with its inputs copied into the graph's
  static inputs.

Nothing here falls back to eager: a capture that fails raises, and
leaves the process as it was before the capture (`abandon_capture`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

import torch

from ..ops import sampling_kernels as sk

# eager calls on the capture's stream before a capture, so that cuDNN and
# cuBLAS choose their algorithms and workspaces outside the graph
CAPTURE_WARMUP = 3


class Captured(NamedTuple):
    """A captured graph, the outputs its replays overwrite, and the
    kernel launches of one replay."""

    graph: "torch.cuda.CUDAGraph"
    outputs: Any
    launches: Dict[str, int]


def _mode(inference: bool):
    return torch.inference_mode() if inference else contextlib.nullcontext()


def run_on(stream: "torch.cuda.Stream", fn: Callable[[], Any], inference: bool = False) -> Any:
    """fn() on `stream`, ordered after the caller's stream's work and
    before its later work."""
    caller = torch.cuda.current_stream(stream.device)
    stream.wait_stream(caller)
    with torch.cuda.stream(stream), _mode(inference):
        out = fn()
    caller.wait_stream(stream)
    return out


def capture(fn: Callable[[], Any], stream: "torch.cuda.Stream",
            inference: bool = False) -> Captured:
    """fn() captured into a CUDA graph on `stream` (a memory pool of its
    own, so that graphs replay in any order).  Raises what the capture
    raises, e.g. for a host synchronisation or a copy from pageable host
    memory inside fn, after `abandon_capture` has put PyTorch's state
    back.  Only this thread's calls are held to the capture's rules
    ("thread_local"): a `prefetch_to_device` thread may pin host memory
    and upload the next batch meanwhile."""
    graph = torch.cuda.CUDAGraph()
    pool = torch.cuda.graph_pool_handle()
    before = sk.launch_counts()
    ended = False
    try:
        # the outer stream context restores the caller's stream even when
        # a failed capture leaves torch.cuda.graph's unrestored
        with torch.cuda.stream(stream), _mode(inference), \
                torch.cuda.graph(graph, pool=pool, stream=stream,
                                 capture_error_mode="thread_local"):
            outputs = fn()
        ended = True
    finally:
        launched = {k: n - before[k] for k, n in sk.launch_counts().items() if n != before[k]}
        sk.add_launches({k: -n for k, n in launched.items()})
        if not ended:
            abandon_capture(pool, stream.device)
    return Captured(graph, outputs, launched)


def abandon_capture(pool, device: torch.device) -> bool:
    """Undo what a capture into `pool` that never ended leaves behind.

    When a capture is invalidated (a host synchronisation inside it),
    `CUDAGraph.capture_end` raises before it ends PyTorch's side of the
    capture (PyTorch 2.11): the caching allocator keeps routing the
    capture stream's allocations into the pool and, while it counts a
    capture underway, `empty_cache` gives back none of its cached blocks;
    and the device's default generator stays in capture mode, so that
    every later random op on the device raises "Offset increment outside
    graph capture".  This ends the allocation to the pool, releases the
    pool and gives the generator a fresh copy of its state (seed and
    offset kept).  Returns False, and touches nothing, where the capture
    did end (fn raised without invalidating it)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    try:
        torch._C._cuda_endAllocateToPool(index, pool)
    except RuntimeError:  # not allocating to the pool: the capture ended
        return False
    torch._C._cuda_releasePool(index, pool)
    gen = torch.cuda.default_generators[index]
    gen.graphsafe_set_state(gen.clone_state())
    return True


def replay(captured: Captured) -> Any:
    """Replay a captured graph on the caller's stream; its launches are
    counted as the wrappers would count them."""
    captured.graph.replay()
    sk.add_launches(captured.launches)
    return captured.outputs


class GraphedStep:
    """A step `fn(inputs)` over a dict of static-shape tensors, compiled on
    the card: the first CAPTURE_WARMUP calls run eagerly on a side stream
    (real calls whose results are returned), the next one captures fn on
    static copies of its inputs and replays the graph, and every later
    call copies its inputs into those static tensors and replays.  The
    outputs are the graph's static tensors: the next call overwrites
    them.  Inputs of other keys, shapes or dtypes than the captured ones
    raise ValueError.  `fn` is passed at each call and never kept, so a
    step held by the object whose method it captures makes no reference
    cycle, and the graph's memory is freed with its owner."""

    def __init__(self, device: torch.device, inference: bool = False):
        if torch.device(device).type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        self.inference = inference
        self.stream = torch.cuda.Stream(device)
        self.calls = 0
        self.static: Optional[Dict[str, torch.Tensor]] = None
        self.captured: Optional[Captured] = None

    def __call__(self, fn: Callable[[Mapping[str, torch.Tensor]], Any],
                 inputs: Mapping[str, torch.Tensor]) -> Any:
        self.calls += 1
        if self.calls <= CAPTURE_WARMUP:
            return run_on(self.stream, lambda: fn(inputs), self.inference)
        if self.captured is None:
            self.static = {k: v.detach().clone() for k, v in inputs.items()}
            self.captured = capture(lambda: fn(self.static), self.stream, self.inference)
        else:
            self._copy_in(inputs)
        return replay(self.captured)

    def _copy_in(self, inputs: Mapping[str, torch.Tensor]) -> None:
        if inputs.keys() != self.static.keys():
            raise ValueError(f"inputs {sorted(inputs)} differ from the captured "
                             f"{sorted(self.static)}")
        for k, v in inputs.items():
            s = self.static[k]
            if v.shape != s.shape or v.dtype != s.dtype:
                raise ValueError(f"{k}: {tuple(v.shape)} {v.dtype} does not fit the graph's "
                                 f"{tuple(s.shape)} {s.dtype}")
            s.copy_(v, non_blocking=True)
