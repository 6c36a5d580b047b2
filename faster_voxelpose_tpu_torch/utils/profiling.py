"""Profiling and tracing hooks (the port's counterpart of
`faster_voxelpose_tpu/utils/profiling.py`).

- `trace(log_dir)`: a `torch.profiler` trace of the host and, on the
  card, the device, written into log_dir for TensorBoard or Perfetto.
- `StepTimer`: per-step host dispatch time, host wall time to the step's
  end, and on the card the device time between two CUDA events recorded
  around the step on the current stream.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler trace into log_dir (no-op when None)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class _StepHandle:
    """Mutable handle yielded by StepTimer.step: the caller deposits the
    step's result, a tensor, inside the context."""

    def __init__(self):
        self.result: Any = None

    def set(self, result) -> None:
        self.result = result


class StepTimer:
    """Tracks per-step host time and the step's time to completion.

    host_s counts only the dispatch section (everything inside the
    context); wall_s additionally waits for the device to finish the
    step.  On a CUDA device (the deposited result's, else the current
    one) two events around the step give device_ms, the card's time
    from the step's first work to its last.  Keep host-side fetches
    (`.cpu()`) outside the context, or host and wall time collapse."""

    def __init__(self):
        self.host_s = 0.0
        self.wall_s = 0.0
        self.device_ms = 0.0
        self.steps = 0
        self.device_steps = 0

    @contextlib.contextmanager
    def step(self) -> Iterator[_StepHandle]:
        handle = _StepHandle()
        cuda = torch.cuda.is_available()
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        yield handle
        t1 = time.perf_counter()
        on_card = cuda and isinstance(handle.result, torch.Tensor) and handle.result.is_cuda
        if on_card:
            end.record()
            end.synchronize()
            self.device_ms += start.elapsed_time(end)
            self.device_steps += 1
        self.host_s += t1 - t0
        self.wall_s += time.perf_counter() - t0
        self.steps += 1

    def summary(self) -> str:
        if not self.steps:
            return "no steps"
        out = (f"{self.steps} steps: host {self.host_s / self.steps * 1e3:.1f} ms/step, "
               f"host+device {self.wall_s / self.steps * 1e3:.1f} ms/step")
        if self.device_steps:
            out += f", device {self.device_ms / self.device_steps:.3f} ms/step (CUDA events)"
        return out
