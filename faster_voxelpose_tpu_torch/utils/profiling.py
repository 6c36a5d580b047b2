"""Profiling and tracing hooks (the port's counterpart of
`faster_voxelpose_tpu/utils/profiling.py`).

- `trace(log_dir)`: a `torch.profiler` trace of the host and, on the
  card, the device, written into log_dir for TensorBoard or Perfetto.
- `StepTimer`: per-step host dispatch time, host wall time to the step's
  end, and on the card the device time between two CUDA events recorded
  around the step on the current stream.
- `SPANS`, the process's span log (`SpanLog`): each served request's host
  stamps, device intervals and counters in a ring of preallocated
  arrays, and the set-up spans of each service.  It outlives the
  service that wrote it.  While `torch.profiler` records, each span is
  also a `record_function` range of the same name, on the profiler's
  clock beside the kernels.
- `GraphMarks`, `marking`, `mark`: CUDA events recorded inside a captured
  graph at its start, after named stages and at its end.  `mark(name)`
  is a no-op except inside `marking(marks)`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
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


# -- the span log -------------------------------------------------------

# A request's six host stamps (time.perf_counter_ns) bound its span and
# its five contiguous children: stamp 0 opens `service.request` and
# `service.input`, stamp k closes child k and opens child k + 1, stamp 5
# closes `service.decode` and the request.
REQUEST_SPANS = ("service.request", "service.input", "service.upload", "service.launch",
                 "service.wait", "service.decode")
# device intervals of a request served by a captured graph, ms (CUDA
# events); NaN where not measured.  The ViT's two (a ViTPose backbone's
# blocks, and its last norm and head) come after the first five, whose
# columns keep their places, and VoxelPose's two after them (its graph's
# start to its proposals: whole-space sampling, CPN, NMS and top K; then
# on to its end: cube sampling, PRN over the K slots, soft-argmax), and
# MvP's two after those (the backbone's end to its values: rays, RayConv,
# value projection; then on to the end: queries, decoder, heads)
DEVICE_INTERVALS = ("device.upload", "device.launch_gap", "device.backbone", "device.hdn",
                    "device.jln", "device.vit_blocks", "device.vit_head", "device.cpn",
                    "device.prn", "device.mvp_values", "device.mvp_decoder")
COUNTERS = ("jln.slots", "jln.people")
CAPACITY = 65536  # requests kept (the ring's bound)
SETUP_CAPACITY = 4096  # set-up spans kept
SWITCH = "FASTER_VOXELPOSE_SPANS"  # "0" in the environment starts the log off


def profiler_enabled() -> bool:
    """Whether a torch.profiler (or autograd profiler) is recording."""
    return torch.autograd._profiler_enabled()


def _enter(name: str):
    r = torch.profiler.record_function(name)
    r.__enter__()
    return r


class RequestSpans:
    """The stamps of one request in flight (`SpanLog.request`), used as a
    context: `next()` closes the current child span and opens the next;
    `close()` takes the last stamp and writes the request into the log;
    `device(ms)` then adds its device intervals.  Leaving the context
    ends the profiler ranges a request that raised left open."""

    __slots__ = ("log", "stamps", "ranges", "row", "id")
    timed = True

    def __init__(self, log: "SpanLog"):
        self.log = log
        self.ranges = None
        if profiler_enabled():
            self.ranges = [_enter(REQUEST_SPANS[0]), _enter(REQUEST_SPANS[1])]
        self.stamps = [time.perf_counter_ns()]

    def __enter__(self) -> "RequestSpans":
        return self

    def __exit__(self, *exc) -> None:
        self._end_ranges()

    def _end_ranges(self) -> None:
        if self.ranges is not None:
            for r in reversed(self.ranges):
                r.__exit__(None, None, None)
            self.ranges = None

    def next(self) -> None:
        self.stamps.append(time.perf_counter_ns())
        if self.ranges is not None:
            self.ranges.pop().__exit__(None, None, None)
            self.ranges.append(_enter(REQUEST_SPANS[len(self.stamps)]))

    def close(self, owner: int, counters: Sequence[int]) -> None:
        self.stamps.append(time.perf_counter_ns())
        self._end_ranges()
        self.row, self.id = self.log.write_request(owner, self.stamps, counters)

    def device(self, values: Sequence[float]) -> None:
        """The request's DEVICE_INTERVALS (ms), once it is closed."""
        self.log.write_device_ms(self.row, self.id, values)

    def ms(self) -> float:
        return (self.stamps[-1] - self.stamps[0]) * 1e-6


class Untimed:
    """A request that is not logged (the log switched off, or a call
    that is not a request): no stamps, the wall time from creation to
    `close` alone."""

    __slots__ = ("t0", "t1")
    timed = False

    def __init__(self):
        self.t0 = self.t1 = time.perf_counter()

    def __enter__(self) -> "Untimed":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def next(self) -> None:
        pass

    def close(self, owner: int, counters: Sequence[int]) -> None:
        self.t1 = time.perf_counter()

    def device(self, values: Sequence[float]) -> None:
        pass

    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


class SpanLog:
    """One process's spans: a ring of the last `capacity` requests in
    preallocated arrays (an id, the service that answered it, its six
    host stamps, its device intervals and its counters), and a ring of
    set-up spans (an id, its parent's id or -1, name, label, service,
    start and end).  Request span ids: the request's id, its children
    id + 1 .. id + 5.  Ids are unique in the process.

    `enabled` is the one switch: off, requests stamp nothing and set-up
    spans and graph marks are not recorded.  It starts on unless the
    environment sets FASTER_VOXELPOSE_SPANS=0."""

    SETUP_FIELDS = ("id", "parent", "name", "label", "owner", "start_ns", "end_ns")

    def __init__(self, capacity: int = CAPACITY, setup_capacity: int = SETUP_CAPACITY):
        self.enabled = os.environ.get(SWITCH, "1") != "0"
        self.capacity = capacity
        # per request: id, owner, the six stamps, the counters
        self.rows = np.zeros((capacity, 2 + len(REQUEST_SPANS) + len(COUNTERS)), np.int64)
        self.device_ms = np.zeros((capacity, len(DEVICE_INTERVALS)), np.float64)
        self.written = 0
        self.setup_capacity = setup_capacity
        self.setup_cols = np.zeros((setup_capacity, len(self.SETUP_FIELDS)), np.int64)
        self.setup_written = 0
        self.names: List[str] = []  # set-up names and labels, by index
        self._next_id = 1
        self._owners = itertools.count(1)
        self._lock = threading.Lock()
        self._open = threading.local()  # the thread's open set-up spans

    def new_owner(self) -> int:
        """An id for a service's requests and set-up spans."""
        return next(self._owners)

    def request(self):
        """A request's spans, opened now (`RequestSpans`), or `Untimed`
        with the log off."""
        return RequestSpans(self) if self.enabled else Untimed()

    def write_request(self, owner: int, stamps: Sequence[int],
                      counters: Sequence[int]) -> tuple:
        """A request's row (its device intervals NaN); returns (row, id)."""
        with self._lock:
            rid = self._next_id
            self._next_id += len(REQUEST_SPANS)
            i = self.written % self.capacity
            self.written += 1
        self.rows[i] = (rid, owner, *stamps, *counters)
        self.device_ms[i] = np.nan
        return i, rid

    def write_device_ms(self, row: int, rid: int, values: Sequence[float]) -> None:
        """The first len(values) device intervals of request `rid` (the
        rest stay NaN), unless the ring has overwritten its row since."""
        if self.rows[row, 0] == rid:
            self.device_ms[row, :len(values)] = values

    def _name(self, name: Optional[str]) -> int:
        if name is None:
            return -1
        with self._lock:
            if name not in self.names:
                self.names.append(name)
            return self.names.index(name)

    @contextlib.contextmanager
    def span(self, name: str, owner: Optional[int] = None,
             label: Optional[str] = None) -> Iterator[None]:
        """A set-up span around the block: its parent is the innermost
        set-up span open in this thread, and its service that parent's
        where `owner` is not given.  Nothing is recorded with the log
        off."""
        if not self.enabled:
            yield
            return
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        parent, parent_owner = stack[-1] if stack else (-1, 0)
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        owner = parent_owner if owner is None else owner
        rng = _enter(name) if profiler_enabled() else None
        stack.append((sid, owner))
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            end = time.perf_counter_ns()
            stack.pop()
            if rng is not None:
                rng.__exit__(None, None, None)
            row = (sid, parent, self._name(name), self._name(label), owner, start, end)
            with self._lock:
                i = self.setup_written % self.setup_capacity
                self.setup_written += 1
            self.setup_cols[i] = row

    def _order(self, written: int, capacity: int) -> np.ndarray:
        if written <= capacity:
            return np.arange(written)
        return (written + np.arange(capacity)) % capacity

    def requests(self, owner: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Copies of the kept requests, oldest first (of one service where
        `owner` is given): "id", "owner", "stamps_ns" (n, 6), "device_ms"
        (n, 11), "counters" (n, 2)."""
        order = self._order(self.written, self.capacity)
        if owner is not None:
            order = order[self.rows[order, 1] == owner]
        rows, n = self.rows[order], len(REQUEST_SPANS)
        return {"id": rows[:, 0], "owner": rows[:, 1], "stamps_ns": rows[:, 2:2 + n],
                "device_ms": self.device_ms[order], "counters": rows[:, 2 + n:]}

    def setup_spans(self, owner: Optional[int] = None) -> List[dict]:
        """The kept set-up spans, oldest first: dicts of SETUP_FIELDS, the
        name and label as strings (label None where not given)."""
        out = []
        for i in self._order(self.setup_written, self.setup_capacity):
            row = dict(zip(self.SETUP_FIELDS, (int(v) for v in self.setup_cols[i])))
            if owner is not None and row["owner"] != owner:
                continue
            row["name"] = self.names[row["name"]]
            row["label"] = self.names[row["label"]] if row["label"] >= 0 else None
            out.append(row)
        return out

    def spans(self, owner: Optional[int] = None) -> List[tuple]:
        """Every kept span as (id, parent id or -1, name, start_ns,
        end_ns): each request's parent and five children, then the
        set-up spans."""
        out = []
        r = self.requests(owner)
        for rid, st in zip(r["id"].tolist(), r["stamps_ns"].tolist()):
            out.append((rid, -1, REQUEST_SPANS[0], st[0], st[-1]))
            out += [(rid + k, rid, REQUEST_SPANS[k], st[k - 1], st[k])
                    for k in range(1, len(REQUEST_SPANS))]
        out += [(s["id"], s["parent"], s["name"], s["start_ns"], s["end_ns"])
                for s in self.setup_spans(owner)]
        return out


SPANS = SpanLog()


def durations_ms(stamps_ns: np.ndarray) -> Dict[str, np.ndarray]:
    """Each request span's duration, ms, from (n, 6) stamps."""
    st = np.asarray(stamps_ns, np.int64)
    out = {REQUEST_SPANS[0]: (st[:, -1] - st[:, 0]) * 1e-6}
    for k in range(1, len(REQUEST_SPANS)):
        out[REQUEST_SPANS[k]] = (st[:, k] - st[:, k - 1]) * 1e-6
    return out


def summary(log: SpanLog, owner: Optional[int] = None) -> dict:
    """count, p50 and p95 (ms) of each request span and device interval,
    the counters' totals and the set-up spans (s) of one service."""
    r = log.requests(owner)

    def stats(v):
        v = v[np.isfinite(v)]
        if not v.size:
            return {"count": 0}
        return {"count": int(v.size), "p50_ms": round(float(np.percentile(v, 50)), 4),
                "p95_ms": round(float(np.percentile(v, 95)), 4)}

    return {
        "requests": int(r["id"].size),
        "spans": {k: stats(v) for k, v in durations_ms(r["stamps_ns"]).items()},
        "device": {k: stats(r["device_ms"][:, j]) for j, k in enumerate(DEVICE_INTERVALS)},
        "counters": {k: int(r["counters"][:, j].sum()) for j, k in enumerate(COUNTERS)},
        "setup": [{"name": s["name"], "label": s["label"],
                   "s": round((s["end_ns"] - s["start_ns"]) * 1e-9, 6)}
                  for s in log.setup_spans(owner)],
    }


# -- marks inside a captured graph ---------------------------------------

_capture = threading.local()  # .marks: the GraphMarks of a capture underway


class GraphMarks:
    """The CUDA events of one captured graph: `upload`, two ordinary
    events the caller records around the copy into the graph's input,
    and the graph's marks, external events captured into the graph (its
    start, the stages named by `mark` calls, its end).  `read()`, once
    the replay's output has reached the host, gives the device
    intervals.  Reading them costs tens of microseconds on the host, so
    a request reads them only where `sampled()` says so: the graph's
    first request and every EVERY-th after it."""

    EVERY = 16
    STAGES = ("start", "backbone", "hdn", "end")
    VIT_STAGES = ("vit_patch", "vit_blocks", "backbone")  # a ViTPose backbone's marks
    VOXELPOSE_STAGES = ("start", "cpn", "end")  # a VoxelPose graph's marks
    MVP_STAGES = ("start", "backbone", "values", "end")  # an MvP graph's marks

    def __init__(self):
        self.upload = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        self.events: Dict[str, torch.cuda.Event] = {}  # in the order recorded
        self.requests = 0

    def record(self, name: str) -> None:
        e = self.events.get(name)
        if e is None:
            e = self.events[name] = torch.cuda.Event(enable_timing=True, external=True)
        e.record()

    def sampled(self) -> bool:
        """Whether this request of the graph reads its device intervals."""
        self.requests += 1
        return self.requests % self.EVERY == 1

    def read(self) -> List[float]:
        """ms of DEVICE_INTERVALS: the upload, the upload's end to the
        graph's start, then start -> backbone -> hdn -> end (NaN where the
        graph has no such mark: the backbone of a heatmaps graph); where
        the graph holds a ViT's marks, vit_patch -> vit_blocks -> backbone
        after them, which a graph without them does not read.  A VoxelPose
        graph (its "cpn" mark) reads NaN for the stages it lacks and
        start -> cpn -> end as `device.cpn` and `device.prn`; an MvP graph
        (its "values" mark) start -> backbone as `device.backbone`, NaN for
        the other stages it lacks, and backbone -> values -> end as the
        last two."""
        ev, (a, b) = self.events, self.upload
        start, nan = ev.get("start"), float("nan")
        out = [a.elapsed_time(b), b.elapsed_time(start) if start is not None else nan]
        if "cpn" in ev:
            first, cpn, end = (ev[n] for n in self.VOXELPOSE_STAGES)
            return out + [nan] * 5 + [first.elapsed_time(cpn), cpn.elapsed_time(end), nan, nan]
        if "values" in ev:
            first, backbone, values, end = (ev[n] for n in self.MVP_STAGES)
            return out + [first.elapsed_time(backbone)] + [nan] * 6 + [
                backbone.elapsed_time(values), values.elapsed_time(end)]
        prev = start
        for name in self.STAGES[1:]:
            e = ev.get(name)
            out.append(prev.elapsed_time(e) if e is not None and prev is not None else nan)
            prev = e if e is not None else prev
        if self.VIT_STAGES[0] in ev:
            patch, blocks, end = (ev[n] for n in self.VIT_STAGES)
            out += [patch.elapsed_time(blocks), blocks.elapsed_time(end)]
        return out


@contextlib.contextmanager
def marking(marks: Optional[GraphMarks]) -> Iterator[None]:
    """`mark` records into `marks` inside the block, in this thread (a
    no-op block where marks is None)."""
    _capture.marks = marks
    try:
        yield
    finally:
        _capture.marks = None


def mark(name: str) -> None:
    """Record the mark `name` into the graph being captured under
    `marking`; nothing elsewhere."""
    marks = getattr(_capture, "marks", None)
    if marks is not None:
        marks.record(name)
