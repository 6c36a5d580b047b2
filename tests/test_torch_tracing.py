"""The port's span log (`utils/profiling.py`) and the spans `PoseService`
writes into it: the request's five child spans partition it exactly,
ids and parents, the ring's bound, the switch, the spans as profiler
ranges, `trace_summary` and the server's `trace` command.  CPU tests on
a tiny geometry (the eager path); the tests marked `cuda` hold the
marks captured into the served graph on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py

This file imports no JAX.
"""

import json

import numpy as np
import pytest
import torch

from faster_voxelpose_tpu_torch.utils import profiling
from test_torch_cuda import _tiny_frames, _tiny_service, _train_setup, tiny_cfg


@pytest.fixture
def log(monkeypatch):
    """A fresh span log in place of the process's."""
    fresh = profiling.SpanLog(capacity=64, setup_capacity=16)
    fresh.enabled = True
    monkeypatch.setattr(profiling, "SPANS", fresh)
    return fresh


def _cpu_service(**kw):
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.geometry import dome_rig

    cfg = tiny_cfg()
    cfg.RESNET.NUM_LAYERS = 18
    rig = dome_rig(1, 3, space_center=cfg.CAPTURE_SPEC.SPACE_CENTER)[0]
    return PoseService(cfg, rig=rig, device="cpu", **kw)


def _requests(svc, kind, n=3):
    if kind == "heatmaps":
        return [svc.infer_heatmaps(f) for f in _tiny_frames(n)]
    rng = np.random.RandomState(0)
    return [svc.infer_images(rng.randint(0, 256, (3, 128, 160, 3)).astype(np.uint8))
            for _ in range(n)]


@pytest.mark.parametrize("kind", ["heatmaps", "images"])
def test_children_partition_the_request(log, kind):
    """Six stamps a request: the five child spans are contiguous, start
    where the request starts and end where it ends; `latency_ms` is the
    request span (decode included); the counters are K slots and the
    people answered; the eager path has no device intervals."""
    svc = _cpu_service()
    answers = _requests(svc, kind)
    r = log.requests()
    assert r["id"].size == 3 and set(r["owner"].tolist()) == {svc._owner}
    st = r["stamps_ns"]
    assert np.all(np.diff(st, axis=1) >= 0)
    d = profiling.durations_ms(st)
    children = sum(d[n] for n in profiling.REQUEST_SPANS[1:])
    assert np.array_equal(np.round(children * 1e6).astype(np.int64), st[:, -1] - st[:, 0])
    for rid, a, row in zip(r["id"].tolist(), answers, st):
        spans = [s for s in log.spans() if s[0] == rid or s[1] == rid]
        parent, kids = spans[0], spans[1:]
        assert parent[2] == "service.request" and [k[2] for k in kids] == list(
            profiling.REQUEST_SPANS[1:])
        assert kids[0][3] == parent[3] and kids[-1][4] == parent[4]
        assert all(a_[4] == b_[3] for a_, b_ in zip(kids, kids[1:]))
        assert a["latency_ms"] == round((row[-1] - row[0]) * 1e-6, 3)
    K = svc.cfg.CAPTURE_SPEC.MAX_PEOPLE
    assert r["counters"][:, 0].tolist() == [K] * 3
    assert r["counters"][:, 1].tolist() == [a["n_people"] for a in answers]
    assert np.isnan(r["device_ms"]).all()


def test_latency_ends_after_decode(log, monkeypatch):
    """`latency_ms`, p50 and p95 end where the request span ends: after
    the poses are decoded."""
    import time

    from faster_voxelpose_tpu_torch.engine import PoseService

    decode = PoseService._decode
    monkeypatch.setattr(PoseService, "_decode",
                        staticmethod(lambda f: time.sleep(0.03) or decode(f)))
    svc = _cpu_service()
    a = _requests(svc, "heatmaps", 1)[0]
    decode_ms = profiling.durations_ms(log.requests()["stamps_ns"])["service.decode"]
    assert decode_ms[0] >= 30.0 and a["latency_ms"] >= 30.0
    assert svc.stats()["p50_ms"] == round(a["latency_ms"], 3)


def test_ids_unique_and_parents(log):
    """Request, child and set-up span ids are unique in the log; each
    child's parent is its request; a set-up span's parent is the span
    open around it, whose service it inherits."""
    svc = _cpu_service()
    svc.warmup()
    _requests(svc, "heatmaps", 2)
    with log.span("outer", owner=99):
        with log.span("inner", label="x"):
            pass
    spans = log.spans()
    ids = [s[0] for s in spans]
    assert len(ids) == len(set(ids)) == 2 * 6 + 5  # the set-up spans with the fusion's fold
    by_id = {s[0]: s for s in spans}
    for s in spans:
        if s[2].startswith("service.") and s[2] != "service.request":
            assert by_id[s[1]][2] == "service.request" and s[0] - s[1] in range(1, 6)
    setup = {s["name"]: s for s in log.setup_spans()}
    assert setup["setup.build"]["parent"] == setup["setup.capture"]["parent"] == -1
    assert setup["setup.build"]["owner"] == setup["setup.capture"]["owner"] == svc._owner
    assert setup["setup.capture"]["label"] == "heatmaps"
    assert setup["inner"]["parent"] == setup["outer"]["id"]
    assert setup["inner"]["owner"] == 99 and setup["inner"]["label"] == "x"
    assert all(s["end_ns"] >= s["start_ns"] for s in setup.values())


def test_ring_keeps_its_bound():
    """The request ring keeps the last `capacity` requests, oldest first;
    the set-up ring its last spans."""
    log = profiling.SpanLog(capacity=8, setup_capacity=4)
    ids = []
    for i in range(20):
        req = profiling.RequestSpans(log)
        for _ in range(4):
            req.next()
        req.close(owner=1, counters=(10, i))
        ids.append(req.id)
    r = log.requests()
    assert log.written == 20 and r["id"].tolist() == ids[-8:]
    assert r["counters"][:, 1].tolist() == list(range(12, 20))
    assert log.rows.shape == (8, 10)
    assert log.device_ms.shape == (8, len(profiling.DEVICE_INTERVALS))
    for i in range(6):
        with log.span(f"s{i}"):
            pass
    assert [s["name"] for s in log.setup_spans()] == ["s2", "s3", "s4", "s5"]
    # a row the ring overwrote takes no late device intervals
    log.write_device_ms(req.row, ids[0], [1.0] * 5)
    assert np.isnan(log.requests()["device_ms"]).all()
    req.device([1.0, 2.0, 3.0, 4.0, 5.0])  # a graph without a ViT's marks: the first five
    last = log.requests()["device_ms"][-1]
    assert last[:5].tolist() == [1.0, 2.0, 3.0, 4.0, 5.0] and np.isnan(last[5:]).all()


def test_kernel_load_is_a_child_set_up_span(log, tmp_path, monkeypatch):
    """The CUDA library's first load (a stand-in compiler and loader) is
    `setup.kernels`, a child of the set-up span open around it, of that
    span's service; a second load is cached and records nothing."""
    from faster_voxelpose_tpu_torch.ops import cuda_build as cb

    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done; touch \"$2\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(cb, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cb, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(cb.ctypes, "CDLL", lambda path: ("lib", path))
    cb.load.cache_clear()
    try:
        with log.span("setup.capture", owner=5, label="heatmaps"):
            cb.load("sampling")
        cb.load("sampling")
    finally:
        cb.load.cache_clear()
    inner, outer = log.setup_spans()  # written as each ends
    assert inner["name"] == "setup.kernels" and inner["label"] == "sampling"
    assert inner["parent"] == outer["id"] and inner["owner"] == outer["owner"] == 5
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= outer["end_ns"]


def test_switch_off_records_nothing(log):
    """With the log off, neither construction, warmup nor requests write
    a span; answers keep their latency and `stats` its request count."""
    log.enabled = False
    svc = _cpu_service()
    svc.warmup()
    answers = _requests(svc, "heatmaps", 2)
    assert log.written == 0 and log.setup_written == 0 and log.spans() == []
    assert all(a["latency_ms"] > 0 for a in answers)
    assert svc.stats() == {"requests": 2, "random_init": True, "backbone_random_init": True,
                           "backbone_folded": False, "fusion_folded": True}


def test_switch_reads_the_environment(monkeypatch):
    monkeypatch.setenv(profiling.SWITCH, "0")
    assert not profiling.SpanLog(capacity=2).enabled
    monkeypatch.setenv(profiling.SWITCH, "1")
    assert profiling.SpanLog(capacity=2).enabled


def test_spans_are_profiler_ranges(log, tmp_path, monkeypatch):
    """Under torch.profiler each span is a `user_annotation` event of the
    same name in the Chrome trace, the children inside their request;
    with no profiler no record_function is entered."""
    entered = []
    record_function = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or record_function(name))
    svc = _cpu_service()
    svc.warmup()
    _requests(svc, "heatmaps", 2)
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _requests(svc, "heatmaps", 1)
        with log.span("setup.test"):
            pass
    assert entered == list(profiling.REQUEST_SPANS) + ["setup.test"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    names = [e["name"] for e in events]
    assert sorted(names) == sorted(list(profiling.REQUEST_SPANS) + ["setup.test"])
    req = next(e for e in events if e["name"] == "service.request")
    for e in events:
        if e["name"] in profiling.REQUEST_SPANS[1:]:
            assert req["ts"] <= e["ts"] and e["ts"] + e["dur"] <= req["ts"] + req["dur"]


def test_a_request_that_raises_closes_its_ranges(log):
    """A bad input raises out of the request and leaves no profiler
    range open and no request in the log."""
    svc = _cpu_service()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="images of shape"):
            svc.infer_images(np.zeros((2, 128, 160, 3), np.uint8))
        _requests(svc, "heatmaps", 1)
    assert log.requests()["id"].size == 1


def test_trace_summary_and_the_serve_command(log):
    """`trace_summary` gives count / p50 / p95 of each span and device
    interval, the counters' totals and the set-up spans, as JSON; the
    server's `trace` command answers with it."""
    from faster_voxelpose_tpu_torch.tools import serve

    svc = _cpu_service()
    svc.warmup()
    answers = _requests(svc, "heatmaps", 3)
    s = svc.trace_summary()
    assert set(s) == {"requests", "spans", "device", "counters", "setup"}
    assert s["requests"] == 3
    assert list(s["spans"]) == list(profiling.REQUEST_SPANS)
    assert all(v["count"] == 3 and v["p95_ms"] >= v["p50_ms"] >= 0 for v in s["spans"].values())
    assert list(s["device"]) == list(profiling.DEVICE_INTERVALS)
    assert all(v == {"count": 0} for v in s["device"].values())
    assert s["counters"] == {"jln.slots": 12, "jln.people": sum(a["n_people"] for a in answers)}
    assert [x["name"] for x in s["setup"]] == ["setup.build", "setup.fold", "setup.capture"]
    assert s["spans"]["service.request"]["p50_ms"] == pytest.approx(svc.stats()["p50_ms"],
                                                                    abs=1e-3)
    assert serve.handle(svc, {"cmd": "trace"}) == s
    json.dumps(s)
    other = _cpu_service()  # another service's summary holds its own spans only
    assert other.trace_summary()["requests"] == 0


def test_stats_with_no_requests(log):
    svc = _cpu_service()
    assert svc.stats() == {"requests": 0, "random_init": True, "backbone_random_init": True,
                           "backbone_folded": False, "fusion_folded": False}


class _FakeEvent:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


@pytest.mark.parametrize("stages, want", [
    (("start", "backbone", "hdn", "end"), [0.25, 0.25, 11.0, 1.5, 2.5]),
    (("start", "hdn", "end"), [0.25, 0.25, float("nan"), 1.5, 2.5]),
])
def test_graph_marks_read_the_intervals(stages, want):
    """Upload, launch gap, then the stages between consecutive marks; the
    backbone NaN in a graph with no backbone mark; the graph's first
    request and every EVERY-th after it read them."""
    times = {"start": 1.25, "backbone": 12.25, "hdn": 13.75, "end": 16.25}
    marks = profiling.GraphMarks.__new__(profiling.GraphMarks)
    marks.upload = (_FakeEvent(0.75), _FakeEvent(1.0))
    if "backbone" not in stages:
        times["start"] = 12.25
        marks.upload = (_FakeEvent(11.75), _FakeEvent(12.0))
    marks.events = {n: _FakeEvent(times[n]) for n in stages}
    np.testing.assert_allclose(marks.read(), want, atol=1e-12)
    marks.requests = 0
    every = profiling.GraphMarks.EVERY
    picks = [i for i in range(3 * every) if marks.sampled()]
    assert picks == [0, every, 2 * every]


def test_mark_records_only_under_marking():
    """`mark` is a no-op outside `marking`, and inside it records into the
    marks given; the block's end clears them, also when it raises."""
    class Marks:
        def __init__(self):
            self.names = []

        def record(self, name):
            self.names.append(name)

    m = Marks()
    profiling.mark("hdn")
    with profiling.marking(m):
        profiling.mark("start")
        profiling.mark("hdn")
    profiling.mark("end")
    with pytest.raises(RuntimeError):
        with profiling.marking(m):
            raise RuntimeError
    profiling.mark("end")
    assert m.names == ["start", "hdn"]
    with profiling.marking(None):
        profiling.mark("start")


# -- on the card -------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graph marks are CUDA events")
    from faster_voxelpose_tpu_torch.device import pin_float32

    pin_float32()
    return torch.device("cuda")


@pytest.mark.cuda
def test_marks_cover_the_served_graph(dev, log):
    """The served graph's first mark to its last is within 5% of the same
    replay timed by two ordinary events around it; the stages sum to
    that interval; a served request logs every device interval (the
    backbone only for an image graph)."""
    from faster_voxelpose_tpu_torch.engine import graphs

    svc = _tiny_service(dev)
    svc.warmup(("heatmaps", "images_u8"))
    g = svc._compiled["heatmaps"]
    assert list(g.marks.events) == ["start", "hdn", "end"]
    assert list(svc._compiled["images_u8"].marks.events) == ["start", "backbone", "hdn", "end"]
    inner, outer = [], []
    for _ in range(10):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graphs.replay(g.captured)
        b.record()
        torch.cuda.synchronize()
        ev = g.marks.events
        inner.append(ev["start"].elapsed_time(ev["end"]))
        outer.append(a.elapsed_time(b))
        parts = ev["start"].elapsed_time(ev["hdn"]) + ev["hdn"].elapsed_time(ev["end"])
        assert parts == pytest.approx(inner[-1], rel=1e-3, abs=2e-3)
    assert abs(np.median(inner) - np.median(outer)) <= 0.05 * np.median(outer), (inner, outer)
    svc.infer_heatmaps(_tiny_frames(1)[0])
    frames = np.random.RandomState(0).randint(0, 256, (3, 128, 160, 3)).astype(np.uint8)
    svc.infer_images(frames)
    d = log.requests()["device_ms"]
    assert np.isnan(d[0, 2]) and np.isfinite(np.delete(d[0, :5], 2)).all()
    assert np.isfinite(d[1, :5]).all() and (d[1, :5] >= 0).all()
    assert np.isnan(d[:, 5:]).all()  # a Pose-ResNet's graphs hold no ViT marks


@pytest.mark.cuda
def test_marks_leave_the_poses_bit_identical(dev, log):
    """A heatmaps graph captured with marks answers bit for bit as one
    captured with the log off, which holds no marks.  The image graph is
    not bit for bit even against itself (one graph replayed twice on the
    same frames parts by 1.2e-4 mm on an H100, two services by 2.4e-4):
    marked and plain are held within 1e-3 mm there."""
    log.enabled = False
    plain = _tiny_service(dev)
    plain.warmup(("images_u8",))
    log.enabled = True
    marked = _tiny_service(dev)
    marked.warmup(("images_u8",))
    assert plain._compiled["heatmaps"].marks is None
    assert marked._compiled["heatmaps"].marks is not None
    rng = np.random.RandomState(1)
    frames = rng.randint(0, 256, (2, 3, 128, 160, 3)).astype(np.uint8)
    for hm in _tiny_frames(3):
        assert marked.infer_heatmaps(hm)["poses_mm"] == plain.infer_heatmaps(hm)["poses_mm"]
    for f in frames:
        a, b = (np.asarray(s.infer_images(f)["poses_mm"]) for s in (marked, plain))
        assert a.shape == b.shape and float(np.abs(a - b).max()) <= 1e-3


@pytest.mark.cuda
def test_trainer_graph_records_no_marks(dev, log, monkeypatch):
    """A trainer's `GraphedStep` captures the model's forward with no
    mark: no event is recorded, and its graph launches what it launched
    before, the whole-space sampler once and the crop sampler once per
    sample."""
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer

    recorded = []
    monkeypatch.setattr(profiling.GraphMarks, "record", lambda self, n: recorded.append(n))
    cfg, model, batches = _train_setup(dev, 5)
    tr = Trainer(cfg, model())
    for b in batches:
        tr.step(b)
    assert tr._graph.captured is not None
    assert tr._graph.captured.launches == {"sample_whole_projected": 1, "sample_crop_planes": 2}
    assert recorded == []
