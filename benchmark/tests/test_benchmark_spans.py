"""The readers of the program's span log (`core/spans.py` and the nine
metrics on it): each reads the timed window's requests alone, never the
warm requests before it or a traced segment after it, and the set-up
spans of the service that served the window; each returns None where
the log has nothing for the window, or the program has no log."""

import numpy as np
import pytest

from benchmark.core import spans
from benchmark.core.record import Request, Run
from benchmark.core.spec import load_cell

READERS = ("service.host_ms", "service.upload_ms", "service.launch_gap_ms",
           "backbone.served_ms", "hdn.served_ms", "jln.served_ms", "jln.slot_use",
           "setup.build_s", "setup.capture_s")
SERVICE, OTHER = 7, 8


@pytest.fixture
def profiling():
    from faster_voxelpose_tpu_torch.utils import profiling

    return profiling


@pytest.fixture
def readers():
    cell = load_cell("panoptic_jln64.images.live")
    m = {x.name: x.reader for x in cell.metrics}
    assert set(READERS) <= set(m)
    return m


def _request(log, t_s, children_ms, device_ms, people, owner=SERVICE, slots=10):
    """One request at t_s seconds with the child spans' ms (input,
    upload, launch, wait, decode), its device intervals and counters."""
    t0 = int(t_s * 1e9)
    stamps = [t0] + [t0 + int(round(c * 1e6)) for c in np.cumsum(children_ms)]
    row, rid = log.write_request(owner, stamps, (slots, people))
    log.write_device_ms(row, rid, device_ms)


def _segment(log, t_s, n, scale, rng):
    """n requests from t_s on, 10 ms apart; their values drawn around
    `scale`.  Returns the per-request values written."""
    out = []
    for i in range(n):
        children = rng.uniform(0.5, 1.5, 5) * scale
        device = rng.uniform(0.5, 1.5, 5) * scale
        people = int(rng.randint(0, 11))
        _request(log, t_s + 0.01 * i, children, device, people)
        out.append((children, device, people))
    return out


@pytest.fixture
def logged(profiling, monkeypatch):
    """A log with 9 warm requests at 1 s, 7 in the window at 2 s and 12
    traced at 4 s (values 100 times the window's), the set-up spans of
    the window's service and of another; and the run of that window."""
    log = profiling.SpanLog(capacity=64, setup_capacity=16)
    log.enabled = True
    monkeypatch.setattr(profiling, "SPANS", log)
    rng = np.random.RandomState(0)
    with log.span("setup.build", owner=OTHER):
        pass
    with log.span("setup.build", owner=SERVICE):
        pass
    with log.span("setup.capture", owner=SERVICE, label="images_u8"):
        with log.span("setup.kernels", label="sampling"):
            pass
    _segment(log, 1.0, 9, 100.0, rng)
    window = _segment(log, 2.0, 7, 1.0, rng)
    _segment(log, 4.0, 12, 100.0, rng)
    run = Run("x", 1.0)
    # the client's clock: entered just before each call, done just after
    run.requests = [Request(2.0 + 0.01 * i - 1e-4, 2.0 + 0.01 * i - 5e-5,
                            2.0 + 0.01 * i + 0.009, 0, True) for i in range(7)]
    return log, run, window


def test_each_reader_reads_the_window_alone(logged, readers):
    log, run, window = logged
    children = np.array([c for c, _, _ in window])
    device = np.array([d for _, d, _ in window])
    people = sum(p for _, _, p in window)
    want = {
        "service.host_ms": np.percentile(children[:, [0, 2, 4]].sum(1), 50),
        "service.upload_ms": np.percentile(device[:, 0], 50),
        "service.launch_gap_ms": np.percentile(device[:, 1], 50),
        "backbone.served_ms": np.percentile(device[:, 2], 50),
        "hdn.served_ms": np.percentile(device[:, 3], 50),
        "jln.served_ms": np.percentile(device[:, 4], 50),
        "jln.slot_use": people / 70.0,
    }
    for name, value in want.items():
        assert readers[name].read(run) == pytest.approx(value, rel=1e-6, abs=1e-6), name
    setup = {(s["name"], s["owner"]): (s["end_ns"] - s["start_ns"]) * 1e-9
             for s in log.setup_spans()}
    assert readers["setup.build_s"].read(run) == pytest.approx(setup["setup.build", SERVICE])
    assert readers["setup.capture_s"].read(run) == pytest.approx(setup["setup.capture", SERVICE])
    assert spans.window(run)["stamps_ns"].shape == (7, 6)


def test_stages_missing_from_the_log_read_none(logged, readers, profiling):
    """A heatmaps graph has no backbone mark (NaN), an eager request no
    device interval: their readers give None, the others still read."""
    log, run, _ = logged
    log.device_ms[:] = np.nan
    for name in ("service.upload_ms", "service.launch_gap_ms", "backbone.served_ms",
                 "hdn.served_ms", "jln.served_ms"):
        assert readers[name].read(run) is None, name
    assert readers["service.host_ms"].read(run) is not None


@pytest.mark.parametrize("case", ["empty log", "no window", "window outside the log",
                                  "no log in the program"])
def test_nothing_to_read_gives_none(case, profiling, monkeypatch, readers):
    log = profiling.SpanLog(capacity=8, setup_capacity=4)
    monkeypatch.setattr(profiling, "SPANS", log)
    run = Run("x", 1.0)
    run.requests = [Request(2.0, 2.0, 2.5, 0, True)]
    if case == "no window":
        run.requests = []
    if case == "window outside the log":
        _request(log, 1.0, [1.0] * 5, [1.0] * 5, 3)
        with log.span("setup.build", owner=SERVICE):
            pass
    if case == "no log in the program":
        _request(log, 2.1, [1.0] * 5, [1.0] * 5, 3)
        monkeypatch.delattr(profiling, "SPANS")
    for name in READERS:
        assert readers[name].read(run) is None, (case, name)


def test_the_benchmark_names_match_the_programs(profiling):
    """The column names the readers index by are the program's."""
    assert spans.STAMPS == profiling.REQUEST_SPANS
    assert spans.DEVICE == profiling.DEVICE_INTERVALS
    assert spans.COUNTERS == profiling.COUNTERS
