"""The metric arithmetic: percentiles over all requests, the interval
union of a small synthetic trace, and the FLOP and byte counts against
counts taken by hand or from the reference's own calls."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.core import trace
from benchmark.core.compare import MISS_MM, compare_answer, summarize
from benchmark.core.record import Request, Run
from benchmark.core.spec import load_cell
from benchmark.counts import flops, kernels
from benchmark.tests.tiny import tiny_cell


def _run(latencies_ms, waits_ms):
    r = Run("x", 1.0)
    r.requests = [Request(0.0, w * 1e-3, l * 1e-3, 0, True)
                  for l, w in zip(latencies_ms, waits_ms)]
    return r


def test_latency_metrics_take_every_request():
    cell = load_cell("shelf_jln64.heatmaps.live")
    m = {x.name: x.reader for x in cell.metrics}
    lat = np.arange(1, 101, dtype=float)
    run = _run(lat, lat / 10)
    assert m["latency_p50_ms"].read(run) == pytest.approx(np.percentile(lat, 50))
    assert m["latency_p95_ms"].read(run) == pytest.approx(np.percentile(lat, 95))
    assert m["service.queue_wait_p95_ms"].read(run) == pytest.approx(np.percentile(lat / 10, 95))
    assert m["latency_p95_ms"].read(_run([], [])) is None


def test_interval_union_and_request_busy_share():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.REQUEST_SPAN, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": trace.REQUEST_SPAN, "ts": 200, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 20, "dur": 30},  # overlaps a
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 90, "dur": 20},  # crosses the end
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 250, "dur": 25},
        {"ph": "X", "cat": "cpu_op", "name": "host", "ts": 50, "dur": 40},
    ]
    r = trace.analyze(ev)
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert r["busy_s"] == pytest.approx((40 + 20 + 25) * 1e-6)
    assert r["window_s"] == pytest.approx(300e-6)
    assert r["request_busy_share"] == pytest.approx([0.5, 0.25])
    assert r["total_s"]["a"] == pytest.approx(55e-6) and r["count"]["a"] == 2
    assert r["idle_gaps"][0][0] == "(none)" and r["idle_gaps"][0][1] == pytest.approx(140e-6)
    assert r["idle_gaps"][1] == ["host", pytest.approx(40e-6)]


class _Counter:
    """MACs of every conv, transposed conv and dense call."""

    def __init__(self, monkeypatch):
        self.macs = 0
        for name in ("conv1d", "conv2d", "conv_transpose1d", "conv_transpose2d", "linear"):
            monkeypatch.setattr(F, name, self._wrap(getattr(F, name), name))

    def _wrap(self, fn, name):
        def call(x, w, *a, **k):
            y = fn(x, w, *a, **k)
            if name == "linear":
                self.macs += y.numel() * w.shape[1]
            elif name.startswith("conv_transpose"):
                self.macs += x.numel() * w.shape[1] * int(np.prod(w.shape[2:]))
            else:
                self.macs += y.numel() * w.shape[1] * int(np.prod(w.shape[2:]))
            return y
        return call


def test_fusion_macs_match_the_reference_calls(monkeypatch):
    from benchmark.drivers.live_service import load_arrays
    from benchmark.reference.fusion import FusionReference, Geometry
    from benchmark.traffic.rig import make_rig

    cell = tiny_cell("shelf_jln64.heatmaps.live")
    y = cell.config["yaml"]
    g = Geometry.from_config(y)
    ref = FusionReference(g, load_arrays(cell.root_weights), "cpu")
    count = _Counter(monkeypatch)
    rig = make_rig(3, 4500.0, 2200.0, (450.0, -320.0), (1032, 776))
    ref(torch.rand(3, 16, 32, 17), torch.as_tensor(rig))
    d, c, i = y["DATASET"], y["CAPTURE_SPEC"], y["INDIVIDUAL_SPEC"]
    # the counter sees the transposed convs' MACs per input pixel, the
    # count per output pixel of their k2/s2: the same products
    assert count.macs == flops.fusion_macs(d["NUM_JOINTS"], c["VOXELS_PER_AXIS"],
                                           i["VOXELS_PER_AXIS"], c["MAX_PEOPLE"])


def test_resnet_macs_match_the_reference_calls(monkeypatch):
    from benchmark.core.weights import backbone_weights
    from benchmark.reference.resnet import ResNetReference

    ref = ResNetReference(backbone_weights(15, 1, "cpu"), True)
    count = _Counter(monkeypatch)
    ref(torch.zeros((1, 64, 96, 3), dtype=torch.uint8))
    assert count.macs == flops.resnet50_macs(64, 96, 15)
    # the published size, by hand: the stem 7x7x3x64 over 256x480 outputs
    assert flops.resnet50_macs(512, 960, 15) > 256 * 480 * 147 * 64


def test_kernel_counts_by_hand():
    w = kernels.whole_kernel(2, (4, 6), 3, (2, 2, 2))
    assert w["bytes"] == 4 * (2 * 4 * 6 * 3 + 2 * 21 + 8 * 3)
    assert w["ops"] == 8 * 2 * (kernels.PROJECT_OPS + kernels.WEIGHT_OPS + 24) + 2 * 8 * 3
    c = kernels.crop_kernel(2, (4, 6), 3, (2, 2, 2), 5, live_voxels=7)
    assert c["bytes"] == 4 * (2 * 4 * 6 * 3 + 2 * 21 + 5 * 12 * 3)
    assert c["ops"] == 7 * (2 * (kernels.PROJECT_OPS + kernels.WEIGHT_OPS + 24) + 18)
    peaks = {"hbm_bytes": 1.0, "fp32_flops": 1e9}
    assert kernels.least_seconds(c, peaks) == c["bytes"]


def _slots():
    poses = np.zeros((4, 2, 3))
    poses[1] += 1000.0
    poses[2] += 2000.0  # below MIN_SCORE: the reference serves no one there
    return {"poses": poses, "valid": np.array([True, True, False, False]),
            "confidence": np.array([0.9, 0.8, 0.05, 0.0])}


@pytest.mark.parametrize("served, pose_mean", [
    ([0, 1], 0.0),  # both people
    ([1], MISS_MM / 2),  # one dropped
    ([], MISS_MM),  # no one served
    ([0, 1, 2], MISS_MM / 3),  # one served whom the reference does not serve
    ([1, 2], 2 * MISS_MM / 3),  # one dropped, another served far from anyone
])
def test_people_dropped_or_added_count_at_the_miss_distance(served, pose_mean):
    ref = _slots()
    answer = {"poses_mm": ref["poses"][served],
              "scores": ref["confidence"][served]}
    got = summarize([compare_answer(answer, ref)])
    assert got["pose_mean_mm"] == pytest.approx(pose_mean)
    assert got["confidence_mean"] == pytest.approx(0.0)


def test_pair_errors_are_mpjpe_capped_at_the_miss_distance():
    ref = _slots()
    answer = {"poses_mm": ref["poses"][:2] + np.array([[[3.0, 4.0, 0.0]], [[0.0, 0.0, 400.0]]]),
              "scores": [0.8, 0.8]}
    got = summarize([compare_answer(answer, ref)])
    assert got["pose_mean_mm"] == pytest.approx((5.0 + MISS_MM) / 2)
    assert got["confidence_mean"] == pytest.approx(0.05)
