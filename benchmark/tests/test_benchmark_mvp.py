"""The MvP cell's own parts: its work at Panoptic's published shapes by hand
(`counts/mvp.py`), that only its cell lists its four metrics, the
roofline's reading of a fabricated trace (one launch per decoder layer
and traced request, or nothing), and the entry's judgement slot for slot
(`drivers/live_mvp.py`)."""

import numpy as np
import pytest

from benchmark.core.record import Run
from benchmark.core.spec import load_cell
from benchmark.counts import mvp as counts
from benchmark.counts.peaks import PEAKS
from benchmark.drivers import live_mvp

CELL = "panoptic_mvp.images.live"
METRICS = ("mvp.values_served_ms", "mvp.decoder_served_ms", "roofline.mvp_projattn",
           "mfu.mvp_live")
KERNEL = ("void (anonymous namespace)::projattn_kernel((anonymous namespace)::Levels, int, int, "
          "float const*, float const*, float const*, float const*, ...)")


def test_work_at_panoptic_by_hand():
    y = load_cell(CELL).config["yaml"]
    assert counts.feature_sizes(y) == [(32, 60), (64, 120), (128, 240)]
    w = counts.projattn_kernel(y)
    assert w["taps"] == 150 * 5 * 8 * 3 * 4 == 72000
    assert w["bytes"] == 72000 * 4 * 32 * 2 + 150 * 96 * 3 * 4 + 5 * 150 * 256 * 2
    least = counts.least_seconds(w, PEAKS["NVIDIA H100 80GB HBM3"])
    assert least == pytest.approx(w["bytes"] / 3.35e12) and least * 1e6 == pytest.approx(5.67,
                                                                                       abs=0.01)
    macs = counts.mvp_macs(y)
    pixels = 5 * (32 * 60 + 64 * 120 + 128 * 240)
    assert macs["values"] == pixels * (259 * 256 + 256 * 256)
    assert counts.request_flops(y) / 1e12 == pytest.approx(0.598, abs=0.001)


def test_only_the_mvp_cell_reports_its_metrics():
    assert set(METRICS) <= {m.name for m in load_cell(CELL).metrics}
    for other in ("panoptic_jln64.heatmaps.live", "shelf_jln64.heatmaps.live",
                  "panoptic_jln64.images.live", "shelf_vitpose_h.images.live",
                  "panoptic_voxelpose.heatmaps.live"):
        assert not set(METRICS) & {m.name for m in load_cell(other).metrics}


@pytest.mark.parametrize("launches, reads", [(24, True), (4, False), (25, False), (0, False)])
def test_roofline_reads_one_launch_per_layer_and_request(launches, reads):
    """Four traced requests of 6 layers: 24 launches at a quarter of the
    least time's rate read 25%; anything else reads nothing."""
    cell = load_cell(CELL)
    reader = next(m.reader for m in cell.metrics if m.name == "roofline.mvp_projattn")
    y = cell.config["yaml"]
    run = Run(cell.name, 1.0, yaml=y)
    run.peaks = PEAKS["NVIDIA H100 80GB HBM3"]
    run.traced_entries = [0, 1, 2, 3]
    least = counts.least_seconds(counts.projattn_kernel(y), run.peaks)
    run.trace = {"total_s": {"other": 1.0}, "count": {"other": 1}}
    if launches:
        run.trace["total_s"][KERNEL], run.trace["count"][KERNEL] = 24 * 4 * least, launches
    got = reader.read(run)
    assert (got == pytest.approx(25.0)) if reads else got is None


def _slots(poses, scores, threshold=0.1):
    """(N, J, 5) slots as the service's graph gives them."""
    poses = np.asarray(poses, np.float32)
    scores = np.asarray(scores, np.float32)
    tail = np.stack([(scores >= threshold).astype(np.float32) - 1.0, scores], -1)
    return np.concatenate([poses, np.broadcast_to(tail[:, None], (*poses.shape[:2], 2))], -1)


def test_judge_is_slot_for_slot():
    """pose_mean_mm: the mean over every slot of every request;
    slot_pose_mm: the largest over slots of the mean over requests of the
    slot's mean joint error; score_gap: the largest gap anywhere; an
    answer is its slots above the threshold, exactly."""
    rng = np.random.default_rng(0)
    ref = {e: {"poses": rng.normal(0, 1000, (3, 2, 3)), "scores": np.array([0.05, 0.2, 0.3])}
           for e in (0, 1)}
    shift = np.zeros((3, 2, 3))
    shift[1, :, 0] = 4.0  # slot 1 off by 4 mm in x
    slots = {0: _slots(ref[0]["poses"] + shift, [0.05, 0.2, 0.301]),
             1: _slots(ref[1]["poses"], [0.05, 0.21, 0.3])}
    got = live_mvp.judge(slots, [0, 0, 1], ref)
    assert got["pose_mean_mm"] == pytest.approx(4.0 * 2 / 9, abs=1e-3)  # float32 slots
    assert got["slot_pose_mm"] == pytest.approx(4.0 * 2 / 3, abs=1e-3)
    assert got["score_gap"] == pytest.approx(0.01, rel=1e-4)
    assert set(live_mvp.judge(slots, [], ref).values()) == {float("inf")}
    valid = slots[0][:, 0, 3] >= 0
    answer = {"poses_mm": slots[0][valid][:, :, :3].tolist(),
              "scores": slots[0][valid][:, 0, 4].tolist()}
    assert live_mvp.answer_is_slots(answer, slots[0])
    assert not live_mvp.answer_is_slots(answer, slots[1])
    answer["scores"] = answer["scores"][:1]
    assert not live_mvp.answer_is_slots(answer, slots[0])
