"""The plain reference against the port at tiny sizes on the CPU, the
control that has to come out as not correct, and whole runs (the card's
look skipped) with the timed path broken underneath."""

import copy

import numpy as np
import pytest
import torch

from benchmark.core.compare import compare_answer, summarize
from benchmark.core.weights import backbone_weights
from benchmark.drivers import live_service as live
from benchmark.reference.fusion import FusionReference, Geometry
from benchmark.reference.resnet import ResNetReference
from benchmark.tests.tiny import run_tiny, tiny_cell
from benchmark.tools.readings import as_answer
from benchmark.traffic.generate import make_traffic

SEED = 2**33 + 101


def float32_cell(name):
    """The tiny cell served in float32, so that the program and the
    reference differ by rounding alone."""
    cell = tiny_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["served"] = {"NETWORK.COMPUTE_DTYPE": "float32"}
    return cell


def test_fusion_reference_against_the_port():
    cell = float32_cell("shelf_jln64.heatmaps.live")
    cell.config["yaml"]["CAPTURE_SPEC"]["MIN_SCORE"] = -10.0  # every slot through the JLN
    from faster_voxelpose_tpu_torch.models.faster_voxelpose import build_model
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    cfg = live.port_config(cell.config)
    arrays = live.load_arrays(cell.root_weights)
    model = build_model(cfg)
    model.load_state_dict(from_jax_variables(arrays, model))
    t = make_traffic(cell.mix, cell.config, 10.0, 1.0, SEED, "cpu")
    ref = FusionReference(Geometry.from_config(cell.config["yaml"]), arrays, "cpu")
    for hm in t.pool:
        with torch.no_grad():
            out = model(torch.as_tensor(hm)[None], torch.as_tensor(t.rig)[None])
        r = ref(torch.as_tensor(hm), torch.as_tensor(t.rig))
        assert torch.equal(out.fused_poses[0, :, 0, 3] >= 0, r["valid"])
        assert torch.allclose(out.proposal_centers[0, :, :3], r["centres"])
        assert torch.allclose(out.proposal_centers[0, :, 5:7], r["bbox"], atol=1e-5)
        assert (out.fused_poses[0, ..., :3] - r["poses"]).abs().max() < 0.05
        assert torch.allclose(out.fused_poses[0, :, 0, 4], r["confidence"], atol=1e-5)


def test_resnet_reference_against_the_port():
    from faster_voxelpose_tpu_torch.models.resnet import PoseResNet, images_to_heatmaps

    w = backbone_weights(15, SEED, "cpu")
    port = PoseResNet(50, 15).eval()
    port.load_state_dict(w)
    frames = torch.randint(0, 256, (1, 2, 64, 96, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = images_to_heatmaps(port, frames, True)[0]
    got = ResNetReference(w, True)(frames[0])
    assert ((got - want).norm() / want.norm()) < 1e-5


def test_planted_backbone_turns_marks_into_heatmaps():
    """Each joint's disk comes out in its own heatmap, not in the others."""
    from benchmark.core.weights import joint_mark

    w = backbone_weights(15, SEED, "cpu")
    frame = np.full((1, 128, 128, 3), 20, np.uint8)
    c, level, _ = joint_mark(4, 15)
    frame[0, 32:96, 32:96, 2 - c] = level  # BGR
    hm = ResNetReference(w, True)(torch.as_tensor(frame))[0]
    centre = hm[14:18, 14:18]
    assert centre[..., 4].min() > 0.5
    assert centre[..., [j for j in range(15) if j != 4]].max() < 0.2
    assert hm[:4, :4].max() < 0.2


@pytest.mark.parametrize("name", ["shelf_jln64.heatmaps.live", "panoptic_jln64.images.live"])
def test_control_fails_the_limits(name):
    """The reference with fp8 operands in the program's place breaks the
    cell's limits (a tiny size; the chip's readings at the cell's size
    are in PERF.md)."""
    cell = tiny_cell(name)
    cell.config["yaml"]["CAPTURE_SPEC"]["MIN_SCORE"] = -10.0
    t = make_traffic(cell.mix, cell.config, 10.0, 1.0, SEED, "cpu")
    arrays = live.load_arrays(cell.root_weights)
    weights = backbone_weights(15, SEED, "cpu") if name.endswith("images.live") else None
    entries = range(len(t.pool))
    refs = live.reference_answers(cell, t, arrays, weights, entries, "cpu")
    ctrl = live.reference_answers(cell, t, arrays, weights, entries, "cpu", precision="fp8")
    got = summarize(compare_answer(as_answer(ctrl[e]), refs[e]) for e in entries)
    limits = cell.workload["limits"]
    assert any(got[k] > limits[k] for k in limits), (got, limits)


def test_clean_run_is_correct():
    cell = float32_cell("shelf_jln64.heatmaps.live")
    result, checks = run_tiny(cell, SEED)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(checks) == set(cell.workload["limits"])
    assert set(result["metrics"]) == {"latency_p50_ms", "latency_p95_ms", "setup_s"}
    assert list(result)[-1] == "checks"


def test_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    """Every fused pose moved 20 mm in x inside the model's forward."""
    from faster_voxelpose_tpu_torch.models import faster_voxelpose as fvp

    forward = fvp.FasterVoxelPoseNet.forward

    def altered(self, *a, **k):
        out = forward(self, *a, **k)
        poses = out.fused_poses.clone()
        poses[..., 0] += 20.0
        return out._replace(fused_poses=poses)

    monkeypatch.setattr(fvp.FasterVoxelPoseNet, "forward", altered)
    cell = float32_cell("shelf_jln64.heatmaps.live")
    result, checks = run_tiny(cell, SEED)
    assert not result["correct"]
    assert checks["pose_mean_mm"][0] > checks["pose_mean_mm"][1]


def test_confidence_altered_where_it_is_produced_is_not_correct(monkeypatch):
    """Every served confidence scaled by 0.9 inside the model's forward."""
    from faster_voxelpose_tpu_torch.models import faster_voxelpose as fvp

    forward = fvp.FasterVoxelPoseNet.forward

    def altered(self, *a, **k):
        out = forward(self, *a, **k)
        poses = out.fused_poses.clone()
        poses[..., 4] *= 0.9
        return out._replace(fused_poses=poses)

    monkeypatch.setattr(fvp.FasterVoxelPoseNet, "forward", altered)
    cell = float32_cell("shelf_jln64.heatmaps.live")
    result, checks = run_tiny(cell, SEED)
    assert not result["correct"]
    assert checks["confidence_mean"][0] > checks["confidence_mean"][1]


@pytest.mark.parametrize("keep", ["none", "every_second"])
def test_people_dropped_where_they_are_served_is_not_correct(monkeypatch, keep):
    """No one served, or every second slot left out, inside the model's
    forward: the people the reference serves count as dropped."""
    from faster_voxelpose_tpu_torch.models import faster_voxelpose as fvp

    forward = fvp.FasterVoxelPoseNet.forward

    def altered(self, *a, **k):
        out = forward(self, *a, **k)
        poses = out.fused_poses.clone()
        poses[:, slice(None) if keep == "none" else slice(0, None, 2), :, 3] = -1.0
        return out._replace(fused_poses=poses)

    monkeypatch.setattr(fvp.FasterVoxelPoseNet, "forward", altered)
    cell = float32_cell("shelf_jln64.heatmaps.live")
    result, checks = run_tiny(cell, SEED)
    assert not result["correct"]
    assert checks["pose_mean_mm"][0] > checks["pose_mean_mm"][1]


def test_traced_run_reports_per_layer_metrics():
    cell = float32_cell("shelf_jln64.heatmaps.live")
    result, _ = run_tiny(cell, SEED, trace=True)
    assert "service.queue_wait_p95_ms" in result["metrics"]
    assert "latency_p50_ms" not in result["metrics"]
    assert result["device"]["window_s"] > 0 and "breakdown" in result


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    from benchmark.core.spec import load_cell
    from benchmark.run import run_cell
    import time

    result, _ = run_cell(load_cell("shelf_jln64.heatmaps.live"), SEED, 1.0, False,
                         torch.device("cuda", 0), time.perf_counter())
    assert result["device"]["platform"] == "gpu" and result["attempted"] > 0
