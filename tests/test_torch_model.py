"""PyTorch port, the whole heatmaps -> poses path: the port's model and
the JAX package's on the tiny geometry with the same random flax weights
(float32, CPU), the port's PoseService on the CPU, the import boundary of
the port, and (slow, not in tier 1) the full Panoptic profile with the
committed weights.

Tolerances: identical proposal voxels; proposal fields to 1e-3; fused
poses to 0.5 mm, the golden bound the JAX package holds its own model to.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_geometry import tiny_configs, tiny_rig
from tests.test_torch_modules import nest, randomize

REPO = pathlib.Path(__file__).resolve().parent.parent


def _frames(V, H, W, J, B, seed):
    """Random heatmaps with a few sharp Gaussian blobs per joint map."""
    rng = np.random.RandomState(seed)
    hm = rng.rand(B, V, H, W, J).astype(np.float32) * 0.2
    ys, xs = np.mgrid[0:H, 0:W]
    for b, v, j in np.ndindex(B, V, J):
        for _ in range(2):
            cx, cy = rng.uniform(0, W), rng.uniform(0, H)
            hm[b, v, :, :, j] += np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / 8.0)
    return np.clip(hm, 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def tiny_pair():
    """(port cfg, flat flax weights, heatmaps, cams, JAX outputs): one JAX
    model build per module; every proposal slot valid.

    The tiny geometry puts every x/y crop origin on an exact tie: fine
    coordinate 2i - 7.5 for whole-grid bin i.  Which way it rounds then
    hangs on the last ulp of `centers * scale + bias`, which XLA fuses
    into FMAs in some lanes of a jitted graph and not in others, so no
    eager computation can follow it.  A 2100 mm person box moves the
    fine coordinates to 28i/15 - 7.35, at least 1/60 from any tie, and
    keeps every shape of the tiny profile."""
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build

    jcfg, pcfg = tiny_configs(
        CAPTURE_SPEC__MIN_SCORE=-1e9, INDIVIDUAL_SPEC__SPACE_SIZE=(2100.0,) * 3
    )
    V, J = jcfg.DATASET.CAMERA_NUM, jcfg.DATASET.NUM_JOINTS
    W, H = jcfg.DATASET.HEATMAP_SIZE
    hm = _frames(V, H, W, J, 2, seed=0)
    cams = np.stack([tiny_rig(V)] * 2)
    model = jax_build(jcfg)
    flat = randomize(model.init(jax.random.PRNGKey(0), hm[:1], cams[:1], train=False), seed=5)
    # bbox sizes near (0.6, 0.7) so that the crop masks keep voxels and the
    # crop sampling carries signal into the JLN
    flat["params/hdn/center_net/size_out/kernel"] *= 0.01
    flat["params/hdn/center_net/size_out/bias"] = np.array([0.6, 0.7], np.float32)
    out = jax.jit(lambda v, h, c: model.apply(v, h, c, train=False))(nest(flat), hm, cams)
    ref = {k: np.asarray(getattr(out, k)) for k in ("fused_poses", "plane_poses", "proposal_centers")}
    return pcfg, flat, hm, cams, ref


def test_tiny_model_matches_jax(tiny_pair):
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    pcfg, flat, hm, cams, ref = tiny_pair
    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(flat, model))
    with torch.no_grad():
        out = model(torch.as_tensor(hm), torch.as_tensor(cams))
    pc, rpc = out.proposal_centers.numpy(), ref["proposal_centers"]
    assert (rpc[:, :, 3] >= 0).all()  # every slot valid
    geom = model.geom
    scale = np.asarray(geom.space_size) / (np.asarray(geom.voxels_per_axis) - 1)
    bias = np.asarray(geom.space_center) - np.asarray(geom.space_size) / 2
    np.testing.assert_array_equal(  # the same proposal voxels, in the same order
        np.round((pc[..., :3] - bias) / scale), np.round((rpc[..., :3] - bias) / scale)
    )
    np.testing.assert_allclose(pc, rpc, atol=1e-3)
    np.testing.assert_allclose(out.plane_poses.numpy(), ref["plane_poses"], atol=0.5)
    fused = out.fused_poses.numpy()
    assert fused.shape == ref["fused_poses"].shape
    assert np.max(np.abs(fused[..., :3] - ref["fused_poses"][..., :3])) <= 0.5
    np.testing.assert_allclose(fused[..., 3:], ref["fused_poses"][..., 3:], atol=1e-3)


def test_pose_service_cpu(tiny_pair):
    """The port's service on the CPU answers requests with the model's
    poses and keeps its statistics."""
    from faster_voxelpose_tpu_torch.engine import PoseService

    pcfg, flat, hm, cams, ref = tiny_pair
    svc = PoseService(pcfg, variables=flat, rig=cams[0], device="cpu")
    svc.warmup()
    for b in range(2):
        res = svc.infer_heatmaps(hm[b])
        assert res["n_people"] == len(res["poses_mm"]) == pcfg.CAPTURE_SPEC.MAX_PEOPLE
        poses = np.asarray(res["poses_mm"])
        assert np.max(np.abs(poses - ref["fused_poses"][b, :, :, :3])) <= 0.5
    stats = svc.stats()
    assert stats["requests"] == 2 and not stats["random_init"]
    assert stats["p50_ms"] > 0 and stats["device"] == "cpu"


def test_entry_points_need_cuda_or_cpu(monkeypatch):
    """With no CUDA device and no device given, the entry points raise."""
    from faster_voxelpose_tpu_torch.device import resolve_device
    from faster_voxelpose_tpu_torch.engine import PoseService

    _, pcfg = tiny_configs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        PoseService(pcfg)
    assert PoseService(pcfg, device="cpu").random_init


def _port_sources():
    files = sorted((REPO / "faster_voxelpose_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py", REPO / "chip_profile.py"]


def test_port_imports_nothing_of_jax():
    """No module of the port, and neither chip script, imports jax, flax,
    optax, the JAX package or the repo's scripts (the port keeps its own
    copies); the walk covers every module, the training modules too."""
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "faster_voxelpose_tpu", "scripts"}
    offenders = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names if n.split(".")[0] in banned]
    names = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    assert {"faster_voxelpose_tpu_torch/engine/trainer.py",
            "faster_voxelpose_tpu_torch/engine/loader.py",
            "faster_voxelpose_tpu_torch/engine/checkpoint.py",
            "faster_voxelpose_tpu_torch/datasets/synthetic.py",
            "faster_voxelpose_tpu_torch/datasets/demo_data.py",
            "faster_voxelpose_tpu_torch/datasets/evaluate.py",
            "faster_voxelpose_tpu_torch/engine/validator.py",
            "faster_voxelpose_tpu_torch/ops/window_kernels.py",
            "faster_voxelpose_tpu_torch/tools/timing.py",
            "faster_voxelpose_tpu_torch/tools/bench.py",
            "faster_voxelpose_tpu_torch/tools/profile_stages.py",
            "faster_voxelpose_tpu_torch/tools/bench_width.py",
            "faster_voxelpose_tpu_torch/tools/probe_sampling.py",
            "faster_voxelpose_tpu_torch/tools/sweep_sampling.py",
            "faster_voxelpose_tpu_torch/tools/microbench_mma.py",
            "faster_voxelpose_tpu_torch/tools/validate.py",
            "faster_voxelpose_tpu_torch/tools/serve.py",
            "faster_voxelpose_tpu_torch/models/resnet.py",
            "faster_voxelpose_tpu_torch/datasets/images.py",
            "faster_voxelpose_tpu_torch/engine/graphs.py",
            "faster_voxelpose_tpu_torch/tools/train.py",
            "faster_voxelpose_tpu_torch/tools/make_demo_data.py",
            "faster_voxelpose_tpu_torch/utils/logging_utils.py",
            "faster_voxelpose_tpu_torch/utils/tb_events.py",
            "faster_voxelpose_tpu_torch/utils/profiling.py",
            "faster_voxelpose_tpu_torch/utils/bench_lock.py",
            "faster_voxelpose_tpu_torch/datasets/base.py",
            "faster_voxelpose_tpu_torch/datasets/panoptic.py",
            "faster_voxelpose_tpu_torch/datasets/shelf_campus.py",
            "faster_voxelpose_tpu_torch/native/build.py",
            "faster_voxelpose_tpu_torch/native/__init__.py",
            "faster_voxelpose_tpu_torch/utils/vis.py",
            "faster_voxelpose_tpu_torch/parallel/__init__.py",
            "faster_voxelpose_tpu_torch/parallel/mesh.py",
            "faster_voxelpose_tpu_torch/tools/demo.py",
            "faster_voxelpose_tpu_torch/tools/preprocess.py",
            "faster_voxelpose_tpu_torch/tools/serve_latency.py"} <= names
    assert not offenders, offenders


@pytest.mark.slow
def test_full_profile_matches_jax_with_committed_weights():
    """Panoptic profile, committed panoptic_synthetic weights, float32 on
    both sides, one frame of random Gaussian blobs: same proposals, fused
    poses of the valid slots within 0.5 mm."""
    from faster_voxelpose_tpu.config import load_config as jax_load
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.geometry import dome_rig
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    jcfg = jax_load(REPO / "configs/demo/panoptic_synthetic.yaml")
    jcfg.NETWORK.COMPUTE_DTYPE = "float32"
    jcfg.NETWORK.SAMPLING_BACKEND = "quad"
    pcfg = panoptic_synthetic_profile()
    pcfg.NETWORK.COMPUTE_DTYPE = "float32"
    with np.load(REPO / "checkpoints/panoptic_synthetic/model_best.npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    cams = dome_rig(1, 5, space_center=pcfg.CAPTURE_SPEC.SPACE_CENTER)
    hm = _frames(5, 128, 240, 15, 1, seed=3)

    jm = jax_build(jcfg)
    ref = jax.jit(lambda v, h, c: jm.apply(v, h, c, train=False))(nest(flat), hm, cams)
    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(flat, model))
    with torch.no_grad():
        out = model(torch.as_tensor(hm), torch.as_tensor(cams))
    np.testing.assert_array_equal(
        out.proposal_centers.numpy()[..., :3], np.asarray(ref.proposal_centers)[..., :3]
    )
    valid = np.asarray(ref.proposal_centers)[0, :, 3] >= 0
    d = out.fused_poses.numpy()[0, valid, :, :3] - np.asarray(ref.fused_poses)[0, valid, :, :3]
    assert np.abs(d).max() <= 0.5
