"""PyTorch port, the entry point and the multi-rank dry run
(`tools/dryrun_multichip.py`) against the JAX repo's `__graft_entry__.py`
on the CPU, and the JAX package's last public names against the port's.

Tolerances of `entry()` against the JAX entry's forward on the JAX
entry's own variables (bf16 conv stacks, both packages): the same
validity flag in every slot, fused poses xyz within 0.5 mm (the golden
bound of tests/test_torch_model.py); the proposal centres in the same
voxels, xyz within 1e-3 mm (tests/test_torch_model.py's proposal bound),
scores and sizes within 2e-2 relative (tests/test_torch_train.py's bound
for the bf16 forward, which rounds at other points in each package).  At
the entry's inputs and random weights no slot reaches MIN_SCORE 0.1 in
either package, so the fused poses are the invalid slots' zeros and the
proposal centres carry the comparison.  The dry run is held to the JAX
file's own bounds (params 1e-4, poses 1e-2 mm; its view and eval poses
also with every slot valid) and to tests/test_torch_parallel.py's 1e-6
relative L2 on the summed gradients.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_geometry import jax_schema


@pytest.fixture(scope="module")
def jax_entry():
    """The JAX entry's variables (flattened), inputs and fused poses, and
    its model's outputs on the quad path and through the Pallas kernel in
    interpret mode."""
    from __graft_entry__ import _tiny_config
    from __graft_entry__ import entry as jax_entry_fn
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu_torch.weights import flatten_variables

    fn, (variables, hm, cams) = jax_entry_fn()
    out = {"entry": np.asarray(jax.jit(fn)(variables, hm, cams))}
    for interpret in (False, True):
        cfg = _tiny_config()
        cfg.NETWORK.PALLAS_INTERPRET = interpret
        model = jax_build(cfg)
        res = jax.jit(lambda v, h, c: model.apply(v, h, c, train=False, mutable=False))(
            variables, hm, cams)
        out[interpret] = {k: np.asarray(getattr(res, k))
                          for k in ("fused_poses", "proposal_centers")}
    return flatten_variables(variables), hm, cams, out


def test_tiny_config_matches_jax():
    from __graft_entry__ import _tiny_config
    from faster_voxelpose_tpu_torch.tools.dryrun_multichip import tiny_config

    assert jax_schema(tiny_config()) == dataclasses.asdict(_tiny_config())


@pytest.mark.parametrize("B, V", [(1, 3), (2, 4)])
def test_ring_rig_matches_jax(B, V):
    from __graft_entry__ import _example_cameras
    from faster_voxelpose_tpu_torch.geometry import ring_rig

    got, want = ring_rig(B, V), _example_cameras(B, V)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (B, V, 21)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("interpret", [False, True], ids=["quad", "pallas-interpret"])
def test_entry_matches_jax(jax_entry, interpret):
    from faster_voxelpose_tpu_torch.tools.dryrun_multichip import entry
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    flat, hm, cams, ref = jax_entry
    fn, (model, heatmaps, cameras) = entry(device="cpu")
    # the same inputs as the JAX entry's, on the CPU
    assert heatmaps.device.type == cameras.device.type == "cpu"
    np.testing.assert_array_equal(heatmaps.numpy(), hm)
    np.testing.assert_array_equal(cameras.numpy(), cams)
    model.load_state_dict(from_jax_variables(flat, model))
    fused = fn(model, heatmaps, cameras).numpy()
    want = ref[interpret]
    np.testing.assert_array_equal(want["fused_poses"], ref["entry"])
    assert fused.shape == want["fused_poses"].shape == (1, 4, 15, 5)
    np.testing.assert_array_equal(fused[..., 3], want["fused_poses"][..., 3])
    assert np.max(np.abs(fused[..., :3] - want["fused_poses"][..., :3])) <= 0.5
    np.testing.assert_allclose(fused[..., 4], want["fused_poses"][..., 4], rtol=2e-2, atol=0)
    # no slot valid at MIN_SCORE 0.1: the proposal centres carry the comparison
    assert (want["proposal_centers"][..., 3] < 0).all()
    with torch.no_grad():
        pc = model(heatmaps, cameras).proposal_centers.numpy()
    geom = model.geom
    scale = np.asarray(geom.space_size) / (np.asarray(geom.voxels_per_axis) - 1)
    bias = np.asarray(geom.space_center) - np.asarray(geom.space_size) / 2
    wpc = want["proposal_centers"]
    np.testing.assert_array_equal(np.round((pc[..., :3] - bias) / scale),
                                  np.round((wpc[..., :3] - bias) / scale))
    np.testing.assert_allclose(pc[..., :4], wpc[..., :4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(pc[..., 4:], wpc[..., 4:], rtol=2e-2, atol=0)


def _readings(text):
    """The dry run's judged numbers, by check, from its printed lines."""
    out = {}
    for key, pattern in (("train", r"dryrun_multichip\(\d+\) ok: .*?max\|Δ\|=(\S+)"),
                         ("grad", r"dryrun_multichip\(\d+\) ok: .*?relative L2 (\S+),"),
                         ("view", r"view-shard ok: .*?max\|Δ\|=(\S+) mm"),
                         ("view all valid", r"view-shard ok: .*every slot valid .*?=(\S+) mm"),
                         ("eval", r"dp-eval ok: .*?max\|Δ\|=(\S+) mm"),
                         ("eval all valid", r"dp-eval ok: .*every slot valid .*?=(\S+) mm"),
                         ("pipeline", r"pipeline ok: .*?max\|Δ\|=(\S+) mm")):
        out[key] = float(re.search(pattern, text).group(1))
    return out


def test_dryrun_three_ranks_cli(capsys):
    """`python3 -m ...dryrun_multichip 3 --device cpu`: the entry's line,
    then every check of the dry run over three gloo ranks, the views
    sharded 3-way over a sub-group of the world, each under the JAX
    file's bound."""
    from faster_voxelpose_tpu_torch.tools.dryrun_multichip import main

    assert main(["3", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    lines = text.splitlines()
    assert lines[0] == "entry ok: (1, 4, 15, 5)"
    assert "dryrun_multichip view-shard ok: 3-way camera sharding" in text
    assert "dryrun_multichip dp-eval ok: 3-way batch sharding" in text
    assert "dryrun_multichip pipeline ok: 2-chip backbone|fusion stream, 2 frames" in text
    assert "every slot valid (12) at MIN_SCORE -1e+09" in text  # B = 3, K = 4
    got = _readings(text)
    assert got["train"] < 1e-4 and got["grad"] <= 1e-6
    assert max(got["view"], got["view all valid"], got["eval"], got["eval all valid"],
               got["pipeline"]) < 1e-2


@pytest.mark.slow
def test_dryrun_eight_ranks():
    """n = 8 as in the JAX repo's record: the view forward on a sub-group
    of 3 of the 8 ranks, and a train step in which the JLN's Adam steps."""
    from faster_voxelpose_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    got = dryrun_multichip(8, device="cpu")
    assert got["view_shards"] == 3 and got["devices"] == ["cpu"] * 8
    assert got["train_max_dev"] < 1e-4 and got["train"]["float64 conv stacks"]["grad"] <= 1e-6
    assert max(got["view_max_dev"], got["view_all_valid_max_dev"], got["eval_max_dev"],
               got["eval_all_valid_max_dev"], got["pipeline_max_dev"]) < 1e-2


def test_entry_and_dryrun_need_cuda_or_cpu(monkeypatch):
    from faster_voxelpose_tpu_torch.tools.dryrun_multichip import dryrun_multichip, entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)


def test_view_shards_match_jax_rule():
    """The largest divisor of the camera count at most n (the JAX file's
    `vdev`)."""
    from faster_voxelpose_tpu_torch.tools.dryrun_multichip import view_shards

    for n in range(1, 9):
        for V in (3, 4, 5):
            want = max(d for d in range(1, min(V, n) + 1) if V % d == 0)
            assert view_shards(n, V) == want
    assert [view_shards(n, 3) for n in (1, 2, 3, 8)] == [1, 1, 3, 3]


# -- the JAX package's last public names ---------------------------------


def _lists(tree):
    if isinstance(tree, dict):
        return {k: _lists(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_lists(v) for v in tree]
    return tree


@pytest.mark.parametrize("name", ["shelf_synthetic_ref", "tiny"])
def test_save_config_round_trips_through_both_packages(tmp_path, name):
    """The port's file loads to the same values in both packages (YAML
    gives back lists where the sections that normalise nothing held
    tuples, in both packages alike; the port's VIT section, which a
    Pose-ResNet's file leaves out, aside), and the JAX package writes the
    same file back."""
    from faster_voxelpose_tpu.config import load_config as jax_load
    from faster_voxelpose_tpu.config import save_config as jax_save
    from faster_voxelpose_tpu_torch.config import load_config, profile, save_config
    from faster_voxelpose_tpu_torch.tools.dryrun_multichip import tiny_config

    cfg = tiny_config() if name == "tiny" else profile(name)
    save_config(cfg, tmp_path / "port.yaml")
    jax_save(jax_load(tmp_path / "port.yaml"), tmp_path / "jax.yaml")
    want = _lists(jax_schema(cfg))
    for path in ("port.yaml", "jax.yaml"):
        assert _lists(jax_schema(load_config(tmp_path / path))) == want
        assert _lists(dataclasses.asdict(jax_load(tmp_path / path))) == want
    assert (tmp_path / "port.yaml").read_text() == (tmp_path / "jax.yaml").read_text()


def test_get_model_name_matches_jax():
    from faster_voxelpose_tpu.config import get_model_name as jax_name
    from faster_voxelpose_tpu.config import load_config as jax_load
    from faster_voxelpose_tpu_torch.config import get_model_name, load_config
    from tests.test_torch_geometry import REPO

    for path in sorted((REPO / "configs").rglob("*.yaml")):
        assert get_model_name(load_config(path)) == jax_name(jax_load(path)), path


def test_unpack_camera_matches_jax():
    from faster_voxelpose_tpu.geometry import unpack_camera as jax_unpack
    from faster_voxelpose_tpu_torch.geometry import dome_rig, pack_camera, unpack_camera

    for packed in dome_rig(1, 5)[0]:
        got, want = unpack_camera(packed), jax_unpack(packed)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(got[k], v)
        np.testing.assert_array_equal(pack_camera(got), packed.astype(np.float64))


def test_affine_transform_and_exports_match_jax():
    from faster_voxelpose_tpu import geometry as jgeom
    from faster_voxelpose_tpu_torch import geometry

    rng = np.random.RandomState(0)
    for _ in range(8):
        center, scale = rng.uniform(50, 1000, 2), rng.uniform(0.5, 8, 2)
        rot, size = rng.uniform(-45, 45), (int(rng.randint(64, 512)), int(rng.randint(64, 512)))
        t = geometry.get_affine_transform(center, scale, rot, size)
        np.testing.assert_array_equal(t, jgeom.get_affine_transform(center, scale, rot, size))
        np.testing.assert_array_equal(geometry.get_scale(size, (960, 512)),
                                      jgeom.get_scale(size, (960, 512)))
        pt = rng.uniform(0, 1000, 2)
        got = geometry.affine_transform(pt, t)
        np.testing.assert_array_equal(got, jgeom.affine_transform(pt, t))
        np.testing.assert_allclose(got, geometry.affine_transform_points(pt[None], t)[0],
                                   rtol=1e-12)


def test_models_registry_matches_jax():
    from faster_voxelpose_tpu import models as jmodels
    from faster_voxelpose_tpu_torch import models
    from faster_voxelpose_tpu_torch.models.faster_voxelpose import build_model
    from faster_voxelpose_tpu_torch.models.resnet import PoseResNet, build_backbone

    assert models.get("faster_voxelpose") is models.build_model is build_model
    assert models.get("resnet") is models.build_backbone is build_backbone
    assert models.PoseResNet is PoseResNet
    assert jmodels.get("faster_voxelpose").__name__ == models.get("faster_voxelpose").__name__
    assert jmodels.get("resnet").__name__ == models.get("resnet").__name__
    for pkg in (models, jmodels):
        with pytest.raises(KeyError, match="unknown model 'hrnet'"):
            pkg.get("hrnet")
