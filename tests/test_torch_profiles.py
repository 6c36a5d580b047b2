"""PyTorch port, the profiles of the committed snapshots: the code-side
profiles against `load_config` of their YAML files, the held-out scenes
of the Shelf and Campus profiles against the JAX package's generator on
the files its `make_demo_data.py` line writes, the profile and rig that
`tools.validate` picks from each snapshot's record, and the model at 17
joints, 3 views and K = 5 (and at width 0.5) against the JAX package on
the tiny geometry with the same random flax weights (float32, CPU).

Tolerances: configs and scenes equal exactly; identical proposal voxels,
proposal fields to 1e-3, fused poses within 0.5 mm (the JAX package's
golden bound).  Two full-profile parity tests with the committed weights
are marked slow, as test_torch_model.py's Panoptic one is.
"""

import dataclasses
import json
import pathlib
import pickle

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_data import _assert_same
from tests.test_torch_geometry import tiny_configs, tiny_rig
from tests.test_torch_model import _frames
from tests.test_torch_modules import nest, randomize

REPO = pathlib.Path(__file__).resolve().parent.parent
STEMS = ["panoptic_synthetic", "panoptic_synthetic_w05", "shelf_synthetic_5k",
         "shelf_synthetic_ref", "campus_synthetic", "campus_synthetic_ref"]
# each profile's make_demo_data.py line, from its YAML's header:
# (views, radius mm, centre xy, original image size, skeleton)
DEMO_LINES = {
    "panoptic": (5, 2800.0, (0.0, -500.0), (1920, 1080), "panoptic15"),
    "shelf": (5, 4500.0, (450.0, -320.0), (1032, 776), "coco17"),
    "campus": (3, 10500.0, (3000.0, 4500.0), (360, 288), "coco17"),
}


@pytest.mark.parametrize("stem", STEMS)
def test_profile_equals_yaml(stem):
    from faster_voxelpose_tpu_torch.config import load_config, profile

    built = dataclasses.asdict(profile(stem))
    assert built == dataclasses.asdict(load_config(REPO / f"configs/demo/{stem}.yaml"))
    # a path to the file names the same profile, wherever it lies
    assert dataclasses.asdict(profile(f"/somewhere/configs/demo/{stem}.yaml")) == built


def test_profile_names_only_known_stems():
    from faster_voxelpose_tpu_torch.config import PROFILES, profile

    assert sorted(PROFILES) == sorted(STEMS)
    with pytest.raises(KeyError, match="no code-side profile"):
        profile("configs/demo/shelf_synthetic.yaml")  # no snapshot trained on it
    a, b = profile("campus_synthetic"), profile("campus_synthetic")
    a.SYNTHETIC.NUM_DATA = 3
    assert b.SYNTHETIC.NUM_DATA == 5000  # a fresh config per call


def _checkpoints():
    return sorted(p.parent.name for p in (REPO / "checkpoints").glob("*/eval_record.json"))


@pytest.mark.parametrize("name", _checkpoints())
def test_validate_picks_profile_and_rig_from_record(name):
    """tools.validate reads the profile from the record's config by stem,
    whether the record holds it relative or absolute, and builds the rig
    and bank of that profile's make_demo_data.py line."""
    from faster_voxelpose_tpu_torch.config import load_config
    from faster_voxelpose_tpu_torch.datasets.demo_data import demo_pose_bank, demo_rig
    from faster_voxelpose_tpu_torch.tools.validate import read_record, snapshot_profile
    from scripts import make_demo_data as script

    ckpt = REPO / "checkpoints" / name
    stem = pathlib.PurePath(read_record(ckpt)["config"]).stem
    assert stem == name
    cfg = snapshot_profile(ckpt)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(load_config(REPO / f"configs/demo/{stem}.yaml"))
    views, radius, center, ori, skeleton = DEMO_LINES[stem.split("_")[0]]
    want = script.make_rig(views, radius, 2200.0, center, ori)
    got = demo_rig(cfg)
    assert sorted(got) == list(range(views))
    for k in got:
        for key, value in want[str(k)].items():
            np.testing.assert_array_equal(got[k][key], np.array(value))
    bank = demo_pose_bank(cfg)
    ref = script.make_pose_bank(2000, skeleton=skeleton)
    assert len(bank) == 2000 and bank[0]["pose"].shape == (cfg.DATASET.NUM_JOINTS, 3)
    for i in (0, 1999):
        np.testing.assert_array_equal(bank[i]["pose"], ref[i]["pose"])


@pytest.mark.parametrize("stem", ["shelf_synthetic_ref", "campus_synthetic_ref"])
def test_held_out_scenes_match_jax(stem, tmp_path):
    """The port's held-out scenes of a Shelf or Campus profile equal the
    JAX package's SyntheticDataset on the calibration and pose bank that
    the profile's make_demo_data.py line writes: the same records and the
    same samples (augmentation draws included), and a prefix of the
    longer set."""
    from faster_voxelpose_tpu.config import load_config as jax_load
    from faster_voxelpose_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
    from faster_voxelpose_tpu_torch.config import profile
    from faster_voxelpose_tpu_torch.tools.validate import held_out_dataset
    from scripts import make_demo_data as script

    views, radius, center, ori, skeleton = DEMO_LINES[stem.split("_")[0]]
    (tmp_path / "calibration_demo.json").write_text(
        json.dumps(script.make_rig(views, radius, 2200.0, center, ori)))
    with open(tmp_path / "demo_pose_bank.pkl", "wb") as f:
        pickle.dump(script.make_pose_bank(2000, skeleton=skeleton), f)
    jcfg = jax_load(REPO / f"configs/demo/{stem}.yaml")
    jcfg.DATASET.DATADIR, jcfg.SYNTHETIC.NUM_DATA = str(tmp_path), 4
    ref = JaxSynthetic(jcfg, is_train=False)
    ours = held_out_dataset(profile(stem), scenes=4)
    assert len(ours) == len(ref) == 4
    for r, o in zip(ref.records, ours.records):
        np.testing.assert_array_equal(o.joints_3d, r.joints_3d)
        np.testing.assert_array_equal(o.joints_3d_vis, r.joints_3d_vis)
    for i in range(2):
        _assert_same(ours[i], ref[i])
    sample = ours[2]
    K, J = jcfg.CAPTURE_SPEC.MAX_PEOPLE, jcfg.DATASET.NUM_JOINTS
    assert J == 17 and sample["hm_params"].shape == (views, K, J, 12)
    prefix = held_out_dataset(profile(stem), scenes=2)
    for a, b in zip(prefix.records, ours.records):
        np.testing.assert_array_equal(a.joints_3d, b.joints_3d)


def _coco_tiny(width):
    """The tiny geometry at the Shelf and Campus joint set: 17 joints,
    root the mean of joints 11 and 12, 3 views, K = 5, and at `width`."""
    return tiny_configs(
        DATASET__NUM_JOINTS=17, DATASET__ROOT_JOINT_ID=[11, 12], CAPTURE_SPEC__MAX_PEOPLE=5,
        CAPTURE_SPEC__MIN_SCORE=-1e9, INDIVIDUAL_SPEC__SPACE_SIZE=(2100.0,) * 3,
        NETWORK__WIDTH_MULT=width,
        NETWORK__NUM_CHANNEL_JOINT_FEAT=16 if width != 1.0 else 32,
        NETWORK__NUM_CHANNEL_JOINT_HIDDEN=32 if width != 1.0 else 64,
    )


@pytest.mark.parametrize("width", [1.0, 0.5])
def test_tiny_coco17_model_matches_jax(width):
    """17 joints (the crop kernel's lanes half full past 16, the
    soft-argmax and the plane fusion at J = 17), 3 views, K = 5, float32,
    random flax weights carried across, every proposal slot valid (the
    2100 mm person box of test_torch_model.py keeps the crop origins off
    their ties): the same proposal voxels, proposal fields to 1e-3,
    plane and fused poses within 0.5 mm."""
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    jcfg, pcfg = _coco_tiny(width)
    V, J, K = pcfg.DATASET.CAMERA_NUM, pcfg.DATASET.NUM_JOINTS, pcfg.CAPTURE_SPEC.MAX_PEOPLE
    assert (V, J, K) == (3, 17, 5) and pcfg.DATASET.ROOT_JOINT_ID == [11, 12]
    W, H = pcfg.DATASET.HEATMAP_SIZE
    hm = _frames(V, H, W, J, 2, seed=11)
    cams = np.stack([tiny_rig(V)] * 2)
    jm = jax_build(jcfg)
    flat = randomize(jm.init(jax.random.PRNGKey(0), hm[:1], cams[:1], train=False), seed=6)
    flat["params/hdn/center_net/size_out/kernel"] *= 0.01
    flat["params/hdn/center_net/size_out/bias"] = np.array([0.6, 0.7], np.float32)
    ref = jax.jit(lambda v, h, c: jm.apply(v, h, c, train=False))(nest(flat), hm, cams)

    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(flat, model))
    with torch.no_grad():
        out = model(torch.as_tensor(hm), torch.as_tensor(cams))
    pc, rpc = out.proposal_centers.numpy(), np.asarray(ref.proposal_centers)
    assert pc.shape == (2, K, 7) and (rpc[:, :, 3] >= 0).all()
    geom = model.geom
    scale = np.asarray(geom.space_size) / (np.asarray(geom.voxels_per_axis) - 1)
    bias = np.asarray(geom.space_center) - np.asarray(geom.space_size) / 2
    np.testing.assert_array_equal(
        np.round((pc[..., :3] - bias) / scale), np.round((rpc[..., :3] - bias) / scale))
    np.testing.assert_allclose(pc, rpc, atol=1e-3)
    np.testing.assert_allclose(out.plane_poses.numpy(), np.asarray(ref.plane_poses), atol=0.5)
    fused, rfused = out.fused_poses.numpy(), np.asarray(ref.fused_poses)
    assert fused.shape == rfused.shape == (2, K, J, 5)
    assert np.max(np.abs(fused[..., :3] - rfused[..., :3])) <= 0.5
    np.testing.assert_allclose(fused[..., 3:], rfused[..., 3:], atol=1e-3)
    # every joint's estimate moves with its own maps: no two joints agree
    assert np.min(np.ptp(fused[..., :3], axis=2)) > 1.0


def _full_profile_parity(stem, scenes=4):
    """The profile of `stem` with its committed weights, float32 on both
    sides, the first `scenes` held-out scenes rendered on the port's
    device renderer: the same proposal voxels, proposal fields to 1e-3,
    fused poses of the valid slots within 0.5 mm."""
    from faster_voxelpose_tpu.config import load_config as jax_load
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu_torch.config import profile
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.ops.heatmap_render import render_heatmaps_device
    from faster_voxelpose_tpu_torch.tools.validate import held_out_dataset
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    jcfg = jax_load(REPO / f"configs/demo/{stem}.yaml")
    jcfg.NETWORK.COMPUTE_DTYPE = "float32"
    jcfg.NETWORK.SAMPLING_BACKEND = "quad"
    pcfg = profile(stem)
    pcfg.NETWORK.COMPUTE_DTYPE = "float32"
    with np.load(REPO / f"checkpoints/{stem}/model_best.npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    jm = jax_build(jcfg)
    forward = jax.jit(lambda v, h, c: jm.apply(v, h, c, train=False))
    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(flat, model))
    geom = model.geom
    scale = np.asarray(geom.space_size) / (np.asarray(geom.voxels_per_axis) - 1)
    bias = np.asarray(geom.space_center) - np.asarray(geom.space_size) / 2
    W, H = pcfg.DATASET.HEATMAP_SIZE
    dataset = held_out_dataset(profile(stem), scenes=scenes)
    for i in range(scenes):
        sample = dataset[i]
        hm = render_heatmaps_device(torch.as_tensor(sample["hm_params"])[None], H, W).numpy()
        cams = sample["cameras"][None].astype(np.float32)
        ref = forward(nest(flat), hm, cams)
        with torch.no_grad():
            out = model(torch.as_tensor(hm), torch.as_tensor(cams))
        pc, rpc = out.proposal_centers.numpy(), np.asarray(ref.proposal_centers)
        np.testing.assert_array_equal(  # the same proposal voxels, in the same order
            np.round((pc[..., :3] - bias) / scale), np.round((rpc[..., :3] - bias) / scale))
        np.testing.assert_allclose(pc, rpc, atol=1e-3)
        valid = rpc[0, :, 3] >= 0
        assert valid.any()
        d = out.fused_poses.numpy()[0, valid, :, :3] - np.asarray(ref.fused_poses)[0, valid, :, :3]
        assert np.abs(d).max() <= 0.5


@pytest.mark.slow
def test_full_shelf_profile_matches_jax_with_committed_weights():
    _full_profile_parity("shelf_synthetic_ref")


@pytest.mark.slow
def test_full_campus_profile_matches_jax_with_committed_weights():
    _full_profile_parity("campus_synthetic_ref")
