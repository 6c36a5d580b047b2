"""PyTorch port, every dataset and heatmap source on the CPU, held against
the JAX package on the same fixtures and seeds:

- `ShelfDataset` and `CampusDataset` on the fixtures of
  tests/test_shelf_campus_loader.py (actorsGT.mat, the prediction pickle,
  the flat calibration): the same records, used frames, 'pred' heatmaps
  (bit for bit: the same native renderer and draws) and PCP3D message;
- `PanopticDataset` on a sequence written here (calibration JSON,
  hdPose3d_stage1_coco19/*.json, hdImgs/*.jpg through cv2): the same
  records, the record cache's round trip, the 'image' source's uint8
  frames, the 'gt' source's host heatmaps, and the metric message;
- the loader's spawn pool with host rendering against the JAX loader;
- `run_validation` on the Shelf fixture, and with a backbone on the
  Panoptic fixture's frames (from the batch and from an `image_loader`):
  fused poses within 0.5 mm and scores within 1e-3 of the JAX package's
  (the tolerance of the model parity tests), the same metric message;
- `tools/train.py`, one epoch with host rendering (DEVICE_RENDER false)
  and two spawn workers; and Trainer steps on loader-made 'images' and
  'input_heatmaps' batches.
"""

import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

import jax

from tests.test_shelf_campus_loader import write_fixtures
from tests.test_torch_geometry import tiny_configs
from tests.test_torch_modules import nest, randomize

cv2 = pytest.importorskip("cv2")
pytest.importorskip("scipy")

SHELF_FRAMES = [300, 301, 302, 305, 307]
CAMPUS_FRAMES = [350, 351, 360, 650, 700]
SEQ = "160906_pizza1"


def _same_samples(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def _pred_cfgs(root, name, **overrides):
    """(JAX, port) configs of the tiny geometry at 17 joints, reading the
    Shelf-format fixture under `root` with the 'pred' source."""
    kw = dict(DATASET__NUM_JOINTS=17, DATASET__ROOT_JOINT_ID=[11, 12],
              DATASET__ORI_IMAGE_SIZE=(1032, 776), DATASET__DATADIR=str(root),
              DATASET__TEST_DATASET=name, DATASET__TEST_HEATMAP_SRC="pred")
    kw.update(overrides)
    jcfg, pcfg = tiny_configs(**kw)
    jcfg.DATASET.__post_init__()
    return jcfg, pcfg


def _write_campus(root):
    """The Shelf fixture under the Campus file names."""
    truth = write_fixtures(str(root), CAMPUS_FRAMES, seed=3)
    for a, b in (("calibration_shelf.json", "calibration_campus.json"),
                 ("pred_shelf_maskrcnn_hrnet_coco.pkl", "pred_campus_maskrcnn_hrnet_coco.pkl")):
        shutil.move(str(root / a), str(root / b))
    return truth


@pytest.fixture(scope="module")
def pred_datasets(tmp_path_factory):
    """{'shelf' | 'campus': (JAX dataset, port dataset, truth, frames)} on
    fixtures written into temporary directories; FRAME_RANGE restricted
    to the fixtures' frames."""
    from faster_voxelpose_tpu.datasets import shelf_campus as jsc
    from faster_voxelpose_tpu_torch.datasets import shelf_campus as psc

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, frames in (("shelf", SHELF_FRAMES), ("campus", CAMPUS_FRAMES)):
            root = tmp_path_factory.mktemp(name)
            truth = write_fixtures(str(root), frames) if name == "shelf" else _write_campus(root)
            cls = name.capitalize() + "Dataset"
            for mod in (jsc, psc):
                mp.setattr(getattr(mod, cls), "FRAME_RANGE", frames)
            jcfg, pcfg = _pred_cfgs(root, name)
            out[name] = (getattr(jsc, cls)(jcfg), getattr(psc, cls)(pcfg), truth, frames)
    return out


@pytest.mark.parametrize("name", ["shelf", "campus"])
def test_pred_datasets_match_jax(pred_datasets, name):
    jds, pds, truth, frames = pred_datasets[name]
    assert pds.used_frames == jds.used_frames == frames and len(pds) == len(frames)
    for a, b in zip(pds.records, jds.records):
        assert a.seq == b.seq == name and a.joints_3d is None
        assert len(a.pred_pose2d) == len(b.pred_pose2d) == 3
        for va, vb in zip(a.pred_pose2d, b.pred_pose2d):
            for pa, pb in zip(va, vb):
                np.testing.assert_array_equal(pa, pb)
    for i in range(len(pds)):
        ours, ref = pds[i], jds[i]
        assert set(ours) == {"cameras", "input_heatmaps"}
        assert ours["input_heatmaps"].shape == (3, 32, 40, 17)
        _same_samples(ours, ref)
    assert pds[0]["input_heatmaps"].max() > 0.3


@pytest.mark.parametrize("name", ["shelf", "campus"])
@pytest.mark.parametrize("quality", ["perfect", "garbage"])
def test_pcp3d_message_matches_jax(pred_datasets, name, quality):
    jds, pds, truth, frames = pred_datasets[name]
    K, J = 4, 17
    preds = np.zeros((len(frames), K, J, 5), np.float32)
    preds[..., 3] = -1.0
    for i, fi in enumerate(frames):
        for a in range(2):
            preds[i, a, :, :3] = truth[(a, fi)] * 1000.0 if quality == "perfect" else 99999.0
            preds[i, a, :, 3], preds[i, a, :, 4] = 0.0, 0.9
    (m, msg), (rm, rmsg) = pds.evaluate(preds), jds.evaluate(preds)
    assert msg == rmsg and m == rm
    if quality == "garbage":
        assert m < 0.2
    elif name == "shelf":  # the fixture's GT is written through coco_to_shelf_pose
        assert m == pytest.approx(1.0)


# -- Panoptic ---------------------------------------------------------------

M_SWAP = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])


def write_panoptic_sequence(root, seq=SEQ, n_frames=7, size=(1920, 1080), seed=0):
    """A Panoptic sequence in the raw format under root/seq: the
    calibration of the five HD cameras (tests/test_geometry.make_camera,
    converted back to Panoptic axes and cm), joints19 bodies of two people
    per frame (cm, Panoptic axes, confidence 1), and one JPEG per camera
    and frame, written by cv2 at `size`.  Returns each frame's two (15, 3)
    poses in millimetres."""
    from tests.test_geometry import make_camera

    seq_dir = pathlib.Path(root) / seq
    anno = seq_dir / "hdPose3d_stage1_coco19"
    anno.mkdir(parents=True, exist_ok=True)
    cams = []
    for i, (panel, node) in enumerate([(0, 3), (0, 6), (0, 12), (0, 13), (0, 23)]):
        c = make_camera(i)
        K = np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1.0]])
        R_raw = c["R"] @ np.linalg.inv(M_SWAP)
        t = -(c["R"] @ c["T"]) / 10.0  # the loader takes T = -R^T t * 10, R = R_raw M
        dist = np.zeros(5)
        dist[[0, 1, 4]] = c["k"].ravel()
        dist[[2, 3]] = c["p"].ravel()
        cams.append({"panel": panel, "node": node, "K": K.tolist(), "distCoef": dist.tolist(),
                     "R": R_raw.tolist(), "t": t.reshape(3, 1).tolist()})
    (seq_dir / f"calibration_{seq}.json").write_text(json.dumps({"cameras": cams}))
    rng = np.random.RandomState(seed)
    W, H = size
    ys, xs = np.mgrid[0:H, 0:W]
    truth = []
    for fi in range(n_frames):
        bodies, frame_truth = [], []
        for _ in range(2):
            xyz_mm = rng.uniform([-1000, -1000, 200], [1000, 1000, 1500], (19, 3))
            raw = (xyz_mm / 10.0) @ np.linalg.inv(M_SWAP)
            bodies.append({"joints19": np.concatenate([raw, np.ones((19, 1))], 1).ravel().tolist()})
            frame_truth.append(xyz_mm[:15])
        truth.append(frame_truth)
        (anno / f"body3DScene_{fi:08d}.json").write_text(json.dumps({"bodies": bodies}))
        for v, (panel, node) in enumerate([(0, 3), (0, 6), (0, 12), (0, 13), (0, 23)]):
            prefix = f"{panel:02d}_{node:02d}"
            img_dir = seq_dir / "hdImgs" / prefix
            img_dir.mkdir(parents=True, exist_ok=True)
            img = np.stack([(xs * (v + 1) + fi * 7) % 256, (ys * 2 + v * 40) % 256,
                            ((xs + ys) // 4 + fi * 30) % 256], -1).astype(np.uint8)
            cv2.imwrite(str(img_dir / f"{prefix}_{fi:08d}.jpg"), img)
    return truth


def _panoptic_cfgs(root, src="image", **overrides):
    """(JAX, port) configs of the tiny geometry (3 views, 15 joints,
    160x128 frames -> 40x32 heatmaps) reading the Panoptic fixture,
    frames of 1920x1080 warped on the host."""
    kw = dict(DATASET__ORI_IMAGE_SIZE=(1920, 1080), DATASET__DATADIR=str(root),
              DATASET__TRAIN_DATASET="panoptic", DATASET__TEST_DATASET="panoptic",
              DATASET__TRAIN_HEATMAP_SRC=src, DATASET__TEST_HEATMAP_SRC=src)
    kw.update(overrides)
    jcfg, pcfg = tiny_configs(**kw)
    jcfg.DATASET.__post_init__()
    return jcfg, pcfg


@pytest.fixture(scope="module")
def panoptic_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("panoptic")
    return root, write_panoptic_sequence(root)


@pytest.fixture
def one_sequence(monkeypatch):
    from faster_voxelpose_tpu.datasets import panoptic as jp
    from faster_voxelpose_tpu_torch.datasets import panoptic as pp

    for mod in (jp, pp):
        monkeypatch.setattr(mod, "TRAIN_SEQUENCES", [SEQ])
        monkeypatch.setattr(mod, "VAL_SEQUENCES", [SEQ])


def _panoptic_pair(root, src="image", is_train=True, **overrides):
    from faster_voxelpose_tpu.datasets.panoptic import PanopticDataset as JaxPanoptic
    from faster_voxelpose_tpu_torch.datasets import PanopticDataset

    jcfg, pcfg = _panoptic_cfgs(root, src, **overrides)
    return JaxPanoptic(jcfg, is_train), PanopticDataset(pcfg, is_train)


def test_panoptic_calibration_matches_jax(panoptic_root):
    from faster_voxelpose_tpu.datasets.panoptic import load_panoptic_calibration as jax_load
    from faster_voxelpose_tpu_torch.datasets.panoptic import (HD_CAMERA_LIST,
                                                               load_panoptic_calibration)
    from tests.test_geometry import make_camera

    root, _ = panoptic_root
    path = str(root / SEQ / f"calibration_{SEQ}.json")
    ours, ref = load_panoptic_calibration(path, HD_CAMERA_LIST), jax_load(path, HD_CAMERA_LIST)
    assert len(ours) == len(ref) == 5
    for a, b, i in zip(ours, ref, range(5)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_allclose(a["T"], make_camera(i)["T"], atol=1e-9)  # cm -> mm, axes


@pytest.mark.parametrize("is_train", [True, False])
def test_panoptic_records_and_cache_match_jax(panoptic_root, one_sequence, is_train):
    """Train (interval 3) and validation (interval 12) records equal the
    JAX package's; the second construction reads the port's own cache
    and gives the same records; a cache of other sequences is refused."""
    from faster_voxelpose_tpu_torch.datasets import PanopticDataset

    root, truth = panoptic_root
    jds, pds = _panoptic_pair(root, is_train=is_train)
    step = 3 if is_train else 12
    assert len(pds) == len(jds) == len(range(0, 7, step))
    image_set = "train" if is_train else "validation"
    assert (root / f"{image_set}_records_torch.pkl").exists()
    again = PanopticDataset(pds.cfg, is_train)
    for recs in (pds.records, again.records):
        for i, (a, b) in enumerate(zip(recs, jds.records)):
            assert a.seq == b.seq == SEQ and a.image_paths == b.image_paths
            np.testing.assert_array_equal(a.joints_3d, b.joints_3d)
            np.testing.assert_array_equal(a.joints_3d_vis, b.joints_3d_vis)
            np.testing.assert_allclose(a.joints_3d, np.stack(truth[i * step]), atol=1e-6)
    import pickle

    cache = root / f"{image_set}_records_torch.pkl"
    info = pickle.loads(cache.read_bytes())
    cache.write_bytes(pickle.dumps(dict(info, sequences=["other"])))
    try:
        with pytest.raises(ValueError, match="remove it to rebuild"):
            PanopticDataset(pds.cfg, is_train)
    finally:
        cache.write_bytes(pickle.dumps(info))


@pytest.mark.parametrize("src", ["image", "gt"])
def test_panoptic_samples_match_jax(panoptic_root, one_sequence, src):
    """The 'image' source's uint8 frames (decoded and warped from
    1920x1080 on the host) and the 'gt' source's host heatmaps, with the
    supervision, equal the JAX package's samples."""
    root, _ = panoptic_root
    jds, pds = _panoptic_pair(root, src)
    for i in range(len(pds)):
        ours, ref = pds[i], jds[i]
        _same_samples(ours, ref)
    key = "images" if src == "image" else "input_heatmaps"
    assert ours[key].shape == ((3, 128, 160, 3) if src == "image" else (3, 32, 40, 15))
    assert ours[key].dtype == (np.uint8 if src == "image" else np.float32)
    assert ours[key].max() > (100 if src == "image" else 0.3)


def test_panoptic_metric_matches_jax(panoptic_root, one_sequence):
    root, _ = panoptic_root
    jds, pds = _panoptic_pair(root, is_train=False)
    K, J = 10, 15
    preds = np.zeros((len(pds), K, J, 5), np.float32)
    preds[..., 3] = -1.0
    for i, rec in enumerate(pds.records):
        for p, gt in enumerate(rec.joints_3d):
            preds[i, p, :, :3], preds[i, p, :, 3], preds[i, p, :, 4] = gt, 0.0, 0.9
    (m, msg), (rm, rmsg) = pds.evaluate(preds), jds.evaluate(preds)
    assert msg == rmsg and m == rm and m == pytest.approx(1.0, abs=1e-3)
    with pytest.raises(ValueError, match="predictions for"):
        pds.evaluate(preds[:0])


# -- the loader, with host rendering ---------------------------------------

def test_worker_pool_renders_on_the_host(tmp_path):
    """Two spawn workers make 'gt' samples with host rendering
    (DEVICE_RENDER false) equal to the JAX loader's, augmentation off."""
    from faster_voxelpose_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
    from faster_voxelpose_tpu.engine.loader import DataLoader as JaxLoader
    from faster_voxelpose_tpu_torch.datasets import get_dataset
    from faster_voxelpose_tpu_torch.engine.loader import DataLoader, DatasetFactory
    from tests.test_torch_engine import _same_batches, _tiny_cfgs

    jcfg, pcfg = _tiny_cfgs(tmp_path, augmentation=False)
    for cfg in (jcfg, pcfg):
        cfg.DATASET.DEVICE_RENDER = False
    ours = DataLoader(get_dataset("synthetic")(pcfg, is_train=True), 3, shuffle=True,
                      num_workers=2, seed=4, dataset_factory=DatasetFactory("synthetic", pcfg, True))
    ref = JaxLoader(JaxSynthetic(jcfg, is_train=True), 3, shuffle=True, seed=4)
    try:
        got = list(ours)
        _same_batches(got, list(ref))
    finally:
        ours.close()
    assert "input_heatmaps" in got[0] and "hm_params" not in got[0]
    assert got[0]["input_heatmaps"].shape == (3, 3, 32, 40, 15)


# -- validation --------------------------------------------------------------

def _random_models(jcfg, pcfg, seed=5):
    """The JAX model and the port's with the same random weights (every
    proposal slot valid, size head tamed as in tests/test_torch_eval.py)."""
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    V, J = jcfg.DATASET.CAMERA_NUM, jcfg.DATASET.NUM_JOINTS
    W, H = jcfg.DATASET.HEATMAP_SIZE
    jmodel = jax_build(jcfg)
    flat = randomize(jmodel.init(jax.random.PRNGKey(0), np.zeros((1, V, H, W, J), np.float32),
                                 np.zeros((1, V, 21), np.float32), train=False), seed=seed)
    flat["params/hdn/center_net/size_out/kernel"] *= 0.01
    flat["params/hdn/center_net/size_out/bias"] = np.array([0.6, 0.7], np.float32)
    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(flat, model))
    return jmodel, nest(flat), model


def _close_preds(preds, rpreds, shape):
    assert preds.shape == rpreds.shape == shape
    assert np.max(np.abs(preds[..., :3] - rpreds[..., :3])) <= 0.5
    np.testing.assert_allclose(preds[..., 3:], rpreds[..., 3:], atol=1e-3)


def test_run_validation_on_shelf_matches_jax(tmp_path, monkeypatch):
    """The 'pred' source end to end: Shelf fixture -> host heatmaps ->
    the model -> PCP3D, both packages, batch 2 with a padded tail."""
    from faster_voxelpose_tpu.datasets import shelf_campus as jsc
    from faster_voxelpose_tpu.engine.validator import run_validation as jax_validate
    from faster_voxelpose_tpu_torch.datasets import shelf_campus as psc
    from faster_voxelpose_tpu_torch.engine.validator import run_validation

    write_fixtures(str(tmp_path), SHELF_FRAMES)
    for mod in (jsc, psc):
        monkeypatch.setattr(mod.ShelfDataset, "FRAME_RANGE", SHELF_FRAMES)
    jcfg, pcfg = _pred_cfgs(tmp_path, "shelf", CAPTURE_SPEC__MIN_SCORE=-1e9,
                            INDIVIDUAL_SPEC__SPACE_SIZE=(2100.0,) * 3, TEST__BATCH_SIZE=2)
    jmodel, variables, model = _random_models(jcfg, pcfg)
    rmetric, rmsg, rpreds = jax_validate(jcfg, jmodel, variables, jsc.ShelfDataset(jcfg))
    metric, msg, preds = run_validation(pcfg, model, psc.ShelfDataset(pcfg), device="cpu")
    _close_preds(preds, rpreds, (5, 4, 17, 5))
    assert msg == rmsg and metric == rmetric


@pytest.fixture(scope="module")
def image_validation(panoptic_root):
    """The JAX validator's image step on the Panoptic fixture's frames
    (image_loader through load_view_images_u8, as run/validate.py does),
    a random ResNet-18 backbone scaled to heatmaps of order 1; and the
    port's configs and models with the same weights."""
    from faster_voxelpose_tpu.datasets.images import load_view_images_u8
    from faster_voxelpose_tpu.datasets.panoptic import PanopticDataset as JaxPanoptic
    from faster_voxelpose_tpu.engine.validator import run_validation as jax_validate
    from faster_voxelpose_tpu.models.resnet import build_backbone as jax_backbone
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    root, _ = panoptic_root
    with pytest.MonkeyPatch.context() as mp:
        from faster_voxelpose_tpu.datasets import panoptic as jp

        mp.setattr(jp, "TRAIN_SEQUENCES", [SEQ])
        jcfg, pcfg = _panoptic_cfgs(root, CAPTURE_SPEC__MIN_SCORE=-1e9,
                                    INDIVIDUAL_SPEC__SPACE_SIZE=(2100.0,) * 3,
                                    RESNET__NUM_LAYERS=18,
                                    RESNET__NUM_DECONV_FILTERS=(32, 32, 32), TEST__BATCH_SIZE=2)
        jds = JaxPanoptic(jcfg, True)
    jmodel, variables, model = _random_models(jcfg, pcfg)
    iw, ih = jcfg.DATASET.IMAGE_SIZE
    jbb = jax_backbone(jcfg)
    bflat = randomize(jbb.init(jax.random.PRNGKey(1), np.zeros((1, ih, iw, 3), np.float32)),
                      seed=9)
    frames = np.stack([load_view_images_u8(r.image_paths, (iw, ih), jds.resize_transform)
                       for r in jds.records])
    x = (frames[0].astype(np.float32) / 255 - 0.45) / 0.225
    raw = jbb.apply(nest(bflat), x)
    for leaf in ("kernel", "bias"):
        bflat[f"params/final/{leaf}"] /= np.float32(np.abs(np.asarray(raw)).max())
    backbone = build_backbone(pcfg)
    backbone.load_state_dict(from_jax_variables(bflat, backbone))

    def image_loader(idxs):
        return frames[idxs]

    ref = jax_validate(jcfg, jmodel, variables, jds, backbone=jbb, backbone_vars=nest(bflat),
                       image_loader=image_loader)
    return pcfg, model, backbone, image_loader, ref


@pytest.mark.parametrize("frames_from", ["batch", "image_loader"])
def test_run_validation_with_a_backbone_matches_jax(image_validation, one_sequence,
                                                     frames_from):
    """The image step: the 'image' source's uint8 frames from the batch,
    or the frames of an image_loader (the JAX package's argument), through
    the backbone and the model; 3 records at batch 2, the tail padded."""
    from faster_voxelpose_tpu_torch.datasets import PanopticDataset
    from faster_voxelpose_tpu_torch.engine.validator import run_validation

    pcfg, model, backbone, image_loader, (rmetric, rmsg, rpreds) = image_validation
    pds = PanopticDataset(pcfg, True)
    kw = {"image_loader": image_loader} if frames_from == "image_loader" else {}
    metric, msg, preds = run_validation(pcfg, model, pds, device="cpu", backbone=backbone, **kw)
    _close_preds(preds, rpreds, (3, 4, 15, 5))
    assert msg == rmsg and metric == rmetric
    with pytest.raises(ValueError, match="needs the backbone"):
        run_validation(pcfg, model, pds, device="cpu")


# -- training ----------------------------------------------------------------

def test_trainer_steps_on_loader_batches_of_every_source(panoptic_root, one_sequence):
    """Eager Trainer steps on loader-made batches of the Panoptic fixture:
    'images' through a backbone and host-rendered 'input_heatmaps' take
    the same step body; the losses are finite and the weights move."""
    from faster_voxelpose_tpu_torch.datasets import PanopticDataset
    from faster_voxelpose_tpu_torch.engine.loader import DataLoader, prefetch_to_device
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone

    root, _ = panoptic_root
    for src in ("image", "gt"):
        _, pcfg = _panoptic_cfgs(root, src, RESNET__NUM_LAYERS=18,
                                 RESNET__NUM_DECONV_FILTERS=(32, 32, 32),
                                 TRAIN__ACCUMULATION_STEPS=1)
        torch.manual_seed(0)
        model = build_model(pcfg)
        backbone = build_backbone(pcfg).eval() if src == "image" else None
        tr = Trainer(pcfg, model, backbone=backbone)
        before = [p.detach().clone() for p in model.parameters()]
        loader = DataLoader(PanopticDataset(pcfg, True), 2, shuffle=True, drop_last=True)
        n = 0
        for batch in prefetch_to_device(iter(loader), device="cpu"):
            assert ("images" in batch) == (src == "image")
            assert ("input_heatmaps" in batch) == (src == "gt")
            losses = tr.step(batch)
            assert all(bool(torch.isfinite(v)) for v in losses.values()), losses
            n += 1
        assert n == 1
        assert any(not torch.equal(a, b) for a, b in zip(before, model.parameters()))


def test_train_cli_epoch_with_host_rendering(tmp_path, monkeypatch):
    """tools/train.py, one epoch on the tiny synthetic experiment with
    DEVICE_RENDER false (heatmaps rendered on the host by the native
    renderer) and WORKERS 2 (the spawn pool, for training and for
    validation): it trains, validates and writes its snapshot."""
    from tests.test_torch_engine import TINY_YAML, _checkpoints_digest, _tiny_experiment, _train

    before = _checkpoints_digest()
    cfg = _tiny_experiment(tmp_path)
    yaml = TINY_YAML.replace("DEVICE_RENDER: true", "DEVICE_RENDER: false")
    assert yaml != TINY_YAML
    cfg.write_text(yaml.replace("WORKERS: 0", "WORKERS: 2"))
    out = _train(tmp_path, monkeypatch, "--epochs", "1")
    log = next(out.glob("tiny_*_train.log")).read_text()
    assert "epoch 0 trained in" in log and "validated 8 frames" in log
    assert "done; best metric" in log
    assert (tmp_path / "snap" / "model_best.npz").exists()
    assert _checkpoints_digest() == before


def test_held_out_factory_rebuilds_the_same_scenes():
    """tools.validate.HeldOutFactory (the spawn workers' dataset maker
    for evaluate_snapshot(workers=...)) pickles and rebuilds the held-out
    scenes of its profile, and host-rendered samples equal the JAX
    package's held-out set rendered on the host."""
    import pickle

    from faster_voxelpose_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
    from faster_voxelpose_tpu_torch.config import profile
    from faster_voxelpose_tpu_torch.tools.validate import HeldOutFactory, held_out_dataset

    cfg = profile("campus_synthetic_ref")
    cfg.DATASET.DEVICE_RENDER = False
    ours = held_out_dataset(cfg, 3)
    again = pickle.loads(pickle.dumps(HeldOutFactory(cfg, 3)))()
    assert len(again) == len(ours) == 3
    for a, b in zip(again.records, ours.records):
        np.testing.assert_array_equal(a.joints_3d, b.joints_3d)
    import dataclasses

    from faster_voxelpose_tpu.config import Config as JaxConfig

    jcfg = JaxConfig()
    for section in ("DATASET", "SYNTHETIC", "CAPTURE_SPEC", "INDIVIDUAL_SPEC", "NETWORK", "TRAIN"):
        for k, v in dataclasses.asdict(getattr(cfg, section)).items():
            if hasattr(getattr(jcfg, section), k):
                setattr(getattr(jcfg, section), k, v)
    ref = JaxSynthetic(jcfg, is_train=False, pose_bank=ours.pose_bank,
                       cameras=ours.cameras["synthetic"])
    for i in range(3):  # one call each: a sample draws its augmentation
        sample = ours[i]
        assert "input_heatmaps" in sample
        _same_samples(sample, ref[i])


def test_worker_pool_makes_pred_and_image_samples(tmp_path):
    """Spawn workers rebuild ShelfDataset ('pred') and PanopticDataset
    ('image') from their files through DatasetFactory and make the
    samples the dataset makes in this process."""
    from faster_voxelpose_tpu_torch.datasets import PanopticDataset, ShelfDataset
    from faster_voxelpose_tpu_torch.engine.loader import DataLoader, DatasetFactory
    from tests.test_torch_engine import _same_batches

    write_fixtures(str(tmp_path), list(range(300, 304)))  # the first slots of FRAME_RANGE
    _, shelf_cfg = _pred_cfgs(tmp_path, "shelf")
    # a real training sequence's name: the workers import the module afresh
    write_panoptic_sequence(tmp_path / "pan", "160422_ultimatum1", n_frames=6, size=(480, 270))
    _, pan_cfg = _panoptic_cfgs(tmp_path / "pan")
    for name, cfg, cls, is_train in (("shelf", shelf_cfg, ShelfDataset, False),
                                     ("panoptic", pan_cfg, PanopticDataset, True)):
        ds = cls(cfg, is_train)
        ours = DataLoader(ds, 2, num_workers=2, dataset_factory=DatasetFactory(name, cfg, is_train))
        try:
            got = list(ours)
        finally:
            ours.close()
        assert len(ds) >= 2
        _same_batches(got, list(DataLoader(cls(cfg, is_train), 2)))
        assert ("input_heatmaps" if name == "shelf" else "images") in got[0]
