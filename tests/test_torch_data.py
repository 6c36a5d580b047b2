"""PyTorch port, the data side of training and the weight files: the
demo rig and pose-bank generators, synthetic scenes, samples and
collated batches in the loader's seeded order, the flat calibration
format and PoseService.set_rig_from_calibration, and the path-keyed npz
snapshots in both directions.  Everything is compared for exact equality
with the JAX package (the same seeds and the same numpy op order).
"""

import pathlib

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent


def _synthetic_cfgs(num_data=6):
    """Tiny geometry (__graft_entry__) with the synthetic 'gt' source,
    device rendering and augmentation on, for both packages."""
    from tests.test_torch_geometry import tiny_configs

    jcfg, pcfg = tiny_configs()
    for cfg in (jcfg, pcfg):
        d = cfg.DATASET
        d.TRAIN_DATASET, d.TRAIN_HEATMAP_SRC, d.DEVICE_RENDER = "synthetic", "gt", True
        cfg.SYNTHETIC.MAX_PEOPLE, cfg.SYNTHETIC.NUM_DATA = 4, num_data
        cfg.SYNTHETIC.DATA_AUGMENTATION = True
        cfg.TRAIN.SEED = 7
    return jcfg, pcfg


def _fixtures(cfg):
    from faster_voxelpose_tpu_torch.datasets.demo_data import make_pose_bank, make_rig

    rig = make_rig(cfg.DATASET.CAMERA_NUM, 2600.0, 2200.0, cfg.CAPTURE_SPEC.SPACE_CENTER[:2],
                   cfg.DATASET.ORI_IMAGE_SIZE)
    return make_pose_bank(40), {int(k): {kk: np.array(vv) for kk, vv in v.items()}
                                for k, v in rig.items()}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_demo_generators_match_the_script():
    from faster_voxelpose_tpu_torch.datasets import demo_data
    from scripts import make_demo_data as script

    for args in ((5, 2800.0, 2200.0, (0.0, -500.0), (1920, 1080)), (3, 4500.0, 2200.0, (0.0, 0.0), (1032, 776))):
        assert demo_data.make_rig(*args) == script.make_rig(*args)
    for skel in ("panoptic15", "coco17"):
        ours, ref = demo_data.make_pose_bank(30, skeleton=skel), script.make_pose_bank(30, skeleton=skel)
        for a, b in zip(ours, ref):
            _assert_same(a, b)


def test_synthetic_samples_match_jax():
    """The same seed gives the same scenes and the same samples, the
    augmentation draws of the device renderer's parameters included."""
    from faster_voxelpose_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
    from faster_voxelpose_tpu_torch.datasets import SyntheticDataset

    jcfg, pcfg = _synthetic_cfgs()
    bank, cams = _fixtures(pcfg)
    ref = JaxSynthetic(jcfg, pose_bank=bank, cameras=cams)
    ours = SyntheticDataset(pcfg, pose_bank=bank, cameras=cams)
    assert len(ours) == len(ref) == 6
    for r, o in zip(ref.records, ours.records):
        np.testing.assert_array_equal(o.joints_3d, r.joints_3d)
        np.testing.assert_array_equal(o.joints_3d_vis, r.joints_3d_vis)
    people = 0
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        _assert_same(a, b)
        people += int(a["num_person"])
        assert a["hm_params"].shape == (3, 4, 15, 12)
    assert people > len(ref) and (ours[0]["hm_params"][..., 3] > 0).any()


def test_loader_batches_match_jax():
    """Two shuffled epochs of collated batches in the JAX loader's order."""
    from faster_voxelpose_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
    from faster_voxelpose_tpu.engine.loader import DataLoader as JaxLoader
    from faster_voxelpose_tpu_torch.datasets import SyntheticDataset
    from faster_voxelpose_tpu_torch.engine.loader import DataLoader

    jcfg, pcfg = _synthetic_cfgs(num_data=7)
    bank, cams = _fixtures(pcfg)
    ref = JaxLoader(JaxSynthetic(jcfg, pose_bank=bank, cameras=cams), 2, shuffle=True,
                    drop_last=True, seed=3)
    ours = DataLoader(SyntheticDataset(pcfg, pose_bank=bank, cameras=cams), 2, shuffle=True,
                      drop_last=True, seed=3)
    assert len(ours) == len(ref) == 3
    for _ in range(2):
        ref_batches, our_batches = list(ref), list(ours)
        assert len(our_batches) == 3
        for a, b in zip(our_batches, ref_batches):
            _assert_same(a, b)


def test_host_order_shards_like_jax():
    """The one-host record order of the JAX loader, epoch after epoch,
    shuffled for several seeds and in order without shuffling."""
    from faster_voxelpose_tpu.engine.loader import DataLoader as JaxLoader
    from faster_voxelpose_tpu_torch.engine.loader import DataLoader

    data = list(range(11))
    for shuffle, seed in ((True, 5), (True, 0), (False, 5)):
        ref = JaxLoader(data, 1, shuffle=shuffle, seed=seed)
        ours = DataLoader(data, 1, shuffle=shuffle, seed=seed)
        assert len(ours) == len(data)
        for _ in range(3):
            assert ours._host_order().tolist() == ref._host_order().tolist()


def test_batch_renders_on_the_device_path():
    """A collated batch moves to tensors and the trainer renders its
    heatmaps from 'hm_params', as the JAX package's train step does."""
    from faster_voxelpose_tpu.ops.heatmap_render import render_heatmaps_device as jax_render
    from faster_voxelpose_tpu_torch.datasets import SyntheticDataset, collate
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer, batch_to_device
    from faster_voxelpose_tpu_torch.models import build_model

    _, pcfg = _synthetic_cfgs(num_data=2)
    bank, cams = _fixtures(pcfg)
    ds = SyntheticDataset(pcfg, pose_bank=bank, cameras=cams)
    batch = batch_to_device(collate([ds[0], ds[1]]), "cpu")
    assert batch["hm_params"].dtype == torch.float32 and batch["mask"].dtype == torch.bool
    hm = Trainer(pcfg, build_model(pcfg)).heatmaps(batch)
    W, H = pcfg.DATASET.HEATMAP_SIZE
    ref = np.asarray(jax_render(batch["hm_params"].numpy(), H, W))
    assert hm.shape == (2, 3, H, W, 15)
    np.testing.assert_allclose(hm.numpy(), ref, atol=1e-6)


def test_calibration_sets_the_service_rig(tmp_path):
    from faster_voxelpose_tpu.datasets.shelf_campus import load_flat_calibration as jax_load
    from faster_voxelpose_tpu_torch.datasets.demo_data import make_rig, write_calibration
    from faster_voxelpose_tpu_torch.datasets.shelf_campus import load_flat_calibration
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.geometry import pack_rig
    from tests.test_torch_geometry import tiny_configs

    _, pcfg = tiny_configs()
    path = tmp_path / "calibration.json"
    write_calibration(str(path), make_rig(4, 3000.0, 2200.0, (0.0, 0.0), (320, 240)))
    ours, ref = load_flat_calibration(str(path)), jax_load(str(path))
    assert sorted(ours) == sorted(ref) == [0, 1, 2, 3]
    for k in ref:
        _assert_same(ours[k], ref[k])
    svc = PoseService(pcfg, device="cpu")
    rig = svc.set_rig_from_calibration(str(path))
    np.testing.assert_array_equal(rig, pack_rig([ours[k] for k in range(3)]).astype(np.float32))
    np.testing.assert_array_equal(svc._require_rig().numpy()[0], rig)


def test_to_jax_variables_inverts_from_jax_variables():
    """to(from(v)) == v exactly on every committed snapshot."""
    from faster_voxelpose_tpu_torch.weights import from_jax_variables, to_jax_variables

    paths = sorted(REPO.glob("checkpoints/*/model_best.npz"))
    assert len(paths) == 6
    for path in paths:
        with np.load(path) as npz:
            flat = {k: npz[k] for k in npz.files}
        back = to_jax_variables(from_jax_variables(flat))
        assert back.keys() == flat.keys(), path
        for k, v in flat.items():
            assert back[k].shape == v.shape and np.array_equal(back[k], v), (path, k)


def test_snapshot_round_trip_between_packages(tmp_path):
    """A port model saved with save_best_npz loads into the JAX package's
    variables (its load_best_npz) and back into the port unchanged."""
    from faster_voxelpose_tpu.engine.checkpoint import load_best_npz as jax_load_best
    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.engine.checkpoint import load_best_npz, save_best_npz
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.weights import from_jax_variables
    from tests.test_torch_modules import nest

    cfg = panoptic_synthetic_profile()
    with np.load(REPO / "checkpoints/panoptic_synthetic/model_best.npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    torch.manual_seed(0)
    model = build_model(cfg)  # random weights, unlike the snapshot's
    path = tmp_path / "model_best.npz"
    written = save_best_npz(str(path), model)
    assert written.keys() == flat.keys()
    restored = jax_load_best(str(path), nest(flat))
    twin = load_best_npz(str(path), build_model(cfg))
    want = model.state_dict()
    for k, v in from_jax_variables(restored, twin).items():
        assert torch.equal(v, want[k]), k
    for k, v in twin.state_dict().items():
        assert torch.equal(v, want[k]), k
