"""PyTorch port, `utils/vis.py` against the JAX package's on the same numpy
inputs: the bone tables are equal, and each of the five drawing functions
writes files of the same names whose decoded pixels are equal (the same
code on the same canvas), with and without a resize transform.
"""

import pathlib

import numpy as np
import pytest


def _inputs(cfg, n=1, views=2, seed=0):
    """Fused poses (n, K, J, 5) with valid and invalid slots, proposal
    centres (n, K, 7), heatmaps (n, V, H, W, J), frames and rigs."""
    from tests.test_torch_geometry import tiny_rig

    rng = np.random.RandomState(seed)
    K, J = cfg.CAPTURE_SPEC.MAX_PEOPLE, cfg.DATASET.NUM_JOINTS
    W, H = cfg.DATASET.HEATMAP_SIZE
    ow, oh = cfg.DATASET.ORI_IMAGE_SIZE
    fused = np.zeros((n, K, J, 5), np.float32)
    fused[..., :2] = rng.uniform(-1200, 1200, (n, K, 1, 2)) + rng.uniform(-200, 200, (n, K, J, 2))
    fused[..., 2] = rng.uniform(100, 1700, (n, K, J))
    fused[..., 3] = np.where(np.arange(K) < K - 1, 0.0, -1.0)[None, :, None]  # last slot invalid
    fused[..., 4] = rng.rand(n, K, 1)
    centers = np.concatenate([fused[:, :, 0, :3], fused[:, :, 0, 3:5], rng.uniform(0.3, 0.9, (n, K, 2))],
                             -1).astype(np.float32)
    heatmaps = rng.rand(n, views, H, W, J).astype(np.float32)
    images = [[rng.randint(0, 256, (oh, ow, 3)).astype(np.uint8) for _ in range(views)]
              for _ in range(n)]
    rigs = np.stack([tiny_rig(views)] * n)
    return fused, centers, heatmaps, images, rigs


def _pixels(root):
    import cv2

    root = pathlib.Path(root)
    return {p.relative_to(root).as_posix(): cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
            for p in sorted(root.rglob("*")) if p.is_file()}


def _same_artifacts(tmp_path, draw):
    """draw(vis_module, cfg, prefix) in both packages into two directories:
    the same file names (relative) and equal decoded pixels."""
    from faster_voxelpose_tpu.utils import vis as jax_vis
    from faster_voxelpose_tpu_torch.utils import vis
    from tests.test_torch_geometry import tiny_configs

    jcfg, pcfg = tiny_configs()
    jcfg.TEST.VIS_TYPE = pcfg.TEST.VIS_TYPE = ("2d_planes", "image_with_poses", "heatmaps")
    jcfg.TRAIN.VIS_TYPE = pcfg.TRAIN.VIS_TYPE = ("2d_planes", "image_with_poses")
    out = {}
    for name, module, cfg in (("jax", jax_vis, jcfg), ("port", vis, pcfg)):
        root = tmp_path / name
        written = draw(module, cfg, str(root / "vis" / "a"))
        written = [written] if isinstance(written, str) else written
        out[name] = ([pathlib.Path(p).relative_to(root).as_posix() for p in written], _pixels(root))
    (jnames, jpix), (pnames, ppix) = out["jax"], out["port"]
    assert pnames == jnames and pnames
    assert sorted(ppix) == sorted(jpix)
    for k in jpix:
        assert ppix[k] is not None and ppix[k].shape == jpix[k].shape, k
        np.testing.assert_array_equal(ppix[k], jpix[k], err_msg=k)
    return pnames


def test_bone_tables_equal():
    from faster_voxelpose_tpu.utils import vis as jax_vis
    from faster_voxelpose_tpu_torch.utils import vis

    for name in ("PANOPTIC_BONES", "COCO17_BONES", "SHELF14_BONES", "BONES_BY_JOINTS"):
        assert getattr(vis, name) == getattr(jax_vis, name), name
    for j in (14, 15, 16, 17):
        assert vis._bones_for(j) == jax_vis._bones_for(j)


def test_save_2d_planes_matches_jax(tmp_path):
    def draw(m, cfg, prefix):
        fused, centers, *_ = _inputs(cfg)
        return m.save_2d_planes(cfg, fused[0], centers[0], prefix)

    assert _same_artifacts(tmp_path, draw) == ["vis/a_2d_planes.png"]


@pytest.mark.parametrize("resized", [False, True])
def test_save_image_with_poses_matches_jax(tmp_path, resized):
    def draw(m, cfg, prefix):
        fused, _, _, images, rigs = _inputs(cfg, seed=1)
        rt = None
        if resized:  # frames at IMAGE_SIZE, pixels through the resize affine
            from faster_voxelpose_tpu_torch.geometry.transforms import get_resize_transform

            rt = get_resize_transform(cfg.DATASET.ORI_IMAGE_SIZE, cfg.DATASET.IMAGE_SIZE)
            iw, ih = cfg.DATASET.IMAGE_SIZE
            images = [[im[:ih, :iw] for im in views] for views in images]
        return m.save_image_with_poses(cfg, images[0], fused[0], rigs[0], prefix, rt)

    assert _same_artifacts(tmp_path, draw) == ["vis/a_view0_poses.jpg", "vis/a_view1_poses.jpg"]


def test_save_heatmaps_matches_jax(tmp_path):
    def draw(m, cfg, prefix):
        return m.save_heatmaps(_inputs(cfg, seed=2)[2][0], prefix)

    assert _same_artifacts(tmp_path, draw) == ["vis/a_view0_heatmaps.png",
                                               "vis/a_view1_heatmaps.png"]


def test_test_vis_all_matches_jax(tmp_path):
    """Every TEST.VIS_TYPE kind for each sample."""
    def draw(m, cfg, prefix):
        fused, centers, heatmaps, images, rigs = _inputs(cfg, n=1, seed=3)
        return m.test_vis_all(cfg, None, fused, centers, heatmaps, prefix, images=images,
                              packed_rigs=rigs)

    assert len(_same_artifacts(tmp_path, draw)) == 1 + 2 + 2


def test_train_vis_all_matches_jax(tmp_path):
    """TRAIN.VIS_TYPE's kinds (here no heatmaps) for each of two samples."""
    def draw(m, cfg, prefix):
        fused, centers, heatmaps, images, rigs = _inputs(cfg, n=2, seed=4)
        return m.train_vis_all(cfg, fused, centers, heatmaps, prefix, images=images,
                               packed_rigs=rigs)

    names = _same_artifacts(tmp_path, draw)
    assert names == ["vis/a_0000_2d_planes.png", "vis/a_0001_2d_planes.png",
                     "vis/a_0000_view0_poses.jpg", "vis/a_0000_view1_poses.jpg",
                     "vis/a_0001_view0_poses.jpg", "vis/a_0001_view1_poses.jpg"]
