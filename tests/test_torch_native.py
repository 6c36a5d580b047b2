"""PyTorch port, the native host code on the CPU: `native/render.cpp`
and `native/warp.cpp`, built with g++ at first use, against the JAX
package's copies and against their plain versions.

- Host heatmap rendering, the 'gt' and 'pred' sources, augmentation off
  and on: the port's native renderer equals the JAX package's
  `render_heatmap` bit for bit (the same C++ arithmetic and the same
  draws); its plain version `_render_joints_numpy` is within 2e-6 (numpy
  takes its exp in float64 and its window in float32, the C++ in
  float32); the device renderer on `render_heatmap_params` of the same
  draws within 2e-5 (the JAX package's own tolerance,
  tests/test_heatmap_render.py).
- The warp: `warp_normalize_native` and `normalize_u8_native` equal the
  JAX package's bit for bit on warps that stay inside the image (the
  same arithmetic); the repaired copy against a float64 numpy bilinear
  sample on warps whose footprint crosses every border of the image
  (1e-4 in normalised units: the C++ takes its coordinates and weights in
  float32).  `load_view_images` and `preprocess_view_native` equal the
  JAX package's.
- A build that fails raises with the compiler's output.
"""

import os
import pathlib

import numpy as np
import pytest
import torch

from tests.test_datasets import make_people, small_cfg

cv2 = pytest.importorskip("cv2")
REPO = pathlib.Path(__file__).resolve().parent.parent


def _datasets(aug, seed=7, num_joints=15):
    """(JAX, port) PoseDatasetBase on the Panoptic geometry of
    tests/test_datasets.py, with the same seed and augmentation."""
    import dataclasses

    from faster_voxelpose_tpu.datasets.base import PoseDatasetBase as JaxBase
    from faster_voxelpose_tpu_torch.config import Config, _apply_overlay
    from faster_voxelpose_tpu_torch.datasets.base import PoseDatasetBase

    jcfg = small_cfg(num_joints=num_joints)
    jcfg.TRAIN.SEED = seed
    pcfg = Config()
    _apply_overlay(pcfg, dataclasses.asdict(jcfg))
    pcfg.DATASET.__post_init__()
    out = []
    for cls, cfg in ((JaxBase, jcfg), (PoseDatasetBase, pcfg)):
        ds = cls(cfg, is_train=True)
        ds.data_augmentation = aug
        out.append(ds)
    return out


def _joints_2d(rng, n, num_joints, W=960, H=512):
    """Direct 2D joints in the input-image frame, some near the edges."""
    joints, vis = [], []
    for i in range(n):
        c = rng.uniform([100, 100], [W - 100, H - 100])
        j = c[None, :] + rng.uniform(-120, 120, (num_joints, 2))
        if i == 0:
            j += np.array([W - 160.0, H - 140.0]) - c  # straddles the corner
        joints.append(j.astype(np.float64))
        vis.append(rng.rand(num_joints) > 0.1)
    return joints, vis


def _hold_renderers(jds, pds, views_args):
    """Render each view with every renderer on the same draws: the JAX
    package's render_heatmap, the port's native one, its plain version,
    and the device renderer on render_heatmap_params."""
    from faster_voxelpose_tpu_torch.datasets.base import _render_joints_numpy
    from faster_voxelpose_tpu_torch.ops.heatmap_render import render_heatmaps_device

    state = pds._rng.get_state()
    W, H = pds.heatmap_size
    peak = 0.0
    for args in views_args:
        pds._rng.set_state(state)
        native = pds.render_heatmap(*args)
        ref = jds.render_heatmap(*args)
        assert native.dtype == ref.dtype == np.float32 and native.shape == ref.shape
        np.testing.assert_array_equal(native, ref)
        pds._rng.set_state(state)
        plain = _render_joints_numpy(*pds.heatmap_instances(*args))
        np.testing.assert_allclose(plain, native, rtol=0, atol=2e-6)
        pds._rng.set_state(state)
        params = torch.as_tensor(pds.render_heatmap_params(*args))
        dev = render_heatmaps_device(params[None], int(H), int(W))[0].numpy()
        np.testing.assert_allclose(dev, native, rtol=0, atol=2e-5)
        state = pds._rng.get_state()
        peak = max(peak, float(native.max()))
    assert peak > 0.3


@pytest.mark.parametrize("aug", [False, True])
def test_gt_rendering_matches_jax(aug):
    """'gt' source: GT joints projected into each view of a rig, then
    rendered (`_heatmaps_from_gt` against the JAX package's)."""
    from faster_voxelpose_tpu.datasets.base import FrameRecord as JaxRecord
    from faster_voxelpose_tpu_torch.datasets.base import FrameRecord
    from tests.test_geometry import make_camera

    jds, pds = _datasets(aug)
    for ds in (jds, pds):
        ds.num_views = 3
        ds.cameras = {"s": [make_camera(v) for v in range(3)]}
    joints, vis = make_people(np.random.RandomState(5), 3, 15)
    vis[1][4:9] = 0
    recs = [cls(seq="s", joints_3d=np.asarray(joints), joints_3d_vis=np.stack(vis))
            for cls in (JaxRecord, FrameRecord)]
    ours, ref = pds._heatmaps_from_gt(recs[1]), jds._heatmaps_from_gt(recs[0])
    assert ours.shape == (3, 128, 240, 15)
    np.testing.assert_array_equal(ours, ref)
    assert jds._rng.randint(1 << 30) == pds._rng.randint(1 << 30)  # the same draws taken
    # and per view against the plain and device renderers
    _, pds = _datasets(aug)
    pds.num_views, pds.cameras = 3, {"s": [make_camera(v) for v in range(3)]}
    jds, _ = _datasets(aug)
    jds.num_views, jds.cameras = 3, {"s": [make_camera(v) for v in range(3)]}
    _hold_renderers(jds, pds, pds._gt_joints_2d(recs[1]))


@pytest.mark.parametrize("aug", [False, True])
def test_pred_rendering_matches_jax(aug):
    """'pred' source: precomputed 2D predictions (with a score column)
    mapped into the input frame and rendered, every person visible."""
    from faster_voxelpose_tpu.datasets.base import FrameRecord as JaxRecord
    from faster_voxelpose_tpu_torch.datasets.base import FrameRecord

    rng = np.random.RandomState(11)
    preds = []
    for _ in range(2):  # views
        joints, _ = _joints_2d(rng, 3, 17, 1920, 1080)
        preds.append([np.concatenate([j, rng.rand(17, 1)], 1) for j in joints])
    jds, pds = _datasets(aug, num_joints=17)
    ours = pds._heatmaps_from_preds(FrameRecord(seq="s", pred_pose2d=preds))
    ref = jds._heatmaps_from_preds(JaxRecord(seq="s", pred_pose2d=preds))
    assert ours.shape == (2, 128, 240, 17)
    np.testing.assert_array_equal(ours, ref)
    from faster_voxelpose_tpu_torch.geometry.transforms import affine_transform_points

    jds, pds = _datasets(aug, num_joints=17)
    mapped = [[np.concatenate([affine_transform_points(p[:, :2], pds.resize_transform),
                               p[:, 2:]], 1) for p in view] for view in preds]
    _hold_renderers(jds, pds, [(m,) for m in mapped])


@pytest.mark.parametrize("aug", [False, True])
def test_direct_joints_against_every_renderer(aug):
    """Joints given in the input frame, one person straddling a corner and
    some joints invisible: the four renderers on the same draws."""
    rng = np.random.RandomState(3)
    views = [_joints_2d(rng, 3, 15) for _ in range(3)]
    jds, pds = _datasets(aug)
    _hold_renderers(jds, pds, views)


def test_render_with_nobody_is_empty():
    jds, pds = _datasets(True)
    out = pds.render_heatmap([])
    assert out.shape == (128, 240, 15) and not out.any()
    np.testing.assert_array_equal(out, jds.render_heatmap([]))


def test_native_is_built_into_the_ignored_build_directory():
    from faster_voxelpose_tpu_torch.native import build

    for name in ("render", "warp"):
        path = build.library_path(name)
        assert path.parent == REPO / "build" / "native"
        build.load(name)
        assert path.exists()
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """No quiet fallback: a source the compiler refuses, or a compiler
    that is missing, raises NativeBuildError."""
    from faster_voxelpose_tpu_torch.native import build

    src = tmp_path / "src"
    src.mkdir()
    (src / "render.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(build, "SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    build.load.cache_clear()
    try:
        with pytest.raises(build.NativeBuildError, match="render.cpp failed to build") as e:
            build.load("render")
        assert "error" in str(e.value)
        monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-compiler"))
        (src / "warp.cpp").write_text("int x;\n")
        with pytest.raises(build.NativeBuildError, match="cannot build"):
            build.load("warp")
        assert not list((tmp_path / "out").glob("*.so"))
    finally:
        build.load.cache_clear()


# -- the warp -------------------------------------------------------------

def _warp_plain(img, out_size, inv, mean, std, swap_rb):
    """float64 numpy bilinear sample of `img` at the dst->src affine
    `inv`, zero outside, normalised: the plain version of warp_normalize."""
    W, H = out_size
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    inv32 = np.asarray(inv, np.float32).astype(np.float64).reshape(2, 3)
    sx = inv32[0, 0] * xs + inv32[0, 1] * ys + inv32[0, 2]
    sy = inv32[1, 0] * xs + inv32[1, 1] * ys + inv32[1, 2]
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    ax, ay = sx - x0, sy - y0
    h, w = img.shape[:2]
    out = np.zeros((H, W, 3))
    for dy, wy in ((0, 1 - ay), (1, ay)):
        for dx, wx in ((0, 1 - ax), (1, ax)):
            yy, xx = y0 + dy, x0 + dx
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            v = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(np.float64)
            out += (wy * wx * inside)[..., None] * v
    if swap_rb:
        out = out[..., ::-1]
    return (out / 255.0 - mean) / std


def _inv(t):
    return cv2.invertAffineTransform(np.asarray(t, np.float64))


def test_warp_matches_jax_inside_the_image():
    from faster_voxelpose_tpu.native.build import load_warp_lib
    from faster_voxelpose_tpu.native.build import normalize_u8_native as jax_normalize
    from faster_voxelpose_tpu.native.build import warp_normalize_native as jax_warp
    from faster_voxelpose_tpu_torch.datasets.images import IMAGENET_MEAN, IMAGENET_STD
    from faster_voxelpose_tpu_torch.geometry.transforms import get_resize_transform
    from faster_voxelpose_tpu_torch.native.build import normalize_u8_native, warp_normalize_native

    assert load_warp_lib() is not None  # the JAX package's native copy, the reference
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (288, 360, 3), np.uint8)
    m, s = IMAGENET_MEAN, IMAGENET_STD
    resize = get_resize_transform((360, 288), (160, 128))  # axis-aligned
    c, sn = np.cos(0.2), np.sin(0.2)
    rotate = np.array([[0.5 * c, -0.5 * sn, 120.0], [0.5 * sn, 0.5 * c, 40.0]])  # general
    for t, size in ((resize, (160, 128)), (rotate, (96, 64))):
        inv = _inv(t)
        for swap in (False, True):
            ours = warp_normalize_native(img, size, inv, m, s, swap)
            np.testing.assert_array_equal(ours, jax_warp(img, size, inv, m, s, swap))
            np.testing.assert_allclose(ours, _warp_plain(img, size, inv, m, s, swap), atol=1e-4)
    for swap in (False, True):
        np.testing.assert_array_equal(normalize_u8_native(img, m, s, swap),
                                      jax_normalize(img, m, s, swap))


@pytest.mark.parametrize("case", ["shift_out", "zoom_out", "rotate", "flip"])
def test_warp_across_every_border(case):
    """Warps whose footprint leaves the image on all four sides (and rows
    and columns entirely outside it): the repaired copy forms no pointer
    outside the image and samples as the float64 plain version does, zero
    outside, on the axis-aligned and the general paths."""
    from faster_voxelpose_tpu_torch.datasets.images import IMAGENET_MEAN, IMAGENET_STD
    from faster_voxelpose_tpu_torch.native.build import warp_normalize_native

    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (37, 53, 3), np.uint8)
    size = (80, 64)
    t = {
        "shift_out": [[1.0, 0.0, 13.5], [0.0, 1.0, 11.25]],   # src inside dst, margins all round
        "zoom_out": [[0.6, 0.0, 30.0], [0.0, 0.6, 25.0]],
        "rotate": [[0.779, -0.45, 27.68], [0.45, 0.779, 5.66]],  # 30 degrees, 0.9
        "flip": [[-1.2, 0.0, 75.0], [0.0, -1.1, 52.0]],
    }[case]
    inv = _inv(np.array(t))
    for swap in (False, True):
        ours = warp_normalize_native(img, size, inv, IMAGENET_MEAN, IMAGENET_STD, swap)
        ref = _warp_plain(img, size, inv, IMAGENET_MEAN, IMAGENET_STD, swap)
        np.testing.assert_allclose(ours, ref, atol=1e-4)
        zero = -IMAGENET_MEAN / IMAGENET_STD  # mean and std are per output channel
        for edge in (ours[0], ours[-1], ours[:, 0], ours[:, -1]):
            np.testing.assert_allclose(edge, np.broadcast_to(zero, edge.shape), atol=1e-5)


def test_load_view_images_matches_jax(tmp_path):
    """Files at the input size (no warp) and larger (cv2's warp), both
    channel orders: the frames equal the JAX package's."""
    from faster_voxelpose_tpu.datasets.images import load_view_images as jax_load
    from faster_voxelpose_tpu.datasets.images import preprocess_view_native as jax_pre
    from faster_voxelpose_tpu_torch.datasets.images import (load_view_images,
                                                             preprocess_view_native)
    from faster_voxelpose_tpu_torch.geometry.transforms import get_resize_transform

    rng = np.random.RandomState(7)
    paths = []
    for i, shape in enumerate([(64, 96, 3), (120, 180, 3)]):
        p = str(tmp_path / f"view{i}.png")
        assert cv2.imwrite(p, rng.randint(0, 256, shape, np.uint8))
        paths.append(p)
    t = get_resize_transform((180, 120), (96, 64))
    for rgb in (True, False):
        ours = load_view_images(paths, (96, 64), t, color_rgb=rgb)
        assert ours.shape == (2, 64, 96, 3) and ours.dtype == np.float32
        np.testing.assert_array_equal(ours, jax_load(paths, (96, 64), t, color_rgb=rgb))
    raw = rng.randint(0, 256, (120, 180, 3), np.uint8)
    np.testing.assert_array_equal(preprocess_view_native(raw, (96, 64), t, True),
                                  jax_pre(raw, (96, 64), t, True))
    with pytest.raises(ValueError, match="resize_transform"):
        load_view_images(paths, (96, 64), None)
    with pytest.raises(FileNotFoundError):
        load_view_images([str(tmp_path / "missing.png")], (96, 64), t)


def test_spawned_processes_share_one_build(tmp_path):
    """Two processes loading the renderer at once (as spawn workers do)
    both get a working library."""
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, sys.argv[1]); import numpy as np; "
            "from faster_voxelpose_tpu_torch.native.build import render_joints_native as r; "
            "print(r(8, 8, 1, np.array([[3, 3]]), np.array([0]), np.array([1.0]), "
            "np.array([3.0]), np.array([1.0]), np.zeros((1, 4))).max())")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(REPO)], stdout=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs) and outs == ["1.0", "1.0"]
