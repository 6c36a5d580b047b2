"""PyTorch port, sampling and decoding ops: the plain versions of the two
sampling kernels against the JAX package's quad path and its Pallas
kernel run in interpret mode, plus NMS/top-K with ties, soft-argmax and
the heatmap renderer.  All on the CPU in float32.

Tolerances: samples of values in [0, 1] agree to 1e-5 (coordinates
computed by the same op sequence differ by float32 rounding only);
soft-argmax poses to 1e-3 mm.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_geometry import tiny_configs, tiny_rig


def _jax_geom_and_port(**kw):
    from faster_voxelpose_tpu.models.projection import make_projection_geometry as jg
    from faster_voxelpose_tpu_torch.models.projection import make_projection_geometry as pg

    jcfg, pcfg = tiny_configs(**kw)
    return jcfg, jg(jcfg), pg(pcfg)


def _spec(jcfg, **kw):
    from faster_voxelpose_tpu.ops.pallas_sampling import SampleKernelSpec

    W, H = jcfg.DATASET.HEATMAP_SIZE
    base = dict(
        n_views=jcfg.DATASET.CAMERA_NUM, height=H, width=W,
        num_joints=jcfg.DATASET.NUM_JOINTS, exact=True, interpret=True,
    )
    base.update(kw)
    return SampleKernelSpec(**base)


def _near_camera_rig(jcfg):
    """Tiny rig with camera 0 moved 800 mm from the space centre, looking
    through the volume: many bins lie behind or right at its image plane."""
    from faster_voxelpose_tpu_torch.geometry import pack_rig

    V = jcfg.DATASET.CAMERA_NUM
    W, H = jcfg.DATASET.HEATMAP_SIZE
    cams = np.asarray(tiny_rig(V)).copy()
    center = np.asarray(jcfg.CAPTURE_SPEC.SPACE_CENTER)
    cams[0] = pack_rig([{
        "R": np.eye(3), "T": (center + np.array([0.0, -800.0, 0.0]))[:, None],
        "fx": 260.0, "fy": 260.0, "cx": W / 2.0, "cy": H / 2.0,
        "k": np.zeros((3, 1)), "p": np.zeros((2, 1)),
    }])[0]
    return cams.astype(np.float32)


def test_sample_whole_plain_matches_pallas_kernel():
    """Random and full-image-spread (wild) pixel coords, in and out of the
    image: the plain twin equals the Pallas kernel (interpret mode)."""
    from faster_voxelpose_tpu.ops.pallas_sampling import SampleKernelSpec, pack_heatmaps, sample_tiles
    from faster_voxelpose_tpu_torch.ops.sampling_kernels import sample_whole

    spec = SampleKernelSpec(
        n_views=3, height=32, width=40, num_joints=15, tile=(4, 4, 8),
        window_x=16, window_y=16, exact=True, interpret=True,
    )
    rng = np.random.RandomState(0)
    nb, s, V = 6, spec.samples, spec.n_views
    hm = rng.rand(V, 32, 40, 15).astype(np.float32)
    centers = np.stack([rng.uniform(-6, 46, (nb, V, 1)), rng.uniform(-6, 38, (nb, V, 1))], 2)
    coords = centers + rng.uniform(-4, 4, (nb, V, 2, s))
    coords[::2, :, 0] = rng.uniform(-8, 48, (3, V, s))  # wild tiles
    coords[::2, :, 1] = rng.uniform(-8, 40, (3, V, s))
    coords = coords.astype(np.float32)

    ref = np.asarray(sample_tiles(pack_heatmaps(jnp.asarray(hm), spec), jnp.asarray(coords), spec))
    pix = torch.as_tensor(coords.transpose(1, 0, 3, 2).reshape(V, nb * s, 2).copy())
    ours = sample_whole(torch.as_tensor(hm), pix).numpy()
    ours = ours.reshape(nb, s, 15).transpose(0, 2, 1)
    np.testing.assert_allclose(ours, ref[:, :15], atol=1e-5)


@pytest.mark.parametrize("near_camera", [False, True])
def test_project_whole_matches_jax(near_camera):
    """Whole-space cube against project_whole (quad) and
    project_whole_pallas (interpret), with a camera inside the volume."""
    from faster_voxelpose_tpu.models.projection import project_whole as jw, project_whole_pallas
    from faster_voxelpose_tpu.ops.pallas_sampling import pack_heatmaps
    from faster_voxelpose_tpu.ops.sampling import build_quad_table
    from faster_voxelpose_tpu_torch.models.projection import project_whole

    jcfg, jgeom, pgeom = _jax_geom_and_port()
    V, J = jcfg.DATASET.CAMERA_NUM, jcfg.DATASET.NUM_JOINTS
    W, H = jcfg.DATASET.HEATMAP_SIZE
    rng = np.random.RandomState(3)
    hm = rng.rand(V, H, W, J).astype(np.float32)
    cams = _near_camera_rig(jcfg) if near_camera else tiny_rig(V)

    quad = np.asarray(jw(jgeom, jax.vmap(build_quad_table)(jnp.asarray(hm)), jnp.asarray(cams)))
    spec = _spec(jcfg, tile=(4, 4, 8), window_x=16, window_y=16)
    pallas = np.asarray(project_whole_pallas(
        jgeom, pack_heatmaps(jnp.asarray(hm), spec), jnp.asarray(cams), spec
    ))
    ours = project_whole(
        pgeom, torch.as_tensor(hm), torch.as_tensor(cams), torch.as_tensor(pgeom.whole_grid)
    ).numpy()
    assert ours.shape == quad.shape == (16, 16, 8, J)
    np.testing.assert_allclose(ours, quad, atol=1e-5)
    np.testing.assert_allclose(ours, pallas, atol=1e-5)


def _crop_case(jcfg, jgeom, seed, near_camera):
    from faster_voxelpose_tpu.models.projection import compute_crop_origin

    V, J = jcfg.DATASET.CAMERA_NUM, jcfg.DATASET.NUM_JOINTS
    W, H = jcfg.DATASET.HEATMAP_SIZE
    rng = np.random.RandomState(seed)
    hm = rng.rand(V, H, W, J).astype(np.float32)
    cams = tiny_rig(V)
    K = 5
    centers = rng.uniform(-1000, 1000, (K, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(600, 1000, K)
    centers[1] = [1950.0, -1900.0, 100.0]  # crop clipped by the space edges
    if near_camera:
        centers[K - 1] = cams[0, 9:12] + np.array([120.0, 80.0, -250.0], np.float32)
    tl, _ = compute_crop_origin(jgeom, jnp.asarray(centers))
    bbox = rng.uniform(0.3, 0.9, (K, 2)).astype(np.float32)
    bbox[3] = [1.1, -0.1]  # wider than the crop on x, empty-margin on y
    valid = np.array([True, True, False, True, True])
    return hm, cams, np.array(tl), bbox, valid


@pytest.mark.parametrize("near_camera", [False, True])
def test_crop_planes_match_jax_quad(near_camera):
    """Crop planes against project_individual_planes (quad path), with an
    invalid slot, crops clipped at the space edge, odd bboxes and a
    person right next to a camera."""
    from faster_voxelpose_tpu.models.projection import project_individual_planes as jplanes
    from faster_voxelpose_tpu.ops.sampling import build_quad_table
    from faster_voxelpose_tpu_torch.models.projection import project_individual_planes

    jcfg, jgeom, pgeom = _jax_geom_and_port()
    hm, cams, tl, bbox, valid = _crop_case(jcfg, jgeom, 4, near_camera)
    ref = jplanes(jgeom, jax.vmap(build_quad_table)(jnp.asarray(hm)), jnp.asarray(cams),
                  jnp.asarray(tl), jnp.asarray(bbox), jnp.asarray(valid))
    ours = project_individual_planes(
        pgeom, torch.as_tensor(hm), torch.as_tensor(cams), torch.as_tensor(tl),
        torch.as_tensor(bbox), torch.as_tensor(valid),
    )
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert float(ours[0][2].abs().max()) == 0.0  # the invalid slot


def test_crop_planes_match_fused_pallas_kernel():
    """Crop planes against the fused crop-to-planes Pallas kernel
    (interpret mode, multi-window fused-coords spec)."""
    from faster_voxelpose_tpu.models.projection import project_individual_planes_pallas
    from faster_voxelpose_tpu.ops.pallas_sampling import pack_heatmaps
    from faster_voxelpose_tpu_torch.models.projection import project_individual_planes

    jcfg, jgeom, pgeom = _jax_geom_and_port()
    hm, cams, tl, bbox, valid = _crop_case(jcfg, jgeom, 5, False)
    spec = _spec(jcfg, tile=(8, 8, 8), window_x=24, window_y=32, fused_coords=True)
    assert spec.nx * spec.ny > 1
    ref = project_individual_planes_pallas(
        jgeom, pack_heatmaps(jnp.asarray(hm), spec), jnp.asarray(cams),
        jnp.asarray(tl), jnp.asarray(bbox), jnp.asarray(valid), spec,
    )
    ours = project_individual_planes(
        pgeom, torch.as_tensor(hm), torch.as_tensor(cams), torch.as_tensor(tl),
        torch.as_tensor(bbox), torch.as_tensor(valid),
    )
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_wrappers_take_plain_version_on_cpu():
    """CPU tensors go to the plain version and count no kernel launch."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    sk.reset_launch_counts()
    hm = torch.rand(2, 8, 10, 3)
    pix = torch.rand(2, 50, 2) * 10
    torch.testing.assert_close(sk.sample_whole(hm, pix), sk.sample_whole_plain(hm, pix))
    assert sk.launch_counts() == {"sample_whole": 0, "sample_crop_planes": 0}


def test_nms_topk_ties_match_jax():
    """Plateaus, repeated peaks and all-zero rows: the same K indices in
    the same order as lax.top_k (ties to the lower flat index)."""
    from faster_voxelpose_tpu.ops.nms import nms2d_topk as jax_nms
    from faster_voxelpose_tpu_torch.ops.nms import nms2d_topk

    rng = np.random.RandomState(6)
    maps = np.round(rng.rand(4, 16, 16) * 4) / 4  # many exact ties
    maps[1] = 0.0
    maps[2, ::3, ::3] = 0.75  # a lattice of equal isolated peaks
    maps[3] = -rng.rand(16, 16)
    maps = maps.astype(np.float32)
    for K in (4, 10, 30):
        jv, ji, jf = (np.asarray(a) for a in jax_nms(jnp.asarray(maps), K))
        pv, pi, pf = (a.numpy() for a in nms2d_topk(torch.as_tensor(maps), K))
        np.testing.assert_array_equal(pf, jf)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pv, jv)


def test_soft_argmax_matches_jax():
    from faster_voxelpose_tpu.ops.soft_argmax import soft_argmax as jax_sa
    from faster_voxelpose_tpu_torch.geometry import compute_center_grids_np
    from faster_voxelpose_tpu_torch.ops.soft_argmax import soft_argmax

    rng = np.random.RandomState(7)
    grids = compute_center_grids_np((2000.0,) * 3, (0.0, -500.0, 800.0), (16, 16, 16))
    grids = grids.astype(np.float32)
    feats = (rng.randn(3, 4, 15, 256) * 0.05).astype(np.float32)
    feats[:, :, :, 37] += 0.2  # a sharp peak under beta = 100
    jp, jc = jax_sa(jnp.asarray(feats), jnp.asarray(grids), 100.0)
    pp, pc = soft_argmax(torch.as_tensor(feats), torch.as_tensor(grids), 100.0)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-3)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-6)


def test_heatmap_render_matches_jax():
    from faster_voxelpose_tpu.ops.heatmap_render import render_heatmaps_device as jax_render
    from faster_voxelpose_tpu_torch.ops.heatmap_render import render_heatmaps_device

    rng = np.random.RandomState(8)
    p = np.zeros((2, 3, 4, 12), np.float32)
    p[..., 0:2] = rng.uniform(0, 30, (2, 3, 4, 2))
    p[..., 2] = 1 / (2 * rng.uniform(1, 3, (2, 3, 4)) ** 2)
    p[..., 3] = rng.uniform(0.5, 1, (2, 3, 4))
    p[..., 4], p[..., 5] = p[..., 0] - 6, p[..., 0] + 6
    p[..., 6], p[..., 7] = p[..., 1] - 6, p[..., 1] + 6
    p[0, 0, :, 8:12] = [5, 15, 5, 15]  # occlusion rect
    p[1, 2] = 0  # absent instance
    ref = np.asarray(jax_render(jnp.asarray(p), 32, 40))
    ours = render_heatmaps_device(torch.as_tensor(p), 32, 40).numpy()
    assert ours.shape == (2, 32, 40, 4)
    np.testing.assert_allclose(ours, ref, atol=1e-6)

