"""PyTorch port, sampling and decoding ops: the plain versions of the
sampling kernels, in every crop route, against the JAX package's quad
path and its Pallas kernel run in interpret mode, the crop-route table
against the JAX package's kernel selection, plus NMS/top-K with ties,
soft-argmax and the heatmap renderer.  All on the CPU in float32.

Tolerances: samples of values in [0, 1] agree to 1e-5 (coordinates
computed by the same op sequence differ by float32 rounding only);
soft-argmax poses to 1e-3 mm.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_geometry import REPO, tiny_configs, tiny_rig


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
    from faster_voxelpose_tpu_torch.models import projection as pj
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    sk.reset_launch_counts()
    hm = torch.rand(2, 8, 10, 3)
    pix = torch.rand(2, 50, 2) * 10
    torch.testing.assert_close(sk.sample_whole(hm, pix), sk.sample_whole_plain(hm, pix))
    jcfg, _, geom = _jax_geom_and_port()
    axes = tuple(torch.as_tensor(a) for a in pj.whole_axes(geom))
    W, H = geom.heatmap_size
    hm = torch.rand(1, 3, H, W, 15)
    cams = torch.as_tensor(tiny_rig(3))[None]
    proj = pj.whole_projection(geom)
    torch.testing.assert_close(sk.sample_whole_projected(hm, cams, axes, proj),
                               sk.sample_whole_projected_plain(hm, cams, axes, proj))
    assert sk.launch_counts() == {
        "sample_whole": 0, "sample_whole_projected": 0,
        "sample_crop_planes": 0, "sample_crop_planes_coords": 0, "sample_crop_cube": 0,
        "window_sample": 0, "mma_window": 0, "weightnet_front": 0, "front3d": 0,
        "front_res3d": 0,
        "projattn": 0,
    }


def test_wrappers_refuse_inputs_that_require_grad():
    """The kernels are forward only: a wrapper raises rather than detach."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    hm = torch.rand(2, 8, 10, 3, requires_grad=True)
    with pytest.raises(ValueError, match="forward only"):
        sk.sample_whole(hm, torch.rand(2, 50, 2) * 10)
    axes = tuple(torch.arange(n, dtype=torch.float32) for n in (2, 3, 4))
    with pytest.raises(ValueError, match="forward only"):
        sk.sample_whole_projected(hm[None], torch.rand(1, 2, 21), axes, None)
    masks = [torch.ones(1, 4, dtype=torch.uint8)] * 3
    with pytest.raises(ValueError, match="forward only"):
        sk.sample_crop_planes_coords(hm, torch.rand(1, 2, 64, 2), *masks,
                                     torch.ones(1, dtype=torch.uint8))


def _pallas_crop(jgeom, hm, cams, tl, bbox, valid, spec):
    from faster_voxelpose_tpu.models.projection import project_individual_planes_pallas
    from faster_voxelpose_tpu.ops.pallas_sampling import pack_heatmaps

    return project_individual_planes_pallas(
        jgeom, pack_heatmaps(jnp.asarray(hm), spec), jnp.asarray(cams),
        jnp.asarray(tl), jnp.asarray(bbox), jnp.asarray(valid), spec,
    )


def test_crop_planes_coords_route_matches_pallas_kernel():
    """Kernel row 3: the coords route (pixels from PyTorch, planes from the
    sampler) against the Pallas kernel on precomputed coords
    (fused_coords=False, interpret mode, exact)."""
    from faster_voxelpose_tpu_torch.models.projection import project_individual_planes

    jcfg, jgeom, pgeom = _jax_geom_and_port()
    hm, cams, tl, bbox, valid = _crop_case(jcfg, jgeom, 6, True)
    spec = _spec(jcfg, tile=(8, 8, 8), window_x=24, window_y=32, fused_coords=False)
    ref = _pallas_crop(jgeom, hm, cams, tl, bbox, valid, spec)
    ours = project_individual_planes(
        pgeom, torch.as_tensor(hm), torch.as_tensor(cams), torch.as_tensor(tl),
        torch.as_tensor(bbox), torch.as_tensor(valid), ("coords", "planes"),
    )
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert float(ours[0][2].abs().max()) == 0.0  # the invalid slot


@pytest.mark.parametrize("fused_coords", [True, False])
def test_crop_cube_route_matches_pallas_kernel(fused_coords):
    """Kernel row 4: the masked cube, from in-kernel projection or from
    coords, then planes by max-reduction, against the Pallas kernel's cube
    mode with 4x4x4 tiles (64 voxels, not a multiple of 128)."""
    from faster_voxelpose_tpu_torch.models.projection import project_individual_planes

    jcfg, jgeom, pgeom = _jax_geom_and_port()
    hm, cams, tl, bbox, valid = _crop_case(jcfg, jgeom, 7, False)
    spec = _spec(jcfg, tile=(4, 4, 4), window_x=24, window_y=32, fused_coords=fused_coords)
    assert spec.samples % 128 != 0
    ref = _pallas_crop(jgeom, hm, cams, tl, bbox, valid, spec)
    route = ("project" if fused_coords else "coords", "cube")
    ours = project_individual_planes(
        pgeom, torch.as_tensor(hm), torch.as_tensor(cams), torch.as_tensor(tl),
        torch.as_tensor(bbox), torch.as_tensor(valid), route,
    )
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_crop_cube_plain_is_the_masked_cube():
    """The cube mode's plain version: zeros outside the bbox mask and in
    dead slots, and its max planes are the planes mode's."""
    from faster_voxelpose_tpu_torch.models import projection as pj
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    jcfg, jgeom, pgeom = _jax_geom_and_port()
    hm, cams, tl, bbox, valid = _crop_case(jcfg, jgeom, 8, False)
    tl_t = torch.as_tensor(tl).to(torch.int32)
    mx, my, mz = (m.to(torch.uint8) for m in pj.crop_axis_masks(pgeom, tl_t, torch.as_tensor(bbox)))
    v = torch.as_tensor(valid).to(torch.uint8)
    crop = pj.crop_projection(pgeom)
    cams_t = torch.as_tensor(cams)
    cube = sk.sample_crop_cube(torch.as_tensor(hm), mx, my, mz, v, cams=cams_t,
                               centers_tl=tl_t, crop=crop)
    pix = sk.crop_pixels(crop, cams_t, tl_t, pgeom.ind_voxels_per_axis)
    cube_c = sk.sample_crop_cube(torch.as_tensor(hm), mx, my, mz, v, pix=pix)
    torch.testing.assert_close(cube_c, cube, atol=1e-6, rtol=0)
    keep = (mx[:, :, None, None].bool() & my[:, None, :, None].bool()
            & mz[:, None, None, :].bool() & v[:, None, None, None].bool())
    assert float(cube[~keep].abs().max()) == 0.0 and float(cube[keep].max()) > 0.0
    planes = sk.sample_crop_planes(torch.as_tensor(hm), cams_t, tl_t, mx, my, mz, v, crop)
    for a, b in zip((cube.amax(3), cube.amax(2), cube.amax(1)), planes):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def _factored_crop_pixels(crop, cams, tl, voxels):
    """crop_pixels with the camera-frame coordinates summed from per-axis
    products, as the crop kernel sums them: xc_r = (p_r0[x] + p_r1[y]) +
    p_r2[z], p_ra[i] = (origin_a + (tl_a + i) * step_a - cam_t_a) * R[r][a];
    then the rest of project_points, project_to_norm_coords and
    norm_to_pixel, op for op.  (K, V, vx*vy*vz, 2)."""
    world = []  # per axis a: (K, v_a) world coordinates
    for a in range(3):
        idx = tl[:, a, None] + torch.arange(voxels[a], dtype=tl.dtype)
        world.append(crop.origin[a] + idx.float() * crop.step[a])
    return _factored_pixels(world, cams, crop)


def _factored_pixels(world, cams, proj):
    """Pixels (K, V, n_x*n_y*n_z, 2) of the separable grids whose axis a
    holds world[a] (K, n_a) mm: per-axis products p_ra[i] = (world_a[i] -
    cam_t_a) * R[r][a] summed as (p_r0[x] + p_r1[y]) + p_r2[z], then the
    rest of project_points, project_to_norm_coords and norm_to_pixel, op
    for op, as the projecting kernels compute them."""
    from faster_voxelpose_tpu_torch.geometry.grids import reciprocal_f32

    K, V = world[0].shape[0], cams.shape[0]
    prods = []  # per axis a: (K, V, 3 rows, n_a)
    for a in range(3):
        xt = world[a][:, None, :] - cams[None, :, 9 + a, None]
        prods.append(xt[:, :, None, :] * cams[None, :, a:9:3, None])
    xc = (prods[0][..., :, None, None] + prods[1][..., None, :, None]) + prods[2][..., None, None, :]
    x0, x1, x2 = (xc[:, :, r].reshape(K, V, -1) for r in range(3))
    c = [cams[None, :, i, None] for i in range(21)]
    y0 = x0 / (x2 + 1e-5)
    y1 = x1 / (x2 + 1e-5)
    r2 = y0 * y0 + y1 * y1
    d = 1 + c[16] * r2 + c[17] * r2 * r2 + c[18] * r2 * r2 * r2
    u = y0 * d + 2 * c[19] * y0 * y1 + c[20] * (r2 + 2 * y0 * y0)
    v = y1 * d + 2 * c[20] * y0 * y1 + c[19] * (r2 + 2 * y1 * y1)
    ox = (u * c[12] + c[14]).clamp(-1.0, float(max(proj.ori_image_size)))
    oy = (v * c[13] + c[15]).clamp(-1.0, float(max(proj.ori_image_size)))
    t = proj.resize_transform
    x = ox * t[0] + oy * t[1] + t[2]
    y = ox * t[3] + oy * t[4] + t[5]
    (w, h), (iw, ih) = proj.heatmap_size, proj.image_size
    x = x * float(w) * reciprocal_f32(iw)
    y = y * float(h) * reciprocal_f32(ih)
    x = (x * reciprocal_f32(w - 1) * 2.0 - 1.0).clamp(-1.1, 1.1)
    y = (y * reciprocal_f32(h - 1) * 2.0 - 1.0).clamp(-1.1, 1.1)
    return torch.stack([(x + 1.0) * 0.5 * float(w - 1), (y + 1.0) * 0.5 * float(h - 1)], dim=-1)


@pytest.mark.parametrize("profile", ["tiny", "panoptic"])
def test_factored_crop_projection_is_bit_exact(profile):
    """The premise of the crop kernel's projection: hoisting the nine
    per-axis products of each view and adding them in project_points'
    order gives crop_pixels' pixels bit for bit, on crops inside the
    space, clipped by its edges and right next to a camera."""
    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.geometry import dome_rig
    from faster_voxelpose_tpu_torch.models import projection as pj
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    if profile == "tiny":
        jcfg, _, geom = _jax_geom_and_port()
        cams = _near_camera_rig(jcfg)
        center = np.asarray(jcfg.CAPTURE_SPEC.SPACE_CENTER, np.float32)
        half = np.asarray(jcfg.CAPTURE_SPEC.SPACE_SIZE, np.float32) / 2
    else:
        cfg = panoptic_synthetic_profile()
        geom = pj.make_projection_geometry(cfg)
        center = np.asarray(cfg.CAPTURE_SPEC.SPACE_CENTER, np.float32)
        half = np.asarray(cfg.CAPTURE_SPEC.SPACE_SIZE, np.float32) / 2
        cams = dome_rig(1, cfg.DATASET.CAMERA_NUM, space_center=tuple(center))[0]
        cams[0, 9:12] = center + np.array([0.0, -700.0, 0.0], np.float32)
    rng = np.random.RandomState(11)
    centers = center + rng.uniform(-0.5, 0.5, (4, 3)).astype(np.float32) * half
    centers[1] = center + half * np.array([0.98, -0.97, -0.9], np.float32)  # the space's corner
    centers[2] = cams[0, 9:12] + np.array([120.0, 80.0, -250.0], np.float32)  # at a camera
    centers[3] = cams[1, 9:12] + np.array([-60.0, 40.0, 90.0], np.float32)
    tl, _ = pj.compute_crop_origin(geom, torch.as_tensor(centers))
    crop, cams_t = pj.crop_projection(geom), torch.as_tensor(cams)
    want = sk.crop_pixels(crop, cams_t, tl, geom.ind_voxels_per_axis)
    got = _factored_crop_pixels(crop, cams_t, tl, geom.ind_voxels_per_axis)
    assert got.shape == want.shape
    assert torch.equal(got, want)


_DEMO_CONFIGS = sorted(p.name for p in (REPO / "configs/demo").glob("*.yaml"))


@pytest.mark.parametrize("name", _DEMO_CONFIGS)
def test_whole_axes_rebuild_the_grid(name):
    """The premise of the whole-space kernel's projection: the three axis
    vectors read from whole_grid rebuild it bit for bit (the grid is a
    meshgrid of three linspaces, cast to float32 once)."""
    from faster_voxelpose_tpu_torch.config import load_config
    from faster_voxelpose_tpu_torch.models import projection as pj
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    geom = pj.make_projection_geometry(load_config(REPO / "configs/demo" / name))
    axes = pj.whole_axes(geom)
    assert [a.dtype for a in axes] == [np.float32] * 3
    assert tuple(len(a) for a in axes) == tuple(geom.voxels_per_axis)
    grid = sk.axes_grid(tuple(torch.as_tensor(a) for a in axes))
    assert torch.equal(grid, torch.as_tensor(geom.whole_grid))


def _whole_profile(profile):
    """(geometry, cams (V, 21)) of a profile with a camera inside the
    volume: the tiny rig with camera 0 800 mm from the centre, or the
    profile's dome rig with camera 0 moved 700 mm from the centre."""
    from faster_voxelpose_tpu_torch.config import load_config
    from faster_voxelpose_tpu_torch.geometry import dome_rig
    from faster_voxelpose_tpu_torch.models import projection as pj

    if profile == "tiny":
        jcfg, _, geom = _jax_geom_and_port()
        return geom, _near_camera_rig(jcfg)
    cfg = load_config(REPO / f"configs/demo/{profile}_synthetic.yaml")
    center = np.asarray(cfg.CAPTURE_SPEC.SPACE_CENTER, np.float32)
    cams = dome_rig(1, cfg.DATASET.CAMERA_NUM, space_center=tuple(center),
                    ori_image_size=cfg.DATASET.ORI_IMAGE_SIZE)[0]
    cams[0, 9:12] = center + np.array([0.0, -700.0, 0.0], np.float32)
    return pj.make_projection_geometry(cfg), cams


@pytest.mark.parametrize("profile", ["tiny", "panoptic", "shelf", "campus"])
def test_factored_whole_projection_is_bit_exact(profile):
    """The whole-space kernel projects the grid from its axes: per-axis
    products summed in project_points' order give whole_pixels' pixels bit
    for bit, with a camera inside the volume."""
    from faster_voxelpose_tpu_torch.models import projection as pj

    geom, cams = _whole_profile(profile)
    cams_t = torch.as_tensor(cams)
    want = pj.whole_pixels(geom, torch.as_tensor(geom.whole_grid), cams_t)
    world = [torch.as_tensor(a)[None] for a in pj.whole_axes(geom)]
    got = _factored_pixels(world, cams_t, pj.whole_projection(geom))[0]
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("J", [15, 17])
def test_project_whole_batch_matches_jax(J):
    """project_whole_batch at B = 2 (a tiny rig and one with a camera inside
    the volume), V = 3, against the JAX package's project_whole_batch_pallas
    in interpret mode and its quad project_whole per sample."""
    from faster_voxelpose_tpu.models.projection import project_whole as jw
    from faster_voxelpose_tpu.models.projection import project_whole_batch_pallas
    from faster_voxelpose_tpu.ops.pallas_sampling import pack_heatmaps
    from faster_voxelpose_tpu.ops.sampling import build_quad_table
    from faster_voxelpose_tpu_torch.models import projection as pj

    jcfg, jgeom, pgeom = _jax_geom_and_port(DATASET__NUM_JOINTS=J)
    V = jcfg.DATASET.CAMERA_NUM
    W, H = jcfg.DATASET.HEATMAP_SIZE
    assert V == 3
    hm = np.random.RandomState(J).rand(2, V, H, W, J).astype(np.float32)
    cams = np.stack([tiny_rig(V), _near_camera_rig(jcfg)])

    spec = _spec(jcfg, tile=(4, 4, 8), window_x=16, window_y=16)
    packed = jnp.stack([pack_heatmaps(jnp.asarray(h), spec) for h in hm])
    pallas = np.asarray(project_whole_batch_pallas(jgeom, packed, jnp.asarray(cams), spec))
    quad = np.stack([np.asarray(jw(jgeom, jax.vmap(build_quad_table)(jnp.asarray(h)), jnp.asarray(c)))
                     for h, c in zip(hm, cams)])
    axes = tuple(torch.as_tensor(a) for a in pj.whole_axes(pgeom))
    ours = pj.project_whole_batch(pgeom, torch.as_tensor(hm), torch.as_tensor(cams), axes).numpy()
    assert ours.shape == quad.shape == pallas.shape == (2, 16, 16, 8, J)
    np.testing.assert_allclose(ours, quad, atol=1e-5)
    np.testing.assert_allclose(ours, pallas, atol=1e-5)


_ROUTE_CASES = [
    {},
    {"PALLAS_FUSED_COORDS": False},
    {"PALLAS_TILE": (4, 4, 4)},
    {"PALLAS_TILE": (4, 4, 4), "PALLAS_FUSED_COORDS": False},
    {"PALLAS_TILE": (8, 8, 8)},
    {"PALLAS_TILE": (16, 8, 4)},
    {"PALLAS_TILE": (2, 2, 4)},
    {"PALLAS_TILE": (8, 8, 6)},  # does not divide 64: quad path in JAX
    {"PALLAS_TILE": (16, 16, 32), "PALLAS_WINDOW": (240, 128)},  # one window
    {"PALLAS_WINDOW": (40, 120), "PALLAS_EXACT": True},
    {"PALLAS_WINDOW": (256, 120), "PALLAS_EXACT": True},  # one window (exact rows)
    {"PALLAS_WINDOW": (256, 120)},  # rows round up to 128: one window
    {"SAMPLING_BACKEND": "quad", "PALLAS_FUSED_COORDS": False},
    {"SAMPLING_BACKEND": "pallas", "PALLAS_TILE": (4, 4, 4)},
]


def test_crop_route_table_matches_jax_kernel_selection():
    """resolve_crop_route against the JAX package's resolve_sampling_spec
    plus the planes test of project_individual_planes_pallas (:518-519),
    on the Panoptic profile under a table of sampling keys.  The JAX
    resolver is asked as on a TPU (PALLAS_INTERPRET)."""
    from faster_voxelpose_tpu.config import load_config as jax_load
    from faster_voxelpose_tpu.models.faster_voxelpose import resolve_sampling_spec
    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.models.projection import resolve_crop_route

    seen = set()
    for case in _ROUTE_CASES:
        jcfg = jax_load(REPO / "configs/demo/panoptic_synthetic.yaml")
        pcfg = panoptic_synthetic_profile()
        for key, value in case.items():
            setattr(jcfg.NETWORK, key, value)
            setattr(pcfg.NETWORK, key, value)
        jcfg.NETWORK.PALLAS_INTERPRET = True
        spec = resolve_sampling_spec(jcfg)
        if spec is None:
            want = ("project", "planes")
        else:
            pow2 = not any(d & (d - 1) for d in spec.tile)
            want = ("project" if spec.fused_coords else "coords",
                    "planes" if pow2 and spec.samples == spec.padded_samples else "cube")
        assert resolve_crop_route(pcfg) == want, case
        seen.add(want)
    assert len(seen) == 4  # every route is reached by some config


def test_model_takes_the_configured_crop_route():
    from faster_voxelpose_tpu_torch.models import build_model

    _, pcfg = tiny_configs(NETWORK__PALLAS_FUSED_COORDS=False, NETWORK__PALLAS_TILE=(8, 8, 8))
    assert build_model(pcfg).jln.crop_route == ("coords", "planes")
    _, pcfg = tiny_configs(NETWORK__PALLAS_TILE=(4, 4, 4), NETWORK__PALLAS_WINDOW=(8, 16))
    assert build_model(pcfg).jln.crop_route == ("project", "cube")


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

