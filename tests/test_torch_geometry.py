"""PyTorch port, geometry and configuration: the port's functions against
the JAX package's on the same inputs (CPU, float32).

Also home of the tiny-geometry helpers the other `test_torch_*` files
import: the geometry of `__graft_entry__._tiny_config` with
COMPUTE_DTYPE float32 on both sides.
"""

import dataclasses
import pathlib

import numpy as np
import torch

import jax
import jax.numpy as jnp

REPO = pathlib.Path(__file__).resolve().parent.parent


def jax_schema(cfg) -> dict:
    """The port's config as a dict, without the VIT and MVP sections, which
    the JAX package (it has no ViTPose backbone and no MvP) lacks."""
    d = dataclasses.asdict(cfg)
    del d["VIT"], d["MVP"]
    return d


def tiny_configs(**overrides):
    """(jax_cfg, port_cfg) with the tiny geometry of __graft_entry__ and
    float32 conv stacks; `overrides` sets CAPTURE_SPEC.MIN_SCORE etc. as
    'SECTION__KEY=value'.  The port's is its own `tiny_config()`, held
    equal to the JAX one."""
    from __graft_entry__ import _tiny_config
    from faster_voxelpose_tpu_torch.tools.dryrun_multichip import tiny_config

    jcfg, pcfg = _tiny_config(), tiny_config()
    for cfg in (jcfg, pcfg):
        cfg.NETWORK.COMPUTE_DTYPE = "float32"
        for key, value in overrides.items():
            section, name = key.split("__")
            setattr(getattr(cfg, section), name, value)
    for section in (pcfg.DATASET, pcfg.CAPTURE_SPEC, pcfg.INDIVIDUAL_SPEC, pcfg.RESNET):
        section.__post_init__()
    assert jax_schema(pcfg) == dataclasses.asdict(jcfg)
    return jcfg, pcfg


def tiny_rig(V):
    """The (V, 21) float32 rig __graft_entry__ uses for the tiny profile
    (the port's `ring_rig`, bit for bit `_example_cameras`)."""
    from faster_voxelpose_tpu_torch.geometry import ring_rig

    return ring_rig(1, V)[0]


def test_panoptic_profile_equals_yaml():
    from faster_voxelpose_tpu_torch.config import load_config, panoptic_synthetic_profile

    built = dataclasses.asdict(panoptic_synthetic_profile())
    loaded = dataclasses.asdict(load_config(REPO / "configs/demo/panoptic_synthetic.yaml"))
    assert built == loaded


def test_port_config_matches_jax_schema():
    """Both packages load every experiment file of the repo to the same
    values (the port's VIT section aside)."""
    from faster_voxelpose_tpu.config import load_config as jax_load
    from faster_voxelpose_tpu_torch.config import load_config as port_load

    for path in sorted((REPO / "configs").rglob("*.yaml")):
        assert jax_schema(port_load(path)) == dataclasses.asdict(jax_load(path)), path


def _dome(V=5):
    from faster_voxelpose_tpu_torch.geometry import dome_rig

    return dome_rig(1, V)[0]


def _points(rig, rng, n=400):
    """World points in the Panoptic space plus points behind and right
    next to each camera (garbage projections the clamps must bound)."""
    pts = rng.uniform([-4000, -4500, -200], [4000, 3500, 1800], (n, 3))
    near = []
    for cam in rig:
        R, T = cam[0:9].reshape(3, 3), cam[9:12]
        near.append(T - 300.0 * R[2] + rng.normal(0, 50, (10, 3)))  # behind
        near.append(T + 20.0 * R[2] + rng.normal(0, 5, (10, 3)))  # near plane
    return np.concatenate([pts] + near).astype(np.float32)


def test_project_points_matches_jax():
    from faster_voxelpose_tpu.geometry.cameras import project_points as jax_proj
    from faster_voxelpose_tpu_torch.geometry import project_points

    rig = _dome()
    pts = _points(rig, np.random.RandomState(0))
    ref = np.stack([np.asarray(jax_proj(jnp.asarray(pts), jnp.asarray(c))) for c in rig])
    ours = project_points(torch.as_tensor(pts), torch.as_tensor(rig)).numpy()
    finite = np.abs(ref) < 1e6  # behind-camera points explode; compare relatively there
    np.testing.assert_allclose(ours[finite], ref[finite], atol=1e-3, rtol=1e-6)
    np.testing.assert_allclose(ours, ref, rtol=1e-5)


def test_project_to_norm_coords_matches_jax():
    """Normalized coords, behind-camera points included, to 1e-3 px."""
    from faster_voxelpose_tpu.geometry.grids import project_to_norm_coords as jax_norm
    from faster_voxelpose_tpu_torch.geometry import (
        get_resize_transform,
        project_to_norm_coords,
    )

    rig = _dome()
    pts = _points(rig, np.random.RandomState(1))
    args = ((1920, 1080), (960, 512), (240, 128))
    rt = get_resize_transform(args[0], args[1])
    ref = np.stack([
        np.asarray(jax_norm(jnp.asarray(pts), jnp.asarray(c), jnp.asarray(rt, jnp.float32), *args))
        for c in rig
    ])
    ours = project_to_norm_coords(torch.as_tensor(pts), torch.as_tensor(rig), rt, *args).numpy()
    px = np.array([239.0, 127.0]) / 2  # normalized units -> pixels
    assert np.max(np.abs(ours - ref) * px) <= 1e-3


def test_host_geometry_matches_jax():
    from faster_voxelpose_tpu.geometry import grids as jg, transforms as jt
    from faster_voxelpose_tpu.geometry.example_rigs import dome_rig as jax_dome
    from faster_voxelpose_tpu_torch.geometry import (
        compute_center_grids_np,
        compute_grid_np,
        dome_rig,
        get_resize_transform,
    )

    np.testing.assert_array_equal(dome_rig(2, 5), jax_dome(2, 5))
    for ori, img in (((1920, 1080), (960, 512)), ((360, 288), (800, 640))):
        np.testing.assert_array_equal(
            get_resize_transform(ori, img), jt.get_resize_transform(ori, img)
        )
    args = ((8000.0, 8000.0, 2000.0), (0.0, -500.0, 800.0), (80, 80, 20))
    np.testing.assert_array_equal(compute_grid_np(*args), jg.compute_grid_np(*args))
    args = ((2000.0, 2000.0, 2000.0), (0.0, -500.0, 800.0), (64, 64, 64))
    np.testing.assert_array_equal(
        compute_center_grids_np(*args), jg.compute_center_grids_np(*args)
    )


def test_projection_geometry_matches_jax():
    from faster_voxelpose_tpu.models.projection import make_projection_geometry as jax_geom
    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.models.projection import make_projection_geometry

    from faster_voxelpose_tpu.config import load_config

    ours = make_projection_geometry(panoptic_synthetic_profile())
    ref = jax_geom(load_config(REPO / "configs/demo/panoptic_synthetic.yaml"))
    for name in ref._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(ours, name)), np.asarray(getattr(ref, name)), err_msg=name
        )


def test_crop_origin_and_masks_match_jax():
    """Round-half-even crop origins (values built to land on .5 exactly),
    offsets, and the bbox axis masks with clipped and degenerate boxes."""
    from faster_voxelpose_tpu.models import projection as jp
    from faster_voxelpose_tpu_torch.models import projection as pp

    jcfg, pcfg = tiny_configs()
    jgeom, pgeom = jp.make_projection_geometry(jcfg), pp.make_projection_geometry(pcfg)
    rng = np.random.RandomState(2)
    scale = pgeom.fine_scale.astype(np.float64)
    bias = pgeom.fine_bias.astype(np.float64)
    half = (np.arange(-3, 9)[:, None] + 0.5 - bias) / scale  # centres at x.5
    centers = np.concatenate([
        half, rng.uniform(-2600, 2600, (20, 3)), rng.uniform(-200, 1800, (8, 3))
    ]).astype(np.float32)
    # keep only centres whose f32 product lands exactly on .5 (the tie case)
    tl_j, off_j = jp.compute_crop_origin(jgeom, jnp.asarray(centers))
    tl_p, off_p = pp.compute_crop_origin(pgeom, torch.as_tensor(centers))
    prod = centers * pgeom.fine_scale + pgeom.fine_bias
    assert np.any(prod == np.floor(prod) + 0.5), "no exact half-way case built"
    np.testing.assert_array_equal(tl_p.numpy(), np.asarray(tl_j))
    np.testing.assert_allclose(off_p.numpy(), np.asarray(off_j), atol=1e-3)

    bbox = rng.uniform(-0.2, 1.2, (len(centers), 2)).astype(np.float32)
    ref = jax.vmap(lambda t, b: jp.crop_axis_masks(jgeom, t, b))(tl_j, jnp.asarray(bbox))
    ours = pp.crop_axis_masks(pgeom, tl_p, torch.as_tensor(bbox))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
