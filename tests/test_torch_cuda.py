"""PyTorch port on the card: the CUDA kernels against their plain
versions, the wrappers' checks and counters, and the model's CUDA path
against its CPU path.  Every test needs a CUDA device and skips without
one.  This file imports neither JAX nor PyYAML, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 on sampled values in [0, 1] (the kernels contract
multiply-adds into FMAs, the plain version does not).  The window
kernel's TF32 modes are held to the same 1e-5, because their plain
version rounds the operands as the kernel does.  The bf16 tensor-core
kernel is held to one bf16 ulp of the value (2^-7 relative): its float32
sums are taken in the tensor cores' order, and the result is rounded to
bf16 once.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from faster_voxelpose_tpu_torch.device import pin_float32

    pin_float32()
    return torch.device("cuda")


def tiny_cfg():
    """The tiny geometry of the CPU tests, float32 conv stacks."""
    from faster_voxelpose_tpu_torch.config import Config

    cfg = Config()
    d, c, i = cfg.DATASET, cfg.CAPTURE_SPEC, cfg.INDIVIDUAL_SPEC
    d.ORI_IMAGE_SIZE, d.IMAGE_SIZE, d.HEATMAP_SIZE = (320, 240), (160, 128), (40, 32)
    d.NUM_JOINTS, d.CAMERA_NUM = 15, 3
    c.SPACE_SIZE, c.SPACE_CENTER = (4000.0, 4000.0, 1600.0), (0.0, 0.0, 800.0)
    c.VOXELS_PER_AXIS, c.MAX_PEOPLE = (16, 16, 8), 4
    i.VOXELS_PER_AXIS = (16, 16, 16)
    cfg.NETWORK.COMPUTE_DTYPE = "float32"
    return cfg


def _case(cfg, seed, K=5):
    """Random heatmaps, a dome rig with camera 0 pulled into the volume,
    and K crops (one at the space edge, one at the near camera, one dead)."""
    from faster_voxelpose_tpu_torch.geometry import dome_rig
    from faster_voxelpose_tpu_torch.models.projection import make_projection_geometry

    geom = make_projection_geometry(cfg)
    V, J = cfg.DATASET.CAMERA_NUM, cfg.DATASET.NUM_JOINTS
    W, H = cfg.DATASET.HEATMAP_SIZE
    center = np.asarray(cfg.CAPTURE_SPEC.SPACE_CENTER)
    rng = np.random.RandomState(seed)
    rig = dome_rig(1, V, space_center=tuple(center), ori_image_size=cfg.DATASET.ORI_IMAGE_SIZE,
                   focal=cfg.DATASET.ORI_IMAGE_SIZE[0] * 0.75)[0]
    rig[0, 9:12] = center + np.array([0.0, -700.0, 0.0])
    hm = rng.rand(V, H, W, J).astype(np.float32)
    centers = center + rng.uniform(-1500, 1500, (K, 3))
    centers[1] = center + np.array([1950.0, -1900.0, -700.0])
    centers[K - 1] = rig[0, 9:12] + np.array([120.0, 80.0, -250.0])
    bbox = rng.uniform(0.2, 1.0, (K, 2))
    valid = np.ones(K, bool)
    valid[2] = False
    return geom, rig, hm, centers.astype(np.float32), bbox.astype(np.float32), valid


def _kernel_args(geom, rig, hm, centers, bbox, valid, device):
    from faster_voxelpose_tpu_torch.models import projection as pj

    tl, _ = pj.compute_crop_origin(geom, torch.as_tensor(centers, device=device))
    masks = pj.crop_axis_masks(geom, tl, torch.as_tensor(bbox, device=device))
    return (torch.as_tensor(hm, device=device), torch.as_tensor(rig, device=device),
            tl.contiguous(), *(m.to(torch.uint8) for m in masks),
            torch.as_tensor(valid, device=device).to(torch.uint8), pj.crop_projection(geom))


def _profiles():
    """The tiny geometry and the served profiles: Panoptic, Shelf (5 views,
    200x152, 17 joints) and Campus (3 views, 200x160, 17 joints, K = 5)."""
    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile, profile

    return {"tiny": tiny_cfg, "panoptic": panoptic_synthetic_profile,
            "shelf": lambda: profile("shelf_synthetic_ref"),
            "campus": lambda: profile("campus_synthetic_ref")}


@pytest.mark.parametrize("profile", ["tiny", "panoptic", "shelf", "campus"])
def test_kernels_match_plain(dev, profile):
    from faster_voxelpose_tpu_torch.models.projection import whole_pixels
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    cfg = _profiles()[profile]()
    geom, rig, hm, centers, bbox, valid = _case(cfg, 0, K=cfg.CAPTURE_SPEC.MAX_PEOPLE)
    args = _kernel_args(geom, rig, hm, centers, bbox, valid, dev)
    pix = whole_pixels(geom, torch.as_tensor(geom.whole_grid, device=dev), args[1])
    out = sk.sample_whole(args[0], pix)
    torch.testing.assert_close(out, sk.sample_whole_plain(args[0], pix), atol=1e-5, rtol=0)
    planes = sk.sample_crop_planes(*args)
    for a, b in zip(planes, sk.sample_crop_planes_plain(*args)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    assert float(planes[0][2].abs().max()) == 0.0  # the dead slot


@pytest.mark.parametrize("profile", ["tiny", "panoptic", "shelf", "campus"])
def test_coords_and_cube_modes_match_plain(dev, profile):
    """Kernel rows 3 and 4: planes from coords, and the masked cube from
    in-kernel projection and from coords, against their plain versions;
    the cube's max planes equal the planes kernel's bit for bit."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    cfg = _profiles()[profile]()
    geom, rig, hm, centers, bbox, valid = _case(cfg, 2, K=cfg.CAPTURE_SPEC.MAX_PEOPLE)
    hm_t, cams, tl, mx, my, mz, v, crop = _kernel_args(geom, rig, hm, centers, bbox, valid, dev)
    masks = (mx, my, mz, v)
    pix = sk.crop_pixels(crop, cams, tl, geom.ind_voxels_per_axis)
    sk.reset_launch_counts()
    planes_c = sk.sample_crop_planes_coords(hm_t, pix, *masks)
    cube_p = sk.sample_crop_cube(hm_t, *masks, cams=cams, centers_tl=tl, crop=crop)
    cube_c = sk.sample_crop_cube(hm_t, *masks, pix=pix)
    assert sk.launch_counts()["sample_crop_planes_coords"] == 1
    assert sk.launch_counts()["sample_crop_cube"] == 2
    for a, b in zip(planes_c, sk.sample_crop_coords_plain(hm_t, pix, *masks)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    torch.testing.assert_close(cube_p, sk.sample_crop_planes_plain(hm_t, cams, tl, *masks, crop, cube=True),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(cube_c, sk.sample_crop_coords_plain(hm_t, pix, *masks, cube=True),
                               atol=1e-5, rtol=0)
    assert float(cube_p[2].abs().max()) == 0.0  # the dead slot
    planes = sk.sample_crop_planes(hm_t, cams, tl, *masks, crop)
    for a, b in zip((cube_p.amax(3), cube_p.amax(2), cube_p.amax(1)), planes):
        assert torch.equal(a, b)


def _edge_case(dev, voxels, J, seed=0, views=3, heatmap=(40, 32)):
    """K = 4 crops of `voxels` on the tiny geometry's projection, J joints,
    `views` cameras, heatmaps of `heatmap` (W, H): slot 0 with masks that
    are not intervals, slot 1 dead, slot 2 with one live voxel, slot 3 with
    interval masks right next to a camera."""
    from faster_voxelpose_tpu_torch.models import projection as pj

    cfg = tiny_cfg()
    cfg.DATASET.CAMERA_NUM, cfg.DATASET.HEATMAP_SIZE = views, heatmap
    geom, rig, _, centers, _, _ = _case(cfg, seed, K=4)
    rng = np.random.RandomState(seed)
    V, (W, H) = cfg.DATASET.CAMERA_NUM, cfg.DATASET.HEATMAP_SIZE
    hm = torch.as_tensor(rng.rand(V, H, W, J).astype(np.float32), device=dev)
    tl, _ = pj.compute_crop_origin(geom, torch.as_tensor(centers, device=dev))
    masks = [torch.as_tensor(rng.rand(4, n) < 0.6, device=dev).to(torch.uint8) for n in voxels]
    for m, n in zip(masks, voxels):
        m[2] = 0
        m[2, n // 2] = 1
        m[3] = 0
        m[3, n // 4: n - 2] = 1
    valid = torch.tensor([1, 0, 1, 1], dtype=torch.uint8, device=dev)
    return hm, torch.as_tensor(rig, device=dev), tl.contiguous(), masks, valid, pj.crop_projection(geom)


def _crop_modes(hm, cams, tl, masks, valid, crop, voxels):
    """Every crop-sampler mode on one input, with its plain version:
    {mode: (kernel output, plain output)}."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    pix = sk.crop_pixels(crop, cams, tl, voxels)
    proj = dict(cams=cams, centers_tl=tl, crop=crop)
    return {
        "planes": (sk.sample_crop_planes(hm, cams, tl, *masks, valid, crop),
                   sk.sample_crop_planes_plain(hm, cams, tl, *masks, valid, crop)),
        "planes_coords": (sk.sample_crop_planes_coords(hm, pix, *masks, valid),
                          sk.sample_crop_coords_plain(hm, pix, *masks, valid)),
        "cube": ((sk.sample_crop_cube(hm, *masks, valid, **proj),),
                 (sk.sample_crop_planes_plain(hm, cams, tl, *masks, valid, crop, cube=True),)),
        "cube_coords": ((sk.sample_crop_cube(hm, *masks, valid, pix=pix),),
                        (sk.sample_crop_coords_plain(hm, pix, *masks, valid, cube=True),)),
    }


def _hold_crop_modes(hm, cams, tl, masks, valid, crop, voxels):
    """Every crop-sampler mode against its plain version at 1e-5, zeros
    for the dead slot 1, at most one live voxel in slot 2; two launches
    give the same planes bit for bit, and so do the cube's max planes."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    modes = _crop_modes(hm, cams, tl, masks, valid, crop, voxels)
    for mode, (out, ref) in modes.items():
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=lambda m: f"{mode}: {m}")
            assert float(a[1].abs().max()) == 0.0, mode  # the dead slot
    cube = modes["cube"][0][0]
    assert int((cube[2] != 0).any(-1).sum()) <= 1 and float(cube[0].max()) > 0.0
    again = sk.sample_crop_planes(hm, cams, tl, *masks, valid, crop)
    for a, b, c in zip(modes["planes"][0], again, (cube.amax(3), cube.amax(2), cube.amax(1))):
        assert torch.equal(a, b) and torch.equal(a, c)


# (16, 16, 16) and (24, 40, 8) fill every x, y tile and cut z; (18, 22, 40)
# and (5, 7, 33) cut every axis, with a partial last z chunk after a full one
_EDGE_VOXELS = [(16, 16, 16), (24, 40, 8), (18, 22, 40), (5, 7, 33)]


@pytest.mark.parametrize("J", [1, 15, 16, 32])
@pytest.mark.parametrize("voxels", _EDGE_VOXELS)
def test_crop_modes_at_tile_edges(dev, voxels, J):
    """The crop sampler's tiling against its plain versions: crop sizes
    that are not multiples of the block tile, masks that are not
    intervals, a dead slot and a slot with one live voxel, 1 to 32
    joints."""
    _hold_crop_modes(*_edge_case(dev, voxels, J), voxels)


@pytest.mark.parametrize("heatmap", [(200, 152), (200, 160)])
@pytest.mark.parametrize("voxels", _EDGE_VOXELS)
def test_crop_modes_at_17_joints_and_3_views(dev, voxels, heatmap):
    """The Shelf and Campus joint count and view count on the crop
    sampler's edges: J = 17 (a second joint group with one live lane),
    3 views, heatmaps of the Shelf and Campus sizes."""
    _hold_crop_modes(*_edge_case(dev, voxels, 17, heatmap=heatmap), voxels)


def test_crop_modes_above_48kb_of_shared_memory(dev):
    """Ten views: the planes modes need more than the 48 KB of dynamic
    shared memory a launch gets by default, so the kernel raises its
    limit; every mode still matches its plain version."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    voxels = (18, 22, 40)
    for project in (True, False):
        geo = sk.crop_launch_geometry(10, 15, 4, voxels, project=project, cube=False)
        assert 48 * 1024 < geo["smem"] <= geo["smem_max"]
    _hold_crop_modes(*_edge_case(dev, voxels, 15, views=10), voxels)


@pytest.mark.parametrize("voxels", _EDGE_VOXELS)
def test_crop_modes_with_every_slot_dead(dev, voxels):
    """No valid slot: every mode returns zeros without touching a pixel."""
    hm, cams, tl, masks, valid, crop = _edge_case(dev, voxels, 15, seed=1)
    modes = _crop_modes(hm, cams, tl, masks, torch.zeros_like(valid), crop, voxels)
    for mode, (out, ref) in modes.items():
        for a, b in zip(out, ref):
            assert float(a.abs().max()) == 0.0 and float(b.abs().max()) == 0.0, mode


def test_crop_launch_geometry(dev):
    """The launch that the kernel's source computes: one block per tile
    and slot, the shared memory within what a block has."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    for project in (True, False):
        for cube in (True, False):
            geo = sk.crop_launch_geometry(5, 15, 10, (64, 64, 64), project=project, cube=cube)
            tx, ty, tz = geo["tile"]
            assert geo["grid"] == (-(-64 // tx) * -(-64 // ty) * -(-64 // tz), 10)
            assert 0 < geo["smem"] <= geo["smem_max"] and geo["threads"] % 32 == 0
    with pytest.raises(ValueError, match="shared memory"):
        hm = torch.rand(200, 4, 4, 32, device=dev)
        m = torch.ones(1, 8, dtype=torch.uint8, device=dev)
        sk.sample_crop_planes_coords(hm, torch.zeros(1, 200, 512, 2, device=dev), m, m, m, m[:, 0])


def test_model_routes_agree_on_the_card(dev):
    """The tiny model under the default, coords and cube routes: each
    launches its own crop kernel once and the poses agree."""
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    outs = {}
    for name, keys in (("sample_crop_planes", {}),
                       ("sample_crop_planes_coords", {"PALLAS_FUSED_COORDS": False}),
                       ("sample_crop_cube", {"PALLAS_TILE": (4, 4, 4)})):
        cfg = tiny_cfg()
        cfg.NETWORK.PALLAS_TILE, cfg.NETWORK.PALLAS_WINDOW = (8, 8, 8), (8, 16)
        cfg.CAPTURE_SPEC.MIN_SCORE = -1e9
        cfg.INDIVIDUAL_SPEC.SPACE_SIZE = (2100.0,) * 3
        for k, val in keys.items():
            setattr(cfg.NETWORK, k, val)
        torch.manual_seed(0)
        model = build_model(cfg).to(dev)
        geom, rig, hm, *_ = _case(cfg, 1)
        sk.reset_launch_counts()
        with torch.no_grad():
            outs[name] = model(torch.as_tensor(hm, device=dev)[None], torch.as_tensor(rig, device=dev)[None])
        counts = sk.launch_counts()
        assert counts[name] == 1 and sum(counts.values()) == 2, counts
    ref = outs["sample_crop_planes"].fused_poses
    for out in outs.values():
        assert float((out.fused_poses - ref).abs().max()) <= 0.01


def test_wrappers_check_and_count(dev):
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    hm = torch.rand(2, 8, 10, 3, device=dev)
    pix = torch.rand(2, 50, 2, device=dev) * 10
    sk.reset_launch_counts()
    sk.sample_whole(hm, pix)
    assert sk.launch_counts()["sample_whole"] == 1
    with pytest.raises(TypeError):
        sk.sample_whole(hm.double(), pix.double())
    with pytest.raises(ValueError):
        sk.sample_whole(hm.transpose(1, 2), pix)
    with pytest.raises(ValueError):
        sk.sample_whole(hm, pix.cpu())
    assert sk.launch_counts()["sample_whole"] == 1


def test_model_cuda_matches_cpu(dev):
    """The whole tiny model through the kernels on the card against its
    plain path on the CPU, same random weights, float32 (TF32 off)."""
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    cfg = tiny_cfg()
    cfg.CAPTURE_SPEC.MIN_SCORE = -1e9
    cfg.INDIVIDUAL_SPEC.SPACE_SIZE = (2100.0,) * 3  # no crop-origin ties
    torch.manual_seed(0)
    model = build_model(cfg)
    with torch.no_grad():  # fan-in scaled weights: O(1) activations
        for p in model.parameters():
            if p.ndim > 1:
                p.normal_(0.0, (2.0 / (p[0].numel())) ** 0.5)
        size_out = model.hdn.center_net.size_out  # bbox sizes near 0.6
        size_out.weight.mul_(0.01)
        size_out.bias.fill_(0.6)
    geom, rig, hm, *_ = _case(cfg, 1)
    hm_t, rig_t = torch.as_tensor(hm)[None], torch.as_tensor(rig)[None]
    with torch.no_grad():
        ref = model(hm_t, rig_t)
        sk.reset_launch_counts()
        out = model.to(dev)(hm_t.to(dev), rig_t.to(dev))
    assert sk.launch_counts() == {"sample_whole": 0, "sample_whole_projected": 1,
                                  "sample_crop_planes": 1,
                                  "sample_crop_planes_coords": 0, "sample_crop_cube": 0,
                                  "window_sample": 0, "mma_window": 0, "weightnet_front": 0,
                                  "front3d": 0, "front_res3d": 0, "projattn": 0}
    torch.testing.assert_close(out.proposal_centers.cpu(), ref.proposal_centers, atol=1e-3, rtol=0)
    assert float((out.fused_poses.cpu() - ref.fused_poses)[..., :3].abs().max()) <= 0.5


# ---------------------------------------------------------------------------
# kernel row 1 in its projected mode (sample_whole_projected)
# ---------------------------------------------------------------------------

_WHOLE_HEATMAPS = [(240, 128), (200, 152), (200, 160)]  # Panoptic, Shelf, Campus (W, H)


def _whole_case(dev, J, V, B, heatmap=(40, 32), voxels=(16, 16, 8), seed=0):
    """The tiny geometry with J joints, V views, these heatmaps and grid: its
    geometry, heatmaps (B, V, H, W, J), cams (B, V, 21) of dome rigs with
    camera 0 of each sample inside the volume, the axes and the projection
    constants."""
    from faster_voxelpose_tpu_torch.geometry import dome_rig
    from faster_voxelpose_tpu_torch.models import projection as pj

    cfg = tiny_cfg()
    d = cfg.DATASET
    d.NUM_JOINTS, d.CAMERA_NUM, d.HEATMAP_SIZE = J, V, heatmap
    cfg.CAPTURE_SPEC.VOXELS_PER_AXIS = voxels
    geom = pj.make_projection_geometry(cfg)
    rng = np.random.RandomState(seed)
    center = np.asarray(cfg.CAPTURE_SPEC.SPACE_CENTER)
    cams = dome_rig(B, V, space_center=tuple(center), ori_image_size=d.ORI_IMAGE_SIZE,
                    focal=d.ORI_IMAGE_SIZE[0] * 0.75)
    cams[:, 0, 9:12] = center + rng.uniform(-900, 900, (B, 3))
    W, H = heatmap
    hm = rng.rand(B, V, H, W, J).astype(np.float32)
    axes = tuple(torch.as_tensor(a, device=dev) for a in pj.whole_axes(geom))
    return (geom, torch.as_tensor(hm, device=dev), torch.as_tensor(cams, device=dev), axes,
            pj.whole_projection(geom))


def _check_whole(dev, geom, hm, cams, axes, proj):
    """The kernel against the plain version (1e-5), and equal to the coords
    mode on whole_pixels of the same cameras, bit for bit."""
    from faster_voxelpose_tpu_torch.models import projection as pj
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    out = sk.sample_whole_projected(hm, cams, axes, proj)
    ref = sk.sample_whole_projected_plain(hm, cams, axes, proj)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    grid = torch.as_tensor(geom.whole_grid, device=dev)
    for b in range(hm.shape[0]):
        coords = sk.sample_whole(hm[b], pj.whole_pixels(geom, grid, cams[b]))
        assert torch.equal(out[b].reshape(coords.shape), coords)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("V", [1, 3, 5, 8])
@pytest.mark.parametrize("J", [1, 15, 16, 17, 32])
def test_whole_projected_matches_plain(dev, J, V, B):
    heatmap = _WHOLE_HEATMAPS[(J + V + B) % 3]
    _check_whole(dev, *_whole_case(dev, J, V, B, heatmap=heatmap, seed=J * 100 + V * 10 + B))


@pytest.mark.parametrize("heatmap", _WHOLE_HEATMAPS)
def test_whole_projected_full_grid(dev, heatmap):
    """The 80 x 80 x 20 grid of the profiles at each profile's heatmaps, 17
    joints, 5 views, B = 3."""
    _check_whole(dev, *_whole_case(dev, 17, 5, 3, heatmap=heatmap, voxels=(80, 80, 20)))


@pytest.mark.parametrize("voxels", [(7, 9, 5), (9, 10, 3), (1, 1, 1)])
def test_whole_projected_ragged_tiles(dev, voxels):
    """Grids that do not fill their last 256-voxel tile."""
    _check_whole(dev, *_whole_case(dev, 15, 3, 2, voxels=voxels))


def test_whole_projected_checks_and_counts(dev):
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    geom, hm, cams, axes, proj = _whole_case(dev, 15, 3, 2)
    sk.reset_launch_counts()
    sk.sample_whole_projected(hm, cams, axes, proj)
    assert sk.launch_counts()["sample_whole_projected"] == 1
    with pytest.raises(TypeError):
        sk.sample_whole_projected(hm.double(), cams.double(), axes, proj)
    with pytest.raises(ValueError):  # not contiguous
        sk.sample_whole_projected(hm.transpose(2, 3), cams, axes, proj)
    with pytest.raises(ValueError):  # one sample's layout
        sk.sample_whole_projected(hm[0], cams[0], axes, proj)
    with pytest.raises(ValueError):  # a mix of devices
        sk.sample_whole_projected(hm, cams.cpu(), axes, proj)
    with pytest.raises(ValueError):  # nine views
        sk.sample_whole_projected(hm[:, [0, 1, 2] * 3].contiguous(), cams[:, [0, 1, 2] * 3]
                                  .contiguous(), axes, proj)
    with pytest.raises(ValueError):  # 33 joints
        sk.sample_whole_projected(torch.cat([hm] * 3, -1)[..., :33].contiguous(), cams, axes,
                                  proj)
    with pytest.raises(ValueError):  # heatmaps of another size than the projection's
        sk.sample_whole_projected(hm[:, :, :-1].contiguous(), cams, axes, proj)
    assert sk.launch_counts()["sample_whole_projected"] == 1


def test_whole_launch_geometry(dev):
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    geo = sk.whole_launch_geometry(5, (80, 80, 20), 4)
    assert geo["grid"] == (500, 4) and geo["threads"] == geo["voxels"] == 256
    assert geo["smem"] == 16 * 5 * 256 + 4 * (5 * 21 + 5 * 3 * 180) <= geo["smem_max"]


def test_device_timer_reads_a_graph(dev):
    """tools/timing.py on the card: a kernel is captured in a CUDA graph; a
    call that synchronises the host cannot be and is read back to back."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.tools.timing import device_timing, host_ms

    _, hm, cams, axes, proj = _whole_case(dev, 15, 3, 2)
    ms, how = device_timing(lambda: sk.sample_whole_projected(hm, cams, axes, proj))
    assert how == "graph" and 0 < ms < 10
    ms, how = device_timing(lambda: float(hm.sum()), n=2, reps=2)
    assert how == "back to back" and ms > 0
    ms, how = device_timing(lambda: sk.sample_whole_projected(hm, cams, axes, proj))
    assert how == "graph" and 0 < ms < 10
    assert 0 < host_ms(lambda: sk.sample_whole_projected(hm, cams, axes, proj)) < 100


# ---------------------------------------------------------------------------
# the tuning kernels (ops/window_kernels.py)
# ---------------------------------------------------------------------------


def _window_case(cfg, spread, n_blocks=64, seed=0):
    from faster_voxelpose_tpu_torch.tools import sweep_sampling as sw

    rng = np.random.RandomState(seed)
    hm = rng.rand(sw.V, sw.H, sw.W, sw.J).astype(np.float32)
    return hm, sw.sweep_coords(n_blocks, cfg.s, spread, rng)


@pytest.mark.parametrize("spread", [6.0, 12.0])
@pytest.mark.parametrize("index", range(9))
def test_window_kernel_matches_plain(dev, index, spread):
    """Every instantiation against its plain version at a spread every
    window covers and at one the 16-wide windows do not; where the window
    covers the spread, float32 also agrees with the exact sampler."""
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk
    from faster_voxelpose_tpu_torch.tools.probe_sampling import exact_reference

    cfg = wk.SWEEP_CONFIGS[index]
    hm, coords = (torch.as_tensor(a, device=dev) for a in _window_case(cfg, spread))
    out = wk.window_sample(hm, coords, cfg)
    torch.testing.assert_close(out, wk.window_sample_plain(hm, coords, cfg), atol=1e-5, rtol=0)
    assert float(out[:, 15].abs().max()) == 0.0  # the padding channel
    if spread <= 7 and cfg.prec in ("fp32", "tf32x3"):
        torch.testing.assert_close(out, exact_reference(hm, coords), atol=1e-5, rtol=0)


_WINDOW_EDGES = ["edges", "spread30", "views1", "views8", "joints1"]


@pytest.mark.parametrize("case", _WINDOW_EDGES)
@pytest.mark.parametrize("index", range(9))
def test_window_kernel_at_its_edges(dev, index, case):
    """Every instantiation against its plain version (1e-5) where its
    footprints are unusual: blocks past each image edge (origins clipped
    at 0 and at W - XW, H - YW), samples on integer pixels up to the last
    column and row, a block past the right edge (nothing staged: zeros), a
    spread of 30 (the footprint fills the window and every config cuts),
    1 and 8 views, 1 joint.  Two launches equal bit for bit."""
    from chip_smoke import edge_coords
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk
    from faster_voxelpose_tpu_torch.tools import sweep_sampling as sw
    from faster_voxelpose_tpu_torch.tools.probe_sampling import exact_reference

    cfg = wk.SWEEP_CONFIGS[index]
    rng = np.random.RandomState(index)
    V = {"views1": 1, "views8": 8}.get(case, sw.V)
    J = 1 if case == "joints1" else sw.J
    hm = torch.as_tensor(rng.rand(V, sw.H, sw.W, J).astype(np.float32), device=dev)
    if case == "spread30":
        coords = sw.sweep_coords(64, cfg.s, 30.0, rng)
    else:
        coords = edge_coords(cfg.s, rng, views=V)
    coords = torch.as_tensor(coords, device=dev)
    out = wk.window_sample(hm, coords, cfg)
    torch.testing.assert_close(out, wk.window_sample_plain(hm, coords, cfg), atol=1e-5, rtol=0)
    assert torch.equal(out, wk.window_sample(hm, coords, cfg))
    assert float(out[:, J:].abs().max()) == 0.0  # the padding channels
    if case == "spread30":
        assert float((out - exact_reference(hm, coords)).abs().max()) > 1e-2
    else:
        assert float(out[5].abs().max()) == 0.0 and float(out[:5].max()) > 0.1


@pytest.mark.parametrize("dyn", [False, True])
@pytest.mark.parametrize("k", [128, 64, 32])
def test_mma_window_matches_plain(dev, k, dyn):
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk
    from faster_voxelpose_tpu_torch.tools import microbench_mma as mb

    lhs, rhs, oy = mb.make_operands(8, k, dev, seed=k)
    origin = oy if dyn else None
    out = wk.mma_window(lhs, rhs, origin, k, mb.NMAT)
    ref = wk.mma_window_plain(lhs, rhs, origin, k, mb.NMAT)
    assert out.shape == (8, 8, mb.N) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), atol=0, rtol=2.0 ** -7)
    # another nmat and narrower operands through the same kernel
    lhs, rhs, oy = mb.make_operands(3, k, dev, seed=1, m=32, n=64)
    origin = oy if dyn else None
    torch.testing.assert_close(wk.mma_window(lhs, rhs, origin, k, 2).float(),
                               wk.mma_window_plain(lhs, rhs, origin, k, 2).float(),
                               atol=0, rtol=2.0 ** -7)


def _mma_close(out, ref):
    torch.testing.assert_close(out.float(), ref.float(), atol=0, rtol=2.0 ** -7)


@pytest.mark.parametrize("dyn", [False, True])
@pytest.mark.parametrize("k", [128, 64, 32])
@pytest.mark.parametrize("m", [16, 32, 80, 320, 640])
def test_mma_window_ragged_tiles(dev, m, k, dyn):
    """Row tiles of 128 in two warpgroups of 64 against M = 16 ... 640
    (partial and wholly empty halves), column tiles of 256 against
    N = 64, 192, 2048 (zero-filled and unloaded boxes), at nmat 1, 2, 5."""
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk
    from faster_voxelpose_tpu_torch.tools import microbench_mma as mb

    for n, nmat in ((64, 1), (192, 2), (2048, 5)):
        lhs, rhs, oy = mb.make_operands(3, k, dev, seed=m + n + k, m=m, n=n)
        origin = oy if dyn else None
        _mma_close(wk.mma_window(lhs, rhs, origin, k, nmat),
                   wk.mma_window_plain(lhs, rhs, origin, k, nmat))


@pytest.mark.parametrize("nmat", [1, 2, 5])
@pytest.mark.parametrize("k", [128, 64, 32])
def test_mma_window_persistent_wrap(dev, k, nmat):
    """One step, and 2 * SMs + 1 steps of one column tile, so that every
    persistent block walks three steps through its rings."""
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk
    from faster_voxelpose_tpu_torch.tools import microbench_mma as mb

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for steps in (1, 2 * sms + 1):
        lhs, rhs, oy = mb.make_operands(steps, k, dev, seed=steps + nmat, m=80, n=192)
        for origin in (None, oy):
            _mma_close(wk.mma_window(lhs, rhs, origin, k, nmat),
                       wk.mma_window_plain(lhs, rhs, origin, k, nmat))


def test_mma_window_back_to_back_shapes(dev):
    """Calls in a row with other shapes, K and origins: each call encodes
    its own tensor maps, so none reads another's operands."""
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk
    from faster_voxelpose_tpu_torch.tools import microbench_mma as mb

    big = mb.make_operands(3, 64, dev, seed=5, m=640, n=2048)
    small = mb.make_operands(5, 32, dev, seed=6, m=80, n=192)
    calls = [(big, None, 128, 5), (small, small[2], 32, 2), (big, big[2], 64, 1),
             (small, None, 128, 5)]
    outs = [wk.mma_window(ops[0], ops[1], origin, k, nmat) for ops, origin, k, nmat in calls]
    for out, (ops, origin, k, nmat) in zip(outs, calls):
        _mma_close(out, wk.mma_window_plain(ops[0], ops[1], origin, k, nmat))


def test_mma_window_nan_step_and_alignment(dev):
    """An origin that is not a window of lhs (not a multiple of 16,
    negative, past 128 - K) writes its step as NaN; its neighbours equal
    the plain version.  Operands not on 16 bytes, which TMA cannot read,
    are refused before the launch."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk
    from faster_voxelpose_tpu_torch.tools import microbench_mma as mb

    lhs, rhs, oy = mb.make_operands(3, 64, dev, m=320, n=192)
    for value in (8, -16, 80):
        bad = oy.clone()
        bad[1] = value
        out = wk.mma_window(lhs, rhs, bad, 64, 2)
        assert torch.isnan(out[1].float()).all()
        _mma_close(out[[0, 2]], wk.mma_window_plain(lhs, rhs[[0, 2]], oy[[0, 2]], 64, 2))
    shifted = torch.empty(lhs.numel() + 1, dtype=lhs.dtype, device=dev)[1:].view(lhs.shape)
    shifted.copy_(lhs)
    count = sk.launch_counts()["mma_window"]
    with pytest.raises(ValueError, match="16 bytes"):
        wk.mma_window(shifted, rhs, oy, 64)
    assert sk.launch_counts()["mma_window"] == count


def test_mma_plan_matches_the_kernel(dev):
    """The wrapper's plan, from the device the library reads, against the
    kernel's own tile, threads, shared-memory layout, B stages and blocks
    per SM (the runtime's occupancy of the kernel as built), for each K."""
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk

    index = torch.cuda.current_device()
    sms, smem, smem_block = wk.mma_device(index)
    assert sms == torch.cuda.get_device_properties(index).multi_processor_count
    for k in wk.MMA_KS:
        plan = wk.mma_plan(640, 2048, k, 512, sms, smem, smem_block)
        assert wk.mma_kernel_layout(k, plan.a_stages) == (
            plan.tile_m, plan.tile_n, wk.MMA_THREADS, plan.smem, wk.MMA_B_STAGES,
            plan.blocks_per_sm)
        assert plan.smem + wk.SMEM_RESERVED_PER_BLOCK <= smem and plan.smem <= smem_block


def test_tuning_wrappers_check_and_count(dev):
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk
    from faster_voxelpose_tpu_torch.tools import microbench_mma as mb

    cfg = wk.PROBE_CONFIG
    hm, coords = (torch.as_tensor(a, device=dev) for a in _window_case(cfg, 6.0, n_blocks=2))
    sk.reset_launch_counts()
    wk.window_sample(hm, coords, cfg)
    assert sk.launch_counts()["window_sample"] == 1
    with pytest.raises(ValueError, match="instantiated"):
        wk.window_sample(hm, coords, wk.WindowConfig(256, 32, 24))
    with pytest.raises(ValueError):
        wk.window_sample(hm, coords[..., :128].contiguous(), cfg)  # S of another config
    with pytest.raises(TypeError):
        wk.window_sample(hm.double(), coords.double(), cfg)
    with pytest.raises(ValueError):
        wk.window_sample(hm, coords.cpu(), cfg)
    with pytest.raises(ValueError, match="grad"):
        wk.window_sample(hm.clone().requires_grad_(), coords, cfg)
    assert sk.launch_counts()["window_sample"] == 1

    lhs, rhs, oy = mb.make_operands(2, 64, dev)
    wk.mma_window(lhs, rhs, oy, 64)
    assert sk.launch_counts()["mma_window"] == 1
    with pytest.raises(ValueError, match="instantiated"):
        wk.mma_window(lhs, rhs, oy, 48)
    with pytest.raises(TypeError):
        wk.mma_window(lhs.float(), rhs, oy, 64)
    with pytest.raises(ValueError):
        wk.mma_window(lhs[:, :24].contiguous(), rhs, oy, 64)  # M not a multiple of 16
    bad = oy.clone()
    bad[1] = 8  # not a multiple of 16: that step reads NaN, the other is untouched
    out = wk.mma_window(lhs, rhs, bad, 64)
    assert torch.isnan(out[1].float()).all() and torch.isfinite(out[0].float()).all()
    assert sk.launch_counts()["mma_window"] == 2


# ---------------------------------------------------------------------------
# WeightNet's front (weightnet_front, csrc/weightnet.cu)
# ---------------------------------------------------------------------------

# Against the plain version as the CPU runs it (oneDNN rounds conv + bias
# to bf16 once, as the kernel and cuDNN's fused conv + bias + ReLU do; on
# the card `F.conv2d` rounds the conv before it adds the bias, which near
# cancellation moves a value by half a bf16 ulp of the conv, so the card's
# plain version is no reference in bf16).  One bf16 ulp of the value (2^-7
# relative): the kernel's float32 sums of the 9 taps and of the pooled
# positions run in another order, which can move a rounding to bf16 by one
# step; 1e-7 absolute for means that float32 cancellation leaves near 0.
# In float32 the sums' order alone: 1e-5 relative.
WEIGHTNET_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def _weightnet_plain_on_cpu(feats, w, b):
    from faster_voxelpose_tpu_torch.ops import weightnet_kernels as wk

    return wk.weightnet_front_plain(feats.cpu(), w.cpu(), b.cpu())


def _weightnet_case(dev, M, J, H, W, C, dtype, seed=0, layout="channels_last"):
    """feats (M, J, H, W) float32 in P2PNet's channels-last layout (or
    with a gap between joints), a folded weight (C, 1, 3, 3) channels-last
    and a nonzero bias in `dtype`; channels 0-3 have negative weights and
    bias over non-negative feats, so every conv output there is negative."""
    gen = torch.Generator().manual_seed(seed)
    if layout == "channels_last":
        feats = torch.rand(M, H, W, J, generator=gen).to(dev).permute(0, 3, 1, 2)
    else:  # every other joint plane of a wider tensor
        feats = torch.rand(M, 2 * J, H, W, generator=gen).to(dev)[:, ::2]
    w = torch.randn(C, 1, 3, 3, generator=gen) * (2.0 / 9) ** 0.5
    b = torch.randn(C, generator=gen) * 0.2
    w[:4] = -w[:4].abs()
    b[:4] = -b[:4].abs() - 0.01
    w = w.to(dtype).contiguous(memory_format=torch.channels_last)
    return feats, w.to(dev), b.to(dtype).to(dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("M, J", [(30, 17), (30, 15)], ids=["shelf", "panoptic"])
@pytest.mark.parametrize("layout", ["channels_last", "strided"])
def test_weightnet_kernel_matches_plain(dev, M, J, dtype, layout):
    """The served shapes (M*J = 510 and 450 maps of 64x64, C = 32) against
    the plain version on the CPU within WEIGHTNET_RTOL; the all-negative
    channels read exactly 0; one launch; a second launch equal bit for
    bit."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.ops import weightnet_kernels as wk

    feats, w, b = _weightnet_case(dev, M, J, 64, 64, 32, dtype, layout=layout)
    assert not feats.is_contiguous()
    sk.reset_launch_counts()
    got = wk.weightnet_front(feats, w, b)
    assert sk.launch_counts()["weightnet_front"] == 1
    want = _weightnet_plain_on_cpu(feats, w, b)
    assert got.dtype == want.dtype == dtype and got.shape == (M * J, 32)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=WEIGHTNET_RTOL[dtype],
                               atol=1e-7)
    assert not bool(got[:, :4].any()) and bool((got[:, 4:] > 0).any())
    assert torch.equal(got, wk.weightnet_front(feats, w, b))


@pytest.mark.parametrize("H, W, C", [(16, 16, 8), (6, 10, 33), (64, 64, 64), (2, 2, 1),
                                     (128, 96, 32)])
def test_weightnet_kernel_at_other_shapes(dev, H, W, C):
    """Ragged strips (W/2 not a multiple of 4), C across and at the
    kernel's 64 channels, one pixel of pooled map, a map above 48 KB of
    shared memory: against the plain version on the CPU in bf16."""
    from faster_voxelpose_tpu_torch.ops import weightnet_kernels as wk

    feats, w, b = _weightnet_case(dev, 3, 5, H, W, C, torch.bfloat16, seed=H + W + C)
    got = wk.weightnet_front(feats, w, b)
    want = _weightnet_plain_on_cpu(feats, w, b)
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               rtol=WEIGHTNET_RTOL[torch.bfloat16], atol=1e-7)


def test_weightnet_wrapper_checks_and_counts(dev):
    """Odd sides, a float16 weight, 65 channels and weights off the card
    are refused on the card and launch nothing."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.ops import weightnet_kernels as wk

    feats, w, b = _weightnet_case(dev, 2, 3, 8, 8, 32, torch.bfloat16)
    sk.reset_launch_counts()
    with pytest.raises(ValueError):
        wk.weightnet_front(feats[..., :7], w, b)
    with pytest.raises(TypeError):
        wk.weightnet_front(feats, w.half(), b.half())
    w65, b65 = torch.cat([w, w, w[:1]]), torch.cat([b, b, b[:1]])
    with pytest.raises(ValueError):
        wk.weightnet_front(feats, w65, b65)
    with pytest.raises(ValueError):
        wk.weightnet_front(feats, w.cpu(), b.cpu())
    assert sk.launch_counts()["weightnet_front"] == 0
    wk.weightnet_front(feats, w, b)
    assert sk.launch_counts()["weightnet_front"] == 1


# ---------------------------------------------------------------------------
# VoxelPose's 7x7x7 front (front3d, csrc/front3d.cu)
# ---------------------------------------------------------------------------


def _front3d_case(dev, N, C, X, Y, Z, seed=0):
    """The samplers' cube (N, X, Y, Z, C) float32 in [0, 1] permuted to
    (N, C, X, Y, Z), a fan-in scaled bf16 weight (16, C, 7, 7, 7)
    channels-last-3d as the fold keeps it, a nonzero bias; outputs 0-3
    have negative weights and bias, so every one of their sums is
    negative."""
    from faster_voxelpose_tpu_torch.ops import front3d_kernels as fk

    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(N, X, Y, Z, C, generator=gen).to(dev).permute(0, 4, 1, 2, 3)
    w = torch.randn(16, C, 7, 7, 7, generator=gen) * (2.0 / (C * 343)) ** 0.5
    b = torch.randn(16, generator=gen) * 0.2
    w[:4] = -w[:4].abs()
    b[:4] = -b[:4].abs() - 0.01
    w = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d).to(dev)
    return x, w, b.to(torch.bfloat16).to(dev), fk.pack_weight(w)


def _bf16_ulp(v):
    """One bf16 ulp of |v| (2^-7 of its binade), 0 at 0."""
    a = v.float().abs()
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a.clamp_min(1e-30))) - 7), 0.0)


def _front3d_exact(x, w, b):
    """(The plain version in float64 on the bf16 operands: the exact value
    that a bf16 output rounds, its sums' own rounding negligible; the
    float64 sum of the products' magnitudes)."""
    from faster_voxelpose_tpu_torch.ops import front3d_kernels as fk

    xd, wd = x.to(torch.bfloat16).double().contiguous(), w.double().contiguous()
    exact = fk.front3d_plain(xd, wd, b.double())
    return exact, torch.nn.functional.conv3d(xd.abs(), wd.abs(), b.double().abs(), 1, 3)


def _front3d_off(got, exact, magnitude):
    """The largest |got - exact| in units of its tolerance: one bf16 ulp of
    the larger of the two (a float32 sum rounded once to bf16 lies within
    half an ulp, and float32 sums in another order can move the rounding
    by one step), and 2^-16 of the products' magnitude, for the float32
    sums' own error where they cancel to near 0."""
    tol = _bf16_ulp(torch.maximum(got.float().abs(), exact.float().abs()))
    tol = tol + 2.0 ** -16 * magnitude.float()
    return float(((got.double() - exact).abs() / (tol.double() + 1e-30)).max())


@pytest.mark.parametrize("shape", [(10, 15, 64, 64, 64), (1, 15, 80, 80, 20), (1, 17, 80, 80, 20),
                                   (2, 15, 9, 13, 11), (2, 17, 9, 13, 11), (1, 1, 3, 2, 40),
                                   (3, 15, 23, 9, 17)],
                         ids=["prn", "cpn", "cpn_j17", "ragged", "ragged_j17", "one_channel",
                              "rows"])
def test_front3d_kernel_matches_plain(dev, shape):
    """The PRN's (10 x 64^3 x 15) and the CPN's (80 x 80 x 20 x 15) shapes,
    J = 17, ragged tiles and several rows of tiles a block, against the
    plain version in float64 on the same bf16 operands within one bf16 ulp
    (`_front3d_off`; the plain version in bf16 is no reference: cuDNN
    rounds the conv to bf16, adds the bias and rounds again); outputs 0-3
    read exactly 0; one launch; the layout and dtype of cuDNN's output; a
    second launch equal bit for bit."""
    from faster_voxelpose_tpu_torch.ops import front3d_kernels as fk
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    x, w, b, p = _front3d_case(dev, *shape)
    sk.reset_launch_counts()
    got = fk.front3d(x, w, b, p)
    assert sk.launch_counts()["front3d"] == 1
    want = fk.front3d_plain(x, w, b)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    assert got.stride() == want.stride() and got.is_contiguous(
        memory_format=torch.channels_last_3d)
    exact, magnitude = _front3d_exact(x, w, b)
    assert _front3d_off(got, exact, magnitude) <= 1.0
    assert not bool(got[:, :4].any()) and bool((got[:, 4:] > 0).any())
    assert torch.equal(got, fk.front3d(x, w, b, p))


def test_front3d_wrapper_checks_and_counts(dev):
    """33 channels, a float32 weight, an unpacked weight and operands off
    the card are refused on the card and launch nothing."""
    from faster_voxelpose_tpu_torch.ops import front3d_kernels as fk
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    x, w, b, p = _front3d_case(dev, 1, 15, 4, 5, 6)
    sk.reset_launch_counts()
    x33 = torch.rand(1, 33, 4, 5, 6, device=dev)
    with pytest.raises(ValueError):
        fk.front3d(x33, torch.zeros(16, 33, 7, 7, 7, dtype=w.dtype, device=dev), b, p)
    with pytest.raises(TypeError):
        fk.front3d(x, w.float(), b.float(), p.float())
    with pytest.raises(ValueError):
        fk.front3d(x, w, b, w)
    with pytest.raises(ValueError):
        fk.front3d(x, w.cpu(), b.cpu(), p.cpu())
    assert sk.launch_counts()["front3d"] == 0
    fk.front3d(x, w, b, p)
    assert sk.launch_counts()["front3d"] == 1


def test_front3d_refold_reaches_a_captured_graph(dev):
    """A folded rank-3 ConvBNRelu captured in a CUDA graph; its weights
    and BatchNorm moved in place and refolded (into the same buffers): the
    replay answers as the block does eagerly on the new weights, and not
    as before."""
    from faster_voxelpose_tpu_torch.models import blocks

    torch.manual_seed(0)
    block = blocks.ConvBNRelu(15, 16, 7, 3, torch.bfloat16).eval().to(dev)
    with torch.no_grad():
        block.conv.weight.normal_(0.0, (2.0 / (15 * 343)) ** 0.5)
        blocks.fold_layers(block)
    x = _front3d_case(dev, 2, 15, 9, 10, 12)[0]
    out = {}
    replay = _captured(lambda: out.update(y=block(x)))
    replay()
    before = out["y"].clone()
    with torch.no_grad():
        block.conv.weight.mul_(-0.5)
        block.bn.running_mean.fill_(-0.2)
        blocks.fold_layers(block)
        want = block(x)
    replay()
    torch.cuda.synchronize()
    assert torch.equal(out["y"], want) and not torch.equal(out["y"], before)


def test_served_voxelpose_launches_front3d_twice(dev):
    """One request of a bf16 VoxelPose service on the tiny geometry, its
    'heatmaps' graph replayed: the CPN's and the PRN's fronts launch
    front3d once each and their `front_res` blocks front_res3d once each,
    beside one launch of each sampler; the eager forward launches the
    same."""
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.geometry import dome_rig
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    cfg = tiny_cfg()
    cfg.MODEL, cfg.NETWORK.COMPUTE_DTYPE = "voxelpose", "bfloat16"
    rig = dome_rig(1, 3, space_center=cfg.CAPTURE_SPEC.SPACE_CENTER,
                   ori_image_size=cfg.DATASET.ORI_IMAGE_SIZE, focal=240.0)[0]
    expect = {n: 0 for n in sk.launch_counts()}
    expect.update({"sample_whole_projected": 1, "sample_crop_cube": 1, "front3d": 2,
                   "front_res3d": 2})
    for aot in (True, False):
        svc = PoseService(cfg, rig=rig, device=dev, aot=aot)
        assert (svc._compiled.get("heatmaps") is not None) == aot
        frame = _tiny_frames(1)[0]
        svc.infer_heatmaps(frame)
        sk.reset_launch_counts()
        svc.infer_heatmaps(frame)
        assert sk.launch_counts() == expect, aot


# ---------------------------------------------------------------------------
# the head of VoxelPose's front_res block (front_res3d, csrc/front_res3d.cu)
# ---------------------------------------------------------------------------


def _front_res3d_case(dev, N, X, Y, Z, seed=0):
    """front3d's output as the block takes it: (N, X, Y, Z, 16) bf16 in [0,
    1] permuted to (N, 16, X, Y, Z); fan-in scaled bf16 weights as the
    fold keeps them (conv1 (32, 16, 3, 3, 3) channels-last-3d, the skip
    (32, 16, 1, 1, 1)), nonzero biases and the packing; conv1's outputs
    0-3 have negative weights and bias, so every one of their sums is
    negative."""
    from faster_voxelpose_tpu_torch.ops import front_res3d_kernels as rk

    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(N, X, Y, Z, 16, generator=gen).to(torch.bfloat16).to(dev).permute(0, 4, 1, 2, 3)
    w1 = torch.randn(32, 16, 3, 3, 3, generator=gen) * (2.0 / (16 * 27)) ** 0.5
    b1 = torch.randn(32, generator=gen) * 0.2
    w1[:4] = -w1[:4].abs()
    b1[:4] = -b1[:4].abs() - 0.01
    ws = torch.randn(32, 16, 1, 1, 1, generator=gen) * (2.0 / 16) ** 0.5
    bs = torch.randn(32, generator=gen) * 0.2
    w1 = w1.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d).to(dev)
    ws = ws.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d).to(dev)
    b1, bs = b1.to(torch.bfloat16).to(dev), bs.to(torch.bfloat16).to(dev)
    return x, w1, b1, ws, bs, rk.pack_weight(w1, ws)


def _front_res3d_off(got, x, w, b, pad):
    """`_front3d_off` of one output against the plain version's conv in
    float64 on the same bf16 operands (ReLU where pad is 1, conv1)."""
    F = torch.nn.functional
    xd, wd, bd = x.double().contiguous(), w.double().contiguous(), b.double()
    exact = F.conv3d(xd, wd, bd, 1, pad)
    if pad:
        exact = exact.relu_()
    return _front3d_off(got, exact, F.conv3d(xd.abs(), wd.abs(), bd.abs(), 1, pad))


@pytest.mark.parametrize("shape", [(10, 64, 64, 64), (1, 80, 80, 20), (2, 9, 13, 11),
                                   (3, 23, 9, 17), (1, 5, 3, 40)],
                         ids=["prn", "cpn", "ragged", "rows", "long_z"])
def test_front_res3d_kernel_matches_plain(dev, shape):
    """The PRN's (10 x 64^3) and the CPN's (80 x 80 x 20) shapes, ragged
    tiles and several rows of tiles a block: h and s each against the
    plain version in float64 on the same bf16 operands within one bf16
    ulp (`_front3d_off`); h's outputs 0-3 read exactly 0; one launch; the
    layout and dtype of cuDNN's outputs; a second launch equal bit for
    bit."""
    from faster_voxelpose_tpu_torch.ops import front_res3d_kernels as rk
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    x, w1, b1, ws, bs, p = _front_res3d_case(dev, *shape)
    sk.reset_launch_counts()
    h, s = rk.front_res3d(x, w1, b1, ws, bs, p)
    assert sk.launch_counts()["front_res3d"] == 1
    want = rk.front_res3d_plain(x, w1, b1, ws, bs)
    for got, ref in zip((h, s), want):
        assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape
        assert got.is_contiguous(memory_format=torch.channels_last_3d)
    assert _front_res3d_off(h, x, w1, b1, 1) <= 1.0
    assert _front_res3d_off(s, x, ws, bs, 0) <= 1.0
    assert not bool(h[:, :4].any()) and bool((h[:, 4:] > 0).any()) and bool((s < 0).any())
    again = rk.front_res3d(x, w1, b1, ws, bs, p)
    assert torch.equal(h, again[0]) and torch.equal(s, again[1])


def test_front_res3d_takes_any_strides(dev):
    """x in plain contiguous strides (not the kernel's layout) is copied
    into it first: the same answers as from channels-last-3d."""
    from faster_voxelpose_tpu_torch.ops import front_res3d_kernels as rk

    x, w1, b1, ws, bs, p = _front_res3d_case(dev, 2, 7, 10, 19)
    want = rk.front_res3d(x, w1, b1, ws, bs, p)
    assert not rk._kernel_layout(x.contiguous())
    got = rk.front_res3d(x.contiguous(), w1, b1, ws, bs, p)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_front_res3d_wrapper_checks_and_counts(dev):
    """15 channels, float32 operands, an unpacked weight and operands off
    the card are refused on the card and launch nothing."""
    from faster_voxelpose_tpu_torch.ops import front_res3d_kernels as rk
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    x, w1, b1, ws, bs, p = _front_res3d_case(dev, 1, 4, 5, 6)
    sk.reset_launch_counts()
    with pytest.raises(ValueError):
        rk.front_res3d(x[:, :15], w1, b1, ws, bs, p)
    with pytest.raises(TypeError):
        rk.front_res3d(x.float(), w1, b1, ws, bs, p)
    with pytest.raises(ValueError):
        rk.front_res3d(x, w1, b1, ws, bs, w1)
    with pytest.raises(ValueError):
        rk.front_res3d(x, w1.cpu(), b1.cpu(), ws.cpu(), bs.cpu(), p.cpu())
    assert sk.launch_counts()["front_res3d"] == 0
    rk.front_res3d(x, w1, b1, ws, bs, p)
    assert sk.launch_counts()["front_res3d"] == 1


def test_front_res3d_refold_reaches_a_captured_graph(dev):
    """A folded rank-3 ResBlock(16, 32) captured in a CUDA graph; its
    weights and BatchNorms moved in place and refolded (into the same
    buffers): the replay answers as the block does eagerly on the new
    weights, and not as before."""
    from faster_voxelpose_tpu_torch.models import blocks

    torch.manual_seed(0)
    block = blocks.ResBlock(16, 32, 3, torch.bfloat16).eval().to(dev)
    with torch.no_grad():
        for conv in (block.conv1, block.conv2, block.skip_conv):
            conv.weight.normal_(0.0, (2.0 / conv.weight[0].numel()) ** 0.5)
        blocks.fold_layers(block)
    assert "front_res3d_weight" in block._buffers
    x = _front_res3d_case(dev, 2, 9, 10, 12)[0]
    out = {}
    replay = _captured(lambda: out.update(y=block(x)))
    replay()
    before = out["y"].clone()
    with torch.no_grad():
        block.conv1.weight.mul_(-0.5)
        block.skip_conv.weight.mul_(2.0)
        block.skip_bn.running_mean.fill_(-0.2)
        blocks.fold_layers(block)
        want = block(x)
    replay()
    torch.cuda.synchronize()
    assert torch.equal(out["y"], want) and not torch.equal(out["y"], before)


# ---------------------------------------------------------------------------
# the image path: the Pose-ResNet backbone (cuDNN) and infer_images
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_layers", [18, 50])
def test_backbone_cuda_matches_cpu(dev, num_layers):
    """A seeded random backbone (deconvs of 32 filters) on two 64x96
    frames, float32 with TF32 off: the card within 1e-4 relative L2 of the
    CPU; the same weights in bf16 on the card, the control, are further."""
    from faster_voxelpose_tpu_torch.models.resnet import PoseResNet

    torch.manual_seed(num_layers)
    cpu = PoseResNet(num_layers, 5, (32, 32, 32)).eval()
    half = PoseResNet(num_layers, 5, (32, 32, 32), dtype=torch.bfloat16).eval()
    half.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        ref = cpu(x).double()
        card = PoseResNet(num_layers, 5, (32, 32, 32)).eval()
        card.load_state_dict(cpu.state_dict())
        out = card.to(dev)(x.to(dev)).cpu().double()
        ctl = half.to(dev)(x.to(dev)).cpu().double()
    assert out.shape == (2, 16, 24, 5) and bool(ref.abs().max() > 0)
    rel = float((out - ref).norm() / ref.norm())
    assert rel <= 1e-4, rel
    assert float((ctl - ref).norm() / ref.norm()) > rel


def test_infer_images_cuda_matches_cpu(dev):
    """PoseService's image path on the tiny geometry (ResNet-18 backbone,
    every slot valid), the same seeded fan-in scaled weights on the card
    and on the CPU, the backbone's heatmaps scaled to about [-1, 1]: the
    same people, fused poses within 0.5 mm; on the card rows 1 and 2
    launch once per request and no other kernel."""
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.geometry import dome_rig
    from faster_voxelpose_tpu_torch.models.resnet import images_to_heatmaps
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    cfg = tiny_cfg()
    cfg.CAPTURE_SPEC.MIN_SCORE = -1e9
    cfg.INDIVIDUAL_SPEC.SPACE_SIZE = (2100.0,) * 3  # no crop-origin ties
    cfg.RESNET.NUM_LAYERS, cfg.RESNET.NUM_DECONV_FILTERS = 18, (32, 32, 32)
    rig = dome_rig(1, 3, space_center=cfg.CAPTURE_SPEC.SPACE_CENTER,
                   ori_image_size=cfg.DATASET.ORI_IMAGE_SIZE, focal=240.0)[0]
    u8 = np.random.RandomState(3).randint(0, 256, (2, 3, 128, 160, 3)).astype(np.uint8)
    cpu = PoseService(cfg, rig=rig, device="cpu")
    torch.manual_seed(0)
    with torch.no_grad():
        for p in [*cpu.model.parameters(), *cpu.backbone.parameters()]:
            if p.ndim > 1:
                p.normal_(0.0, (2.0 / p[0].numel()) ** 0.5)
        size_out = cpu.model.hdn.center_net.size_out  # bbox sizes near 0.6
        size_out.weight.mul_(0.01)
        size_out.bias.fill_(0.6)
        hm = images_to_heatmaps(cpu.backbone, torch.as_tensor(u8), False)
        cpu.backbone.final.weight.div_(hm.abs().max())
        cpu.backbone.final.bias.div_(hm.abs().max())
    card = PoseService(cfg, rig=rig, device=dev)
    card.model.load_state_dict(cpu.model.state_dict())
    card.backbone.load_state_dict(cpu.backbone.state_dict())
    card.warmup(("images_u8",))
    sk.reset_launch_counts()
    answers = [card.infer_images(f) for f in u8]
    counts = sk.launch_counts()
    assert counts["sample_whole_projected"] == counts["sample_crop_planes"] == 2
    assert counts["weightnet_front"] == 2 and sum(counts.values()) == 6
    for f, got in zip(u8, answers):
        want = cpu.infer_images(f)
        assert got["n_people"] == want["n_people"] == 4
        d = np.abs(np.asarray(got["poses_mm"]) - np.asarray(want["poses_mm"]))
        assert float(d.max()) <= 0.5


@pytest.mark.parametrize("num_layers", [18, 50])
def test_folded_backbone_cuda_matches_unfolded(dev, num_layers):
    """The folded backbone on the card (cuDNN's fused conv + bias + ReLU
    and conv + bias + shortcut + ReLU), random BatchNorm statistics, two
    64x96 frames: in float32 with TF32 off within 1e-4 relative L2 of the
    unfolded CPU forward; in bf16 within 2e-2 of it, about as far as the
    unfolded bf16 forward on the card; and a CUDA graph of the folded
    forward replays what the eager forward gives."""
    from faster_voxelpose_tpu_torch.models.blocks import BatchNorm
    from faster_voxelpose_tpu_torch.models.resnet import PoseResNet

    torch.manual_seed(num_layers)
    cpu = PoseResNet(num_layers, 5, (32, 32, 32)).eval()
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.1)
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    x = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(0))
    xd = x.to(dev)

    def on_card(dtype, fold):
        m = PoseResNet(num_layers, 5, (32, 32, 32), dtype=dtype).eval()
        m.load_state_dict(cpu.state_dict())
        m = m.to(dev)
        return m.fold() if fold else m

    with torch.inference_mode():
        ref = cpu(x).double()
        folded = on_card(torch.float32, True)
        out = folded(xd).cpu().double()
        half = on_card(torch.bfloat16, True)
        h = half(xd)
        unfolded_h = on_card(torch.bfloat16, False)(xd).cpu().double()
    rel = float((out - ref).norm() / ref.norm())
    rel_h = float((h.cpu().double() - ref).norm() / ref.norm())
    rel_uh = float((unfolded_h - ref).norm() / ref.norm())
    assert bool(ref.abs().max() > 0) and rel <= 1e-4, rel
    assert rel_h <= 2e-2 and rel_h <= 2 * rel_uh + 1e-3, (rel_h, rel_uh)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream), torch.inference_mode():
        for _ in range(3):
            half(xd)
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode(), torch.cuda.graph(graph):
        static = half(xd)
    graph.replay()
    torch.cuda.synchronize(dev)
    assert float((static - h).abs().max()) <= 1e-3 * float(h.abs().max())


def _tiny_service(dev, aot=True, rig=None):
    """PoseService on the tiny geometry (float32, every slot valid) with
    seeded fan-in scaled weights, bbox sizes near 0.6; the same weights
    at every call."""
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.geometry import dome_rig

    cfg = tiny_cfg()
    cfg.CAPTURE_SPEC.MIN_SCORE = -1e9
    cfg.INDIVIDUAL_SPEC.SPACE_SIZE = (2100.0,) * 3  # no crop-origin ties
    if rig is None:
        rig = dome_rig(1, 3, space_center=cfg.CAPTURE_SPEC.SPACE_CENTER,
                       ori_image_size=cfg.DATASET.ORI_IMAGE_SIZE, focal=240.0)[0]
    svc = PoseService(cfg, rig=rig, device=dev, aot=False)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in svc.model.parameters():
            if p.ndim > 1:
                p.copy_(torch.randn(p.shape, generator=gen) * (2.0 / p[0].numel()) ** 0.5)
        svc.model.hdn.center_net.size_out.weight.mul_(0.01)
        svc.model.hdn.center_net.size_out.bias.fill_(0.6)
    if aot:
        svc.warmup()
    return svc


def _tiny_frames(n, seed=0):
    hm = np.random.RandomState(seed).rand(n, 3, 32, 40, 15).astype(np.float32) * 0.2
    hm[:, :, 10:18, 14:22, :] = 1.0
    return hm


def _same_answers(got, want, tol=0.01):
    """The same people, fused poses within tol mm (float32, TF32 off:
    bit for bit expected, a cuBLAS or cuDNN algorithm chosen otherwise
    under capture allowed)."""
    for a, b in zip(got, want):
        assert a["n_people"] == b["n_people"] == 4
        assert float(np.abs(np.asarray(a["poses_mm"]) - np.asarray(b["poses_mm"])).max()) <= tol


def test_service_graph_equals_eager(dev):
    """The captured heatmaps graph answers as the eager forward of the
    same weights, request by request."""
    compiled, eager = _tiny_service(dev), _tiny_service(dev, aot=False)
    assert compiled.warmup() == ["heatmaps"] and compiled._compiled["heatmaps"] is not None
    assert eager._compiled == {}
    frames = _tiny_frames(4)
    _same_answers([compiled.infer_heatmaps(f) for f in frames],
                  [eager.infer_heatmaps(f) for f in frames])
    assert compiled.stats()["compiled"] == ["heatmaps"]


def test_service_rig_swap_without_recapture(dev):
    """set_rig on a compiled service: the same graph object replays, its
    answers equal the eager service's on the new rig, and swapping back
    gives the first answers bit for bit."""
    from faster_voxelpose_tpu_torch.geometry import dome_rig

    svc, eager = _tiny_service(dev), _tiny_service(dev, aot=False)
    graph = svc._compiled["heatmaps"]
    rig1 = svc._rig.cpu().numpy()[0]
    rig2 = dome_rig(1, 3, space_center=svc.cfg.CAPTURE_SPEC.SPACE_CENTER,
                    ori_image_size=(320, 240), focal=240.0, seed=7,
                    radius_range=(3200.0, 3600.0))[0]
    frames = _tiny_frames(3, seed=1)
    first = [svc.infer_heatmaps(f) for f in frames]
    svc.set_rig(rig2)
    eager.set_rig(rig2)
    swapped = [svc.infer_heatmaps(f) for f in frames]
    _same_answers(swapped, [eager.infer_heatmaps(f) for f in frames])
    assert svc._compiled["heatmaps"] is graph and sorted(svc._compiled) == ["heatmaps"]
    assert not np.allclose(first[0]["poses_mm"], swapped[0]["poses_mm"])
    svc.set_rig(rig1)
    assert [svc.infer_heatmaps(f)["poses_mm"] for f in frames] == [a["poses_mm"] for a in first]


def test_launch_counts_under_replay(dev):
    """A replay adds the kernels the graph launched at capture: rows 1
    and 2 once per compiled request and no other kernel; the capture
    itself, which launches nothing, leaves the counts as they were."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    svc = _tiny_service(dev, aot=False)
    sk.reset_launch_counts()
    svc.warmup()
    warm = sk.launch_counts()  # the eager forwards before the capture
    assert warm["sample_whole_projected"] == warm["sample_crop_planes"] == 3
    assert svc._compiled["heatmaps"].launches == {"sample_whole_projected": 1,
                                                  "sample_crop_planes": 1, "weightnet_front": 1}
    sk.reset_launch_counts()
    for f in _tiny_frames(5):
        svc.infer_heatmaps(f)
    counts = sk.launch_counts()
    assert counts["sample_whole_projected"] == counts["sample_crop_planes"] == 5
    assert counts["weightnet_front"] == 5 and sum(counts.values()) == 15


def test_capture_with_a_host_synchronisation_raises(dev):
    """A forward that reads a value back to the host cannot be captured:
    warmup raises, records no graph and leaves no eager stand-in; the
    service and the device still answer afterwards."""
    svc = _tiny_service(dev, aot=False)
    forward = svc.model.forward

    def synced(*args, **kwargs):
        out = forward(*args, **kwargs)
        out.fused_poses.sum().item()  # a host synchronisation
        return out

    svc.model.forward = synced
    with pytest.raises(RuntimeError):
        svc.warmup(("heatmaps",))
    assert svc._compiled == {}
    del svc.model.forward
    frame = _tiny_frames(1)[0]
    _same_answers([svc.infer_heatmaps(frame)], [_tiny_service(dev).infer_heatmaps(frame)])


def test_non_batch_1_input_runs_eager(dev):
    """A batch of 2 does not fit the batch-1 graph: it runs eagerly (one
    whole-space launch for the batch, one crop launch per sample, no
    replay) and answers its first sample as the model's own forward at
    batch 2 does, bit for bit (against the graph at batch 1 it differs by
    cuDNN's batch-dependent float32 algorithms, not by the service); an
    image graph not captured runs eagerly too."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    svc = _tiny_service(dev)
    frames = _tiny_frames(2, seed=2)
    sk.reset_launch_counts()
    batch = svc.infer_heatmaps(frames)
    counts = sk.launch_counts()
    assert counts["sample_whole_projected"] == 1 and counts["sample_crop_planes"] == 2
    with torch.inference_mode():
        fused = svc.model(torch.as_tensor(frames, device=dev), svc._rig.expand(2, -1, -1))
    want = svc._decode(fused.fused_poses.cpu().numpy())
    assert batch["poses_mm"] == want["poses_mm"] and batch["n_people"] == 4
    u8 = np.random.RandomState(3).randint(0, 256, (3, 128, 160, 3)).astype(np.uint8)
    assert "images_u8" not in svc._compiled and svc.infer_images(u8)["n_people"] == 4


def test_service_refolds_a_reloaded_backbone_in_graph(dev):
    """Backbone weights loaded in place after the captured 'images_u8'
    graph's fold: the next request refolds into the buffers the graph
    reads (no recapture) and answers as a service captured with those
    weights, within the image path's 0.5 mm (a graph of a random backbone
    replays one input 0.07 mm apart, cuDNN's sums in float32); one
    `setup.fold` after set-up, two after the reload."""
    from faster_voxelpose_tpu_torch.models.resnet import images_to_heatmaps

    frames = np.random.RandomState(4).randint(0, 256, (3, 3, 128, 160, 3)).astype(np.uint8)

    def service(seed):
        """Seeded fan-in scaled backbone weights, heatmaps in about [-1, 1]."""
        svc = _tiny_service(dev, aot=False)
        with torch.random.fork_rng(devices=[]), torch.no_grad():
            torch.manual_seed(seed)
            for p in svc.backbone.parameters():
                if p.ndim > 1:
                    p.normal_(0.0, (2.0 / p[0].numel()) ** 0.5)
            scale = images_to_heatmaps(svc.backbone, torch.as_tensor(frames, device=dev),
                                       False).abs().max()
            svc.backbone.final.weight.div_(scale)
            svc.backbone.final.bias.div_(scale)
        svc.warmup(("images_u8",))
        return svc

    def folds(svc):
        return sum(s["name"] == "setup.fold" and s["label"] == "backbone"
                   for s in svc.trace_summary()["setup"])

    svc, fresh = service(0), service(1)
    graph = svc._compiled["images_u8"]
    assert svc.stats()["backbone_folded"] and folds(svc) == 1
    before = [svc.infer_images(f) for f in frames]
    assert folds(svc) == 1
    svc.backbone.load_state_dict(fresh.backbone.state_dict())
    after = [svc.infer_images(f) for f in frames]
    assert folds(svc) == 2 and svc._compiled["images_u8"] is graph
    _same_answers(after, [fresh.infer_images(f) for f in frames], tol=0.5)
    assert not np.allclose(before[0]["poses_mm"], after[0]["poses_mm"], rtol=0, atol=1.0)


def _random_fusion(cfg, seed=0):
    """The fusion model of cfg with seeded fan-in scaled weights and
    random BatchNorm affine terms and statistics, in eval mode, on the
    host; the same at every call."""
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.models.blocks import BatchNorm

    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
        for p in model.parameters():
            if p.ndim > 1:
                p.copy_(torch.randn(p.shape, generator=gen) * (2.0 / p[0].numel()) ** 0.5)
    return model


def _fusion_nets(model):
    """Each fusion net of the model with a random input of the tiny
    geometry's shapes (K = 4 proposals, 3 planes each)."""
    gen = torch.Generator().manual_seed(5)
    return {"center_net": (model.hdn.center_net, torch.rand(1, 16, 16, 8, 15, generator=gen)),
            "c2c_net": (model.hdn.c2c_net, torch.rand(4, 15, 8, generator=gen)),
            "p2p_net": (model.jln.p2p_net, torch.rand(12, 15, 16, 16, generator=gen)),
            "weight_net": (model.jln.weight_net, torch.rand(12, 15, 16, 16, generator=gen))}


def test_folded_fusion_cuda_matches_unfolded(dev):
    """The fusion nets folded on the card (cuDNN's fused conv + bias +
    ReLU and conv + bias + shortcut + ReLU, C2CNet's as 2D convs of unit
    height), random BatchNorm statistics: each net in float32 with TF32
    off within 1e-4 relative L2 of its unfolded CPU forward, and in bf16
    within 2e-2 of it and about as far as the unfolded bf16 nets on the
    card; the whole folded model replayed in a CUDA graph answers as its
    eager forward (0.01 mm) and, in float32, as the unfolded forward on
    the card (0.1 mm, the fold's reassociation through the soft-argmax)."""
    from faster_voxelpose_tpu_torch.geometry import dome_rig

    cfg = tiny_cfg()
    cfg.CAPTURE_SPEC.MIN_SCORE = -1e9
    cfg.INDIVIDUAL_SPEC.SPACE_SIZE = (2100.0,) * 3  # no crop-origin ties
    cpu = _random_fusion(cfg)

    def on_card(dtype, fold):
        c = tiny_cfg()
        c.CAPTURE_SPEC.MIN_SCORE, c.INDIVIDUAL_SPEC.SPACE_SIZE = -1e9, (2100.0,) * 3
        c.NETWORK.COMPUTE_DTYPE = dtype
        m = _random_fusion(c).to(dev)
        return m.fold() if fold else m

    models = {(dt, fold): on_card(dt, fold) for dt in ("float32", "bfloat16")
              for fold in (False, True)}
    with torch.inference_mode():
        for name, (net, x) in _fusion_nets(cpu).items():
            ref = net(x)
            got = {k: _fusion_nets(m)[name][0](x.to(dev)) for k, m in models.items()}
            for i, r in enumerate(ref if isinstance(ref, tuple) else (ref,)):
                r = r.double()

                def rel(k):
                    out = got[k][i] if isinstance(ref, tuple) else got[k]
                    assert out.dtype == torch.float32
                    return float((out.cpu().double() - r).norm() / r.norm())

                assert rel(("float32", True)) <= 1e-4, (name, i, rel(("float32", True)))
                rel_h, rel_uh = rel(("bfloat16", True)), rel(("bfloat16", False))
                assert rel_h <= 2e-2 and rel_h <= 2 * rel_uh + 1e-3, (name, i, rel_h, rel_uh)
    frames = torch.as_tensor(_tiny_frames(1), device=dev)
    rig = torch.as_tensor(dome_rig(1, 3, space_center=cfg.CAPTURE_SPEC.SPACE_CENTER,
                                   ori_image_size=(320, 240), focal=240.0), device=dev)
    for dt in ("float32", "bfloat16"):
        folded, out = models[(dt, True)], {}
        replay = _captured(lambda: out.update(static=folded(frames, rig).fused_poses))
        with torch.inference_mode():
            eager = folded(frames, rig).fused_poses
        replay()
        torch.cuda.synchronize(dev)
        static = out["static"]
        assert bool((static[..., 3] >= 0).all())
        assert float((static - eager).abs().max()) <= 0.01
        if dt == "float32":
            with torch.inference_mode():
                want = models[(dt, False)](frames, rig).fused_poses
            assert float((static - want).abs().max()) <= 0.1


def test_service_refolds_reloaded_fusion_weights_in_graph(dev):
    """Fusion weights loaded in place after the captured heatmaps graph's
    fold: the next request's check, made while the card replays, finds
    the moved version counters, refolds into the buffers the graph reads
    and replays again (no recapture); the answers are a service's captured
    with those weights (0.01 mm, float32); one `setup.fold` labelled
    "fusion" after set-up, none for a request that changes nothing, two
    after the reload."""
    def folds(svc):
        return sum(s["name"] == "setup.fold" and s["label"] == "fusion"
                   for s in svc.trace_summary()["setup"])

    svc, fresh = _tiny_service(dev), _tiny_service(dev, aot=False)
    other = _random_fusion(fresh.cfg, seed=1)
    fresh.model.load_state_dict(other.state_dict())
    fresh.warmup()
    graph = svc._compiled["heatmaps"]
    assert svc.stats()["fusion_folded"] and folds(svc) == 1
    frames = _tiny_frames(3, seed=5)
    before = [svc.infer_heatmaps(f) for f in frames]
    assert folds(svc) == 1
    svc.model.load_state_dict(other.state_dict())
    after = [svc.infer_heatmaps(f) for f in frames]
    assert folds(svc) == 2 and svc._compiled["heatmaps"] is graph
    _same_answers(after, [fresh.infer_heatmaps(f) for f in frames])
    assert not np.allclose(before[0]["poses_mm"], after[0]["poses_mm"], rtol=0, atol=1.0)


def _captured(fn):
    """fn captured in a CUDA graph after 3 eager calls on a side stream;
    the graph's replay."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.inference_mode():
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode(), torch.cuda.graph(graph):
        fn()
    return graph.replay


def _kernel_names(replay, n=3):
    """The names of the kernels that n calls of replay launch
    (torch.profiler, device events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            replay()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def test_heatmaps_graph_launches_no_batch_norm(dev):
    """The service's captured heatmaps graph, which runs the folded
    fusion, launches no BatchNorm kernel (cuDNN's `bn_fw_inf`, or
    PyTorch's own); the same model unfolded, captured alike, does, which
    shows that the profiler sees a graph's kernels."""
    from faster_voxelpose_tpu_torch.engine import graphs
    from faster_voxelpose_tpu_torch.models import build_model

    svc = _tiny_service(dev)
    g = svc._compiled["heatmaps"]
    assert svc.stats()["fusion_folded"] and g is not None
    g.input.copy_(torch.as_tensor(_tiny_frames(1), device=dev))

    def is_bn(name):
        return "bn_fw" in name or "batch_norm" in name.lower() or "batchnorm" in name.lower()

    served = _kernel_names(lambda: graphs.replay(g.captured))
    assert any("crop_kernel" in n for n in served) and any("whole_kernel" in n for n in served)
    assert not [n for n in served if is_bn(n)]
    unfolded = build_model(svc.cfg)
    unfolded.load_state_dict(svc.model.state_dict())
    unfolded = unfolded.to(dev)
    assert [n for n in _kernel_names(_captured(lambda: unfolded(g.input, svc._rig))) if is_bn(n)]


def test_heatmaps_graph_runs_weightnet_kernel(dev):
    """The service's captured heatmaps graph launches WeightNet's front as
    `weightnet_kernel` once per replay.  The folded bf16 WeightNet alone at
    Shelf's served shapes (P2PNet's (30, 17, 64, 64) channels-last float32
    feats), captured, launches it once per replay and none of the library
    chain it replaced (cuDNN's CUDA-core `implicit_convolve_sgemm`, an NCHW
    `max_pool_forward_nchw`); a refold after the capture (new BatchNorm
    statistics, `sync_fold`) reaches the replayed kernel: the graph then
    answers as the eager folded forward."""
    from faster_voxelpose_tpu_torch.engine import graphs

    svc = _tiny_service(dev)
    g = svc._compiled["heatmaps"]
    g.input.copy_(torch.as_tensor(_tiny_frames(1), device=dev))
    served = _kernel_names(lambda: graphs.replay(g.captured))
    assert sum("weightnet_kernel" in n for n in served) == 3

    cfg = tiny_cfg()
    cfg.NETWORK.COMPUTE_DTYPE = "bfloat16"
    model = _random_fusion(cfg).to(dev).fold()
    net = model.jln.weight_net
    gen = torch.Generator().manual_seed(3)
    feats = torch.rand(30, 64, 64, 17, generator=gen).to(dev).permute(0, 3, 1, 2)
    out = {}
    replay = _captured(lambda: out.update(w=net(feats)))
    names = _kernel_names(replay, 3)
    assert sum("weightnet_kernel" in n for n in names) == 3
    replaced = [n for n in names if "implicit_convolve_sgemm" in n or "max_pool" in n]
    assert not replaced, "\n".join(sorted(set(replaced)))

    replay()
    torch.cuda.synchronize(dev)
    before = out["w"].clone()
    with torch.no_grad():
        net.feat_bn.running_var.mul_(4.0)
        net.feat_bn.bias.add_(0.5)
    assert model.sync_fold()
    replay()
    with torch.inference_mode():
        want = net(feats)
    torch.cuda.synchronize(dev)
    torch.testing.assert_close(out["w"], want, rtol=0, atol=1e-6)
    assert float((before - want).abs().max()) > 1e-3


def _train_setup(dev, n_batches, B=2, seed=0):
    """The tiny geometry with synthetic training scenes (device-rendered
    'gt' heatmaps, augmentation on), float32 conv stacks: (cfg, a model
    factory giving the same seeded weights at every call, the collated
    numpy batches of one shuffled pass)."""
    from faster_voxelpose_tpu_torch.datasets import SyntheticDataset
    from faster_voxelpose_tpu_torch.datasets.demo_data import make_pose_bank, make_rig
    from faster_voxelpose_tpu_torch.engine.loader import DataLoader
    from faster_voxelpose_tpu_torch.models import build_model

    cfg = tiny_cfg()
    cfg.DATASET.DEVICE_RENDER = True
    cfg.SYNTHETIC.MAX_PEOPLE, cfg.SYNTHETIC.NUM_DATA = 3, n_batches * B
    cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.ACCUMULATION_STEPS, cfg.TRAIN.LR = B, 2, 1e-3
    rig = make_rig(3, 2600.0, 2200.0, (0.0, 0.0), cfg.DATASET.ORI_IMAGE_SIZE)
    cams = {int(k): {kk: np.array(vv) for kk, vv in v.items()} for k, v in rig.items()}
    ds = SyntheticDataset(cfg, pose_bank=make_pose_bank(40), cameras=cams)
    batches = list(DataLoader(ds, B, shuffle=True, drop_last=True, seed=seed))

    def model():
        torch.manual_seed(seed)
        m = build_model(cfg).to(dev)
        with torch.no_grad():  # fan-in scaled weights: proposals near the people
            gen = torch.Generator().manual_seed(seed)
            for p in m.parameters():
                if p.ndim > 1:
                    p.copy_(torch.randn(p.shape, generator=gen).to(dev)
                            * (2.0 / p[0].numel()) ** 0.5)
        return m

    return cfg, model, batches


def _run_trainer(tr, batches):
    """Losses (host floats) and (pose count, joint count, mini-step) after
    every step."""
    losses, gates = [], []
    for b in batches:
        out = tr.step(b)
        losses.append({k: float(v) for k, v in out.items()})
        gates.append((int(tr.opt_pose.count), int(tr.opt_joint.count), int(tr.mini_step)))
    return losses, gates


def _state_gap(a, b):
    """{kind: relative L2 gap of the two trainers' flat buffers} for the
    last step's gradients, both moments and the parameters, each kind's
    tensors of both optimizers taken together."""
    def flat(t, kind):
        if kind == "params":
            return torch.cat([p.detach().reshape(-1) for p in t.model.parameters()])
        return torch.cat([getattr(t.opt_pose, kind), getattr(t.opt_joint, kind)])

    return {kind: float((flat(b, kind) - flat(a, kind)).norm() / flat(a, kind).norm())
            for kind in ("grad", "mu", "nu", "params")}


def test_compiled_trainer_matches_eager(dev):
    """12 calls on the same batches, eager and captured (3 eager warm-up
    steps, one capture, 8 replays), each call from the same state (the
    eager trainer's, copied in place into the tensors the graph reads):
    the same gates on every call (the JLN's skip, the HDN's k-th step),
    losses within 1e-4 relative, and after each call the gradients and
    both moments within 1e-4 relative L2, the parameters within 1e-3, all
    tensors of a kind together.  cuDNN's backward is not bit for bit
    (atomics), and a gradient that is 0 in exact arithmetic (a conv bias
    before a train-mode BatchNorm) is rounding noise that Adam turns into
    a step of about LR either way: the parameters part by up to 2 LR on
    such elements (2.3e-4 relative overall, measured on an H100), so a
    single such tensor is not held.  Free-running, the two trainers part
    further: chip_smoke.py holds that run between a float32 reading and a
    bf16 control."""
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer

    cfg, model, batches = _train_setup(dev, 12)
    batches[6]["num_person"][:] = 0  # a call whose JLN step is skipped
    eager, compiled = Trainer(cfg, model(), compiled=False), Trainer(cfg, model())
    assert compiled.compiled and not eager.compiled
    gates, worst = [], {}
    for i, b in enumerate(batches):
        compiled.load_state_dict(eager.state_dict())
        le = {k: float(v) for k, v in eager.step(b).items()}
        lc = {k: float(v) for k, v in compiled.step(b).items()}
        for k in le:
            assert abs(le[k] - lc[k]) <= 1e-4 * max(abs(le[k]), 1e-6), (i, k, le[k], lc[k])
        gates.append([(int(t.opt_pose.count), int(t.opt_joint.count), int(t.mini_step))
                      for t in (eager, compiled)])
        for k, v in _state_gap(eager, compiled).items():
            worst[k] = max(worst.get(k, 0.0), v)
    assert compiled._graph.captured is not None
    assert all(e == c for e, c in gates), gates
    assert gates[6][0][1] == gates[5][0][1] and gates[-1][0][0] == 6
    limits = {"grad": 1e-4, "mu": 1e-4, "nu": 1e-4, "params": 1e-3}
    assert all(worst[k] <= v for k, v in limits.items()), worst


def test_jln_skip_and_hdn_kth_step_under_replay(dev):
    """Under replay, a call with no GT person leaves the JLN's parameters
    and Adam state bit for bit; the HDN steps on every second call only."""
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer

    cfg, model, batches = _train_setup(dev, 8)
    tr = Trainer(cfg, model())
    for b in batches[:5]:  # warm-up, capture and a first replay
        tr.step(b)
    assert tr._graph.captured is not None
    skip = dict(batches[5], num_person=np.zeros_like(batches[5]["num_person"]))
    jln = [p.detach().clone() for p in tr.model.jln.parameters()]
    state = [t.clone() for t in (tr.opt_joint.mu, tr.opt_joint.nu, tr.opt_joint.count)]
    hdn = [p.detach().clone() for p in tr.model.hdn.parameters()]
    mini = int(tr.mini_step)
    losses = tr.step(skip)
    assert float(losses["joint"]) == 0.0
    assert all(torch.equal(p, q) for p, q in zip(tr.model.jln.parameters(), jln))
    assert all(torch.equal(a, b) for a, b in zip(
        (tr.opt_joint.mu, tr.opt_joint.nu, tr.opt_joint.count), state))
    moved = any(not torch.equal(p, q) for p, q in zip(tr.model.hdn.parameters(), hdn))
    assert moved == (mini == 1) and int(tr.mini_step) == (mini + 1) % 2


def test_trainer_launch_counts_under_replay(dev):
    """Each replayed step adds the launches its capture recorded: the
    whole-space sampler once and the crop sampler once per sample."""
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    cfg, model, batches = _train_setup(dev, 9)
    tr = Trainer(cfg, model())
    sk.reset_launch_counts()
    for b in batches[:4]:
        tr.step(b)
    counts = sk.launch_counts()  # 3 eager steps and one replay
    assert counts["sample_whole_projected"] == 4 and counts["sample_crop_planes"] == 8
    assert tr._graph.captured.launches == {"sample_whole_projected": 1, "sample_crop_planes": 2}
    sk.reset_launch_counts()
    for b in batches[4:]:
        tr.step(b)
    counts = sk.launch_counts()
    assert counts["sample_whole_projected"] == 5 and counts["sample_crop_planes"] == 10
    assert sum(counts.values()) == 15


def test_compiled_eval_matches_eager_with_padded_batch(dev):
    """run_validation on 11 held-out scenes at batch 2 (3 eager warm-up
    batches, a capture, 2 replays, the last batch padded by 1): the CUDA
    graph's fused poses equal the eager validator's (0.01 mm), every
    record kept once."""
    from faster_voxelpose_tpu_torch.datasets import SyntheticDataset
    from faster_voxelpose_tpu_torch.datasets.demo_data import make_pose_bank, make_rig
    from faster_voxelpose_tpu_torch.engine.validator import run_validation
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    cfg, model, _ = _train_setup(dev, 1)
    cfg.SYNTHETIC.NUM_DATA, cfg.TEST.BATCH_SIZE = 11, 2
    cfg.CAPTURE_SPEC.MIN_SCORE = -1e9
    rig = make_rig(3, 2600.0, 2200.0, (0.0, 0.0), cfg.DATASET.ORI_IMAGE_SIZE)
    cams = {int(k): {kk: np.array(vv) for kk, vv in v.items()} for k, v in rig.items()}
    runs = {}
    for compiled in (False, True):
        ds = SyntheticDataset(cfg, is_train=False, pose_bank=make_pose_bank(40), cameras=cams)
        sk.reset_launch_counts()
        runs[compiled] = run_validation(cfg, model(), ds, device=dev, compiled=compiled)[2]
        # six batches of 2: one whole-space launch per batch and one crop
        # launch per row, padding included, replays counted
        assert sk.launch_counts()["sample_whole_projected"] == 6
        assert sk.launch_counts()["sample_crop_planes"] == 12
    assert runs[True].shape == runs[False].shape == (11, 4, 15, 5)
    np.testing.assert_array_equal(runs[True][..., 3], runs[False][..., 3])
    assert float(np.abs(runs[True] - runs[False]).max()) <= 0.01


def test_prefetch_feeds_a_replay(dev):
    """Batches made and uploaded by prefetch_to_device's thread on its
    side stream feed a compiled trainer as the same batches copied in
    series feed another: from the same state at every call, equal losses
    (1e-4 relative; bit for bit expected, atomics in cuDNN's backward
    allowed)."""
    from faster_voxelpose_tpu_torch.engine.loader import prefetch_to_device
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer, batch_to_device

    cfg, model, batches = _train_setup(dev, 8)
    series, fed = Trainer(cfg, model()), Trainer(cfg, model())
    n = 0
    for b_fed, b in zip(prefetch_to_device(iter(batches), device=dev), batches):
        fed.load_state_dict(series.state_dict())
        a = {k: float(v) for k, v in series.step(batch_to_device(b, dev)).items()}
        c = {k: float(v) for k, v in fed.step(b_fed).items()}
        for k in a:
            assert abs(a[k] - c[k]) <= 1e-4 * max(abs(a[k]), 1e-6), (n, k, a[k], c[k])
        n += 1
    assert n == 8 and fed._graph.captured is not None


def test_trainer_capture_with_a_host_synchronisation_raises(dev):
    """A step that reads a value back to the host cannot be captured: the
    step after the warm-up raises, and so does the next one (no eager
    stand-in)."""
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer

    cfg, model, batches = _train_setup(dev, 6)
    tr = Trainer(cfg, model())
    loss = tr.loss

    def synced(batch):
        out = loss(batch)
        out["total"].item()  # a host synchronisation
        return out

    tr.loss = synced
    for b in batches[:3]:
        tr.step(b)  # eager warm-up: the sync is allowed there
    for b in batches[3:5]:
        with pytest.raises(RuntimeError):
            tr.step(b)
    assert tr._graph.captured is None
    torch.cuda.synchronize()


_CAPTURE_RECOVERY = r"""
import gc, json, sys
import torch
sys.path.insert(0, sys.argv[1])
from faster_voxelpose_tpu_torch.engine import graphs

if sys.argv[2] == "unrepaired":
    graphs.abandon_capture = lambda pool, device: False
dev = torch.device("cuda")
stream = torch.cuda.Stream(dev)
x = torch.randn(1024, device=dev)
n = 2 ** 28  # 1 GiB of float32


def reserved():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def synced():
    y = x * 2
    y.sum().item()  # a host synchronisation: invalidates the capture
    return y


def python_error():
    torch.ones(4, device=dev)
    raise ValueError("not a CUDA error")


out = {"base_gib": reserved() / 2 ** 30, "raised": []}
for fn in (synced, synced, python_error, synced):
    try:
        graphs.capture(fn, stream)
    except Exception as e:
        out["raised"].append(type(e).__name__)
try:
    torch.randn(8, device=dev).sum().item()
    out["randn"] = "ok"
except RuntimeError as e:
    out["randn"] = str(e).splitlines()[0]
t = torch.empty(n, device=dev)
del t
out["after_eager_gib"] = reserved() / 2 ** 30
good = graphs.capture(lambda: torch.ones(n, device=dev) + 1, stream)
graphs.replay(good)
torch.cuda.synchronize()
out["replay_ok"] = float(good.outputs[0]) == 2.0 and float(good.outputs[-1]) == 2.0
del good
out["after_graph_gib"] = reserved() / 2 ** 30
print("CAPTURE_RECOVERY " + json.dumps(out))
"""


def _capture_recovery(mode):
    import json
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, "-c", _CAPTURE_RECOVERY, str(root), mode],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(s for s in r.stdout.splitlines() if s.startswith("CAPTURE_RECOVERY "))
    print(mode, line)
    return json.loads(line.split(" ", 1)[1])


def test_failed_capture_leaves_the_process_usable(dev):
    """In a fresh process: three captures invalidated by a host
    synchronisation and one whose fn raises a Python error each raise,
    and after them the device's generator draws, an eager 1 GiB block and
    a 1 GiB graph pool are given back by `empty_cache`, and a new capture
    replays.  The same script with `abandon_capture` disabled shows the
    fault it repairs (PyTorch 2.11: the generator left in capture mode,
    cached blocks never given back); that reading is printed, not held,
    since a later PyTorch may repair it itself."""
    fixed = _capture_recovery("repaired")
    assert len(fixed["raised"]) == 4 and fixed["raised"][2] == "ValueError", fixed
    assert fixed["randn"] == "ok", fixed
    assert fixed["replay_ok"], fixed
    slack = 0.125  # GiB: the allocator's small blocks and the context's workspace
    assert fixed["after_eager_gib"] <= fixed["base_gib"] + slack, fixed
    assert fixed["after_graph_gib"] <= fixed["base_gib"] + slack, fixed
    _capture_recovery("unrepaired")


@pytest.mark.parametrize("aug", [False, True])
@pytest.mark.parametrize("name", ["panoptic_synthetic", "shelf_synthetic_ref",
                                  "campus_synthetic_ref"])
def test_host_rendering_matches_the_device_renderer(dev, name, aug):
    """Host rendering (native/render.cpp) against ops/heatmap_render.py on
    the card, each view of two held-out scenes from the same draws:
    within 2e-5, the JAX package's tolerance for its two renderers."""
    from faster_voxelpose_tpu_torch.config import profile
    from faster_voxelpose_tpu_torch.ops.heatmap_render import render_heatmaps_device
    from faster_voxelpose_tpu_torch.tools.validate import held_out_dataset

    ds = held_out_dataset(profile(name), 2)
    ds.data_augmentation = aug
    W, H = (int(v) for v in ds.heatmap_size)
    peak = 0.0
    for rec in ds.records:
        for j2d, vis in ds._gt_joints_2d(rec):
            state = ds._rng.get_state()
            host = ds.render_heatmap(j2d, vis)
            ds._rng.set_state(state)
            params = torch.as_tensor(ds.render_heatmap_params(j2d, vis), device=dev)
            got = render_heatmaps_device(params[None], H, W)[0].cpu().numpy()
            np.testing.assert_allclose(got, host, rtol=0, atol=2e-5)
            peak = max(peak, float(host.max()))
    assert peak > 0.3


def test_make_mesh_under_gloo_is_on_the_card(dev, tmp_path):
    """A gloo group's mesh with no device named lies on the card, so that
    the DP steps keep a model and its batches there."""
    import torch.distributed as dist

    from faster_voxelpose_tpu_torch.parallel import make_mesh, shard_batch

    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "init"),
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        assert mesh.device == torch.device("cuda", 0)
        assert shard_batch({"x": np.zeros((2, 3), np.float32)}, mesh)["x"].device.type == "cuda"
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("defines", [
    ("FVP_CROP_TX=8", "FVP_CROP_TY=8", "FVP_CROP_TZ=16", "FVP_THREADS=512"),
    ("FVP_CROP_TX=2", "FVP_CROP_TY=4", "FVP_CROP_TZ=32", "FVP_THREADS=128"),
    ("FVP_WHOLE_VOXELS=64",),
    ("FVP_WHOLE_VOXELS=1024",),
])
def test_block_shape_variants_equal_the_production_build(dev, defines):
    """A variant of csrc/sampling.cu built with other block shapes (the
    sweeps' -D defines) gives the production build's planes, cube and
    whole-space cube bit for bit: each value's sum over the views runs in
    the same order whatever the block, and max is order-free; its launch
    geometry reports its own tile and threads."""
    from faster_voxelpose_tpu_torch.models.projection import whole_axes, whole_projection
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    cfg = tiny_cfg()
    geom, rig, hm, centers, bbox, valid = _case(cfg, 3)
    hm_d, cams, tl, mx, my, mz, valid_d, crop = _kernel_args(geom, rig, hm, centers, bbox,
                                                             valid, dev)
    axes = tuple(torch.as_tensor(a, device=dev) for a in whole_axes(geom))
    outs = {}
    for variant in ((), defines):
        with sk.kernel_variant(variant):
            planes = sk.sample_crop_planes(hm_d, cams, tl, mx, my, mz, valid_d, crop)
            cube = sk.sample_crop_cube(hm_d, mx, my, mz, valid_d, cams=cams, centers_tl=tl,
                                       crop=crop)
            whole = sk.sample_whole_projected(hm_d[None], cams[None], axes,
                                              whole_projection(geom))
            geo = sk.crop_launch_geometry(cfg.DATASET.CAMERA_NUM, cfg.DATASET.NUM_JOINTS,
                                          len(valid), geom.ind_voxels_per_axis,
                                          project=True, cube=False)
        outs[variant] = (planes, cube, whole, geo)
    (p0, c0, w0, g0), (p1, c1, w1, g1) = outs[()], outs[defines]
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert torch.equal(c0, c1) and torch.equal(w0, w1)
    tile = {d.split("=")[0]: int(d.split("=")[1]) for d in defines}
    want = tuple(tile.get(k, v) for k, v in (("FVP_CROP_TX", 4), ("FVP_CROP_TY", 4),
                                               ("FVP_CROP_TZ", 32)))
    assert g0["tile"] == (4, 4, 32) and g1["tile"] == want
    assert g0["threads"] == 256 and g1["threads"] == tile.get("FVP_THREADS", 256)


# ---------------------------------------------------------------------------
# VoxelPose (models/voxelpose.py): the samplers' bounded modes, its graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heatmap", _WHOLE_HEATMAPS)
@pytest.mark.parametrize("V", [3, 5])
def test_whole_bounded_matches_plain(dev, V, heatmap):
    """The whole-space sampler's bounded mode (VoxelPose's ProjectLayer)
    against its plain version, 1e-5, on rigs with a camera inside the
    volume (voxels outside some views' images); not the view mean."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    geom, hm, cams, axes, proj = _whole_case(dev, 15, V, 2, heatmap=heatmap, seed=V)
    out = sk.sample_whole_projected(hm, cams, axes, proj, bounded=True)
    ref = sk.sample_whole_projected_plain(hm.cpu(), cams.cpu(), tuple(a.cpu() for a in axes),
                                          proj, bounded=True)
    torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=0)
    assert float((out - sk.sample_whole_projected(hm, cams, axes, proj)).abs().max()) > 1e-2


@pytest.mark.parametrize("J", [15, 17])
def test_centred_cube_matches_plain(dev, J):
    """The crop sampler's bounded cube mode about float centres (one far
    outside the space, one at the camera inside it) against its plain
    version, 1e-5; a dead slot reads zeros; the launch is counted as
    sample_crop_cube."""
    from faster_voxelpose_tpu_torch.models import projection as pj
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    geom, hm, cams, axes, proj = _whole_case(dev, J, 5, 1, heatmap=(200, 152), seed=J)
    crop = sk.centred_projection(pj.crop_projection(geom), (2000.0,) * 3, (24, 20, 16))
    centres = torch.tensor([[0.0, 0.0, 800.0], [1234.5, -987.25, 400.0], [9000.0, 0.0, 0.0],
                            [0.0, 0.0, 0.0], [300.0, -200.0, 1500.0]], device=dev)
    centres[3] = cams[0, 0, 9:12]
    masks = [torch.ones((5, n), dtype=torch.uint8, device=dev) for n in (24, 20, 16)]
    valid = torch.tensor([1, 1, 1, 1, 0], dtype=torch.uint8, device=dev)
    sk.reset_launch_counts()
    out = sk.sample_crop_cube(hm[0], *masks, valid, cams=cams[0], crop=crop, centres=centres)
    assert sk.launch_counts()["sample_crop_cube"] == 1
    ref = sk.sample_crop_cube(hm[0].cpu(), *(m.cpu() for m in masks), valid.cpu(),
                              cams=cams[0].cpu(), crop=crop, centres=centres.cpu())
    torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=0)
    assert float(out[4].abs().max()) == 0.0 and float(out[0].max()) > 0.1


def _voxelpose_service(dev, aot=True):
    """PoseService serving the tiny VoxelPose (float32, 5 views) with
    seeded fan-in scaled weights."""
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.geometry import dome_rig

    cfg = tiny_cfg()
    cfg.MODEL, cfg.DATASET.CAMERA_NUM, cfg.CAPTURE_SPEC.MIN_SCORE = "voxelpose", 5, -1e9
    rig = dome_rig(1, 5, space_center=cfg.CAPTURE_SPEC.SPACE_CENTER,
                   ori_image_size=cfg.DATASET.ORI_IMAGE_SIZE, focal=240.0)[0]
    svc = PoseService(cfg, rig=rig, device=dev, aot=False)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in svc.model.parameters():
            if p.ndim > 1:
                p.copy_(torch.randn(p.shape, generator=gen) * (2.0 / p[0].numel()) ** 0.5)
    if aot:
        svc.warmup()
    return svc


def test_voxelpose_graph_equals_eager(dev):
    """The captured VoxelPose graph answers as the eager forward, request
    by request (float32), and fills `device.cpn`, `device.prn` and the
    slot counters; the graph launches the bounded modes once each."""
    compiled, eager = _voxelpose_service(dev), _voxelpose_service(dev, aot=False)
    assert compiled._compiled["heatmaps"] is not None
    assert compiled._compiled["heatmaps"].launches == {"sample_whole_projected": 1,
                                                       "sample_crop_cube": 1}
    hm = np.random.RandomState(3).rand(3, 5, 32, 40, 15).astype(np.float32) ** 4
    got = [compiled.infer_heatmaps(h) for h in hm]
    want = [eager.infer_heatmaps(h) for h in hm]
    for a, b in zip(got, want):
        assert a["n_people"] == b["n_people"] == 4
        assert float(np.abs(np.asarray(a["poses_mm"]) - np.asarray(b["poses_mm"])).max()) <= 0.01
    s = compiled.trace_summary()
    assert s["device"]["device.cpn"]["count"] >= 1 and s["device"]["device.prn"]["count"] >= 1
    assert s["device"]["device.hdn"]["count"] == 0 and s["device"]["device.jln"]["count"] == 0
    assert s["counters"] == {"jln.slots": 12, "jln.people": 12}


# ---------------------------------------------------------------------------
# MvP's projective attention (csrc/projattn.cu) and MvP's image graph
# ---------------------------------------------------------------------------

_PANOPTIC_LEVELS = [(32, 60), (64, 120), (128, 240)]  # MvP's levels at 960 x 512


def _projattn_case(dev, B, V, Q, M, Dh, P, sizes, seed=0):
    """bf16 value maps (B, V, H_l, W_l, M Dh) in [-1, 1]; reference points
    in the middle of the Panoptic space, offsets of a few pixels and
    logits (float32); dome rigs about the space and the projection of
    1920x1080 frames served at 960x512."""
    from faster_voxelpose_tpu_torch.geometry import dome_rig, get_resize_transform
    from faster_voxelpose_tpu_torch.ops.projattn_kernels import ProjAttnGeometry

    gen = torch.Generator().manual_seed(seed)
    D, L = M * Dh, len(sizes)
    values = [(torch.rand((B, V, h, w, D), generator=gen) * 2 - 1).to(torch.bfloat16).to(dev)
              for h, w in sizes]
    ref = (0.2 + 0.6 * torch.rand((B, Q, 3), generator=gen)).to(dev)
    offsets = (torch.randn((B, Q, M, L, P, 2), generator=gen) * 3.0).to(dev)
    logits = torch.randn((B, Q, M, L, P), generator=gen).to(dev)
    ori, img, centre = (1920, 1080), (960, 512), (0.0, -500.0, 800.0)
    cams = torch.as_tensor(dome_rig(B, V, space_center=centre, ori_image_size=ori, focal=1400.0),
                           dtype=torch.float32).to(dev)
    geom = ProjAttnGeometry.of((8000.0, 8000.0, 2000.0), centre, get_resize_transform(ori, img),
                               ori, img)
    return values, ref, offsets, logits, cams, geom


@pytest.mark.parametrize("case", [
    (1, 5, 150, 8, 32, 4, _PANOPTIC_LEVELS),  # MvP at Panoptic
    (2, 3, 37, 4, 16, 2, [(5, 7), (9, 13), (17, 25)]),  # half-warp heads, a batch
    (1, 1, 3, 1, 32, 1, [(1, 1)]),  # one level of one pixel: most taps outside
])
def test_projattn_kernel_matches_plain(dev, case):
    """projattn_kernel against its plain version in float64 on the same
    bf16 maps and float32 points, offsets and logits.  Tolerance: one bf16
    ulp of the value (the kernel rounds its float32 sum once) plus 2^-12
    of the maps' largest magnitude, for the float32 projection and tap
    positions (a tap's weights sum to 1 over its corners, so a position
    off by e pixels moves a sample by at most 2 e x that magnitude; e is
    about 1e-4 pixels here).  Two launches equal; one counted each."""
    from faster_voxelpose_tpu_torch.ops import projattn_kernels as pk
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    values, ref, offsets, logits, cams, geom = _projattn_case(dev, *case)
    sk.reset_launch_counts()
    out = pk.projective_attention(values, ref, offsets, logits, cams, geom)
    assert sk.launch_counts()["projattn"] == 1
    exact = pk.projective_attention_plain([v.double() for v in values], ref.double(),
                                          offsets.double(), logits.double(), cams.double(), geom)
    B, Q, M = offsets.shape[:3]
    assert out.shape == exact.shape == (B, cams.shape[1], Q, values[0].shape[-1])
    vmax = max(float(v.abs().max()) for v in values)
    a = torch.maximum(out.double().abs(), exact.abs())
    ulp = torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a.clamp_min(1e-30))) - 7), 0.0)
    off = (out.double() - exact).abs() / (ulp + 2.0 ** -12 * vmax)
    assert float(off.max()) <= 1.0, float(off.max())
    assert torch.equal(out, pk.projective_attention(values, ref, offsets, logits, cams, geom))
    assert sk.launch_counts()["projattn"] == 2


def test_projattn_wrapper_checks_and_counts(dev):
    """The wrapper raises on what the kernel does not take on the card
    (float32 maps, a mix of devices, an input that requires grad) and
    counts only the launches it makes."""
    from faster_voxelpose_tpu_torch.ops import projattn_kernels as pk
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    values, ref, offsets, logits, cams, geom = _projattn_case(dev, 1, 3, 5, 2, 32, 2,
                                                              [(4, 6)] * 3)
    sk.reset_launch_counts()
    with pytest.raises(TypeError):
        pk.projective_attention([v.float() for v in values], ref, offsets, logits, cams, geom)
    with pytest.raises(ValueError):
        pk.projective_attention(values, ref, offsets, logits, cams.cpu(), geom)
    with pytest.raises(ValueError):
        pk.projective_attention(values, ref.requires_grad_(), offsets, logits, cams, geom)
    assert sk.launch_counts()["projattn"] == 0


def _tiny_mvp_service(dev, aot):
    """The CPU tests' tiny MvP (3 views of 64x48, d 64, 2 layers) in bf16
    on the card, its weights drawn by the benchmark from one seed."""
    from benchmark.core.mvp_weights import mvp_weights
    from benchmark.core.weights import backbone_weights
    from faster_voxelpose_tpu_torch.engine import PoseService
    from test_torch_mvp import tiny_config, tiny_rig, yaml_of  # tests/ is on the path

    cfg = tiny_config("bfloat16")
    svc = PoseService(cfg, rig=tiny_rig(cfg)[0].numpy(), device=dev, aot=False)
    svc.backbone.load_state_dict(backbone_weights(15, 5, dev))
    svc.model.load_state_dict(mvp_weights(yaml_of(cfg), 5, dev))
    if aot:
        assert svc.warmup() == ["images_u8"]
    return svc


def test_mvp_graph_matches_eager_and_launches_projattn_per_layer(dev):
    """MvP's captured 'images_u8' graph against the eager forward of the
    same bf16 service on the same frames: every slot's fused poses within
    0.05 mm and its score within 1e-4 (the same kernels; bit for bit is
    expected, cuBLAS may choose another algorithm under capture); one
    replay launches projattn once per decoder layer and no other kernel of
    the port, as the eager forward does; a heatmaps request raises."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    graph, eager = _tiny_mvp_service(dev, True), _tiny_mvp_service(dev, False)
    frames = np.random.RandomState(8).randint(0, 256, (3, 3, 48, 64, 3)).astype(np.uint8)
    expect = {n: 0 for n in sk.launch_counts()}
    expect["projattn"] = len(graph.model.layers)
    for f in frames:
        for svc in (graph, eager):
            svc.infer_images(f)
            sk.reset_launch_counts()
            svc.infer_images(f)
            assert sk.launch_counts() == expect
        got, want = graph.infer_images_raw(f)[0], eager.infer_images_raw(f)[0]
        assert got.shape == (1, 4, 15, 5)
        np.testing.assert_allclose(got[..., :3], want[..., :3], rtol=0, atol=0.05)
        np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="MvP"):
        graph.infer_heatmaps(np.zeros((3, 12, 16, 15), np.float32))
