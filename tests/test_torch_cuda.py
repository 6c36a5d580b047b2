"""PyTorch port on the card: the CUDA kernels against their plain
versions, the wrappers' checks and counters, and the model's CUDA path
against its CPU path.  Every test needs a CUDA device and skips without
one.  This file imports neither JAX nor PyYAML, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 on sampled values in [0, 1] (the kernels contract
multiply-adds into FMAs, the plain version does not).
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
    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile

    return {"tiny": tiny_cfg, "panoptic": panoptic_synthetic_profile}


@pytest.mark.parametrize("profile", ["tiny", "panoptic"])
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
    assert sk.launch_counts() == {"sample_whole": 1, "sample_crop_planes": 1}
    torch.testing.assert_close(out.proposal_centers.cpu(), ref.proposal_centers, atol=1e-3, rtol=0)
    assert float((out.fused_poses.cpu() - ref.fused_poses)[..., :3].abs().max()) <= 0.5
