"""The port's VoxelPose (`models/voxelpose.py`, `MODEL: voxelpose`) against
its plain float32 reference (`benchmark/reference/voxelpose.py`) at a tiny size
on the CPU: 5 views of 40x32x15 heatmaps rendered from scenes of the
benchmark's generator, a 16x16x8 space, 16^3 cubes, K = 4, seeded
random weights at unit scales; folded against unfolded; bf16 against the
float32 reference, with an fp8 control; the 3D NMS/top-K and
soft-argmax; the sampling kernels' bounded and float-centred modes'
plain versions against the reference's ProjectLayer; Faster VoxelPose's
forward against values fixed before VoxelPose came in; and the service
that serves it."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference.voxelpose import (Geometry, VoxelPoseReference, grid_points,
                                          project_layer)


def tiny_config(dtype="float32"):
    """The port's tiny geometry with VoxelPose: 5 views, THRESHOLD 0.3."""
    from faster_voxelpose_tpu_torch.tools.dryrun_multichip import tiny_config as tiny

    cfg = tiny()
    cfg.MODEL = "voxelpose"
    cfg.NETWORK.COMPUTE_DTYPE = dtype
    cfg.DATASET.CAMERA_NUM = 5
    cfg.CAPTURE_SPEC.MIN_SCORE = 0.3
    return cfg


def yaml_of(cfg):
    """The configuration's keys as the reference reads them."""
    d, c, i = cfg.DATASET, cfg.CAPTURE_SPEC, cfg.INDIVIDUAL_SPEC
    return {"DATASET": {"ORI_IMAGE_SIZE": list(d.ORI_IMAGE_SIZE), "IMAGE_SIZE": list(d.IMAGE_SIZE),
                        "HEATMAP_SIZE": list(d.HEATMAP_SIZE), "NUM_JOINTS": d.NUM_JOINTS},
            "CAPTURE_SPEC": {"SPACE_SIZE": list(c.SPACE_SIZE), "SPACE_CENTER": list(c.SPACE_CENTER),
                             "VOXELS_PER_AXIS": list(c.VOXELS_PER_AXIS),
                             "MAX_PEOPLE": c.MAX_PEOPLE, "MIN_SCORE": c.MIN_SCORE},
            "INDIVIDUAL_SPEC": {"SPACE_SIZE": list(i.SPACE_SIZE),
                                "VOXELS_PER_AXIS": list(i.VOXELS_PER_AXIS)},
            "NETWORK": {"BETA": cfg.NETWORK.BETA}}


def randomize(module, seed):
    """Every parameter and buffer of `module` drawn at unit scales, in
    place: conv weights normal over their fan-in (the transposed convs'
    over their input channels), BatchNorm gains 1 +- 0.1, shifts and
    biases 0.1, running variances in [0.5, 1.5]."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            r = torch.randn(t.shape, generator=gen)
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif t.ndim == 1:
                t.copy_((1.0 if name.endswith("weight") else 0.0) + 0.1 * r)  # BatchNorm gains
            else:
                fan = t.shape[0] if "deconv" in name else t[0].numel()
                t.copy_(r / math.sqrt(fan))
    return module


def scene_heatmaps(cfg, seed, people=3):
    """(heatmaps (1, V, H, W, J), cams (1, V, 21)) of one scene of the
    benchmark's generator on a ring of cameras around the space."""
    from benchmark.reference.fusion import resize_affine
    from benchmark.traffic.heatmaps import render_scene
    from benchmark.traffic.poses import make_pose_bank
    from benchmark.traffic.rig import make_rig
    from benchmark.traffic.scenes import make_scene

    d, c = cfg.DATASET, cfg.CAPTURE_SPEC
    rig = make_rig(d.CAMERA_NUM, 6000.0, 2200.0, c.SPACE_CENTER[:2], d.ORI_IMAGE_SIZE)
    rng = np.random.default_rng(seed)
    scene = make_scene(rng, make_pose_bank(100, "panoptic15"), rig, 2, c.SPACE_SIZE,
                       c.SPACE_CENTER, d.ORI_IMAGE_SIZE, people)
    hm = render_scene(scene, rig, resize_affine(d.ORI_IMAGE_SIZE, d.IMAGE_SIZE),
                      d.ORI_IMAGE_SIZE, d.IMAGE_SIZE, d.HEATMAP_SIZE, 3.0, 0.0, rng)
    return torch.as_tensor(hm)[None], torch.as_tensor(rig, dtype=torch.float32)[None]


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def tiny():
    """(cfg, the float32 port with random weights, its state dict, the
    reference, two scenes)."""
    from faster_voxelpose_tpu_torch.models import build_fusion_model as build_model

    cfg = tiny_config()
    model = randomize(build_model(cfg), 3)
    sd = model.state_dict()
    ref = VoxelPoseReference(Geometry.from_config(yaml_of(cfg)), sd, "cpu")
    return cfg, model, sd, ref, [scene_heatmaps(cfg, s) for s in (0, 1)]


def _forward(model, hm, cams):
    with torch.no_grad():
        return model(hm, cams)


def test_build_model_dispatches_on_model():
    from faster_voxelpose_tpu_torch.models import FasterVoxelPoseNet, get
    from faster_voxelpose_tpu_torch.models import build_fusion_model as build_model
    from faster_voxelpose_tpu_torch.models.faster_voxelpose import build_model as build_fvp
    from faster_voxelpose_tpu_torch.models.voxelpose import V2VNet, VoxelPoseNet

    cfg = tiny_config()
    m = build_model(cfg)
    assert isinstance(m, VoxelPoseNet) and not m.training and m.FOLD_LABEL == "voxelpose"
    assert isinstance(m.cpn, V2VNet) and m.prn.output.weight.shape == (15, 32, 1, 1, 1)
    assert m.cpn.front.front_basic.conv.weight.shape == (16, 15, 7, 7, 7)
    assert get("voxelpose")(cfg).__class__ is VoxelPoseNet
    # Faster VoxelPose's own module builds Faster VoxelPose alone
    assert isinstance(build_fvp(cfg), FasterVoxelPoseNet) and get("faster_voxelpose") is build_fvp
    cfg.MODEL = "faster_voxelpose"
    assert isinstance(build_model(cfg), FasterVoxelPoseNet)
    cfg.MODEL = "multi_person_posenet"
    with pytest.raises(ValueError, match="unknown MODEL"):
        build_model(cfg)
    with pytest.raises(NotImplementedError):
        m(torch.zeros(1, 5, 32, 40, 15), torch.zeros(1, 5, 21), train=True)


def test_published_widths():
    """VoxelPose at Panoptic's published sizes, built on the meta device:
    both V2VNets' parameters (the CPN's 15 -> 1, the PRN's 15 -> 15)."""
    from faster_voxelpose_tpu_torch.config import Config
    from faster_voxelpose_tpu_torch.models.voxelpose import VoxelPoseNet

    cfg = Config()
    cfg.MODEL, cfg.DATASET.NUM_JOINTS = "voxelpose", 15
    cfg.CAPTURE_SPEC.VOXELS_PER_AXIS = (80, 80, 20)
    with torch.device("meta"):
        m = VoxelPoseNet(cfg)
    n = {k: sum(p.numel() for p in getattr(m, k).parameters()) for k in ("cpn", "prn")}
    assert n["prn"] - n["cpn"] == 32 * 14 + 14  # the output conv's 14 more outputs
    assert m.mask_x.shape == (10, 64) and m.whole_gx.shape == (80,) and m.whole_gz.shape == (20,)


@pytest.mark.parametrize("scene", [0, 1])
def test_voxelpose_matches_the_plain_reference(tiny, scene):
    """float32 port, unfolded, against the float32 reference: the same
    proposals and their values to 1e-5, every slot's pose to relative L2
    1e-5 (the two differ in the bilinear samples' op order and in the
    soft-argmax's: per-axis marginals against the whole grid)."""
    cfg, model, sd, ref, scenes = tiny
    hm, cams = scenes[scene]
    out = _forward(model, hm, cams)
    want = ref(hm[0], cams[0])
    centres, flag, value = out.proposal_centers[0].split([3, 1, 1], dim=-1)
    assert torch.equal(centres, want["centres"])
    assert torch.equal(flag[:, 0] >= 0, want["valid"]) and want["valid"].any()
    np.testing.assert_allclose(value[:, 0], want["confidence"], rtol=1e-5)
    assert out.fused_poses.shape == (1, 4, 15, 5)
    assert _rel(out.fused_poses[0, ..., :3], want["poses"]) < 1e-5
    assert torch.equal(out.fused_poses[0, :, :, 3:], out.proposal_centers[0, :, None, 3:].expand(
        -1, 15, -1))


def test_folded_voxelpose_matches_unfolded(tiny):
    """Folded (BatchNorm in the 3D convs and transposed convs, 5-D weights
    channels-last-3d) against unfolded, float32: relative L2 under 1e-4 on
    both networks' outputs and the poses; a reload in place refolds."""
    from faster_voxelpose_tpu_torch.models import build_fusion_model as build_model

    cfg, model, sd, ref, scenes = tiny
    hm, cams = scenes[0]
    folded = build_model(cfg)
    folded.load_state_dict(sd)
    folded.fold()
    w = folded.prn.front.front_basic.conv.folded_weight
    assert w.is_contiguous(memory_format=torch.channels_last_3d) and w.shape == (16, 15, 7, 7, 7)
    cube = torch.rand(2, 15, 16, 16, 16)
    with torch.no_grad():
        for net in ("cpn", "prn"):
            assert _rel(getattr(folded, net)(cube), getattr(model, net)(cube)) < 1e-4
    a, b = _forward(folded, hm, cams), _forward(model, hm, cams)
    assert torch.equal(a.proposal_centers[..., :4], b.proposal_centers[..., :4])
    assert _rel(a.fused_poses, b.fused_poses) < 1e-4
    other = randomize(build_model(cfg), 11)
    folded.load_state_dict(other.state_dict())
    assert torch.equal(_forward(folded, hm, cams).fused_poses,
                       _forward(other.fold(), hm, cams).fused_poses)


def test_bf16_v2v_stays_near_float32(tiny):
    """The served precision on the CPU: bf16 folded V2VNets against the
    float32 reference's, on a cube of the tiny scene, relative L2 under
    2e-2 on the CPN's root cube and the PRN's joint cubes; the fp8
    control (the benchmark's reference with fp8 operands) fails it."""
    from benchmark.reference.voxelpose import Weights, v2v
    from benchmark.reference.precision import operand_rounding
    from faster_voxelpose_tpu_torch.models import build_fusion_model as build_model

    cfg, model, sd, ref, scenes = tiny
    hm, cams = scenes[0]
    bf = build_model(tiny_config("bfloat16"))
    bf.load_state_dict(sd)
    bf.fold()
    assert bf.prn.encdec.mid_res.conv1.folded_weight.dtype == torch.bfloat16
    g = ref.geom
    cube = project_layer(g, hm[0], cams[0], ref.whole_points).reshape(*g.voxels, 15)
    x = cube.permute(3, 0, 1, 2)[None].contiguous()
    fp8 = Weights(sd, "cpu", operand_rounding("fp8"))
    for net in ("cpn", "prn"):
        with torch.no_grad():
            got = getattr(bf, net)(x)
        want = v2v(ref.p, x, net)
        assert got.dtype == torch.float32
        assert 1e-4 < _rel(got, want) < 2e-2, net
        assert _rel(v2v(fp8, x, net), want) > 2e-2, net


def test_nms3d_topk_against_plain():
    """VoxelPose's NMS and top K on random cubes with planted ties: the
    reference's values, flat indices and (x, y, z) unravelling."""
    from faster_voxelpose_tpu_torch.ops.nms import nms3d_topk
    from benchmark.reference.voxelpose import nms_topk

    gen = torch.Generator().manual_seed(5)
    cubes = torch.rand((3, 9, 7, 5), generator=gen)
    cubes[1, 2, 3, 1] = cubes[1, 6, 1, 3] = 2.0  # a tie, broken to the lower index
    cubes[2] = torch.round(cubes[2] * 4) / 4  # plateaus
    values, index, flat = nms3d_topk(cubes, 6)
    assert values.shape == (3, 6) and index.shape == (3, 6, 3)
    for b in range(3):
        v, f = nms_topk(cubes[b], 6)
        assert torch.equal(values[b], v) and torch.equal(flat[b], f)
        assert torch.equal(index[b, :, 0] * 35 + index[b, :, 1] * 5 + index[b, :, 2], f)
    assert flat[1, 0] == 2 * 35 + 3 * 5 + 1 and flat[1, 1] == 6 * 35 + 1 * 5 + 3


def test_soft_argmax_3d_against_plain():
    """The per-axis marginals' expectation against the softmax times the
    whole (X*Y*Z, 3) grid, at BETA 100 on cubes with a peak: 1e-3 mm."""
    from faster_voxelpose_tpu_torch.ops.soft_argmax import soft_argmax_3d

    gen = torch.Generator().manual_seed(6)
    y = torch.rand((2, 3, 8, 6, 5), generator=gen) * 0.5
    y[0, 1, 3, 2, 1] = y[1, 2, 7, 5, 4] = 1.0
    centres = torch.tensor([[100.0, -250.0, 800.0], [-2000.0, 30.0, 10.0]])
    axes = [torch.linspace(-1000, 1000, n) for n in (8, 6, 5)]
    got = soft_argmax_3d(y, tuple(a + centres[:, None, i, None] for i, a in enumerate(axes)),
                         100.0)
    for n in range(2):
        grid = grid_points((2000.0,) * 3, centres[n].tolist(), (8, 6, 5), "cpu")
        p = torch.softmax(100.0 * y[n].reshape(3, -1), -1)
        want = torch.stack([(p * grid[:, a]).sum(-1) for a in range(3)], -1)
        assert (got[n] - want).abs().max() < 1e-3
    assert got.shape == (2, 3, 3)


def test_sampling_modes_against_the_project_layer(tiny):
    """The bounded whole-space mode and the float-centred, bounded crop
    cube mode of the sampling kernels (their plain versions, which the
    CPU runs) against the reference's ProjectLayer: 1e-5 on values in
    [0, 1]; voxels outside every view read 0, not NaN."""
    from faster_voxelpose_tpu_torch.ops.sampling_kernels import (
        sample_crop_cube, sample_whole_projected)

    cfg, model, sd, ref, scenes = tiny
    hm, cams = scenes[1]
    g = ref.geom
    axes = (model.whole_gx, model.whole_gy, model.whole_gz)
    got = sample_whole_projected(hm, cams, axes, model.whole, bounded=True)[0]
    want = project_layer(g, hm[0], cams[0], ref.whole_points).reshape(*g.voxels, 15)
    assert (got - want).abs().max() < 1e-5 and want.max() > 0.5
    plain = sample_whole_projected(hm, cams, axes, model.whole)[0]
    assert (plain - want).abs().max() > 1e-2  # the view mean over V is another function
    centres = torch.tensor([[0.0, 0.0, 800.0], [1500.0, -900.0, 400.0], [5000.0, 5000.0, 0.0],
                            [-300.5, 200.25, 1000.75]])
    cube = sample_crop_cube(hm[0], model.mask_x, model.mask_y, model.mask_z, model.all_slots,
                            cams=cams[0], crop=model.crop, centres=centres)
    for k, c in enumerate(centres):
        pts = grid_points(g.cube_size, c.tolist(), g.cube_voxels, "cpu")
        want = project_layer(g, hm[0], cams[0], pts).reshape(*g.cube_voxels, 15)
        assert (cube[k] - want).abs().max() < 1e-5
    assert torch.isfinite(cube).all()
    with pytest.raises(ValueError, match="centred mode"):
        sample_crop_cube(hm[0], model.mask_x, model.mask_y, model.mask_z, model.all_slots,
                         cams=cams[0], crop=model.crop, centres=centres,
                         centers_tl=centres.int())


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The sums of Faster VoxelPose's outputs on `_faster_case`, computed on the
# tree before VoxelPose came in (one CPU thread): [unfolded, folded] x
# [fused poses, plane poses, proposal centres]
FASTER_SUMS = {
    "float32": [[-33945.65931940079, -67980.52180480957, -2053.809759557247],
                [-33945.72845578194, -67980.66372680664, -2053.8097625374794]],
    "bfloat16": [[-33610.20659279823, -67310.93281555176, -2053.760039329529],
                 [-34515.09137010574, -69120.28150939941, -2053.779739320278]],
}


def _faster_case(dtype):
    """The tiny Faster VoxelPose, every parameter and buffer drawn at unit
    scales from one seed, every slot valid, on seeded heatmaps and the
    ring rig: the sums of its outputs, unfolded and folded."""
    from faster_voxelpose_tpu_torch.geometry import ring_rig
    from faster_voxelpose_tpu_torch.models.faster_voxelpose import build_model
    from faster_voxelpose_tpu_torch.tools.dryrun_multichip import tiny_config as tiny

    cfg = tiny()
    cfg.NETWORK.COMPUTE_DTYPE = dtype
    cfg.CAPTURE_SPEC.MIN_SCORE = -1e9
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(17)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif t.ndim == 1:
                t.copy_((1.0 if name.endswith("weight") else 0.0)
                        + 0.1 * torch.randn(t.shape, generator=gen))
            else:
                t.copy_(torch.randn(t.shape, generator=gen) / math.sqrt(t[0].numel()))
    hm = torch.rand((1, 3, 32, 40, 15), generator=gen) ** 8
    cams = torch.as_tensor(ring_rig(1, 3), dtype=torch.float32)
    outs = []
    for fold in (False, True):
        if fold:
            model.fold()
        o = _forward(model, hm, cams)
        outs.append([float(t.double().sum()) for t in
                     (o.fused_poses, o.plane_poses, o.proposal_centers)])
    return outs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_faster_voxelpose_forward_is_unchanged(one_thread, dtype):
    """Faster VoxelPose's rank-1 and rank-2 blocks, fold and samplers give
    the outputs they gave before the rank-3 blocks and the bounded modes
    came in, bit for bit (float64 sums of its float32 outputs)."""
    assert _faster_case(dtype) == FASTER_SUMS[dtype]


def test_graph_marks_read_the_voxelpose_intervals():
    """A VoxelPose graph's marks (start, cpn, end) read NaN where it has no
    stage and start -> cpn -> end as `device.cpn` and `device.prn`,
    columns 7 and 8 of DEVICE_INTERVALS (MvP's two follow them)."""
    from faster_voxelpose_tpu_torch.utils import profiling

    class Event:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, other):
            return other.t - self.t

    assert profiling.DEVICE_INTERVALS[7:9] == ("device.cpn", "device.prn")
    marks = profiling.GraphMarks.__new__(profiling.GraphMarks)
    marks.upload = (Event(0.25), Event(0.75))
    marks.events = {"start": Event(1.0), "cpn": Event(2.5), "end": Event(12.0)}
    got = marks.read()
    assert len(got) == len(profiling.DEVICE_INTERVALS)
    np.testing.assert_allclose(got, [0.5, 0.25] + [math.nan] * 5 + [1.5, 9.5] + [math.nan] * 2)


def test_service_serves_voxelpose(tiny):
    """The tiny VoxelPose through `PoseService.infer_heatmaps` on the CPU,
    float32: each answer's people are the model's valid slots, their
    poses and values; the slot counters count K slots and the valid
    people; the fold's set-up span is labelled "voxelpose"."""
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.utils import profiling

    cfg, model, sd, ref, scenes = tiny
    svc = PoseService(cfg, rig=scenes[0][1][0].numpy(), device="cpu")
    svc.model.load_state_dict(sd)
    assert svc.warmup(("heatmaps",)) == ["heatmaps"] and svc.stats()["fusion_folded"]
    people = 0
    for hm, cams in scenes[:1] * 2:
        got = svc.infer_heatmaps(hm[0].numpy())
        fused = _forward(svc.model, hm, cams).fused_poses[0].numpy()
        valid = fused[:, 0, 3] >= 0
        assert got["n_people"] == valid.sum() > 0
        np.testing.assert_allclose(got["poses_mm"], fused[valid][:, :, :3], atol=1e-3)
        np.testing.assert_allclose(got["scores"], fused[valid][:, 0, 4], atol=1e-6)
        people += got["n_people"]
    s = svc.trace_summary()
    assert s["counters"] == {"jln.slots": 2 * cfg.CAPTURE_SPEC.MAX_PEOPLE, "jln.people": people}
    assert [f["label"] for f in s["setup"] if f["name"] == "setup.fold"] == ["voxelpose"]
    assert list(s["device"]) == list(profiling.DEVICE_INTERVALS)
