"""The port's MvP (`models/mvp.py`, `MODEL: mvp`) against its plain float32
reference (`benchmark/reference/mvp.py`) at a tiny size on the CPU: 3
views of 64x48 frames, a planted Pose-ResNet-50 (`benchmark/core/
weights.py`), a decoder of 2 layers of d 64 in 4 heads, 2 points on each of
the 3 feature levels, 4 instances of 15 joints, its weights drawn by
`benchmark/core/mvp_weights.py`; the projective attention's plain version
against the reference's `grid_sample` path; folded bf16 against unfolded
float32; the service that serves it; and the Pose-ResNet's heatmaps
against values fixed before MvP came in."""

import math

import numpy as np
import pytest
import torch

from benchmark.core.mvp_weights import mvp_weights
from benchmark.core.weights import backbone_weights
from benchmark.reference.mvp import Geometry, MvPReference


def tiny_config(dtype="float32"):
    """MvP on 3 views of 64x48 frames (128x96 originals), a 4 x 4 x 1.6 m
    space, 4 instances, d 64 in 4 heads, 2 layers, 2 points."""
    from faster_voxelpose_tpu_torch.config import Config

    cfg = Config()
    cfg.MODEL = "mvp"
    d, c, m = cfg.DATASET, cfg.CAPTURE_SPEC, cfg.MVP
    d.ORI_IMAGE_SIZE, d.IMAGE_SIZE, d.CAMERA_NUM, d.NUM_JOINTS = (128, 96), (64, 48), 3, 15
    d.COLOR_RGB = True
    c.SPACE_SIZE, c.SPACE_CENTER = (4000.0, 4000.0, 1600.0), (0.0, 0.0, 800.0)
    c.MAX_PEOPLE, c.MIN_SCORE = 4, 0.1
    m.D_MODEL, m.NUM_HEADS, m.DIM_FEEDFORWARD, m.DEC_LAYERS, m.DEC_N_POINTS = 64, 4, 128, 2, 2
    cfg.NETWORK.COMPUTE_DTYPE = dtype
    return cfg


def yaml_of(cfg):
    """The configuration's keys as the reference and the weights read them."""
    d, c, m = cfg.DATASET, cfg.CAPTURE_SPEC, cfg.MVP
    return {"DATASET": {"ORI_IMAGE_SIZE": list(d.ORI_IMAGE_SIZE), "IMAGE_SIZE": list(d.IMAGE_SIZE),
                        "COLOR_RGB": d.COLOR_RGB, "CAMERA_NUM": d.CAMERA_NUM,
                        "NUM_JOINTS": d.NUM_JOINTS},
            "CAPTURE_SPEC": {"SPACE_SIZE": list(c.SPACE_SIZE), "SPACE_CENTER": list(c.SPACE_CENTER),
                             "MAX_PEOPLE": c.MAX_PEOPLE, "MIN_SCORE": c.MIN_SCORE},
            "MVP": {"D_MODEL": m.D_MODEL, "NUM_HEADS": m.NUM_HEADS,
                    "DIM_FEEDFORWARD": m.DIM_FEEDFORWARD, "DEC_LAYERS": m.DEC_LAYERS,
                    "DEC_N_POINTS": m.DEC_N_POINTS}}


def tiny_rig(cfg):
    from faster_voxelpose_tpu_torch.geometry import dome_rig

    return torch.as_tensor(dome_rig(1, cfg.DATASET.CAMERA_NUM,
                                    space_center=cfg.CAPTURE_SPEC.SPACE_CENTER,
                                    ori_image_size=cfg.DATASET.ORI_IMAGE_SIZE, focal=96.0),
                           dtype=torch.float32)


def tiny_frames(seed):
    return torch.as_tensor(np.random.RandomState(seed).randint(0, 256, (1, 3, 48, 64, 3))
                           .astype(np.uint8))


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def tiny():
    """(cfg, backbone and MvP state dicts, the float32 port's backbone and
    MvP, the reference, the rig)."""
    from faster_voxelpose_tpu_torch.models import build_fusion_model
    from faster_voxelpose_tpu_torch.models.resnet import PoseResNet

    cfg = tiny_config()
    bw, mw = backbone_weights(15, 5, "cpu"), mvp_weights(yaml_of(cfg), 5, "cpu")
    bb = PoseResNet(50, 15).eval()
    bb.load_state_dict(bw)
    net = build_fusion_model(cfg)
    net.load_state_dict(mw)
    ref = MvPReference(Geometry.from_config(yaml_of(cfg)), bw, mw, "cpu")
    return cfg, bw, mw, bb, net, ref, tiny_rig(cfg)


def _forward(bb, net, frames, rig):
    from faster_voxelpose_tpu_torch.models.resnet import images_to_features

    with torch.no_grad():
        return net(images_to_features(bb, frames, True), rig)


def test_build_dispatches_and_published_widths():
    """MODEL mvp builds MvPNet (label "mvp"); at the published Panoptic
    widths, on the meta device, its levels are 32x60, 64x120 and 128x240
    and its six layers hold their offsets (8 heads x 3 levels x 4 points
    x 2) and a 5 x 256 -> 256 view fusion; train mode and a ViTPose
    backbone raise."""
    from faster_voxelpose_tpu_torch.config import Config
    from faster_voxelpose_tpu_torch.models import build_fusion_model, get
    from faster_voxelpose_tpu_torch.models.mvp import MvPNet, build_mvp

    m = build_fusion_model(tiny_config())
    assert isinstance(m, MvPNet) and not m.training and m.FOLD_LABEL == "mvp"
    assert get("mvp") is build_mvp
    cfg = Config()
    cfg.MODEL, cfg.DATASET.NUM_JOINTS = "mvp", 15
    with torch.device("meta"):
        big = MvPNet(cfg)
    assert big.sizes == [(32, 60), (64, 120), (128, 240)] and len(big.layers) == 6
    assert big.layers[0].sampling_offsets.weight.shape == (192, 256)
    assert big.layers[5].fuse.weight.shape == (256, 5 * 256)
    assert big.rayconv.weight.shape == (256, 259) and big.ray_pixels.shape == (201600 // 5, 2)
    with pytest.raises(NotImplementedError):
        m([torch.zeros(3, 256, 4, 4)] * 3, torch.zeros(1, 3, 21), train=True)
    cfg.BACKBONE = "vitpose"
    with pytest.raises(ValueError, match="Pose-ResNet"):
        build_fusion_model(cfg)


@pytest.mark.parametrize("seed", [0, 1])
def test_mvp_matches_the_plain_reference(tiny, seed):
    """float32 port, unfolded, against the float32 reference on uint8
    frames: every slot's joints and score to relative L2 1e-5 (the two
    differ in the sums' order: addmm against one matmul over the
    concatenation, the samples' op order)."""
    cfg, bw, mw, bb, net, ref, rig = tiny
    frames = tiny_frames(seed)
    out = _forward(bb, net, frames, rig)
    want = ref(frames[0], rig[0])
    assert out.fused_poses.shape == (1, 4, 15, 5) and out.proposal_centers.shape == (1, 4, 5)
    assert _rel(out.fused_poses[0, ..., :3], want["poses"]) < 1e-5
    assert _rel(out.fused_poses[0, :, 0, 4], want["scores"]) < 1e-5
    flag = out.fused_poses[0, :, :, 3]
    assert torch.equal(flag >= 0, want["valid"][:, None].expand(-1, 15))
    assert set(flag.unique().tolist()) <= {0.0, -1.0}


def test_projective_attention_plain_matches_the_reference(tiny):
    """`projective_attention_plain` against the reference's grid_sample
    path on the same value maps, points, offsets and logits: 1e-5
    relative; the points moved by a pixel's worth read other values."""
    from faster_voxelpose_tpu_torch.ops.projattn_kernels import projective_attention_plain

    cfg, bw, mw, bb, net, ref, rig = tiny
    gen = torch.Generator().manual_seed(3)
    Q, d, M, L, P = 60, 64, 4, 3, 2
    values = [torch.randn((3, h, w, d), generator=gen) for h, w in net.sizes]
    y = 0.3 + 0.4 * torch.rand((Q, 3), generator=gen)
    z = torch.randn((Q, d), generator=gen)
    n = "layers.0"
    offsets = ref.dense(z, f"{n}.sampling_offsets").view(1, Q, M, L, P, 2)
    logits = ref.dense(z, f"{n}.attention_weights").view(1, Q, M, L, P)
    want = ref.projective_attention(z, y, values, rig[0], n)
    got = projective_attention_plain([v[None] for v in values], y[None], offsets, logits, rig,
                                     net.geom)[0]
    assert got.shape == (3, Q, d) and _rel(got, want) < 1e-5
    moved = projective_attention_plain([v[None] for v in values], y[None] + 0.01, offsets,
                                       logits, rig, net.geom)[0]
    assert _rel(moved, want) > 1e-2


def test_folded_bf16_stays_near_unfolded_float32(tiny):
    """The served precision on the CPU: the backbone and MvP folded in
    bf16 against the unfolded float32 port on one frame set: the value
    maps, the normalised joints and the scores within relative L2 2e-2
    (the fusion nets' bound) and not equal; the fp8 control (the
    reference with fp8 operands) is further from the float32 reference
    on the joints than bf16 is."""
    from faster_voxelpose_tpu_torch.models import build_fusion_model
    from faster_voxelpose_tpu_torch.models.resnet import PoseResNet, images_to_features

    cfg, bw, mw, bb, net, ref, rig = tiny
    bf_bb = PoseResNet(50, 15, dtype=torch.bfloat16).eval()
    bf_bb.load_state_dict(bw)
    bf = build_fusion_model(tiny_config("bfloat16"))
    bf.load_state_dict(mw)
    bf_bb.fold()
    bf.fold()
    assert bf.layers[1].linear1.folded_weight.dtype == torch.bfloat16
    assert bf.layers[0].norm2.folded_weight.dtype == torch.bfloat16
    frames = tiny_frames(2)
    with torch.no_grad():
        f32_feats = images_to_features(bb, frames, True)
        bf_feats = images_to_features(bf_bb, frames, True)
        assert _rel(bf.values(bf_feats, rig, True)[2], net.values(f32_feats, rig)[2]) < 2e-2
        assert bf.rayconv_feat.is_contiguous() and bf.rayconv_ray.shape == (64, 3)
    a, b = _forward(bf_bb, bf, frames, rig), _forward(bb, net, frames, rig)
    size = torch.tensor(cfg.CAPTURE_SPEC.SPACE_SIZE)
    ya, yb = a.fused_poses[0, ..., :3] / size, b.fused_poses[0, ..., :3] / size
    bf_err = _rel(ya, yb)
    assert 0 < bf_err < 2e-2
    assert 0 < _rel(a.fused_poses[0, :, 0, 4], b.fused_poses[0, :, 0, 4]) < 2e-2
    fp8 = MvPReference(ref.geom, bw, mw, "cpu", "fp8")(frames[0], rig[0])["poses"] / size
    assert _rel(fp8, yb) > bf_err


def test_a_changed_view_moves_the_joints(tiny):
    """The answer depends on every view: one view's frame replaced moves
    the joints by millimetres and more, the other frames alone unchanged
    give the same answer."""
    cfg, bw, mw, bb, net, ref, rig = tiny
    frames = tiny_frames(4)
    base = _forward(bb, net, frames, rig).fused_poses[0, ..., :3]
    again = _forward(bb, net, frames.clone(), rig).fused_poses[0, ..., :3]
    assert torch.equal(base, again)
    for v in range(3):
        other = frames.clone()
        other[0, v] = tiny_frames(5)[0, v]
        moved = _forward(bb, net, other, rig).fused_poses[0, ..., :3]
        assert float((moved - base).norm(dim=-1).mean()) > 1.0, v


def test_service_serves_mvp(tiny):
    """The tiny MvP through `PoseService.infer_images` on the CPU, float32:
    the eager 'images_u8' forward, each answer the model's slots above the
    threshold (fused5, (1, 4, 15, 5)), its counters 4 slots and the valid
    people a request, the folds labelled "mvp" and "backbone";
    `infer_heatmaps` and a 'heatmaps' graph raise."""
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.utils import profiling

    cfg, bw, mw, bb, net, ref, rig = tiny
    svc = PoseService(cfg, rig=rig[0].numpy(), device="cpu")
    svc.backbone.load_state_dict(bw)
    svc.model.load_state_dict(mw)
    assert svc.warmup() == ["images_u8"]
    people = 0
    for seed in (6, 7):
        frames = tiny_frames(seed)
        got = svc.infer_images(frames[0].numpy())
        fused, centres = svc.infer_images_raw(frames[0].numpy())
        assert fused.shape == (1, 4, 15, 5) and centres.shape == (1, 4, 5)
        want = _forward(bb, net, frames, rig).fused_poses[0].numpy()
        np.testing.assert_allclose(fused[0], want, rtol=0, atol=1e-3)
        valid = fused[0, :, 0, 3] >= 0
        assert got["n_people"] == valid.sum()
        np.testing.assert_array_equal(np.asarray(got["poses_mm"], np.float32).reshape(-1, 15, 3),
                                      fused[0][valid][:, :, :3])
        people += got["n_people"]
    s = svc.trace_summary()
    assert s["counters"] == {"jln.slots": 8, "jln.people": people}
    assert sorted(f["label"] for f in s["setup"] if f["name"] == "setup.fold") == ["backbone",
                                                                                "mvp"]
    assert list(s["device"]) == list(profiling.DEVICE_INTERVALS)
    with pytest.raises(ValueError, match="MvP"):
        svc.infer_heatmaps(np.zeros((3, 12, 16, 15), np.float32))
    with pytest.raises(ValueError, match="MvP"):
        svc.warmup(("heatmaps",))


def test_graph_marks_read_the_mvp_intervals():
    """An MvP graph's marks (start, backbone, values, end) read start ->
    backbone as `device.backbone`, NaN for the stages it lacks, and
    backbone -> values -> end as `device.mvp_values` and
    `device.mvp_decoder`, the last two of DEVICE_INTERVALS."""
    from faster_voxelpose_tpu_torch.utils import profiling

    class Event:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, other):
            return other.t - self.t

    assert profiling.DEVICE_INTERVALS[-2:] == ("device.mvp_values", "device.mvp_decoder")
    marks = profiling.GraphMarks.__new__(profiling.GraphMarks)
    marks.upload = (Event(0.25), Event(0.75))
    marks.events = {"start": Event(1.0), "backbone": Event(4.5), "values": Event(4.75),
                    "end": Event(6.0)}
    got = marks.read()
    assert len(got) == len(profiling.DEVICE_INTERVALS)
    np.testing.assert_allclose(got, [0.5, 0.25, 3.5] + [math.nan] * 6 + [0.25, 1.25])


def test_projattn_wrapper_refuses_what_the_kernel_does_not_take(tiny):
    """The wrapper's checks (shapes, dtypes, layouts; they run anywhere):
    float32 value maps, a head wider than 32 channels, more taps than 16,
    a level count that differs from the offsets', a non-contiguous map."""
    from faster_voxelpose_tpu_torch.ops.projattn_kernels import check_inputs

    B, Q, V, M, L, P, d = 1, 6, 3, 4, 3, 2, 64
    vals = [torch.zeros((B, V, 4, 4, d), dtype=torch.bfloat16) for _ in range(L)]
    ref, cams = torch.zeros((B, Q, 3)), torch.zeros((B, V, 21))
    off, lg = torch.zeros((B, Q, M, L, P, 2)), torch.zeros((B, Q, M, L, P))
    check_inputs(vals, ref, off, lg, cams)
    with pytest.raises(TypeError, match="bfloat16"):
        check_inputs([v.float() for v in vals], ref, off, lg, cams)
    with pytest.raises(ValueError, match="heads"):
        check_inputs(vals, ref, off[:, :, :1], lg[:, :, :1], cams)  # 1 head of 64 channels
    with pytest.raises(ValueError, match="taps"):
        check_inputs(vals, ref, torch.zeros((B, Q, M, L, 6, 2)), torch.zeros((B, Q, M, L, 6)),
                     cams)
    with pytest.raises(ValueError, match="levels"):
        check_inputs(vals[:2], ref, off, lg, cams)
    with pytest.raises(ValueError, match="contiguous"):
        check_inputs([vals[0].transpose(2, 3), *vals[1:]], ref, off, lg, cams)


# The float64 sums and absolute sums of a seeded Pose-ResNet's heatmaps
# (deconvs of 32, 15 joints, two 48x64 frames, one CPU thread), computed on
# the tree before MvP came in: (layers, dtype) -> [unfolded, folded]
HEATMAP_SUMS = {
    (18, "float32"): [(2.7945975664269568e-05, 6.487320377302755e-05),
                      (2.794596789742061e-05, 6.487319124137328e-05)],
    (18, "bfloat16"): [(2.7907354905376547e-05, 6.48334436341158e-05),
                       (2.791008012639762e-05, 6.483552633282375e-05)],
    (50, "float32"): [(0.000195261346895478, 0.0010981170590283699),
                      (0.00019526130698974305, 0.001098117151979312)],
    (50, "bfloat16"): [(0.00019544305930718764, 0.0010980468811885302),
                       (0.00019504007065851425, 0.0010964169891831688)],
}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("layers,dtype", sorted(HEATMAP_SUMS))
def test_pose_resnet_heatmaps_are_unchanged(one_thread, layers, dtype):
    """The Pose-ResNet's heatmaps, unfolded and folded, bit for bit as
    before its transposed convs' outputs were handed out for MvP."""
    from faster_voxelpose_tpu_torch.models.resnet import PoseResNet

    torch.manual_seed(layers)
    m = PoseResNet(layers, 15, (32, 32, 32), dtype=getattr(torch, dtype)).eval()
    x = torch.randn(2, 48, 64, 3, generator=torch.Generator().manual_seed(1))
    got = []
    for fold in (False, True):
        if fold:
            m.fold()
        with torch.no_grad():
            h = m(x).double()
        got.append((float(h.sum()), float(h.abs().sum())))
    assert got == HEATMAP_SUMS[(layers, dtype)]
