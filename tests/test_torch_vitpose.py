"""The port's ViTPose backbone (`models/vitpose.py`) against its plain
float32 reference (`tests/plain_vitpose.py`) at a tiny size on the CPU:
width 160, 2 heads of 80, 2 blocks, 64x48 frames, 17 joints, seeded
random weights at unit scales; folded against unfolded; the tiny config
served through `PoseService.infer_images` against the reference's
heatmaps fed into the port's fusion; the benchmark's copy of the
reference; `build_backbone`'s dispatch and the VIT config; the device
intervals a ViTPose's served graph adds."""

import math

import numpy as np
import pytest
import torch

from tests.plain_vitpose import ViTPoseReference

OLD_INTERVALS = ("device.upload", "device.launch_gap", "device.backbone", "device.hdn",
                 "device.jln")


def tiny_config(dtype="float32"):
    """The port's tiny geometry with a tiny ViTPose: 3 views of 64x48
    frames (4 x 3 tokens), heatmaps 16x12x17, every proposal slot valid."""
    from faster_voxelpose_tpu_torch.tools.dryrun_multichip import tiny_config as tiny

    cfg = tiny()
    cfg.BACKBONE = "vitpose"
    cfg.NETWORK.COMPUTE_DTYPE = dtype
    cfg.DATASET.IMAGE_SIZE, cfg.DATASET.HEATMAP_SIZE = (64, 48), (16, 12)
    cfg.DATASET.NUM_JOINTS = 17
    cfg.DATASET.__post_init__()
    cfg.CAPTURE_SPEC.MIN_SCORE = -1e9
    cfg.VIT.EMBED_DIM, cfg.VIT.NUM_HEADS, cfg.VIT.DEPTH = 160, 2, 2
    return cfg


def randomize(module, seed):
    """Every parameter and buffer of `module` drawn at unit scales, in
    place: weights normal over their fan-in, norms' gains 1 +- 0.1,
    biases, shifts and the position embedding 0.1, running variances in
    [0.5, 1.5]; the output conv at 1, so heatmaps are about 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            r = torch.randn(t.shape, generator=gen)
            if name.endswith("running_var"):
                t.copy_(1.0 + torch.rand(t.shape, generator=gen) - 0.5)
            elif t.ndim == 1 and name.endswith("weight"):
                t.copy_(1.0 + 0.1 * r)
            elif t.ndim == 1 or name == "pos_embed":
                t.copy_(0.1 * r)
            else:
                fan = t[0].numel() if not name.startswith("deconv") else t.shape[0] * 4
                t.copy_(r / math.sqrt(fan))
    return module


@pytest.fixture(scope="module")
def tiny():
    """(cfg, the port's ViTPose with random weights, 2 x 3 uint8 frames)."""
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone

    cfg = tiny_config()
    backbone = randomize(build_backbone(cfg), 3)
    frames = np.random.RandomState(4).randint(0, 256, (2, 3, 48, 64, 3)).astype(np.uint8)
    return cfg, backbone, frames


def _heatmaps(backbone, frames, color_rgb=False):
    from faster_voxelpose_tpu_torch.models.resnet import images_to_heatmaps

    with torch.no_grad():
        return images_to_heatmaps(backbone, torch.as_tensor(frames), color_rgb)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_build_backbone_dispatches_on_backbone():
    from faster_voxelpose_tpu_torch.config import Config
    from faster_voxelpose_tpu_torch.models.resnet import PoseResNet, build_backbone
    from faster_voxelpose_tpu_torch.models.vitpose import ViTPose

    cfg = tiny_config()
    vit = build_backbone(cfg)
    assert isinstance(vit, ViTPose) and not vit.training
    assert len(vit.blocks) == 2 and vit.grid == (3, 4) and vit.pos_embed.shape == (1, 13, 160)
    assert isinstance(build_backbone(Config()), PoseResNet)
    cfg.BACKBONE = "hrnet"
    with pytest.raises(ValueError, match="unknown BACKBONE"):
        build_backbone(cfg)


def test_vitpose_h_is_drawn_where_asked():
    """The published ViTPose-H at Shelf's 800x608 frames, built on the meta
    device: 639.4 M parameters, 633.1 M of them in the trunk with its
    1,901-row position embedding, none drawn on the host; its keys are
    the upstream backbone's."""
    from faster_voxelpose_tpu_torch.config import Config
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone

    cfg = Config()
    cfg.BACKBONE, cfg.DATASET.IMAGE_SIZE, cfg.DATASET.NUM_JOINTS = "vitpose", (800, 608), 17
    vit = build_backbone(cfg, torch.device("meta"))
    params = dict(vit.named_parameters())
    assert all(p.is_meta for p in params.values())
    assert vit.grid == (38, 50) and params["pos_embed"].shape == (1, 1901, 1280)
    assert params["blocks.31.attn.qkv.weight"].shape == (3840, 1280)
    assert params["blocks.31.mlp.fc1.weight"].shape == (5120, 1280)
    assert params["deconv1.weight"].shape == (1280, 256, 4, 4)
    n = sum(p.numel() for p in params.values())
    trunk = sum(p.numel() for k, p in params.items() if not k.startswith(("deconv", "final")))
    assert n == 639_395_089 and trunk == 633_098_240


@pytest.mark.parametrize("color_rgb", [False, True])
def test_vitpose_matches_the_plain_reference(tiny, color_rgb):
    """float32 port against the float32 reference: relative L2 under 1e-5
    (the two differ only in the order of their sums: the fused attention's
    math path against explicit products, channels-last convolutions)."""
    cfg, backbone, frames = tiny
    ref = ViTPoseReference(backbone.state_dict(), color_rgb, heads=2)
    got = _heatmaps(backbone, frames[0][None], color_rgb)[0]
    want = ref(torch.as_tensor(frames[0]))
    assert got.shape == want.shape == (3, 12, 16, 17) and got.dtype == torch.float32
    assert want.abs().mean() > 0.1  # heatmaps at unit scale, not drowned by the head's init
    assert _rel(got, want) < 1e-5


def test_folded_vitpose_matches_unfolded(tiny):
    """The folded module (weights prepared once, the head's BatchNorms
    folded into its transposed convs) against the unfolded one, both
    float32: relative L2 under 1e-6 (one product in place of BatchNorm's
    multiply and add); a reload in place refolds before the next forward,
    and the result equals a fresh fold of the new weights bit for bit."""
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone

    cfg, backbone, frames = tiny
    unfolded = _heatmaps(backbone, frames)
    folded = randomize(build_backbone(cfg), 3).fold()
    assert folded.folded and folded.patch_embed.proj.folded_weight.dtype == torch.float32
    assert _rel(_heatmaps(folded, frames), unfolded) < 1e-6
    other = randomize(build_backbone(cfg), 11)
    folded.load_state_dict(other.state_dict())
    again = _heatmaps(folded, frames)
    assert torch.equal(again, _heatmaps(other.fold(), frames))
    assert not folded.sync_fold()  # nothing moved since


def test_bf16_vitpose_stays_near_float32(tiny):
    """The served precision on the CPU: bf16 folded weights and
    activations against the float32 reference, relative L2 under 3e-2
    (bf16 keeps 8 bits: a few of its 2^-9 roundings a layer, over 2
    blocks and the head); and the bf16 module casts its weights once."""
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone

    cfg, backbone, frames = tiny
    bf = build_backbone(tiny_config("bfloat16"))
    bf.load_state_dict(backbone.state_dict())
    bf.fold()
    assert bf.blocks[0].mlp.fc1.folded_weight.dtype == torch.bfloat16
    assert bf.folded_pos.dtype == torch.bfloat16 and bf.folded_pos.shape == (1, 12, 160)
    got = _heatmaps(bf, frames[:1])[0]
    want = ViTPoseReference(backbone.state_dict(), False, heads=2)(torch.as_tensor(frames[0]))
    assert got.dtype == torch.float32 and 1e-4 < _rel(got, want) < 3e-2


def test_benchmark_reference_is_the_plain_reference(tiny):
    """The benchmark's copy at float32 gives the repo's reference's
    heatmaps bit for bit; its fp8 control does not."""
    from benchmark.reference.vitpose import ViTPoseReference as BenchReference

    cfg, backbone, frames = tiny
    sd, x = backbone.state_dict(), torch.as_tensor(frames[1])
    want = ViTPoseReference(sd, True, heads=2)(x)
    assert torch.equal(BenchReference(sd, True, 2)(x), want)
    assert _rel(BenchReference(sd, True, 2, precision="fp8")(x), want) > 1e-2


def test_service_serves_the_vitpose(tiny):
    """The tiny config through `PoseService.infer_images` on the CPU (uint8
    frames normalised on the device, the folded backbone, the fusion)
    against the reference's heatmaps fed into the port's fusion: every
    slot's score to 1e-4 and pose within 0.1 mm, float32 on both sides."""
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.geometry import ring_rig

    cfg, backbone, frames = tiny
    rig = ring_rig(1, 3)[0]
    svc = PoseService(cfg, rig=rig, device="cpu")
    svc.backbone.load_state_dict(backbone.state_dict())
    assert svc.warmup(("images_u8",)) == ["images_u8"] and svc.stats()["backbone_folded"]
    ref = ViTPoseReference(backbone.state_dict(), cfg.DATASET.COLOR_RGB, heads=2)
    cams = torch.as_tensor(rig)[None]
    for b in range(2):
        got = svc.infer_images(frames[b])
        with torch.no_grad():
            hm = ref(torch.as_tensor(frames[b]))[None]
            fused = svc.model(hm, cams).fused_poses[0].numpy()
        valid = fused[:, 0, 3] >= 0
        assert got["n_people"] == valid.sum() == cfg.CAPTURE_SPEC.MAX_PEOPLE
        np.testing.assert_allclose(got["scores"], fused[valid][:, 0, 4], atol=1e-4)
        np.testing.assert_allclose(got["poses_mm"], fused[valid][:, :, :3], atol=0.1)
    folds = [s for s in svc.trace_summary()["setup"] if s["name"] == "setup.fold"]
    assert [s["label"] for s in folds] == ["fusion", "vitpose"]  # the model's, the backbone's


def test_flax_backbone_variables_with_a_vitpose_raise():
    from faster_voxelpose_tpu_torch.engine import PoseService

    with pytest.raises(ValueError, match="vitpose backbone takes a state dict"):
        PoseService(tiny_config(), backbone_variables={"params/conv1/kernel": np.zeros(1)},
                    device="cpu")


def test_vit_config_round_trips(tmp_path):
    """The VIT section loads from YAML and is written back where BACKBONE is
    'vitpose'; a Pose-ResNet's file has none, in the JAX package's schema."""
    from faster_voxelpose_tpu_torch.config import Config, VitConfig, load_config, save_config

    cfg = tiny_config()
    cfg.VIT.NUM_DECONV_FILTERS = (64, 32)
    save_config(cfg, tmp_path / "vit.yaml")
    back = load_config(tmp_path / "vit.yaml")
    assert back.VIT == cfg.VIT and back.BACKBONE == "vitpose"
    assert back.VIT.NUM_DECONV_FILTERS == (64, 32) and back.DATASET == cfg.DATASET
    save_config(Config(), tmp_path / "resnet.yaml")
    assert "VIT" not in (tmp_path / "resnet.yaml").read_text()
    assert load_config(tmp_path / "resnet.yaml").VIT == VitConfig()
    v = VitConfig()
    assert (v.PATCH_SIZE, v.EMBED_DIM, v.DEPTH, v.NUM_HEADS, v.MLP_RATIO,
            v.NUM_DECONV_FILTERS) == (16, 1280, 32, 16, 4, (256, 256))


class _Event:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


@pytest.mark.parametrize("vit", [True, False])
def test_vit_intervals_come_after_the_five(vit):
    """DEVICE_INTERVALS keeps its first five in their places, then
    `device.vit_blocks` and `device.vit_head`; a ViT graph's marks read
    them (patch -> blocks -> backbone), a graph without them reads five
    and its row keeps NaN there."""
    from faster_voxelpose_tpu_torch.utils import profiling

    assert profiling.DEVICE_INTERVALS[:5] == OLD_INTERVALS
    assert profiling.DEVICE_INTERVALS[5:7] == ("device.vit_blocks", "device.vit_head")
    times = {"start": 1.0, "vit_patch": 1.5, "vit_blocks": 30.5, "backbone": 32.0, "hdn": 33.0,
             "end": 35.0}
    marks = profiling.GraphMarks.__new__(profiling.GraphMarks)
    marks.upload = (_Event(0.25), _Event(0.75))
    marks.events = {n: _Event(t) for n, t in times.items() if vit or not n.startswith("vit")}
    want = [0.5, 0.25, 31.0, 1.0, 2.0] + ([29.0, 1.5] if vit else [])
    np.testing.assert_allclose(marks.read(), want)
    log = profiling.SpanLog(capacity=4, setup_capacity=4)
    req = profiling.RequestSpans(log)
    for _ in range(4):
        req.next()
    req.close(owner=1, counters=(10, 1))
    req.device(marks.read())
    row = log.requests()["device_ms"][0]
    np.testing.assert_allclose(row, want + [math.nan] * (len(profiling.DEVICE_INTERVALS)
                                                         - len(want)))
