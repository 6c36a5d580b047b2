"""PyTorch port, the image path: the Pose-ResNet backbone against the flax
`PoseResNet` on the same weights, the converters of upstream PyTorch
state dicts against the JAX package's, the on-device image
normalisation, and `PoseService.infer_images` and the validator's image
step against the JAX package's service and eval step (CPU).

Tolerances: the backbone 1e-4 absolute in float32 on outputs of order 1,
and 2e-2 relative L2 in bf16 (gross faults only); converted state dicts
and normalised images equal (1e-6); the image path's proposals identical
and fused poses within 0.5 mm (the JAX package's golden bound).
"""

import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_geometry import tiny_configs, tiny_rig
from tests.test_torch_modules import nest, randomize


def test_same_pads_are_flax_same():
    """`blocks.same_pads` is XLA's "SAME": (0, 1) for a 3x3 stride-2 conv
    on an even side, where torch's padding=1 pads (1, 1)."""
    from jax import lax

    from faster_voxelpose_tpu_torch.models.blocks import same_pads

    for size in range(4, 14):
        for kernel in (1, 3, 7):
            for stride in (1, 2):
                want = lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
                assert same_pads(size, kernel, stride) == tuple(want), (size, kernel, stride)
    assert same_pads(8, 3, 2) == (0, 1) and same_pads(9, 3, 2) == (1, 1)


def _flax_backbone(num_layers, dtype=jnp.float32):
    from faster_voxelpose_tpu.models.resnet import PoseResNet as FlaxPoseResNet

    return FlaxPoseResNet(num_layers=num_layers, num_joints=5, deconv_filters=(32, 32, 32),
                          dtype=dtype)


def _carried(num_layers, x, seed=0):
    """Random flax weights (fan-in scaled, random BatchNorm statistics)
    with the output conv scaled so that the float32 heatmaps are of order
    1; returns (flat weights, flax float32 output)."""
    fm = _flax_backbone(num_layers)
    flat = randomize(fm.init(jax.random.PRNGKey(0), x[:1]), seed)
    s = 1.0 / float(np.abs(np.asarray(fm.apply(nest(flat), x))).max())
    flat["params/final/kernel"] = (flat["params/final/kernel"] * s).astype(np.float32)
    flat["params/final/bias"] = (flat["params/final/bias"] * s).astype(np.float32)
    return flat, np.asarray(fm.apply(nest(flat), x))


@functools.lru_cache(maxsize=None)
def _carried_case(num_layers, side):
    """A batch of 2 at 64x96 (even sides) or 65x97 (odd) and `_carried`'s
    weights and flax output on it; made once per case for this file's
    tests."""
    H, W = (64, 96) if side == "even" else (65, 97)
    x = np.random.RandomState(3).randn(2, H, W, 3).astype(np.float32)
    return (x, *_carried(num_layers, x))


def _port_backbone(num_layers, flat, dtype=torch.float32):
    from faster_voxelpose_tpu_torch.models.resnet import PoseResNet
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    model = PoseResNet(num_layers, 5, (32, 32, 32), dtype=dtype).eval()
    model.load_state_dict(from_jax_variables(flat, model))
    return model


@pytest.mark.parametrize("num_layers,side", [(18, "even"), (18, "odd"), (50, "even"),
                                             (50, "odd")])
def test_backbone_matches_flax(num_layers, side):
    """float32, the same weights through from_jax_variables, a batch of 2
    at 64x96 (even sides) or 65x97 (odd): within 1e-4.  On even sides
    every 3x3 stride-2 conv pads (0, 1), as flax's "SAME" does; a port
    that padded (1, 1) there, as torch's padding=1 does, fails the even
    cases by far more than the tolerance, and only those."""
    x, flat, ref = _carried_case(num_layers, side)
    H, W = x.shape[1:3]
    with torch.no_grad():
        out = _port_backbone(num_layers, flat)(torch.as_tensor(x))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert out.shape == (2, -(-H // 32) * 8, -(-W // 32) * 8, 5)
    assert 0.5 <= np.abs(ref).max() <= 1.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_backbone_bf16_matches_flax():
    """bf16 compute on both sides (ResNet-50, even sides): within 2e-2
    relative L2 of flax's bf16 output, a bound for gross faults only."""
    x = np.random.RandomState(4).randn(2, 64, 96, 3).astype(np.float32)
    flat, _ = _carried(50, x)
    ref = np.asarray(_flax_backbone(50, jnp.bfloat16).apply(nest(flat), x))
    with torch.no_grad():
        out = _port_backbone(50, flat, torch.bfloat16)(torch.as_tensor(x))
    assert out.dtype == torch.float32
    rel = np.linalg.norm(out.numpy() - ref) / np.linalg.norm(ref)
    assert rel <= 2e-2, rel


@pytest.mark.parametrize("num_layers,side", [(18, "even"), (18, "odd"), (50, "even"),
                                             (50, "odd")])
def test_folded_backbone_matches_unfolded(num_layers, side):
    """BatchNorm folded into the convolutions (`PoseResNet.fold`), random
    BatchNorm statistics from `_carried`, a batch of 2 at 64x96 or 65x97:
    the folded eval forward within 1e-4 of the unfolded one in float32
    (outputs of order 1; the fold reassociates one affine map per conv),
    and the folded bf16 forward within the 2e-2 relative L2 of flax's
    bf16 output that the unfolded one is held to."""
    x, flat, _ = _carried_case(num_layers, side)
    with torch.no_grad():
        want = _port_backbone(num_layers, flat)(torch.as_tensor(x))
        folded = _port_backbone(num_layers, flat).fold()
        got = folded(torch.as_tensor(x))
    assert folded.folded and 0.5 <= float(want.abs().max()) <= 1.001
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
    ref = np.asarray(_flax_backbone(num_layers, jnp.bfloat16).apply(nest(flat), x))
    with torch.no_grad():
        half = _port_backbone(num_layers, flat, torch.bfloat16).fold()(torch.as_tensor(x))
    assert half.dtype == torch.float32
    rel = np.linalg.norm(half.numpy() - ref) / np.linalg.norm(ref)
    assert rel <= 2e-2, rel


def _random_backbone(num_layers, dtype, seed=0):
    """A seeded PoseResNet (deconvs of 32 filters) with random BatchNorm
    affine terms and statistics, in eval mode."""
    from faster_voxelpose_tpu_torch.models.blocks import BatchNorm
    from faster_voxelpose_tpu_torch.models.resnet import PoseResNet

    torch.manual_seed(seed)
    model = PoseResNet(num_layers, 5, (32, 32, 32), dtype=dtype).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.1)
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    return model


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """Records each aten op's name and its tensor outputs' dtypes while
    `on`."""

    def __init__(self):
        super().__init__()
        self.ops, self.on = [], True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.on:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            self.ops.append((func.overloadpacket.__name__,
                             [o.dtype for o in outs if isinstance(o, torch.Tensor)]))
        return out


@pytest.mark.parametrize("num_layers", [18, 50])
def test_folded_forward_ops(num_layers):
    """The folded bf16 forward's aten ops before `final`: convolutions,
    ReLUs, pads, the max pool and the residual adds, all in bf16, with no
    batch-norm op and one dtype cast (the images'); unfolded, the same
    forward runs a batch norm and float32 activations.  `fold()` keeps the
    state dict's keys; the folded module's weights are channels-last; one
    convolution per BatchNorm, each folded into it."""
    from faster_voxelpose_tpu_torch.models.blocks import BatchNorm

    model = _random_backbone(num_layers, torch.bfloat16)
    x = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(1))

    def ops_before_final():
        rec = _Ops()
        hook = model.final.register_forward_pre_hook(lambda *_: setattr(rec, "on", False))
        try:
            with torch.no_grad(), rec:
                model(x)
        finally:
            hook.remove()
        return rec.ops

    keys = list(model.state_dict())
    unfolded = ops_before_final()
    assert any("batch_norm" in name for name, _ in unfolded)
    assert any(torch.float32 in dtypes for _, dtypes in unfolded)
    model.fold()
    assert list(model.state_dict()) == keys
    assert model.layer1_0.conv2.folded_weight.is_contiguous(memory_format=torch.channels_last)
    ops = ops_before_final()
    names = [name for name, _ in ops]
    assert not any("batch_norm" in name or "native_batch_norm" in name for name in names)
    # the images' permuted view and their one cast, then bf16 throughout
    assert ops[:2] == [("permute", [torch.float32]), ("_to_copy", [torch.bfloat16])], ops[:2]
    assert {d for _, dtypes in ops[1:] for d in dtypes if d.is_floating_point} == {torch.bfloat16}
    assert names.count("_to_copy") == 1
    assert names.count("convolution") == sum(isinstance(m, BatchNorm) for m in model.modules())
    assert set(names) <= {"permute", "_to_copy", "convolution", "relu_", "add_",
                          "constant_pad_nd", "max_pool2d_with_indices"}, set(names)


def test_folded_backbone_trains_unfolded():
    """In train mode a folded module runs the unfolded forward: its output
    and its state are bit for bit an unfolded twin's; back in eval mode it
    refolds from what training changed."""
    model = _random_backbone(18, torch.float32).fold()
    twin = _random_backbone(18, torch.float32)
    x = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(2))
    model.train()
    twin.train()
    assert torch.equal(model(x), twin(x))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  twin.state_dict().values()))
    with torch.no_grad():
        twin.layer2_0.bn1.running_var.mul_(2.0)
        model.layer2_0.bn1.running_var.mul_(2.0)
    model.eval()
    twin.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(x).numpy(), twin(x).numpy(), rtol=0, atol=1e-5)
    assert not model.sync_fold()  # the forward refolded


def _upstream_backbone(num_layers, rng, joints=5, filters=32):
    """A state dict named as the upstream Pose-ResNet's (the keys the JAX
    package's utils/weights_torch.py reads, plus BatchNorm's
    num_batches_tracked), random values of its shapes."""
    bottleneck = num_layers >= 50
    layout = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3)}[num_layers]
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = rng.randn(o, i, k, k) * np.sqrt(2.0 / (i * k * k))

    def bn(name, c):
        sd.update({f"{name}.weight": rng.uniform(0.5, 1.5, c), f"{name}.bias": rng.randn(c) * 0.1,
                   f"{name}.running_mean": rng.randn(c) * 0.1,
                   f"{name}.running_var": rng.uniform(0.5, 1.5, c),
                   f"{name}.num_batches_tracked": np.array(7)})

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, (planes, n) in enumerate(zip((64, 128, 256, 512), layout)):
        for b in range(n):
            t = f"layer{s + 1}.{b}"
            cout = planes * (4 if bottleneck else 1)
            if bottleneck:
                for c, (o, i, k) in enumerate([(planes, cin, 1), (planes, planes, 3),
                                               (cout, planes, 1)], 1):
                    conv(f"{t}.conv{c}", o, i, k)
                    bn(f"{t}.bn{c}", o)
            else:
                for c, (o, i) in enumerate([(planes, cin), (planes, planes)], 1):
                    conv(f"{t}.conv{c}", o, i, 3)
                    bn(f"{t}.bn{c}", o)
            if b == 0 and (s > 0 or cin != cout):
                conv(f"{t}.downsample.0", cout, cin, 1)
                bn(f"{t}.downsample.1", cout)
            cin = cout
    for i in range(3):
        sd[f"deconv_layers.{3 * i}.weight"] = rng.randn(cin, filters, 4, 4) * 0.05
        bn(f"deconv_layers.{3 * i + 1}", filters)
        cin = filters
    conv("final_layer", joints, filters, 1)
    sd["final_layer.bias"] = rng.randn(joints)
    return {k: np.asarray(v, np.float32 if np.ndim(v) else np.int64) for k, v in sd.items()}


@pytest.mark.parametrize("num_layers", [18, 50])
def test_convert_backbone_matches_jax(num_layers):
    """The port's convert_backbone equals the JAX package's converter
    followed by from_jax_variables, key for key and bit for bit, fills
    the port's PoseResNet, and to_jax_variables gives the JAX converter's
    flax variables back."""
    from faster_voxelpose_tpu.utils.weights_torch import convert_backbone as jax_convert
    from faster_voxelpose_tpu_torch.models.resnet import PoseResNet
    from faster_voxelpose_tpu_torch.weights import (
        convert_backbone, flatten_variables, from_jax_variables, to_jax_variables)

    sd = _upstream_backbone(num_layers, np.random.RandomState(num_layers))
    model = PoseResNet(num_layers, 5, (32, 32, 32))
    ours = convert_backbone(sd, num_layers, model=model)
    ref = from_jax_variables(jax_convert(sd, num_layers), model)
    assert sorted(ours) == sorted(ref) == sorted(model.state_dict())
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    model.load_state_dict(ours)
    # and back to the flax layout the JAX converter writes (the deconvs'
    # kernels flipped again)
    flat = flatten_variables(jax_convert(sd, num_layers))
    back = to_jax_variables(ours)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    # torch tensors convert as numpy arrays do
    again = convert_backbone({k: torch.as_tensor(v) for k, v in sd.items()}, num_layers)
    assert all(torch.equal(again[k], ours[k]) for k in ours)


# the port's module path -> the reference FasterVoxelPoseNet's, in order
_UPSTREAM = [
    (r"^hdn\.center_net\.", "pose_net.center_net."), (r"^hdn\.c2c_net\.", "pose_net.c2c_net."),
    (r"^jln\.p2p_net\.", "joint_net.conv_net."), (r"^jln\.weight_net\.", "joint_net.weight_net."),
    (r"front\.front_basic\.conv\.", "front_layers.0.block.0."),
    (r"front\.front_basic\.bn\.", "front_layers.0.block.1."),
    (r"front\.front_res\.", "front_layers.1."), (r"encdec\.", "encoder_decoder."),
    (r"(decoder_upsample\d)\.deconv\.", r"\1.block.0."), (r"(decoder_upsample\d)\.bn\.", r"\1.block.1."),
    (r"\.conv1\.", ".res_branch.0."), (r"\.bn1\.", ".res_branch.1."),
    (r"\.conv2\.", ".res_branch.3."), (r"\.bn2\.", ".res_branch.4."),
    (r"\.skip_conv\.", ".skip_con.0."), (r"\.skip_bn\.", ".skip_con.1."),
    (r"center_net\.hm_conv\.", "center_net.output_hm.0."),
    (r"center_net\.hm_out\.", "center_net.output_hm.2."),
    (r"center_net\.size_conv\.", "center_net.output_size.0."),
    (r"center_net\.size_out\.", "center_net.output_size.2."),
    (r"c2c_net\.output\.", "c2c_net.output_hm."), (r"conv_net\.output\.", "conv_net.output_layer."),
    (r"feat_conv\.", "heatmap_feature_net.0."), (r"feat_bn\.", "heatmap_feature_net.1."),
    (r"fc1\.", "output.0."), (r"fc2\.", "output.2."),
]


def _upstream_name(key):
    for pattern, repl in _UPSTREAM:
        key = re.sub(pattern, repl, key)
    return key


def test_convert_model_matches_jax():
    """The port's convert_model equals the JAX package's converter
    followed by from_jax_variables, on a state dict named as the
    reference FasterVoxelPoseNet's (random values of the tiny model's
    shapes)."""
    from faster_voxelpose_tpu.utils.weights_torch import convert_model as jax_convert
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.weights import convert_model, from_jax_variables

    _, pcfg = tiny_configs()
    model = build_model(pcfg)
    rng = np.random.RandomState(0)
    sd = {_upstream_name(k): rng.randn(*v.shape).astype(np.float32)
          for k, v in model.state_dict().items()}
    assert "pose_net.center_net.front_layers.1.skip_con.0.weight" in sd
    assert "joint_net.weight_net.output.2.bias" in sd
    ours = convert_model(sd, model=model)
    ref = from_jax_variables(jax_convert(sd), model)
    assert sorted(ours) == sorted(ref) == sorted(model.state_dict())
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k


@pytest.mark.parametrize("num_layers", [18, 50])
def test_upstream_names_invert_the_converters(num_layers):
    """upstream_model and upstream_backbone give the port's state dicts
    the upstream names (the model's as this module's own table names
    them, the backbone's as the upstream Pose-ResNet's, num_batches_tracked
    aside), bit for bit, and convert_* takes them back."""
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.models.resnet import PoseResNet
    from faster_voxelpose_tpu_torch.weights import (
        convert_backbone, convert_model, upstream_backbone, upstream_model)

    sd = _upstream_backbone(num_layers, np.random.RandomState(num_layers))
    port = convert_backbone(sd, num_layers, model=PoseResNet(num_layers, 5, (32, 32, 32)))
    back = upstream_backbone(port, num_layers)
    assert sorted(back) == sorted(k for k in sd if not k.endswith("num_batches_tracked"))
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    _, pcfg = tiny_configs()
    model = build_model(pcfg)
    theirs = upstream_model(model.state_dict())
    assert sorted(theirs) == sorted(_upstream_name(k) for k in model.state_dict())
    again = convert_model(theirs, model=model)
    assert all(torch.equal(again[k], v) for k, v in model.state_dict().items())


def test_converters_reject_misfits(tmp_path):
    from faster_voxelpose_tpu_torch.models.resnet import PoseResNet
    from faster_voxelpose_tpu_torch.weights import convert_backbone, load_torch_state_dict

    sd = _upstream_backbone(18, np.random.RandomState(1))
    wrong = PoseResNet(18, 6, (32, 32, 32))  # 6 joints, the dict holds 5
    with pytest.raises(ValueError, match="shape"):
        convert_backbone(sd, 18, model=wrong)
    with pytest.raises(KeyError):
        convert_backbone({k: v for k, v in sd.items() if k != "layer1.0.bn2.running_var"}, 18)
    # a training checkpoint as the reference saves it, DataParallel prefix
    torch.save({"epoch": 3, "state_dict": {f"module.{k}": torch.as_tensor(v)
                                           for k, v in sd.items()}}, tmp_path / "ckpt.pth")
    loaded = load_torch_state_dict(str(tmp_path / "ckpt.pth"))
    assert sorted(loaded) == sorted(sd)
    np.testing.assert_array_equal(loaded["final_layer.weight"].numpy(), sd["final_layer.weight"])


def test_service_takes_an_upstream_backbone():
    """An upstream Pose-ResNet state dict enters PoseService through
    `backbone_variables` as the README says,
    to_jax_variables(convert_backbone(sd)): the service's backbone holds
    the converted weights bit for bit, stats() reports them as given and
    the default warm-up includes the uint8 image graph."""
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.weights import convert_backbone, to_jax_variables

    _, pcfg = tiny_configs(RESNET__NUM_LAYERS=18, RESNET__NUM_DECONV_FILTERS=(32, 32, 32))
    sd = _upstream_backbone(18, np.random.RandomState(2), joints=pcfg.DATASET.NUM_JOINTS)
    want = convert_backbone(sd, 18)
    svc = PoseService(pcfg, backbone_variables=to_jax_variables(want),
                      rig=tiny_rig(pcfg.DATASET.CAMERA_NUM), device="cpu")
    got = svc.backbone.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not svc.stats()["backbone_random_init"]
    assert svc.warmup() == ["heatmaps", "images_u8"]


@pytest.mark.parametrize("color_rgb", [False, True])
def test_normalize_images_matches_jax(color_rgb):
    from faster_voxelpose_tpu.datasets import images as ref
    from faster_voxelpose_tpu_torch.datasets import images as ours

    u8 = np.random.RandomState(2).randint(0, 256, (2, 3, 8, 12, 3)).astype(np.uint8)
    want = np.asarray(ref.normalize_images_device(jnp.asarray(u8), color_rgb))
    got = ours.normalize_images_device(torch.as_tensor(u8), color_rgb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    host = ours.normalize_image(u8[0, 0])
    np.testing.assert_array_equal(host, ref.normalize_image(u8[0, 0]))
    np.testing.assert_array_equal(ours.denormalize_images(host), ref.denormalize_images(host))
    np.testing.assert_array_equal(ours.IMAGENET_MEAN, ref.IMAGENET_MEAN)
    np.testing.assert_array_equal(ours.IMAGENET_STD, ref.IMAGENET_STD)


@pytest.fixture(scope="module")
def image_pair():
    """The tiny geometry with a ResNet-18 backbone (deconvs of 32
    filters), 160x128 frames -> 40x32 heatmaps; random model and backbone
    weights in flax, every proposal slot valid; two uint8 frames of
    3 views, and the JAX service's answers to both, uint8 and float32."""
    from faster_voxelpose_tpu.datasets.images import normalize_images_device
    from faster_voxelpose_tpu.engine.service import PoseService as JaxService
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu.models.resnet import build_backbone as jax_backbone

    jcfg, pcfg = tiny_configs(
        CAPTURE_SPEC__MIN_SCORE=-1e9, INDIVIDUAL_SPEC__SPACE_SIZE=(2100.0,) * 3,
        RESNET__NUM_LAYERS=18, RESNET__NUM_DECONV_FILTERS=(32, 32, 32))
    V, J = jcfg.DATASET.CAMERA_NUM, jcfg.DATASET.NUM_JOINTS
    W, H = jcfg.DATASET.HEATMAP_SIZE
    iw, ih = jcfg.DATASET.IMAGE_SIZE
    rig = tiny_rig(V)
    model, backbone = jax_build(jcfg), jax_backbone(jcfg)
    flat = randomize(model.init(jax.random.PRNGKey(0), np.zeros((1, V, H, W, J), np.float32),
                                rig[None], train=False), seed=5)
    flat["params/hdn/center_net/size_out/kernel"] *= 0.01
    flat["params/hdn/center_net/size_out/bias"] = np.array([0.6, 0.7], np.float32)
    rng = np.random.RandomState(8)
    u8 = rng.randint(0, 256, (2, V, ih, iw, 3)).astype(np.uint8)
    bflat = randomize(backbone.init(jax.random.PRNGKey(1), np.zeros((1, ih, iw, 3), np.float32)),
                      seed=9)
    # heatmaps in about [-1, 1]: the output conv scaled to the raw output
    raw = backbone.apply(nest(bflat), normalize_images_device(jnp.asarray(u8[0]), False))
    for leaf in ("kernel", "bias"):
        bflat[f"params/final/{leaf}"] /= np.float32(np.abs(np.asarray(raw)).max())
    svc = JaxService(jcfg, variables=nest(flat), backbone_vars=nest(bflat), rig=rig, aot=False)
    f32 = np.asarray(normalize_images_device(jnp.asarray(u8), False))
    ref_u8 = [svc.infer_images(u8[b]) for b in range(2)]
    ref_f32 = [svc.infer_images(f32[b]) for b in range(2)]
    return jcfg, pcfg, flat, bflat, rig, u8, f32, ref_u8, ref_f32


def _same_answer(ours, ref):
    assert ours["n_people"] == ref["n_people"] == len(ref["poses_mm"])
    np.testing.assert_allclose(ours["scores"], ref["scores"], atol=1e-3)
    assert np.max(np.abs(np.asarray(ours["poses_mm"]) - np.asarray(ref["poses_mm"]))) <= 0.5


def test_infer_images_matches_jax_service(image_pair):
    """uint8 frames (normalised on the device) and float32 frames
    (normalised already) against the JAX PoseService: every slot's
    proposal score to 1e-3 and fused pose within 0.5 mm; the statistics
    and warm-up of the image graphs."""
    from faster_voxelpose_tpu_torch.engine import PoseService

    jcfg, pcfg, flat, bflat, rig, u8, f32, ref_u8, ref_f32 = image_pair
    svc = PoseService(pcfg, variables=flat, backbone_variables=bflat, rig=rig, device="cpu")
    assert svc.warmup() == ["heatmaps", "images_u8"]  # backbone weights given
    assert svc.warmup(("images",)) == ["heatmaps", "images", "images_u8"]
    for b in range(2):
        _same_answer(svc.infer_images(u8[b]), ref_u8[b])
        _same_answer(svc.infer_images(torch.as_tensor(f32[b].copy())[None]), ref_f32[b])
        assert ref_u8[b]["n_people"] == pcfg.CAPTURE_SPEC.MAX_PEOPLE
    stats = svc.stats()
    assert stats["requests"] == 4 and not stats["random_init"]
    assert not stats["backbone_random_init"]
    with pytest.raises(ValueError, match="images of shape"):
        svc.infer_images(u8[0, :, :64])
    with pytest.raises(ValueError, match="unknown graphs"):
        svc.warmup(("frames",))
    # no backbone weights: a seeded random backbone, heatmaps warmed only
    dry = PoseService(pcfg, variables=flat, rig=rig, device="cpu")
    assert dry.warmup() == ["heatmaps"] and dry.stats()["backbone_random_init"]
    same = PoseService(pcfg, variables=flat, rig=rig, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(dry.backbone.state_dict().values(),
                                                  same.backbone.state_dict().values()))


def test_eval_step_images_matches_jax(image_pair):
    """The validator's image step (uint8 frames, batch 2) against the JAX
    package's make_eval_step with a backbone: identical proposals (every
    slot valid), fused poses within 0.5 mm, the validity and score fields
    to 1e-3; the image step equals the heatmap step on the backbone's
    heatmaps."""
    from faster_voxelpose_tpu.engine.validator import make_eval_step as jax_eval_step
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu.models.resnet import build_backbone as jax_backbone
    from faster_voxelpose_tpu_torch.engine import make_eval_step
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone, images_to_heatmaps
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    jcfg, pcfg, flat, bflat, rig, u8, f32, ref_u8, ref_f32 = image_pair
    cams = np.stack([rig] * 2)
    jstep = jax_eval_step(jcfg, jax_build(jcfg), jax_backbone(jcfg))
    ref = np.asarray(jstep(nest(flat), nest(bflat), u8, cams))
    model, backbone = build_model(pcfg), build_backbone(pcfg)
    model.load_state_dict(from_jax_variables(flat, model))
    backbone.load_state_dict(from_jax_variables(bflat, backbone))
    step = make_eval_step(pcfg, model, backbone)
    got = step(torch.as_tensor(u8), torch.as_tensor(cams)).numpy()
    assert got.shape == ref.shape == (2, 4, 15, 5) and (ref[..., 3] >= 0).all()
    assert np.max(np.abs(got[..., :3] - ref[..., :3])) <= 0.5
    np.testing.assert_allclose(got[..., 3:], ref[..., 3:], atol=1e-3)
    with torch.no_grad():
        hm = images_to_heatmaps(backbone, torch.as_tensor(u8), pcfg.DATASET.COLOR_RGB)
    assert hm.shape == (2, 3, 32, 40, 15)
    by_heatmaps = make_eval_step(pcfg, model)({"input_heatmaps": hm,
                                               "cameras": torch.as_tensor(cams)})
    assert torch.equal(by_heatmaps, torch.as_tensor(got))


def _folds(svc):
    return sum(s["name"] == "setup.fold" and s["label"] == "backbone"
               for s in svc.trace_summary()["setup"])


def test_service_refolds_a_reloaded_backbone(image_pair):
    """A service whose backbone weights are loaded in place after the fold
    answers as a service built with those weights, bit for bit (and as
    the JAX service within its bounds): the request's check finds the
    moved version counters and refolds.  One `setup.fold` after set-up,
    none for a request that changes nothing, two after the reload."""
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    jcfg, pcfg, flat, bflat, rig, u8, f32, ref_u8, ref_f32 = image_pair
    svc = PoseService(pcfg, variables=flat, rig=rig, device="cpu")  # a random backbone
    assert not svc.stats()["backbone_folded"] and _folds(svc) == 0
    svc.warmup(("images_u8",))
    assert svc.stats()["backbone_folded"] and _folds(svc) == 1
    before = svc.infer_images(u8[0])
    assert _folds(svc) == 1
    svc.backbone.load_state_dict(from_jax_variables(bflat, svc.backbone))
    got = [svc.infer_images(u8[b]) for b in range(2)]
    assert _folds(svc) == 2
    fresh = PoseService(pcfg, variables=flat, backbone_variables=bflat, rig=rig, device="cpu")
    for b in range(2):
        want = fresh.infer_images(u8[b])
        assert got[b]["poses_mm"] == want["poses_mm"] and got[b]["scores"] == want["scores"]
        _same_answer(got[b], ref_u8[b])
    assert before["poses_mm"] != got[0]["poses_mm"]
    assert _folds(fresh) == 1 and fresh.stats()["backbone_folded"]
