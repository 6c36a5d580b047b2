"""The fusion nets served folded (`FoldedModule.fold`,
`blocks.fold_layers`): CenterNet, C2CNet, P2PNet and WeightNet with each
BatchNorm folded into the convolution before it and every weight
prepared once in the compute dtype, against the unfolded forward and
the flax modules; the folded forward's aten ops; train mode, which
never runs folded; and `PoseService`, which folds its model and refolds
it after a reload.  Then the one fold of every served module (the
fusion model, the Pose-ResNet and the ViTPose): what it folds, stamps
and logs, and its refold after an in-place write; and the import graph
of `models/`.  CPU, tiny shapes.

Tolerances: float32 folded within 1e-4 of the unfolded forward, relative
to the output's largest value (the fold reassociates one affine map per
conv); bf16 folded within the 2e-2 relative L2 of flax's bf16 output
that `tests/test_torch_backbone.py` holds the folded ResNet to.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faster_voxelpose_tpu_torch.utils import profiling
from tests.test_torch_cuda import _random_fusion, _tiny_frames, tiny_cfg
from tests.test_torch_modules import nest, randomize

NETS = ["center_net", "c2c_net", "p2p_net", "weight_net"]


def _net_case(name):
    """(flax module of a dtype, port module of a dtype, input shape, the
    permutation of the flax input to the port's layout, of the port's
    output to flax's)."""
    from faster_voxelpose_tpu.models import cnns as jc
    from faster_voxelpose_tpu_torch.models import cnns as pc

    return {
        "center_net": (lambda d: jc.CenterNet(dtype=d), lambda d: pc.CenterNet(15, dtype=d),
                       (2, 16, 16, 8, 15), None, (0, 2, 3, 1)),
        "c2c_net": (lambda d: jc.C2CNet(dtype=d), lambda d: pc.C2CNet(15, dtype=d),
                    (6, 8, 15), (0, 2, 1), None),
        "p2p_net": (lambda d: jc.P2PNet(15, dtype=d), lambda d: pc.P2PNet(15, 15, dtype=d),
                    (3, 16, 16, 15), (0, 3, 1, 2), (0, 2, 3, 1)),
        "weight_net": (lambda d: jc.WeightNet(32, 64, dtype=d),
                       lambda d: pc.WeightNet(32, 64, dtype=d), (3, 16, 16, 15), (0, 3, 1, 2),
                       None),
    }[name]


def _outputs(out, perm):
    """A net's outputs as a tuple of float64 arrays in flax's layout."""
    return tuple(o.numpy().astype(np.float64).transpose(perm) if perm else
                 o.numpy().astype(np.float64) for o in (out if isinstance(out, tuple) else (out,)))


@pytest.mark.parametrize("name", NETS)
def test_folded_net_matches_unfolded(name):
    """Each fusion net with flax's random weights and BatchNorm statistics
    (`randomize`), folded (`blocks.fold_layers`): in float32 within 1e-4
    of its unfolded forward, relative to the largest output; in bf16
    within 2e-2 relative L2 of flax's bf16 forward of the same weights,
    as the unfolded bf16 forward is (0.8-1.6% for both here)."""
    from faster_voxelpose_tpu_torch.models.blocks import fold_layers
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    flax_ctor, port_ctor, shape, to_port, to_flax = _net_case(name)
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    flat = randomize(flax_ctor(jnp.float32).init(jax.random.PRNGKey(0), jnp.asarray(x)), 0)
    ref = flax_ctor(jnp.bfloat16).apply(nest(flat), jnp.asarray(x))
    ref = tuple(np.asarray(r, np.float64) for r in (ref if isinstance(ref, tuple) else (ref,)))
    xt = torch.as_tensor(x if to_port is None else x.transpose(to_port).copy())
    for dtype in (torch.float32, torch.bfloat16):
        net = port_ctor(dtype)
        net.load_state_dict(from_jax_variables(flat, net))
        net.eval()
        with torch.no_grad():
            want = net(xt)
            fold_layers(net)
            got = net(xt)
        assert all(o.dtype == torch.float32 for o in (got if isinstance(got, tuple) else (got,)))
        got, want = _outputs(got, to_flax), _outputs(want, to_flax)
        for g, w, r in zip(got, want, ref):
            if dtype == torch.float32:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
            else:
                rel = np.linalg.norm(g - r) / np.linalg.norm(r)
                assert rel <= 2e-2 and np.linalg.norm(w - r) / np.linalg.norm(r) <= 2e-2, rel


def _model(dtype="float32", seed=0):
    cfg = tiny_cfg()
    cfg.NETWORK.COMPUTE_DTYPE = dtype
    cfg.CAPTURE_SPEC.MIN_SCORE = -1e9
    cfg.INDIVIDUAL_SPEC.SPACE_SIZE = (2100.0,) * 3  # no crop-origin ties
    return cfg, _random_fusion(cfg, seed)


def _rig(cfg):
    from faster_voxelpose_tpu_torch.geometry import dome_rig

    return torch.as_tensor(dome_rig(1, 3, space_center=cfg.CAPTURE_SPEC.SPACE_CENTER,
                                    ori_image_size=(320, 240), focal=240.0))


def test_folded_model_matches_unfolded():
    """The whole FasterVoxelPoseNet in float32, folded: the same
    proposals, and poses and scores within 1e-4 of the unfolded model's,
    relative to their largest value; `state_dict()` keeps its keys and the
    fold reads 6 tensors per (conv, BatchNorm) pair and 2 per other layer."""
    cfg, unfolded = _model()
    _, folded = _model()
    keys = list(folded.state_dict())
    folded.fold()
    assert list(folded.state_dict()) == keys and folded.folded
    assert len(folded._fold_tensors) == 67 * 6 + 8 * 2
    hm, cams = torch.as_tensor(_tiny_frames(2)), _rig(cfg).expand(2, -1, -1)
    with torch.no_grad():
        want, got = unfolded(hm, cams), folded(hm, cams)
    assert torch.equal(got.proposal_centers[..., :4], want.proposal_centers[..., :4])
    for field in ("fused_poses", "proposal_centers"):
        g, w = getattr(got, field), getattr(want, field)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-4 * float(w.abs().max()))


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """Records each aten op: its name, its floating outputs' dtypes,
    whether it ran inside a `float32_out` layer (`in_head`, set by hooks),
    and whether an input is one of the `raw` tensors (by data pointer)."""

    def __init__(self, raw):
        super().__init__()
        self.ops, self.raw, self.in_head = [], raw, False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [a for a in torch.utils._pytree.tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in torch.utils._pytree.tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        self.ops.append((func.overloadpacket.__name__,
                         {o.dtype for o in outs if o.is_floating_point()}, self.in_head,
                         any(t.data_ptr() in self.raw for t in ins)))
        return out


def _record(model, net, x):
    """The aten ops of net(x) (`_Ops`), its float32_out layers marked."""
    raw = {t.data_ptr() for t in model.parameters()}
    raw |= {t.data_ptr() for n, t in model.named_buffers() if n.endswith(("running_mean",
                                                                          "running_var"))}
    rec = _Ops(raw)
    hooks = []
    for m in net.modules():
        if getattr(m, "out_dtype", None) == torch.float32:
            hooks.append(m.register_forward_pre_hook(lambda *_: setattr(rec, "in_head", True)))
            hooks.append(m.register_forward_hook(lambda *_: setattr(rec, "in_head", False)))
    try:
        with torch.no_grad(), rec:
            net(x)
    finally:
        for h in hooks:
            h.remove()
    return rec.ops


# the folded forward's aten ops on the CPU: convolutions, in-place relu_
# and add_ (cuDNN's fused epilogues on the card), the U-Net's pools and
# skip adds, the input cast and one float32 cast per float32_out layer;
# unfolded, the same nets issue 230, 221, 214 and 27 ops
FOLDED_OPS = {"center_net": 64, "c2c_net": 63, "p2p_net": 56, "weight_net": 14}


@pytest.mark.parametrize("name", NETS)
def test_folded_forward_ops(name):
    """The folded bf16 forward of each net issues FOLDED_OPS[name] aten
    ops (197 for the four, against 692 unfolded): no batch-norm op, no
    op that reads a parameter or a running statistic (so no parameter
    cast), one input cast, and only bf16 activations from that cast to
    the last `float32_out` layer, outside those layers; unfolded, the
    same forward runs batch norms, casts parameters and promotes
    activations to float32."""
    cfg, model = _model("bfloat16")
    gen = torch.Generator().manual_seed(5)
    net, x = {"center_net": (model.hdn.center_net, (1, 16, 16, 8, 15)),
              "c2c_net": (model.hdn.c2c_net, (4, 15, 8)),
              "p2p_net": (model.jln.p2p_net, (12, 15, 16, 16)),
              "weight_net": (model.jln.weight_net, (12, 15, 16, 16))}[name]
    x = torch.rand(*x, generator=gen)
    unfolded = _record(model, net, x)
    assert any("batch_norm" in op for op, *_ in unfolded) and any(r for *_, r in unfolded)
    assert any(torch.float32 in d for _, d, head, _ in unfolded[3:] if not head)
    model.fold()
    ops = _record(model, net, x)
    names = [op for op, *_ in ops]
    assert len(ops) == FOLDED_OPS[name], names
    assert not any("batch_norm" in op for op in names)
    assert not [op for op, *_, r in ops if r]
    first = next(i for i, (op, d, *_) in enumerate(ops) if op == "_to_copy")
    assert ops[first][1] == {torch.bfloat16}
    last = max(i for i, (*_, head, _) in enumerate(ops) if head)
    body = [d for _, d, head, _ in ops[first + 1:last] if not head]
    assert set().union(*body) == {torch.bfloat16}
    heads = sum(getattr(m, "out_dtype", None) == torch.float32 for m in net.modules())
    assert names.count("_to_copy") == 1 + heads


def _fold_spans(log, label="fusion"):
    return sum(s["name"] == "setup.fold" and s["label"] == label for s in log.setup_spans())


@pytest.fixture
def log(monkeypatch):
    """A fresh span log in place of the process's."""
    fresh = profiling.SpanLog(capacity=64, setup_capacity=16)
    fresh.enabled = True
    monkeypatch.setattr(profiling, "SPANS", fresh)
    return fresh


def test_folded_model_trains_unfolded(log):
    """Train mode (`train=True`, or the module's `training`) runs the
    unfolded forward on a folded model: its outputs and its state after
    the running-statistics update are bit for bit an unfolded twin's.  The
    next eval forward refolds from the updated statistics (a second
    `setup.fold`) and answers as the twin folded afresh, bit for bit."""
    cfg, model = _model("bfloat16")
    _, twin = _model("bfloat16")
    model.fold()
    assert _fold_spans(log) == 1
    hm, cams = torch.as_tensor(_tiny_frames(2, seed=3)), _rig(cfg).expand(2, -1, -1)
    got, want = model(hm, cams, train=True), twin(hm, cams, train=True)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  twin.state_dict().values()))
    assert _fold_spans(log) == 1  # train mode neither checks nor refolds
    model.train()
    assert torch.equal(model(hm, cams).fused_poses, twin.train()(hm, cams).fused_poses)
    model.eval()
    twin.eval()
    with torch.no_grad():
        served = model(hm, cams)
        assert _fold_spans(log) == 2 and not model.sync_fold()
        again = twin.fold()(hm, cams)
    assert all(torch.equal(a, b) for a, b in zip(served[:3], again[:3]))


def test_service_refolds_reloaded_fusion_weights(log):
    """A bf16 service folds its model at its heatmaps graph's warm-up
    (`setup.fold` labelled "fusion", `stats()["fusion_folded"]`); fusion
    weights loaded in place after that are refolded before the next
    request, which answers bit for bit as a service built with those
    weights.  No refold for a request that changes nothing."""
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.weights import to_jax_variables

    cfg, other = _model("bfloat16", seed=1)
    rig = _rig(cfg)[0].numpy()
    svc = PoseService(cfg, rig=rig, device="cpu")
    assert not svc.stats()["fusion_folded"] and _fold_spans(log) == 0
    svc.warmup(("heatmaps",))
    assert svc.stats()["fusion_folded"] and _fold_spans(log) == 1
    frames = _tiny_frames(3, seed=4)
    before = svc.infer_heatmaps(frames[0])
    assert _fold_spans(log) == 1
    svc.model.load_state_dict(other.state_dict())
    got = [svc.infer_heatmaps(f) for f in frames]
    assert _fold_spans(log) == 2
    fresh = PoseService(cfg, variables=to_jax_variables(other.state_dict()), rig=rig,
                        device="cpu")
    for g, f in zip(got, frames):
        want = fresh.infer_heatmaps(f)
        assert g["poses_mm"] == want["poses_mm"] and g["scores"] == want["scores"]
    assert fresh.stats()["fusion_folded"] and _fold_spans(log) == 3
    assert before["poses_mm"] != got[0]["poses_mm"]


def _served_case(kind):
    """(a served module of `kind` with seeded random weights in float32, a
    twin of the same weights, its input, its eval forward's output to
    compare, the BatchNorm to write, the fold's span label)."""
    from tests.test_torch_backbone import _random_backbone
    from tests.test_torch_vitpose import randomize, tiny_config
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone

    gen = torch.Generator().manual_seed(2)
    if kind == "fusion":
        cfg, model = _model()
        hm, cams = torch.as_tensor(_tiny_frames(2)), _rig(cfg).expand(2, -1, -1)
        return (model, _model()[1], lambda m: m(hm, cams).proposal_centers,
                "hdn.center_net.front.front_basic.bn", "fusion")
    if kind == "resnet":
        x = torch.randn(2, 64, 96, 3, generator=gen)
        return (_random_backbone(18, torch.float32), _random_backbone(18, torch.float32),
                lambda m: m(x), "deconv_bn3", "backbone")
    x = torch.randn(2, 48, 64, 3, generator=gen)
    vit = [randomize(build_backbone(tiny_config()), 3) for _ in range(2)]
    return (*vit, lambda m: m(x), "deconv_bn2", "vitpose")


@pytest.mark.parametrize("kind", ["fusion", "resnet", "vitpose"])
def test_one_fold_serves_every_module(kind, log):
    """`FoldedModule.fold` on the fusion model, a PoseResNet-18 and a tiny
    ViTPose, float32: it keeps `state_dict()`'s keys; it folds every
    Conv, Deconv and Dense and every torch layer of a trunk, `final`
    included; it is one `setup.fold` span of the module's label; its
    stamp holds each parameter and each BatchNorm's running statistics,
    once.  An in-place write to one BatchNorm's `running_var` moves the
    answer, and the next eval forward refolds (a second span) and matches
    the unfolded twin after the same write within 1e-5 of the largest
    output."""
    from torch import nn

    from faster_voxelpose_tpu_torch.models.blocks import Conv, Deconv, Dense

    model, twin, run, bn, label = _served_case(kind)
    keys = list(model.state_dict())
    model.fold()
    assert list(model.state_dict()) == keys and model.folded
    layers = [m for m in model.modules()
              if isinstance(m, (Conv, Deconv, Dense, nn.Conv2d, nn.Linear, nn.LayerNorm))]
    assert layers and all(m.folded for m in layers)
    assert getattr(model, "final", layers[0]).folded
    assert [(s["name"], s["label"]) for s in log.setup_spans()] == [("setup.fold", label)]
    read = {id(t) for t in model.parameters()}
    read |= {id(t) for n, t in model.named_buffers() if n.endswith(("running_mean", "running_var"))}
    assert len(model._fold_tensors) == len(read) == len({id(t) for t in model._fold_tensors})
    assert {id(t) for t in model._fold_tensors} == read
    with torch.no_grad():
        before = run(model)
        for m in (model, twin):
            m.get_submodule(bn).running_var.mul_(1.5)
        got, want = run(model), run(twin)
    tol = 1e-5 * float(want.abs().max())
    assert float((want - before).abs().max()) > 100 * tol
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)
    assert _fold_spans(log, label) == 2 and not model.sync_fold()


def test_models_import_graph():
    """`models/`: no module-level import cycle among blocks, resnet,
    vitpose and faster_voxelpose (read from their sources); no import
    inside a function of resnet.py; `build_backbone`,
    `images_to_heatmaps` and `PoseResNet` importable from resnet."""
    import ast
    from pathlib import Path

    import faster_voxelpose_tpu_torch.models as models
    from faster_voxelpose_tpu_torch.models.resnet import (PoseResNet, build_backbone,
                                                          images_to_heatmaps)

    names = ("blocks", "resnet", "vitpose", "faster_voxelpose")
    root = Path(models.__file__).parent
    trees = {n: ast.parse((root / f"{n}.py").read_text()) for n in names}
    deps = {n: {a.module for a in trees[n].body
                if isinstance(a, ast.ImportFrom) and a.level == 1 and a.module in names}
            for n in names}

    def reaches(a, b, seen=()):
        return any(d == b or (d not in seen and reaches(d, b, seen + (d,))) for d in deps[a])

    assert not [n for n in names if reaches(n, n)], deps
    assert "resnet" not in deps["vitpose"] | deps["blocks"]
    inner = [node for f in ast.walk(trees["resnet"])
             if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
             for node in ast.walk(f) if isinstance(node, (ast.Import, ast.ImportFrom))]
    assert not inner
    assert callable(build_backbone) and callable(images_to_heatmaps) and PoseResNet
