"""PyTorch port, conv modules and the weight loader: each flax module of
the JAX package and its port counterpart on the same input, with the
flax weights carried across by `from_jax_variables` (CPU, float32).

The flax initializer draws N(0, 0.001) weights, which make every
activation nearly zero; the weights are re-drawn at fan-in scale and the
BatchNorm statistics made non-trivial so that outputs are O(1) and a
layout slip shows.  Tolerance 1e-4: float32 convolutions summed in
another order by XLA and PyTorch.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

REPO = pathlib.Path(__file__).resolve().parent.parent


def randomize(variables, seed=0):
    """Fan-in-scaled weights, random biases and BN statistics."""
    from faster_voxelpose_tpu_torch.weights import flatten_variables

    rng = np.random.RandomState(seed)
    out = {}
    for path, v in sorted(flatten_variables(variables).items()):
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            out[path] = rng.randn(*v.shape) * np.sqrt(2.0 / fan_in)
        elif leaf in ("scale", "var"):
            out[path] = rng.uniform(0.5, 1.5, v.shape)
        else:  # bias, mean
            out[path] = rng.randn(*v.shape) * 0.1
        out[path] = out[path].astype(np.float32)
    return out


def nest(flat):
    """{'a/b/c': x} -> {'a': {'b': {'c': x}}} (flax variables)."""
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _carry(flax_module, port_module, x_jax, seed=0):
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    flat = randomize(flax_module.init(jax.random.PRNGKey(0), x_jax), seed)
    port_module.load_state_dict(from_jax_variables(flat, port_module))
    return flax_module.apply(nest(flat), x_jax), port_module.eval()


def _cases():
    from faster_voxelpose_tpu.models import cnns as jc
    from faster_voxelpose_tpu_torch.models import cnns as pc

    f32 = jnp.float32
    return {
        "center_net": (lambda: jc.CenterNet(dtype=f32), lambda: pc.CenterNet(15),
                       (2, 16, 16, 8, 15), None),
        "c2c_net": (lambda: jc.C2CNet(dtype=f32), lambda: pc.C2CNet(15),
                    (6, 8, 15), (0, 2, 1)),
        "p2p_net": (lambda: jc.P2PNet(15, dtype=f32), lambda: pc.P2PNet(15, 15),
                    (3, 16, 16, 15), (0, 3, 1, 2)),
        "weight_net": (lambda: jc.WeightNet(32, 64, dtype=f32),
                       lambda: pc.WeightNet(32, 64), (3, 16, 16, 15), (0, 3, 1, 2)),
        "p2p_net_w05": (lambda: jc.P2PNet(15, dtype=f32, width=0.5),
                        lambda: pc.P2PNet(15, 15, width=0.5), (2, 16, 16, 15), (0, 3, 1, 2)),
    }


@pytest.mark.parametrize("name", ["center_net", "c2c_net", "p2p_net", "weight_net", "p2p_net_w05"])
def test_head_matches_flax(name):
    flax_ctor, port_ctor, shape, to_port = _cases()[name]
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    ref, port = _carry(flax_ctor(), port_ctor(), jnp.asarray(x))
    xt = torch.as_tensor(x if to_port is None else x.transpose(to_port).copy())
    with torch.no_grad():
        ours = port(xt)
    if name == "center_net":
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy().transpose(0, 2, 3, 1), np.asarray(b), atol=1e-4)
        return
    ours = ours.numpy()
    if name.startswith("p2p_net"):
        ours = ours.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize(
    "kernel,stride,pad,rank", [(2, 2, 0, 2), (2, 2, 0, 1), (4, 2, 1, 2)]
)
def test_deconv_matches_flax(kernel, stride, pad, rank):
    """The k2/s2 sub-pixel branch and the dilated k4/s2/p1 branch of the
    flax Deconv against conv_transpose with the flip undone."""
    from faster_voxelpose_tpu.models.blocks import Deconv as JDeconv
    from faster_voxelpose_tpu_torch.models.blocks import Deconv

    shape = (2, 6, 5, 8) if rank == 2 else (2, 7, 8)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    flax_mod = JDeconv(12, kernel, stride, pad, rank=rank, dtype=jnp.float32)
    holder = nn.Module()
    holder.deconv = Deconv(8, 12, kernel, stride, pad, rank)
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    flat = randomize(flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    ref = np.asarray(flax_mod.apply(nest(flat), jnp.asarray(x)))
    holder.load_state_dict(from_jax_variables(
        {f"params/deconv/{k.split('/')[-1]}": v for k, v in flat.items()}, holder
    ))
    perm = (0, 3, 1, 2) if rank == 2 else (0, 2, 1)
    with torch.no_grad():
        ours = holder.deconv(torch.as_tensor(x.transpose(perm).copy())).numpy()
    back = (0, 2, 3, 1) if rank == 2 else (0, 2, 1)
    np.testing.assert_allclose(ours.transpose(back), ref, atol=1e-4)


def _checkpoints():
    return sorted(p.parent.name for p in (REPO / "checkpoints").glob("*/model_best.npz"))


@pytest.mark.parametrize("name", _checkpoints())
def test_from_jax_variables_loads_checkpoint(name):
    """Every committed snapshot fills the port's model for its own config:
    no key unused, none missing, every shape right (no forward run)."""
    from faster_voxelpose_tpu_torch.config import load_config
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    ckpt = REPO / "checkpoints" / name
    record = json.loads((ckpt / "eval_record.json").read_text())
    cfg_path = REPO / "configs" / record["config"].split("configs/", 1)[1]
    model = build_model(load_config(cfg_path))
    with np.load(ckpt / "model_best.npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    sd = from_jax_variables(flat, model)
    assert len(sd) == len(flat) == len(model.state_dict())
    model.load_state_dict(sd, strict=True)
    key = "params/jln/weight_net/fc1/kernel"
    np.testing.assert_array_equal(model.jln.weight_net.fc1.weight.detach().numpy(), flat[key].T)


def test_from_jax_variables_rejects_misfits():
    from faster_voxelpose_tpu_torch.models.cnns import WeightNet
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    model = WeightNet(32, 64)
    good = {f"params/{k.replace('.weight', '/kernel')}": v for k, v in {
        "feat_conv.weight": np.zeros((3, 3, 1, 32)), "fc1.weight": np.zeros((32, 64)),
        "fc2.weight": np.zeros((64, 1))}.items()}
    good.update({"params/feat_conv/bias": np.zeros(32), "params/fc1/bias": np.zeros(64),
                 "params/fc2/bias": np.zeros(1), "params/feat_bn/scale": np.ones(32),
                 "params/feat_bn/bias": np.zeros(32), "batch_stats/feat_bn/mean": np.zeros(32),
                 "batch_stats/feat_bn/var": np.ones(32)})
    assert len(from_jax_variables(good, model)) == len(model.state_dict())
    with pytest.raises(ValueError, match="unused"):
        from_jax_variables({**good, "params/extra/kernel": np.zeros((3, 3))}, model)
    with pytest.raises(ValueError, match="shape"):
        from_jax_variables({**good, "params/fc1/bias": np.zeros(63)}, model)
    missing = dict(good)
    del missing["batch_stats/feat_bn/var"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_variables(missing, model)
