"""Flax variables <-> state dict of the port's modules.

The JAX package's checkpoints (`checkpoints/*/model_best.npz`) hold its
flax variables as path-keyed arrays, e.g.
`params/jln/weight_net/fc1/kernel`.  The port's modules carry the same
names, so each path maps onto a state-dict key, with these layout changes:

  conv kernel    (*k, I, O)            -> (O, I, *k)
  deconv kernel  (*k, I, O), flipped   -> (I, O, *k), flip undone
  dense kernel   (I, O)                -> (O, I)
  BatchNorm      params scale / bias   -> weight / bias
                 batch_stats mean / var -> running_mean / running_var

(a deconv is a module named `deconv`, or `deconv1`.. as in the backbone).
`to_jax_variables` inverts the mapping, so that weights trained by the
port are served by either package.

`convert_model` and `convert_backbone` take the upstream's PyTorch state
dicts (the reference's FasterVoxelPoseNet, the Pose-ResNet backbone) to
the port's state dicts directly: the port's modules keep PyTorch's
layouts, so this is a renaming (the port's own copy of the JAX package's
`utils/weights_torch.py`, which converts the same dicts to flax).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn


def flatten_variables(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested flax variables -> {'collection/module/.../leaf': array}; a
    flat mapping (an npz) passes through."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_variables(v, path))
        else:
            out[path] = np.asarray(v)
    return out


_DECONV = re.compile(r"deconv\d*")


def _convert(path: str, value: np.ndarray):
    parts = path.split("/")
    collection, modules, leaf = parts[0], parts[1:-1], parts[-1]
    if collection == "batch_stats":
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
    elif collection == "params":
        name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
    else:
        raise KeyError(collection)
    w = np.asarray(value, np.float32)
    if leaf == "kernel":
        rank = w.ndim - 2
        spatial = tuple(range(rank))
        if modules and _DECONV.fullmatch(modules[-1]):
            w = np.transpose(np.flip(w, axis=spatial), (rank, rank + 1, *spatial))
        elif w.ndim == 2:
            w = w.T
        else:
            w = np.transpose(w, (rank + 1, rank, *spatial))
    return ".".join(modules + [name]), torch.tensor(np.ascontiguousarray(w))


def from_jax_variables(
    flat: Mapping, model: Optional[nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """Convert flax variables (flat path-keyed, or nested) to a state dict.

    With `model`, raise ValueError unless every converted key names one
    of the model's parameters or buffers with the same shape and every
    one of those is filled."""
    sd = {}
    for path, value in flatten_variables(flat).items():
        try:
            key, t = _convert(path, value)
        except KeyError as e:
            raise ValueError(f"unrecognised variable {path!r}") from e
        sd[key] = t
    if model is not None:
        check_fits(sd, model)
    return sd


def check_fits(sd: Mapping[str, torch.Tensor], model: nn.Module) -> None:
    """Raise ValueError unless every key of `sd` names one of the model's
    parameters or buffers with the same shape and every one of those is
    filled."""
    want = model.state_dict()
    unused = sorted(set(sd) - set(want))
    missing = sorted(set(want) - set(sd))
    bad = sorted(
        f"{k}: {tuple(sd[k].shape)} vs {tuple(want[k].shape)}"
        for k in set(sd) & set(want) if sd[k].shape != want[k].shape
    )
    if unused or missing or bad:
        raise ValueError(
            f"variables do not fit the model: unused {unused[:8]}, "
            f"missing {missing[:8]}, shape mismatches {bad[:8]} "
            f"({len(unused)}/{len(missing)}/{len(bad)})"
        )


def to_jax_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """State dict of the port's model -> flat path-keyed flax variables,
    float32 numpy, the inverse of `from_jax_variables` (the layout of the
    JAX package's `model_best.npz`)."""
    flat = {}
    for key, t in state_dict.items():
        *modules, name = key.split(".")
        w = t.detach().cpu().float().numpy()
        if name in ("running_mean", "running_var"):
            path = ["batch_stats", *modules, name.split("_")[1]]
        elif name == "bias":
            path = ["params", *modules, "bias"]
        elif name == "weight" and w.ndim == 1:  # BatchNorm scale
            path = ["params", *modules, "scale"]
        elif name == "weight":
            path = ["params", *modules, "kernel"]
            rank = w.ndim - 2
            spatial = tuple(range(2, w.ndim))
            if modules and _DECONV.fullmatch(modules[-1]):
                w = np.flip(np.transpose(w, (*spatial, 0, 1)), axis=tuple(range(rank)))
            elif w.ndim == 2:
                w = w.T
            else:
                w = np.transpose(w, (*spatial, 1, 0))
        else:
            raise ValueError(f"unrecognised state-dict key {key!r}")
        flat["/".join(path)] = np.ascontiguousarray(w, dtype=np.float32)
    return flat


# -- upstream PyTorch state dicts --------------------------------------------


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """An upstream checkpoint as {name: tensor}: a raw state dict or the
    reference's training checkpoint ({'state_dict': ...} or {'model':
    ...}), with any DataParallel 'module.' prefix removed."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    return {k.replace("module.", ""): v.detach() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


class _Renamer:
    """Collects upstream tensors under the port's names (float32); which
    upstream keys are read follows the JAX package's converter."""

    def __init__(self, sd: Mapping):
        self.sd, self.out = sd, {}

    def _put(self, path, leaf, value):
        self.out[".".join(path + (leaf,))] = torch.as_tensor(np.asarray(value, np.float32))

    def conv(self, tname: str, path: tuple, bias: bool = True) -> None:
        self._put(path, "weight", self.sd[tname + ".weight"])
        if bias and tname + ".bias" in self.sd:
            self._put(path, "bias", self.sd[tname + ".bias"])

    def bn(self, tname: str, path: tuple) -> None:
        for src, dst in (("weight", "weight"), ("bias", "bias"),
                         ("running_mean", "running_mean"), ("running_var", "running_var")):
            self._put(path, dst, self.sd[f"{tname}.{src}"])


def _as_numpy(sd: Mapping) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in sd.items()}


def _res_block(b: _Renamer, tname: str, path: tuple) -> None:
    b.conv(f"{tname}.res_branch.0", path + ("conv1",))
    b.bn(f"{tname}.res_branch.1", path + ("bn1",))
    b.conv(f"{tname}.res_branch.3", path + ("conv2",))
    b.bn(f"{tname}.res_branch.4", path + ("bn2",))
    if f"{tname}.skip_con.0.weight" in b.sd:
        b.conv(f"{tname}.skip_con.0", path + ("skip_conv",))
        b.bn(f"{tname}.skip_con.1", path + ("skip_bn",))


def _front(b: _Renamer, tname: str, path: tuple) -> None:
    b.conv(f"{tname}.0.block.0", path + ("front_basic", "conv"))
    b.bn(f"{tname}.0.block.1", path + ("front_basic", "bn"))
    _res_block(b, f"{tname}.1", path + ("front_res",))


def _encdec(b: _Renamer, tname: str, path: tuple) -> None:
    for name in ("skip_res1", "encoder_res1", "skip_res2", "encoder_res2",
                 "mid_res", "decoder_res2", "decoder_res1"):
        _res_block(b, f"{tname}.{name}", path + (name,))
    for name in ("decoder_upsample2", "decoder_upsample1"):
        b.conv(f"{tname}.{name}.block.0", path + (name, "deconv"))
        b.bn(f"{tname}.{name}.block.1", path + (name, "bn"))


def convert_model(sd: Mapping, model: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """The reference's FasterVoxelPoseNet state dict -> the port's
    FasterVoxelPoseNet state dict; with `model`, misfits raise as in
    `from_jax_variables`."""
    b = _Renamer(_as_numpy(sd))
    cn = ("hdn", "center_net")
    _front(b, "pose_net.center_net.front_layers", cn + ("front",))
    _encdec(b, "pose_net.center_net.encoder_decoder", cn + ("encdec",))
    b.conv("pose_net.center_net.output_hm.0", cn + ("hm_conv",))
    b.conv("pose_net.center_net.output_hm.2", cn + ("hm_out",))
    b.conv("pose_net.center_net.output_size.0", cn + ("size_conv",))
    b.conv("pose_net.center_net.output_size.2", cn + ("size_out",))
    cc = ("hdn", "c2c_net")
    _front(b, "pose_net.c2c_net.front_layers", cc + ("front",))
    _encdec(b, "pose_net.c2c_net.encoder_decoder", cc + ("encdec",))
    b.conv("pose_net.c2c_net.output_hm", cc + ("output",))
    pp = ("jln", "p2p_net")
    _front(b, "joint_net.conv_net.front_layers", pp + ("front",))
    _encdec(b, "joint_net.conv_net.encoder_decoder", pp + ("encdec",))
    b.conv("joint_net.conv_net.output_layer", pp + ("output",))
    wn = ("jln", "weight_net")
    b.conv("joint_net.weight_net.heatmap_feature_net.0", wn + ("feat_conv",))
    b.bn("joint_net.weight_net.heatmap_feature_net.1", wn + ("feat_bn",))
    b.conv("joint_net.weight_net.output.0", wn + ("fc1",))
    b.conv("joint_net.weight_net.output.2", wn + ("fc2",))
    if model is not None:
        check_fits(b.out, model)
    return b.out


def convert_backbone(sd: Mapping, num_layers: int = 50,
                     model: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """The upstream Pose-ResNet state dict -> the port's `PoseResNet`
    state dict; with `model`, misfits raise as in `from_jax_variables`."""
    from .models.resnet import RESNET_SPEC

    _, layout = RESNET_SPEC[num_layers]
    n_convs = 3 if num_layers >= 50 else 2
    b = _Renamer(_as_numpy(sd))
    b.conv("conv1", ("conv1",), bias=False)
    b.bn("bn1", ("bn1",))
    for stage, blocks in enumerate(layout):
        for i in range(blocks):
            t, p = f"layer{stage + 1}.{i}", (f"layer{stage + 1}_{i}",)
            for c in range(1, n_convs + 1):
                b.conv(f"{t}.conv{c}", p + (f"conv{c}",), bias=False)
                b.bn(f"{t}.bn{c}", p + (f"bn{c}",))
            if f"{t}.downsample.0.weight" in b.sd:
                b.conv(f"{t}.downsample.0", p + ("down_conv",), bias=False)
                b.bn(f"{t}.downsample.1", p + ("down_bn",))
    # deconv_layers: ConvTranspose at 0, 3, 6 and BatchNorm at 1, 4, 7
    for i in range(3):
        b.conv(f"deconv_layers.{i * 3}", (f"deconv{i + 1}",))
        b.bn(f"deconv_layers.{i * 3 + 1}", (f"deconv_bn{i + 1}",))
    b.conv("final_layer", ("final",))
    if model is not None:
        check_fits(b.out, model)
    return b.out
