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

`to_jax_variables` inverts the mapping, so that weights trained by the
port are served by either package.
"""

from __future__ import annotations

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
        if modules and modules[-1] == "deconv":
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
    return sd


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
            if modules and modules[-1] == "deconv":
                w = np.flip(np.transpose(w, (*spatial, 0, 1)), axis=tuple(range(rank)))
            elif w.ndim == 2:
                w = w.T
            else:
                w = np.transpose(w, (*spatial, 1, 0))
        else:
            raise ValueError(f"unrecognised state-dict key {key!r}")
        flat["/".join(path)] = np.ascontiguousarray(w, dtype=np.float32)
    return flat
