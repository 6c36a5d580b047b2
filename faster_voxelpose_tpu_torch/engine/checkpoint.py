"""Best-model snapshots in the JAX package's layout (counterpart of
`save_best_npz` / `load_best_npz`, faster_voxelpose_tpu/engine/checkpoint.py:145-183):
one compressed npz of path-keyed float32 flax variables, e.g.
`params/jln/weight_net/fc1/kernel`.  A model trained by the port is thus
served by either package, and the repo's `checkpoints/*/model_best.npz`
load into the port.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
from torch import nn

from ..weights import from_jax_variables, to_jax_variables


def save_best_npz(npz_path: str, model: nn.Module) -> Dict[str, np.ndarray]:
    """Write the model's parameters and BatchNorm statistics as flax
    variables; returns the arrays written."""
    flat = to_jax_variables(model.state_dict())
    os.makedirs(os.path.dirname(os.path.abspath(npz_path)), exist_ok=True)
    np.savez_compressed(npz_path, **flat)
    return flat


def load_best_npz(npz_path: str, model: nn.Module) -> nn.Module:
    """Load a snapshot into `model` in place (every variable must fit,
    see `weights.from_jax_variables`); returns the model."""
    with np.load(npz_path) as data:
        flat = {k: data[k] for k in data.files}
    model.load_state_dict(from_jax_variables(flat, model))
    return model
