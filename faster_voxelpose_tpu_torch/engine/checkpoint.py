"""Best-model snapshots in the JAX package's layout (counterpart of
`save_best_npz` / `load_best_npz`, faster_voxelpose_tpu/engine/checkpoint.py:145-183):
one compressed npz of path-keyed float32 flax variables, e.g.
`params/jln/weight_net/fc1/kernel`.  A model trained by the port is thus
served by either package, and the repo's `checkpoints/*/model_best.npz`
load into the port.  `load_best_model` is the counterpart of the JAX
package's loader of an output directory's best model.
"""

from __future__ import annotations

import os
import pathlib
from typing import Dict

import numpy as np
from torch import nn

from ..weights import from_jax_variables, to_jax_variables

BEST_NPZ = "model_best.npz"
REPO_CHECKPOINTS = pathlib.Path(__file__).resolve().parents[2] / "checkpoints"


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


def load_best_model(output_dir: str, model: nn.Module,
                    repo_snapshot_fallback: bool = False) -> nn.Module:
    """Load `<output_dir>/model_best.npz` into `model` in place; returns
    the model (counterpart of `load_best_model`,
    faster_voxelpose_tpu/engine/checkpoint.py:88-109).  Raises
    FileNotFoundError where the file is absent.  The JAX package then
    falls back, silently, to the repo's snapshot
    `checkpoints/<basename of output_dir>/model_best.npz`; here that
    fallback is taken only with `repo_snapshot_fallback`, so that a
    mistyped directory is never answered by a committed model."""
    path = pathlib.Path(output_dir) / BEST_NPZ
    if not path.exists() and repo_snapshot_fallback:
        path = REPO_CHECKPOINTS / pathlib.Path(os.path.normpath(output_dir)).name / BEST_NPZ
    if not path.exists():
        raise FileNotFoundError(f"no {BEST_NPZ} under {output_dir}"
                                + ("" if repo_snapshot_fallback else
                                   " (the repo's snapshots are reached only with "
                                   "repo_snapshot_fallback)"))
    return load_best_npz(str(path), model)
