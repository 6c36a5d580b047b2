"""Checkpoints of the port (counterpart of
`faster_voxelpose_tpu/engine/checkpoint.py`).

- Best-model snapshots in the JAX package's layout (`save_best_npz` /
  `load_best_npz`, :145-183 there): one compressed npz of path-keyed
  float32 flax variables, e.g. `params/jln/weight_net/fc1/kernel`.  A
  model trained by the port is thus served by either package, and the
  repo's `checkpoints/*/model_best.npz` load into the port.
  `load_best_model` loads an output directory's best model;
  `write_repo_snapshot` writes a snapshot and its eval record.
- The resumable training checkpoint (`save_checkpoint` /
  `load_checkpoint`, :27-86 there): `<output_dir>/checkpoint.pt`, written
  to a temporary file and renamed, with the epoch, the best metric, the
  trainer's state (`Trainer.state_dict`: the model, both Adams, the HDN
  accumulator and mini-step) and the RandomStates of the training loader
  and its dataset.  A resumed run therefore continues the order and the
  augmentation draws of the run it resumes (with samples made in the
  calling process, `WORKERS: 0`); the JAX package's resume reseeds its
  loader from TRAIN.SEED and repeats epoch 0's order.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..weights import from_jax_variables, to_jax_variables

logger = logging.getLogger(__name__)

BEST_NPZ = "model_best.npz"
CHECKPOINT = "checkpoint.pt"
EVAL_RECORD = "eval_record.json"
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
        path = repo_snapshot_dir(output_dir) / BEST_NPZ
    if not path.exists():
        raise FileNotFoundError(f"no {BEST_NPZ} under {output_dir}"
                                + ("" if repo_snapshot_fallback else
                                   " (the repo's snapshots are reached only with "
                                   "repo_snapshot_fallback)"))
    logger.info("=> loaded best model %s", path)
    return load_best_npz(str(path), model)


def repo_snapshot_dir(output_dir: str) -> pathlib.Path:
    """The repo's snapshot directory for an experiment's output_dir:
    `<repo>/checkpoints/<basename of output_dir>`."""
    return REPO_CHECKPOINTS / pathlib.Path(os.path.normpath(output_dir)).name


def write_repo_snapshot(output_dir: str, model: nn.Module, record: Dict[str, object],
                        snapshot_dir: Optional[str] = None) -> pathlib.Path:
    """Write `model_best.npz` and `eval_record.json` (the record: config,
    epoch, metric, message, seed) into `snapshot_dir`, by default the
    repo's own `repo_snapshot_dir(output_dir)` as in the JAX package,
    which overwrites a committed snapshot of the same name.  Returns the
    directory."""
    snap = pathlib.Path(snapshot_dir) if snapshot_dir is not None else repo_snapshot_dir(output_dir)
    snap.mkdir(parents=True, exist_ok=True)
    save_best_npz(str(snap / BEST_NPZ), model)
    with open(snap / EVAL_RECORD, "w") as f:
        json.dump(record, f, indent=2)
    logger.info("=> wrote snapshot to %s", snap)
    return snap


def _rng_state(rng: np.random.RandomState) -> Dict[str, object]:
    """A RandomState's state as tensors and numbers (loadable with
    torch.load's weights_only)."""
    name, keys, pos, has_gauss, cached = rng.get_state()
    return {"name": name, "keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached_gaussian": float(cached)}


def _set_rng_state(rng: np.random.RandomState, state: Dict[str, object]) -> None:
    rng.set_state((state["name"], state["keys"].cpu().numpy().astype(np.uint32), state["pos"],
                   state["has_gauss"], state["cached_gaussian"]))


def _loader_rngs(loader) -> Dict[str, np.random.RandomState]:
    """The RandomStates that decide a loader's next epoch: its order's and
    its dataset's augmentation draws'."""
    if loader is None:
        return {}
    rngs = {"loader": loader._rng}
    if getattr(loader.dataset, "_rng", None) is not None:
        rngs["dataset"] = loader.dataset._rng
    return rngs


def save_checkpoint(output_dir: str, trainer, epoch: int, best_metric: float, is_best: bool,
                    loader=None) -> None:
    """Write `<output_dir>/checkpoint.pt` (through a temporary file and a
    rename, so an interrupted write leaves the last checkpoint whole) and,
    when is_best, `<output_dir>/model_best.npz`."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, CHECKPOINT)
    ckpt = {"epoch": int(epoch), "best_metric": float(best_metric),
            "trainer": trainer.state_dict(),
            "rng": {k: _rng_state(r) for k, r in _loader_rngs(loader).items()}}
    torch.save(ckpt, path + ".tmp")
    os.replace(path + ".tmp", path)
    logger.info("=> saved checkpoint at epoch %d to %s", epoch, path)
    if is_best:
        save_best_npz(os.path.join(output_dir, BEST_NPZ), trainer.model)
        logger.info("=> saved best model to %s", os.path.join(output_dir, BEST_NPZ))


def load_checkpoint(output_dir: str, trainer, loader=None) -> Tuple[int, float]:
    """Restore `<output_dir>/checkpoint.pt` into `trainer` (and `loader`'s
    RandomStates) in place; returns (start_epoch, best_metric), or
    (0, -inf) when there is no checkpoint."""
    path = os.path.join(output_dir, CHECKPOINT)
    if not os.path.exists(path):
        logger.info("=> no checkpoint at %s, starting fresh", path)
        return 0, -np.inf
    ckpt = torch.load(path, map_location=trainer.device, weights_only=True)
    trainer.load_state_dict(ckpt["trainer"])
    rngs = _loader_rngs(loader)
    for k, state in ckpt["rng"].items():
        if k in rngs:
            _set_rng_state(rngs[k], state)
    logger.info("=> resumed from %s at epoch %d", path, ckpt["epoch"])
    return ckpt["epoch"], ckpt["best_metric"]
