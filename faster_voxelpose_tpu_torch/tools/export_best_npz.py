"""Publish a trained best model as a snapshot of the model zoo, validated
from the written file (counterpart of scripts/export_best_npz.py):

    python3 -m faster_voxelpose_tpu_torch.tools.export_best_npz --cfg configs/demo/panoptic_synthetic.yaml \
        --snapshot-dir snap [--device cpu]

Loads the port's best model (`<OUTPUT_DIR>/<TEST_DATASET>/<cfg stem>/
model_best.npz`, what tools/train.py writes), writes `model_best.npz` in
the JAX package's layout (`engine.checkpoint.save_best_npz`: path-keyed
flax variables, which either package loads), then RELOADS that npz into a
fresh model and validates with it (`engine.validator.run_validation` on
the config's test set, on the card), so that the metric of
`eval_record.json` is the written file's.  The record holds the config's
path relative to the checkout, the metric and its message, the seed, the
best epoch (the epoch of the last "saved best model" line of the run's
`*_train.log` files, as the script parses them: `best_epoch`) and the
evaluation set.

One departure, as tools/train.py made: `--snapshot-dir` names where the
snapshot goes.  Without it the snapshot goes where the script writes it,
`checkpoints/<cfg stem>` of the checkout, which overwrites a committed
snapshot of the same name.  Unlike the JAX package's `load_best_model`,
a missing best model raises rather than falling back to the committed
snapshot, which would export that snapshot onto itself.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Optional, Sequence

from ..config import load_config
from ..datasets import get_dataset
from ..device import resolve_device
from ..engine.checkpoint import (BEST_NPZ, EVAL_RECORD, load_best_model, load_best_npz,
                                 repo_snapshot_dir, save_best_npz)
from ..engine.validator import run_validation
from ..models.faster_voxelpose import build_model
from ..utils.logging_utils import create_logger
from .timing import device_line


def best_epoch(output_dir: str) -> Optional[int]:
    """The epoch of the LAST "saved best model" event across the run's
    train logs (the script's parse): each line ending "epoch N" sets the
    current epoch, each "saved best model" line after one takes it."""
    epoch = None
    try:
        for lf in sorted(f for f in os.listdir(output_dir) if f.endswith("_train.log")):
            cur = None
            with open(os.path.join(output_dir, lf), errors="ignore") as f:
                for line in f:
                    m = re.search(r"\bepoch (\d+)$", line.strip())
                    if m:
                        cur = int(m.group(1))
                    if "saved best model" in line and cur is not None:
                        epoch = cur
    except OSError:
        pass
    return epoch


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", required=True)
    p.add_argument("--snapshot-dir", default=None,
                   help="where the snapshot goes (default: checkpoints/<cfg stem> of the checkout)")
    p.add_argument("--device", default=None, help="default: the CUDA device (cpu: tests only)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config(args.cfg)
    logger, output_dir, _ = create_logger(cfg, args.cfg, "export")
    logger.info("device: %s", device_line(device))
    model = load_best_model(output_dir, build_model(cfg))

    snap_dir = str(args.snapshot_dir or repo_snapshot_dir(output_dir))
    os.makedirs(snap_dir, exist_ok=True)
    npz_path = os.path.join(snap_dir, BEST_NPZ)
    save_best_npz(npz_path, model)

    # round trip: evaluate the written file, not the model it came from
    reloaded = load_best_npz(npz_path, build_model(cfg))
    test_ds = get_dataset(cfg.DATASET.TEST_DATASET)(cfg, is_train=False)
    metric, msg, _ = run_validation(cfg, reloaded, test_ds, device=device)
    logger.info("npz round-trip eval:\n%s", msg)

    record = {
        "config": os.path.relpath(os.path.abspath(args.cfg),
                                  os.path.dirname(os.path.abspath(snap_dir)) + "/.."),
        "metric": float(metric),
        "message": msg,
        "seed": cfg.TRAIN.SEED,
        "epoch": best_epoch(output_dir),
        "eval_set": f"{cfg.DATASET.TEST_DATASET}/"
                    f"{len(test_ds)} samples (held-out synthetic)",
    }
    with open(os.path.join(snap_dir, EVAL_RECORD), "w") as f:
        json.dump(record, f, indent=2)
    print(f"snapshot: {snap_dir}")
    print(f"metric (npz round-trip): {metric:.4f}")
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
