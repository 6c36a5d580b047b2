"""Experiment logging: output directories, timestamped log files, scalar
metrics (the port's copy of `faster_voxelpose_tpu/utils/logging_utils.py`:
the same directory layout and byte for byte the same scalar records).

Capability parity with lib/utils/utils.py:19-50 (create_logger) and the
TensorBoard scalar stream (function.py:102-109): scalars go to a JSONL
file consumable by any dashboard and to a TensorBoard event file.
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Tuple


def create_logger(cfg, cfg_name: str, phase: str = "train") -> Tuple[logging.Logger, str, str]:
    """Create output/log dirs and a timestamped file logger.

    Layout matches the reference: output/<test_dataset>/<cfg_name>/ and
    log/<test_dataset>/<cfg_name>_<timestamp>/.
    """
    dataset = cfg.DATASET.TEST_DATASET
    cfg_stem = Path(cfg_name).stem
    output_dir = Path(cfg.OUTPUT_DIR) / dataset / cfg_stem
    output_dir.mkdir(parents=True, exist_ok=True)

    t = time.strftime("%Y-%m-%d-%H-%M")
    log_file = output_dir / f"{cfg_stem}_{t}_{phase}.log"
    head = "%(asctime)-15s %(message)s"
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    # explicit handlers: logging.basicConfig would silently no-op when a
    # library already configured the root logger, losing the timestamped
    # log file entirely
    if not any(
        isinstance(h, logging.FileHandler)
        and getattr(h, "baseFilename", "") == str(log_file)
        for h in logger.handlers
    ):
        fh = logging.FileHandler(str(log_file))
        fh.setFormatter(logging.Formatter(head))
        logger.addHandler(fh)
    if not any(
        type(h) is logging.StreamHandler for h in logger.handlers
    ):
        console = logging.StreamHandler()
        console.setFormatter(logging.Formatter(head))
        logger.addHandler(console)

    scalar_dir = Path(cfg.LOG_DIR) / dataset / f"{cfg_stem}_{t}"
    scalar_dir.mkdir(parents=True, exist_ok=True)
    return logger, str(output_dir), str(scalar_dir)


class ScalarWriter:
    """Append-only JSONL scalar stream ({tag, value, step, wall}), teed
    into a TensorBoard event file in the same dir (the reference streams
    scalars to tensorboardX, lib/utils/utils.py:44-50 — `tensorboard
    --logdir` works on ours the same way; see utils/tb_events.py)."""

    def __init__(self, log_dir: str, filename: str = "scalars.jsonl",
                 tensorboard: bool = True):
        self.path = os.path.join(log_dir, filename)
        self._fh = open(self.path, "a")
        self._tb = None
        if tensorboard:
            from .tb_events import TBEventWriter

            self._tb = TBEventWriter(log_dir)

    def add_scalar(self, tag: str, value, step: int):
        self._fh.write(
            json.dumps(
                {"tag": tag, "value": float(value), "step": int(step), "wall": time.time()}
            )
            + "\n"
        )
        self._fh.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
