"""Calibration loading of the Shelf/Campus format (counterpart of
`load_flat_calibration` in `faster_voxelpose_tpu/datasets/shelf_campus.py`).
The Shelf and Campus datasets themselves are not ported yet."""

from __future__ import annotations

import json
from typing import Dict

import numpy as np


def load_flat_calibration(path: str) -> Dict[int, dict]:
    """{cam_id: {R, T, fx, fy, cx, cy, k, p}} JSON (reference
    shelf.py:138-153)."""
    with open(path) as f:
        cameras = json.load(f)
    return {
        int(cam_id): {k: np.array(v) for k, v in cam.items()}
        for cam_id, cam in cameras.items()
    }
