"""The procedural pose bank (frozen copy of `make_pose_bank` of the
repo's `scripts/make_demo_data.py`): jittered copies of a template
skeleton, mid-hip 850-1000 mm up."""

from __future__ import annotations

import numpy as np

PANOPTIC15 = np.array([
    [0, 0, 450], [0, 40, 560], [0, 0, 0], [150, 0, 430], [230, 0, 200],
    [260, 30, -20], [90, 0, -20], [100, 20, -420], [110, 0, -800],
    [-150, 0, 430], [-230, 0, 200], [-260, 30, -20], [-90, 0, -20],
    [-100, 20, -420], [-110, 0, -800],
], dtype=np.float64)
COCO17 = np.array([
    [0, 40, 560], [30, 55, 590], [-30, 55, 590], [70, 20, 570], [-70, 20, 570],
    [150, 0, 430], [-150, 0, 430], [230, 0, 200], [-230, 0, 200],
    [260, 30, -20], [-260, 30, -20], [90, 0, 0], [-90, 0, 0],
    [100, 20, -420], [-100, 20, -420], [110, 0, -800], [-110, 0, -800],
], dtype=np.float64)
SKELETONS = {"panoptic15": PANOPTIC15, "coco17": COCO17}


def make_pose_bank(n_poses: int, skeleton: str, seed: int = 1) -> np.ndarray:
    """(n_poses, J, 3) mm."""
    template = SKELETONS[skeleton]
    rng = np.random.RandomState(seed)
    bank = []
    for _ in range(n_poses):
        pose = template + rng.normal(0, 40, template.shape)
        pose[:, 2] += rng.uniform(850, 1000)
        bank.append(pose)
    return np.asarray(bank)
