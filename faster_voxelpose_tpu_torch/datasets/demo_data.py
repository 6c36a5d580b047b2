"""Self-contained training fixtures: a synthetic camera rig in the flat
calibration format {cam_id: {R, T, fx, fy, cx, cy, k, p}} and a
procedural pose bank of {'pose': (J, 3) mm, 'vis': (J, 4)} records (the
port's own copy of the repo's `scripts/make_demo_data.py` generators, so
that one seed gives the same rig and bank).

Each `configs/demo/` profile trains and is scored on the rig and bank of
the `make_demo_data.py` line in its header (`demo_rig`, `demo_pose_bank`):
`configs/demo/panoptic_synthetic.yaml` on
    make_rig(5, 2800.0, 2200.0, (0.0, -500.0), (1920, 1080))
    make_pose_bank(2000, skeleton="panoptic15")
the Shelf profiles on make_rig(5, 4500.0, 2200.0, (450.0, -320.0),
(1032, 776)) and the Campus profiles on make_rig(3, 10500.0, 2200.0,
(3000.0, 4500.0), (360, 288)), both with the "coco17" bank.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from ..config import Config


def make_rig(n_views: int, radius_mm: float, height_mm: float, center,
             image_size, seed: int = 0) -> Dict[str, dict]:
    """n_views cameras on a circle of radius_mm around center (xy), at
    height_mm, each looking at the center 1 m up."""
    rng = np.random.RandomState(seed)
    cams = {}
    for v in range(n_views):
        angle = 2 * np.pi * v / n_views + rng.uniform(-0.1, 0.1)
        cam_pos = np.array([center[0] + radius_mm * np.cos(angle),
                            center[1] + radius_mm * np.sin(angle), height_mm])
        target = np.array([center[0], center[1], 1000.0])
        fwd = target - cam_pos
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])  # world -> camera rows
        f = 0.9 * image_size[0]
        cams[str(v)] = {
            "R": R.tolist(), "T": cam_pos.reshape(3, 1).tolist(), "fx": f, "fy": f,
            "cx": image_size[0] / 2.0, "cy": image_size[1] / 2.0,
            "k": [[0.0], [0.0], [0.0]], "p": [[0.0], [0.0]],
        }
    return cams


# 15-joint (Panoptic order) template skeleton, mm offsets from mid-hip
SKELETON_PANOPTIC15 = np.array([
    [0, 0, 450], [0, 40, 560], [0, 0, 0], [150, 0, 430], [230, 0, 200],
    [260, 30, -20], [90, 0, -20], [100, 20, -420], [110, 0, -800],
    [-150, 0, 430], [-230, 0, 200], [-260, 30, -20], [-90, 0, -20],
    [-100, 20, -420], [-110, 0, -800],
], dtype=np.float64)

# 17-joint COCO-order template, the Shelf/Campus joint set
SKELETON_COCO17 = np.array([
    [0, 40, 560], [30, 55, 590], [-30, 55, 590], [70, 20, 570], [-70, 20, 570],
    [150, 0, 430], [-150, 0, 430], [230, 0, 200], [-230, 0, 200],
    [260, 30, -20], [-260, 30, -20], [90, 0, 0], [-90, 0, 0],
    [100, 20, -420], [-100, 20, -420], [110, 0, -800], [-110, 0, -800],
], dtype=np.float64)

SKELETONS = {"panoptic15": SKELETON_PANOPTIC15, "coco17": SKELETON_COCO17}


def make_pose_bank(n_poses: int, seed: int = 1, skeleton: str = "panoptic15") -> List[dict]:
    """n_poses jittered (N(0, 40) mm) copies of a template skeleton, the
    mid-hip 850-1000 mm up, every joint visible."""
    template = SKELETONS[skeleton]
    rng = np.random.RandomState(seed)
    bank = []
    for _ in range(n_poses):
        jitter = rng.normal(0, 40, template.shape)
        root_height = rng.uniform(850, 1000)
        pose = template + jitter
        pose[:, 2] += root_height
        bank.append({"pose": pose, "vis": np.ones((len(template), 4))})
    return bank


# The camera ring's radius in each demo data directory's make_demo_data.py
# line (the profiles' headers); Shelf's line takes the script's default.
RIG_RADIUS_MM = {"data/DemoPanoptic": 2800.0, "data/DemoShelf": 4500.0,
                 "data/DemoCampus": 10500.0}
# the pose bank's skeleton for each joint count
SKELETON_OF = {15: "panoptic15", 17: "coco17"}


def demo_rig(cfg: Config) -> Dict[int, dict]:
    """The rig `cfg` trains and is scored on, {cam_id: camera of numpy
    arrays}: `make_rig(CAMERA_NUM, radius, 2200, SPACE_CENTER[:2],
    ORI_IMAGE_SIZE)` with the radius of its DATADIR's line."""
    d = cfg.DATASET
    if d.DATADIR not in RIG_RADIUS_MM:
        raise KeyError(f"no demo rig for DATADIR {d.DATADIR!r}; known: {sorted(RIG_RADIUS_MM)}")
    rig = make_rig(d.CAMERA_NUM, RIG_RADIUS_MM[d.DATADIR], 2200.0,
                   cfg.CAPTURE_SPEC.SPACE_CENTER[:2], d.ORI_IMAGE_SIZE)
    return {int(k): {kk: np.array(vv) for kk, vv in v.items()} for k, v in rig.items()}


def demo_pose_bank(cfg: Config) -> List[dict]:
    """The 2000-pose bank of `cfg`'s joint set."""
    return make_pose_bank(2000, skeleton=SKELETON_OF[cfg.DATASET.NUM_JOINTS])


def write_calibration(path: str, cams: Dict[str, dict]) -> None:
    """Write a make_rig rig as a flat calibration JSON file."""
    with open(path, "w") as f:
        json.dump(cams, f, indent=1)
