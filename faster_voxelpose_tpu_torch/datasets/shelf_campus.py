"""The Shelf and Campus test datasets of the port (counterpart of
`faster_voxelpose_tpu/datasets/shelf_campus.py`, reference
lib/dataset/shelf.py and campus.py): test-only frame ranges, precomputed
Mask R-CNN + HRNet COCO-17 2D pose predictions as the heatmap source
('pred', rendered on the host), actorsGT.mat 3D ground truth, the flat
{cam_id: {R, T, fx, fy, cx, cy, k, p}} calibration, and PCP3D evaluation
(`datasets/evaluate.py`, with the COCO -> Shelf / Campus remapping).
`scipy.io` is imported when a ground-truth file is read.
"""

from __future__ import annotations

import json
import logging
import os.path as osp
import pickle
from typing import Dict, List, Tuple

import numpy as np

from ..config import Config
from .base import FrameRecord, PoseDatasetBase
from .evaluate import coco_to_campus_pose, coco_to_shelf_pose, pcp3d_metrics

logger = logging.getLogger(__name__)

SHELF_FRAME_RANGE = list(range(300, 601))
CAMPUS_FRAME_RANGE = list(range(350, 471)) + list(range(650, 751))


def load_flat_calibration(path: str) -> Dict[int, dict]:
    """{cam_id: {R, T, fx, fy, cx, cy, k, p}} JSON (reference
    shelf.py:138-153)."""
    with open(path) as f:
        cameras = json.load(f)
    return {
        int(cam_id): {k: np.array(v) for k, v in cam.items()}
        for cam_id, cam in cameras.items()
    }


def load_actors_gt(path: str):
    """actorsGT.mat -> per actor, per frame, a (14, 3) array in metres
    (an empty entry where the actor is absent)."""
    import scipy.io as scio

    actor_3d = scio.loadmat(path)["actor3D"]
    return np.array(np.array(actor_3d.tolist()).tolist(), dtype=object).squeeze()


class _PredHeatmapDataset(PoseDatasetBase):
    """What Shelf and Campus share: heatmaps rendered at the 2D
    predictions, GT from actorsGT.mat for evaluation only (the model
    outputs COCO-17, the GT is the datasets' 14 joints, so no supervision
    is built), PCP3D evaluation."""

    SEQ: str = ""
    FRAME_RANGE: List[int] = []
    PRED_FILE: str = ""
    CALIB_FILE: str = ""
    NUM_GT_JOINTS = 14
    REMAP = None

    def __init__(self, cfg: Config, is_train: bool = False):
        super().__init__(cfg, is_train)
        ddir = cfg.DATASET.DATADIR
        self.cameras = {self.SEQ: load_flat_calibration(osp.join(ddir, self.CALIB_FILE))}
        with open(osp.join(ddir, self.PRED_FILE), "rb") as f:
            pred_2d = pickle.load(f)
        self.actor_3d = load_actors_gt(osp.join(ddir, "actorsGT.mat"))
        self.used_frames: List[int] = []

        for fi in self.FRAME_RANGE:
            all_preds = []
            for cam in range(self.num_views):
                key = f"{cam}_{fi}"
                if key not in pred_2d:
                    all_preds = None
                    break
                all_preds.append([np.array(p["pred"]) for p in pred_2d[key]])
            if all_preds is None:
                continue
            self.records.append(FrameRecord(seq=self.SEQ, pred_pose2d=all_preds))
            self.used_frames.append(fi)
        logger.info("=> %d %s frames loaded from %d views", len(self.records), self.SEQ,
                    self.num_views)

    def evaluate(self, preds: np.ndarray) -> Tuple[float, str]:
        """(PCP3D average, message) of preds (N, K, J, 5) in COCO order
        against the actors' GT of the used frames."""
        actor_gt = [[np.asarray(actor[fi] * 1000.0) for actor in self.actor_3d]
                    for fi in self.used_frames]
        metric, msg, _ = pcp3d_metrics(list(preds), actor_gt, self.REMAP)
        return metric, msg


class ShelfDataset(_PredHeatmapDataset):
    SEQ = "shelf"
    FRAME_RANGE = SHELF_FRAME_RANGE
    PRED_FILE = "pred_shelf_maskrcnn_hrnet_coco.pkl"
    CALIB_FILE = "calibration_shelf.json"
    REMAP = staticmethod(coco_to_shelf_pose)


class CampusDataset(_PredHeatmapDataset):
    SEQ = "campus"
    FRAME_RANGE = CAMPUS_FRAME_RANGE
    PRED_FILE = "pred_campus_maskrcnn_hrnet_coco.pkl"
    CALIB_FILE = "calibration_campus.json"
    REMAP = staticmethod(coco_to_campus_pose)
