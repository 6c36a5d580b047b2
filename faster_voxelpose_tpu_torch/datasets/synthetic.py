"""Synthetic training and held-out scenes (counterpart of
`faster_voxelpose_tpu/datasets/synthetic.py`, reference
lib/dataset/synthetic.py): 1..MAX_PEOPLE poses from a pose bank, placed
at random positions and rotations in the capture space with a retry loop
that keeps bboxes in bounds, every person visible from >= 2 cameras and
pairwise IoU near zero.  The 'gt' source's heatmaps are rendered on the
host, or on the device from their Gaussian parameters where
DATASET.DEVICE_RENDER is set.  The draws follow the JAX package's
order, so one seed gives the same scenes in both packages.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from ..config import Config
from ..geometry.cameras import project_points_np
from ..geometry.transforms import rotate_points
from .base import FrameRecord, PoseDatasetBase, root_center
from .evaluate import panoptic_metrics


def load_cameras(path: str) -> Dict[int, dict]:
    """{cam_id: {R, T, fx, fy, cx, cy, k, p}} from a .json or .pkl file."""
    ext = os.path.splitext(path)[1]
    if ext == ".json":
        with open(path) as f:
            cams = json.load(f)
    elif ext == ".pkl":
        with open(path, "rb") as f:
            cams = pickle.load(f)
    else:
        raise ValueError(f"unsupported calibration format: {path}")
    return {int(cam_id): {k: np.array(v) for k, v in cam.items()}
            for cam_id, cam in cams.items()}


class SyntheticDataset(PoseDatasetBase):
    """reference Synthetic (synthetic.py:25-194).  The scenes come from
    `seed`: by default cfg.TRAIN.SEED for the training set and
    cfg.TRAIN.SEED + 10007 for the held-out set (`is_train` false), so the
    two never share a scene.  `pose_bank` and `cameras` default to the
    files named by cfg.SYNTHETIC under cfg.DATASET.DATADIR."""

    def __init__(
        self,
        cfg: Config,
        is_train: bool = True,
        pose_bank: Optional[List[dict]] = None,
        cameras: Optional[Dict[int, dict]] = None,
        seed: Optional[int] = None,
    ):
        super().__init__(cfg, is_train)
        if seed is None:
            seed = cfg.TRAIN.SEED if is_train else cfg.TRAIN.SEED + 10007
        self.heatmap_src = "gt"
        self.data_augmentation = cfg.SYNTHETIC.DATA_AUGMENTATION
        self.max_synthetic_people = cfg.SYNTHETIC.MAX_PEOPLE
        self.num_data = cfg.SYNTHETIC.NUM_DATA
        self._gen_rng = np.random.RandomState(seed)

        if cameras is None:
            cameras = load_cameras(os.path.join(cfg.DATASET.DATADIR, cfg.SYNTHETIC.CAMERA_FILE))
        self.cameras = {"synthetic": cameras}
        if pose_bank is None:
            with open(os.path.join(cfg.DATASET.DATADIR, cfg.SYNTHETIC.POSE_FILE), "rb") as f:
                pose_bank = pickle.load(f)
        self.pose_bank = pose_bank

        cs = cfg.CAPTURE_SPEC
        self.x_min = cs.SPACE_CENTER[0] - cs.SPACE_SIZE[0] / 2.0
        self.x_max = cs.SPACE_CENTER[0] + cs.SPACE_SIZE[0] / 2.0
        self.y_min = cs.SPACE_CENTER[1] - cs.SPACE_SIZE[1] / 2.0
        self.y_max = cs.SPACE_CENTER[1] + cs.SPACE_SIZE[1] / 2.0
        for _ in range(self.num_data):
            self.records.append(self._generate_scene())

    def _generate_scene(self) -> FrameRecord:
        rng = self._gen_rng
        nposes = rng.choice(range(self.max_synthetic_people)) + 1
        picks = rng.choice(len(self.pose_bank), nposes)
        joints = np.array([self.pose_bank[i]["pose"] for i in picks], dtype=np.float64)
        vis = np.array([self.pose_bank[i]["vis"][:, -1] for i in picks], dtype=np.float64)

        bboxes: List[np.ndarray] = []
        centers: List[np.ndarray] = []
        for n in range(nposes):
            pts = joints[n][:, :2].copy()
            center = root_center(joints[n][None], self.root_id)[0][:2]
            rotation = rng.uniform(-180, 180)
            placed = False
            for _ in range(100):
                new_center = self._random_center(centers)
                xy = rotate_points(pts, center, rotation) - center + new_center
                bbox = self._bbox(xy, vis[n])
                if self._placement_valid(new_center, bbox, bboxes):
                    placed = True
                    break
            if not placed:
                joints = joints[:n]
                vis = vis[:n]
                break
            centers.append(new_center)
            bboxes.append(bbox)
            joints[n][:, :2] = xy
        return FrameRecord(seq="synthetic", joints_3d=joints, joints_3d_vis=vis)

    def _random_center(self, centers: List[np.ndarray]) -> np.ndarray:
        rng = self._gen_rng
        if not centers or rng.random_sample() < 0.7:
            return np.array(
                [rng.uniform(self.x_min, self.x_max), rng.uniform(self.y_min, self.y_max)]
            )
        base = centers[rng.choice(len(centers))]
        return base + rng.normal(500, 50, 2) * rng.choice([1, -1], 2)

    def evaluate(self, preds: np.ndarray):
        """(mean AP, message) of preds (N, K, J, 5) over the generated
        scenes, by the Panoptic protocol."""
        gts = [(rec.joints_3d, rec.joints_3d_vis) for rec in self.records]
        metric, msg, _ = panoptic_metrics(list(preds), gts)
        return metric, msg

    @staticmethod
    def _bbox(pose_xy: np.ndarray, vis: np.ndarray) -> np.ndarray:
        idx = vis > 0
        return np.array([pose_xy[idx, 0].min(), pose_xy[idx, 1].min(),
                         pose_xy[idx, 0].max(), pose_xy[idx, 1].max()])

    def _placement_valid(self, new_center, bbox, bbox_list) -> bool:
        """In bounds, visible from >= 2 cameras at 1 m height, IoU < 0.01
        with the people already placed (reference isvalid,
        synthetic.py:157-186)."""
        if (bbox[0] < self.x_min or bbox[1] < self.y_min
                or bbox[2] > self.x_max or bbox[3] > self.y_max):
            return False
        rig = self.packed_rig("synthetic")
        point = np.concatenate([new_center, [1000.0]])[None]
        w, h = self.ori_image_size
        vis_count = 0
        for c in range(rig.shape[0]):
            uv = project_points_np(point, rig[c])[0]
            if 10 < uv[0] < w - 10 and 10 < uv[1] < h - 10:
                vis_count += 1
        if not bbox_list:
            return vis_count >= 2
        bl = np.array(bbox_list)
        x0 = np.maximum(bbox[0], bl[:, 0])
        y0 = np.maximum(bbox[1], bl[:, 1])
        x1 = np.minimum(bbox[2], bl[:, 2])
        y1 = np.minimum(bbox[3], bl[:, 3])
        inter = np.maximum(0, (x1 - x0) * (y1 - y0))
        area = (bbox[2] - bbox[0]) * (bbox[3] - bbox[1])
        areas = (bl[:, 2] - bl[:, 0]) * (bl[:, 3] - bl[:, 1])
        iou = inter / (area + areas - inter)
        return vis_count >= 2 and float(np.max(iou)) < 0.01
