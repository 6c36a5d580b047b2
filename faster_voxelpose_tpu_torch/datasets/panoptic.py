"""The CMU Panoptic dataset of the port (counterpart of
`faster_voxelpose_tpu/datasets/panoptic.py`, reference
lib/dataset/panoptic.py): 9 train / 4 val sequences,
15-joint skeleton, HD cameras (0,3),(0,6),(0,12),(0,13),(0,23), frame
subsampling 3 (train) / 12 (val), per-sequence calibration with the
y/z axis swap and T = -R^T t * 10 cm->mm conversion, pose coords x10 to
millimeters, a pickled record cache
(`<image_set>_records_torch.pkl` beside the sequences), and the
AP/recall/MPJPE evaluation protocol (datasets/evaluate.py).  With the
'image' source each sample holds the views' uint8 frames.
"""

from __future__ import annotations

import glob
import json
import logging
import os.path as osp
import pickle
from typing import List, Tuple

import numpy as np

from ..config import Config
from .base import FrameRecord, PoseDatasetBase
from .evaluate import panoptic_metrics

logger = logging.getLogger(__name__)

TRAIN_SEQUENCES = [
    "160422_ultimatum1",
    "160224_haggling1",
    "160226_haggling1",
    "161202_haggling1",
    "160906_ian1",
    "160906_ian2",
    "160906_ian3",
    "160906_band1",
    "160906_band2",
]
VAL_SEQUENCES = [
    "160906_pizza1",
    "160422_haggling1",
    "160906_ian5",
    "160906_band4",
]

JOINT_NAMES = [
    "neck", "nose", "mid-hip",
    "l-shoulder", "l-elbow", "l-wrist", "l-hip", "l-knee", "l-ankle",
    "r-shoulder", "r-elbow", "r-wrist", "r-hip", "r-knee", "r-ankle",
]

BONES = [
    [0, 1], [0, 2],
    [0, 3], [3, 4], [4, 5],
    [0, 9], [9, 10], [10, 11],
    [2, 6], [6, 7], [7, 8],
    [2, 12], [12, 13], [13, 14],
]

HD_CAMERA_LIST = [(0, 3), (0, 6), (0, 12), (0, 13), (0, 23)]

# Panoptic world frame -> ours: swap y up-axis (panoptic.py:151-153)
_AXIS_SWAP = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])


def load_panoptic_calibration(path: str, cam_list) -> List[dict]:
    """Per-sequence calibration JSON -> reference-format camera dicts
    (panoptic.py:171-205)."""
    with open(path) as f:
        calib = json.load(f)
    cams = []
    for cam in calib["cameras"]:
        if (cam["panel"], cam["node"]) in cam_list:
            K = np.array(cam["K"])
            dist = np.array(cam["distCoef"]).ravel()
            R = np.array(cam["R"]) @ _AXIS_SWAP
            t = np.array(cam["t"]).reshape(3, 1)
            cams.append(
                {
                    "R": R,
                    "T": -R.T @ t * 10.0,  # cm -> mm, camera center in world
                    "fx": K[0, 0],
                    "fy": K[1, 1],
                    "cx": K[0, 2],
                    "cy": K[1, 2],
                    "k": dist[[0, 1, 4]].reshape(3, 1),
                    "p": dist[[2, 3]].reshape(2, 1),
                }
            )
    return cams


class PanopticDataset(PoseDatasetBase):
    def __init__(self, cfg: Config, is_train: bool = True):
        super().__init__(cfg, is_train)
        self.cam_list = HD_CAMERA_LIST[: self.num_views]
        if is_train:
            self.image_set, self.sequences, self.interval = (
                "train", TRAIN_SEQUENCES, 3,
            )
        else:
            self.image_set, self.sequences, self.interval = (
                "validation", VAL_SEQUENCES, 12,
            )

        self.cameras = {
            seq: load_panoptic_calibration(
                osp.join(self.dataset_dir(), seq, f"calibration_{seq}.json"),
                self.cam_list,
            )
            for seq in self.sequences
            if osp.exists(osp.join(self.dataset_dir(), seq, f"calibration_{seq}.json"))
        }

        # a name of its own: the JAX package's cache pickles its own
        # FrameRecord class, which the port must not import
        cache = osp.join(self.dataset_dir(), f"{self.image_set}_records_torch.pkl")
        if osp.exists(cache):
            with open(cache, "rb") as f:
                info = pickle.load(f)
            if info["sequences"] != self.sequences or info["interval"] != self.interval:
                raise ValueError(f"{cache} holds the records of sequences {info['sequences']} "
                                 f"at interval {info['interval']}, not of {self.sequences} at "
                                 f"{self.interval}: remove it to rebuild")
            self.records = info["records"]
        else:
            self._build_records()
            with open(cache, "wb") as f:
                pickle.dump(
                    {
                        "sequences": self.sequences,
                        "interval": self.interval,
                        "records": self.records,
                    },
                    f,
                )
        logger.info("=> %d panoptic frames loaded", len(self.records))

    def dataset_dir(self) -> str:
        return self.cfg.DATASET.DATADIR

    def _build_records(self):
        for seq in self.sequences:
            anno_dir = osp.join(self.dataset_dir(), seq, "hdPose3d_stage1_coco19")
            for i, anno_file in enumerate(sorted(glob.iglob(f"{anno_dir}/*.json"))):
                if i % self.interval:
                    continue
                with open(anno_file) as f:
                    bodies = json.load(f)["bodies"]
                if not bodies:
                    continue

                image_paths = []
                missing = False
                suffix = osp.basename(anno_file).replace("body3DScene", "")
                for panel, node in self.cam_list:
                    prefix = f"{panel:02d}_{node:02d}"
                    p = osp.join(
                        self.dataset_dir(), seq, "hdImgs", prefix,
                        (prefix + suffix).replace("json", "jpg"),
                    )
                    if not osp.exists(p):
                        logger.info("Image not found: %s. Skipped.", p)
                        missing = True
                        break
                    image_paths.append(p)
                if missing:
                    continue

                poses, viss = [], []
                for body in bodies:
                    pose = np.array(body["joints19"]).reshape(-1, 4)[: self.num_joints]
                    vis = np.maximum(pose[:, -1], 0.0)
                    root_vis = (
                        vis[self.root_id]
                        if isinstance(self.root_id, int)
                        else min(vis[j] for j in self.root_id)
                    )
                    if root_vis <= 0.1:
                        continue
                    xyz = pose[:, :3] @ _AXIS_SWAP * 10.0  # cm -> mm
                    poses.append(xyz)
                    viss.append(vis)
                if poses:
                    self.records.append(
                        FrameRecord(
                            seq=seq,
                            joints_3d=np.stack(poses),
                            joints_3d_vis=np.stack(viss),
                            image_paths=image_paths,
                        )
                    )

    def evaluate(self, preds: np.ndarray) -> Tuple[float, str]:
        """preds: (N, K, J, 5) fused poses; protocol from panoptic.py:214-265."""
        gts = [
            (rec.joints_3d, rec.joints_3d_vis)
            for rec in self.records
        ]
        if len(preds) != len(gts):
            raise ValueError(f"{len(preds)} predictions for {len(gts)} records")
        metric, msg, _ = panoptic_metrics(list(preds), gts)
        return metric, msg
