"""Dataset foundations of the port (counterpart of
`faster_voxelpose_tpu/datasets/base.py`, reference
lib/dataset/JointsDataset.py): frame records, supervision targets and
the three heatmap sources.

Every sample is a dict of fixed-shape numpy arrays padded to MAX_PEOPLE,
and `collate` stacks them, so that one seed gives the JAX package's
samples and batches: the augmentation draws run on the same
`np.random.RandomState` in the same order.  The sources:
- 'gt': the GT poses projected into each view; with DEVICE_RENDER the
  sample holds the Gaussians' parameters ('hm_params', rendered in the
  step by `ops/heatmap_render.py`), without it heatmaps rendered on the
  host ('input_heatmaps');
- 'pred': heatmaps rendered on the host at precomputed 2D pose
  predictions ('input_heatmaps');
- 'image': the views' frames, decoded and warped on the host and shipped
  as uint8 ('images'; the step normalises them on the device).
Host rendering runs the native renderer (`native/render.cpp`), built at
first use; `_render_joints_numpy` is its plain version, for tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..config import Config
from ..geometry.cameras import pack_rig, project_points_np
from ..geometry.transforms import affine_transform_points, get_resize_transform


def root_center(joints: np.ndarray, root_id: Union[int, Sequence[int]]) -> np.ndarray:
    """Per-person root position: one joint or the mean of two
    (reference JointsDataset.py:87-90)."""
    if isinstance(root_id, int):
        return joints[..., root_id, :]
    return np.mean([joints[..., j, :] for j in root_id], axis=0)


@dataclasses.dataclass
class FrameRecord:
    """One multi-view frame: ground truth (optional), precomputed 2D pose
    predictions (optional), image paths (optional)."""

    seq: str
    joints_3d: Optional[np.ndarray] = None  # (P, J, 3) mm
    joints_3d_vis: Optional[np.ndarray] = None  # (P, J)
    pred_pose2d: Optional[list] = None  # per view: list of (J2d, 3) arrays
    image_paths: Optional[List[str]] = None


class PoseDatasetBase:
    """Shared machinery of the datasets: subclasses fill self.records and
    self.cameras (seq -> list or {cam_id: camera dict})."""

    def __init__(self, cfg: Config, is_train: bool):
        self.cfg = cfg
        self.is_train = is_train
        self.root_id = cfg.DATASET.ROOT_JOINT_ID
        self.max_people = cfg.CAPTURE_SPEC.MAX_PEOPLE
        self.num_views = cfg.DATASET.CAMERA_NUM
        self.num_joints = cfg.DATASET.NUM_JOINTS
        self.ori_image_size = np.array(cfg.DATASET.ORI_IMAGE_SIZE)
        self.image_size = np.array(cfg.DATASET.IMAGE_SIZE)
        self.heatmap_size = np.array(cfg.DATASET.HEATMAP_SIZE)
        self.sigma = cfg.NETWORK.SIGMA
        self.space_size = np.array(cfg.CAPTURE_SPEC.SPACE_SIZE)
        self.space_center = np.array(cfg.CAPTURE_SPEC.SPACE_CENTER)
        self.voxels_per_axis = np.array(cfg.CAPTURE_SPEC.VOXELS_PER_AXIS)
        self.individual_space_size = np.array(cfg.INDIVIDUAL_SPEC.SPACE_SIZE)
        self.heatmap_src = (
            cfg.DATASET.TRAIN_HEATMAP_SRC if is_train else cfg.DATASET.TEST_HEATMAP_SRC
        )
        self.data_augmentation = cfg.DATASET.DATA_AUGMENTATION
        self.resize_transform = get_resize_transform(
            cfg.DATASET.ORI_IMAGE_SIZE, cfg.DATASET.IMAGE_SIZE
        )
        self.records: List[FrameRecord] = []
        self.cameras: Dict[str, object] = {}
        self._packed_rigs: Dict[str, np.ndarray] = {}
        self._rng = np.random.RandomState(cfg.TRAIN.SEED)

    def packed_rig(self, seq: str) -> np.ndarray:
        if seq not in self._packed_rigs:
            cams = self.cameras[seq]
            if isinstance(cams, dict):  # {cam_id: cam} calibration format
                cams = [cams[k] for k in sorted(cams.keys())]
            self._packed_rigs[seq] = pack_rig(cams[: self.num_views]).astype(np.float32)
        return self._packed_rigs[seq]

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.records[idx]
        sample: Dict[str, np.ndarray] = {"cameras": self.packed_rig(rec.seq)}
        if self.heatmap_src == "pred":
            sample["input_heatmaps"] = self._heatmaps_from_preds(rec)
        elif self.heatmap_src == "gt":
            if self.cfg.DATASET.DEVICE_RENDER:
                sample["hm_params"] = self._heatmap_params_from_gt(rec)
            else:
                sample["input_heatmaps"] = self._heatmaps_from_gt(rec)
        elif self.heatmap_src == "image":
            from .images import load_view_images_u8

            sample["images"] = load_view_images_u8(rec.image_paths, self.image_size,
                                                   self.resize_transform)
        else:
            raise ValueError(f"unknown heatmap source {self.heatmap_src!r}; "
                             "have 'gt', 'pred' and 'image'")
        if rec.joints_3d is not None:
            sample.update(self._build_supervision(rec))
        return sample

    def _build_supervision(self, rec: FrameRecord) -> Dict[str, np.ndarray]:
        K, J = self.max_people, self.num_joints
        P = len(rec.joints_3d)
        if P > K:
            raise ValueError(f"{P} persons exceed MAX_PEOPLE={K}")
        joints_u = np.zeros((K, J, 3), np.float32)
        vis_u = np.zeros((K, J), np.float32)
        joints_u[:P] = np.asarray(rec.joints_3d)[:, :, :3]
        vis_u[:P] = np.asarray(rec.joints_3d_vis)
        roots = root_center(joints_u, self.root_id)  # (K, 3)
        tgt = self.generate_target(rec.joints_3d, rec.joints_3d_vis)
        return {
            "num_person": np.int32(P),
            "joints_3d": joints_u,
            "joints_3d_vis": vis_u,
            "roots_3d": roots.astype(np.float32),
            **tgt,
        }

    def generate_target(self, joints_3d, joints_3d_vis) -> Dict[str, np.ndarray]:
        """Supervision targets (reference generate_target,
        JointsDataset.py:205-269): BEV and per-person height Gaussians,
        GT center indices and bbox sizes."""
        K = self.max_people
        vx, vy, vz = self.voxels_per_axis
        space, center = self.space_size, self.space_center
        ind_size = self.individual_space_size
        voxel_size = space / (self.voxels_per_axis - 1)

        gx = np.linspace(-space[0] / 2, space[0] / 2, vx) + center[0]
        gy = np.linspace(-space[1] / 2, space[1] / 2, vy) + center[1]
        gz = np.linspace(-space[2] / 2, space[2] / 2, vz) + center[2]

        index = np.zeros(K, np.float32)
        hm2d = np.zeros((vx, vy), np.float32)
        hm1d = np.zeros((K, vz), np.float32)
        bbox = np.zeros((K, 2), np.float32)
        offset = np.zeros((K, 2), np.float32)
        sigma_mm = 200.0

        num_people = len(joints_3d)
        for n in range(num_people):
            pose = np.asarray(joints_3d[n])
            vis_idx = np.asarray(joints_3d_vis[n]) > 0.1
            c = root_center(pose[None], self.root_id)[0]

            loc = (c - center + 0.5 * space) / voxel_size
            if not ((loc >= 0).all() and (loc <= self.voxels_per_axis).all()):
                raise ValueError("human centers out of bound!")
            index[n] = np.floor(loc[0]) * vy + np.floor(loc[1])
            offset[n] = (loc % 1)[:2]
            bbox[n] = ((2 * np.abs(c - pose[vis_idx]).max(axis=0) + 200.0) / ind_size)[:2]

            def span(g, m):
                return (np.searchsorted(g, m - 3 * sigma_mm),
                        np.searchsorted(g, m + 3 * sigma_mm, "right"))

            (x0, x1), (y0, y1), (z0, z1) = span(gx, c[0]), span(gy, c[1]), span(gz, c[2])
            if x0 >= x1 or y0 >= y1 or z0 >= z1:
                continue
            mgx, mgy = np.meshgrid(gx[x0:x1], gy[y0:y1], indexing="ij")
            g = np.exp(-((mgx - c[0]) ** 2 + (mgy - c[1]) ** 2) / (2 * sigma_mm**2))
            hm2d[x0:x1, y0:y1] = np.maximum(hm2d[x0:x1, y0:y1], g)
            g1 = np.exp(-((gz[z0:z1] - c[2]) ** 2) / (2 * sigma_mm**2))
            hm1d[n, z0:z1] = np.maximum(hm1d[n, z0:z1], g1)

        # `<=` keeps the reference's off-by-one mask, which marks
        # num_people + 1 slots valid (JointsDataset.py:266); the extra
        # slot carries zero targets
        mask = np.arange(K) <= num_people
        return {
            "index": index,
            "offset": offset,
            "bbox": bbox,
            "2d_heatmaps": np.clip(hm2d, 0, 1),
            "1d_heatmaps": np.clip(hm1d, 0, 1),
            "mask": mask,
        }

    def _human_scale(self, pose2d: np.ndarray, vis: np.ndarray) -> float:
        idx = vis > 0.1
        if np.sum(idx) == 0:
            return 0.0
        extent = max(
            pose2d[idx, 0].max() - pose2d[idx, 0].min(),
            pose2d[idx, 1].max() - pose2d[idx, 1].min(),
        )
        return float(np.clip(extent**2, 96**2 / 4.0, 4 * 96**2))

    def heatmap_instances(self, joints_2d: list, joints_vis: Optional[list] = None):
        """The Gaussians of one view as the host renderer takes them:
        (H, W, J, mu (M, 2) int32, joint_id (M,) int32, sigma, tmp_size,
        scale (M,) float32, occl (M, 4) int32).  joints_2d: per person
        (J, >=2) pixel coords in the input-image frame.  Scale-adaptive
        sigma, the reference's instance gating, and the augmentation draws
        (`_augment_params`) in the JAX package's order."""
        W, H = self.heatmap_size
        J = joints_2d[0].shape[0] if joints_2d else self.num_joints
        stride = self.image_size / self.heatmap_size
        mu, joint_id, sigmas, tmps, scales, occls = [], [], [], [], [], []
        for n in range(len(joints_2d)):
            scale2 = 2 * self._human_scale(joints_2d[n][:, :2] / stride, np.ones(J))
            if scale2 == 0:
                continue
            cur_sigma = self.sigma * np.sqrt(scale2 / (96.0 * 96.0))
            tmp = cur_sigma * 3
            for j in range(J):
                if joints_vis is not None and joints_vis[n][j] == 0:
                    continue
                mu_x = int(joints_2d[n][j][0] / stride[0])
                mu_y = int(joints_2d[n][j][1] / stride[1])
                if (int(mu_x - tmp) >= W or int(mu_y - tmp) >= H
                        or int(mu_x + tmp + 1) < 0 or int(mu_y + tmp + 1) < 0):
                    continue
                scale, occl = self._augment_params(j)
                mu.append((mu_x, mu_y))
                joint_id.append(j)
                sigmas.append(cur_sigma)
                tmps.append(tmp)
                scales.append(scale)
                occls.append(occl)
        return (int(H), int(W), int(J), np.asarray(mu, np.int32).reshape(-1, 2),
                np.asarray(joint_id, np.int32), np.asarray(sigmas, np.float32),
                np.asarray(tmps, np.float32), np.asarray(scales, np.float32),
                np.asarray(occls, np.int32).reshape(-1, 4))

    def render_heatmap(self, joints_2d: list, joints_vis: Optional[list] = None) -> np.ndarray:
        """Per-joint Gaussians of one view, (H, W, J) channels-last, by the
        native renderer (`native/render.cpp`; reference
        generate_input_heatmap, JointsDataset.py:271-338).  Its plain
        version is `_render_joints_numpy(*self.heatmap_instances(...))`."""
        from ..native.build import render_joints_native

        return render_joints_native(*self.heatmap_instances(joints_2d, joints_vis))

    def _augment_params(self, joint_id: int):
        """Augmentation of one joint instance: magnitude scale and an
        occlusion rectangle [y0, y1, x0, x1) of its local window
        (reference JointsDataset.py:306-324; 7/8 knees, 9/10 ankles of the
        Panoptic skeleton)."""
        if not self.data_augmentation:
            return 1.0, (0, 0, 0, 0)
        rng = self._rng
        scale = 0.9 + rng.randn() * 0.03 if rng.random_sample() < 0.6 else 1.0
        if joint_id in (7, 8):
            scale = scale * 0.5 if rng.random_sample() < 0.1 else scale
        elif joint_id in (9, 10):
            scale = scale * 0.2 if rng.random_sample() < 0.1 else scale
        else:
            scale = scale * 0.5 if rng.random_sample() < 0.05 else scale
        W, H = self.heatmap_size
        y0 = int(rng.uniform(0, H - 1))
        x0 = int(rng.uniform(0, W - 1))
        y1 = int(min(y0 + rng.uniform(H / 4, H * 0.75), H))
        x1 = int(min(x0 + rng.uniform(W / 4, W * 0.75), W))
        return float(scale), (y0, y1, x0, x1)

    def render_heatmap_params(
        self, joints_2d: list, joints_vis: Optional[list] = None
    ) -> np.ndarray:
        """Device-renderer parameters of one view's Gaussians,
        (MAX_PEOPLE, J, 12) float32 (layout in ops/heatmap_render.py), with
        the reference's instance gating and augmentation draws in order."""
        W, H = self.heatmap_size
        J = joints_2d[0].shape[0] if joints_2d else self.num_joints
        stride = self.image_size / self.heatmap_size
        K = self.max_people
        if len(joints_2d) > K:
            raise ValueError(
                f"render_heatmap_params: {len(joints_2d)} persons exceed "
                f"MAX_PEOPLE={K}; the device renderer cannot represent them"
            )
        out = np.zeros((K, J, 12), np.float32)
        for n in range(len(joints_2d)):
            scale2 = 2 * self._human_scale(joints_2d[n][:, :2] / stride, np.ones(J))
            if scale2 == 0:
                continue
            cur_sigma = self.sigma * np.sqrt(scale2 / (96.0 * 96.0))
            tmp = cur_sigma * 3
            for j in range(J):
                if joints_vis is not None and joints_vis[n][j] == 0:
                    continue
                mu_x = int(joints_2d[n][j][0] / stride[0])
                mu_y = int(joints_2d[n][j][1] / stride[1])
                if (int(mu_x - tmp) >= W or int(mu_y - tmp) >= H
                        or int(mu_x + tmp + 1) < 0 or int(mu_y + tmp + 1) < 0):
                    continue
                scale, occl = self._augment_params(j)
                ul_x, ul_y = int(mu_x - tmp), int(mu_y - tmp)
                br_x, br_y = int(mu_x + tmp + 1), int(mu_y + tmp + 1)
                c = (2 * tmp + 1) // 2  # the host renderer's window center
                y0, y1, x0, x1 = occl
                if y1 <= y0:
                    occl_img = (0.0, 0.0, 0.0, 0.0)
                else:
                    occl_img = (ul_x + x0, ul_x + x1, ul_y + y0, ul_y + y1)
                out[n, j] = (
                    ul_x + c, ul_y + c, 1.0 / (2.0 * cur_sigma * cur_sigma), scale,
                    max(0, ul_x), min(br_x, W), max(0, ul_y), min(br_y, H), *occl_img,
                )
        return out

    def _heatmap_params_from_gt(self, rec: FrameRecord) -> np.ndarray:
        """'gt' source, device-render mode: (V, MAX_PEOPLE, J, 12)."""
        return np.stack([self.render_heatmap_params(j2d, vis)
                         for j2d, vis in self._gt_joints_2d(rec)], axis=0)

    def _heatmaps_from_preds(self, rec: FrameRecord) -> np.ndarray:
        """'pred' source: Gaussians at precomputed 2D pose predictions
        mapped into the input-image frame, (V, H, W, J) (reference
        JointsDataset.py:144-154)."""
        views = []
        for preds in rec.pred_pose2d:
            mapped = [np.concatenate([affine_transform_points(p[:, :2], self.resize_transform),
                                      p[:, 2:]], axis=1) for p in preds]
            views.append(self.render_heatmap(mapped))
        return np.stack(views, axis=0)

    def _heatmaps_from_gt(self, rec: FrameRecord) -> np.ndarray:
        """'gt' source, host rendering: the GT poses projected into each
        view and rendered, (V, H, W, J)."""
        return np.stack([self.render_heatmap(j2d, vis)
                         for j2d, vis in self._gt_joints_2d(rec)], axis=0)

    def _gt_joints_2d(self, rec: FrameRecord):
        """Per view: (joints_2d, vis_2d) of the GT poses (reference
        JointsDataset.py:156-191); visibility combines GT visibility with
        in-frame checks in both image frames."""
        rig = self.packed_rig(rec.seq)
        out = []
        for c in range(self.num_views):
            joints_2d, vis_2d = [], []
            for n in range(len(rec.joints_3d)):
                pose = project_points_np(rec.joints_3d[n], rig[c])
                in_ori = ((pose[:, 0] >= 0) & (pose[:, 0] <= self.ori_image_size[0] - 1)
                          & (pose[:, 1] >= 0) & (pose[:, 1] <= self.ori_image_size[1] - 1))
                vis = (np.asarray(rec.joints_3d_vis[n]) > 0) & in_ori
                pose = affine_transform_points(pose, self.resize_transform)
                in_input = ((pose[:, 0] >= 0) & (pose[:, 1] >= 0)
                            & (pose[:, 0] < self.image_size[0])
                            & (pose[:, 1] < self.image_size[1]))
                joints_2d.append(pose)
                vis_2d.append(vis & in_input)
            out.append((joints_2d, vis_2d))
        return out

    def evaluate(self, preds: np.ndarray):
        """(metric, message) of preds (N, K, J, 5) against the records;
        each dataset brings its own protocol."""
        raise NotImplementedError


def _render_joints_numpy(H, W, J, mu, joint_id, sigmas, tmps, scales, occls) -> np.ndarray:
    """The plain version of `native/render.cpp`: the same windowed
    Gaussian, occlusion cut and max-accumulation in numpy, (H, W, J)
    clipped to [0, 1] (the JAX package's fallback renderer)."""
    out = np.zeros((H, W, J), np.float32)
    for m in range(mu.shape[0]):
        mu_x, mu_y = int(mu[m, 0]), int(mu[m, 1])
        tmp = float(tmps[m])
        ul = [int(mu_x - tmp), int(mu_y - tmp)]
        br = [int(mu_x + tmp + 1), int(mu_y + tmp + 1)]
        if ul[0] >= W or ul[1] >= H or br[0] < 0 or br[1] < 0:
            continue
        size = 2 * tmp + 1
        xs = np.arange(0, size, 1, np.float32)
        ys = xs[:, None]
        c = size // 2
        g = np.exp(-((xs - c) ** 2 + (ys - c) ** 2) / (2 * float(sigmas[m]) ** 2))
        g = g * scales[m]
        y0, y1, x0, x1 = occls[m]
        if y1 > y0:
            g[y0:y1, x0:x1] = 0.0
        gx = (max(0, -ul[0]), min(br[0], W) - ul[0])
        gy = (max(0, -ul[1]), min(br[1], H) - ul[1])
        ix = (max(0, ul[0]), min(br[0], W))
        iy = (max(0, ul[1]), min(br[1], H))
        j = int(joint_id[m])
        out[iy[0]:iy[1], ix[0]:ix[1], j] = np.maximum(
            out[iy[0]:iy[1], ix[0]:ix[1], j], g[gy[0]:gy[1], gx[0]:gx[1]])
    return np.clip(out, 0, 1)


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into batch arrays."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}
