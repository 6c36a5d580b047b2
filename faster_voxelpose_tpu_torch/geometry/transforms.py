"""2D affine transforms between original-image / network-input / heatmap
coordinate frames (numpy; counterpart of
`faster_voxelpose_tpu/geometry/transforms.py`).  The 3-point affine
estimation is a closed-form linear solve, so no OpenCV is needed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _get_dir(src_point, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array(
        [src_point[0] * cs - src_point[1] * sn, src_point[0] * sn + src_point[1] * cs],
        dtype=np.float64,
    )


def _get_3rd_point(a, b):
    direct = np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)
    return np.asarray(b, dtype=np.float64) + np.array([-direct[1], direct[0]])


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact 2x3 affine mapping three src points onto three dst points
    (the numpy equivalent of cv2.getAffineTransform)."""
    A = np.concatenate([src, np.ones((3, 1))], axis=1)  # (3, 3)
    # Solve A @ M.T = dst  ->  M = (A^-1 @ dst).T
    M = np.linalg.solve(A, dst).T  # (2, 3)
    return M


def get_affine_transform(center, scale, rot: float, output_size: Sequence[int]) -> np.ndarray:
    """Affine from a (center, scale*200px, rot) crop box to output_size.

    Semantics match reference get_affine_transform (transforms.py:15-50):
    the longer box side maps onto the matching output side.
    """
    center = np.asarray(center, dtype=np.float64)
    scale_tmp = np.asarray(scale, dtype=np.float64) * 200.0
    src_w, src_h = scale_tmp[0], scale_tmp[1]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    if src_w >= src_h:
        src_dir = _get_dir([0, src_w * -0.5], rot_rad)
        dst_dir = np.array([0, dst_w * -0.5], dtype=np.float64)
    else:
        src_dir = _get_dir([src_h * -0.5, 0], rot_rad)
        dst_dir = np.array([dst_h * -0.5, 0], dtype=np.float64)

    src = np.zeros((3, 2), dtype=np.float64)
    dst = np.zeros((3, 2), dtype=np.float64)
    src[0] = center
    src[1] = center + src_dir
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir
    src[2] = _get_3rd_point(src[0], src[1])
    dst[2] = _get_3rd_point(dst[0], dst[1])
    return _solve_affine(src, dst)


def get_scale(image_size, resized_size) -> np.ndarray:
    """Aspect-preserving pad-then-resize scale (reference transforms.py:81-92)."""
    w, h = float(image_size[0]), float(image_size[1])
    w_resized, h_resized = float(resized_size[0]), float(resized_size[1])
    if w / w_resized < h / h_resized:
        w_pad = h / h_resized * w_resized
        h_pad = h
    else:
        w_pad = w
        h_pad = w / w_resized * h_resized
    return np.array([w_pad / 200.0, h_pad / 200.0], dtype=np.float64)


def get_resize_transform(ori_image_size, image_size) -> np.ndarray:
    """The original-image -> network-input affine used across the pipeline
    (reference JointsDataset._get_resize_transform, JointsDataset.py:51-56)."""
    c = np.array([ori_image_size[0] / 2.0, ori_image_size[1] / 2.0])
    s = get_scale(ori_image_size, image_size)
    return get_affine_transform(c, s, 0, image_size)


def affine_transform(pt, t: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to one 2D point (reference transforms.py:53-56)."""
    new_pt = np.array([pt[0], pt[1], 1.0], dtype=np.float64)
    return (t @ new_pt)[:2]


def affine_transform_points(pts: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to (N, 2) points."""
    return pts @ t[:, :2].T + t[:, 2]


def rotate_points(points: np.ndarray, center: np.ndarray, rot_deg: float) -> np.ndarray:
    """Rotate (N, 2) points around center by rot_deg degrees (reference
    transforms.py:95-108; the synthetic scene generator uses it)."""
    rot_rad = rot_deg * np.pi / 180.0
    rot = np.array(
        [[np.cos(rot_rad), -np.sin(rot_rad)], [np.sin(rot_rad), np.cos(rot_rad)]]
    )
    center = np.asarray(center, dtype=np.float64).reshape(1, 2)
    return (points - center) @ rot.T + center
