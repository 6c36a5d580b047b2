"""Pinhole camera model with radial + tangential distortion (PyTorch).

Counterpart of `faster_voxelpose_tpu/geometry/cameras.py`: cameras are
packed into flat (21,) float arrays so that a rig is one (V, 21) tensor,
and the projector is written on top of that layout.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

# Packed camera layout: 21 floats.
#   [0:9]   R (row-major 3x3 world->cam rotation)
#   [9:12]  T (camera center in world coords, mm)
#   [12:14] f (fx, fy)
#   [14:16] c (cx, cy)
#   [16:19] k (radial k1, k2, k3)
#   [19:21] p (tangential p1, p2)
CAM_PARAM_DIM = 21


def pack_camera(camera: Dict) -> np.ndarray:
    """Pack a camera dict {R,T,fx,fy,cx,cy,k,p} into a flat (21,) float64
    array."""
    out = np.zeros(CAM_PARAM_DIM, dtype=np.float64)
    out[0:9] = np.asarray(camera["R"], dtype=np.float64).reshape(9)
    out[9:12] = np.asarray(camera["T"], dtype=np.float64).reshape(3)
    out[12] = np.float64(np.asarray(camera["fx"]).reshape(()))
    out[13] = np.float64(np.asarray(camera["fy"]).reshape(()))
    out[14] = np.float64(np.asarray(camera["cx"]).reshape(()))
    out[15] = np.float64(np.asarray(camera["cy"]).reshape(()))
    out[16:19] = np.asarray(camera["k"], dtype=np.float64).reshape(3)
    out[19:21] = np.asarray(camera["p"], dtype=np.float64).reshape(2)
    return out


def pack_rig(cameras: Sequence[Dict]) -> np.ndarray:
    """Pack a list of per-view camera dicts into a (V, 21) array."""
    return np.stack([pack_camera(c) for c in cameras], axis=0)


def project_points(x: torch.Tensor, cams: torch.Tensor) -> torch.Tensor:
    """World points (..., N, 3) -> pixels (..., N, 2) for packed cameras
    (..., 21); leading dims broadcast, so (N, 3) with (V, 21) projects
    into every view at once, giving (V, N, 2).

    The 3x3 rotation stays explicit multiply-adds: a matmul may run in
    reduced precision (TF32 on the card), which costs millimetres on
    mm-scale world coordinates.  The op order follows the JAX package's
    `project_points` so that both round alike."""
    c = [cams[..., i, None] for i in range(CAM_PARAM_DIM)]
    x0, x1, x2 = x[..., 0] - c[9], x[..., 1] - c[10], x[..., 2] - c[11]
    xc0 = x0 * c[0] + x1 * c[1] + x2 * c[2]
    xc1 = x0 * c[3] + x1 * c[4] + x2 * c[5]
    xc2 = x0 * c[6] + x1 * c[7] + x2 * c[8]
    y0 = xc0 / (xc2 + 1e-5)
    y1 = xc1 / (xc2 + 1e-5)

    r2 = y0 * y0 + y1 * y1
    d = 1 + c[16] * r2 + c[17] * r2 * r2 + c[18] * r2 * r2 * r2
    u = y0 * d + 2 * c[19] * y0 * y1 + c[20] * (r2 + 2 * y0 * y0)
    v = y1 * d + 2 * c[20] * y0 * y1 + c[19] * (r2 + 2 * y1 * y1)
    return torch.stack([u * c[12] + c[14], v * c[13] + c[15]], dim=-1)


def project_points_np(x: np.ndarray, packed_cam: np.ndarray) -> np.ndarray:
    """World (N, 3) -> pixels (N, 2) for one packed camera, numpy float64
    on the host (dataset building, synthetic visibility checks); the
    reference's project_point_cpu (cameras.py:58-84), 1e-5 depth epsilon
    included."""
    p = np.asarray(packed_cam, dtype=np.float64)
    R = p[0:9].reshape(3, 3)
    T = p[9:12].reshape(3, 1)
    f = p[12:14].reshape(2, 1)
    c = p[14:16].reshape(2, 1)
    k = p[16:19]
    tp = p[19:21]
    xcam = R @ (np.asarray(x, dtype=np.float64).T - T)  # (3, N)
    y = xcam[:2] / (xcam[2] + 1e-5)
    r2 = np.sum(y**2, axis=0)
    d = 1 + k[0] * r2 + k[1] * r2 * r2 + k[2] * r2 * r2 * r2
    u = y[0] * d + 2 * tp[0] * y[0] * y[1] + tp[1] * (r2 + 2 * y[0] * y[0])
    v = y[1] * d + 2 * tp[1] * y[0] * y[1] + tp[0] * (r2 + 2 * y[1] * y[1])
    return (f * np.stack([u, v], axis=0) + c).T
