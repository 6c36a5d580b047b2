"""Per-view 2D joint heatmaps of a scene, as a 2D pose detector hands
them over (frozen copy of the repo's Gaussian rendering, without its
training-time augmentation): each joint seen in the view is a Gaussian at
its pixel on the heatmap grid, its deviation SIGMA scaled by the
person's size in the view (sqrt(extent^2 / 96^2 * 2), the extent clipped
to [48, 192] heatmap pixels), cut at 3 deviations, people combined by
max, values in [0, 1]."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .rig import project_np


def render_view(joints_2d: np.ndarray, visible: np.ndarray, heatmap_size: Sequence[int],
                sigma: float) -> np.ndarray:
    """joints_2d (P, J, 2) heatmap pixels, visible (P, J) -> (H, W, J)."""
    W, H = heatmap_size
    P, J = visible.shape
    out = np.zeros((H, W, J), np.float32)
    for p in range(P):
        ext = joints_2d[p].max(0) - joints_2d[p].min(0)
        scale2 = 2 * float(np.clip(ext.max() ** 2, 96 ** 2 / 4.0, 4 * 96 ** 2))
        s = sigma * np.sqrt(scale2 / 96.0 ** 2)
        r = int(3 * s)
        for j in np.flatnonzero(visible[p]):
            mx, my = (int(v) for v in joints_2d[p, j])
            x0, x1, y0, y1 = max(mx - r, 0), min(mx + r + 1, W), max(my - r, 0), min(my + r + 1, H)
            if x0 >= x1 or y0 >= y1:
                continue
            xs = np.arange(x0, x1, dtype=np.float32) - mx
            ys = np.arange(y0, y1, dtype=np.float32)[:, None] - my
            g = np.exp(-(xs ** 2 + ys ** 2) / (2 * s * s))
            np.maximum(out[y0:y1, x0:x1, j], g, out=out[y0:y1, x0:x1, j])
    return out


def render_scene(people: np.ndarray, rig: np.ndarray, affine: np.ndarray,
                 ori_image_size: Sequence[int], image_size: Sequence[int],
                 heatmap_size: Sequence[int], sigma: float, noise_px: float,
                 rng: np.random.Generator) -> np.ndarray:
    """(V, H, W, J) float32 heatmaps of people (P, J, 3) mm in every view:
    projected, moved into the input frame by `affine` (2x3), jittered by
    N(0, noise_px) input pixels as a detector's keypoints are, kept where
    inside both frames."""
    stride = np.asarray(image_size, np.float64) / np.asarray(heatmap_size, np.float64)
    P, J, _ = people.shape
    views = []
    for cam in rig:
        uv = project_np(people.reshape(-1, 3), cam).reshape(P, J, 2)
        in_ori = ((uv >= 0) & (uv <= np.asarray(ori_image_size) - 1)).all(-1)
        uv = uv @ affine[:, :2].T + affine[:, 2] + rng.normal(0, noise_px, uv.shape)
        in_img = ((uv >= 0) & (uv < np.asarray(image_size))).all(-1)
        views.append(render_view(uv / stride, in_ori & in_img, heatmap_size, sigma))
    return np.stack(views)
