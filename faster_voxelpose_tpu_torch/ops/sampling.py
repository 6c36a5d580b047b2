"""Bilinear heatmap sampling with grid_sample(align_corners=True,
padding_mode='zeros') semantics: the plain PyTorch version of the
sampling kernels (counterpart of `faster_voxelpose_tpu/ops/sampling.py`).

Coordinates here are heatmap pixels (x, y); `geometry.grids.norm_to_pixel`
maps the normalized align_corners=True frame onto them, as the JAX
package does before its sampling kernel.  Corners outside the image
weigh zero, which is zeros padding, so the result is exact for any
coordinate, behind-camera garbage included.
"""

from __future__ import annotations

import torch


def bilinear_sample_pixels(heatmaps: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """heatmaps (V, H, W, J) channels-last, pix (V, N, 2) -> (V, N, J).

    Four corner gathers, each weighted by its bilinear weight or by 0
    when the corner lies outside the image, summed in the order
    (x0,y0), (x1,y0), (x0,y1), (x1,y1) as the CUDA kernel sums them."""
    V, H, W, J = heatmaps.shape
    x, y = pix[..., 0], pix[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1.0, y0 + 1.0
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = heatmaps.reshape(V, H * W, J)

    def corner(xi, yi, w):
        inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
        g = torch.gather(flat, 1, idx[..., None].expand(-1, -1, J))
        return g * torch.where(inside, w, torch.zeros_like(w))[..., None]

    return (
        corner(x0, y0, wx0 * wy0)
        + corner(x1, y0, wx1 * wy0)
        + corner(x0, y1, wx0 * wy1)
        + corner(x1, y1, wx1 * wy1)
    )


def sample_and_mean_views(heatmaps: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """Sample every view and average: heatmaps (V, H, W, J), pix
    (V, N, 2) -> (N, J), clamped to [0, 1] (reference project_whole.py:83
    mean over cameras, clamp at :86)."""
    return bilinear_sample_pixels(heatmaps, pix).mean(dim=0).clamp(0.0, 1.0)
