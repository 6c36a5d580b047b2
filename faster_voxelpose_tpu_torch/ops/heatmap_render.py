"""Gaussian heatmap rasterization on the device (forward of the JAX
package's `render_heatmaps_device`, `faster_voxelpose_tpu/ops/heatmap_render.py`).

The port uses it to make input frames for tests and the smoke run.
Parameter layout (..., K, J, 12), float32:
  0 cx, 1 cy     Gaussian center (on the host renderer's window center)
  2 inv2s2       1/(2 sigma^2); 0 marks a dead row (scale is 0 too)
  3 scale        magnitude (0 = instance absent)
  4 x0w, 5 x1w   window columns [x0w, x1w) after image clipping
  6 y0w, 7 y1w   window rows    [y0w, y1w)
  8 ox0, 9 ox1, 10 oy0, 11 oy1   occlusion rect in image coords
"""

from __future__ import annotations

import torch


def render_heatmaps_device(
    params: torch.Tensor, height: int, width: int
) -> torch.Tensor:
    """(..., K, J, 12) instance params -> (..., H, W, J) heatmaps: the
    max over the K instances of each windowed, occlusion-cut Gaussian,
    clipped to [0, 1]."""
    p = params.float()
    K, J = p.shape[-3], p.shape[-2]
    lead = p.shape[:-3]
    ones = (1,) * len(lead)
    xs = torch.arange(width, dtype=torch.float32, device=p.device)
    ys = torch.arange(height, dtype=torch.float32, device=p.device)
    xs = xs.reshape(ones + (1, width, 1))
    ys = ys.reshape(ones + (height, 1, 1))

    out = torch.zeros(lead + (height, width, J), dtype=torch.float32, device=p.device)
    for k in range(K):
        q = p[..., k, :, :]

        def f(i):
            return q[..., None, None, :, i]

        dx = xs - f(0)
        dy = ys - f(1)
        g = f(3) * torch.exp(-(dx * dx + dy * dy) * f(2))
        inwin = (xs >= f(4)) & (xs < f(5)) & (ys >= f(6)) & (ys < f(7))
        inoccl = (xs >= f(8)) & (xs < f(9)) & (ys >= f(10)) & (ys < f(11))
        out = torch.maximum(out, torch.where(inwin & ~inoccl, g, torch.zeros_like(g)))
    return out.clamp(0.0, 1.0)
