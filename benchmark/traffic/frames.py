"""Camera frames as a decoder hands them over: uint8 BGR, (V, H, W, 3),
in pageable host memory.  Each frame is a dark, smooth random background
(a coarse grid of uniform values upsampled bilinearly, with fine noise,
below every mark's level) with every joint of the scene's people,
projected into the view, marked by a disk of its own colour channel and
level (`core.weights.joint_mark`), the nearer person's mark drawn over
the farther: what the seeded backbone's planted paths turn into one
heatmap per joint.  Made on the device in a few large calls and copied
to the host once."""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..core.weights import LEVEL_LO, joint_mark

BACKGROUND_MAX = LEVEL_LO - 25.0


def make_frames(marks: List[np.ndarray], depth: List[np.ndarray], height: int, width: int,
                disk_px: float, seed: int, device) -> List[np.ndarray]:
    """One (V, height, width, 3) uint8 array per scene: `marks[i]` (V, P,
    J, 2) joint pixels in the input frame, `depth[i]` (V, P) each
    person's distance from each camera."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2**63))
    views = marks[0].shape[0]
    n = len(marks) * views
    coarse = torch.rand((n, 3, max(height // 32, 2), max(width // 32, 2)), generator=gen,
                        device=device)
    smooth = F.interpolate(coarse, size=(height, width), mode="bilinear", align_corners=False)
    fine = torch.rand((n, 3, height, width), generator=gen, device=device)
    img = (5.0 + (BACKGROUND_MAX - 15.0) * smooth + 10.0 * fine).reshape(
        len(marks), views, 3, height, width)
    ys = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(width, device=device, dtype=torch.float32)[None]
    for i, (pts, dist) in enumerate(zip(marks, depth)):
        J = pts.shape[2]
        for v in range(views):
            for p in np.argsort(-dist[v]):  # the farthest first, the nearest on top
                for j in range(J):
                    c, level, _ = joint_mark(j, J)
                    x, y = (float(t) for t in pts[v, p, j])
                    disk = (xs - x) ** 2 + (ys - y) ** 2 <= disk_px ** 2
                    img[i, v, 2 - c][disk] = level  # BGR
    host = img.reshape(n, 3, height, width).round().clamp(0, 255).to(torch.uint8)
    host = host.permute(0, 2, 3, 1).contiguous().cpu().numpy()
    return [np.ascontiguousarray(host[i * views:(i + 1) * views]) for i in range(len(marks))]
