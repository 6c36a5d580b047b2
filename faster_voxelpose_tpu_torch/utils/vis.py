"""Visualisation of the port (counterpart of
`faster_voxelpose_tpu/utils/vis.py`): the bone tables of COCO-17,
Shelf/Campus-14 and Panoptic-15, a four-panel figure (3D and the xy, xz
and yz planes with the proposals' bbox rectangles), per-view frames with
the reprojected poses, and per-joint heatmap grids.

Host code on numpy arrays: the callers move tensors to the host first.
matplotlib and cv2 are imported inside the functions, so that importing
this module (and code that runs on the card) needs neither.  What is
drawn is gated by cfg.TRAIN / cfg.TEST .VISUALIZATION and VIS_TYPE.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..geometry.cameras import project_points_np
from ..geometry.transforms import affine_transform_points

PANOPTIC_BONES = [
    [0, 1], [0, 2], [0, 3], [3, 4], [4, 5], [0, 9], [9, 10], [10, 11],
    [2, 6], [6, 7], [7, 8], [2, 12], [12, 13], [13, 14],
]
COCO17_BONES = [
    [0, 1], [0, 2], [1, 3], [2, 4], [3, 5], [5, 7], [7, 9], [4, 6],
    [6, 8], [8, 10], [5, 11], [6, 12], [11, 13], [13, 15], [12, 14], [14, 16],
]
SHELF14_BONES = [
    [13, 12], [12, 9], [9, 10], [10, 11], [12, 8], [8, 7], [7, 6],
    [9, 3], [8, 2], [3, 4], [4, 5], [2, 1], [1, 0],
]

BONES_BY_JOINTS = {15: PANOPTIC_BONES, 17: COCO17_BONES, 14: SHELF14_BONES}


def _bones_for(num_joints: int):
    return BONES_BY_JOINTS.get(num_joints, [])


def save_2d_planes(
    cfg,
    fused_poses: np.ndarray,  # (K, J, >=4); col 3 validity
    proposal_centers: Optional[np.ndarray],  # (K, 7) or None
    prefix: str,
):
    """4-panel figure: 3D skeletons + xy/xz/yz plane projections with
    bbox rectangles (reference save_2d_planes, vis.py:141-218)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d import Axes3D  # noqa: F401

    valid = fused_poses[:, 0, 3] >= 0 if fused_poses.shape[-1] > 3 else slice(None)
    poses = fused_poses[valid][:, :, :3]
    bones = _bones_for(poses.shape[1]) if poses.size else []

    fig = plt.figure(figsize=(12, 10))
    ax3d = fig.add_subplot(2, 2, 1, projection="3d")
    panels = [(2, "x", "y", (0, 1)), (3, "x", "z", (0, 2)), (4, "y", "z", (1, 2))]

    for pose in poses:
        for b in bones:
            ax3d.plot(pose[b, 0], pose[b, 1], pose[b, 2], "b-", lw=1)
        ax3d.scatter(pose[:, 0], pose[:, 1], pose[:, 2], s=4, c="r")
    ax3d.set_title("3D")

    space = np.asarray(cfg.CAPTURE_SPEC.SPACE_SIZE)
    center = np.asarray(cfg.CAPTURE_SPEC.SPACE_CENTER)
    ind = np.asarray(cfg.INDIVIDUAL_SPEC.SPACE_SIZE)

    for idx, nx, ny, (a, b) in panels:
        ax = fig.add_subplot(2, 2, idx)
        for ki, pose in enumerate(poses):
            for bn in bones:
                ax.plot(pose[bn, a], pose[bn, b], "b-", lw=1)
            ax.scatter(pose[:, a], pose[:, b], s=3, c="r")
        if proposal_centers is not None and a == 0 and b == 1:
            pc = proposal_centers[proposal_centers[:, 3] >= 0]
            for row in pc:
                w, h = row[5] * ind[0], row[6] * ind[1]
                rect = plt.Rectangle(
                    (row[0] - w / 2, row[1] - h / 2), w, h,
                    fill=False, edgecolor="g",
                )
                ax.add_patch(rect)
        ax.set_xlim(center[a] - space[a] / 2, center[a] + space[a] / 2)
        ax.set_ylim(center[b] - space[b] / 2, center[b] + space[b] / 2)
        ax.set_title(f"{nx}{ny}")

    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    path = prefix + "_2d_planes.png"
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def save_image_with_poses(
    cfg,
    images: Sequence[np.ndarray],  # per view HWC uint8 (original frame)
    fused_poses: np.ndarray,  # (K, J, >=4)
    packed_rig: np.ndarray,  # (V, 21)
    prefix: str,
    resize_transform: Optional[np.ndarray] = None,
):
    """Reproject predicted 3D poses into each camera view and draw
    skeletons (reference save_image_with_poses, vis.py:221-270)."""
    import cv2

    valid = fused_poses[:, 0, 3] >= 0 if fused_poses.shape[-1] > 3 else slice(None)
    poses = fused_poses[valid][:, :, :3]
    bones = _bones_for(poses.shape[1]) if poses.size else []
    paths = []
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    for v, img in enumerate(images):
        canvas = np.ascontiguousarray(img.copy())
        for pose in poses:
            pix = project_points_np(pose, packed_rig[v])
            if resize_transform is not None:
                pix = affine_transform_points(pix, resize_transform)
            pix = pix.astype(int)
            for a, b in bones:
                cv2.line(canvas, tuple(pix[a]), tuple(pix[b]), (0, 255, 0), 2)
            for pt in pix:
                cv2.circle(canvas, tuple(pt), 3, (0, 0, 255), -1)
        path = f"{prefix}_view{v}_poses.jpg"
        cv2.imwrite(path, canvas)
        paths.append(path)
    return paths


def save_heatmaps(heatmaps: np.ndarray, prefix: str):
    """Per-joint colormapped heatmap grid for each view; heatmaps
    (V, H, W, J) (reference save_heatmaps, vis.py:273-309)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    V, H, W, J = heatmaps.shape
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    paths = []
    for v in range(V):
        cols = min(J, 5)
        rows = (J + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 2.2 * rows))
        axes = np.atleast_2d(axes)
        for j in range(J):
            ax = axes[j // cols][j % cols]
            ax.imshow(heatmaps[v, :, :, j], cmap="jet", vmin=0, vmax=1)
            ax.set_title(f"j{j}", fontsize=8)
            ax.axis("off")
        for j in range(J, rows * cols):
            axes[j // cols][j % cols].axis("off")
        path = f"{prefix}_view{v}_heatmaps.png"
        fig.savefig(path, dpi=70)
        plt.close(fig)
        paths.append(path)
    return paths


def test_vis_all(
    cfg,
    batch_meta,
    fused_poses,
    proposal_centers,
    heatmaps,
    prefix,
    images=None,  # per sample: sequence of per-view HWC uint8 frames
    packed_rigs=None,  # (N, V, 21)
    resize_transform=None,
):
    """Dispatch on cfg.TEST.VIS_TYPE (reference test_vis_all, vis.py:48-57):
    every configured VIS_TYPE entry ('2d_planes', 'image_with_poses',
    'heatmaps') emits its artifact kind for each sample."""
    return _vis_all(
        cfg, cfg.TEST.VIS_TYPE, fused_poses, proposal_centers, heatmaps,
        prefix, images, packed_rigs, resize_transform,
    )


def train_vis_all(
    cfg,
    fused_poses,
    proposal_centers,
    heatmaps,
    prefix,
    images=None,
    packed_rigs=None,
    resize_transform=None,
):
    """Training-time counterpart keyed on cfg.TRAIN.VIS_TYPE (reference
    train_vis_all, vis.py:34-46): emits every configured artifact kind
    for the current training batch."""
    return _vis_all(
        cfg, cfg.TRAIN.VIS_TYPE, fused_poses, proposal_centers, heatmaps,
        prefix, images, packed_rigs, resize_transform,
    )


def _vis_all(
    cfg,
    vis_type,
    fused_poses,
    proposal_centers,
    heatmaps,
    prefix,
    images=None,
    packed_rigs=None,
    resize_transform=None,
):
    outputs = []
    if "2d_planes" in vis_type:
        for i in range(len(fused_poses)):
            outputs.append(
                save_2d_planes(
                    cfg, fused_poses[i],
                    proposal_centers[i] if proposal_centers is not None else None,
                    f"{prefix}_{i:04d}",
                )
            )
    if (
        "image_with_poses" in vis_type
        and images is not None
        and packed_rigs is not None
    ):
        for i in range(len(fused_poses)):
            outputs.extend(
                save_image_with_poses(
                    cfg, images[i], fused_poses[i], packed_rigs[i],
                    f"{prefix}_{i:04d}", resize_transform,
                )
            )
    if "heatmaps" in vis_type and heatmaps is not None:
        for i in range(len(heatmaps)):
            outputs.extend(save_heatmaps(heatmaps[i], f"{prefix}_{i:04d}"))
    return outputs
