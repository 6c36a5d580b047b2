"""Synthetic scenes (frozen copy of the placement of
`datasets/synthetic.py:_generate_scene`): n poses from the bank, each rotated about its root and placed at random in the capture
space, 70% uniformly and 30% about 500 mm from someone already placed,
kept only where its xy bbox lies in the space, its root 1 m up is seen by
two cameras or more, and it overlaps no one (IoU < 0.01); 100 tries a
person, after which the scene keeps those placed."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .rig import project_np


def root_of(pose: np.ndarray, root) -> np.ndarray:
    return pose[root] if isinstance(root, int) else pose[list(root)].mean(0)


def _rotate(xy: np.ndarray, center: np.ndarray, deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    return (xy - center) @ rot.T + center


def make_scene(rng: np.random.Generator, bank: np.ndarray, rig: np.ndarray, root,
               space_size: Sequence[float], space_center: Sequence[float],
               ori_image_size: Sequence[int], n_people: int) -> np.ndarray:
    """(P, J, 3) mm, 1 <= P <= n_people (fewer where one finds no room)."""
    lo = np.array(space_center[:2]) - np.array(space_size[:2]) / 2
    hi = np.array(space_center[:2]) + np.array(space_size[:2]) / 2
    w, h = ori_image_size
    people: List[np.ndarray] = []
    boxes: List[np.ndarray] = []
    centers: List[np.ndarray] = []
    for i in rng.integers(0, len(bank), n_people):
        pose = bank[i].copy()
        c0 = root_of(pose, root)[:2]
        deg = rng.uniform(-180, 180)
        for _ in range(100):
            if not centers or rng.random() < 0.7:
                c = rng.uniform(lo, hi)
            else:
                c = centers[rng.integers(len(centers))] + rng.normal(500, 50, 2) * rng.choice(
                    [-1, 1], 2)
            xy = _rotate(pose[:, :2], c0, deg) - c0 + c
            box = np.array([*xy.min(0), *xy.max(0)])
            if (box[:2] < lo).any() or (box[2:] > hi).any():
                continue
            uv = np.stack([project_np(np.array([[*c, 1000.0]]), cam)[0] for cam in rig])
            seen = ((uv[:, 0] > 10) & (uv[:, 0] < w - 10) & (uv[:, 1] > 10)
                    & (uv[:, 1] < h - 10)).sum()
            if seen < 2:
                continue
            if boxes:
                b = np.asarray(boxes)
                iw = np.maximum(0, np.minimum(box[2], b[:, 2]) - np.maximum(box[0], b[:, 0]))
                ih = np.maximum(0, np.minimum(box[3], b[:, 3]) - np.maximum(box[1], b[:, 1]))
                inter = iw * ih
                area = (box[2] - box[0]) * (box[3] - box[1])
                areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
                if (inter / (area + areas - inter)).max() >= 0.01:
                    continue
            pose[:, :2] = xy
            people.append(pose)
            boxes.append(box)
            centers.append(c)
            break
        else:
            break
    if not people:  # the first person always has room in these spaces
        raise RuntimeError("no person could be placed")
    return np.asarray(people)
