"""The one generator of every mix: a pool of inputs, the order in which
requests take them, and when each is due.

A mix file (`mixes/<traffic>.json`) gives:
  input     "frames" (uint8 camera frames) or "heatmaps" (float32 2D
            joint heatmaps rendered from synthetic scenes)
  pool      how many distinct inputs the requests cycle through
  host_memory  "pageable" (numpy arrays, as a decoder hands frames over) or
            "pinned" (page-locked tensors)
  arrivals  the schedule's name (`arrivals.ARRIVALS`) and its parameters
  scenes    people per scene [lo, hi], spread evenly over the pool (every
            seed gets the same counts, in another order); for heatmaps the
            keypoint noise in input pixels
  frames    for frames: the radius in input pixels of each joint's disk
The cell's file gives the rate; the configuration the sizes, the rig and
the pose bank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Mapping

import numpy as np
import torch

from ..reference.fusion import resize_affine
from .arrivals import ARRIVALS
from .frames import make_frames
from .heatmaps import render_scene
from .poses import make_pose_bank
from .rig import make_rig, project_np
from .scenes import make_scene

INPUTS = ("frames", "heatmaps")


@dataclass
class Traffic:
    rig: np.ndarray  # (V, 21) float32
    pool: list  # the distinct inputs (numpy arrays, or pinned tensors)
    order: np.ndarray  # (n,) pool index of each request
    due: np.ndarray  # (n,) seconds from the window's start
    people: List[int]  # people placed in each pool entry's scene


def config_rig(config: Mapping) -> np.ndarray:
    r, d = config["rig"], config["yaml"]["DATASET"]
    return make_rig(int(d["CAMERA_NUM"]), float(r["radius_mm"]), float(r["height_mm"]),
                    r["center_xy"], d["ORI_IMAGE_SIZE"], seed=int(r.get("seed", 0)))


def make_pool(mix: Mapping, config: Mapping, seed: int, device):
    """(rig, pool, people) of a mix under a configuration and seed: one
    synthetic scene per pool entry, rendered as heatmaps or drawn into
    frames."""
    y = config["yaml"]
    d, c = y["DATASET"], y["CAPTURE_SPEC"]
    if mix["input"] not in INPUTS:
        raise ValueError(f"unknown input {mix['input']!r}; known: {INPUTS}")
    rig = config_rig(config)
    rng = np.random.default_rng([seed, 1])
    b = config["pose_bank"]
    bank = make_pose_bank(int(b["size"]), b["skeleton"], int(b.get("seed", 1)))
    lo, hi = mix["scenes"]["people"]
    hi = min(int(hi), int(c["MAX_PEOPLE"]))
    counts = rng.permutation(np.resize(np.arange(int(lo), hi + 1), int(mix["pool"])))
    affine = resize_affine(d["ORI_IMAGE_SIZE"], d["IMAGE_SIZE"])
    scenes = [make_scene(rng, bank, rig, d["ROOT_JOINT_ID"], c["SPACE_SIZE"],
                         c["SPACE_CENTER"], d["ORI_IMAGE_SIZE"], int(k)) for k in counts]
    people = [len(s) for s in scenes]
    if mix["input"] == "frames":
        iw, ih = d["IMAGE_SIZE"]
        marks, depth = [], []
        for s in scenes:
            P, J, _ = s.shape
            marks.append(np.stack([(project_np(s.reshape(-1, 3), cam) @ affine[:, :2].T
                                    + affine[:, 2]).reshape(P, J, 2) for cam in rig]))
            depth.append(np.stack([np.linalg.norm(s.mean(1) - cam[9:12], axis=-1)
                                   for cam in rig]))
        return rig, make_frames(marks, depth, ih, iw, float(mix["frames"]["disk_px"]), seed,
                                device), people
    pool = [render_scene(s, rig, affine, d["ORI_IMAGE_SIZE"], d["IMAGE_SIZE"],
                         d["HEATMAP_SIZE"], float(y["NETWORK"]["SIGMA"]),
                         float(mix["scenes"]["noise_px"]), rng) for s in scenes]
    return rig, pool, people


def host_memory(pool: List[np.ndarray], kind: str, device) -> list:
    """The pool as the client holds it: numpy arrays in pageable memory,
    or, with a card, tensors in page-locked memory, as a producer that
    streams them at this rate stages them."""
    if kind == "pageable" or torch.device(device).type != "cuda":
        return pool
    if kind != "pinned":
        raise ValueError(f"unknown host memory {kind!r}; known: pageable, pinned")
    return [torch.from_numpy(x).pin_memory() for x in pool]


def make_traffic(mix: Mapping, config: Mapping, rate: float, seconds: float, seed: int,
                 device) -> Traffic:
    rig, pool, people = make_pool(mix, config, seed, device)
    pool = host_memory(pool, mix.get("host_memory", "pageable"), device)
    rng = np.random.default_rng([seed, 2])
    a = dict(mix["arrivals"])
    due = ARRIVALS[a.pop("kind")](rate, seconds, rng=rng, **a)
    order = np.resize(rng.permutation(len(pool)), len(due))
    return Traffic(rig, pool, order, due, people)
