"""The comparison that decides `correct` for served poses.

Each answer (the people the program served for one request) is held
against the people the reference serves for the same input: its slots
above MIN_SCORE.  People are paired greedily by mean per-joint distance
(MPJPE), nearest first, within PAIR_MM (a person's scale: a slot
farther off is someone else).  A reference person left unpaired was
dropped; a served person left unpaired is one the reference does not
serve.  Over a run, compared with the cell's limits:

- pose_mean_mm: the mean over every person of either side of their
  error: a pair's MPJPE, at most MISS_MM, and MISS_MM for each person
  dropped or served in excess;
- confidence_mean: the mean gap between the served confidence and the
  reference's over the pairs.

MISS_MM is 150 mm, the loosest threshold of the average precision that
Faster-VoxelPose reports on Panoptic (AP@25..150): a pose off by more
counts there as a person not found.  So a program that serves no one
reads MISS_MM wherever the reference finds someone.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

NUMBERS = ("pose_mean_mm", "confidence_mean")
PAIR_MM = 500.0
MISS_MM = 150.0


def compare_answer(answer: Mapping, ref: Mapping) -> Dict[str, object]:
    """answer: {'poses_mm' (P, J, 3), 'scores' (P,)}; ref: numpy arrays
    'poses' (K, J, 3), 'valid' (K,), 'confidence' (K,).  Returns the
    pairs' errors and confidence gaps, and the people left unpaired."""
    valid = np.asarray(ref["valid"], bool)
    slots = np.asarray(ref["poses"], np.float64)[valid]
    conf = np.asarray(ref["confidence"], np.float64)[valid]
    served = np.asarray(answer["poses_mm"], np.float64).reshape(-1, *slots.shape[1:])
    scores = np.asarray(answer["scores"], np.float64)
    dist = np.linalg.norm(served[:, None] - slots[None], axis=-1).mean(-1)  # (P, V)
    out = {"errors": [], "conf": [], "unpaired": 0}
    used_p, used_k = set(), set()
    for flat in np.argsort(dist, axis=None, kind="stable"):
        p, k = divmod(int(flat), slots.shape[0])
        if p in used_p or k in used_k or dist[p, k] >= PAIR_MM:
            continue
        used_p.add(p)
        used_k.add(k)
        out["errors"].append(min(float(dist[p, k]), MISS_MM))
        out["conf"].append(abs(float(scores[p]) - float(conf[k])))
    out["unpaired"] = (len(served) - len(used_p)) + (len(slots) - len(used_k))
    return out


def summarize(readings) -> Dict[str, float]:
    """The run's numbers from its answers' readings (0 where neither side
    served anyone)."""
    errors, conf, unpaired = [], [], 0
    for r in readings:
        errors += r["errors"]
        conf += r["conf"]
        unpaired += r["unpaired"]
    people = len(errors) + unpaired
    return {"pose_mean_mm": (sum(errors) + MISS_MM * unpaired) / people if people else 0.0,
            "confidence_mean": sum(conf) / len(conf) if conf else 0.0,
            "unpaired": unpaired, "people": people}
