"""Evaluation metrics of the port: Panoptic AP / recall / MPJPE and
Shelf/Campus PCP3D (the port's own copy of
`faster_voxelpose_tpu/datasets/evaluate.py`, numpy only, float64 on the
host), following the reference's protocol:
* AP by score-sorted greedy matching, each ground truth consumed once, and
  the area under the precision envelope (lib/dataset/panoptic.py:267-311);
* MPJPE over the matched predictions under 500 mm (panoptic.py:295-306);
* PCP3D with alpha = 0.5 over 9 limbs and the head-torso pseudo-limb
  (lib/dataset/shelf.py:162-227), with the COCO-17 -> Shelf/Campus-14
  joint remapping and its head interpolation (shelf.py:229-256,
  campus.py:211-230).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Panoptic protocol: AP / recall / MPJPE
# ---------------------------------------------------------------------------


def match_predictions(
    all_preds: Sequence[np.ndarray],
    all_gt: Sequence[Tuple[np.ndarray, np.ndarray]],
) -> Tuple[List[Dict], int]:
    """Build the (mpjpe, score, gt_id) evaluation list.

    all_preds[i]: (P_i, J, >=5) predicted poses for frame i; column 3 is
    the validity flag, column 4 the score (only rows with flag >= 0 count).
    all_gt[i]: (gt_joints (G_i, J, 3), gt_vis (G_i, J)).
    """
    eval_list: List[Dict] = []
    total_gt = 0
    for preds, (gts, gt_vis) in zip(all_preds, all_gt):
        if len(gts) == 0:
            continue
        preds = np.asarray(preds, dtype=np.float64)
        valid = preds[:, 0, 3] >= 0
        for pose in preds[valid]:
            mpjpes = []
            for gt, vis in zip(gts, gt_vis):
                v = vis > 0.1
                mpjpes.append(
                    np.mean(
                        np.sqrt(np.sum((pose[v, 0:3] - gt[v]) ** 2, axis=-1))
                    )
                )
            min_gt = int(np.argmin(mpjpes))
            eval_list.append(
                {
                    "mpjpe": float(np.min(mpjpes)),
                    "score": float(pose[0, 4]),
                    "gt_id": total_gt + min_gt,
                }
            )
        total_gt += len(gts)
    return eval_list, total_gt


def ap_at_threshold(
    eval_list: List[Dict], total_gt: int, threshold_mm: float
) -> Tuple[float, float]:
    """Average precision + final recall at an MPJPE threshold: greedy
    score-descending matching, each GT consumable once, interpolated
    PR-curve area."""
    order = sorted(eval_list, key=lambda e: e["score"], reverse=True)
    n = len(order)
    tp = np.zeros(n)
    fp = np.zeros(n)
    taken = set()
    for i, item in enumerate(order):
        if item["mpjpe"] < threshold_mm and item["gt_id"] not in taken:
            tp[i] = 1
            taken.add(item["gt_id"])
        else:
            fp[i] = 1
    tp, fp = np.cumsum(tp), np.cumsum(fp)
    recall = tp / (total_gt + 1e-5)
    precision = tp / (tp + fp + 1e-5)
    # monotone precision envelope
    for i in range(n - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    precision = np.concatenate(([0.0], precision, [0.0]))
    recall_ext = np.concatenate(([0.0], recall, [1.0]))
    steps = np.where(recall_ext[1:] != recall_ext[:-1])[0]
    ap = float(np.sum((recall_ext[steps + 1] - recall_ext[steps]) * precision[steps + 1]))
    final_recall = float(recall_ext[-2]) if n > 0 else 0.0
    return ap, final_recall


def mpjpe_at_threshold(eval_list: List[Dict], threshold_mm: float = 500.0) -> float:
    order = sorted(eval_list, key=lambda e: e["score"], reverse=True)
    taken = set()
    errs = []
    for item in order:
        if item["mpjpe"] < threshold_mm and item["gt_id"] not in taken:
            errs.append(item["mpjpe"])
            taken.add(item["gt_id"])
    return float(np.mean(errs)) if errs else float("inf")


def recall_at_threshold(
    eval_list: List[Dict], total_gt: int, threshold_mm: float = 500.0
) -> float:
    matched = {e["gt_id"] for e in eval_list if e["mpjpe"] < threshold_mm}
    return len(matched) / total_gt if total_gt else 0.0


def panoptic_metrics(all_preds, all_gt) -> Tuple[float, str, Dict[str, float]]:
    """Full Panoptic evaluation table; returns (mean AP, message, detail)."""
    eval_list, total_gt = match_predictions(all_preds, all_gt)
    thresholds = np.arange(25, 155, 25)
    aps, recs = [], []
    for t in thresholds:
        ap, rec = ap_at_threshold(eval_list, total_gt, t)
        aps.append(ap)
        recs.append(rec)
    mpjpe = mpjpe_at_threshold(eval_list)
    recall = recall_at_threshold(eval_list, total_gt)
    detail = {f"ap@{int(t)}": a for t, a in zip(thresholds, aps)}
    detail.update({"recall@500mm": recall, "mpjpe@500mm": mpjpe})
    msg = (
        "Evaluation results on Panoptic dataset:\n"
        + "\t".join(f"ap@{int(t)}: {a:.4f}" for t, a in zip(thresholds, aps))
        + f"\trecall@500mm: {recall:.4f}\tmpjpe@500mm: {mpjpe:.3f}"
    )
    return float(np.mean(aps)), msg, detail


# ---------------------------------------------------------------------------
# COCO -> Shelf/Campus joint remapping
# ---------------------------------------------------------------------------

_COCO2SHELF = np.array([16, 14, 12, 11, 13, 15, 10, 8, 6, 5, 7, 9])


def coco_to_shelf_pose(coco_pose: np.ndarray) -> np.ndarray:
    """COCO-17 -> Shelf-14 with interpolated head joints
    (reference shelf.py:229-256: head direction blended 75/25 with an
    ear/shoulder construction)."""
    out = np.zeros((14, 3))
    out[:12] = coco_pose[_COCO2SHELF]
    mid_sho = (coco_pose[5] + coco_pose[6]) / 2
    head_center = (coco_pose[3] + coco_pose[4]) / 2
    head_bottom = (mid_sho + head_center) / 2
    head_top = head_bottom + (head_center - head_bottom) * 2
    out[12] = (out[8] + out[9]) / 2
    out[13] = coco_pose[0]
    out[13] = out[12] + (out[13] - out[12]) * np.array([0.75, 0.75, 1.5])
    out[12] = out[12] + (coco_pose[0] - out[12]) * 0.5
    alpha = 0.75
    out[13] = out[13] * alpha + head_top * (1 - alpha)
    out[12] = out[12] * alpha + head_bottom * (1 - alpha)
    return out


def coco_to_campus_pose(coco_pose: np.ndarray) -> np.ndarray:
    """COCO-17 -> Campus-14: head joints from the ear/shoulder construction
    directly (reference campus.py:211-230)."""
    out = np.zeros((14, 3))
    out[:12] = coco_pose[_COCO2SHELF]
    mid_sho = (coco_pose[5] + coco_pose[6]) / 2
    head_center = (coco_pose[3] + coco_pose[4]) / 2
    head_bottom = (mid_sho + head_center) / 2
    out[12] = head_bottom
    out[13] = head_bottom + (head_center - head_bottom) * 2
    return out


# ---------------------------------------------------------------------------
# Shelf/Campus protocol: PCP3D
# ---------------------------------------------------------------------------

PCP_LIMBS = [[0, 1], [1, 2], [3, 4], [4, 5], [6, 7], [7, 8], [9, 10], [10, 11], [12, 13]]
PCP_BONE_GROUPS = OrderedDict(
    [
        ("Head", [8]),
        ("Torso", [9]),
        ("Upper arms", [5, 6]),
        ("Lower arms", [4, 7]),
        ("Upper legs", [1, 2]),
        ("Lower legs", [0, 3]),
    ]
)


def pcp3d_metrics(
    all_preds: Sequence[np.ndarray],
    actor_gt: Sequence[Sequence[np.ndarray]],
    remap,
    recall_threshold: float = 500.0,
) -> Tuple[float, str, Dict]:
    """PCP3D with alpha=0.5 (reference shelf.py:162-227 / campus.py:138-209).

    all_preds[i]: (P_i, J, >=4) COCO-order predictions for frame i (only
    rows with flag col 3 >= 0 count).
    actor_gt[i]: per-actor GT (14, 3) arrays for frame i; empty array when
    the actor is absent.
    remap: coco_to_shelf_pose or coco_to_campus_pose.
    """
    num_actors = max(len(f) for f in actor_gt)
    correct = np.zeros(num_actors)
    total = np.zeros(num_actors)
    bone_correct = np.zeros((num_actors, 10))
    alpha = 0.5
    total_gt = 0
    match_gt = 0

    for preds, gts in zip(all_preds, actor_gt):
        preds = np.asarray(preds, dtype=np.float64)
        valid = preds[:, 0, 3] >= 0
        pred_coco = preds[valid][:, :, :3]
        if len(pred_coco) == 0:
            continue
        pred = np.stack([remap(p) for p in pred_coco])

        for a, gt in enumerate(gts):
            gt = np.asarray(gt, dtype=np.float64)
            if gt.size == 0 or len(gt[0]) == 0:
                continue
            mpjpes = np.mean(
                np.sqrt(np.sum((gt[None] - pred) ** 2, axis=-1)), axis=-1
            )
            best = int(np.argmin(mpjpes))
            if np.min(mpjpes) < recall_threshold:
                match_gt += 1
            total_gt += 1

            for li, (s, e) in enumerate(PCP_LIMBS):
                total[a] += 1
                err_s = np.linalg.norm(pred[best, s] - gt[s])
                err_e = np.linalg.norm(pred[best, e] - gt[e])
                limb_len = np.linalg.norm(gt[s] - gt[e])
                if (err_s + err_e) / 2.0 <= alpha * limb_len:
                    correct[a] += 1
                    bone_correct[a, li] += 1
            # head-torso pseudo-limb: mid-hip to bottom-head
            pred_hip = (pred[best, 2] + pred[best, 3]) / 2.0
            gt_hip = (gt[2] + gt[3]) / 2.0
            total[a] += 1
            err_s = np.linalg.norm(pred_hip - gt_hip)
            err_e = np.linalg.norm(pred[best, 12] - gt[12])
            limb_len = np.linalg.norm(gt_hip - gt[12])
            if (err_s + err_e) / 2.0 <= alpha * limb_len:
                correct[a] += 1
                bone_correct[a, 9] += 1

    actor_pcp = correct / (total + 1e-8)
    avg_pcp = float(np.mean(actor_pcp[:3]))
    recall = match_gt / (total_gt + 1e-8)

    bone_pcp = OrderedDict(
        (k, np.sum(bone_correct[:, v], axis=-1) / (total / 10 * len(v) + 1e-8))
        for k, v in PCP_BONE_GROUPS.items()
    )
    msg = (
        "     | " + " | ".join(f"Actor {i+1}" for i in range(min(3, num_actors)))
        + " | Average |\n PCP | "
        + " | ".join(f"{actor_pcp[i]*100: .2f}" for i in range(min(3, num_actors)))
        + f" | {avg_pcp*100: .2f} |\t Recall@500mm: {recall:.4f}"
    )
    return avg_pcp, msg, {"actor_pcp": actor_pcp, "bone_pcp": bone_pcp, "recall": recall}
