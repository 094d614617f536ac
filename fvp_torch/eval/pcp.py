"""PCP3D evaluation for Shelf/Campus + COCO->dataset skeleton conversion.

A numpy copy of the reference package's `eval/pcp.py`, which follows the
original implementation's lib/dataset/shelf.py:162-256 and
campus.py:138-230: alpha=0.5 limb-length criterion over 9 limbs plus a
virtual hip-head limb, per-actor accounting averaged over actors 1-3, and the
head-interpolating COCO-17 -> Shelf/Campus-14 conversions.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

# limb index pairs in the 14-joint shelf/campus order (shelf.py:170)
LIMBS14 = [[0, 1], [1, 2], [3, 4], [4, 5], [6, 7], [7, 8], [9, 10],
           [10, 11], [12, 13]]

BONE_GROUP = OrderedDict([
    ("Head", [8]), ("Torso", [9]), ("Upper arms", [5, 6]),
    ("Lower arms", [4, 7]), ("Upper legs", [1, 2]),
    ("Lower legs", [0, 3])])


def coco2shelf3d(coco: np.ndarray) -> np.ndarray:
    """COCO-17 -> Shelf-14 with interpolated head joints (shelf.py:229-256)."""
    out = np.zeros((14, 3))
    mapping = np.array([16, 14, 12, 11, 13, 15, 10, 8, 6, 5, 7, 9])
    out[:12] = coco[mapping]

    mid_sho = (coco[5] + coco[6]) / 2
    head_center = (coco[3] + coco[4]) / 2
    head_bottom = (mid_sho + head_center) / 2
    head_top = head_bottom + (head_center - head_bottom) * 2

    out[12] = (out[8] + out[9]) / 2
    out[13] = coco[0]
    out[13] = out[12] + (out[13] - out[12]) * np.array([0.75, 0.75, 1.5])
    out[12] = out[12] + (coco[0] - out[12]) * np.array([0.5, 0.5, 0.5])
    alpha = 0.75
    out[13] = out[13] * alpha + head_top * (1 - alpha)
    out[12] = out[12] * alpha + head_bottom * (1 - alpha)
    return out


def coco2campus3d(coco: np.ndarray) -> np.ndarray:
    """COCO-17 -> Campus-14 (campus.py:211-230)."""
    out = np.zeros((14, 3))
    mapping = np.array([16, 14, 12, 11, 13, 15, 10, 8, 6, 5, 7, 9])
    out[:12] = coco[mapping]
    mid_sho = (coco[5] + coco[6]) / 2
    head_center = (coco[3] + coco[4]) / 2
    head_bottom = (mid_sho + head_center) / 2
    head_top = head_bottom + (head_center - head_bottom) * 2
    out[12] = head_bottom
    out[13] = head_top
    return out


def evaluate_pcp(preds: np.ndarray, gt_by_actor: list,
                 convert=coco2shelf3d, alpha: float = 0.5,
                 recall_threshold: float = 500.0) -> dict:
    """preds: (N, max_people, J, 5) coco-order fused poses;
    gt_by_actor: list over actors of per-frame (14, 3) poses or None.

    Returns per-actor PCP, average over actors 1-3, per-bone-group PCP and
    recall@500mm.
    """
    num_person = len(gt_by_actor)
    num_frames = len(preds)
    correct_parts = np.zeros(num_person)
    total_parts = np.zeros(num_person)
    bone_correct = np.zeros((num_person, 10))
    total_gt = 0
    match_gt = 0

    for i in range(num_frames):
        pred = preds[i]
        pred = pred[pred[:, 0, 3] >= 0, :, :3]
        if len(pred) == 0:
            continue
        pred14 = np.stack([convert(p.copy()) for p in pred])

        for person in range(num_person):
            gt = gt_by_actor[person][i]
            if gt is None or len(np.asarray(gt).reshape(-1)) == 0:
                continue
            gt = np.asarray(gt)
            mpjpes = np.mean(np.sqrt(np.sum(
                (gt[np.newaxis] - pred14) ** 2, axis=-1)), axis=-1)
            min_n = int(np.argmin(mpjpes))
            if np.min(mpjpes) < recall_threshold:
                match_gt += 1
            total_gt += 1

            for j, (a, b) in enumerate(LIMBS14):
                total_parts[person] += 1
                err_s = np.linalg.norm(pred14[min_n, a] - gt[a])
                err_e = np.linalg.norm(pred14[min_n, b] - gt[b])
                limb_len = np.linalg.norm(gt[a] - gt[b])
                if (err_s + err_e) / 2.0 <= alpha * limb_len:
                    correct_parts[person] += 1
                    bone_correct[person, j] += 1
            # virtual hip->head limb
            pred_hip = (pred14[min_n, 2] + pred14[min_n, 3]) / 2.0
            gt_hip = (gt[2] + gt[3]) / 2.0
            total_parts[person] += 1
            err_s = np.linalg.norm(pred_hip - gt_hip)
            err_e = np.linalg.norm(pred14[min_n, 12] - gt[12])
            limb_len = np.linalg.norm(gt_hip - gt[12])
            if (err_s + err_e) / 2.0 <= alpha * limb_len:
                correct_parts[person] += 1
                bone_correct[person, 9] += 1

    actor_pcp = correct_parts / (total_parts + 1e-8)
    avg_pcp = float(np.mean(actor_pcp[:3]))
    bone_pcp = OrderedDict()
    for k, v in BONE_GROUP.items():
        bone_pcp[k] = (np.sum(bone_correct[:, v], axis=-1)
                       / (total_parts / 10 * len(v) + 1e-8))
    return {
        "actor_pcp": actor_pcp,
        "avg_pcp": avg_pcp,
        "bone_pcp": bone_pcp,
        "recall@500": match_gt / (total_gt + 1e-8),
    }
