"""Panoptic-protocol evaluation: AP over MPJPE thresholds + MPJPE@500.

A numpy copy of the reference package's `eval/ap.py`, which follows the
original implementation's lib/dataset/panoptic.py:214-311:
per-detection min-MPJPE matching against GT (visibility > 0.1 joints only),
score-sorted greedy assignment, 11-point-free AP integration with monotone
precision envelope, recall/MPJPE at the 500 mm gate.
"""

from __future__ import annotations

import numpy as np


def _ap_at_threshold(eval_list, total_gt, threshold):
    eval_list = sorted(eval_list, key=lambda k: k["score"], reverse=True)
    total_num = len(eval_list)
    tp = np.zeros(total_num)
    fp = np.zeros(total_num)
    seen: set[int] = set()
    for i, item in enumerate(eval_list):
        if item["mpjpe"] < threshold and item["gt_id"] not in seen:
            tp[i] = 1
            seen.add(item["gt_id"])
        else:
            fp[i] = 1
    tp = np.cumsum(tp)
    fp = np.cumsum(fp)
    recall = tp / (total_gt + 1e-5)
    precise = tp / (tp + fp + 1e-5)
    for n in range(total_num - 2, -1, -1):
        precise[n] = max(precise[n], precise[n + 1])
    precise = np.concatenate(([0], precise, [0]))
    recall = np.concatenate(([0], recall, [1]))
    idx = np.where(recall[1:] != recall[:-1])[0]
    ap = np.sum((recall[idx + 1] - recall[idx]) * precise[idx + 1])
    return ap, recall[-2]


def _mpjpe_at(eval_list, threshold=500):
    eval_list = sorted(eval_list, key=lambda k: k["score"], reverse=True)
    seen: set[int] = set()
    vals = []
    for item in eval_list:
        if item["mpjpe"] < threshold and item["gt_id"] not in seen:
            vals.append(item["mpjpe"])
            seen.add(item["gt_id"])
    return float(np.mean(vals)) if vals else np.inf


def evaluate_ap_mpjpe(preds: np.ndarray, gt_joints: list, gt_vis: list,
                      thresholds=None) -> dict:
    """preds: (N, max_people, J, 5) fused poses ([..., 3] match/valid flag,
    [..., 4] score); gt_joints/gt_vis: per-frame lists of (n_i, J, 3)/(n_i, J).

    Returns {'ap': {t: ap}, 'recall@500': r, 'mpjpe@500': m, 'mean_ap': ...}.
    """
    thresholds = thresholds if thresholds is not None \
        else np.arange(25, 155, 25)
    eval_list = []
    total_gt = 0
    for i in range(len(preds)):
        gts = np.asarray(gt_joints[i])
        if len(gts) == 0:
            continue
        vis = np.asarray(gt_vis[i])
        pred = preds[i]
        pred = pred[pred[:, 0, 3] >= 0]
        for pose in pred:
            mpjpes = []
            for g, gv in zip(gts, vis):
                sel = gv > 0.1
                mpjpes.append(np.mean(np.sqrt(np.sum(
                    (pose[sel, 0:3] - g[sel]) ** 2, axis=-1))))
            eval_list.append({
                "mpjpe": float(np.min(mpjpes)),
                "score": float(pose[0, 4]),
                "gt_id": int(total_gt + int(np.argmin(mpjpes))),
            })
        total_gt += len(gts)

    aps, recs = {}, {}
    for t in thresholds:
        ap, rec = _ap_at_threshold(eval_list, total_gt, t)
        aps[int(t)] = ap
        recs[int(t)] = rec

    gt_ids = {e["gt_id"] for e in eval_list if e["mpjpe"] < 500}
    return {
        "ap": aps,
        "mean_ap": float(np.mean(list(aps.values()))),
        "recall@500": len(gt_ids) / max(total_gt, 1),
        "mpjpe@500": _mpjpe_at(eval_list),
        "total_gt": total_gt,
    }
