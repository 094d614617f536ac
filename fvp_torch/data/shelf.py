"""Shelf dataset: eval-only frames 300-600 from offline 2D predictions,
PCP3D evaluation against actorsGT.mat.

A copy of the reference package's `data/shelf.py` (after the original
implementation's lib/dataset/shelf.py:73-227 and campus.py).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle

import numpy as np

from fvp_torch.config import FVPConfig
from fvp_torch.data.base import PoseDataset
from fvp_torch.eval.pcp import coco2shelf3d, evaluate_pcp
from fvp_torch.geometry.cameras import CameraRig


def load_json_calibration(cam_file: str) -> CameraRig:
    """Shelf/Campus-style calibration: {'0': {R,T,fx,...}, ...}."""
    with open(cam_file) as f:
        cameras = json.load(f)
    ordered = [cameras[k] for k in sorted(cameras, key=int)]
    return CameraRig.from_dicts(ordered)


class ShelfDataset(PoseDataset):
    SEQ = "shelf"

    def __init__(self, cfg: FVPConfig, is_train: bool = False,
                 frame_range=None):
        super().__init__(cfg, is_train)
        self.has_evaluate_function = True
        self.frame_range = list(frame_range or range(300, 601))
        self.rigs[self.SEQ] = load_json_calibration(
            osp.join(cfg.data_dir, f"calibration_{self.SEQ}.json"))
        self._gt_by_actor = None
        self._build_records()

    # ------------------------------------------------------------------
    def _load_gt(self):
        import scipy.io as scio

        datafile = os.path.join(self.cfg.data_dir, "actorsGT.mat")
        actor_3d = scio.loadmat(datafile)["actor3D"]
        actor_3d = np.array(np.array(actor_3d.tolist()).tolist(),
                            dtype=object).squeeze()
        return actor_3d

    def _load_pred2d(self):
        path = os.path.join(self.cfg.data_dir,
                            "pred_shelf_maskrcnn_hrnet_coco.pkl")
        with open(path, "rb") as f:
            return pickle.load(f)

    def _build_records(self) -> None:
        if not osp.exists(os.path.join(self.cfg.data_dir, "actorsGT.mat")):
            return      # dataset not on disk; keep importable
        actor_3d = self._load_gt()
        pred_2d = self._load_pred2d()
        num_person = len(actor_3d)

        for fi in self.frame_range:
            all_preds, poses, vis = [], [], []
            for person in range(num_person):
                pose3d = actor_3d[person][fi] * 1000.0
                if len(pose3d[0]) > 0:
                    poses.append(pose3d)
                    vis.append(np.ones(pose3d.shape[0]))
            for k in range(self.cfg.num_views):
                preds = pred_2d[f"{k}_{fi}"]
                all_preds.append([np.array(p["pred"]) for p in preds])
            self.records.append({
                "seq": self.SEQ,
                "frame": fi,
                "pred_pose2d": all_preds,
                # GT kept for evaluation only; targets aren't needed in eval,
                # but meta padding requires the joint count to match cfg
                "gt_poses": poses,
            })

    # ------------------------------------------------------------------
    def sample(self, idx, rng=None):
        rec = self.records[idx]
        out = {
            "meta": {"num_person": np.int32(len(rec.get("gt_poses", [])))},
            "input_heatmaps": self._render_pred_heatmaps(rec, rng),
        }
        return out

    def evaluate(self, fused_poses: np.ndarray) -> dict:
        actor_3d = self._load_gt()
        gt_by_actor = []
        for person in range(len(actor_3d)):
            frames = []
            for fi in self.frame_range:
                gt = actor_3d[person][fi]
                frames.append(gt * 1000.0 if len(gt[0]) > 0 else None)
            gt_by_actor.append(frames)
        return evaluate_pcp(fused_poses, gt_by_actor, convert=coco2shelf3d)


class CampusDataset(ShelfDataset):
    """Campus: same pattern, 3 cameras, frames 350-470 + 650-750
    (reference campus.py:55)."""

    SEQ = "campus"

    def __init__(self, cfg: FVPConfig, is_train: bool = False):
        frame_range = list(range(350, 471)) + list(range(650, 751))
        super().__init__(cfg, is_train, frame_range=frame_range)

    def _load_pred2d(self):
        path = os.path.join(self.cfg.data_dir,
                            "pred_campus_maskrcnn_hrnet_coco.pkl")
        with open(path, "rb") as f:
            return pickle.load(f)

    def evaluate(self, fused_poses: np.ndarray) -> dict:
        from fvp_torch.eval.pcp import coco2campus3d

        actor_3d = self._load_gt()
        gt_by_actor = []
        for person in range(len(actor_3d)):
            frames = []
            for fi in self.frame_range:
                gt = actor_3d[person][fi]
                frames.append(gt * 1000.0 if len(gt[0]) > 0 else None)
            gt_by_actor.append(frames)
        return evaluate_pcp(fused_poses, gt_by_actor, convert=coco2campus3d)
