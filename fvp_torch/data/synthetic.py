"""Synthetic multi-person scene factory for training without images.

A copy of the reference package's `data/synthetic.py`, after the original
implementation's lib/dataset/synthetic.py:25-195:
sample 1..max poses from a pose library, randomly rotate each and place it in
the capture space by rejection sampling (inside-space bbox, visible from >= 2
cameras, pairwise bbox IoU < 0.01, 100 attempts), then render GT heatmaps with
augmentation at __getitem__ time.

Differences: the pose library falls back to the procedural skeleton sampler
when the reference's panoptic_training_pose.pkl is absent, and placement is
driven by an explicit RandomState for reproducibility.
"""

from __future__ import annotations

import os

import numpy as np

from fvp_torch.config import FVPConfig
from fvp_torch.data.base import PoseDataset
from fvp_torch.data.poses import load_pose_library, procedural_pose_library
from fvp_torch.eval.ap import evaluate_ap_mpjpe
from fvp_torch.geometry.cameras import CameraRig, project_points_np
from fvp_torch.geometry.transforms import rotate_points


def _calc_bbox(pose_xy: np.ndarray, vis: np.ndarray) -> np.ndarray:
    idx = vis > 0
    return np.array([pose_xy[idx, 0].min(), pose_xy[idx, 1].min(),
                     pose_xy[idx, 0].max(), pose_xy[idx, 1].max()])


class SyntheticDataset(PoseDataset):
    def __init__(self, cfg: FVPConfig, rig: CameraRig,
                 num_data: int | None = None, seed: int = 0,
                 pose_library=None, is_train: bool = True):
        super().__init__(cfg, is_train)
        # the Synthetic dataset has its own augmentation gate (reference
        # lib/dataset/synthetic.py:31: SYNTHETIC.DATA_AUGMENTATION)
        self.data_augmentation = cfg.synthetic_augmentation
        self.rigs = {"synthetic": rig}
        self.num_data = num_data or cfg.synthetic_num_data

        if pose_library is not None:
            self.poses = pose_library
        elif cfg.synthetic_pose_file and os.path.exists(
                os.path.join(cfg.data_dir, cfg.synthetic_pose_file)):
            self.poses = load_pose_library(
                os.path.join(cfg.data_dir, cfg.synthetic_pose_file))
        else:
            self.poses = procedural_pose_library(
                cfg.num_joints, count=2000, seed=seed)

        self._space_min = np.array(cfg.space_center[:2]) \
            - np.array(cfg.space_size[:2]) / 2.0
        self._space_max = np.array(cfg.space_center[:2]) \
            + np.array(cfg.space_size[:2]) / 2.0

        if cfg.synthetic_scene_file:
            # Cross-framework A/B mode: consume pre-generated scenes so a
            # second framework (e.g. the reference's torch code) can train
            # on byte-identical records (see tools/ab_export_scenes.py).
            import pickle

            with open(cfg.synthetic_scene_file, "rb") as f:
                payload = pickle.load(f)
            split = "train" if is_train else "test"
            self.records = list(payload[split])
            self.num_data = len(self.records)
        else:
            rng = np.random.RandomState(seed)
            for _ in range(self.num_data):
                self.records.append(self._make_scene(rng))

        # synthetic scenes carry exact GT joints, so the Panoptic
        # AP/MPJPE protocol (eval/ap.py) applies verbatim; used for
        # held-out metric runs when no real dataset is on the machine
        self.has_evaluate_function = not is_train

    def evaluate(self, fused_poses: np.ndarray) -> dict:
        gts = [np.asarray(r["joints_3d"]) for r in self.records]
        vis = [np.asarray(r["joints_3d_vis"]) for r in self.records]
        return evaluate_ap_mpjpe(fused_poses, gts, vis)

    # ------------------------------------------------------------------
    def _random_center(self, rng, center_list):
        if len(center_list) == 0 or rng.random_sample() < 0.7:
            return np.array([
                rng.uniform(self._space_min[0], self._space_max[0]),
                rng.uniform(self._space_min[1], self._space_max[1])])
        xy = center_list[rng.randint(len(center_list))]
        return xy + rng.normal(500, 50, 2) * rng.choice([1, -1], 2)

    def _visible_from(self, center_xy) -> int:
        cnt = 0
        w, h = self.cfg.ori_image_size
        probe = np.array([[center_xy[0], center_xy[1], 1000.0]])
        rig = self.rigs["synthetic"]
        for c in range(rig.num_cameras):
            uv = project_points_np(probe, rig.camera(c))
            if 10 < uv[0, 0] < w - 10 and 10 < uv[0, 1] < h - 10:
                cnt += 1
        return cnt

    def _placement_valid(self, center, bbox, bbox_list) -> bool:
        if (bbox[0] < self._space_min[0] or bbox[1] < self._space_min[1]
                or bbox[2] > self._space_max[0]
                or bbox[3] > self._space_max[1]):
            return False
        vis = self._visible_from(center)
        if len(bbox_list) == 0:
            return vis >= 2
        bl = np.array(bbox_list)
        x0 = np.maximum(bbox[0], bl[:, 0])
        y0 = np.maximum(bbox[1], bl[:, 1])
        x1 = np.minimum(bbox[2], bl[:, 2])
        y1 = np.minimum(bbox[3], bl[:, 3])
        inter = np.maximum(0, (x1 - x0) * (y1 - y0))
        area = (bbox[2] - bbox[0]) * (bbox[3] - bbox[1])
        areas = (bl[:, 2] - bl[:, 0]) * (bl[:, 3] - bl[:, 1])
        iou = inter / (area + areas - inter)
        return vis >= 2 and np.max(iou) < 0.01

    def _make_scene(self, rng) -> dict:
        cfg = self.cfg
        nposes = rng.randint(cfg.synthetic_max_people) + 1
        chosen = [self.poses[i] for i in
                  rng.randint(len(self.poses), size=nposes)]
        joints_3d = [np.asarray(p["pose"], np.float64).copy()
                     for p in chosen]
        joints_vis = [np.asarray(p["vis"])[:, -1].copy() for p in chosen]

        placed_j, placed_v, bbox_list, center_list = [], [], [], []
        for n in range(nposes):
            points = joints_3d[n][:, :2].copy()
            ids = (list(cfg.root_joint_id))
            center = np.mean([points[j] for j in ids], axis=0)
            rotation = rng.uniform(-180, 180)

            ok = False
            for _ in range(100):
                human_center = self._random_center(rng, center_list)
                xy = rotate_points(points, center, rotation) \
                    - center + human_center
                bbox = _calc_bbox(xy, joints_vis[n])
                if self._placement_valid(human_center, bbox, bbox_list):
                    ok = True
                    break
            if not ok:
                break
            center_list.append(human_center)
            bbox_list.append(bbox)
            pose = joints_3d[n].copy()
            pose[:, :2] = xy
            placed_j.append(pose)
            placed_v.append(joints_vis[n])

        return {
            "seq": "synthetic",
            "joints_3d": placed_j,
            "joints_3d_vis": placed_v,
        }
