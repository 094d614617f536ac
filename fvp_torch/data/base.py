"""Dataset base: multi-view scene records -> fixed-shape numpy samples.

A copy of the reference package's `data/base.py` (after the original
implementation's lib/dataset/JointsDataset.py) on the port's geometry. Each
record describes one synchronized multi-view frame; `sample()` produces
padded, fixed-shape arrays ready to stack into device batches:

  input_heatmaps (V, J, hm_h, hm_w)   [gt/pred heatmap sources]
  targets: index/offset/bbox/2d/1d/mask (max_people-padded)
  meta: num_person, joints_3d, joints_3d_vis, roots_3d, bbox

The three heatmap sources mirror the reference (config.py:38-40):
  'image' — raw views for the backbone (loaded by subclasses),
  'gt'    — gaussians rendered at projected GT joints (mock backbone),
  'pred'  — gaussians rendered at offline 2D detections.

Host rendering runs the native C++ renderer (data/native.py), as the
reference package does where its library is built: each augmented view
draws the renderer's seed from `rng`, and the renderer draws its
augmentation from that seed. With the native path switched off
(`native.ENABLED = False`) the numpy renderer (data/heatmaps.py) draws
from `rng` after the seed, as the reference package's fallback does.
Every draw from `rng` is taken in the reference package's order, so a
seeded sample is bit for bit the reference package's, native path on or
off on both sides.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np

from fvp_torch.config import FVPConfig
from fvp_torch.data import native
from fvp_torch.data.heatmaps import (
    compute_human_scale, generate_input_heatmap,
)
from fvp_torch.data.targets import generate_target, root_center
from fvp_torch.geometry.cameras import CameraRig, project_points_np
from fvp_torch.geometry.transforms import affine_apply, get_resize_transform


def _render(cfg, joints, joints_vis, augment: bool, rng) -> np.ndarray:
    """One view's heatmaps (J, hm_h, hm_w): the native renderer from the
    seed drawn from `rng` (per augmented view, as the reference package
    draws it), or the numpy renderer from `rng` where the native path is
    off or there is nobody."""
    seed = int(rng.randint(0, 2 ** 31)) if augment else 0
    hm = native.generate_input_heatmap_native(cfg, joints, joints_vis,
                                              augment=augment, seed=seed)
    if hm is None:
        hm = generate_input_heatmap(cfg, joints, joints_vis=joints_vis,
                                    augment=augment, rng=rng)
    return hm


class PoseDataset:
    def __init__(self, cfg: FVPConfig, is_train: bool):
        self.cfg = cfg
        self.is_train = is_train
        self.heatmap_src = (cfg.train_heatmap_src if is_train
                            else cfg.test_heatmap_src)
        # heatmap-level augmentation gate (reference JointsDataset.py:62
        # reads DATASET.DATA_AUGMENTATION; the Synthetic subclass overrides
        # this with SYNTHETIC.DATA_AUGMENTATION, synthetic.py:31)
        self.data_augmentation = cfg.data_augmentation
        self.resize_transform = get_resize_transform(
            cfg.ori_image_size, cfg.image_size)
        # seq name -> CameraRig
        self.rigs: dict[str, CameraRig] = {}
        self.records: list[dict[str, Any]] = []
        self.has_evaluate_function = False

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.records)

    def rig_for(self, seq: str) -> CameraRig:
        return self.rigs[seq]

    # ------------------------------------------------------------------
    def _padded_meta(self, rec: Mapping[str, Any]) -> dict[str, np.ndarray]:
        cfg = self.cfg
        maxp, J = cfg.max_people, cfg.num_joints
        joints = rec.get("joints_3d", [])
        vis = rec.get("joints_3d_vis", [])
        n = len(joints)
        j3d = np.zeros((maxp, J, 3), np.float32)
        jvis = np.zeros((maxp, J), np.float32)
        for i in range(n):
            j3d[i] = np.asarray(joints[i])[:, :3]
            jvis[i] = np.asarray(vis[i])
        roots = np.stack([root_center(j3d[i], cfg.root_joint_id)
                          for i in range(maxp)])
        return {
            "num_person": np.int32(n),
            "joints_3d": j3d,
            "joints_3d_vis": jvis,
            "roots_3d": roots.astype(np.float32),
        }

    # ------------------------------------------------------------------
    def _project_gt_views(self, rec) -> tuple[list, list]:
        """Project GT joints into every view with the reference's visibility
        logic (JointsDataset.py:229-258). Returns per-view lists of
        per-person (J, 2) working-image coords and (J,) visibility."""
        cfg = self.cfg
        rig = self.rig_for(rec["seq"])
        joints_3d = rec["joints_3d"]
        joints_3d_vis = rec["joints_3d_vis"]
        views_2d, views_vis = [], []
        for c in range(rig.num_cameras):
            joints_2d, joints_vis = [], []
            for n in range(len(joints_3d)):
                pose = project_points_np(
                    np.asarray(joints_3d[n], np.float64), rig.camera(c))
                in_x = (pose[:, 0] >= 0) & (
                    pose[:, 0] <= cfg.ori_image_size[0] - 1)
                in_y = (pose[:, 1] >= 0) & (
                    pose[:, 1] <= cfg.ori_image_size[1] - 1)
                vis = (np.asarray(joints_3d_vis[n]) > 0).astype(np.float64)
                vis[~(in_x & in_y)] = 0
                pose = affine_apply(pose, self.resize_transform)
                bad = ((pose.min(axis=1) < 0)
                       | (pose[:, 0] >= cfg.image_size[0])
                       | (pose[:, 1] >= cfg.image_size[1]))
                vis[bad] = 0
                joints_2d.append(pose)
                joints_vis.append(vis)
            views_2d.append(joints_2d)
            views_vis.append(joints_vis)
        return views_2d, views_vis

    def _render_gt_heatmaps(self, rec, rng) -> np.ndarray:
        cfg = self.cfg
        views_2d, views_vis = self._project_gt_views(rec)
        augment = self.data_augmentation
        out = []
        for joints_2d, joints_vis in zip(views_2d, views_vis):
            out.append(_render(cfg, joints_2d, joints_vis, augment, rng))
        return np.stack(out)

    def pack_render_params(self, views_2d, views_vis, rng) -> dict:
        """Fixed-shape per-sample payload for the on-device renderer
        (ops/heatmap_render.py): projected coords, visibility, per-person
        sigma, and host-drawn augmentation parameters. ~600x smaller than
        the rendered heatmaps."""
        cfg = self.cfg
        # the payload must cover every person the host renderer would
        # splat, not just the model's proposal cap (SYNTHETIC.MAX_PEOPLE
        # is independent of CAPTURE_SPEC.MAX_PEOPLE); P stays
        # config-static so batches keep one compiled shape
        V, J = len(views_2d), cfg.num_joints
        P = max(cfg.max_people, cfg.synthetic_max_people)
        if any(len(v) > P for v in views_2d) and not getattr(
                self, "_warned_render_trunc", False):
            self._warned_render_trunc = True
            print(f"WARNING: device_render truncating scene to {P} "
                  f"people (host renderer would splat all); raise "
                  f"CAPTURE_SPEC.MAX_PEOPLE for full parity", flush=True)
        hm_w, hm_h = cfg.heatmap_size
        stride = (np.asarray(cfg.image_size, np.float64)
                  / np.asarray(cfg.heatmap_size, np.float64))
        mu = np.zeros((V, P, J, 2), np.int32)
        vis = np.zeros((V, P, J), np.float32)
        sig = np.zeros((V, P), np.float32)
        scl = np.ones((V, P, J), np.float32)
        occ = np.zeros((V, P, J, 4), np.int32)
        augment = self.data_augmentation
        for v in range(V):
            people = views_2d[v][:P]
            for n, pose in enumerate(people):
                pose = np.asarray(pose, np.float64)[:, :2]
                hs = 2.0 * compute_human_scale(pose / stride, np.ones(J))
                if hs == 0.0:
                    continue
                sig[v, n] = cfg.sigma * np.sqrt(hs / (96.0 * 96.0))
                # int() truncation in float64 — exactly the reference's
                # mu = int(coord / feat_stride)
                mu[v, n] = np.trunc(
                    np.clip(pose / stride, -1e9, 1e9)).astype(np.int32)
                pv = (views_vis[v][n] if views_vis is not None
                      else np.ones(J))
                vis[v, n] = np.asarray(pv, np.float32)
                if augment:
                    for j in range(J):
                        s = (0.9 + rng.randn() * 0.03
                             if rng.random_sample() < 0.6 else 1.0)
                        if j in (7, 8):
                            s = s * 0.5 if rng.random_sample() < 0.1 else s
                        elif j in (9, 10):
                            s = s * 0.2 if rng.random_sample() < 0.1 else s
                        else:
                            s = s * 0.5 if rng.random_sample() < 0.05 else s
                        scl[v, n, j] = s
                        y0 = int(rng.uniform(0, hm_h - 1))
                        x0 = int(rng.uniform(0, hm_w - 1))
                        y1 = int(min(y0 + rng.uniform(hm_h / 4,
                                                      hm_h * 0.75), hm_h))
                        x1 = int(min(x0 + rng.uniform(hm_w / 4,
                                                      hm_w * 0.75), hm_w))
                        occ[v, n, j] = (y0, y1, x0, x1)
        return {"mu": mu, "vis": vis, "sigma": sig, "scale": scl,
                "occ": occ}

    def _mapped_pred_views(self, rec) -> list:
        """Offline per-view 2D predictions mapped into working-image
        coordinates — the single source for both the host renderer and the
        device render-params payload."""
        return [[affine_apply(np.asarray(p)[:, :2], self.resize_transform)
                 for p in view_preds]
                for view_preds in rec["pred_pose2d"]]

    def _render_pred_heatmaps(self, rec, rng) -> np.ndarray:
        """Render heatmaps from offline per-view 2D predictions (already in
        original-image coordinates). Augmentation follows the same
        DATA_AUGMENTATION gate as the gt path (the reference's
        generate_input_heatmap applies it to every source,
        JointsDataset.py:414)."""
        augment = self.data_augmentation
        out = []
        for mapped in self._mapped_pred_views(rec):
            out.append(_render(self.cfg, mapped, None, augment, rng))
        return np.stack(out)

    # ------------------------------------------------------------------
    def sample(self, idx: int,
               rng: Optional[np.random.RandomState] = None) -> dict:
        rng = rng or np.random.RandomState()
        rec = self.records[idx]
        out: dict[str, Any] = {"meta": self._padded_meta(rec)}

        if "joints_3d" in rec:
            target = generate_target(self.cfg, rec["joints_3d"],
                                     rec["joints_3d_vis"])
            out["meta"]["bbox"] = target["bbox"]
            out["targets"] = {k: np.asarray(v) for k, v in target.items()}
        else:
            out["meta"]["bbox"] = np.zeros((self.cfg.max_people, 2),
                                           np.float32)

        if self.heatmap_src == "gt":
            if self.cfg.device_render:
                out["render_params"] = self.pack_render_params(
                    *self._project_gt_views(rec), rng)
            else:
                out["input_heatmaps"] = self._render_gt_heatmaps(rec, rng)
        elif self.heatmap_src == "pred":
            if self.cfg.device_render:
                out["render_params"] = self.pack_render_params(
                    self._mapped_pred_views(rec), None, rng)
            else:
                out["input_heatmaps"] = self._render_pred_heatmaps(rec, rng)
        elif self.heatmap_src == "image":
            out["images"] = self._load_images(rec)
        else:
            raise ValueError(self.heatmap_src)
        return out

    def _load_images(self, rec) -> np.ndarray:
        raise NotImplementedError

    def evaluate(self, all_fused_poses: np.ndarray):
        raise NotImplementedError
