"""Pose libraries for the synthetic data factory (a copy of the reference
package's `data/poses.py`).

The reference trains Shelf/Campus from real Panoptic poses stored in
`panoptic_training_pose.pkl` (configs/shelf/jln64.yaml:38). That file is not
redistributed here, so we support both:
  * `load_pose_library(path)` — the reference pkl format
    (list of {'pose': (J,3), 'vis': (J,4)});
  * `procedural_pose_library(...)` — a parametric human-skeleton sampler
    producing plausible standing/walking poses in panoptic-15 or coco-17
    joint order, used by tests, benchmarks and bootstrap training.
"""

from __future__ import annotations

import pickle

import numpy as np

# canonical standing skeleton, z-up, mm; (x: lateral, y: depth, z: height)
_PANOPTIC15 = np.array([
    [0, 0, 1430],       # 0 neck
    [0, -80, 1580],     # 1 nose
    [0, 0, 930],        # 2 mid-hip
    [170, 0, 1400],     # 3 l-shoulder
    [220, 0, 1120],     # 4 l-elbow
    [240, -40, 860],    # 5 l-wrist
    [100, 0, 930],      # 6 l-hip
    [110, 20, 500],     # 7 l-knee
    [120, 0, 90],       # 8 l-ankle
    [-170, 0, 1400],    # 9 r-shoulder
    [-220, 0, 1120],    # 10 r-elbow
    [-240, -40, 860],   # 11 r-wrist
    [-100, 0, 930],     # 12 r-hip
    [-110, 20, 500],    # 13 r-knee
    [-120, 0, 90],      # 14 r-ankle
], np.float64)

_COCO17 = np.array([
    [0, -80, 1580],     # 0 nose
    [30, -90, 1620],    # 1 l-eye
    [-30, -90, 1620],   # 2 r-eye
    [70, -40, 1600],    # 3 l-ear
    [-70, -40, 1600],   # 4 r-ear
    [170, 0, 1400],     # 5 l-shoulder
    [-170, 0, 1400],    # 6 r-shoulder
    [220, 0, 1120],     # 7 l-elbow
    [-220, 0, 1120],    # 8 r-elbow
    [240, -40, 860],    # 9 l-wrist
    [-240, -40, 860],   # 10 r-wrist
    [100, 0, 930],      # 11 l-hip
    [-100, 0, 930],     # 12 r-hip
    [110, 20, 500],     # 13 l-knee
    [-110, 20, 500],    # 14 r-knee
    [120, 0, 90],       # 15 l-ankle
    [-120, 0, 90],      # 16 r-ankle
], np.float64)


def canonical_pose(num_joints: int) -> np.ndarray:
    if num_joints == 15:
        return _PANOPTIC15.copy()
    if num_joints == 17:
        return _COCO17.copy()
    raise ValueError(f"no canonical skeleton with {num_joints} joints")


def _jitter_pose(rng: np.random.RandomState, base: np.ndarray) -> np.ndarray:
    pose = base.copy()
    # overall body yaw
    yaw = rng.uniform(-np.pi, np.pi)
    rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                    [np.sin(yaw), np.cos(yaw), 0],
                    [0, 0, 1.0]])
    # limb articulation: independent per-joint jitter, larger for extremities
    height = pose[:, 2]
    extremity = np.clip(1.2 - height / 1600.0, 0.3, 1.2)[:, None]
    pose = pose + rng.normal(0, 55.0, pose.shape) * extremity
    # slight crouch / height scaling
    pose[:, 2] *= rng.uniform(0.9, 1.05)
    pose = pose @ rot.T
    return pose


def procedural_pose_library(num_joints: int, count: int,
                            seed: int = 0) -> list[dict]:
    rng = np.random.RandomState(seed)
    base = canonical_pose(num_joints)
    out = []
    for _ in range(count):
        pose = _jitter_pose(rng, base)
        vis = np.ones((num_joints, 4), np.float64)
        out.append({"pose": pose, "vis": vis})
    return out


def load_pose_library(path: str) -> list[dict]:
    with open(path, "rb") as f:
        return pickle.load(f)
