"""Custom (user-captured) dataset: eval-only image sequences with a
per-take calibration.json; no GT / no evaluator.

A copy of the reference package's `data/custom.py` (after the original
implementation's lib/dataset/custom.py): images under
Take_*/<cam_id>/*.png, calibration storing intrinsics 'k' = [fx, fy, cx, cy],
distortion 'd' (OpenCV 5-coeff order) and a 3x4 projection 'p'; extrinsics
recovered via K^-1 @ P (custom.py:111-144).
"""

from __future__ import annotations

import json
import os.path as osp
from glob import glob

import numpy as np

from fvp_torch.config import FVPConfig
from fvp_torch.data.base import PoseDataset
from fvp_torch.geometry.cameras import CameraRig


def load_custom_calibration(cam_file: str, cam_list=None) -> CameraRig:
    with open(cam_file) as f:
        calib = json.load(f)
    keys = cam_list or sorted(calib.keys())
    cams = []
    for key in keys:
        c = calib[key]
        fx, fy, cx, cy = c["k"][:4]
        d = np.asarray(c["d"], np.float64)
        P = np.asarray(c["p"], np.float64).reshape(3, 4)
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        T_cam_world = np.linalg.inv(K) @ P
        R = T_cam_world[:3, :3]
        t = T_cam_world[:3, 3].reshape(3, 1)
        cams.append({
            "R": R,
            "T": -R.T @ t,
            "fx": fx, "fy": fy, "cx": cx, "cy": cy,
            "k": d[[0, 1, 4]].reshape(3, 1),
            "p": d[[2, 3]].reshape(2, 1),
        })
    return CameraRig.from_dicts(cams)


class CustomDataset(PoseDataset):
    def __init__(self, cfg: FVPConfig, is_train: bool = False,
                 sequences=("Take_035",),
                 cam_list=("44310001", "44310002", "44310006", "44310010")):
        if is_train:
            raise NotImplementedError(
                "training is not supported for the custom dataset")
        super().__init__(cfg, is_train)
        self.has_evaluate_function = False
        self.cam_list = list(cam_list)[:cfg.num_views]

        for seq in sequences:
            cam_file = osp.join(cfg.data_dir, seq, "calibration.json")
            if not osp.exists(cam_file):
                continue
            self.rigs[seq] = load_custom_calibration(cam_file, self.cam_list)
            pattern = osp.join(cfg.data_dir, seq, self.cam_list[0], "*.png")
            for image_path in sorted(glob(pattern)):
                paths = [osp.join(cfg.data_dir, seq, cam,
                                  osp.basename(image_path))
                         for cam in self.cam_list]
                if all(osp.exists(p) for p in paths):
                    self.records.append({"seq": seq, "image_paths": paths})

    def _load_images(self, rec) -> np.ndarray:
        from fvp_torch.data.images import load_and_resize_views
        return load_and_resize_views(self.cfg, rec["image_paths"])
