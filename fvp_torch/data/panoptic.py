"""CMU-Panoptic dataset: sequences, calibration, GT poses, AP evaluation.

A copy of the reference package's `data/panoptic.py` (after the original
implementation's lib/dataset/panoptic.py): 9 train /
4 val sequences, 5 HD cameras (panels (0,3),(0,6),(0,12),(0,13),(0,23)),
frame subsampling interval 3 (train) / 12 (val), the y-up -> z-up axis
rotation M applied to both poses and camera extrinsics, cm -> mm x10, and the
AP/MPJPE evaluation protocol.
"""

from __future__ import annotations

import glob
import json
import os.path as osp
import pickle

import numpy as np

from fvp_torch.config import FVPConfig
from fvp_torch.data.base import PoseDataset
from fvp_torch.eval.ap import evaluate_ap_mpjpe
from fvp_torch.geometry.cameras import CameraRig

TRAIN_LIST = [
    "160422_ultimatum1", "160224_haggling1", "160226_haggling1",
    "161202_haggling1", "160906_ian1", "160906_ian2", "160906_ian3",
    "160906_band1", "160906_band2",
]
VAL_LIST = [
    "160906_pizza1", "160422_haggling1", "160906_ian5", "160906_band4",
]

CAM_LIST = [(0, 3), (0, 6), (0, 12), (0, 13), (0, 23)]

# y-up (panoptic) -> z-up (ours)
M_AXES = np.array([[1.0, 0.0, 0.0],
                   [0.0, 0.0, -1.0],
                   [0.0, 1.0, 0.0]])

JOINTS_DEF = {
    "neck": 0, "nose": 1, "mid-hip": 2,
    "l-shoulder": 3, "l-elbow": 4, "l-wrist": 5,
    "l-hip": 6, "l-knee": 7, "l-ankle": 8,
    "r-shoulder": 9, "r-elbow": 10, "r-wrist": 11,
    "r-hip": 12, "r-knee": 13, "r-ankle": 14,
}

LIMBS15 = [[0, 1], [0, 2], [0, 3], [3, 4], [4, 5], [0, 9], [9, 10],
           [10, 11], [2, 6], [6, 7], [7, 8], [2, 12], [12, 13], [13, 14]]


def load_panoptic_calibration(cam_file: str,
                              cam_list=None) -> CameraRig:
    """Per-sequence calibration JSON -> CameraRig with the axis rotation and
    cm->mm conversion (panoptic.py:171-205)."""
    cam_list = cam_list or CAM_LIST
    with open(cam_file) as f:
        calib = json.load(f)
    sel = {}
    for cam in calib["cameras"]:
        key = (cam["panel"], cam["node"])
        if key in cam_list:
            K = np.array(cam["K"])
            dist = np.array(cam["distCoef"])
            R = np.array(cam["R"]).dot(M_AXES)
            t = np.array(cam["t"]).reshape(3, 1)
            sel[key] = {
                "R": R,
                "T": -np.dot(R.T, t) * 10.0,
                "fx": K[0, 0], "fy": K[1, 1],
                "cx": K[0, 2], "cy": K[1, 2],
                "k": dist[[0, 1, 4]].reshape(3, 1),
                "p": dist[[2, 3]].reshape(2, 1),
            }
    return CameraRig.from_dicts([sel[k] for k in cam_list if k in sel])


class PanopticDataset(PoseDataset):
    def __init__(self, cfg: FVPConfig, is_train: bool = True,
                 sequences=None):
        super().__init__(cfg, is_train)
        self.has_evaluate_function = True
        self.num_views = cfg.num_views
        self.cam_list = CAM_LIST[:cfg.num_views]
        self.interval = 3 if is_train else 12
        self.sequence_list = sequences if sequences is not None else (
            TRAIN_LIST if is_train else VAL_LIST)

        for seq in self.sequence_list:
            cam_file = osp.join(cfg.data_dir, seq,
                                f"calibration_{seq}.json")
            self.rigs[seq] = load_panoptic_calibration(cam_file,
                                                       self.cam_list)

        cache = osp.join(cfg.data_dir,
                         f"{'train' if is_train else 'validation'}"
                         f"_meta_fvp.pkl")
        if osp.exists(cache):
            with open(cache, "rb") as f:
                info = pickle.load(f)
            assert info["sequence_list"] == self.sequence_list
            assert info["interval"] == self.interval
            self.records = info["records"]
        else:
            self._index_records()
            with open(cache, "wb") as f:
                pickle.dump({"sequence_list": self.sequence_list,
                             "interval": self.interval,
                             "records": self.records}, f)

    # ------------------------------------------------------------------
    def _index_records(self) -> None:
        cfg = self.cfg
        for seq in self.sequence_list:
            anno_dir = osp.join(cfg.data_dir, seq, "hdPose3d_stage1_coco19")
            anno_files = sorted(glob.iglob(f"{anno_dir}/*.json"))
            for i, anno_file in enumerate(anno_files):
                if i % self.interval != 0:
                    continue
                with open(anno_file) as f:
                    bodies = json.load(f)["bodies"]
                if len(bodies) == 0:
                    continue

                image_paths = []
                missing = False
                for k in range(self.num_views):
                    suffix = osp.basename(anno_file).replace(
                        "body3DScene", "").replace("json", "jpg")
                    prefix = "{:02d}_{:02d}".format(*self.cam_list[k])
                    path = osp.join(cfg.data_dir, seq, "hdImgs", prefix,
                                    prefix + suffix)
                    if not osp.exists(path):
                        missing = True
                        break
                    image_paths.append(path)
                if missing:
                    continue

                poses, vis_list = [], []
                for body in bodies:
                    pose = np.array(body["joints19"]).reshape(-1, 4)
                    pose = pose[:cfg.num_joints]
                    vis = np.maximum(pose[:, -1], 0.0)
                    root = cfg.root_joint_id[0]
                    if vis[root] <= 0.1:
                        continue
                    xyz = pose[:, 0:3].dot(M_AXES) * 10.0
                    poses.append(xyz)
                    vis_list.append(vis)
                if poses:
                    self.records.append({
                        "seq": seq,
                        "image_paths": image_paths,
                        "joints_3d": poses,
                        "joints_3d_vis": vis_list,
                    })

    # ------------------------------------------------------------------
    def _load_images(self, rec) -> np.ndarray:
        from fvp_torch.data.images import load_and_resize_views
        return load_and_resize_views(self.cfg, rec["image_paths"])

    def evaluate(self, fused_poses: np.ndarray) -> dict:
        gts = [np.asarray(r["joints_3d"]) for r in self.records]
        vis = [np.asarray(r["joints_3d_vis"]) for r in self.records]
        return evaluate_ap_mpjpe(fused_poses, gts, vis)
