"""Synthesised dataset trees in the on-disk formats the datasets read.

No real Panoptic, Shelf or Campus data ships with the repository, so the
tools, their tests and `chip_smoke.py` build the trees they need from a
numpy seed:

- `write_panoptic_sequence`: one CMU-Panoptic sequence, its calibration
  JSON (the real schema, y-up, cm) for the five HD cameras of CAM_LIST,
  `hdPose3d_stage1_coco19/body3DScene_*.json` with standing 15-joint
  skeletons, and empty `hdImgs/<panel>_<node>/*.jpg` files (a frame is
  indexed only where its images exist; the heatmap sources never read
  them);
- `write_shelf_tree`: a Shelf or Campus directory, `actorsGT.mat` (a
  (1, P) cell of (F, 1) cells of (14, 3) metre poses, or (1, 0)
  empties where an actor is absent), `pred_<seq>_maskrcnn_hrnet_coco.pkl`
  (per view and frame, the 17-joint 2D detections in original-image
  pixels) and `calibration_<seq>.json` (a ring rig around the space's
  centre, its focal length scaled to the image width), covering the
  frames its dataset pins.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from fvp_torch.data.panoptic import CAM_LIST, M_AXES
from fvp_torch.eval.pcp import coco2campus3d, coco2shelf3d
from fvp_torch.geometry.cameras import default_ring_rig, project_points_np

# the frames ShelfDataset and CampusDataset read (data/shelf.py)
SHELF_FRAMES = tuple(range(300, 601))
CAMPUS_FRAMES = tuple(range(350, 471)) + tuple(range(650, 751))

# standing skeletons, mm, person-local (x right, y forward, z up)
PANOPTIC15 = np.array([
    [0, 0, 1430], [0, -80, 1580], [0, 0, 930],              # neck nose hip
    [170, 0, 1400], [220, 0, 1120], [240, -40, 860],        # left arm
    [100, 0, 930], [110, 20, 500], [120, 0, 90],            # left leg
    [-170, 0, 1400], [-220, 0, 1120], [-240, -40, 860],     # right arm
    [-100, 0, 930], [-110, 20, 500], [-120, 0, 90],         # right leg
], np.float64)
COCO17 = np.array([
    [0, 0, 1650],                                           # nose
    [-35, 20, 1680], [35, 20, 1680],                        # eyes
    [-80, 0, 1660], [80, 0, 1660],                          # ears
    [-180, 0, 1450], [180, 0, 1450],                        # shoulders
    [-230, 30, 1150], [230, 30, 1150],                      # elbows
    [-250, 60, 880], [250, 60, 880],                        # wrists
    [-110, 0, 1000], [110, 0, 1000],                        # hips
    [-120, 20, 520], [120, 20, 520],                        # knees
    [-130, 40, 80], [130, 40, 80],                          # ankles
], np.float64)


def _placed(template: np.ndarray, center_xy, rng, jitter: float
            ) -> np.ndarray:
    """The template turned about z by a random angle, stood at
    `center_xy`, each joint moved by up to `jitter` mm."""
    a = rng.uniform(-np.pi, np.pi)
    rot = np.array([[np.cos(a), -np.sin(a), 0.0],
                    [np.sin(a), np.cos(a), 0.0],
                    [0.0, 0.0, 1.0]])
    pose = template @ rot.T
    pose[:, :2] += np.asarray(center_xy, np.float64)
    return pose + rng.uniform(-jitter, jitter, pose.shape)


def _panoptic_camera(idx: int, center) -> tuple[np.ndarray, np.ndarray]:
    """World rotation (rows: the camera's axes) and position (mm) of an
    inward-looking ring camera, 4 m out, 1.2 m above `center`, z up."""
    center = np.asarray(center, np.float64)
    ang = 2 * np.pi * idx / len(CAM_LIST)
    pos = center + np.array([4000 * np.cos(ang), 4000 * np.sin(ang), 1200])
    z = center - pos
    z /= np.linalg.norm(z)
    x = np.cross(z, np.array([0.0, 0.0, -1.0]))
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z]), pos


def write_panoptic_sequence(root: str, seq: str, n_frames: int = 13,
                            n_people: int = 2,
                            seed: int = 7) -> dict[int, list[np.ndarray]]:
    """Write one Panoptic sequence under `root/seq`; returns each frame's
    15-joint poses (mm, z up) as written."""
    seq_dir = os.path.join(root, seq)
    anno_dir = os.path.join(seq_dir, "hdPose3d_stage1_coco19")
    os.makedirs(anno_dir, exist_ok=True)
    center = (0.0, -500.0, 800.0)

    # the loader maps R_json -> R_json @ M and T = -(R_json @ M)^T t * 10
    # (data/panoptic.py::load_panoptic_calibration): invert that from the
    # world-frame cameras
    cams = []
    for k, (panel, node) in enumerate(CAM_LIST):
        R_w, T_mm = _panoptic_camera(k, center)
        cams.append({
            "panel": panel, "node": node, "name": f"{panel:02d}_{node:02d}",
            "type": "hd",
            "K": [[1400.0, 0.0, 960.0], [0.0, 1400.0, 540.0],
                  [0.0, 0.0, 1.0]],
            "distCoef": [-0.2, 0.1, 1e-3, -1e-3, 0.05],
            "R": (R_w @ M_AXES.T).tolist(),
            "t": (-R_w @ T_mm / 10.0).reshape(3, 1).tolist(),
        })
    with open(os.path.join(seq_dir, f"calibration_{seq}.json"), "w") as f:
        json.dump({"calibDataSource": "synthesised", "cameras": cams}, f)

    # joints19 in cm, y up: the loader keeps the first 15 rows and applies
    # xyz @ M * 10
    rng = np.random.RandomState(seed)
    gt_mm = {}
    for i in range(n_frames):
        bodies, poses = [], []
        for p in range(n_people):
            xy = (center[0] + 1200.0 * p - 600.0 * (n_people - 1)
                  + rng.uniform(-300, 300),
                  center[1] + rng.uniform(-800, 800))
            pose = _placed(PANOPTIC15, xy, rng, 20.0)
            poses.append(pose)
            j19 = np.zeros((19, 4))
            j19[:15, :3] = (pose @ M_AXES.T) / 10.0
            j19[:15, 3] = rng.uniform(0.5, 1.0, 15)
            bodies.append({"id": p, "joints19": j19.ravel().tolist()})
        with open(os.path.join(anno_dir, f"body3DScene_{i:08d}.json"),
                  "w") as f:
            json.dump({"version": 1.0, "bodies": bodies}, f)
        gt_mm[i] = poses

    for panel, node in CAM_LIST:
        prefix = f"{panel:02d}_{node:02d}"
        img_dir = os.path.join(seq_dir, "hdImgs", prefix)
        os.makedirs(img_dir, exist_ok=True)
        for i in range(n_frames):
            open(os.path.join(img_dir, f"{prefix}_{i:08d}.jpg"), "wb").close()
    return gt_mm


def write_shelf_tree(root: str, seq: str, num_views: int, space_center,
                     ori_image_size) -> dict[int, list[np.ndarray]]:
    """Write a Shelf (`seq` 'shelf') or Campus ('campus') tree into
    `root`, over the frames its dataset reads, with three actors. Actor 1
    is absent on every third frame, as real files hold empty cells. The
    rig is `default_ring_rig` around `space_center`; the 2D detections are
    the GT's projections at score 0.9. Returns each frame's 17-joint COCO
    poses (mm) in actor order."""
    import scipy.io as scio

    if seq not in ("shelf", "campus"):
        raise ValueError(f"unknown tree {seq!r}")
    frames = SHELF_FRAMES if seq == "shelf" else CAMPUS_FRAMES
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(3)
    convert = coco2shelf3d if seq == "shelf" else coco2campus3d
    wanted = set(frames)
    n_total = max(frames) + 1
    # the actors' places about the space centre, mm
    offsets = [(-1300.0, -400.0), (900.0, 500.0), (-100.0, 1400.0)]
    coco_by_frame: dict[int, list[np.ndarray]] = {}

    actor3d = np.empty((1, len(offsets)), dtype=object)
    for p, (dx, dy) in enumerate(offsets):
        cells = np.empty((n_total, 1), dtype=object)
        for fi in range(n_total):
            if fi in wanted and not (p == 1 and fi % 3 == 0):
                xy = (space_center[0] + dx + 150.0 * np.sin(fi / 20.0),
                      space_center[1] + dy + 150.0 * np.cos(fi / 20.0))
                coco = _placed(COCO17, xy, rng, 15.0)
                coco_by_frame.setdefault(fi, []).append(coco)
                cells[fi, 0] = convert(coco.copy()) / 1000.0
            else:
                cells[fi, 0] = np.zeros((1, 0))
        actor3d[0, p] = cells
    scio.savemat(os.path.join(root, "actorsGT.mat"), {"actor3D": actor3d})

    # the focal length scaled to the image width, so that a ring camera
    # sees what it sees at Panoptic's 1920 pixels
    rig = default_ring_rig(num_views, space_center, ori_image_size,
                           focal=1500.0 * ori_image_size[0] / 1920.0)
    cams = {str(i): {k: np.asarray(v).tolist()
                     for k, v in rig.camera(i).items()}
            for i in range(num_views)}
    with open(os.path.join(root, f"calibration_{seq}.json"), "w") as f:
        json.dump(cams, f)

    pred2d = {}
    for fi in frames:
        for k in range(num_views):
            pred2d[f"{k}_{fi}"] = [
                {"pred": np.concatenate(
                    [project_points_np(coco, rig.camera(k)),
                     np.full((17, 1), 0.9)], axis=1).astype(np.float32)}
                for coco in coco_by_frame.get(fi, [])]
    with open(os.path.join(root, f"pred_{seq}_maskrcnn_hrnet_coco.pkl"),
              "wb") as f:
        pickle.dump(pred2d, f)
    return coco_by_frame
