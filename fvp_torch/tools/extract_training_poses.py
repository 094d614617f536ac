"""Build panoptic_training_pose.pkl, the pose library that feeds the
synthetic data factory for Shelf and Campus training (SYNTHETIC.POSE_FILE,
configs/shelf/jln64.yaml).

The port's counterpart of the reference package's
tools/extract_training_poses.py, with the same flags and output: the
Panoptic training sequences' 3D poses (every `--interval`-th frame; a
body kept where its root is seen and at least 10 joints are), root-centred
in xy, in the library format ({'pose': (J, 3) mm, 'vis': (J, 4)}), in
Panoptic-15 order or with --coco17 in COCO-17 order (head joints
approximated) for the Shelf and Campus configs.

    python -m fvp_torch.tools.extract_training_poses --data_dir data/Panoptic \
        --out data/panoptic_training_pose.pkl [--coco17]
"""

from __future__ import annotations

import argparse
import glob
import json
import os.path as osp
import pickle

import numpy as np

from fvp_torch.data.panoptic import M_AXES, TRAIN_LIST

# panoptic-15 -> coco-17 joint mapping (approximate head joints synthesized)
P15_TO_COCO = {
    5: 3, 6: 9, 7: 4, 8: 10, 9: 5, 10: 11, 11: 6, 12: 12,
    13: 7, 14: 13, 15: 8, 16: 14,
}


def panoptic15_to_coco17(pose15: np.ndarray) -> np.ndarray:
    coco = np.zeros((17, 3))
    coco[0] = pose15[1]                                 # nose
    neck, nose = pose15[0], pose15[1]
    up = nose - neck
    coco[1] = nose + 0.3 * up + [30, 0, 0]              # eyes/ears approx
    coco[2] = nose + 0.3 * up + [-30, 0, 0]
    coco[3] = nose + 0.15 * up + [70, 0, 0]
    coco[4] = nose + 0.15 * up + [-70, 0, 0]
    for c, p in zip((5, 7, 9, 11, 13, 15), (3, 4, 5, 6, 7, 8)):
        coco[c] = pose15[p]                             # left chain
    for c, p in zip((6, 8, 10, 12, 14, 16), (9, 10, 11, 12, 13, 14)):
        coco[c] = pose15[p]                             # right chain
    return coco


def extract(data_dir: str, coco17: bool = False, interval: int = 12,
            max_poses: int = 50000) -> list[dict]:
    """The library's entries, in sequence and frame order."""
    poses = []
    for seq in TRAIN_LIST:
        anno_dir = osp.join(data_dir, seq, "hdPose3d_stage1_coco19")
        files = sorted(glob.glob(f"{anno_dir}/*.json"))
        for i, f in enumerate(files):
            if i % interval:
                continue
            with open(f) as fh:
                bodies = json.load(fh)["bodies"]
            for body in bodies:
                p = np.array(body["joints19"]).reshape(-1, 4)[:15]
                vis = np.maximum(p[:, 3], 0.0)
                if vis[2] <= 0.1 or (vis > 0.1).sum() < 10:
                    continue
                xyz = p[:, :3].dot(M_AXES) * 10.0
                # center at the root in xy so placement is translation-free
                xyz[:, :2] -= xyz[2, :2]
                if coco17:
                    xyz = panoptic15_to_coco17(xyz)
                    vis = np.ones(17)
                poses.append({"pose": xyz,
                              "vis": np.tile(vis[:, None], (1, 4))})
            if len(poses) >= max_poses:
                return poses
    return poses


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--coco17", action="store_true",
                        help="emit coco-17 order (for Shelf/Campus configs)")
    parser.add_argument("--interval", type=int, default=12)
    parser.add_argument("--max_poses", type=int, default=50000)
    args = parser.parse_args(argv)

    poses = extract(args.data_dir, args.coco17, args.interval,
                    args.max_poses)
    with open(args.out, "wb") as f:
        pickle.dump(poses, f)
    print(f"wrote {len(poses)} poses to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
