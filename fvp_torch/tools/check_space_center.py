"""Calibration check: the configured SPACE_CENTER against the statistics
of the GT root positions of a dataset split. The capture space's centre
should sit near the mean of the observed roots; a large offset silently
degrades the voxel coverage.

The port's counterpart of the reference package's
tools/check_space_center.py, with the same flags and output:

    python -m fvp_torch.tools.check_space_center \
        --cfg configs/panoptic/jln64.yaml [--split test]
"""

from __future__ import annotations

import argparse

import numpy as np

from fvp_torch.config import load_config
from fvp_torch.data.registry import build_dataset
from fvp_torch.data.targets import root_center


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--split", default="test", choices=["train", "test"])
    args = parser.parse_args(argv)

    cfg = load_config(args.cfg)
    name = cfg.train_dataset if args.split == "train" else cfg.test_dataset
    ds = build_dataset(name, cfg, is_train=args.split == "train")

    roots = []
    for rec in ds.records:
        for pose in rec.get("joints_3d", []):
            roots.append(root_center(np.asarray(pose), cfg.root_joint_id))
    if not roots:
        print("no GT poses found")
        return 0
    roots = np.asarray(roots)
    mean = roots.mean(axis=0)
    lo, hi = roots.min(axis=0), roots.max(axis=0)
    center = np.asarray(cfg.space_center)
    half = np.asarray(cfg.space_size) / 2.0

    print(f"frames: {len(ds.records)}, people: {len(roots)}")
    print(f"root mean:      {np.round(mean, 1)}")
    print(f"root range:     {np.round(lo, 1)} .. {np.round(hi, 1)}")
    print(f"SPACE_CENTER:   {center}")
    print(f"center offset:  {np.round(mean - center, 1)} mm")
    inside = np.all((roots >= center - half) & (roots <= center + half),
                    axis=1)
    print(f"roots inside capture space: {inside.mean() * 100:.2f}%")
    if np.linalg.norm((mean - center)[:2]) > 500:
        print("WARNING: SPACE_CENTER is >500mm from the observed root mean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
