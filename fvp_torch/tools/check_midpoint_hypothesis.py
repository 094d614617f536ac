"""Calibration analysis: is SPACE_CENTER the midpoint (min + max) / 2 of
the observed GT root positions, rather than their mean? Collects every
visible root across a dataset split, compares the configured
SPACE_CENTER with the coordinate midpoint, reports the relative error
with a 5% x/y verdict threshold, and with --visualize plots the
distribution.

The port's counterpart of the reference package's
tools/check_midpoint_hypothesis.py, with the same flags and output:

    python -m fvp_torch.tools.check_midpoint_hypothesis \
        --cfg configs/panoptic/jln64.yaml [--split test] [--visualize]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from fvp_torch.config import load_config
from fvp_torch.data.registry import build_dataset
from fvp_torch.data.targets import root_center


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--split", default="test", choices=["train", "test"])
    parser.add_argument("--visualize", action="store_true")
    parser.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "midpoint_hypothesis.png"))
    args = parser.parse_args(argv)

    cfg = load_config(args.cfg)
    name = cfg.train_dataset if args.split == "train" else cfg.test_dataset
    ds = build_dataset(name, cfg, is_train=args.split == "train")

    centers = []
    for rec in ds.records:
        for pose, vis in zip(rec.get("joints_3d", []),
                             rec.get("joints_3d_vis", [])):
            vis = np.asarray(vis)
            ids = [j for j in cfg.root_joint_id if vis[j] > 0.1]
            if ids:
                centers.append(root_center(np.asarray(pose), tuple(ids)))
    if not centers:
        print("no GT poses found")
        return 0
    centers = np.asarray(centers)

    mean = centers.mean(axis=0)
    lo, hi = centers.min(axis=0), centers.max(axis=0)
    midpoint = (lo + hi) / 2.0
    space_center = np.asarray(cfg.space_center)

    print(f"people observed: {len(centers)}")
    print(f"mean:     {np.round(mean, 1)}")
    print(f"min..max: {np.round(lo, 1)} .. {np.round(hi, 1)}")
    print(f"midpoint (min+max)/2: {np.round(midpoint, 1)}")
    print(f"SPACE_CENTER:         {space_center}")
    diff = midpoint - space_center
    print(f"midpoint - SPACE_CENTER: {np.round(diff, 1)} mm")
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = 100 * np.abs(np.where(midpoint != 0, diff / midpoint, 0.0))
    print(f"relative error: {np.round(rel, 2)} %")
    if np.all(rel[:2] < 5.0):
        print("verdict: SPACE_CENTER x/y matches the coordinate midpoint "
              "(<5% relative error) — the midpoint hypothesis holds")
    else:
        print("verdict: SPACE_CENTER x/y differs from the coordinate "
              "midpoint by >5% — the midpoint hypothesis does NOT hold")

    if args.visualize:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(12, 5))
        axes[0].scatter(centers[:, 0], centers[:, 1], s=1, alpha=0.15)
        axes[0].scatter(*space_center[:2], c="red", marker="x", s=100,
                        label="SPACE_CENTER")
        axes[0].scatter(*midpoint[:2], c="green", marker="+", s=100,
                        label="midpoint")
        axes[0].set_title("root positions (x-y)")
        axes[0].legend()
        axes[1].hist(centers[:, 2], bins=50)
        axes[1].axvline(space_center[2], color="red", label="SPACE_CENTER z")
        axes[1].set_title("root z distribution")
        axes[1].legend()
        fig.tight_layout()
        fig.savefig(args.out, dpi=120)
        plt.close(fig)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
