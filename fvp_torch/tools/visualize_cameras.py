"""3D camera-rig plot: the camera positions and optical axes of a dataset
split's first rig, and the capture-space box, for any dataset config.

The port's counterpart of the reference package's
tools/visualize_cameras.py, with the same flags and output:

    python -m fvp_torch.tools.visualize_cameras \
        --cfg configs/shelf/jln64.yaml --out cameras.png [--split test]
"""

from __future__ import annotations

import argparse

import numpy as np

from fvp_torch.config import load_config
from fvp_torch.data.registry import build_dataset


def main(argv=None) -> int:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--out", default="cameras.png")
    parser.add_argument("--split", default="test", choices=["train", "test"])
    args = parser.parse_args(argv)

    cfg = load_config(args.cfg)
    name = cfg.train_dataset if args.split == "train" else cfg.test_dataset
    ds = build_dataset(name, cfg, is_train=args.split == "train")

    fig = plt.figure(figsize=(9, 8))
    ax = fig.add_subplot(projection="3d")

    center = np.asarray(cfg.space_center)
    half = np.asarray(cfg.space_size) / 2.0
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)]) * half + center
    for i in range(8):
        for j in range(i + 1, 8):
            if np.sum(corners[i] != corners[j]) == 1:
                ax.plot(*zip(corners[i], corners[j]), c="gray", lw=0.5)

    for seq, rig in ds.rigs.items():
        for v in range(rig.num_cameras):
            pos = np.asarray(rig.T[v])
            ax.scatter(*pos, c="red", s=40)
            # optical axis: third row of R points forward in camera frame
            fwd = np.asarray(rig.R[v])[2] * 800.0
            ax.quiver(*pos, *fwd, color="blue")
            ax.text(*pos, f"{seq[:6]}:{v}", fontsize=7)
        break   # one rig is representative for a fixed-rig dataset

    ax.set_xlabel("x (mm)")
    ax.set_ylabel("y (mm)")
    ax.set_zlabel("z (mm)")
    fig.savefig(args.out, dpi=110)
    plt.close(fig)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
