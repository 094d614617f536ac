"""Offline dataset image resize: every image of a dataset warped in place
to the working resolution by the aspect-preserving affine the datasets
use (geometry/transforms.py::get_resize_transform), so that the per-frame
warp leaves the input path.

The port's counterpart of the reference package's tools/preprocess.py,
with the same flags, size table and directory patterns:

    python -m fvp_torch.tools.preprocess --dataset panoptic \
        --dir data/Panoptic [--dry-run]
"""

from __future__ import annotations

import argparse
import os
from glob import glob

from fvp_torch.geometry.transforms import get_resize_transform

SIZES = {
    # dataset: (ori_w, ori_h), (out_w, out_h)
    "panoptic": ((1920, 1080), (960, 512)),
    "shelf": ((1032, 776), (800, 608)),
    "campus": ((360, 288), (800, 640)),
    "custom": ((2048, 1536), (800, 608)),
}

PATTERNS = {
    "panoptic": "*/hdImgs/*/*.jpg",
    "shelf": "Camera*/*.png",
    "campus": "Camera*/*.png",
    "custom": "Take_*/*/*.png",
}


def main(argv=None) -> int:
    import cv2

    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True, choices=sorted(SIZES))
    parser.add_argument("--dir", required=True)
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)

    ori, out = SIZES[args.dataset]
    t = get_resize_transform(ori, out)
    paths = sorted(glob(os.path.join(args.dir, PATTERNS[args.dataset])))
    print(f"{len(paths)} images -> {out}")
    done = 0
    for p in paths:
        img = cv2.imread(p, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if img is None:
            print(f"unreadable: {p}")
            continue
        if (img.shape[1], img.shape[0]) == out:
            continue
        resized = cv2.warpAffine(img, t[:2], out, flags=cv2.INTER_LINEAR)
        if not args.dry_run:
            cv2.imwrite(p, resized)
        done += 1
        if done % 1000 == 0:
            print(f"{done} resized")
    print(f"resized {done} images")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
