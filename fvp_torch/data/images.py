"""Host-side image loading: decode, aspect-preserving affine resize to the
working resolution, ImageNet normalization.

A copy of the reference package's `data/images.py` (after the original
implementation's offline resize tool, preprocess.py, and its dataset-side
ToTensor/Normalize transform, run/train.py:58-66). Images already stored
at working resolution skip the warp. cv2 is imported where the images are
loaded, so the module imports without it.
"""

from __future__ import annotations

import numpy as np

from fvp_torch.config import FVPConfig
from fvp_torch.geometry.transforms import get_resize_transform

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_and_resize_views(cfg: FVPConfig, paths) -> np.ndarray:
    """-> (V, H, W, 3) float32, normalized, RGB."""
    import cv2

    out = []
    w, h = cfg.image_size
    t = get_resize_transform(cfg.ori_image_size, cfg.image_size)
    for p in paths:
        img = cv2.imread(p, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if img is None:
            raise FileNotFoundError(p)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if img.shape[1] != w or img.shape[0] != h:
            img = cv2.warpAffine(img, t[:2], (w, h),
                                 flags=cv2.INTER_LINEAR)
        img = img.astype(np.float32) / 255.0
        out.append((img - IMAGENET_MEAN) / IMAGENET_STD)
    return np.stack(out)
