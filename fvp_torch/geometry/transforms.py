"""2D affine transforms: the fixed original-image -> working-resolution
resize, and applying a 2x3 affine to points.

A numpy copy of the reference package's `geometry/transforms.py`
(`get_resize_transform`, `affine_apply` and the helpers they need). The
3-point affine is solved in closed form, without cv2.
"""

from __future__ import annotations

import numpy as np


def _get_dir(src_point, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array(
        [src_point[0] * cs - src_point[1] * sn,
         src_point[0] * sn + src_point[1] * cs],
        dtype=np.float64,
    )


def _get_3rd_point(a, b):
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float64)


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Solve the 2x3 matrix M with M @ [x, y, 1]^T = dst for 3 point pairs."""
    A = np.concatenate([src, np.ones((3, 1))], axis=1)  # (3, 3)
    MT = np.linalg.solve(A, dst)
    return MT.T  # (2, 3)


def get_affine_transform(center, scale, rot, output_size) -> np.ndarray:
    """Center/scale/rotation -> 2x3 affine matrix (scale in units of
    200 px)."""
    center = np.asarray(center, dtype=np.float64)
    scale = np.asarray(scale, dtype=np.float64)

    scale_tmp = scale * 200.0
    src_w, src_h = scale_tmp[0], scale_tmp[1]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    if src_w >= src_h:
        src_dir = _get_dir([0.0, src_w * -0.5], rot_rad)
        dst_dir = np.array([0.0, dst_w * -0.5], dtype=np.float64)
    else:
        src_dir = _get_dir([src_h * -0.5, 0.0], rot_rad)
        dst_dir = np.array([dst_h * -0.5, 0.0], dtype=np.float64)

    src = np.zeros((3, 2), dtype=np.float64)
    dst = np.zeros((3, 2), dtype=np.float64)
    src[0] = center
    src[1] = center + src_dir
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir
    src[2] = _get_3rd_point(src[0], src[1])
    dst[2] = _get_3rd_point(dst[0], dst[1])
    return _solve_affine(src, dst)


def get_scale(image_size, resized_size) -> np.ndarray:
    """Aspect-preserving scale for a resize."""
    w, h = image_size
    w_resized, h_resized = resized_size
    if w / w_resized < h / h_resized:
        w_pad = h / h_resized * w_resized
        h_pad = h
    else:
        w_pad = w
        h_pad = w / w_resized * h_resized
    return np.array([w_pad / 200.0, h_pad / 200.0], dtype=np.float64)


def get_resize_transform(ori_image_size, image_size) -> np.ndarray:
    """The fixed original -> working-resolution affine."""
    c = np.array([ori_image_size[0] / 2.0, ori_image_size[1] / 2.0])
    s = get_scale(ori_image_size, image_size)
    return get_affine_transform(c, s, 0, image_size)


def affine_apply(points, t):
    """Apply a 2x3 affine to (..., 2) points (numpy or torch)."""
    return points @ t[:, :2].T + t[:, 2]


def rotate_points(points: np.ndarray, center: np.ndarray,
                  rot_deg: float) -> np.ndarray:
    """Rotate (N, 2) points around a center (the synthetic scenes'
    placement)."""
    rot_rad = rot_deg * np.pi / 180.0
    m = np.array([[np.cos(rot_rad), -np.sin(rot_rad)],
                  [np.sin(rot_rad), np.cos(rot_rad)]])
    center = np.asarray(center, dtype=np.float64).reshape(2, 1)
    return (m.dot(points.T - center) + center).T
