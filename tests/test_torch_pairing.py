"""Pairing the port's proposals with the reference's person by person.

Two bf16 pipelines find the same people but may rank two of them the
other way round where their BEV scores lie within a bf16 rounding of
each other: the order of a top-K over near-ties is not something either
side computes precisely. `pair_people` matches each reference slot to the
port's slot at the same voxel pick (the same mm centre), asserts that both
sides picked the same voxels, and lets two slots trade places only where
the reference's BEV scores at their cells differ by less than `tol` of the
map's scale. `check_paired` then holds the mask, the match index, the
confidences and boxes and the fused poses pair by pair."""

import numpy as np
import pytest
import torch

# of the BEV map's scale: bf16's tolerance (tests/test_torch_bf16.py)
RTOL = 2e-2


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    assert scale > 0
    return float(np.abs(np.asarray(got, np.float32) - ref).max()) / scale


def bev_scores(proposals, hm2d, voxel_to_mm):
    """The BEV score (B, K) of each proposal's cell: its (x, y) voxel from
    its mm centre through the (scale, bias) affine `voxel_to_mm` (2, 3),
    read from the maps hm2d (B, X, Y)."""
    scale, bias = np.asarray(voxel_to_mm, np.float64)
    idx = np.rint((np.asarray(proposals, np.float64)[..., :2] - bias[:2])
                  / scale[:2]).astype(np.int64)
    hm2d = np.asarray(hm2d)
    b = np.arange(hm2d.shape[0])[:, None]
    return hm2d[b, idx[..., 0], idx[..., 1]]


def pair_people(got_p, ref_p, ref_scores, scale, tol=RTOL):
    """perm (B, K): the port's slot of each reference slot, the one whose
    centre equals the reference's within a float32 rounding (rtol 1e-6).
    Asserts that every reference slot has exactly one such port slot (the
    same set of voxel picks on both sides) and that every pair of slots
    whose order differs has reference BEV scores `ref_scores` (B, K) within
    `tol` x `scale` of each other."""
    got_c = np.asarray(got_p, np.float64)[..., :3]
    ref_c = np.asarray(ref_p, np.float64)[..., :3]
    B, K = ref_c.shape[:2]
    perm = np.zeros((B, K), np.int64)
    for b in range(B):
        same = np.all(np.isclose(got_c[b][None, :, :], ref_c[b][:, None, :],
                                 rtol=1e-6, atol=0), axis=2)   # (ref, got)
        assert np.all(same.sum(axis=1) == 1) and np.all(
            same.sum(axis=0) == 1), (
            f"item {b}: the port picked other voxels than the reference",
            ref_c[b], got_c[b])
        perm[b] = np.argmax(same, axis=1)
        for i in range(K):
            for j in range(i + 1, K):
                if perm[b, i] > perm[b, j]:
                    gap = abs(float(ref_scores[b, i] - ref_scores[b, j]))
                    assert gap < tol * scale, (
                        f"item {b}: slots {i} and {j} trade places, but "
                        f"the reference's BEV scores differ by {gap:.3e}, "
                        f"not less than {tol} x {scale:.3e}")
    return perm


def _take(x, perm):
    """x (B, K, ...) reordered by perm (B, K)."""
    x = np.asarray(x)
    return np.stack([x[b][perm[b]] for b in range(x.shape[0])])


def check_paired(out, ref, voxel_to_mm, pose_atol_mm, tol=RTOL):
    """The port's eval output `out` (torch) against the reference's `ref`
    (jax or numpy) person by person: mask, match index, confidences and
    boxes (within `tol` of their scale) and fused poses (within
    `pose_atol_mm`). Returns the pairing."""
    got_p = np.asarray(out["proposals"])
    ref_p = np.asarray(ref["proposals"])
    ref_hm = np.asarray(ref["hm2d"], np.float32)
    perm = pair_people(got_p, ref_p, bev_scores(ref_p, ref_hm, voxel_to_mm),
                       float(np.abs(ref_hm).max()), tol)
    got_p = _take(got_p, perm)
    np.testing.assert_array_equal(_take(out["mask"], perm),
                                  np.asarray(ref["mask"]))
    np.testing.assert_array_equal(got_p[..., 3], ref_p[..., 3])
    assert _rel_err(got_p[..., 4:], ref_p[..., 4:]) < tol
    np.testing.assert_allclose(_take(out["fused_poses"], perm),
                               np.asarray(ref["fused_poses"]), rtol=0,
                               atol=pose_atol_mm)
    return perm


# -- the pairing on synthetic proposals ---------------------------------------

VOXEL_TO_MM = np.array([[100.0, 100.0, 50.0], [-800.0, -800.0, 0.0]])


def _synthetic(cells, scores):
    """Proposals (1, K, 7) at the (x, y) voxels `cells` (z 2), the
    reference's maps (1, 16, 16) holding `scores` at those cells, and the
    eval output of a port that found the same people."""
    scale, bias = VOXEL_TO_MM
    K = len(cells)
    p = np.zeros((1, K, 7), np.float32)
    for k, (x, y) in enumerate(cells):
        p[0, k, :3] = np.array([x, y, 2]) * scale + bias
        p[0, k, 3] = 0.0 if scores[k] > 0.3 else -1.0
        p[0, k, 4] = scores[k]
        p[0, k, 5:7] = [1000.0 + 10 * k, 900.0 + 10 * k]
    hm = np.full((1, 16, 16), 0.01, np.float32)
    for (x, y), s in zip(cells, scores):
        hm[0, x, y] = s
    poses = np.zeros((1, K, 15, 5), np.float32)
    poses[..., :3] = p[:, :, None, :3]
    poses[..., 3:5] = p[:, :, None, 3:5]
    ref = {"proposals": p, "hm2d": hm, "mask": p[..., 3] >= 0,
           "fused_poses": poses}
    return ref


def _port(ref, order):
    """The port's output holding the reference's people in `order`."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        np.asarray(ref[k])[:, order])) for k in ("proposals", "mask",
                                                 "fused_poses")}


CELLS = [(3, 4), (9, 1), (5, 12), (13, 7)]


def test_pairing_same_order_passes():
    ref = _synthetic(CELLS, [0.9, 0.6, 0.4, 0.2])
    perm = check_paired(_port(ref, [0, 1, 2, 3]), ref, VOXEL_TO_MM, 1.0)
    assert perm.tolist() == [[0, 1, 2, 3]]


def test_pairing_near_tie_swap_passes():
    """Slots 2 and 3 trade places where the scores lie 5.4e-4 apart (the
    image test's cells 5 and 13), under 2e-2 of the map's scale."""
    ref = _synthetic(CELLS, [0.418349, 0.385580, 0.378098, 0.377557])
    perm = check_paired(_port(ref, [0, 1, 3, 2]), ref, VOXEL_TO_MM, 1.0)
    assert perm.tolist() == [[0, 1, 3, 2]]


def test_pairing_swap_beyond_tolerance_fails():
    """A swap of two slots whose scores are further apart than RTOL of the
    scale is an ordering fault."""
    ref = _synthetic(CELLS, [0.9, 0.6, 0.4, 0.2])
    with pytest.raises(AssertionError, match="trade places"):
        check_paired(_port(ref, [0, 2, 1, 3]), ref, VOXEL_TO_MM, 1.0)


def test_pairing_other_voxels_fail():
    """A port that picked another voxel for one person fails, even with
    every other field equal."""
    ref = _synthetic(CELLS, [0.9, 0.6, 0.4, 0.2])
    out = _port(ref, [0, 1, 2, 3])
    out["proposals"][0, 3, 0] += float(VOXEL_TO_MM[0, 0])
    with pytest.raises(AssertionError, match="other voxels"):
        check_paired(out, ref, VOXEL_TO_MM, 1.0)

