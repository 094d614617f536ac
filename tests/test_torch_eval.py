"""The port's evaluators (fvp_torch/eval) against the reference package's
on the same seeded inputs: AP / recall / MPJPE with perfect, noisy and
false-positive predictions, PCP on Shelf- and Campus-converted poses,
and the COCO -> Shelf / Campus conversions. They must be equal, not
close: both are the same numpy arithmetic."""

from collections import OrderedDict

import numpy as np
import pytest

import fvp_torch.eval.ap as tap
import fvp_torch.eval.pcp as tpcp
import fvp_tpu.eval.ap as jap
import fvp_tpu.eval.pcp as jpcp


def _frame_preds(rng, gts, noise=0.0, score=0.9, maxp=10):
    """Per-frame GT packed into the (maxp, J, 5) fused-pose layout, with
    N(0, noise) mm added and descending scores; unused rows flagged -1."""
    J = gts[0].shape[0]
    out = np.zeros((maxp, J, 5), np.float32)
    out[:, :, 3] = -1.0
    for i, g in enumerate(gts):
        out[i, :, 0:3] = g + (rng.normal(0, noise, g.shape) if noise else 0)
        out[i, :, 3] = 0.0
        out[i, :, 4] = score - 0.01 * i
    return out


def _ap_inputs(rng, noise, false_positive):
    gts, frames = [], []
    for _ in range(6):
        gt = rng.uniform(-2000, 2000, (rng.randint(1, 4), 15, 3))
        gts.append(gt)
        frames.append(_frame_preds(rng, list(gt), noise))
    preds = np.stack(frames)
    if false_positive:
        preds[:, 5, :, 0:3] = 9000.0
        preds[:, 5, :, 3] = 0.0
        preds[:, 5, :, 4] = 0.99
    vis = [(rng.rand(len(g), 15) > 0.1).astype(np.float64) for g in gts]
    return preds, gts, vis


def _pcp_inputs(rng, convert, noise):
    """Shelf/Campus-style inputs: COCO-17 predictions, GT by actor in the
    14-joint order (actor 1 absent on every 3rd frame)."""
    frames, actors = 5, 3
    coco = rng.uniform(-1000, 1000, (frames, actors, 17, 3))
    gt_by_actor = [[None if (a == 1 and f % 3 == 0)
                    else convert(coco[f, a].copy())
                    for f in range(frames)] for a in range(actors)]
    preds = np.stack([_frame_preds(rng, list(coco[f]), noise)
                      for f in range(frames)])
    return preds, gt_by_actor


def _equal(got, ref):
    assert type(got) is type(ref) or isinstance(got, type(ref)), (got, ref)
    if isinstance(ref, (dict, OrderedDict)):
        assert list(got) == list(ref)
        for k in ref:
            _equal(got[k], ref[k])
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref or (np.isnan(got) and np.isnan(ref)), (got, ref)


CASES = ["ap_perfect", "ap_noisy", "ap_false_positive", "pcp_shelf",
         "pcp_shelf_noisy", "pcp_campus_noisy", "coco2shelf3d",
         "coco2campus3d"]


@pytest.mark.parametrize("case", CASES)
def test_evaluators_equal_reference(case):
    rng = np.random.RandomState(CASES.index(case) + 20261017)
    if case.startswith("ap"):
        preds, gts, vis = _ap_inputs(
            rng, noise=40.0 if case == "ap_noisy" else 0.0,
            false_positive=case == "ap_false_positive")
        got = tap.evaluate_ap_mpjpe(preds, gts, vis)
        ref = jap.evaluate_ap_mpjpe(preds, gts, vis)
        assert ref["total_gt"] > 6
        if case == "ap_perfect":
            assert ref["mean_ap"] > 0.99
        if case == "ap_false_positive":
            assert ref["ap"][150] < 0.75
    elif case.startswith("pcp"):
        campus = "campus" in case
        preds, gt_by_actor = _pcp_inputs(
            rng, jpcp.coco2campus3d if campus else jpcp.coco2shelf3d,
            noise=60.0 if case.endswith("noisy") else 0.0)
        got = tpcp.evaluate_pcp(
            preds, gt_by_actor,
            convert=tpcp.coco2campus3d if campus else tpcp.coco2shelf3d)
        ref = jpcp.evaluate_pcp(
            preds, gt_by_actor,
            convert=jpcp.coco2campus3d if campus else jpcp.coco2shelf3d)
        if case == "pcp_shelf":
            assert ref["avg_pcp"] > 0.999
        else:
            assert 0.0 < ref["avg_pcp"] < 1.0
    else:
        coco = rng.uniform(-1000, 1000, (17, 3))
        got = getattr(tpcp, case)(coco.copy())
        ref = getattr(jpcp, case)(coco.copy())
    _equal(got, ref)
