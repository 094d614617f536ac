"""The comparison that decides `correct`.

Each judged ring slot is worked out by the plain reference (float32, TF32
off) from the same inputs and weights. Stage by stage, as a served model's
tokens are judged on the reference run over them, the reference reads the
program's own output of the stage before:
- heatmaps (image traffic): the program's backbone output against the
  reference's from the same images;
- HDN: on the program's heatmaps, each proposal the program made is held
  against the reference's BEV heatmap, heights and bbox sizes at the
  program's picks;
- JLN: on the program's heatmaps and proposals, the program's fused
  joints and JLN scores against the reference's.
Every number is the worst over all answers of the judged slots in the
window, a share of the reference's own scale unless it says mm:
`heatmaps` (relative L2 error of the worst frame), `hdn` (the worst pick
gap, height gap, gate margin, score or bbox error), `pose_mm` (the worst
kept joint's distance), `jln_conf` (the worst kept score's error) and
`exact` (answers that break an exact rule: zeroed joints, the gate and
score columns, picks on the voxel grid and distinct). The limits come
from the cell's limits file.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _max(t: torch.Tensor) -> float:
    return float(t.max()) if t.numel() else 0.0


def judge_heatmaps(hm_prog: torch.Tensor, hm_ref: torch.Tensor) -> float:
    """Worst frame's ||prog - ref|| / ||ref|| over its views' maps."""
    B = hm_ref.shape[0]
    d = (hm_prog.float() - hm_ref).reshape(B, -1).norm(dim=1)
    return _max(d / hm_ref.reshape(B, -1).norm(dim=1).clamp(min=1e-30))


class SlotJudge:
    """The reference's HDN maps of one slot's heatmaps, then each answer
    of that slot judged against them."""

    def __init__(self, ref, hm: torch.Tensor):
        self.ref, self.hm = ref, hm
        s = ref.s
        self.vol = ref.volume(hm)
        self.hm2d, self.bbox = ref.center(self.vol)
        self.top, _ = ref.nms_topk(self.hm2d, s.max_people)
        B, X, Y = self.hm2d.shape
        self.peak = F.max_pool2d(self.hm2d[:, None], 3, 1, 1)[:, 0] \
            .reshape(B, -1)
        self.scale2d = self.hm2d.reshape(B, -1).abs().amax(dim=1)
        self.scale_bb = self.bbox.reshape(B, -1).abs().amax(dim=1)
        self._jln = []

    def _localize(self, proposals: torch.Tensor):
        for prev, out in self._jln:
            if torch.equal(prev, proposals):
                return out
        out = self.ref.localize(self.hm, proposals)
        self._jln.append((proposals, out))
        return out

    def judge(self, out: dict) -> dict:
        ref, s = self.ref, self.ref.s
        dev = self.hm2d.device
        prop = out["proposals"].to(dev).float()
        fused = out["fused_poses"].to(dev).float()
        mask = out["mask"].to(dev)
        B, K = prop.shape[:2]
        X, Y, Z = s.voxels_per_axis
        exact = 0
        # the picks: voxel indices of the proposal centers
        fidx = (prop[..., 0:3] - ref.vox_bias) / ref.vox_scale
        idx = torch.round(fidx).to(torch.int64)
        exact += int((ref.to_mm(idx) - prop[..., 0:3]).abs()
                     .gt(1e-3).any(dim=2).sum())
        lim = torch.tensor([X, Y, Z], device=dev)
        inside = ((idx >= 0) & (idx < lim)).all(dim=2)
        exact += int((~inside).sum())
        idx = torch.minimum(idx.clamp(min=0), lim - 1)
        flat = idx[..., 0] * Y + idx[..., 1]
        exact += sum(int(K - torch.unique(flat[b]).numel())
                     for b in range(B))
        # the rules of the answer's own columns
        exact += int((prop[..., 3] != mask.float() - 1.0).sum())
        exact += int((fused[..., 3] != prop[..., None, 3]).sum())
        exact += int((fused[..., 4] != prop[..., None, 4]).sum())
        exact += int((fused[..., 0:3][~mask] != 0).sum())

        # HDN: BEV picks, heights, gate, scores and sizes
        score = torch.gather(self.hm2d.reshape(B, -1), 1, flat)
        gap2d = torch.maximum(self.top - score,
                              torch.gather(self.peak, 1, flat) - score)
        hdn = [gap2d / self.scale2d[:, None].clamp(min=1e-30)]
        h1 = ref.heights(self.vol, flat)                      # (B, K, Z)
        h1_pick = torch.gather(h1, 2, idx[..., 2:3])[..., 0]
        scale1d = h1.reshape(B, -1).abs().amax(dim=1)[:, None]
        hdn.append((h1.amax(dim=2) - h1_pick) / scale1d.clamp(min=1e-30))
        conf = score * h1_pick
        cscale = conf.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
        flip = mask != (conf > s.min_score)
        hdn.append(torch.where(flip, (conf - s.min_score).abs() / cscale,
                               torch.zeros_like(conf)))
        hdn.append(torch.where(mask, torch.zeros_like(conf),
                               (prop[..., 4] - conf).abs() / cscale))
        box = torch.gather(self.bbox.reshape(B, X * Y, 2), 1,
                           flat[..., None].expand(-1, -1, 2))
        hdn.append((prop[..., 5:7] - box).abs().amax(dim=2)
                   / self.scale_bb[:, None].clamp(min=1e-30))

        # JLN on the program's proposals
        ref_joints, ref_conf = self._localize(prop)
        d = (fused[..., 0:3] - ref_joints).norm(dim=3).amax(dim=2)
        jscale = ref_conf.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
        jerr = (prop[..., 4] - ref_conf).abs() / jscale
        return {"hdn": max(_max(t) for t in hdn),
                "pose_mm": _max(d[mask]),
                "jln_conf": _max(jerr[mask]),
                "exact": float(exact),
                "parts": {"bev_gap": _max(hdn[0]), "height_gap": _max(hdn[1]),
                          "gate": _max(hdn[2]), "score": _max(hdn[3]),
                          "bbox": _max(hdn[4])}}


def combine(readings: list) -> dict:
    """The worst of each number over a run's judged answers; a NaN stays
    the worst."""
    out = {}
    for r in readings:
        for k, v in r.items():
            if k == "parts":
                continue
            old = out.get(k, 0.0)
            out[k] = v if (v != v or v > old) and old == old else old
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): correct iff every number
    has a limit and is within it."""
    checks, ok = {}, True
    for k in sorted(numbers):
        lim = limits.get(k)
        checks[k] = {"value": numbers[k], "limit": lim}
        if lim is None or not numbers[k] <= lim:
            ok = False
    return ok, checks
