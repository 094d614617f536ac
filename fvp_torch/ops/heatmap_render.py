"""Gaussian input heatmaps rendered on the batch's device from render
parameters: the 'gt' and 'pred' heatmap sources with DEVICE_RENDER on.

The host packs each sample's projected joints, per-person sigma and
augmentation draws (data/base.py::pack_render_params, ~1 KB a view); the
splat runs here. It computes what the reference package's
`ops/heatmap_render.py::render_heatmaps_device` computes (an XLA function
there, not a Pallas kernel), so plain torch ops are its counterpart: the
integer-truncation windows, the scale-adaptive sigma, the per-joint peak
scale, the occlusion rectangle in window-local indices and the final clip
to [0, 1]. It matches the numpy renderer (data/heatmaps.py) within 1e-5.

One elementwise pass over (..., J, H, W) per person slot; leading batch
dims (B, V) broadcast. The window and occlusion tests are separable, so
they are built on (..., J, 1, W) and (..., J, H, 1) and meet once.
"""

from __future__ import annotations

import torch

from fvp_torch.config import FVPConfig


def render_heatmaps_device(cfg: FVPConfig, mu: torch.Tensor,
                           vis: torch.Tensor, sigma: torch.Tensor,
                           scale: torch.Tensor, occ: torch.Tensor
                           ) -> torch.Tensor:
    """mu: (..., P, J, 2) int32 heatmap-grid joint centers (truncated on
    the host in float64, as the reference's int(coord / feat_stride));
    vis: (..., P, J) float (0 = skip the joint); sigma: (..., P) the
    person's gaussian sigma in heatmap pixels (0 = skip the person);
    scale: (..., P, J) peak multipliers (1 = clean); occ: (..., P, J, 4)
    int32 window-local occlusion [y0, y1, x0, x1) (y1 <= y0 = none).
    Returns (..., J, hm_h, hm_w) float32 on mu's device."""
    hm_w, hm_h = cfg.heatmap_size
    dev = mu.device
    P, J = mu.shape[-3:-1]
    lead = mu.shape[:-3]
    f32 = torch.float32

    mu_x = mu[..., 0].to(f32)                                # (..., P, J)
    mu_y = mu[..., 1].to(f32)
    tmp = (sigma.to(f32) * 3.0)[..., None]                   # (..., P, 1)
    # float32 -> int32 truncates toward zero, as int() does
    ul_x = (mu_x - tmp).to(torch.int32)
    ul_y = (mu_y - tmp).to(torch.int32)
    br_x = (mu_x + tmp + 1.0).to(torch.int32)
    br_y = (mu_y + tmp + 1.0).to(torch.int32)
    c0 = torch.floor((2.0 * tmp + 1.0) / 2.0)                # (..., P, 1)
    alive = ((vis > 0) & (sigma[..., None] > 0)
             & (ul_x < hm_w) & (ul_y < hm_h)
             & (br_x >= 0) & (br_y >= 0))                    # (..., P, J)
    sig = sigma.to(f32)
    inv2s2 = torch.where(sig > 0, 1.0 / (2.0 * sig * sig + 1e-30),
                         torch.zeros_like(sig))              # (..., P)

    xs = torch.arange(hm_w, dtype=torch.int32, device=dev)
    ys = torch.arange(hm_h, dtype=torch.int32, device=dev)
    acc = torch.zeros((*lead, J, hm_h, hm_w), dtype=f32, device=dev)
    for p in range(P):
        uy = ul_y[..., p, :, None, None]                     # (..., J, 1, 1)
        ux = ul_x[..., p, :, None, None]
        gx = xs - ux                                         # (..., J, 1, W)
        gy = ys[:, None] - uy                                # (..., J, H, 1)
        c = c0[..., p, :, None, None]
        dx = gx.to(f32) - c
        dy = gy.to(f32) - c
        k = inv2s2[..., p, None, None, None]
        g = torch.exp(-(dx * dx + dy * dy) * k)              # (..., J, H, W)
        g = g * scale[..., p, :, None, None]
        o = occ[..., p, :, :, None, None]               # (..., J, 4, 1, 1)
        in_x = (gx >= 0) & (xs < br_x[..., p, :, None, None])
        in_y = (gy >= 0) & (ys[:, None] < br_y[..., p, :, None, None])
        occ_x = (gx >= o[..., 2, :, :]) & (gx < o[..., 3, :, :])
        occ_y = (gy >= o[..., 0, :, :]) & (gy < o[..., 1, :, :])
        keep = (in_y & in_x) & ~(occ_y & occ_x) \
            & alive[..., p, :, None, None]
        acc = torch.maximum(acc, torch.where(keep, g, 0.0))
    return acc.clamp_(0.0, 1.0)
