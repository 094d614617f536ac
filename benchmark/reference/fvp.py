"""Faster-VoxelPose's eval forward, plain: images -> heatmaps -> whole-space
volume -> CenterNet -> NMS top-K -> C2CNet -> proposals -> per-person
tri-planes -> P2PNet -> soft-argmax and WeightNet -> fused poses.

Every stage is a method, so that a judge can run one stage on another
side's input (the program's heatmaps or proposals) and compare the stage
alone. Large stages run in chunks so that the reference fits beside the
program's outputs on one card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import geometry as geo
from .nets import FasterVoxelPose, PoseResNet, set_precision
from .precision import Precision, float32_math

IMAGE_CHUNK = 8          # backbone images a step
PERSON_CHUNK = 16        # people a step of the JLN


class Reference:
    """The model of one configuration (`space`) and rig on `device`, with
    the given state dicts, computing in `fmt` (precision.FORMATS)."""

    def __init__(self, space: geo.Space, rig: dict, state_dict: dict,
                 backbone_state_dict: dict | None, device,
                 fmt: str = "fp32", depth: int = 50, feat: int = 32,
                 hidden: int = 64):
        self.s = space
        self.device = torch.device(device)
        prec = Precision(fmt)
        # built on the meta device and given the state dict's tensors: no
        # initialisation that the weights would overwrite
        with torch.device("meta"):
            model = FasterVoxelPose(space.num_joints, feat, hidden)
            backbone = None if backbone_state_dict is None \
                else PoseResNet(space.num_joints, depth)
        self.model = self._load(model, state_dict, prec)
        self.backbone = None if backbone is None \
            else self._load(backbone, backbone_state_dict, prec)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        self.whole_px = t(geo.whole_px(space, rig))          # (V, 2, N)
        self.grids = t(geo.plane_grids(space))               # (3, n*n, 2)
        scale, bias = geo.voxel_affine(space)
        self.vox_scale, self.vox_bias = t(scale), t(bias)
        self.cams = [{k: t(rig[k][v]) for k in "RTfckp"}
                     for v in range(space.num_views)]
        self.hm_t = geo.heatmap_transform(space).astype(np.float32)
        self.pitch, self.origin = geo.fine_grid(space)

    @classmethod
    def from_config(cls, cfg: dict, rig: dict, state_dict: dict,
                    backbone_state_dict: dict | None, device,
                    fmt: str = "fp32") -> "Reference":
        """The reference of a configuration's sizes (a configuration
        file's "config")."""
        return cls(geo.Space.from_config(cfg), rig, state_dict,
                   backbone_state_dict, device, fmt,
                   depth=cfg["resnet_layers"],
                   feat=cfg["num_channel_joint_feat"],
                   hidden=cfg["num_channel_joint_hidden"])

    def _load(self, net, state_dict, prec):
        net.load_state_dict(state_dict, assign=True)
        return set_precision(net, prec).eval().to(self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def heatmaps(self, images: torch.Tensor) -> torch.Tensor:
        """Normalized images (B, V, H, W, 3) -> heatmaps (B, V, J, h, w)."""
        B, V = images.shape[:2]
        x = images.reshape(B * V, *images.shape[2:]).permute(0, 3, 1, 2)
        with float32_math():
            out = torch.cat([self.backbone(x[i:i + IMAGE_CHUNK].float()
                                           .to(self.device))
                             for i in range(0, B * V, IMAGE_CHUNK)])
        return out.reshape(B, V, *out.shape[1:])

    @torch.no_grad()
    def volume(self, hm: torch.Tensor) -> torch.Tensor:
        """Heatmaps (B, V, J, H, W) -> volume (B, X, Y, Z, J): each voxel's
        bilinear samples (zero outside the map), their view mean, clamped
        to [0, 1]."""
        B, V, J, H, W = hm.shape
        px = self.whole_px
        g = torch.stack([px[:, 0] / (W - 1) * 2 - 1,
                         px[:, 1] / (H - 1) * 2 - 1], dim=-1)  # (V, N, 2)
        N = g.shape[1]
        acc = 0
        for v in range(V):
            acc = acc + F.grid_sample(
                hm[:, v].float(), g[v][None, None].expand(B, 1, N, 2),
                mode="bilinear", padding_mode="zeros",
                align_corners=True)[:, :, 0]
        vol = torch.clamp(acc / V, 0.0, 1.0)                 # (B, J, N)
        X, Y, Z = self.s.voxels_per_axis
        return vol.reshape(B, J, X, Y, Z).permute(0, 2, 3, 4, 1)

    @torch.no_grad()
    def center(self, vol: torch.Tensor):
        """Volume -> (center heatmap (B, X, Y), bbox sizes (B, X, Y, 2))
        from its bird's-eye view, the max over z."""
        with float32_math():
            return self.model.pose_net.center_net(
                vol.amax(dim=3).permute(0, 3, 1, 2))

    @staticmethod
    def nms_topk(hm2d: torch.Tensor, k: int):
        """Local maxima of a 3x3 window (ties all kept) and the top k of
        them, ties to the lowest flat index: (values (B, k), flat (B, k))."""
        B, X, Y = hm2d.shape
        peak = F.max_pool2d(hm2d[:, None], 3, stride=1, padding=1)[:, 0]
        keep = torch.where(hm2d == peak, hm2d, torch.zeros_like(hm2d))
        vals, flat = torch.sort(keep.reshape(B, X * Y), dim=1,
                                descending=True, stable=True)
        return vals[:, :k], flat[:, :k]

    @torch.no_grad()
    def heights(self, vol: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
        """C2CNet on the volume's z-columns at flat BEV cells (B, K) ->
        height scores (B, K, Z)."""
        B, X, Y, Z, J = vol.shape
        K = flat.shape[1]
        cols = torch.gather(vol.reshape(B, X * Y, Z, J), 1,
                            flat[:, :, None, None].expand(B, K, Z, J))
        with float32_math():
            h = self.model.pose_net.c2c_net(
                cols.reshape(B * K, Z, J).permute(0, 2, 1))
        return h.reshape(B, K, Z)

    def to_mm(self, idx: torch.Tensor) -> torch.Tensor:
        return idx.to(torch.float32) * self.vox_scale + self.vox_bias

    @torch.no_grad()
    def detect(self, hm: torch.Tensor) -> torch.Tensor:
        """HDN: heatmaps -> proposals (B, K, 7): center mm (3), -1 or 0
        (below or above the gate), confidence, bbox size (2)."""
        vol = self.volume(hm)
        hm2d, bbox = self.center(vol)
        B, X, Y = hm2d.shape
        vals, flat = self.nms_topk(hm2d, self.s.max_people)
        h1 = self.heights(vol, flat)
        conf1, z = h1.max(dim=2)
        idx = torch.stack([flat // Y, flat % Y, z], dim=2)
        conf = vals * conf1
        gate = (conf > self.s.min_score).to(torch.float32) - 1.0
        box = torch.gather(bbox.reshape(B, X * Y, 2), 1,
                           flat[:, :, None].expand(-1, -1, 2))
        return torch.cat([self.to_mm(idx), gate[..., None], conf[..., None],
                          box], dim=2)

    # ------------------------------------------------------------------
    def _planes(self, hm, frames, corner, start, end) -> torch.Tensor:
        """Tri-planes (p, 3, J, n, n) of people whose cubes snap to
        `corner` in frames `frames`: each voxel the view mean of its
        bilinear samples clamped to [0, 1], zero outside [start, end),
        then max over z (xy), y (xz) and x (yz)."""
        s = self.s
        n = s.ind_voxels_per_axis[0]
        p = corner.shape[0]
        H, W = hm.shape[-2:]
        j = torch.arange(n, device=hm.device, dtype=torch.float32)
        ax = [float(self.origin[a]) + (corner[:, a, None].float() + j)
              * float(self.pitch[a]) for a in range(3)]        # (p, n)
        px = ax[0][:, :, None, None].expand(p, n, n, n).reshape(p, -1)
        py = ax[1][:, None, :, None].expand(p, n, n, n).reshape(p, -1)
        pz = ax[2][:, None, None, :].expand(p, n, n, n).reshape(p, -1)
        bound = float(max(s.ori_image_size))
        t = self.hm_t
        acc = 0
        for v, cam in enumerate(self.cams):
            u, w = geo.project_torch(px, py, pz, cam)
            u, w = u.clamp(-1.0, bound), w.clamp(-1.0, bound)
            x = float(t[0, 0]) * u + float(t[0, 1]) * w + float(t[0, 2])
            y = float(t[1, 0]) * u + float(t[1, 1]) * w + float(t[1, 2])
            g = torch.stack([x / (W - 1.0) * 2.0 - 1.0,
                             y / (H - 1.0) * 2.0 - 1.0], dim=-1)
            g = torch.clamp(g, -1.1, 1.1)
            acc = acc + F.grid_sample(hm[frames, v].float(), g[:, None],
                                      mode="bilinear", padding_mode="zeros",
                                      align_corners=True)[:, :, 0]
        cube = torch.clamp(acc / len(self.cams), 0.0, 1.0)
        cube = cube.reshape(p, -1, n, n, n)
        ok = [((corner[:, a, None] + j.to(torch.int32) >= start[:, a, None])
               & (corner[:, a, None] + j.to(torch.int32) < end[:, a, None]))
              for a in range(3)]
        valid = ok[0][:, :, None, None] & ok[1][:, None, :, None] \
            & ok[2][:, None, None, :]
        cube = cube * valid[:, None].to(cube.dtype)
        return torch.stack([cube.amax(dim=4), cube.amax(dim=3),
                            cube.amax(dim=2)], dim=1)

    @torch.no_grad()
    def localize(self, hm: torch.Tensor, proposals: torch.Tensor):
        """JLN on the people that `proposals` (B, K, 7) keep (column 3 >=
        0): fused joints (B, K, J, 3) in mm and JLN confidences (B, K),
        zero for the others."""
        s = self.s
        B, K = proposals.shape[:2]
        J, n = s.num_joints, s.ind_voxels_per_axis[0]
        fused = torch.zeros((B * K, J, 3), device=hm.device)
        confs = torch.zeros((B * K,), device=hm.device)
        kept = torch.nonzero(proposals[..., 3].reshape(-1) >= 0)[:, 0]
        if kept.numel() == 0:
            return fused.reshape(B, K, J, 3), confs.reshape(B, K)
        flat = proposals.reshape(B * K, 7)[kept]
        corner, start, end, alive, offset = geo.snap(s, flat[:, 0:3],
                                                     flat[:, 5:7])
        end = torch.where(alive[:, None], end, start)
        net = self.model.joint_net.conv_net
        wnet = self.model.joint_net.weight_net
        for c in range(0, kept.numel(), PERSON_CHUNK):
            sl = slice(c, c + PERSON_CHUNK)
            planes = self._planes(hm, kept[sl] // K, corner[sl], start[sl],
                                  end[sl])                   # (p, 3, J, n, n)
            p = planes.shape[0]
            with float32_math():
                feats = net(planes.reshape(3 * p, J, n, n))
                weights = wnet(feats).reshape(p, 3, J)
            probs = torch.softmax(s.beta * feats.reshape(p, 3, J, n * n),
                                  dim=3)
            conf = probs.amax(dim=3).mean(dim=(1, 2))        # (p,)
            xy = torch.einsum("psjn,snc->psjc", probs, self.grids)
            off = offset[sl]
            xy = torch.stack([xy[:, 0] + off[:, None, 0:2],
                              xy[:, 1] + off[:, None, 0::2],
                              xy[:, 2] + off[:, None, 1:3]], dim=1)
            w = weights
            x = (w[:, 0] * xy[:, 0, :, 0] + w[:, 1] * xy[:, 1, :, 0]) \
                / (w[:, 0] + w[:, 1])
            y = (w[:, 0] * xy[:, 0, :, 1] + w[:, 2] * xy[:, 2, :, 0]) \
                / (w[:, 0] + w[:, 2])
            z = (w[:, 1] * xy[:, 1, :, 1] + w[:, 2] * xy[:, 2, :, 1]) \
                / (w[:, 1] + w[:, 2])
            fused[kept[sl]] = torch.stack([x, y, z], dim=2)
            confs[kept[sl]] = conf
        return fused.reshape(B, K, J, 3), confs.reshape(B, K)

    @staticmethod
    def finish(proposals, fused, confs) -> dict:
        """The outputs: fused_poses (B, K, J, 5) (joints, gate, score; zero
        joints for people not kept), proposals with the JLN's score for
        the kept, and the mask."""
        mask = proposals[..., 3] >= 0
        proposals = proposals.clone()
        proposals[..., 4] = torch.where(mask, confs, proposals[..., 4])
        J = fused.shape[2]
        tail = proposals[:, :, None, 3:5].expand(-1, -1, J, 2)
        fused = fused * mask[..., None, None].to(fused.dtype)
        return {"fused_poses": torch.cat([fused, tail], dim=3),
                "proposals": proposals, "mask": mask}

    @torch.no_grad()
    def forward(self, frame: torch.Tensor) -> dict:
        """The whole model on a frame (images with a backbone, else
        heatmaps), as the program answers it; with the heatmaps."""
        hm = self.heatmaps(frame) if self.backbone is not None \
            else frame.float().to(self.device)
        proposals = self.detect(hm)
        out = self.finish(proposals, *self.localize(hm, proposals))
        return {**out, "heatmaps": hm}
