"""The HDN + JLN model, eval mode: heatmaps -> fused 3D poses.

Data flow (the reference package's FasterVoxelPose, non-train branch):
  heatmaps (B, V, J, H, W)
    -> whole-space volumes (B, X, Y, Z, J)        [K1 whole_sample]
    -> BEV max over z -> CenterNet -> center heatmap + bbox sizes [K3]
    -> NMS top-K -> proposal (x, y) + z-columns -> C2CNet -> z
    -> proposals (B, K, 7) [xyz mm, match, conf, bbox wh]
    -> per-person tri-planes (3, B*K, A, A, J)     [K2 person_planes]
    -> P2PNet -> soft-argmax [K4] -> WeightNet [K5 + MLP] fusion
    -> fused poses (B, K, J, 5) [xyz mm, match, score]

C2CNet and P2PNet are cuDNN modules by default, in float32, or in bf16
up to their float32 1x1 heads where the packed weights hold their bf16
copies (`compute_dtype='bfloat16'`, the reference's serving
configuration; engine/packing.py::pack_model). With `cfg.fuse_p2p` they run
as the bf16 kernels of the reference's fused nets, as the reference
routes them (fvp_tpu/models/faster_voxelpose.py:204, :332): C2CNet when
the z axis is a multiple of 4 (`ops/kernels/c2cnet.py`), P2PNet when
`hourglass_supported` accepts the plane shape (`ops/kernels/hourglass.py`).
The reference also asks for its Pallas samplers there; the port always
samples in its kernels, so that condition has no counterpart. CenterNet
and WeightNet's conv front end run on their float32 kernels under either
dtype (the reference computes them in bf16 under 'bfloat16'); the
soft-argmax reads P2PNet's float32 output.

Submodules carry the reference model's key names (`pose_net.center_net`,
`pose_net.c2c_net`, `joint_net.conv_net`, `joint_net.weight_net`). The
kernel wrappers pick the kernel for CUDA tensors and the plain version for
CPU tensors, so the same forward serves both devices.
"""

from __future__ import annotations

import torch
from torch import nn

from fvp_torch.config import FVPConfig
from fvp_torch.geometry.grids import RigConstants
from fvp_torch.models.cnns import C2CNet, CenterNet, P2PNet, WeightNet
from fvp_torch.ops.kernels.c2cnet import c2cnet
from fvp_torch.ops.kernels.centernet import centernet_forward
from fvp_torch.ops.kernels.hourglass import hourglass_supported, p2pnet
from fvp_torch.ops.kernels.sampler import person_planes, whole_sample
from fvp_torch.ops.kernels.softargmax import soft_argmax
from fvp_torch.ops.kernels.weightnet import weightnet_pool
from fvp_torch.ops.nms import nms_topk_2d


def _cudnn_net(packed: dict, name: str, net: nn.Module,
               x: torch.Tensor) -> torch.Tensor:
    """A task net's cuDNN module on `x`: the model's own (float32), or its
    bf16 copy in `packed` (engine/packing.py::pack_model for 'bfloat16')
    on `x` rounded to bf16."""
    net16 = packed.get("bf16_nets", {}).get(name)
    return net(x) if net16 is None else net16(x.to(torch.bfloat16))


class FasterVoxelPose(nn.Module):
    """HDN + JLN, eval mode. `heatmaps` layout: (B, V, J, H, W)."""

    def __init__(self, cfg: FVPConfig):
        super().__init__()
        self.cfg = cfg
        J = cfg.num_joints
        self.pose_net = nn.Module()
        self.pose_net.center_net = CenterNet(J)
        self.pose_net.c2c_net = C2CNet(J)
        self.joint_net = nn.Module()
        self.joint_net.conv_net = P2PNet(J)
        self.joint_net.weight_net = WeightNet(cfg.num_channel_joint_feat,
                                              cfg.num_channel_joint_hidden)

    # ------------------------------------------------------------------
    def detect(self, heatmaps, rc: RigConstants, packed: dict) -> dict:
        """HDN: heatmaps -> proposals (B, K, 7), the raw maps and C2CNet's
        input, the proposals' z-columns (B*K, Z, J)."""
        cfg = self.cfg
        B = heatmaps.shape[0]
        K = cfg.max_people
        nx, ny, nz = cfg.voxels_per_axis

        volumes = whole_sample(heatmaps, rc, cfg)            # (B, X, Y, Z, J)
        bev = volumes.amax(dim=3)                            # (B, X, Y, J)
        hm2d, bbox_map = centernet_forward(packed["center_net"], bev)
        confs2d, xy, flat = nms_topk_2d(hm2d[..., 0], K)

        bbox_flat = bbox_map.reshape(B, nx * ny, 2)
        match_bbox = torch.gather(
            bbox_flat, 1, flat[:, :, None].expand(B, K, 2))  # (B, K, 2)
        J = volumes.shape[-1]
        vol_flat = volumes.reshape(B, nx * ny, nz, J)
        columns = torch.gather(
            vol_flat, 1, flat[:, :, None, None].expand(B, K, nz, J))
        columns = columns.reshape(B * K, nz, J)
        if cfg.fuse_p2p and nz % 4 == 0:
            hm1d = c2cnet(packed["c2c_net"], columns)
        else:
            hm1d = _cudnn_net(packed, "c2c_net", self.pose_net.c2c_net,
                              columns)
        hm1d = hm1d.reshape(B, K, nz)

        z_idx = torch.argmax(hm1d, dim=2)                    # (B, K)
        confs1d = hm1d.amax(dim=2)
        scale, bias = rc.voxel_to_mm
        idx_xyz = torch.cat([xy, z_idx[:, :, None].to(torch.int32)],
                            dim=2).to(torch.float32)
        centers_mm = idx_xyz * scale + bias                  # (B, K, 3)
        confs = confs2d * confs1d
        proposal2gt = (confs > cfg.min_score).to(torch.float32) - 1.0
        proposals = torch.cat([centers_mm, proposal2gt[:, :, None],
                               confs[:, :, None], match_bbox], dim=2)
        return {"proposals": proposals, "hm2d": hm2d[..., 0], "hm1d": hm1d,
                "bbox_flat": bbox_flat, "columns": columns}

    # ------------------------------------------------------------------
    def localize(self, heatmaps, rc: RigConstants, proposals, packed: dict):
        """JLN: tri-planes -> P2PNet -> soft-argmax -> fusion.
        Returns (fused (B, K, J, 3), planes (3, B, K, J, 2), confs (B, K))."""
        cfg = self.cfg
        B, K = proposals.shape[:2]
        J = cfg.num_joints
        n = cfg.ind_voxels_per_axis[0]

        person_mask = proposals[..., 3] >= 0
        planes, offsets = person_planes(
            heatmaps, rc, cfg, proposals[..., 0:3], proposals[..., 5:7],
            person_mask)                                     # (3, BK, n, n, J)
        flat = planes.reshape(3 * B * K, n, n, J)
        if cfg.fuse_p2p and hourglass_supported(flat.shape):
            feats = p2pnet(packed["p2p_net"], flat)
        else:
            feats = _cudnn_net(packed, "conv_net", self.joint_net.conv_net,
                               flat)
        coords, confs = soft_argmax(feats.reshape(3, B * K, n * n, J),
                                    rc.center_grid, cfg.beta)
        off = offsets.reshape(B * K, 1, 3)
        coords = torch.stack([
            coords[0] + off[..., 0:2],                       # xy plane
            coords[1] + off[..., ::2],                       # xz plane
            coords[2] + off[..., 1:],                        # yz plane
        ])
        pooled = weightnet_pool(feats, packed["weight_net"])  # (3BK, J, C)
        weights = self.joint_net.weight_net.head(pooled).reshape(
            3, B * K, J, 1)
        fused = self._fuse(coords, weights)                  # (BK, J, 3)
        return (fused.reshape(B, K, J, 3), coords.reshape(3, B, K, J, 2),
                confs.reshape(B, K))

    @staticmethod
    def _fuse(coords, weights):
        """Weighted per-axis fusion of the three plane estimates."""
        xy_w, xz_w, yz_w = weights[0], weights[1], weights[2]
        xy, xz, yz = coords[0], coords[1], coords[2]
        x_w = torch.cat([xy_w, xz_w], dim=2)
        y_w = torch.cat([xy_w, yz_w], dim=2)
        z_w = torch.cat([xz_w, yz_w], dim=2)
        x_w = x_w / x_w.sum(dim=2, keepdim=True)
        y_w = y_w / y_w.sum(dim=2, keepdim=True)
        z_w = z_w / z_w.sum(dim=2, keepdim=True)
        x = x_w[:, :, :1] * xy[:, :, :1] + x_w[:, :, 1:] * xz[:, :, :1]
        y = y_w[:, :, :1] * xy[:, :, 1:] + y_w[:, :, 1:] * yz[:, :, :1]
        z = z_w[:, :, :1] * xz[:, :, 1:] + z_w[:, :, 1:] * yz[:, :, 1:]
        return torch.cat([x, y, z], dim=2)

    # ------------------------------------------------------------------
    def forward(self, heatmaps, rc: RigConstants, packed: dict):
        """`packed`: the kernels' weights, engine/packing.py::pack_model."""
        cfg = self.cfg
        B = heatmaps.shape[0]
        J = cfg.num_joints

        det = self.detect(heatmaps, rc, packed)
        proposals = det["proposals"]
        mask = proposals[..., 3] >= 0                        # (B, K)
        fused, planes, jln_confs = self.localize(heatmaps, rc, proposals,
                                                 packed)

        # unmatched people are zeroed; matched ones take the JLN score
        fmask = mask[..., None, None].to(fused.dtype)
        fused = fused * fmask
        planes = planes * fmask[None]
        proposals = proposals.clone()
        proposals[..., 4] = torch.where(mask, jln_confs, proposals[..., 4])
        tail = proposals[:, :, None, 3:5].expand(B, proposals.shape[1], J, 2)
        return {
            "fused_poses": torch.cat([fused, tail], dim=3),
            "plane_poses": planes,
            "proposals": proposals,
            "mask": mask,
            "hm2d": det["hm2d"],
            "hm1d": det["hm1d"],
            "bbox_flat": det["bbox_flat"],
        }
