"""The HDN + JLN model: heatmaps -> fused 3D poses, in eval and train mode.

Data flow (the reference package's FasterVoxelPose):
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
and WeightNet's conv front end run on their float32 kernels, and under
'bfloat16' on their bf16 routes (the packed weights hold
"center_net_bf16" and "weight_net_bf16"), which compute as the
reference's TPU kernels do; the soft-argmax reads P2PNet's float32
output.

Train mode (`train=True`, the module in train mode; under 'bfloat16' the
nets compute in bf16 as flax builds them, models/blocks.py) is the
reference's train branch: the samplers K1 and K2 as in eval (their inputs
carry no gradient), the four nets as their modules with batch-statistic
BatchNorm (P2PNet and WeightNet per scene over the matched people, on the
planes reordered scene-major), the differentiable soft-argmax of
ops/softargmax.py, and the proposals matched to the ground truth
(`match_proposals_to_gt`). `compute_losses` gives the four losses.

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
from fvp_torch.models.blocks import set_compute_dtype
from fvp_torch.models.cnns import C2CNet, CenterNet, P2PNet, WeightNet
from fvp_torch.ops import softargmax as plain_softargmax
from fvp_torch.ops.kernels.c2cnet import c2cnet
from fvp_torch.ops.kernels.centernet import centernet_bf16, centernet_forward
from fvp_torch.ops.kernels.hourglass import hourglass_supported, p2pnet
from fvp_torch.ops.kernels.sampler import person_planes, whole_sample
from fvp_torch.ops.kernels.softargmax import soft_argmax
from fvp_torch.ops.kernels.weightnet import (weightnet_pool,
                                             weightnet_pool_bf16)
from fvp_torch.ops.nms import nms_topk_2d
from fvp_torch.utils import tracing


def _cudnn_net(packed: dict, name: str, net: nn.Module,
               x: torch.Tensor) -> torch.Tensor:
    """A task net's cuDNN module on `x`: the model's own (float32), or its
    bf16 copy in `packed` (engine/packing.py::pack_model for 'bfloat16')
    on `x` rounded to bf16."""
    net16 = packed.get("bf16_nets", {}).get(name)
    return net(x) if net16 is None else net16(x.to(torch.bfloat16))


def match_proposals_to_gt(centers_mm, bbox_preds, roots_3d, gt_bbox,
                          num_person, radius: float = 500.0,
                          bbox_slack: float = 0.1):
    """The reference's GT matching, batched: centers_mm (B, K, 3),
    bbox_preds (B, K, 2), roots_3d (B, G, 3) and gt_bbox (B, G, 2) padded,
    num_person (B,). Returns (proposal2gt (B, K) float, -1 for no person
    within `radius` mm; adjusted bbox (B, K, 2)): where ANY coordinate of
    a matched proposal's bbox is below its person's minus `bbox_slack`,
    the WHOLE bbox is replaced by the person's (the reference's quirk)."""
    G = roots_3d.shape[1]
    dist = torch.sqrt(((centers_mm[:, :, None, :]
                        - roots_3d[:, None, :, :]) ** 2).sum(-1))  # (B, K, G)
    gt_valid = torch.arange(G, device=dist.device) < num_person[:, None]
    dist = torch.where(gt_valid[:, None, :], dist,
                       torch.full_like(dist, float("inf")))
    min_dist, min_gt = dist.min(dim=2)
    proposal2gt = torch.where(min_dist > radius, -1.0,
                              min_gt.to(torch.float32))
    matched = torch.gather(gt_bbox, 1, min_gt[..., None].expand(-1, -1, 2))
    too_small = (bbox_preds < matched - bbox_slack).any(dim=2)
    use_gt = (proposal2gt >= 0) & too_small
    return proposal2gt, torch.where(use_gt[..., None], matched, bbox_preds)


class FasterVoxelPose(nn.Module):
    """HDN + JLN. `heatmaps` layout: (B, V, J, H, W)."""

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
        for net in (self.pose_net.center_net, self.pose_net.c2c_net,
                    self.joint_net.conv_net, self.joint_net.weight_net):
            set_compute_dtype(net, cfg.compute_dtype)

    # ------------------------------------------------------------------
    @tracing.spanned("detect")
    def detect(self, heatmaps, rc: RigConstants, packed: dict | None,
               train: bool = False, meta: dict | None = None) -> dict:
        """HDN: heatmaps -> proposals (B, K, 7), the raw maps and C2CNet's
        input, the proposals' z-columns (B*K, Z, J). In train mode
        CenterNet and C2CNet run as their modules, and with `meta` the
        proposals are matched to its people."""
        with tracing.span("whole_sample"):
            volumes = whole_sample(heatmaps, rc, self.cfg)   # (B, X, Y, Z, J)
        return self.propose(volumes, rc, packed, train, meta)

    def propose(self, volumes, rc: RigConstants, packed: dict | None,
                train: bool = False, meta: dict | None = None) -> dict:
        """`detect` from the whole-space volumes (B, X, Y, Z, J) on: the
        view-sharded step enters here with a volume whose view mean it
        reduced over ranks (parallel/sharding.py)."""
        cfg = self.cfg
        B = volumes.shape[0]
        K = cfg.max_people
        nx, ny, nz = cfg.voxels_per_axis

        with tracing.span("centernet"):
            if train:
                hm2d, bbox_map = self.pose_net.center_net(volumes)
            else:
                bev = volumes.amax(dim=3)                    # (B, X, Y, J)
                if "center_net_bf16" in packed:
                    hm2d, bbox_map = centernet_bf16(
                        packed["center_net_bf16"], bev)
                else:
                    hm2d, bbox_map = centernet_forward(packed["center_net"],
                                                       bev)
        with tracing.span("nms"):
            confs2d, xy, flat = nms_topk_2d(hm2d[..., 0].detach(), K)
            bbox_flat = bbox_map.reshape(B, nx * ny, 2)
            match_bbox = torch.gather(
                bbox_flat.detach(), 1, flat[:, :, None].expand(B, K, 2))
            J = volumes.shape[-1]
            vol_flat = volumes.reshape(B, nx * ny, nz, J)
            columns = torch.gather(
                vol_flat, 1, flat[:, :, None, None].expand(B, K, nz, J))
        det = self.place(confs2d, xy, match_bbox, columns, rc, packed,
                         train, meta)
        return {**det, "hm2d": hm2d[..., 0], "bbox_flat": bbox_flat}

    def place(self, confs2d, xy, match_bbox, columns, rc: RigConstants,
              packed: dict | None, train: bool = False,
              meta: dict | None = None) -> dict:
        """`propose` from the NMS peaks on: their confidences (B, K), (x,
        y) voxels (B, K, 2), bbox sizes (B, K, 2) and volume z-columns (B,
        K, Z, J) -> C2CNet's z, the proposals (B, K, 7). The spatially
        sharded step enters here with peaks it picked over row blocks
        (parallel/spatial.py)."""
        cfg = self.cfg
        B, K = confs2d.shape
        nz = cfg.voxels_per_axis[2]
        columns = columns.reshape(B * K, nz, columns.shape[-1])
        with tracing.span("c2cnet"):
            if train:
                hm1d = self.pose_net.c2c_net(columns)
            elif cfg.fuse_p2p and nz % 4 == 0:
                hm1d = c2cnet(packed["c2c_net"], columns)
            else:
                hm1d = _cudnn_net(packed, "c2c_net", self.pose_net.c2c_net,
                                  columns)
            hm1d = hm1d.reshape(B, K, nz)

        with tracing.span("proposals"):
            z_idx = torch.argmax(hm1d.detach(), dim=2)       # (B, K)
            confs1d = hm1d.detach().amax(dim=2)
            scale, bias = rc.voxel_to_mm
            idx_xyz = torch.cat([xy, z_idx[:, :, None].to(torch.int32)],
                                dim=2).to(torch.float32)
            centers_mm = idx_xyz * scale + bias              # (B, K, 3)
            confs = confs2d * confs1d
            if train and meta is not None:
                proposal2gt, match_bbox = match_proposals_to_gt(
                    centers_mm, match_bbox, meta["roots_3d"], meta["bbox"],
                    meta["num_person"])
            else:
                proposal2gt = (confs > cfg.min_score).to(torch.float32) \
                    - 1.0
            proposals = torch.cat([centers_mm, proposal2gt[:, :, None],
                                   confs[:, :, None], match_bbox], dim=2)
        return {"proposals": proposals, "hm1d": hm1d, "columns": columns}

    # ------------------------------------------------------------------
    @tracing.spanned("localize")
    def localize(self, heatmaps, rc: RigConstants, proposals,
                 packed: dict | None, train: bool = False):
        """JLN: tri-planes -> P2PNet -> soft-argmax -> fusion.
        Returns (fused (B, K, J, 3), planes (3, B, K, J, 2), confs (B, K))."""
        cfg = self.cfg
        B, K = proposals.shape[:2]
        J = cfg.num_joints
        n = cfg.ind_voxels_per_axis[0]

        with tracing.span("person_planes"):
            person_mask = proposals[..., 3] >= 0
            planes, offsets = person_planes(
                heatmaps, rc, cfg, proposals[..., 0:3], proposals[..., 5:7],
                person_mask)                                 # (3, BK, n, n, J)
        if train:
            # the reference trains the JLN per scene on its matched people
            # only: the plane stacks scene-major, each scene a BatchNorm
            # group of 3K members under the mask. The masked BatchNorm
            # zeroes the other members, so their planes (zero here, sampled
            # in the reference) change nothing.
            pb = planes.reshape(3, B, K, n, n, J).transpose(0, 1) \
                .reshape(B * 3 * K, n, n, J)
            mask2d = person_mask[:, None, :].expand(B, 3, K).reshape(
                B, 3 * K)
            with tracing.span("p2pnet"):
                feats_b = self.joint_net.conv_net(pb, mask2d)
                tracing.count("jln_planes", pb.shape[0])
            feats = feats_b.reshape(B, 3, K, n, n, J).transpose(0, 1) \
                .reshape(3 * B * K, n, n, J)
            with tracing.span("weightnet"):
                weights = self.joint_net.weight_net(feats_b, mask2d) \
                    .reshape(B, 3, K, J, 1).transpose(0, 1) \
                    .reshape(3, B * K, J, 1)
            with tracing.span("soft_argmax"):
                coords, confs = plain_softargmax.soft_argmax(
                    feats.reshape(3, B * K, n * n, J), rc.center_grid,
                    cfg.beta)
        else:
            flat = planes.reshape(3 * B * K, n, n, J)
            with tracing.span("p2pnet"):
                if cfg.fuse_p2p and hourglass_supported(flat.shape):
                    feats = p2pnet(packed["p2p_net"], flat)
                else:
                    feats = _cudnn_net(packed, "conv_net",
                                       self.joint_net.conv_net, flat)
                tracing.count("jln_planes", flat.shape[0])
            with tracing.span("soft_argmax"):
                coords, confs = soft_argmax(
                    feats.reshape(3, B * K, n * n, J), rc.center_grid,
                    cfg.beta)
            with tracing.span("weightnet"):
                if "weight_net_bf16" in packed:
                    pooled = weightnet_pool_bf16(feats,
                                                 packed["weight_net_bf16"])
                else:
                    pooled = weightnet_pool(feats, packed["weight_net"])
                # pooled: (3BK, J, C)
                weights = self.joint_net.weight_net.head(pooled).reshape(
                    3, B * K, J, 1)
        with tracing.span("fuse"):
            off = offsets.reshape(B * K, 1, 3)
            coords = torch.stack([
                coords[0] + off[..., 0:2],                   # xy plane
                coords[1] + off[..., ::2],                   # xz plane
                coords[2] + off[..., 1:],                    # yz plane
            ])
            fused = self._fuse(coords, weights)              # (BK, J, 3)
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

    @staticmethod
    @tracing.spanned("finish")
    def finish(proposals, fused, jln_confs) -> dict:
        """forward's tail on the HDN's proposals (B, K, 7) and the JLN's
        fused poses (B, K, J, 3) and scores (B, K): unmatched people are
        zeroed, matched ones take the JLN score. Returns fused_poses (B, K,
        J, 5), the scored proposals and the mask (B, K)."""
        B, K, J = fused.shape[:3]
        mask = proposals[..., 3] >= 0                        # (B, K)
        fused = fused * mask[..., None, None].to(fused.dtype)
        proposals = proposals.clone()
        proposals[..., 4] = torch.where(mask, jln_confs.detach(),
                                        proposals[..., 4])
        tail = proposals[:, :, None, 3:5].expand(B, K, J, 2)
        return {"fused_poses": torch.cat([fused, tail], dim=3),
                "proposals": proposals, "mask": mask}

    # ------------------------------------------------------------------
    def forward(self, heatmaps, rc: RigConstants, packed: dict | None = None,
                train: bool = False, meta: dict | None = None):
        """`packed`: the kernels' weights (engine/packing.py::pack_model),
        which the eval forward needs. `train` must match the module's mode
        (`model.train()` / `model.eval()`); `meta` (train mode): the
        batch's people (roots_3d, bbox, num_person) the proposals are
        matched to."""
        if train != self.training:
            raise ValueError(f"forward(train={train}) on a module in "
                             f"{'train' if self.training else 'eval'} mode")
        if not train and packed is None:
            raise ValueError("the eval forward needs the packed weights")
        det = self.detect(heatmaps, rc, packed, train, meta)
        return self.complete(det, heatmaps, rc, packed, train)

    def complete(self, det: dict, heatmaps, rc: RigConstants,
                 packed: dict | None, train: bool = False) -> dict:
        """`forward` after the HDN: the JLN on `det`'s proposals and the
        heatmaps, then `finish`. The sharded train step enters here with
        its reduced volume's detection and its gathered heatmaps
        (parallel/sharding.py)."""
        fused, planes, jln_confs = self.localize(
            heatmaps, rc, det["proposals"], packed, train)
        out = self.finish(det["proposals"], fused, jln_confs)
        fmask = out["mask"][..., None, None].to(planes.dtype)
        return {
            **out,
            "plane_poses": planes * fmask[None],
            "hm2d": det["hm2d"],
            "hm1d": det["hm1d"],
            "bbox_flat": det["bbox_flat"],
        }


# ---------------------------------------------------------------------------
# training losses
# ---------------------------------------------------------------------------

def compute_losses(cfg: FVPConfig, outputs: dict, targets: dict,
                   meta: dict, data=None) -> dict:
    """The four losses of the reference package's `compute_losses`, with
    its masking and normalisation.

    targets: 2d_heatmaps (B, X, Y), 1d_heatmaps (B, G, Z), index (B, G),
             bbox (B, G, 2), mask (B, G)
    meta:    joints_3d (B, G, J, 3), joints_3d_vis (B, G, J)

    `data` (the data-parallel train step, parallel/sharding.py): the
    'data' axis (parallel/mesh.py::Axis) whose ranks hold the other
    blocks of the batch. The denominators are then the global batch's
    (its B*X*Y cells, matched proposals and target people), summed over
    the axis, and each loss is this block's numerator over them: the
    losses' sum over the ranks is the global batch's loss, as the
    reference's one global program computes it.
    """
    prop = outputs["proposals"]
    mask = outputs["mask"]                                  # (B, K)
    B, K = mask.shape
    J = cfg.num_joints
    p2g_idx = prop[..., 3].clamp(min=0.0).to(torch.int64)    # (B, K)
    tmask = targets["mask"].to(torch.float32)
    se_2d = (outputs["hm2d"] - targets["2d_heatmaps"]) ** 2
    if data is None:
        n_matched = mask.sum()
        n_target = tmask.sum()
        mean_2d = se_2d.mean()
    else:
        n_matched, n_target, cells = data.all_reduce_sum(torch.stack([
            mask.sum().to(torch.float32), tmask.sum(),
            se_2d.new_tensor(float(se_2d.numel()))]))
        mean_2d = se_2d.sum() / cells

    # 2D BEV heatmap MSE over every cell
    loss_2d = cfg.lambda_loss_2d * mean_2d

    # 1D z-heatmap MSE over matched proposals only
    t1d = targets["1d_heatmaps"]
    Z = t1d.shape[2]
    matched_1d = torch.gather(t1d, 1, p2g_idx[:, :, None].expand(B, K, Z))
    se_1d = (outputs["hm1d"] - matched_1d) ** 2
    denom_1d = (n_matched * Z).clamp(min=1)
    loss_1d = cfg.lambda_loss_1d * (se_1d * mask[:, :, None]).sum() \
        / denom_1d

    # bbox L1 at the GT center cells (the target mask is `arange <=
    # num_person`, one padding row included, as the reference has it)
    gt_index = targets["index"].to(torch.int64)             # (B, G)
    pred_bbox = torch.gather(outputs["bbox_flat"], 1,
                             gt_index[:, :, None].expand(-1, -1, 2))
    denom_bb = (n_target * 2).clamp(min=1)
    loss_bbox = cfg.lambda_loss_bbox * ((pred_bbox - targets["bbox"]).abs()
                                        * tmask[:, :, None]).sum() / denom_bb

    # joint losses over matched proposals, visibility-weighted
    gt_j = torch.gather(meta["joints_3d"], 1,
                        p2g_idx[:, :, None, None].expand(B, K, J, 3))
    vis = torch.gather(meta["joints_3d_vis"].to(torch.float32), 1,
                       p2g_idx[:, :, None].expand(B, K, J))[..., None]
    pm = mask[:, :, None, None].to(torch.float32)

    def masked_l1(pred, gt, width):
        denom = (n_matched * J * width).clamp(min=1)
        return ((pred * vis - gt * vis).abs() * pm).sum() / denom

    planes = outputs["plane_poses"]
    loss_joint = (
        masked_l1(planes[0], gt_j[..., 0:2], 2)
        + masked_l1(planes[1], gt_j[..., ::2], 2)
        + masked_l1(planes[2], gt_j[..., 1:], 2)
        + cfg.lambda_loss_fused
        * masked_l1(outputs["fused_poses"][..., 0:3], gt_j, 3))
    loss_joint = torch.where(n_matched > 0, loss_joint,
                             torch.zeros_like(loss_joint))
    return {
        "2d_heatmaps": loss_2d,
        "1d_heatmaps": loss_1d,
        "bbox": loss_bbox,
        "joint": loss_joint,
        "total": loss_2d + loss_1d + loss_bbox + loss_joint,
    }
