"""Voxel-block spatial sharding: the whole-space volume and BEV maps split
over the 'space' ranks of a ('data', 'space') mesh (mesh.py) along the x
(row) axis, with explicit seam-row exchange for windowed ops.

The counterpart of the reference package's fvp_tpu/parallel/spatial.py,
whose windowed ops see (kernel - 1) / 2 rows across each seam: the 3x3
NMS window (its explicit shard_map with `ppermute` halos) and CenterNet's
convs (which GSPMD partitions, inserting the halos itself). Here a rank
holds x-rows x0 .. x0+XL-1 and the seam rows move point to point between
neighbouring ranks (`exchange_rows`):

* NMS + top-K (`sharded_nms_topk_2d`): a 1-row halo, -inf at the outer
  edge as the single-map max pool pads; each block's top-K candidates by
  the single map's stable descending sort, gathered block-major (which is
  flat-index-major) and merged by the same sort: bit for bit
  ops/nms.py::nms_topk_2d on the whole map, tie order included. A peak on
  a seam survives on its own block only, since both neighbours see it
  through the halo.
* CenterNet (`spatial_centernet`): every conv with k > 1 takes (k - 1) / 2
  rows from each neighbour, zeros at the outer edge as its own padding,
  and pads y alone; 1x1 convs, BN, ReLU, the 2x2/2 pools and transposed
  convs are local when a block's rows divide by 4. GSPMD also splits
  blocks whose rows do not; here they raise.

`make_spatial_eval_step` runs the eval forward on a rank of the mesh: K1
on its x-rows, the z-max, CenterNet, the NMS, each proposal's z-column
and bbox from the rank that owns its row, then C2CNet, the JLN on all K
people and the forward's tail, replicated over 'space', as the reference
leaves them (it sets no `jln_mesh` there). With one 'space' rank it is
the unsharded eval forward. The CenterNet kernel (K5) is not on this
path, as the reference's `pallas_centernet` is not under a spatial mesh
(fvp_tpu/models/faster_voxelpose.py:170).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from fvp_torch.engine.serve import Engine, backbone_heatmaps, float32_math
from fvp_torch.geometry.grids import RigConstants
from fvp_torch.models.blocks import add_bias_bf16
from fvp_torch.models.cnns import CenterNet
from fvp_torch.models.faster_voxelpose import FasterVoxelPose
from fvp_torch.ops.kernels.sampler import row_block, whole_sample
from fvp_torch.parallel.mesh import Mesh, spatial_size, staged


def exchange_rows(mesh: Mesh, x: torch.Tensor, halo: int, fill: float,
                  dim: int = 1) -> torch.Tensor:
    """This rank's row block `x` with `halo` rows of each neighbouring
    block's on either side along `dim`: block i's last rows go to block
    i+1's top and its first rows to block i-1's bottom (the reference's
    `ppermute`), point to point in the 'space' group; the outer edges take
    `fill`."""
    n, i = mesh.size("space"), mesh.coords[1]
    if x.shape[dim] < halo:
        raise ValueError(f"a block of {x.shape[dim]} rows cannot give a "
                         f"halo of {halo}")
    edges = {i - 1: x.narrow(dim, 0, halo),                # to the top
             i + 1: x.narrow(dim, x.shape[dim] - halo, halo)}
    halos = {j: torch.full_like(e, fill) for j, e in edges.items()}
    peers = [j for j in edges if 0 <= j < n]
    if peers:
        group = mesh.groups["space"]
        ranks = mesh.axis_ranks("space")
        host = staged(x, group)
        send = {j: edges[j].contiguous() for j in peers}
        if host:
            send = {j: t.cpu() for j, t in send.items()}
        recv = {j: torch.empty_like(send[j]) for j in peers}
        ops = []
        for j in peers:
            ops += [dist.P2POp(dist.isend, send[j], ranks[j], group),
                    dist.P2POp(dist.irecv, recv[j], ranks[j], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for j in peers:
            halos[j] = recv[j].to(x.device)
            if host:
                mesh.staged_bytes += send[j].nbytes + recv[j].nbytes
    top, bottom = halos[i - 1], halos[i + 1]
    return torch.cat([top, x, bottom], dim=dim)


def sharded_nms_topk_2d(mesh: Mesh, hm_block: torch.Tensor, max_num: int,
                        kernel: int = 3):
    """ops/nms.py::nms_topk_2d over the 'space' ranks: `hm_block` is this
    rank's rows (B, XL, Y) of (B, X, Y) maps. Returns (vals (B, K), xy
    (B, K, 2) int32, flat (B, K) int64) of the whole maps, the same on
    every rank of the 'space' group and bit for bit the single-map op."""
    B, XL, Y = hm_block.shape
    halo = (kernel - 1) // 2
    if max_num > XL * Y:
        raise ValueError(f"top-{max_num} of a block of {XL * Y} cells")
    x0 = mesh.coords[1] * XL
    neg = float("-inf")
    padded = F.pad(exchange_rows(mesh, hm_block, halo, neg),
                   (halo, halo), value=neg)
    local_max = F.max_pool2d(padded[:, None], kernel, stride=1)[:, 0]
    keep = torch.where(hm_block == local_max, hm_block,
                       torch.zeros_like(hm_block)).reshape(B, XL * Y)
    vals, flat = torch.sort(keep, dim=1, descending=True, stable=True)
    flat = flat[:, :max_num] + x0 * Y
    vals = mesh.all_gather(vals[:, :max_num], 1, "space")    # block-major
    flat = mesh.all_gather(flat, 1, "space")
    vals, sel = torch.sort(vals, dim=1, descending=True, stable=True)
    flat = torch.gather(flat, 1, sel[:, :max_num])
    xy = torch.stack([flat // Y, flat % Y], dim=2).to(torch.int32)
    return vals[:, :max_num], xy, flat


def _halo_conv(mesh: Mesh, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv` (k x k, padding k // 2) on this rank's rows (B, C, XL, Y):
    the neighbours' seam rows (zeros at the outer edge) in place of its
    x padding."""
    h = conv.kernel_size[0] // 2
    if conv.compute_dtype == torch.bfloat16:
        # bf16 values move as float32 (exact) and round back
        x = exchange_rows(mesh, x.float(), h, 0.0, dim=2).to(torch.bfloat16)
        return add_bias_bf16(conv.product(
            x, conv.weight.to(torch.bfloat16), (0, h)), conv.bias)
    return F.conv2d(exchange_rows(mesh, x, h, 0.0, dim=2), conv.weight,
                    conv.bias, padding=(0, h))


@contextlib.contextmanager
def _halo_convs(net: nn.Module, mesh: Mesh):
    """Inside, every conv of `net` with k > 1 runs as `_halo_conv`."""
    convs = [m for m in net.modules()
             if isinstance(m, nn.Conv2d) and m.kernel_size[0] > 1]
    for c in convs:
        c.forward = lambda x, c=c: _halo_conv(mesh, c, x)
    try:
        yield
    finally:
        for c in convs:
            del c.forward


def spatial_centernet(net: CenterNet, bev_block: torch.Tensor, mesh: Mesh):
    """The CenterNet module in eval mode on this rank's rows (B, XL, Y, J)
    of the BEV map -> its rows of (hm (B, XL, Y, 1), size (B, XL, Y, 2)),
    the seam rows exchanged for every conv with k > 1. The two 2x2/2
    pools halve the rows twice, so XL must divide by 4."""
    XL = bev_block.shape[1]
    if XL % 4:
        raise ValueError(f"spatial CenterNet: blocks of {XL} x-rows on a "
                         f"{mesh.shape} {mesh.axis_names} mesh; its two "
                         "2x2 pools need rows that divide by 4")
    with _halo_convs(net, mesh):
        return net.bev_forward(bev_block)


def make_spatial_forward(model: FasterVoxelPose, packed: dict, mesh: Mesh):
    """`forward(heatmaps, rc)` of the eval model on this rank of a
    ('data', 'space') mesh: heatmaps (B, V, J, h, w) of its 'data' block,
    all views, replicated over 'space'; `rc` the rig constants of all V
    views. Returns {'fused_poses' (B, K, J, 5), 'proposals' (B, K, 7),
    'mask' (B, K)}, the same on every rank of the 'space' group. Each
    rig's row block of K1's coords is made once."""
    cfg = model.cfg
    n = spatial_size(mesh)
    nx, ny, nz = cfg.voxels_per_axis
    K = cfg.max_people
    if nx % n:
        raise ValueError(f"{nx} x-rows do not split over {n} 'space' ranks")
    XL = nx // n
    x0 = mesh.coords[1] * XL
    blocks: dict[int, tuple[RigConstants, RigConstants]] = {}

    def forward(hm: torch.Tensor, rc: RigConstants) -> dict:
        if n == 1:
            out = model(hm, rc, packed)
            return {k: out[k] for k in ("fused_poses", "proposals", "mask")}
        if id(rc) not in blocks:
            blocks[id(rc)] = (rc, row_block(rc, cfg, x0, XL))
        vol = whole_sample(hm, blocks[id(rc)][1], cfg, rows=(x0, XL))
        B, J = vol.shape[0], vol.shape[-1]
        hm2d, bbox = spatial_centernet(model.pose_net.center_net,
                                       vol.amax(dim=3), mesh)
        confs2d, xy, flat = sharded_nms_topk_2d(mesh, hm2d[..., 0], K)
        # each peak's bbox and z-column from the rank that owns its row,
        # zeros from the others, summed: exact
        lx = xy[..., 0].to(torch.int64) - x0
        mine = ((lx >= 0) & (lx < XL))[..., None]
        idx = (lx.clamp(0, XL - 1) * ny + xy[..., 1])[..., None]
        cells = torch.cat([bbox.reshape(B, XL * ny, 2),
                           vol.reshape(B, XL * ny, nz * J)], dim=2)
        picked = torch.gather(cells, 1, idx.expand(B, K, cells.shape[2]))
        picked = mesh.all_reduce_sum(
            torch.where(mine, picked, torch.zeros_like(picked)), "space")
        det = model.place(confs2d, xy, picked[..., :2],
                          picked[..., 2:].reshape(B, K, nz, J), rc, packed)
        fused, _, scores = model.localize(hm, rc, det["proposals"], packed)
        return model.finish(det["proposals"], fused, scores)

    return forward


def make_spatial_eval_step(engine: Engine, mesh: Mesh):
    """`step(block, rc)` on this rank of a ('data', 'space') mesh: `block`
    is its 'data' block of a frame batch with all views, replicated over
    'space' (parallel/sharding.py::shard_data), heatmaps (B, V, J, h, w)
    or, where `engine` holds a backbone, normalized images (B, V, H, W,
    3); `rc` the engine's rig constants. Returns, as `Predictor` does,
    {'fused_poses', 'proposals', 'mask'} of the block, the same on every
    rank of the 'space' group. Every rank builds `engine` from the same
    weights."""
    if not mesh.active:
        raise ValueError(f"rank {mesh.rank} is idle on a {mesh.shape} mesh")
    if "space" not in mesh.axis_names:
        raise ValueError(f"a {mesh.axis_names} mesh has no 'space' axis")
    forward = make_spatial_forward(engine.model, engine.packed, mesh)

    @torch.inference_mode()
    @float32_math()
    def step(block, rc: RigConstants) -> dict[str, torch.Tensor]:
        x = torch.as_tensor(block, dtype=torch.float32, device=engine.device)
        if engine.backbone is not None:
            hm = backbone_heatmaps(engine.cfg, engine.backbone,
                                   engine.backbone_packed, x)
        else:
            hm = x.contiguous()
        return forward(hm, rc)

    return step
