"""The port's spatial ('data', 'space') pipeline mesh
(fvp_torch/parallel/spatial.py) on the CPU over gloo, held against the
reference package's fvp_tpu/parallel/spatial.py on its 8-device CPU mesh
(tests/test_spatial.py's cases): one spawned job of 8 ranks builds a (1,
8) 'space' mesh and a (2, 4) pipeline mesh and runs every sharded check
on both (`tests/torch_ranks.py::spatial_rank`); K1's row block, the
mesh helpers and a world of one run in this process."""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import fvp_torch.config as tcfg
import fvp_torch.geometry.cameras as tcam
import fvp_tpu.ops.sampling as jsampling
from fvp_torch.engine.serve import Predictor
from fvp_torch.geometry.grids import build_rig_constants as \
    port_rig_constants
from fvp_torch.models.convert import from_jax_variables
from fvp_torch.models.faster_voxelpose import FasterVoxelPose as TModel
from fvp_torch.ops.kernels import sampler as ksamp
from fvp_torch.ops.nms import nms_topk_2d as port_nms
from fvp_torch.parallel import (make_mesh, make_pipeline_mesh,
                                make_spatial_eval_step, make_spatial_mesh,
                                shard_data, spatial_size)
from fvp_torch.parallel.mesh import Mesh, free_port, init_distributed
from fvp_tpu.config import FVPConfig
from fvp_tpu.geometry.cameras import default_ring_rig
from fvp_tpu.geometry.grids import build_rig_constants
from fvp_tpu.models.cnns import CenterNet as RefCenterNet
from fvp_tpu.models.faster_voxelpose import FasterVoxelPose
from fvp_tpu.parallel import spatial as ref_spatial
from tests.helpers import random_rig
from tests.test_torch_nets import perturbed_variables, small_cfg
from tests.test_torch_validate import _snap_centers_op_by_op
from tests.torch_ranks import run_ranks, spatial_rank

WORLD = 8
SEAMS = (10, 40, 70)          # boundary rows of blocks 1, 4, 7 (10 rows)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(cfg):
    return tcfg.FVPConfig(**dataclasses.asdict(cfg))


def _port_rig(rig):
    return tcam.CameraRig(rig.R, rig.T, rig.f, rig.c, rig.k, rig.p)


@functools.lru_cache(maxsize=None)
def _variables():
    """tests/test_torch_parallel.py's weights: perturbed flax weights (15
    joints) with CenterNet's and C2CNet's output heads scaled x30, so
    that the detection maps have no near-ties."""
    v = copy.deepcopy(perturbed_variables(small_cfg(), 7))
    p = v["params"]
    p["center_net"]["Conv_1"]["kernel"] *= np.float32(30.0)
    p["c2c_net"]["Conv_0"]["kernel"] *= np.float32(30.0)
    return v


def pipe_cfg():
    """tests/test_spatial.py's pipeline config."""
    return FVPConfig(
        num_joints=15, num_views=3, heatmap_size=(60, 32),
        voxels_per_axis=(32, 32, 8), ind_voxels_per_axis=(16, 16, 16),
        max_people=4, min_score=0.0, sampling_backend="exact")


def _seam_maps():
    """A Gaussian peak centred on each seam row and one row above it
    (cy = 33), one map each: (6, 80, 80)."""
    xs, ys = np.meshgrid(np.arange(80), np.arange(80), indexing="ij")
    return np.stack([np.exp(-((xs - x) ** 2 + (ys - 33) ** 2) / 8.0)
                     for s in SEAMS for x in (s, s - 1)]).astype(np.float32)


@pytest.fixture(scope="module")
def job():
    """The inputs, the spawned job's results by rank, and the weights."""
    rng = np.random.RandomState(0)
    variables = _variables()
    cfg = pipe_cfg()
    rig = default_ring_rig(cfg.num_views, cfg.space_center,
                           cfg.ori_image_size)
    port = TModel(_port(small_cfg()))
    port.load_state_dict(from_jax_variables(variables))
    inp = {
        "nms": {"rand": (rng.rand(3, 80, 80).astype(np.float32), 10),
                "neg": (rng.randn(2, 80, 80).astype(np.float32), 6),
                "seam": (_seam_maps(), 10)},
        "vol": rng.rand(1, 64, 80, 8, 15).astype(np.float32),
        "centernet": port.pose_net.center_net.state_dict(),
        "cfg": _port(cfg), "rig": _port_rig(rig), "variables": variables,
        "heatmaps": rng.rand(2, cfg.num_views, cfg.num_joints, 32, 60)
        .astype(np.float32)}
    inp["bev"] = inp["vol"].max(axis=3)
    args = {k: v for k, v in inp.items() if k != "vol"}
    return inp, run_ranks(spatial_rank, WORLD, (args,), timeout=240.0), \
        cfg, rig


def _same_on_every_rank(res, key):
    for r in range(1, WORLD):
        for a, b in zip(res[0][key], res[r][key]):
            np.testing.assert_array_equal(a, b)
    return res[0][key]


@pytest.mark.parametrize("name", ["rand", "neg"])
def test_sharded_nms_bitwise(job, name):
    """8 blocks of 10 rows: every rank returns the same (vals, xy, flat),
    bit for bit the port's single-map nms_topk_2d and the reference's
    sharded_nms_topk_2d on its 8-device mesh (negative maps: the outer
    halo is -inf, not 0)."""
    inp, res, _, _ = job
    hm, k = inp["nms"][name]
    got = _same_on_every_rank(res, name)
    ref = port_nms(torch.from_numpy(hm), k)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b.numpy())
    jv, jxy, jflat = ref_spatial.sharded_nms_topk_2d(
        ref_spatial.make_spatial_mesh(WORLD), jnp.asarray(hm), k)
    np.testing.assert_array_equal(got[0], np.asarray(jv))
    np.testing.assert_array_equal(got[1], np.asarray(jxy))
    np.testing.assert_array_equal(got[2], np.asarray(jflat))


def test_seam_peak_detected_exactly_once(job):
    """A peak on a seam row, and one row above it, is detected once, at its
    own (x, y)."""
    inp, res, _, _ = job
    vals, xy, _ = _same_on_every_rank(res, "seam")
    peaks = [x for s in SEAMS for x in (s, s - 1)]
    for b, x in enumerate(peaks):
        assert (vals[b] > 0.5).sum() == 1, (x, vals[b])
        assert tuple(xy[b, 0]) == (x, 33)


def test_tie_order_across_blocks():
    """Equal values on several blocks merge in flat-index order, as the
    single map's stable sort takes them: the top-K of a map of zeros with
    a few equal peaks is the single-map op's, bit for bit (checked here
    on the merge alone, with the blocks' candidates as the job builds
    them)."""
    hm = torch.zeros(1, 80, 80)
    for x, y in ((75, 3), (12, 50), (12, 2), (41, 41), (2, 79)):
        hm[0, x, y] = 0.5
    ref = port_nms(hm, 10)
    keep = hm.reshape(1, 8, 10 * 80)
    parts = [torch.sort(keep[:, i], dim=1, descending=True, stable=True)
             for i in range(8)]
    vals = torch.cat([v[:, :10] for v, _ in parts], dim=1)
    flat = torch.cat([f[:, :10] + i * 800 for i, (_, f) in enumerate(parts)],
                     dim=1)
    v, sel = torch.sort(vals, dim=1, descending=True, stable=True)
    assert torch.equal(v[:, :10], ref[0])
    assert torch.equal(torch.gather(flat, 1, sel[:, :10]), ref[2])


def test_spatial_centernet_matches_reference(job):
    """8 blocks of 8 rows of a (1, 64, 80, 8, 15) volume's BEV map through
    spatial_centernet, joined, against the reference's CenterNet.apply on
    the whole volume: rtol/atol 1e-5 (tests/test_spatial.py's); 10 rows a
    block raise, naming the mesh."""
    inp, res, _, _ = job
    v = _variables()
    ref_hm, ref_size = RefCenterNet().apply(
        {"params": v["params"]["center_net"],
         "batch_stats": v["batch_stats"]["center_net"]},
        jnp.asarray(inp["vol"]), train=False)
    hm = np.concatenate([res[r]["centernet"][0] for r in range(WORLD)], 1)
    size = np.concatenate([res[r]["centernet"][1] for r in range(WORLD)], 1)
    np.testing.assert_allclose(hm, np.asarray(ref_hm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(size, np.asarray(ref_size), rtol=1e-5,
                               atol=1e-5)
    assert float(np.abs(hm).max()) > 1e-2           # not vacuous
    for r in range(WORLD):
        assert "(1, 8)" in res[r]["raised"] and "by 4" in res[r]["raised"]


def _reference_pipeline(cfg, rig, variables, hm, op_by_op_snap):
    """The reference's unsharded jitted apply and its
    make_spatial_eval_step on make_pipeline_mesh(2, 4), with its
    snap_centers as it is or op by op."""
    rc = jax.tree_util.tree_map(jnp.asarray, build_rig_constants(cfg, rig))
    plain = FasterVoxelPose(cfg=cfg)
    with pytest.MonkeyPatch.context() as mp:
        if op_by_op_snap:
            mp.setattr(jsampling, "snap_centers", _snap_centers_op_by_op)
        ref = jax.jit(lambda h: plain.apply(variables, h, rc, train=False)[
            "fused_poses"])(jnp.asarray(hm))
        mesh = ref_spatial.make_pipeline_mesh(2, 4)
        sharded = FasterVoxelPose(cfg=cfg, spatial_mesh=mesh)
        par = ref_spatial.make_spatial_eval_step(cfg, sharded, mesh)(
            variables, jnp.asarray(hm), rc)
    return np.asarray(ref), np.asarray(par)


def test_pipeline_matches_reference(job):
    """The (2 data, 4 space) pipeline: every rank of a 'space' group
    returns the same output, and the two data blocks together match the
    port's unsharded Predictor and the reference's make_spatial_eval_step
    and unsharded apply: identical masks with >= 2 people kept, coords
    rtol 1e-4, atol 5e-3 (tests/test_spatial.py's). The poses are held
    against the reference with its snap_centers corner op by op (ROADMAP
    Queue 3 item 3, as tests/test_torch_parallel.py does); the masks
    against it as it is too."""
    inp, res, cfg, rig = job
    for r in range(WORLD):
        assert res[r]["pipe"] == divmod(r, 4)
        assert res[r]["space"] == list(range(WORLD))
    for d in range(2):
        for r in range(4 * d + 1, 4 * d + 4):
            for k, v in res[r]["pipeline"].items():
                np.testing.assert_array_equal(v, res[4 * d]["pipeline"][k])
    got = np.concatenate([res[0]["pipeline"]["fused_poses"],
                          res[4]["pipeline"]["fused_poses"]])
    mask = got[..., 0, 3] >= 0
    assert mask.sum() >= 2 and mask.all(axis=0).any()
    pred = Predictor(inp["cfg"], inp["variables"], inp["rig"], device="cpu")
    refs = [pred(inp["heatmaps"])["fused_poses"].numpy(),
            *_reference_pipeline(cfg, rig, inp["variables"],
                                 inp["heatmaps"], op_by_op_snap=True)]
    for ref in refs:
        np.testing.assert_array_equal(got[..., 3], ref[..., 3])
        np.testing.assert_allclose(got[..., :3], ref[..., :3], rtol=1e-4,
                                   atol=5e-3)
    for ref in _reference_pipeline(cfg, rig, inp["variables"],
                                   inp["heatmaps"], op_by_op_snap=False):
        np.testing.assert_array_equal(got[..., 3], ref[..., 3])


@pytest.mark.parametrize("x0,rows", [(0, 8), (8, 16), (24, 8)])
def test_whole_sample_row_block_plain(x0, rows):
    """K1's plain row-block mode on row_block's coords: the whole volume's
    rows x0 .. x0+rows-1, bit for bit, in mean and in sum mode."""
    cfg = _port(pipe_cfg())
    rng = np.random.RandomState(4)
    rc = port_rig_constants(cfg, _port_rig(random_rig(rng, num_views=3))
                            ).to("cpu")
    hm = torch.from_numpy(rng.rand(2, 3, 15, 32, 60).astype(np.float32))
    block = ksamp.row_block(rc, cfg, x0, rows)
    assert block.whole_sample_px.is_contiguous()
    for view_sum in (False, True):
        whole = ksamp.whole_sample(hm, rc, cfg, view_sum)
        got = ksamp.whole_sample(hm, block, cfg, view_sum, rows=(x0, rows))
        assert got.shape == (2, rows, 32, 8, 15)
        assert torch.equal(got, whole[:, x0:x0 + rows])


def test_mesh_axes():
    """The pipeline mesh names its second axis 'space'; spatial_size is 1
    without one."""
    mesh = Mesh((2, 4), 6, axis_names=("data", "space"))
    assert mesh.coords == (1, 2)
    assert mesh.axis_ranks("space") == [4, 5, 6, 7]
    assert mesh.axis_ranks("data") == [2, 6]
    assert spatial_size(mesh) == 4 and mesh.size("data") == 2
    assert spatial_size(None) == 1
    assert spatial_size(Mesh((2, 2), 0)) == 1
    with pytest.raises(ValueError, match="no axis"):
        Mesh((2, 2), 0).axis_ranks("space")


@pytest.fixture
def world1():
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cpu")
    yield
    dist.destroy_process_group()


def test_world1_is_the_unsharded_step(world1):
    """A (1, 1) pipeline mesh and a (1, 1) 'space' mesh are the unsharded
    eval forward bit for bit; a ('data', 'view') mesh is refused."""
    cfg = _port(pipe_cfg())
    rig = _port_rig(default_ring_rig(3, cfg.space_center,
                                     cfg.ori_image_size))
    pred = Predictor(cfg, _variables(), rig, device="cpu")
    hm = np.random.RandomState(1).rand(2, 3, 15, 32, 60).astype(np.float32)
    ref = pred(hm)
    for mesh in (make_pipeline_mesh(1, 1), make_spatial_mesh(1)):
        got = make_spatial_eval_step(pred, mesh)(shard_data(mesh, hm),
                                                 pred.rc)
        for k in ("fused_poses", "proposals", "mask"):
            assert torch.equal(got[k], ref[k]), k
    with pytest.raises(ValueError, match="no 'space' axis"):
        make_spatial_eval_step(pred, make_mesh(1, 1))
