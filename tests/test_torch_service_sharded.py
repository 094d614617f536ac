"""The port's view-sharded and multi-host service (fvp_torch/service/
pipeline.py over fvp_torch/parallel/) on the CPU over gloo: a rank's
block of views prepared alone; the leader's raw frames shared over a
host's ranks; the inference process of one host with a
coordinator, bit for bit against a Predictor; the whole topology with its
views sharded over two local ranks (FVP_CPU_DEVICES=2, the counterpart of
tests/test_service.py's sharded end-to-end test); a rehearsal of two hosts;
a rank that ends when its leader is killed; and the CLI's
--coordinator."""

import dataclasses
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import fvp_torch.config as tcfg
from fvp_torch.engine import flax_msgpack
from fvp_torch.engine.checkpoint import load_model_state
from fvp_torch.engine.serve import Predictor
from fvp_torch.parallel.mesh import free_port
from fvp_torch.service import pipeline
from fvp_torch.service.sources import SPAWN, FrameQueue
from tests.helpers import tiny_config
from tests.test_torch_nets import perturbed_variables, small_cfg
from tests.torch_ranks import (leader_of_one_rank, run_ranks, service_host,
                               share_frame_rank)

cv2 = pytest.importorskip("cv2")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A 2-view small config with a gate below every confidence (all K
    people come out), the reference's perturbed weights written as a
    model_best.msgpack, and three frames of 2 raw views."""
    cfg = tcfg.FVPConfig(**dataclasses.asdict(small_cfg(
        heatmap_size=(64, 32), min_score=-1.0)))
    ckpt = tmp_path_factory.mktemp("svc") / "model_best.msgpack"
    ckpt.write_bytes(flax_msgpack.dumps(perturbed_variables(cfg, 7)))
    rng = np.random.RandomState(8)
    frames = [[rng.randint(0, 256, (96, 160, 3), dtype=np.uint8)
               for _ in range(cfg.num_views)] for _ in range(3)]
    return cfg, str(ckpt), frames


def _direct(cfg, ckpt, frames):
    """Each frame through a CPU Predictor of the same weights."""
    svc = pipeline.ServiceConfig(cfg_obj=cfg, num_views=cfg.num_views)
    pred = Predictor.from_state_dict(cfg, load_model_state(ckpt),
                                     pipeline._service_rig(svc, cfg),
                                     device="cpu")
    return [pred(pipeline._frames_to_heatmaps(cfg, v))["fused_poses"][0]
            .numpy() for v in frames]


@pytest.mark.parametrize("prepare", ["_frames_to_images",
                                     "_frames_to_heatmaps"])
def test_view_block_prepared_alone(prepare):
    """A rank's views lo..hi, prepared alone, are that block of the whole
    frame's preparation, bit for bit (a missing view stays zero)."""
    cfg = tcfg.FVPConfig(**dataclasses.asdict(tiny_config(
        num_views=4, heatmap_size=(60, 32), image_size=(160, 96))))
    rng = np.random.RandomState(1)
    views = [rng.randint(0, 256, (96, 160, 3), dtype=np.uint8)
             for _ in range(3)]                     # one view missing
    fn = getattr(pipeline, prepare)
    whole = fn(cfg, views)
    for lo, hi in ((0, 2), (2, 4), (1, 2), (3, 4)):
        np.testing.assert_array_equal(fn(cfg, views, lo, hi),
                                      whole[:, lo:hi])
    assert not whole[:, 3].any()


def test_share_frame_over_a_host():
    """The leader's raw frames reach the host's other ranks bit for bit
    over its gloo group: views of other shapes, a grayscale one and a
    non-contiguous one (split_quad's slices), then the idle and stop
    codes."""
    rng = np.random.RandomState(2)
    big = rng.randint(0, 256, (9, 13, 3), dtype=np.uint8)
    frames = [[rng.randint(0, 256, (6, 8, 3), dtype=np.uint8),
               rng.randint(0, 256, (5, 7), dtype=np.uint8),
               big[:4, 6:]],
              [rng.randint(0, 256, (3, 2, 3), dtype=np.uint8)]]
    res = run_ranks(share_frame_rank, 3, (frames,))
    for r in range(3):
        got = res[r]
        assert [c for c, _ in got] == [pipeline._FRAME] * 2 + [
            pipeline._IDLE, pipeline._STOP]
        for (_, views), sent in zip(got, frames):
            assert len(views) == len(sent)
            for a, b in zip(views, sent):
                np.testing.assert_array_equal(a, b)
        assert got[2][1] is None and got[3][1] is None


def test_one_host_with_coordinator_bitwise(served):
    """The inference process with a coordinator and one host: a job of one
    rank through the sharded step, each frame's poses bit for bit those of
    a direct Predictor call."""
    cfg, ckpt, frames = served
    svc = pipeline.ServiceConfig(
        cfg_obj=cfg, num_views=cfg.num_views, checkpoint=ckpt,
        max_frames=len(frames), view_mode="none", device="cpu",
        coordinator=f"127.0.0.1:{free_port()}", num_hosts=1, host_id=0)
    frame_q, result_q = FrameQueue(maxsize=3), FrameQueue(maxsize=3)
    for q in (frame_q, result_q):
        q.q.cancel_join_thread()
    for i, views in enumerate(frames):
        frame_q.put((float(i), views))
    stop = SPAWN.Value("i", 0)
    pipeline.inference_process(svc, frame_q, result_q, stop)
    assert stop.value == 1
    assert not torch.distributed.is_initialized()
    results = [result_q.get(timeout=10) for _ in frames]
    for i, (res, ref) in enumerate(zip(results, _direct(cfg, ckpt,
                                                        frames))):
        assert res["timestamp"] == float(i) and res["latency_ms"] > 0
        assert (ref[:, 0, 3] >= 0).all()
        np.testing.assert_array_equal(res["poses"], ref)


def test_two_hosts_rehearsal(served):
    """Two hosts of one rank each (two spawned inference processes, one
    coordinator, --num_hosts 2), each queued the same frames: each host's
    ranks take their view from its own frames, so the job sees whole
    frames; both hosts emit every frame, equal to each other, and within
    the world-4 tolerance of tests/test_torch_parallel.py of a direct
    Predictor call."""
    cfg, ckpt, frames = served
    kw = dict(cfg_obj=cfg, num_views=cfg.num_views, checkpoint=ckpt,
              view_mode="none", device="cpu")
    res = run_ranks(service_host, 2, (kw, frames))
    ref = _direct(cfg, ckpt, frames)
    for h in (0, 1):
        assert [r["timestamp"] for r in res[h]] == [0.0, 1.0, 2.0]
        for r, p in zip(res[h], ref):
            np.testing.assert_array_equal(r["poses"], res[0][
                int(r["timestamp"])]["poses"])
            np.testing.assert_allclose(r["poses"], p, rtol=1e-5, atol=1e-2)


def test_run_service_local_view_sharding(monkeypatch, tmp_path, capfd):
    """The whole topology, spawned, on 2 local CPU ranks
    (FVP_CPU_DEVICES=2) and a 2-view config: the inference process leads
    a second rank, each prepares its view, and the service stops itself
    after max_frames with no child dead and JPEGs saved."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("FVP_CPU_DEVICES", "2")
    cfg = tcfg.FVPConfig(**dataclasses.asdict(tiny_config(
        num_views=2, heatmap_size=(60, 32), voxels_per_axis=(16, 16, 8),
        ind_voxels_per_axis=(8, 8, 8), max_people=3)))
    out = tmp_path / "svc"
    died = pipeline.run_service(pipeline.ServiceConfig(
        num_views=2, max_frames=2, view_mode="save", output_dir=str(out),
        target_fps=10.0, cfg_obj=cfg, device="cpu"))
    assert died is None
    assert len(list(out.glob("pose_*.jpg"))) >= 1
    assert "sharding inference over 2 of 2 ranks" in capfd.readouterr().out


def _alive(pid: int) -> bool:
    """Whether `pid` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


@pytest.mark.skipif(not sys.platform.startswith("linux"),
                    reason="PR_SET_PDEATHSIG is Linux's")
def test_rank_ends_with_its_killed_leader():
    """A SIGKILL (or SIGTERM) to a sharded leader skips its joins of its
    ranks; each rank it spawned ends with it all the same."""
    q = SPAWN.Queue()
    leader = SPAWN.Process(target=leader_of_one_rank, args=(q,))
    leader.start()
    pid = None
    try:
        pid = q.get(timeout=120.0)
        assert _alive(pid)
        leader.kill()
        leader.join()
        deadline = time.monotonic() + 20.0
        while _alive(pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not _alive(pid)
    finally:
        if leader.is_alive():
            leader.kill()
        if pid is not None and _alive(pid):
            os.kill(pid, signal.SIGKILL)


def test_service_cli_coordinator():
    """run/service_torch.py takes --coordinator, --num_hosts and
    --host_id: one host's job of one rank serves and exits 0."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "run/service_torch.py"),
         "--cfg", os.path.join(ROOT, "configs/test/tiny_synthetic.yaml"),
         "--num_views", "2", "--max_frames", "2", "--view_mode",
         "callback", "--device", "cpu", "--coordinator",
         f"127.0.0.1:{free_port()}", "--num_hosts", "1", "--host_id", "0"],
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "rank 0 of 1 joined (gloo)" in proc.stdout
    assert "people, latency" in proc.stdout
