"""The port's streaming service (fvp_torch/service/, fvp_torch/utils/vis.py,
run/service_torch.py) on the CPU, held against the reference package's as
tests/test_service.py holds the reference: the host-side pieces bit for
bit on the same seeded inputs (view composition, the pose overlay, frame
preprocessing, the calibration rig, view sharding, the restream without
ffmpeg); the inference process in this process against a CPU Predictor
on the same prepared frames; and the whole topology once end to end."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import fvp_torch.config as tcfg
import fvp_torch.geometry.cameras as tcam
import fvp_tpu.service.pipeline as ref_pipe
import fvp_tpu.service.render as ref_render
import fvp_tpu.utils.vis as ref_vis
from fvp_torch.engine.checkpoint import load_backbone_state, load_model_state
from fvp_torch.engine.serve import Predictor
from fvp_torch.geometry.transforms import get_resize_transform
from fvp_torch.models.convert import to_jax_backbone_variables
from fvp_torch.models.resnet import PoseResNet, seeded_state_dict
from fvp_torch.service import pipeline, render
from fvp_torch.service.sources import SPAWN, FrameQueue, split_quad
from fvp_torch.utils import vis
from tests.helpers import random_rig, tiny_config
from tests.test_torch_nets import perturbed_variables, small_cfg

cv2 = pytest.importorskip("cv2")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread at these small shapes: parallel test workers
    then do not oversubscribe the cores (the previous count restored)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(cfg):
    return tcfg.FVPConfig(**dataclasses.asdict(cfg))


def _port_rig(rig):
    return tcam.CameraRig(rig.R, rig.T, rig.f, rig.c, rig.k, rig.p)


def _frames(rng, n, shape):
    return [rng.randint(0, 256, shape, dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("num_views", [3, 4, 5])
def test_compose_views_bit_equal(num_views):
    rng = np.random.RandomState(num_views)
    views = _frames(rng, num_views, (270, 480, 3))
    views[0] = views[0][..., 0]                    # a grayscale view
    for size in ((960, 512), (320, 160)):
        np.testing.assert_array_equal(
            render.compose_views(views, size),
            ref_render.compose_views(views, size))


def _poses(rng, cfg):
    """Two confident people near the space center, one below the gate and
    one non-detection."""
    poses = np.zeros((cfg.max_people, cfg.num_joints, 5), np.float32)
    poses[:, :, 3] = -1.0
    for n, conf in enumerate((0.9, 0.8, 0.1)):
        poses[n, :, :3] = np.asarray(cfg.space_center) + rng.randn(
            cfg.num_joints, 3) * 300
        poses[n, :, 3] = n
        poses[n, :, 4] = conf
    return poses


@pytest.mark.parametrize("num_views", [4, 5])
def test_render_result_on_image_bit_equal(num_views):
    rng = np.random.RandomState(10 + num_views)
    cfg = tiny_config(num_views=num_views, min_score=0.3)
    rig = random_rig(rng, num_views=num_views)
    views = _frames(rng, num_views, (270, 480, 3))
    poses = _poses(rng, cfg)
    t = get_resize_transform(cfg.ori_image_size, cfg.image_size)
    ref = ref_render.render_result_on_image(
        cfg, rig, t, ref_render.compose_views(views, cfg.image_size), poses,
        fps=29.5, latency_ms=12.25)
    before = render.compose_views(views, cfg.image_size)
    got = render.render_result_on_image(
        _port(cfg), _port_rig(rig), t, before.copy(), poses, fps=29.5,
        latency_ms=12.25)
    assert (got != before).any()
    np.testing.assert_array_equal(got, ref)


def test_draw_poses_on_image_bit_equal():
    rng = np.random.RandomState(2)
    cfg = tiny_config(num_views=3)
    rig = random_rig(rng, num_views=3)
    image = _frames(rng, 1, (512, 960, 3))[0]
    poses = _poses(rng, cfg)
    t = get_resize_transform(cfg.ori_image_size, cfg.image_size)
    for view in range(3):
        np.testing.assert_array_equal(
            vis.draw_poses_on_image(image, poses, _port_rig(rig), view, t),
            ref_vis.draw_poses_on_image(image, poses, rig, view, t))
    for j in (14, 15, 17):
        assert vis.limbs_for(j) == ref_vis.limbs_for(j)


@pytest.mark.parametrize("shape", [(512, 960, 3), (300, 400, 3), (256, 480)])
def test_frames_to_images_bit_equal(shape):
    """At the working size (no resize), resized and from a grayscale
    frame."""
    rng = np.random.RandomState(len(shape) + shape[0])
    cfg = tiny_config(num_views=3)
    views = _frames(rng, 4, shape)               # one more than num_views
    got = pipeline._frames_to_images(_port(cfg), views)
    assert got.shape == (1, 3, 512, 960, 3)
    np.testing.assert_array_equal(
        got, ref_pipe._frames_to_images(cfg, views))


@pytest.mark.parametrize("shape", [(480, 640, 3), (100, 120)])
def test_frames_to_heatmaps_bit_equal(shape):
    rng = np.random.RandomState(shape[0])
    cfg = tiny_config(num_views=2, heatmap_size=(60, 32))
    views = _frames(rng, 2, shape)
    np.testing.assert_array_equal(
        pipeline._frames_to_heatmaps(_port(cfg), views),
        ref_pipe._frames_to_heatmaps(cfg, views))


def _write_calibration(path, rig, num_views):
    calib = {}
    for c in range(num_views):
        cam = rig.camera(c)
        K = np.array([[cam["fx"], 0, cam["cx"]],
                      [0, cam["fy"], cam["cy"]], [0, 0, 1]])
        R = np.asarray(cam["R"])
        T = np.asarray(cam["T"]).reshape(3, 1)
        k = np.asarray(cam["k"]).ravel()
        p = np.asarray(cam["p"]).ravel()
        calib[f"cam{c}"] = {
            "k": [float(cam["fx"]), float(cam["fy"]),
                  float(cam["cx"]), float(cam["cy"])],
            "d": [float(k[0]), float(k[1]), float(p[0]), float(p[1]),
                  float(k[2])],
            "p": (K @ np.hstack([R, -R @ T])).ravel().tolist(),
        }
    path.write_text(json.dumps(calib))


@pytest.mark.parametrize("calibrated", [True, False])
def test_service_rig_bit_equal(tmp_path, calibrated):
    """From a calibration file, and the demo ring without one."""
    cfg = tiny_config(num_views=3)
    kw = {}
    if calibrated:
        _write_calibration(tmp_path / "calibration.json",
                           random_rig(np.random.RandomState(4), 3), 3)
        kw["calibration"] = str(tmp_path / "calibration.json")
    got = pipeline._service_rig(pipeline.ServiceConfig(num_views=3, **kw),
                                _port(cfg))
    ref = ref_pipe._service_rig(ref_pipe.ServiceConfig(num_views=3, **kw),
                                cfg)
    for name in ("R", "T", "f", "c", "k", "p"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(ref, name)))


def test_service_rig_checks_the_camera_count(tmp_path):
    _write_calibration(tmp_path / "c.json",
                       random_rig(np.random.RandomState(4), 2), 2)
    svc = pipeline.ServiceConfig(num_views=3,
                                 calibration=str(tmp_path / "c.json"))
    with pytest.raises(ValueError, match="calibration has 2 cameras"):
        pipeline._service_rig(svc, _port(tiny_config(num_views=3)))


def test_pick_view_shards_and_split_quad_equal():
    for n in range(1, 9):
        for v in range(1, 9):
            assert pipeline.pick_view_shards(n, v) == \
                ref_pipe.pick_view_shards(n, v)
    from fvp_tpu.service.sources import split_quad as ref_split
    frame = _frames(np.random.RandomState(0), 1, (7, 9, 3))[0]
    for got, ref in zip(split_quad(frame), ref_split(frame)):
        np.testing.assert_array_equal(got, ref)


def test_load_cfg_service_views_win(tmp_path):
    path = os.path.join(ROOT, "configs/test/tiny_synthetic.yaml")
    for views in (3, 5):
        got = pipeline._load_cfg(pipeline.ServiceConfig(cfg_path=path,
                                                        num_views=views))
        ref = ref_pipe._load_cfg(ref_pipe.ServiceConfig(cfg_path=path,
                                                        num_views=views))
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_restream_degrades_without_ffmpeg(monkeypatch, tmp_path, capsys):
    """Without ffmpeg both restreams warn alike and do nothing."""
    monkeypatch.setenv("PATH", str(tmp_path))   # hide any ffmpeg
    out = []
    for cls in (render.FFmpegRestream, ref_render.FFmpegRestream):
        w = cls("rtsp://localhost/x", (64, 64), fps=5.0)
        assert w.dead
        w.write(np.zeros((64, 64, 3), np.uint8))    # must not raise
        w.close()
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] == "ffmpeg not found; RTSP restream disabled\n"


@pytest.fixture(scope="module")
def served():
    """A small config at a working size of 256 x 128 (heatmaps 64 x 32),
    with a gate below every confidence so that all K people come out;
    the reference's perturbed model and a seeded ResNet-18, both written
    in the reference's msgpack layout."""
    cfg = _port(small_cfg(image_size=(256, 128), heatmap_size=(64, 32),
                          min_score=-1.0, resnet_layers=18))
    return cfg, perturbed_variables(cfg, 7), \
        seeded_state_dict(PoseResNet(cfg.num_joints, 18), seed=5)


@pytest.mark.parametrize("source", ["heatmaps", "images"])
def test_inference_process_matches_predictor(tmp_path, served, source):
    """The inference process, run in this process on 3 queued frames (one
    at the working size, two resized), loads the model from a
    model_best.msgpack (and the backbone from a msgpack for the image
    source) and emits per frame the poses a CPU Predictor gives on the
    same prepared frames, bit for bit, with its latency and fps."""
    from fvp_torch.engine import flax_msgpack

    cfg, variables, bb_state = served
    ckpt = tmp_path / "model_best.msgpack"
    ckpt.write_bytes(flax_msgpack.dumps(variables))
    if source == "images":
        bb = tmp_path / "backbone.msgpack"
        bb.write_bytes(flax_msgpack.dumps(to_jax_backbone_variables(
            bb_state)))
        cfg = cfg.replace(pretrained_backbone=str(bb))
    svc = pipeline.ServiceConfig(cfg_obj=cfg, num_views=cfg.num_views,
                                 checkpoint=str(ckpt), max_frames=3,
                                 device="cpu", view_mode="none")
    rng = np.random.RandomState(8)
    frames = [_frames(rng, cfg.num_views, shape)
              for shape in ((128, 256, 3), (96, 200, 3), (256, 480, 3))]
    frame_q, result_q = FrameQueue(maxsize=3), FrameQueue(maxsize=3)
    for q in (frame_q, result_q):
        # a failure that leaves frames queued must not hang the exit
        q.q.cancel_join_thread()
    for i, views in enumerate(frames):
        frame_q.put((float(i), views))
    stop = SPAWN.Value("i", 0)
    pipeline.inference_process(svc, frame_q, result_q, stop)
    assert stop.value == 1
    results = [result_q.get(timeout=10) for _ in frames]

    pred = Predictor.from_state_dict(
        cfg, load_model_state(str(ckpt)), pipeline._service_rig(svc, cfg),
        device="cpu", backbone_state_dict=load_backbone_state(str(bb))
        if source == "images" else None)
    prepare = pipeline._frames_to_images if source == "images" \
        else pipeline._frames_to_heatmaps
    for i, (res, views) in enumerate(zip(results, frames)):
        assert res["timestamp"] == float(i) and "views" not in res
        assert res["latency_ms"] > 0 and res["fps"] > 0
        ref = pred(prepare(cfg, views))["fused_poses"][0].numpy()
        assert (ref[:, 0, 3] >= 0).all()
        np.testing.assert_array_equal(res["poses"], ref)


def test_run_service_end_to_end(monkeypatch, tmp_path):
    """The whole topology on the CPU, spawned: synthetic source ->
    inference (seeded weights, heatmap stand-ins) -> overlay -> JPEG save,
    stopping itself after max_frames with no child dead. The spawned
    inference child takes one intra-op thread from the environment."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = _port(tiny_config(num_views=2, heatmap_size=(60, 32),
                            voxels_per_axis=(16, 16, 8),
                            ind_voxels_per_axis=(8, 8, 8), max_people=3))
    out = tmp_path / "svc"
    died = pipeline.run_service(pipeline.ServiceConfig(
        num_views=2, max_frames=2, view_mode="save", output_dir=str(out),
        target_fps=10.0, cfg_obj=cfg, device="cpu"))
    assert died is None
    assert len(list(out.glob("pose_*.jpg"))) >= 1


def test_run_service_multi_host_not_ported():
    with pytest.raises(NotImplementedError, match="multi-host"):
        pipeline.run_service(pipeline.ServiceConfig(
            coordinator="127.0.0.1:8477", device="cpu"))


def test_service_cli_without_a_card_exits_1(tmp_path):
    """Without --device the inference child raises (no card); the
    watchdog stops the service and the CLI exits 1."""
    import subprocess
    import sys

    assert not torch.cuda.is_available()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "run/service_torch.py"),
         "--cfg", os.path.join(ROOT, "configs/test/tiny_synthetic.yaml"),
         "--num_views", "3", "--max_frames", "2", "--view_mode", "none",
         "--output_dir", str(tmp_path)],
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "no CUDA device" in proc.stderr
    assert "service: inference process died; stopping" in proc.stdout
