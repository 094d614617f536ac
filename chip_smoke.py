#!/usr/bin/env python3
"""Smoke test of the PyTorch port (fvp_torch) on one NVIDIA GPU.

Runs from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA card, `nvcc` (CUDA toolkit) and `nvidia-smi`, and exits non-zero
without a card or outside the repo. Phases, in order; any failure exits
non-zero:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels from fvp_torch/csrc (one nvcc per source, in
   parallel) and prints the build time and the compiler's register report;
3. for each kernel K1..K5, at the flagship shapes (5 views of 15 joints at
   240x128, an 80x80x20 space, 10 people in 64^3 cubes), holds the kernel
   against its plain PyTorch version on the card, and times kernel, plain
   version and, where one exists, a library call (CUDA events behind a
   ~1 ms spin of the card, so device time only; warm-up excluded, median;
   whole_sample also with its GB/s and host enqueue time; CenterNet with
   its launches per call, its 16 stages each launched alone and its host
   enqueue time, beside the cuDNN CenterNet module timed in the same run;
   person_planes with its layout and planes kernels timed apart, the
   planes kernel's gathered bytes and rate, and its time on frame 0's own
   proposals); then the same for the `fuse_p2p` kernels, P2PNet on K2's planes
   and C2CNet on frame 0's z-columns, for the backbone's stem (5 images of
   512x960) and its three deconv stages (each with its tiling plan and
   host enqueue time), and for the bottleneck stage on the seeded
   ResNet-50's own layer1 input, within one bf16 ulp (P2PNet and the stage
   launch by launch, each launch also timed alone and printed with its
   route, tiling plan, shape and bytes; C2CNet, one launch, as a whole);
   the stem's plan and GB/s, and the wrappers' host enqueue times;
   C2CNet's plan (CTAs, columns a CTA, ring depth, barriers) and one
   launch per call; weightnet_pool's plan, its GB/s of input and two calls
   bitwise equal; soft_argmax's plan (blocks a map, threads, rows), one
   launch per call, its GB/s and two calls bitwise equal;
4. drives the heatmap serving path, `Predictor` at full width with seeded
   random weights, on the card for 12 frames of Gaussian-blob heatmaps with
   every launch count set to 0 just before, checks that every kernel ran,
   and prints the device time by kernel over 3 frames (torch.profiler), and
   holds frame 0 against the same Predictor on the CPU (the plain path);
5. drives the image serving path, the same Predictor with a seeded
   ResNet-50 backbone, for 12 frames of seeded normalized 5x512x960 images
   with every launch count set to 0 just before, checks that all seven
   kernels ran, prints the frame latency, the profile and the frame's
   parts timed one by one, and holds the card against the CPU: (a) the
   backbone's heatmaps of view 0 against the plain backbone, (b) the
   HDN+JLN on the card's heatmaps of frame 0 against the CPU on the same
   heatmaps;
6. drives the `fuse_p2p` serving path, the heatmap Predictor with
   `fuse_p2p=True`, for 12 frames with every launch count set to 0 just
   before, checks that p2pnet and c2cnet ran with K1..K5 (P2PNet's convs
   on the routes conv_plan gives them: 21 conv_wgmma, 2 wmma), prints its
   latency and profile and holds frame 0 against the CPU;
7. drives the bf16 image serving path (`compute_dtype='bfloat16'`, the
   reference's serving configuration in bench.py, `fuse_p2p` off): the
   image Predictor in bf16 for 12 frames with every launch count set to 0
   just before, checks that the stem (1 a frame), the bottleneck stage on
   layer1 (10 conv_wgmma launches a frame), the deconv head (3 a frame)
   and K1..K5 ran and nothing else did, prints its latency, profile and
   parts (stem, layer1, layers 2-4, head, final_layer, HDN+JLN) beside the
   float32 frame's parts of phase 5, holds view 0's heatmaps against the
   CPU's bf16 backbone and frame 0's poses against the CPU's bf16 HDN+JLN
   on the card's heatmaps, and prints its poses' distance from the float32
   frame's as information;
8. drives the eval engine (`run_validation`) on the card: the held-out
   synthetic protocol of configs/test/synthetic_convergence_r5.yaml at
   full width (device render with augmentation, up to 5 people a scene),
   20 scenes at the config's test batch of 8 (8, 8 and 4 padded),
   with every launch count set to 0 just before; checks that K1..K5 ran
   once a batch and nothing else did, prints FPS, batch_ms and the
   metrics beside the card's name and power limit, holds the first
   batch's 8 frames run one by one against the batched run (identical
   masks, within 1e-3 mm), two of its frames against the CPU (identical
   masks, within 5e-2 mm), the device splat against the numpy renderer
   (within 1e-5), and prints a profile of a batch, and how far the batch's
   poses move when the model runs with TF32 on (outside the entry points'
   float32_math), beside the eval step under the same flags, which must
   not move;
9. drives the trainer (engine/train.py) on the card: the same protocol's
   training scenes at its train batch of 8 through seq_grouped_batches,
   the model from the port's 'flax' init, 2 warm-up and 10 timed steps
   with every launch count set to 0 just before; checks that each step
   launched whole_sample once and person_planes once (with its layout)
   and no other kernel, that the losses are finite, that the HDN moved on
   the accumulation window's k-th steps only and the JLN exactly when the
   joint loss was > 0; prints the median step, peak memory, the losses and
   a profile of a step by kind beside the card's name and power limit,
   holds K1 and K2 against their plain versions on the training batch,
   the first step against the CPU (losses, gradients, BatchNorm
   statistics), and takes 2 image-source steps at batch 2 through the
   frozen float32 ResNet-50 (stem, deconv head, K1, K2 a step);
10. drives the streaming service (fvp_torch/service/) at the reference's
    serving configuration: FVPConfig() at compute_dtype='bfloat16' with
    the seeded ResNet-50, the model and backbone read from torch files
    written for the phase. (a) `run_service` on the card as users run it
    (spawned synthetic source, inference and visualization processes;
    SERVICE_FRAMES frames; JPEGs saved): results arrived, the service
    stopped by itself, no child died, and the pipeline's own latency_ms
    and fps printed beside the card's name and power limit; (b) its
    inference process run in this process on FRAMES seeded 5-view frames
    at 512x960 with every launch count set to 0 just before: the stem
    (1 a frame), the bottleneck stage (10 conv_wgmma a frame), the
    deconv head (3 a frame) and K1..K5 ran and nothing else did, and
    frame 0's poses equal, bit for bit, a Predictor built here from the
    same files on the same prepared frame; (c) the same weights written
    in the reference's flax msgpack layout load to the same state dicts
    as the torch files;
11. prints one JSON line of the kernels, then the result line.

float32 outside the bf16 kernels and the bf16 path: TF32 is switched off
for cuDNN convs and matmuls, so that the card's plain path and the float32
trunk compute in full float32 (the port's entry points switch it off for
their own work whatever the global flags say).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK_FP32 = 67e12           # H100 SXM float32 outside the tensor cores
PEAK_BF16 = 989e12          # H100 SXM bf16 on the tensor cores, dense
FRAMES = 12
# ~1 ms of the card's clock: longer than most wrappers' host enqueue
SPIN_CYCLES = 2_000_000
# ~5 ms, for calls whose host enqueue nears 1 ms (person_planes' wrapper
# with its bounds)
LONG_SPIN = 10_000_000
WARMUP_FRAMES = 2
# The seeded random weights below give detection confidences whose scale
# has nothing to do with a trained model's (0.294 .. 0.315 on frame 0,
# with a gap from 0.302 to 0.310); this gate lets the three strongest
# proposals of frame 0 through. Asserted: at least two pass, none lies
# within 1e-4 of the gate.
MIN_SCORE = 0.306
# The image path's gate, for the seeded ResNet-50 and images below: their
# frame-0 detection confidences are 0.338 .. 0.362, with 0.3535 below and
# 0.3557 above this gate, which lets three through; the same two
# assertions hold on it.
MIN_SCORE_IMG = 0.3545
# The fuse_p2p path's gate, for the same weights and heatmaps: its bf16
# C2CNet moves the frame-0 confidences a little from the float32 module's
# (0.2951 .. 0.3174, 0.3043 below and 0.3100 above this gate), and the same
# three pass; the same two assertions hold on it.
MIN_SCORE_FUSE = 0.306
# The bf16 image path's gate, for the same weights and images: its bf16
# trunk and cuDNN nets move the frame-0 confidences from the float32
# path's (0.3396 .. 0.3634 on the CPU, nine of them within 2.1e-3 of the
# next); this gate sits in the widest gap, 0.3396 below and 0.3483 above,
# 4.3e-3 from each, and lets nine through; the same two assertions hold.
MIN_SCORE_BF16 = 0.344
# Whole bf16 nets against their plain versions: each launch is held at one
# bf16 ulp alone (P2PNet, the bottleneck stage), but a flip early in a net
# carries on through the layers after it, so the nets' outputs are held at
# a fraction of their scale, as tests/test_torch_fuse_p2p.py holds the
# plain versions against the reference (measured there: 2.7e-3 for P2PNet,
# 3.6e-3 for the stage, 0 for C2CNet).
NET_RTOL = 1e-2
# fuse_p2p path, card vs CPU, in mm: bf16 flips between the card's and the
# CPU's sums move the soft-argmax (beta 100) coordinates.
FUSE_POSE_TOL_MM = 1.0
# bf16 image path, card vs CPU: cuDNN's bf16 convs round at other points
# than the CPU's (C2CNet's scores up to ~2e-2 of their scale apart, as the
# check prints), and the soft-argmax at beta 100 on the seeded nets' broad
# maps (P2PNet's features of scale ~0.085) turns that into ~1 mm (0.91-1.00
# mm a person on frame 0); a z pick may flip where C2CNet's scores at two
# heights lie within bf16's reach of each other (one of ten on frame 0,
# 1.2e-2 of their scale apart).
BF16_POSE_TOL_MM = 3.0
BF16_TIE_RTOL = 2e-2
# The eval phase: the held-out synthetic protocol of this config at full
# width (5 views, 240x128 heatmaps rendered on the card with augmentation,
# an 80x80x20 space, K = 10 in 64^3 cubes), EVAL_SCENES scenes at the
# config's test batch of 8: batches of 8, 8 and 4 padded to 8.
EVAL_CFG = "configs/test/synthetic_convergence_r5.yaml"
EVAL_SCENES = 20
# Its gate is chosen at run time, in the widest gap between the first
# batch's 80 detection confidences on the card that leaves at least two of
# frames 0-1's people above it and one below (printed); asserted:
# at least two people of the CPU's two frames pass, and no confidence of
# the card's batch or the CPU's frames lies within 1e-4 of it.
# The first batch's 8 frames, each run alone on the card, against the
# batched run: the kernels must not mix frames or people (mm).
EVAL_BATCH_TOL_MM = 1e-3
# full batches of 8 timed after run_validation (it times two batches here)
EVAL_FULL_BATCHES = 20
# The eval batch's device time by kind: the port's kernels (K1-K5), cuDNN
# (the float32 C2CNet and P2PNet: convs, BN, layout transposes), copies and
# fills, and PyTorch's own kernels (the splat's passes, the model's
# elementwise ops and reductions).
EVAL_PROFILE_GROUPS = [
    ("K1-K5", ("whole_sample_kernel", "person_layout_kernel",
               "person_planes_kernel", "centernet_kernel",
               "soft_argmax_kernel", "weightnet_pool_kernel")),
    ("cuDNN", ("cudnn", "xmma", "implicit_gemm", "convolve", "gemm",
               "Nhwc", "Nchw")),
    ("copies", ("Memcpy", "Memset")),
    ("torch ops", ("at::native",)),
]
# The device splat against the numpy renderer (as tests/test_device_render
# holds the reference's).
RENDER_ATOL = 1e-5
# The training phase: EVAL_CFG's training protocol at full width, its
# train batch of 8 from TRAIN_SCENES synthetic scenes (the dataset's
# 1600 cut to what the steps need) through seq_grouped_batches with the
# device render and augmentation; TRAIN_WARMUP steps, then TRAIN_STEPS
# timed ones.
TRAIN_SCENES = 96
TRAIN_WARMUP = 2
TRAIN_STEPS = 10
# The first step, card against CPU, on the first batch, all 8 scenes at
# full width (a CPU step at batch 2 took 4.7 s, and its two scenes matched
# nobody, which left the JLN's gradients 0 on both sides): the four
# losses relative; each gradient within TRAIN_GRAD_RTOL of its
# tensor's largest entry plus TRAIN_GRAD_NET_RTOL of its net's largest
# gradient (a conv bias before a BatchNorm has a gradient of exactly 0 in
# exact arithmetic, float32 noise on both devices, and gradients that
# cancel round far from their own scale: tests/test_torch_train_lockstep.py
# measures up to 3.1e-3 of a tensor's scale for the port's float32 on the
# CPU against float64); each new BatchNorm statistic against its tensor's
# largest entry.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
TRAIN_GRAD_NET_RTOL = 3e-3
TRAIN_STATS_RTOL = 1e-4
# the train step's device time by kind
TRAIN_PROFILE_GROUPS = [
    ("K1", ("whole_sample_kernel",)),
    ("K2", ("person_layout_kernel", "person_planes_kernel")),
    ("Adam", ("multi_tensor_apply", "adam", "Adam")),
    ("cuDNN backward (dgrad, wgrad)", ("dgrad", "wgrad", "bprop")),
    ("cuDNN forward and GEMM/FFT convs", ("cudnn", "xmma", "implicit_gemm",
                                         "convolve", "gemm", "fft",
                                         "Nhwc", "Nchw", "cutlass",
                                         "sm90")),
    ("copies", ("Memcpy", "Memset")),
    ("torch ops", ("at::native",)),
]
# the image-source train steps (a smaller depth than the heatmap ones)
TRAIN_IMAGE_BATCH = 2
TRAIN_IMAGE_STEPS = 2
# The service phase: frames that run_service serves (its synthetic source
# gives 480x640 frames, resized to the working 960x512 on the host), and
# the results of either run taken as warm-up (cuDNN's first calls).
SERVICE_FRAMES = 20
SERVICE_WARMUP = 2
# ImageNet normalisation of the reference data pipeline (RGB, 0..1 scale)
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
# bf16 kernels against their plain versions: the two round the same float32
# value to bf16 unless their float32 sums, taken in another order, straddle
# a rounding boundary, so they differ by at most one bf16 ulp
# (<= 2**-7 of the value) plus the float32 summation-order difference,
# which over up to 8192 terms stays below 1e-4 of the output's scale.
BF16_RTOL = 2.0 ** -7
SUM_ATOL = 1e-4
# The image path, card vs CPU: the trunk's float32 convs sum in another
# order on each device, so a few bf16 roundings in the stem and head flip;
# a float64 against a float32 trunk on the CPU moves the heatmaps by
# 2.6e-3 of their scale this way, and this bound leaves a factor ~8.
HM_RTOL = 2e-2


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# seeded inputs and weights
# ---------------------------------------------------------------------------

def random_state_dict(model, seed: int) -> dict:
    """Weights for the port's FasterVoxelPose from a numpy seed. The task
    nets' convs are N(0, 0.03) (the reference init's std 0.001, x30, as the
    parity tests perturb it, so outputs are not bias-dominated), their
    output heads N(0, 0.9); WeightNet's layers are uniform(+-1/sqrt(fan
    in)) like torch's default; every 1-D tensor is its init value shifted
    by up to 0.05."""
    import torch

    rng = np.random.RandomState(seed)
    heads = ("pose_net.center_net.output_hm.2.weight",
             "pose_net.c2c_net.output_hm.weight")
    out = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            a = v.numpy()
        elif len(shape) >= 2 and "weight_net" in k:
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            a = rng.uniform(-bound, bound, shape)
        elif len(shape) >= 2:
            a = rng.normal(0.0, 0.9 if k in heads else 0.03, shape)
        else:                                    # BN gamma / var start at 1
            one = k.endswith("running_var") or k.endswith(".weight")
            a = float(one) + 0.05 * rng.rand(*shape)
        out[k] = torch.as_tensor(np.asarray(a, np.float32)
                                 if a.dtype != np.int64 else a)
    return out


def blob_heatmaps(cfg, rig, seed: int, people: int = 4) -> np.ndarray:
    """(1, V, J, H, W) heatmaps: Gaussian blobs (sigma = cfg.sigma heatmap
    px) at the projections of `people` random 15-joint skeletons-like point
    sets standing in the space, over a faint random background (so that no
    region of the volume is exactly constant)."""
    from fvp_torch.geometry.cameras import project_points_np
    from fvp_torch.geometry.grids import heatmap_transform
    from fvp_torch.geometry.transforms import affine_apply

    rng = np.random.RandomState(seed)
    V, J = cfg.num_views, cfg.num_joints
    w, h = cfg.heatmap_size
    roots = np.stack([rng.uniform(-2500, 2500, people),
                      rng.uniform(-3000, 2000, people),
                      np.full(people, 900.0)], axis=1)
    joints = roots[:, None, :] + np.stack([
        rng.uniform(-300, 300, (people, J)),
        rng.uniform(-300, 300, (people, J)),
        rng.uniform(-850, 850, (people, J))], axis=2)
    hm_t = heatmap_transform(cfg)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = 0.02 * rng.rand(1, V, J, h, w).astype(np.float32)
    for v in range(V):
        px = affine_apply(project_points_np(joints.reshape(-1, 3),
                                            rig.camera(v)), hm_t)
        px = px.reshape(people, J, 2)
        for p in range(people):
            for j in range(J):
                g = np.exp(-((xx - px[p, j, 0]) ** 2 + (yy - px[p, j, 1]) ** 2)
                           / (2 * cfg.sigma ** 2))
                out[0, v, j] = np.maximum(out[0, v, j], g)
    return out


def seeded_images(cfg, seed: int, frames: int = 1) -> np.ndarray:
    """(frames, V, H, W, 3) float32 normalized images: smooth random colour
    fields (bilinear upsampling of a 1/16-resolution random image) plus
    pixel noise, in 0..1, normalized with the ImageNet mean and std."""
    import torch

    rng = np.random.RandomState(seed)
    w, h = cfg.image_size
    n = frames * cfg.num_views
    low = torch.from_numpy(rng.rand(n, 3, h // 16, w // 16)
                           .astype(np.float32))
    img = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear",
                                          align_corners=False).numpy()
    img = img + 0.05 * rng.randn(*img.shape).astype(np.float32)
    img = np.clip(img, 0.0, 1.0).transpose(0, 2, 3, 1)
    img = np.ascontiguousarray((img - MEAN) / STD, dtype=np.float32)
    return img.reshape(frames, cfg.num_views, h, w, 3)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def bf16_close(got, ref) -> tuple[float, float]:
    """(max abs error, worst error in bf16 ulps) of a bf16 kernel output
    against its plain version: the ulps are (|err| - SUM_ATOL * scale) /
    (BF16_RTOL * max(|got|, |ref|)), so the two agree iff they are <= 1."""
    import torch

    g, r = got.float(), ref.float()
    err = (g - r).abs()
    mag = torch.maximum(g.abs(), r.abs())
    atol = SUM_ATOL * float(r.abs().max())
    ulps = (err - atol).clamp(min=0) / (BF16_RTOL * mag).clamp(min=1e-30)
    return float(err.max()), float(ulps.max())


def time_ms(fn, reps: int = 20, warmup: int = 3,
            with_enqueue: bool = False, spin: int = SPIN_CYCLES) -> float:
    """Median of per-call CUDA-event times, warm-up excluded. Before each
    call the card spins for `spin` cycles (torch.cuda._sleep), so that the
    call is enqueued behind the spin and the events time the device's work
    alone (a call whose host enqueue takes longer than the spin needs a
    longer one). With `with_enqueue` (the method of the port's earlier
    records) the card is idle when the first event is recorded, and the
    host's time to enqueue the call counts as well."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if not with_enqueue:
            torch.cuda._sleep(spin)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps: int = 20) -> float:
    """Median host time to enqueue one call of fn: the Python wrappers and
    the launches, not the device work (synchronised outside the timed
    region)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak: float = PEAK_FP32
          ) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def conv_flops(packed_cn, H: int, W: int) -> float:
    """float32 operations of CenterNet's layers at an H x W BEV (2 per
    multiply-add, 2 per output for the affine)."""
    f = 0.0

    def conv(layer, h, w):
        k, _, cin, cout = layer["w"].shape
        return h * w * cout * (2.0 * k * k * cin + 2)

    def res(r, h, w):
        s = conv(r["c0"], h, w) + conv(r["c1"], h, w)
        return s + (conv(r["proj"], h, w) if r["proj"] is not None else 0)

    e = packed_cn["enc"]
    f += conv(packed_cn["front"], H, W) + res(packed_cn["res0"], H, W)
    f += res(e["skip_res1"], H, W) + res(e["encoder_res1"], H // 2, W // 2)
    f += res(e["skip_res2"], H // 2, W // 2)
    for name in ("encoder_res2", "mid_res", "decoder_res2"):
        f += res(e[name], H // 4, W // 4)
    f += res(e["decoder_res1"], H // 2, W // 2)
    for name, h in (("decoder_upsample2", H // 2), ("decoder_upsample1", H)):
        cin, cout = e[name]["w"].shape[2:]
        f += h * (h * W // H) * cout * (2.0 * cin + 3)
    for name in ("hm0", "hm1", "size0", "size1"):
        f += conv(packed_cn[name], H, W)
    return f


# ---------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import fvp_torch.ops.kernels as K
    from fvp_torch.config import FVPConfig
    from fvp_torch.engine.packing import pack_backbone
    from fvp_torch.engine.serve import Predictor
    from fvp_torch.geometry.cameras import default_ring_rig
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose
    from fvp_torch.models.resnet import PoseResNet, seeded_state_dict
    from fvp_torch.ops.kernels import _build
    from fvp_torch.ops.kernels import sampler as ksamp
    from fvp_torch.ops.kernels import softargmax as ksa
    from fvp_torch.ops.kernels import weightnet as kwn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("chip_smoke: TF32 off for cuDNN convs and matmuls (float32 "
        "comparisons)")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    dev = torch.device("cuda")

    # 2. build
    t0 = time.time()
    lib = _build.build()
    K.load()
    log(f"build: {time.time() - t0:.1f} s -> {lib}")
    for line in (lib.parent / "ptxas.log").read_text().splitlines():
        if "Used" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())

    # the flagship configuration and the serving predictor
    cfg = FVPConfig(backbone="", min_score=MIN_SCORE)
    rig = default_ring_rig(cfg.num_views, cfg.space_center,
                           cfg.ori_image_size)
    state = random_state_dict(FasterVoxelPose(cfg), seed=0)
    pred = Predictor.from_state_dict(cfg, state, rig, device=dev)
    frames = [blob_heatmaps(cfg, rig, seed=s) for s in range(3)]
    # the image predictor: the same HDN+JLN behind a seeded ResNet-50
    cfg_img = FVPConfig(min_score=MIN_SCORE_IMG)
    bb_state = seeded_state_dict(
        PoseResNet(cfg_img.num_joints, cfg_img.resnet_layers), seed=0)
    pred_img = Predictor.from_state_dict(cfg_img, state, rig, device=dev,
                                         backbone_state_dict=bb_state)
    images = seeded_images(cfg_img, seed=0, frames=3)
    # the fuse_p2p predictor: the same weights, C2CNet and P2PNet as kernels
    cfg_fuse = FVPConfig(backbone="", fuse_p2p=True, min_score=MIN_SCORE_FUSE)
    pred_fuse = Predictor.from_state_dict(cfg_fuse, state, rig, device=dev)
    # the bf16 image predictor (bench.py's configuration): the same weights
    cfg_bf16 = FVPConfig(min_score=MIN_SCORE_BF16, compute_dtype="bfloat16")
    pred_bf16 = Predictor.from_state_dict(cfg_bf16, state, rig, device=dev,
                                          backbone_state_dict=bb_state)
    hm = torch.as_tensor(frames[0], device=dev)
    rc, packed, model = pred.rc, pred.packed, pred.model
    V, J = cfg.num_views, cfg.num_joints
    n = cfg.ind_voxels_per_axis[0]
    rows = {}

    with torch.inference_mode():
        # K1 whole_sample
        vol_k = ksamp.whole_sample(hm, rc, cfg)
        vol_p = ksamp.whole_sample_plain(hm, rc, cfg)
        torch.cuda.synchronize()
        err = float((vol_k - vol_p).abs().max())
        N = vol_k.shape[1] * vol_k.shape[2] * vol_k.shape[3]
        wm1, hm1 = cfg.heatmap_size[0] - 1.0, cfg.heatmap_size[1] - 1.0
        grid = torch.stack([rc.whole_sample_px[:, 0] / wm1 * 2 - 1,
                            rc.whole_sample_px[:, 1] / hm1 * 2 - 1],
                           dim=-1)[:, None]                 # (V, 1, N, 2)
        hm_v = hm[0].contiguous()
        report(rows, "whole_sample", "fvp_torch/csrc/whole_sample.cu",
               "fvp_tpu/ops/pallas/sampler.py:483", err, 1e-5,
               time_ms(lambda: ksamp.whole_sample(hm, rc, cfg)),
               time_ms(lambda: ksamp.whole_sample_plain(hm, rc, cfg), 5),
               time_ms(lambda: torch.nn.functional.grid_sample(
                   hm_v, grid, mode="bilinear", padding_mode="zeros",
                   align_corners=True)),
               bound(nbytes(hm, rc.whole_sample_px, vol_k),
                     N * J * V * 8.0 + N * J * 2.0))
        ws = rows["whole_sample"]
        ws["gb_per_s"] = nbytes(hm, rc.whole_sample_px, vol_k) / ws["ms"] / 1e6
        ws["host_enqueue_ms"] = host_ms(
            lambda: ksamp.whole_sample(hm, rc, cfg))
        ws["ms_with_enqueue"] = time_ms(
            lambda: ksamp.whole_sample(hm, rc, cfg), with_enqueue=True)
        log(f"whole_sample: {ws['gb_per_s']:.1f} GB/s of its "
            f"{nbytes(hm, rc.whole_sample_px, vol_k) / 1e6:.1f} MB; host time "
            f"to enqueue one call {ws['host_enqueue_ms']:.4f} ms; timed with "
            f"the enqueue {ws['ms_with_enqueue']:.4f} ms")

        # K3 centernet: one persistent launch walking the plan's stages
        centernet_kernel(packed["center_net"], vol_p, model, rows)

        # K2 person_planes: 10 people, all alive, full cubes
        planes_k = person_planes_kernel(pred, hm, rows)

        # K4 soft_argmax on P2PNet's output of those planes
        feats = model.joint_net.conv_net(planes_k.reshape(3 * 10, n, n, J))
        fl = feats.reshape(3, 10, n * n, J).contiguous()
        c_k, p_k = ksa.soft_argmax(fl, rc.center_grid, cfg.beta)
        c_p, p_p = ksa.soft_argmax_plain(fl, rc.center_grid, cfg.beta)
        torch.cuda.synchronize()
        err = float(max((c_k - c_p).abs().max(), (p_k - p_p).abs().max()))
        report(rows, "soft_argmax", "fvp_torch/csrc/softargmax.cu",
               "fvp_tpu/ops/pallas/softargmax.py:49", err, 1e-2,
               time_ms(lambda: ksa.soft_argmax(fl, rc.center_grid,
                                               cfg.beta)),
               time_ms(lambda: ksa.soft_argmax_plain(fl, rc.center_grid,
                                                     cfg.beta)),
               None,
               bound(nbytes(fl, rc.center_grid, c_k, p_k),
                     fl.numel() * 8.0))
        softargmax_plan_line(fl, rc.center_grid, cfg.beta, c_k, p_k, rows)

        # K5 weightnet_pool on the same features
        feats = feats.contiguous()
        w_k = kwn.weightnet_pool(feats, packed["weight_net"])
        w_p = kwn.weightnet_pool_plain(feats, packed["weight_net"])
        torch.cuda.synchronize()
        err = float((w_k - w_p).abs().max())
        Nn, A, Bb, _ = feats.shape
        C = w_k.shape[-1]
        wconv = packed["weight_net"]["w"].t().reshape(C, 1, 3, 3).contiguous()
        x1 = feats.permute(0, 3, 1, 2).reshape(Nn * J, 1, A, Bb).contiguous()
        report(rows, "weightnet_pool", "fvp_torch/csrc/weightnet.cu",
               "fvp_tpu/ops/pallas/weightnet.py:84", err,
               1e-4 * max(float(w_p.abs().max()), 1.0),
               time_ms(lambda: kwn.weightnet_pool(feats,
                                                  packed["weight_net"])),
               time_ms(lambda: kwn.weightnet_pool_plain(
                   feats, packed["weight_net"])),
               time_ms(lambda: torch.nn.functional.conv2d(x1, wconv,
                                                          padding=1)),
               bound(nbytes(feats, w_k, *_leaves(packed["weight_net"])),
                     Nn * J * A * Bb * C * (9 * 2.0 + 2) + Nn * J * C * 2))
        weightnet_plan_line(feats, packed["weight_net"], w_k, rows)

        # the fuse_p2p kernels: P2PNet on K2's planes, C2CNet on frame 0's
        # z-columns
        fuse_kernels(pred_fuse, hm, planes_k.reshape(3 * 10, n, n, J), rows)

        # the backbone's kernels on its own activations of image frame 0
        backbone_kernels(pred_img, images[0], rows)
        stage_kernel(pred_img, images[0], rows)

    # 4. the heatmap serving path: counts to 0, frames, counts read back
    outs, lat, launches = drive(pred, frames, K)
    log(f"serving path: {FRAMES} frames, launches {launches}")
    expect_launches(launches, HEATMAP_PATH, "heatmap path")
    steady = lat[WARMUP_FRAMES:]
    log_latency("frame latency", lat)
    profile_frames(pred, frames)

    # frame 0 against the plain path on the CPU
    cpu = Predictor.from_state_dict(cfg, state, rig, device="cpu")
    check_poses(outs[0], cpu, hm, "")

    # 5. the image serving path: counts to 0, frames, counts read back
    img_frames = [im[None] for im in images]
    outs, lat, img_launches = drive(pred_img, img_frames, K)
    log(f"image path: {FRAMES} frames, launches {img_launches}")
    expect_launches(img_launches, IMAGE_PATH, "image path")
    img_steady = lat[WARMUP_FRAMES:]
    log_latency("image frame latency", lat)
    profile_frames(pred_img, img_frames)
    img_parts = image_breakdown(pred_img, img_frames[0])

    # (a) the backbone's heatmaps, view 0, against the plain backbone
    hm_img = pred_img.heatmaps(img_frames[0])             # (1, V, J, h, w)
    bb_cpu = PoseResNet(cfg_img.num_joints, cfg_img.resnet_layers)
    bb_cpu.load_state_dict(bb_state)
    bb_cpu.eval()
    with torch.inference_mode():
        ref = bb_cpu(torch.from_numpy(images[0][:1]),
                     pack_backbone(bb_cpu))[0].permute(2, 0, 1)
    check_heatmaps(hm_img[0, 0].cpu(), ref, "")
    # (b) the HDN+JLN on those heatmaps: the card's frame 0 against the CPU
    cpu_img = Predictor.from_state_dict(cfg_img, state, rig, device="cpu")
    check_poses(outs[0], cpu_img, hm_img, "image path ")
    img_outs = outs

    # 6. the fuse_p2p serving path: counts to 0, frames, counts read back
    outs, lat, fuse_launches = drive(pred_fuse, frames, K)
    log(f"fuse_p2p path: {FRAMES} frames, launches {fuse_launches}")
    expect_launches(fuse_launches, FUSE_PATH, "fuse_p2p path")
    expect_conv_routes(K, "p2pnet.conv", fuse_launches["p2pnet"] // 25,
                       P2PNET_ROUTES)
    fuse_steady = lat[WARMUP_FRAMES:]
    log_latency("fuse_p2p frame latency", lat)
    profile_frames(pred_fuse, frames)
    cpu_fuse = Predictor.from_state_dict(cfg_fuse, state, rig, device="cpu")
    check_poses(outs[0], cpu_fuse, hm, "fuse_p2p path ", FUSE_POSE_TOL_MM)

    # 7. the bf16 image serving path (the reference's serving
    # configuration): counts to 0, frames, counts read back
    outs, lat, bf16_launches = drive(pred_bf16, img_frames, K)
    log(f"bf16 image path: {FRAMES} frames, launches {bf16_launches}")
    expect_launches(bf16_launches, BF16_IMAGE_PATH, "bf16 image path")
    expect_per_frame(bf16_launches, {"stem": 1, "deconv_stage": 3},
                     "bf16 image path")
    expect_conv_routes(K, "bottleneck_stage", FRAMES, STAGE_ROUTES)
    bf16_steady = lat[WARMUP_FRAMES:]
    log_latency("bf16 image frame latency", lat)
    profile_frames(pred_bf16, img_frames)
    bf16_parts = image_breakdown(pred_bf16, img_frames[0])
    log("image frame by part, bfloat16 beside float32 (this run):")
    for name in bf16_parts:
        log(f"  {bf16_parts[name]:8.3f} ms  {img_parts[name]:8.3f} ms  "
            f"{name}")
    log(f"  {sum(bf16_parts.values()):8.3f} ms  "
        f"{sum(img_parts.values()):8.3f} ms  sum")
    # (a) the bf16 backbone's heatmaps, view 0, against the CPU's bf16
    hm_bf16 = pred_bf16.heatmaps(img_frames[0])
    bb_cpu16 = PoseResNet(cfg_img.num_joints, cfg_img.resnet_layers)
    bb_cpu16.load_state_dict(bb_state)
    bb_cpu16.eval()
    with torch.inference_mode():
        ref = bb_cpu16(torch.from_numpy(images[0][:1]),
                       pack_backbone(bb_cpu16, "bfloat16"))[0]
    check_heatmaps(hm_bf16[0, 0].cpu(), ref.permute(2, 0, 1), "bf16 ")
    # (b) the bf16 HDN+JLN on the card's heatmaps against the CPU's
    cpu_bf16 = Predictor.from_state_dict(cfg_bf16, state, rig, device="cpu")
    check_poses_bf16(outs[0], pred_bf16, cpu_bf16, hm_bf16)
    pose_distance(outs[0], img_outs[0])

    # 8. the eval engine: run_validation at the reference's eval batch
    eval_launches, eval_res = eval_phase(K, state, smi, rows)

    # 9. training: the trainer's steps at the train batch of 8
    train_launches, train_res = train_phase(K, smi)

    # 10. the streaming service at the reference's serving configuration
    service_launches, service_res = service_phase(K, state, bb_state, rig,
                                                  smi)

    kernels = []
    paths = {"heatmap_path": launches, "image_path": img_launches,
             "fuse_p2p_path": fuse_launches,
             "bf16_image_path": bf16_launches, "eval_path": eval_launches,
             "train_path": train_launches, "service_path": service_launches}
    for name in ("stem", "deconv_stage", "whole_sample", "person_planes",
                 "centernet", "soft_argmax", "weightnet_pool", "p2pnet",
                 "c2cnet", "bottleneck_stage"):
        row = dict(rows[name])
        main = ("image_path" if name in IMAGE_PATH else "fuse_p2p_path"
                if name in FUSE_PATH else "bf16_image_path")
        row["launches"] = paths[main][name]
        row["launches_from"] = main
        for path, counts in paths.items():
            row[f"launches_{path}"] = counts[name]
        row["train_step_ms"] = train_res["step_ms_median"]
        kernels.append(row)
    log(json.dumps({"kernels": kernels,
                    "frame_ms_median": statistics.median(steady),
                    "image_frame_ms_median": statistics.median(img_steady),
                    "fuse_p2p_frame_ms_median": statistics.median(
                        fuse_steady),
                    "bf16_image_frame_ms_median": statistics.median(
                        bf16_steady),
                    "eval_fps": eval_res["fps"],
                    "eval_batch_ms": eval_res["batch_ms"],
                    "eval_full_batch_ms": eval_res["full_batch_ms"],
                    "eval_parts_ms": eval_res["parts_ms"],
                    "train_step_ms": train_res["step_ms"],
                    "train_step_ms_median": train_res["step_ms_median"],
                    "train_peak_memory_gb": train_res["peak_gb"],
                    "train_losses": train_res["losses"],
                    "train_image_step_ms": train_res["image_step_ms"],
                    "tf32_pose_shift_mm": eval_res["tf32_shift_mm"],
                    "service_latency_ms": service_res["latency_ms"],
                    "service_fps": service_res["fps"],
                    "service_inprocess_latency_ms":
                        service_res["inprocess_latency_ms"],
                    "service_parts_ms": service_res["parts_ms"],
                    "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def softargmax_plan_line(fl, grid, beta, coords, confs, rows) -> None:
    """soft_argmax's plan, its launches per call (1), its rate of input
    read and a second call bit for bit equal to the first (the
    fixed-order combine)."""
    import torch
    from fvp_torch.ops.kernels import softargmax as ksa

    plan = ksa.softargmax_plan(*fl.shape)
    before = ksa.SOFT_ARGMAX.launches
    again = ksa.soft_argmax(fl, grid, beta)
    torch.cuda.synchronize()
    calls = ksa.SOFT_ARGMAX.launches - before
    if calls != 1:
        raise AssertionError(f"soft_argmax: {calls} launches in one call")
    if not (torch.equal(again[0], coords) and torch.equal(again[1], confs)):
        raise AssertionError("soft_argmax: two calls differ")
    row = rows["soft_argmax"]
    row["launches_per_call"] = calls
    row["gb_per_s"] = nbytes(fl) / row["ms"] / 1e6
    row["plan"] = {k: v for k, v in plan._asdict().items()
                   if k in ("threads", "rows", "chunk", "ctas_per_map",
                            "ctas")}
    log(f"soft_argmax plan: {plan.ctas_per_map} blocks a map of "
        f"{plan.threads} threads ({plan.rows} rows a thread, {plan.chunk} "
        f"rows a block), {plan.ctas} blocks, {calls} launch per call; "
        f"{row['gb_per_s']:.1f} GB/s of its {nbytes(fl) / 1e6:.1f} MB "
        "input; two calls bitwise equal")


def weightnet_plan_line(feats, pw, first, rows) -> None:
    """weightnet_pool's plan, its rate of input read, and a second call
    bit for bit equal to the first (the mean's fixed order)."""
    import torch
    from fvp_torch.ops.kernels import weightnet as kwn

    plan = kwn.weightnet_plan(*feats.shape)
    again = kwn.weightnet_pool(feats, pw)
    torch.cuda.synchronize()
    if not torch.equal(again, first):
        raise AssertionError("weightnet_pool: two calls differ")
    row = rows["weightnet_pool"]
    row["gb_per_s"] = nbytes(feats) / row["ms"] / 1e6
    row["plan"] = {k: v for k, v in plan._asdict().items()
                   if k in ("rows", "bands", "joints", "reps", "threads",
                            "smem")}
    log(f"weightnet_pool plan: bands of {plan.rows} rows ({plan.bands} per "
        f"map), {plan.joints} joints a block, {plan.blocks} blocks of "
        f"{plan.threads} threads, {plan.smem} B shared; "
        f"{row['gb_per_s']:.1f} GB/s of its {nbytes(feats) / 1e6:.1f} MB "
        f"input; two calls bitwise equal")


def report(rows, name, source, replaces, err, tol, ms, plain_ms, lib_ms,
           bnd) -> None:
    """Log and check one float32 kernel's comparison; its row."""
    log(f"{name}: max_abs_err={err:.3e} tol={tol:.1e} kernel_ms={ms:.4f}"
        f" plain_ms={plain_ms:.4f} library_ms={lib_ms} bound_ms="
        f"{bnd[0]:.4f} ({bnd[1]})")
    held(name, err, tol)
    rows[name] = {"name": name, "route": "cuda", "source": source,
                  "replaces": replaces, "max_abs_err": err, "tol": tol,
                  "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                  "bound_by": bnd[1], "library_ms": lib_ms}


def held(name, err, tol, where="") -> None:
    """Fail unless a kernel's output is within tol of its plain version's."""
    if not err <= tol:
        raise AssertionError(f"{name}{where}: kernel disagrees with its "
                             f"plain version: {err} > {tol}")


def centernet_kernel(pc, vol, model, rows) -> None:
    """Phase 3 for K3 on the BEV map of frame 0's volume: the kernel against
    its plain version within 1e-4 of the output scale; its launches per
    call (the counter) and stages; each stage launched alone on the arena
    of a full run (device time); the host's enqueue time; and the cuDNN
    CenterNet module (float32, TF32 off) on the same volume as the
    library yardstick, timed in the same run."""
    import torch
    from fvp_torch.ops.kernels import centernet as kcn

    bev = vol.amax(dim=3).contiguous()
    plan = kcn.centernet_plan(*bev.shape)
    before = kcn.CENTERNET.launches
    hm_k, size_k = kcn.centernet_forward(pc, bev)
    per_call = kcn.CENTERNET.launches - before
    hm_p, size_p = kcn.centernet_plain(pc, bev)
    torch.cuda.synchronize()
    scale = float(max(hm_p.abs().max(), size_p.abs().max()))
    err = float(max((hm_k - hm_p).abs().max(), (size_k - size_p).abs().max()))
    report(rows, "centernet", "fvp_torch/csrc/centernet.cu",
           "fvp_tpu/ops/pallas/hourglass.py:386", err,
           1e-4 * max(scale, 1.0),
           time_ms(lambda: kcn.centernet_forward(pc, bev)),
           time_ms(lambda: kcn.centernet_plain(pc, bev)),
           time_ms(lambda: model.pose_net.center_net(vol)),
           bound(nbytes(bev, hm_k, size_k, pc["flat"]),
                 conv_flops(pc, bev.shape[1], bev.shape[2])))
    row = rows["centernet"]
    arena = torch.empty(plan.arena_floats, device=bev.device)
    kcn.launch(pc, bev, arena)
    stage_ms = [time_ms(lambda s=s: kcn.launch(pc, bev, arena, s, s + 1))
                for s in range(len(plan.stages))]
    row.update(launches_per_call=per_call, stages=len(plan.stages),
               stage_ms=stage_ms, smem_bytes=plan.smem_bytes,
               host_enqueue_ms=host_ms(lambda: kcn.centernet_forward(pc,
                                                                     bev)))
    log(f"centernet {tuple(bev.shape)}: {per_call} launch per call, "
        f"{len(plan.stages)} stages, {plan.smem_bytes} B of shared memory a "
        f"block; each stage launched alone (device time):")
    for s, (a, b) in enumerate(plan.stages):
        log(f"  stage {s:2d} {stage_ms[s]:.4f} ms  " + "; ".join(
            f"{op['name']} {op['h']}x{op['w']} {op['cin']}->{op['cout']} "
            f"tile {op['th']}x{op['tw']}x{op['tn']} wk {op['wk']}, "
            f"{op['tiles']} tiles" for op in plan.ops[a:b]))
    log(f"centernet: kernel {row['ms']:.4f} ms against the cuDNN module's "
        f"{row['library_ms']:.4f} ms in this run ("
        f"{row['library_ms'] / row['ms']:.2f}x); the stages one by one "
        f"{sum(stage_ms):.4f} ms; host_enqueue_ms {row['host_enqueue_ms']:.4f}"
        f"; {conv_flops(pc, bev.shape[1], bev.shape[2]) / row['ms'] / 1e9:.2f}"
        " TFLOP/s")
    if per_call != 1:
        raise AssertionError(f"centernet: {per_call} launches per call")


def person_planes_kernel(pred, hm, rows):
    """Phase 3 for K2 at 10 people with full 64^3 cubes (all alive, bbox
    1): the kernel pair (layout + planes) against its plain version within
    1e-4 and with identical zero patterns; the layout kernel and the planes
    kernel each timed alone, the planes kernel's gathered bytes and rate;
    then the call on frame 0's own proposals (the people that pass the
    gate). Returns the planes."""
    import torch
    from fvp_torch.ops.kernels import sampler as ksamp

    cfg, rc, dev = pred.cfg, pred.rc, pred.device
    V, J = cfg.num_views, cfg.num_joints
    n = cfg.ind_voxels_per_axis[0]
    prs = np.random.RandomState(1)
    centers = torch.as_tensor(np.stack([
        prs.uniform(-3000, 3000, 10), prs.uniform(-3500, 2500, 10),
        prs.uniform(700, 1100, 10)], axis=1)[None].astype(np.float32),
        device=dev)
    bbox = torch.ones((1, 10, 2), device=dev)
    mask = torch.ones((1, 10), dtype=torch.bool, device=dev)
    planes_k, _ = ksamp.person_planes(hm, rc, cfg, centers, bbox, mask)
    corner, start, end, _ = ksamp.person_bounds(centers, bbox, mask, cfg)
    planes_p = ksamp.person_planes_plain(hm, rc, cfg, corner, start, end)
    torch.cuda.synchronize()
    err = float((planes_k - planes_p).abs().max())
    if not torch.equal(planes_k > 0, planes_p > 0):
        raise AssertionError("person_planes: zero patterns differ")
    voxels = float(torch.prod((end - start).clamp(min=0).double(),
                              dim=1).sum())
    assert voxels > 0.9 * 10 * n ** 3, voxels    # full work
    report(rows, "person_planes", "fvp_torch/csrc/person_planes.cu",
           "fvp_tpu/ops/pallas/sampler.py:556 + "
           "fvp_tpu/ops/pallas/collapse.py:90", err, 1e-4,
           time_ms(lambda: ksamp.person_planes(hm, rc, cfg, centers, bbox,
                                               mask), spin=LONG_SPIN),
           time_ms(lambda: ksamp.person_planes_plain(
               hm, rc, cfg, corner, start, end), 3, 1),
           None,
           bound(nbytes(hm, rc.cam_params, corner, start, end, planes_k),
                 voxels * V * (45.0 + J * 8.0) + voxels * J * 5.0))
    row = rows["person_planes"]
    hmp = ksamp.pixel_major(hm)
    JP = hmp.shape[-1]
    gathered = voxels * V * 4 * JP * 4.0
    row.update(
        layout_ms=time_ms(lambda: ksamp.pixel_major(hm)),
        planes_ms=time_ms(lambda: ksamp.sample_planes(
            hmp, rc, cfg, corner, start, end, J)),
        gathered_bytes=gathered,
        host_enqueue_ms=host_ms(lambda: ksamp.person_planes(
            hm, rc, cfg, centers, bbox, mask)))
    row["gathered_gb_per_s"] = gathered / row["planes_ms"] / 1e6
    # frame 0's own proposals: the people that pass the gate
    prop = pred.model.detect(hm, rc, pred.packed)["proposals"]
    live = prop[..., 3] >= 0
    row["frame_people"] = int(live.sum())
    row["frame_ms"] = time_ms(lambda: ksamp.person_planes(
        hm, rc, cfg, prop[..., 0:3], prop[..., 5:7], live), spin=LONG_SPIN)
    log(f"person_planes: layout kernel {row['layout_ms']:.4f} ms "
        f"({nbytes(hm, hmp) / row['layout_ms'] / 1e6:.1f} GB/s of "
        f"{nbytes(hm, hmp) / 1e6:.1f} MB), planes kernel "
        f"{row['planes_ms']:.4f} ms gathering {gathered / 1e9:.2f} GB "
        f"({row['gathered_gb_per_s']:.1f} GB/s from L1/L2); host_enqueue_ms "
        f"{row['host_enqueue_ms']:.4f}; on frame 0's proposals "
        f"({row['frame_people']} pass the gate) {row['frame_ms']:.4f} ms")
    return planes_k


def backbone_kernels(pred, images_np, rows) -> None:
    """Phase 3 for the stem and the deconv head: each kernel against its
    plain version, within one bf16 ulp (BF16_RTOL, SUM_ATOL), on the seeded
    backbone's own activations of one frame, and timed with a bf16 cuDNN
    call of the same conv as the library yardstick."""
    import torch
    import torch.nn.functional as F
    from fvp_torch.ops.kernels import deconv_head as kdh
    from fvp_torch.ops.kernels import stem as kst

    cl = torch.channels_last
    pk = pred.backbone_packed
    x = torch.as_tensor(images_np, device=pred.device).contiguous()
    ps = pk["stem"]
    got, ref = kst.stem(x, ps), kst.stem_plain(x, ps)
    torch.cuda.synchronize()
    err, ulps = bf16_close(got, ref)
    N, H, W, _ = x.shape
    convs = N * kst.out_size(H)[0] * kst.out_size(W)[0] * 64
    xl = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    wl = ps["w"].permute(3, 2, 0, 1).contiguous(memory_format=cl)
    rows["stem"] = {
        "name": "stem", "route": "cuda", "source": "fvp_torch/csrc/stem.cu",
        "replaces": "fvp_tpu/ops/pallas/stem.py:127", **bf16_row(
            "stem", err, ulps, time_ms(lambda: kst.stem(x, ps)),
            time_ms(lambda: kst.stem_plain(x, ps)),
            time_ms(lambda: F.conv2d(xl, wl, stride=2, padding=3)),
            bound(nbytes(x, ps["w"], ps["aff"], got),
                  convs * (2.0 * 7 * 7 * 3 + 2), PEAK_BF16))}
    st = rows["stem"]
    st["plan"] = kst.stem_plan(N, H, W, torch.cuda.get_device_properties(
        0).multi_processor_count)._asdict()
    st["gb_per_s"] = nbytes(x, ps["w"], ps["aff"], got) / st["ms"] / 1e6
    st["host_enqueue_ms"] = host_ms(lambda: kst.stem(x, ps))
    log(f"  plan {st['plan']}; {st['gb_per_s']:.1f} GB/s of its "
        f"{nbytes(x, ps['w'], ps['aff'], got) / 1e6:.1f} MB; host_enqueue_ms "
        f"{st['host_enqueue_ms']:.4f}")

    # stage 1 reads the trunk's float32 output, the others the stage before
    xs = pred.backbone.trunk(ref)
    stages = []
    for i, st in enumerate(pk["head"]):
        got, ref = kdh.deconv_stage(xs, st), kdh.deconv_stage_plain(xs, st)
        torch.cuda.synchronize()
        err, ulps = bf16_close(got, ref)
        V, h, w, C = xs.shape
        Fo = st["w"].shape[-1]
        xl = xs.to(torch.bfloat16).permute(0, 3, 1, 2)
        wt = kdh.unpack_deconv_weight(st["w"]).to(torch.bfloat16) \
            .contiguous(memory_format=cl)
        outs = V * 4 * h * w * Fo
        stages.append(bf16_row(
            f"deconv_stage{i + 1} {tuple(xs.shape)} {xs.dtype}", err, ulps,
            time_ms(lambda: kdh.deconv_stage(xs, st)),
            time_ms(lambda: kdh.deconv_stage_plain(xs, st)),
            time_ms(lambda: F.conv_transpose2d(xl, wt, stride=2,
                                               padding=1)),
            bound(nbytes(xs, st["w"], st["aff"], got),
                  outs * (2.0 * 4 * C + 2), PEAK_BF16)))
        stages[-1]["host_enqueue_ms"] = host_ms(
            lambda: kdh.deconv_stage(xs, st))
        stages[-1]["ms_with_enqueue"] = time_ms(
            lambda: kdh.deconv_stage(xs, st), with_enqueue=True)
        plan = kdh.deconv_plan(V, h, w, C, Fo,
                               torch.cuda.get_device_properties(
                                   0).multi_processor_count)
        stages[-1]["plan"] = plan._asdict()
        log(f"  plan {plan}; host time to enqueue one call "
            f"{stages[-1]['host_enqueue_ms']:.4f} ms; timed with the enqueue "
            f"{stages[-1]['ms_with_enqueue']:.4f} ms")
        xs = ref
    head = {k: sum(s[k] for s in stages)
            for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                      "host_enqueue_ms", "ms_with_enqueue")}
    rows["deconv_stage"] = {
        "name": "deconv_stage", "route": "cuda",
        "source": "fvp_torch/csrc/deconv_head.cu",
        "replaces": "fvp_tpu/ops/pallas/deconv_head.py:151 + "
                    "fvp_tpu/ops/pallas/deconv_head.py:190",
        "max_abs_err": max(s["max_abs_err"] for s in stages),
        "max_ulps": max(s["max_ulps"] for s in stages),
        **head, "bound_by": "operations", "stages": stages}
    log(f"deconv_stage, the 3-stage head: kernel_ms={head['ms']:.4f} "
        f"plain_ms={head['plain_ms']:.4f} library_ms="
        f"{head['library_ms']:.4f} bound_ms={head['bound_ms']:.4f} "
        f"ms_with_enqueue={head['ms_with_enqueue']:.4f} "
        f"host_enqueue_ms={head['host_enqueue_ms']:.4f} (per stage: "
        + ", ".join(f"{st['host_enqueue_ms']:.4f}" for st in stages) + ")")


class PairedOps:
    """The ops of a bf16 net (ops/kernels/conv_bf16.py) run twice on the
    same inputs, by the kernels and by their plain versions: keeps the worst
    bf16 ulps (bf16_close) and the operation count, and passes the plain
    output on, so that each launch is held against its plain version alone.
    With `timed`, each launch is also timed alone (device time) and logged
    with its route, plan, shape and bytes. Its kernel counters are its own:
    these launches count on no path."""

    def __init__(self, timed: bool = False):
        from fvp_torch.ops.kernels import conv_bf16 as kcv

        self.kcv = kcv
        self.conv_k = kcv.conv_kernel("compare.conv")
        self.kernel = kcv.make_ops(self.conv_k,
                                   kcv.pool_kernel("compare.pool"))
        self.plain = kcv.PLAIN
        self.err = self.ulps = self.flops = self.bytes = 0.0
        self.launches = 0
        self.timed = timed
        self.per_launch = []

    def _held(self, got, ref, call, what, plan, moved):
        import torch

        torch.cuda.synchronize()
        err, ulps = bf16_close(got, ref)
        self.err, self.ulps = max(self.err, err), max(self.ulps, ulps)
        self.launches += 1
        self.bytes += moved
        if self.timed:
            ms = time_ms(call)
            rec = {"op": what, "route": plan.route if plan else "pool",
                   "ms": ms, "bytes": moved, "ulps": ulps,
                   "plan": plan._asdict() if plan else None}
            self.per_launch.append(rec)
            log(f"  launch {self.launches:2d} {what}: route "
                f"{rec['route']}, {moved / 1e6:.2f} MB, {ms:.4f} ms "
                f"({moved / ms / 1e6:.0f} GB/s), {ulps:.3f} ulps; plan "
                + (", ".join(f"{k}={v}" for k, v in plan._asdict().items()
                             if k != "route") if plan else "-"))
        return ref

    def conv(self, x, layer, res=None, relu=False, out_dtype=None):
        import math

        import torch

        out_dtype = out_dtype or torch.bfloat16
        taps, cin, f = layer["w"].shape
        N, H, W, _ = x.shape
        k = math.isqrt(taps)
        self.flops += N * H * W * f * (2.0 * taps * cin + 2
                                       + (res is not None))
        got = self.kernel.conv(x, layer, res, relu, out_dtype)
        moved = nbytes(x, layer["w"], layer["aff"], got) + (
            0 if res is None else nbytes(res))
        return self._held(
            got, self.plain.conv(x, layer, res, relu, out_dtype),
            lambda: self.kernel.conv(x, layer, res, relu, out_dtype),
            f"conv {k}x{k} {tuple(x.shape)} {str(x.dtype)[6:]} -> F {f} "
            f"{str(out_dtype)[6:]}, residual "
            f"{None if res is None else str(res.dtype)[6:]}",
            self.kcv.conv_plan(N, H, W, cin, f, k, 0,
                               torch.cuda.get_device_properties(
                                   0).multi_processor_count), moved)

    def upconv(self, x, layer, skip):
        import torch

        cin, f = layer["w"].shape[2:]
        N, H, W, _ = x.shape
        self.flops += 4.0 * N * H * W * f * (2.0 * cin + 4)
        got = self.kernel.upconv(x, layer, skip)
        return self._held(
            got, self.plain.upconv(x, layer, skip),
            lambda: self.kernel.upconv(x, layer, skip),
            f"upconv {tuple(x.shape)} -> F {f}, skip",
            self.kcv.conv_plan(N, H, W, cin, f, 1, 1,
                               torch.cuda.get_device_properties(
                                   0).multi_processor_count),
            nbytes(x, layer["w"], layer["aff"], skip, got))

    def pool(self, x):
        self.flops += 3.0 * x.numel() / 4
        got = self.kernel.pool(x)
        return self._held(got, self.plain.pool(x),
                          lambda: self.kernel.pool(x),
                          f"pool {tuple(x.shape)}", None,
                          nbytes(x, got))

    def summary(self, name) -> dict:
        """Per-route launch counts and summed device times of the timed
        launches; logs them."""
        routes = {}
        for r in self.per_launch:
            n, ms = routes.get(r["route"], (0, 0.0))
            routes[r["route"]] = (n + 1, ms + r["ms"])
        log(f"{name}: launches by route " + ", ".join(
            f"{k} {n} ({ms:.4f} ms)" for k, (n, ms) in routes.items())
            + f"; sum of the launches timed alone "
            f"{sum(r['ms'] for r in self.per_launch):.4f} ms; their bytes "
            f"{self.bytes / 1e6:.1f} MB, a layer-by-layer floor of "
            f"{self.bytes / PEAK_BYTES * 1e3:.4f} ms at "
            f"{PEAK_BYTES / 1e12:.2f} TB/s")
        return {"routes": {k: n for k, (n, _) in routes.items()},
                "layer_floor_ms": self.bytes / PEAK_BYTES * 1e3,
                "launches_timed_alone_ms": sum(r["ms"]
                                               for r in self.per_launch),
                "per_launch": self.per_launch}


def c2c_flops(N: int, Z: int, J: int) -> float:
    """Operations of C2CNet on N columns of height Z (2 per multiply-add,
    2 per output for the affine)."""
    from fvp_torch.ops.kernels.c2cnet import layer_shapes

    level = {"encoder_res1": 2, "skip_res2": 2, "decoder_res1": 2,
             "decoder_upsample1": 2, "encoder_res2": 4, "mid_res": 4,
             "decoder_res2": 4, "decoder_upsample2": 4}
    f = 0.0
    for name, taps, cin, fo in layer_shapes(J):
        z = Z // level.get(name.split(".")[0], 1)
        f += z * fo * (2.0 * taps * cin + 2 * (taps if taps == 2 else 1))
    return N * f


def fuse_kernels(pred, hm, planes, rows) -> None:
    """Phase 3 for the fuse_p2p kernels. P2PNet on K2's planes of frame 0
    (30, 64, 64, 15): each of its 25 launches against its plain version on
    the same input within one bf16 ulp, the whole net within NET_RTOL of
    its scale. C2CNet, one launch, on frame 0's z-columns (10, 20, 15):
    within NET_RTOL of its scale. Library yardstick: the port's cuDNN
    module of the same net in bf16 (P2PNet channels-last)."""
    import torch
    from fvp_torch.engine.packing import bf16_copy
    from fvp_torch.ops.kernels import c2cnet as kc2c
    from fvp_torch.ops.kernels import hourglass as khg

    pk = pred.packed["p2p_net"]
    log(f"p2pnet {tuple(planes.shape)}, launch by launch (device time of "
        "each alone):")
    paired = PairedOps(timed=True)
    khg.run(pk, planes, paired)
    launches = paired.summary("p2pnet")
    got, ref = khg.p2pnet(pk, planes), khg.p2pnet_plain(pk, planes)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"p2pnet {tuple(planes.shape)}: {paired.launches} launches each "
        f"within {paired.ulps:.3f} bf16 ulps of the plain op (max_abs_err "
        f"{paired.err:.3e}); whole net max_abs_err {err:.3e}, scale "
        f"{scale:.3e} (tol {NET_RTOL} x scale)")
    if not (paired.ulps <= 1.0 and err <= NET_RTOL * scale and scale > 0):
        raise AssertionError("p2pnet disagrees with its plain version")
    net16 = bf16_copy(pred.model.joint_net.conv_net, ("output_layer",))
    p16 = planes.to(torch.bfloat16)
    rows["p2pnet"] = {
        "name": "p2pnet", "route": "cuda",
        "source": "fvp_torch/csrc/conv_bf16.cu",
        "replaces": "fvp_tpu/ops/pallas/hourglass.py:614",
        **bf16_row("p2pnet", err, paired.ulps,
                   time_ms(lambda: khg.p2pnet(pk, planes)),
                   time_ms(lambda: khg.p2pnet_plain(pk, planes)),
                   time_ms(lambda: net16(p16)),
                   bound(nbytes(planes, got, *_leaves(pk)), paired.flops,
                         PEAK_BF16)),
        "host_enqueue_ms": host_ms(lambda: khg.p2pnet(pk, planes)),
        **launches}

    pc = pred.packed["c2c_net"]
    cols = pred.model.detect(hm, pred.rc, pred.packed)["columns"]
    got, ref = kc2c.c2cnet(pc, cols), kc2c.c2cnet_plain(pc, cols)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    _, ulps = bf16_close(got, ref)
    log(f"c2cnet {tuple(cols.shape)}: max_abs_err {err:.3e}, scale "
        f"{scale:.3e} (tol {NET_RTOL} x scale), {ulps:.3f} bf16 ulps")
    if not (err <= NET_RTOL * scale and scale > 0):
        raise AssertionError("c2cnet disagrees with its plain version")
    c2c16 = bf16_copy(pred.model.pose_net.c2c_net, ("output_hm",))
    c16 = cols.to(torch.bfloat16)
    rows["c2cnet"] = {
        "name": "c2cnet", "route": "cuda",
        "source": "fvp_torch/csrc/c2cnet.cu",
        "replaces": "fvp_tpu/ops/pallas/hourglass.py:565",
        "max_abs_err": err, "max_ulps": ulps,
        "ms": time_ms(lambda: kc2c.c2cnet(pc, cols)),
        "plain_ms": time_ms(lambda: kc2c.c2cnet_plain(pc, cols)),
        "library_ms": time_ms(lambda: c2c16(c16)),
        "host_enqueue_ms": host_ms(lambda: kc2c.c2cnet(pc, cols))}
    b = bound(nbytes(cols, got, pc["w_flat"], pc["aff_flat"]),
              c2c_flops(*cols.shape), PEAK_BF16)
    rows["c2cnet"].update(bound_ms=b[0], bound_by=b[1])
    c2cnet_plans(pc, cols, rows["c2cnet"])
    for name in ("p2pnet", "c2cnet"):
        log(f"{name}: host_enqueue_ms (one call) "
            f"{rows[name]['host_enqueue_ms']:.4f}")
    log(f"c2cnet: kernel_ms={rows['c2cnet']['ms']:.4f} plain_ms="
        f"{rows['c2cnet']['plain_ms']:.4f} library_ms="
        f"{rows['c2cnet']['library_ms']:.4f} bound_ms={b[0]:.4f} ({b[1]})")


def c2cnet_plans(pc, cols, row) -> None:
    """C2CNet's plan on frame 0's columns and one launch per call."""
    from fvp_torch.ops.kernels import c2cnet as kc2c

    plan = kc2c.c2cnet_plan(*cols.shape)
    before = kc2c.C2C.launches
    kc2c.c2cnet(pc, cols)
    if kc2c.C2C.launches != before + 1:
        raise AssertionError("c2cnet: not one launch per call")
    row["plan"] = {"ctas": plan.ctas, "cols": plan.cols,
                   "depth": plan.depth, "barriers": plan.barriers,
                   "smem": plan.smem}
    log(f"c2cnet plan: {plan.ctas} CTAs of {plan.cols} columns, ring depth "
        f"{plan.depth} x {plan.slot_bytes} B, {plan.barriers} block "
        f"barriers, {plan.smem} B shared; 1 launch per call")


def stage_weights(pred):
    """The bottleneck stage's packed weights and (cmid, down) per block:
    the predictor's ResNet-50 layer1."""
    from fvp_torch.engine.packing import pack_bottleneck_stage

    layer1 = pred.backbone.layer1
    cfg = tuple((blk.conv1.out_channels, blk.downsample is not None)
                for blk in layer1)
    return pack_bottleneck_stage(layer1), cfg


def stage_kernel(pred, images_np, rows) -> None:
    """Phase 3 for the bottleneck stage, on the seeded ResNet-50's layer1
    input of image frame 0 (the stem's output, (5, 128, 240, 64) bf16):
    each of its 10 launches within one bf16 ulp of the plain op on the same
    input, the stage within NET_RTOL of its scale. Library yardstick:
    cuDNN's bf16 layer1, channels-last; beside it the port's float32 layer1
    (its trunk, TF32 off)."""
    import copy

    import torch
    from fvp_torch.ops.kernels import stem as kst
    from fvp_torch.ops.kernels import trunk as ktr

    packed, cfg = stage_weights(pred)
    x = kst.stem(torch.as_tensor(images_np, device=pred.device),
                 pred.backbone_packed["stem"])
    log(f"bottleneck_stage {tuple(x.shape)}, launch by launch (device time "
        "of each alone):")
    paired = PairedOps(timed=True)
    ktr.run(x, packed, cfg, paired)
    launches = paired.summary("bottleneck_stage")
    got = ktr.bottleneck_stage(x, packed, cfg)
    ref = ktr.bottleneck_stage_plain(x, packed, cfg)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    log(f"bottleneck_stage {tuple(x.shape)}: {paired.launches} launches "
        f"each within {paired.ulps:.3f} bf16 ulps of the plain op; stage "
        f"max_abs_err {err:.3e}, scale {scale:.3e} (tol {NET_RTOL} x "
        "scale)")
    if not (paired.ulps <= 1.0 and err <= NET_RTOL * scale and scale > 0):
        raise AssertionError("bottleneck_stage disagrees with its plain "
                             "version")
    cl = torch.channels_last
    l16 = copy.deepcopy(pred.backbone.layer1).to(torch.bfloat16).to(
        memory_format=cl)
    x16 = x.permute(0, 3, 1, 2)                      # channels-last NCHW
    x32 = x.float().permute(0, 3, 1, 2)
    f32_ms = time_ms(lambda: pred.backbone.layer1(x32))
    rows["bottleneck_stage"] = {
        "name": "bottleneck_stage", "route": "cuda",
        "source": "fvp_torch/csrc/conv_bf16.cu",
        "replaces": "fvp_tpu/ops/pallas/trunk.py:175",
        **bf16_row("bottleneck_stage", err, paired.ulps,
                   time_ms(lambda: ktr.bottleneck_stage(x, packed, cfg)),
                   time_ms(lambda: ktr.bottleneck_stage_plain(x, packed,
                                                              cfg)),
                   time_ms(lambda: l16(x16)),
                   bound(nbytes(x, got, *_leaves(packed)), paired.flops,
                         PEAK_BF16)),
        "float32_layer1_ms": f32_ms,
        "host_enqueue_ms": host_ms(lambda: ktr.bottleneck_stage(x, packed,
                                                                cfg)),
        **launches}
    log(f"  the port's float32 layer1 (cuDNN, TF32 off): {f32_ms:.4f} ms; "
        "host_enqueue_ms (one call of the stage) "
        f"{rows['bottleneck_stage']['host_enqueue_ms']:.4f}; the stage "
        f"{rows['bottleneck_stage']['ms']:.4f} ms against its "
        f"layer-by-layer byte floor {launches['layer_floor_ms']:.4f} ms")


def bf16_row(name, err, ulps, ms, plain_ms, lib_ms, bnd) -> dict:
    """Log and check one bf16 kernel's comparison; its measurements."""
    log(f"{name}: max_abs_err={err:.3e} max_ulps={ulps:.3f} (tol 1 bf16 "
        f"ulp + {SUM_ATOL:.0e} x scale) kernel_ms={ms:.4f} plain_ms="
        f"{plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bnd[0]:.4f} "
        f"({bnd[1]})")
    if not ulps <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version by {ulps} bf16 ulps")
    return {"name": name, "max_abs_err": err, "max_ulps": ulps, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": lib_ms}


def image_breakdown(pred, frame) -> dict:
    """The image frame's parts, each timed alone (CUDA events around the
    call, median of 20): the pageable host-to-device copy of the images,
    the stem, layer1 (the stage kernel under bf16, else cuDNN), layers 2-4
    (cuDNN, channels-last, in the predictor's compute_dtype), the three
    deconv launches, final_layer and the HDN+JLN (whose host gaps between
    launches count). Returns them by name."""
    import torch
    from fvp_torch.ops.kernels.deconv_head import deconv_head
    from fvp_torch.ops.kernels.stem import stem
    from fvp_torch.ops.kernels.trunk import bottleneck_stage

    bb, pk = pred.backbone, pred.backbone_packed

    def timed(fn):                   # the card idle at the first event
        return time_ms(fn, with_enqueue=True)

    trunk = pk.get("trunk")          # the bf16 copies of the layers
    layers = [bb.layer1, bb.layer2, bb.layer3, bb.layer4] if trunk is None \
        else trunk

    def layer1(s):
        if "layer1" in pk:
            return bottleneck_stage(s, *pk["layer1"]).permute(0, 3, 1, 2)
        x = s.permute(0, 3, 1, 2)
        return layers[0](x.float() if trunk is None else x)

    def layers2to4(x):
        for layer in layers[-3:]:
            x = layer(x)
        return x.permute(0, 2, 3, 1).contiguous()

    with torch.inference_mode():
        x = torch.as_tensor(frame, device=pred.device)
        flat = x.reshape(-1, *x.shape[2:])
        s = stem(flat, pk["stem"])
        l1 = layer1(s)
        t = layers2to4(l1)
        h = deconv_head(t, pk["head"]).float().permute(0, 3, 1, 2)
        hm = pred.heatmaps(frame)
        parts = {
            "host-to-device copy of the images (pageable)": timed(
                lambda: torch.as_tensor(frame, device=pred.device)),
            "stem kernel": timed(lambda: stem(flat, pk["stem"])),
            "layer1": timed(lambda: layer1(s)),
            "layers 2-4 (cuDNN, channels-last)": timed(
                lambda: layers2to4(l1)),
            "head (3 deconv launches)": timed(
                lambda: deconv_head(t, pk["head"])),
            "final_layer": timed(lambda: bb.final_layer(h)),
            "HDN+JLN on the heatmaps": timed(
                lambda: pred.model(hm, pred.rc, pred.packed)),
        }
    log(f"image frame by part, {pk['compute_dtype']} (each timed alone; "
        f"layer1 on {'the stage kernel' if 'layer1' in pk else 'cuDNN'}):")
    for name, ms in parts.items():
        log(f"  {ms:8.3f} ms  {name}")
    log(f"  {sum(parts.values()):8.3f} ms  sum")
    return parts


# the kernels each path must launch (and no others)
HEATMAP_PATH = ("whole_sample", "person_planes", "centernet", "soft_argmax",
                "weightnet_pool")
IMAGE_PATH = ("stem", "deconv_stage") + HEATMAP_PATH
FUSE_PATH = HEATMAP_PATH + ("p2pnet", "c2cnet")
BF16_IMAGE_PATH = IMAGE_PATH + ("bottleneck_stage",)


def launch_counts(K) -> dict:
    """Launches per kernel of the JSON line: the wrappers' counters, with
    P2PNet's and the stage's routes summed (person_planes: its planes
    kernel, whose layout kernel launches once beside each)."""
    c = {k.name: k.launches for k in K.all_kernels().values()}
    if c["person_planes.layout"] != c["person_planes"]:
        raise AssertionError("person_planes: layout and planes launches "
                             "differ")
    return {"stem": c["stem"], "deconv_stage": c["deconv_stage"],
            "whole_sample": c["whole_sample"],
            "person_planes": c["person_planes"],
            "centernet": c["centernet"],
            "soft_argmax": c["soft_argmax"],
            "weightnet_pool": c["weightnet_pool"],
            "p2pnet": c["p2pnet.conv.wgmma"] + c["p2pnet.conv.wmma"]
            + c["p2pnet.pool"],
            "c2cnet": c["c2cnet"],
            "bottleneck_stage": c["bottleneck_stage.wgmma"]
            + c["bottleneck_stage.wmma"]}


# launches per call of each conv route (ops/kernels/conv_bf16.py::
# conv_plan): P2PNet's 7x7 front and 1x1 output layer on the wmma kernel,
# its 21 other convs and up-convs and all 10 of the stage's on conv_wgmma
P2PNET_ROUTES = {"wgmma": 21, "wmma": 2}
STAGE_ROUTES = {"wgmma": 10, "wmma": 0}


def expect_conv_routes(K, name, calls, per_call) -> None:
    """The conv launches of `calls` calls went through each route as
    conv_plan routes them (the wrappers' per-route counters)."""
    c = {k.name: k.launches for k in K.all_kernels().values()}
    got = {r: c[f"{name}.{r}"] for r in per_call}
    log(f"{name}: {calls} calls, conv launches by route {got}")
    if calls < 1 or got != {r: n * calls for r, n in per_call.items()}:
        raise AssertionError(f"{name}: routes {got}, expected "
                             f"{per_call} x {calls}")


def expect_launches(counts, names, what) -> None:
    """Every kernel of `names` ran on the path, and no other kernel did."""
    for name, c in counts.items():
        if (c > 0) != (name in names):
            raise AssertionError(f"{what}: {name} launched {c} times")


def drive(pred, frames, K):
    """Every launch count to 0, FRAMES frames through `pred`, the counts
    read back. Returns (outputs, host-clock ms per frame, launches)."""
    import torch

    K.reset_launches()
    lat, outs = [], []
    for i in range(FRAMES):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pred(frames[i % len(frames)])
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        outs.append(out)
    return outs, lat, launch_counts(K)


def check_poses_bf16(out, pred, cpu, hm) -> None:
    """The bf16 path's frame against the CPU's bf16 HDN+JLN on the same
    heatmaps. cuDNN's bf16 convs and the CPU's round at other points (the
    C2CNet scores' difference is printed): masks must be identical (the
    gate clear of both sides' confidences), each person whose voxel pick
    agrees within BF16_POSE_TOL_MM, and a person whose z pick differs only
    where C2CNet's scores at the two picks are a near-tie on the CPU
    (within BF16_TIE_RTOL of the person's score scale)."""
    import torch

    ref = cpu(hm.cpu())
    got = {k: v.cpu() for k, v in out.items()}
    with torch.inference_mode():
        d_cpu = cpu.model.detect(hm.cpu(), cpu.rc, cpu.packed)
        d_card = pred.model.detect(hm, pred.rc, pred.packed)
    c_cpu = d_cpu["proposals"][0, :, 4]
    c_card = d_card["proposals"][0, :, 4].cpu()
    min_score = cpu.cfg.min_score
    passed = int(ref["mask"].sum())
    log(f"bf16 image path proposals passing min_score={min_score}: {passed}; "
        f"detection confidences, CPU {[round(float(c), 4) for c in c_cpu]}, "
        f"card {[round(float(c), 4) for c in c_card]}")
    gap = float(torch.minimum((c_cpu - min_score).abs(),
                              (c_card - min_score).abs()).min())
    if passed < 2 or gap <= 1e-4:
        raise AssertionError(f"vacuous or fragile gate: {passed} pass, "
                             f"closest confidence {gap} from min_score")
    if not torch.equal(got["mask"], ref["mask"]):
        raise AssertionError("masks differ between the card and the CPU")
    for k in ("fused_poses", "proposals"):
        if not torch.isfinite(got[k]).all():
            raise AssertionError(f"{k}: non-finite")
    same = (got["proposals"][0, :, :3] == ref["proposals"][0, :, :3]) \
        .all(dim=-1)
    hm1d = d_cpu["hm1d"][0]                                  # (K, Z)
    z_card = d_card["hm1d"][0].argmax(dim=-1).cpu()
    log(f"bf16 image path C2CNet scores, card vs CPU: max_abs_err "
        f"{float((d_card['hm1d'][0].cpu() - hm1d).abs().max()):.3e}, scale "
        f"{float(hm1d.abs().max()):.3e}")
    flips = []
    for k in torch.nonzero(~same).flatten().tolist():
        xy_same = bool((got["proposals"][0, k, :2]
                        == ref["proposals"][0, k, :2]).all())
        tie = float(hm1d[k].max() - hm1d[k, z_card[k]])
        scale = float(hm1d[k].abs().max())
        flips.append((k, int(hm1d[k].argmax()), int(z_card[k]), tie / scale))
        if not (xy_same and tie <= BF16_TIE_RTOL * scale):
            raise AssertionError(f"person {k}: voxel picks differ beyond a "
                                 f"z near-tie ({tie / scale:.3e} of scale)")
    err = (got["fused_poses"][0, :, :, :3] - ref["fused_poses"][0, :, :, :3]
           ).norm(dim=-1).amax(dim=-1)                       # (K,)
    kept = err[same]
    log(f"bf16 image path fused_poses: {int(same.sum())} of {same.numel()} "
        f"people with the same voxel pick on card and CPU, joint distance "
        f"max {float(kept.max()):.3e} mm (tol {BF16_POSE_TOL_MM} mm), per "
        f"person {[round(float(e), 3) for e in kept]}; z picks that differ "
        f"on a near-tie (person, CPU z, card z, gap / scale): {flips}")
    if not float(kept.max()) <= BF16_POSE_TOL_MM:
        raise AssertionError("bf16 fused_poses differ between card and CPU")


def check_heatmaps(got, ref, label) -> None:
    """View 0's heatmaps (J, h, w), card against CPU: finite, with spread,
    within HM_RTOL of their scale."""
    import torch

    scale = float(ref.abs().max())
    spread = float(ref.std(dim=(1, 2)).min())
    err = float((got - ref).abs().max())
    log(f"{label}heatmaps {tuple(got.shape)}: view 0 card vs CPU "
        f"max_abs_err {err:.3e}, scale {scale:.3e} (tol {HM_RTOL} x "
        f"scale); smallest per-joint std {spread:.3e}")
    if not (torch.isfinite(got).all() and spread > 1e-2 * scale > 0):
        raise AssertionError("heatmaps non-finite or without spread")
    if not err <= HM_RTOL * scale:
        raise AssertionError("heatmaps differ between card and CPU")


def pose_distance(bf16, f32) -> None:
    """Information, not a gate: the bf16 frame's fused poses against the
    float32 frame's on the card, over the people both keep."""
    both = (bf16["mask"] & f32["mask"])[0]
    d = (bf16["fused_poses"][0, :, :, :3] - f32["fused_poses"][0, :, :, :3])
    d = d.norm(dim=-1)[both]
    log(f"bf16 vs float32 image path on the card: masks "
        f"{bf16['mask'][0].tolist()} vs {f32['mask'][0].tolist()}; over the "
        f"{int(both.sum())} people both keep, joint distance max "
        f"{float(d.max()) if d.numel() else float('nan'):.3f} mm, mean "
        f"{float(d.mean()) if d.numel() else float('nan'):.3f} mm")


def expect_per_frame(counts, per_frame, what) -> None:
    """Each named kernel launched exactly that many times a frame."""
    for name, n in per_frame.items():
        if counts[name] != n * FRAMES:
            raise AssertionError(f"{what}: {name} launched {counts[name]} "
                                 f"times in {FRAMES} frames, expected "
                                 f"{n} a frame")


def log_latency(what, lat) -> None:
    steady = lat[WARMUP_FRAMES:]
    log(f"{what}: median {statistics.median(steady):.3f} ms over "
        f"{len(steady)} frames (host clock, synchronised; first "
        f"{WARMUP_FRAMES} excluded: "
        f"{', '.join(f'{x:.1f}' for x in lat[:WARMUP_FRAMES])} ms)")


def check_poses(out, cpu, hm, label, tol_mm: float = 5e-2) -> None:
    """The card's output `out` of a frame whose heatmaps are `hm` against
    the CPU predictor `cpu` on the same heatmaps: a non-vacuous gate clear
    of min_score, identical masks, fused poses within `tol_mm`."""
    import torch

    ref = cpu(hm.cpu())
    got = {k: v.cpu() for k, v in out.items()}
    with torch.inference_mode():
        conf = cpu.model.detect(hm.cpu(), cpu.rc, cpu.packed)[
            "proposals"][0, :, 4]
    min_score = cpu.cfg.min_score
    passed = int(ref["mask"].sum())
    log(f"{label}proposals passing min_score={min_score}: {passed}; "
        f"detection confidences {[round(float(c), 4) for c in conf]}")
    gap = float((conf - min_score).abs().min())
    if passed < 2 or gap <= 1e-4:
        raise AssertionError(f"vacuous or fragile gate: {passed} pass, "
                             f"closest confidence {gap} from min_score")
    p = got["proposals"]
    if p.shape != ref["proposals"].shape or not torch.isfinite(p).all():
        raise AssertionError(f"proposals: shape {tuple(p.shape)} or "
                             "non-finite")
    check_fused(got["fused_poses"], ref["fused_poses"], label, tol_mm)


def eval_phase(K, state, smi, rows):
    """Phase 8: the eval engine on the card. run_validation on EVAL_CFG's
    held-out scenes at its test batch of 8 with every launch count set to
    0 just before; K1-K5 once a batch and no other kernel; then batch 0's
    8 frames one by one against the batched run, two of its frames on the
    CPU, the device splat against the numpy renderer, and a profile of a
    batch, and K1-K5 timed on the batch's own tensors beside their times
    at B = 1 (phase 3, `rows`). Returns (launches, run_validation's
    result)."""
    import torch
    from fvp_torch.config import load_config
    from fvp_torch.data.heatmaps import generate_input_heatmap
    from fvp_torch.data.loader import build_samples, collate
    from fvp_torch.data.registry import build_dataset
    from fvp_torch.engine.serve import Engine
    from fvp_torch.engine.validate import (RENDER_KEYS, batch_input,
                                           eval_batches, eval_rng,
                                           make_eval_step, run_validation)
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose
    from fvp_torch.ops.heatmap_render import render_heatmaps_device

    dev = torch.device("cuda")
    base = load_config(EVAL_CFG, synthetic_num_data=EVAL_SCENES)
    ds = build_dataset(base.test_dataset, base, is_train=False)
    rig = ds.rigs["synthetic"]
    specs = list(eval_batches(ds, base.test_batch_size))
    log(f"eval phase: {EVAL_CFG}, {len(ds)} held-out scenes of up to "
        f"{base.synthetic_max_people} people, batches "
        f"{[int(v) for _, _, v in specs]} of {base.test_batch_size} "
        f"(padded), device render {base.device_render}, augmentation "
        f"{ds.data_augmentation}, {base.compute_dtype}")
    # batch 0's inputs as run_validation draws them (its fixed eval RNG)
    idx0 = specs[0][1]
    x0 = batch_input(collate(build_samples(ds, idx0, rng=eval_rng(base))),
                     dev)

    def engine(cfg, device):
        model = FasterVoxelPose(cfg)
        model.load_state_dict(state)
        return Engine(cfg, model, device)

    # the gate: the widest gap between batch 0's confidences that leaves
    # at least two of frames 0-1's people (the ones held against the CPU)
    # above it and one below
    probe = engine(base, dev)
    rc = probe.rig_constants(rig)
    with torch.inference_mode():
        hm0 = render_heatmaps_device(base, *(x0[k] for k in RENDER_KEYS))
        conf = probe.model.detect(hm0, rc, probe.packed)["proposals"][..., 4]
    cb = conf.cpu().numpy()
    c = np.sort(cb.ravel())
    f01 = cb[:2].ravel()
    fits = [i for i in range(len(c) - 1)
            if (f01 > c[i]).sum() >= 2 and (f01 <= c[i]).sum() >= 1]
    i = max(fits, key=lambda i: c[i + 1] - c[i])
    cfg = base.replace(min_score=float((c[i] + c[i + 1]) / 2))
    log(f"eval gate: min_score {cfg.min_score:.6f} in the widest gap "
        f"({c[i]:.6f} .. {c[i + 1]:.6f}) of batch 0's {len(c)} detection "
        f"confidences ({c[0]:.4f} .. {c[-1]:.4f}) with at least two of "
        f"frames 0-1 above it; {len(c) - i - 1} above it in all")

    # run_validation: counts to 0, the run, counts read back
    model = FasterVoxelPose(cfg)
    model.load_state_dict(state)
    K.reset_launches()
    res = run_validation(cfg, model, ds, device=dev, log=log)
    counts = launch_counts(K)
    log(f"eval path: {len(specs)} batches, launches {counts}")
    expect_launches(counts, HEATMAP_PATH, "eval path")
    for name in HEATMAP_PATH:
        if counts[name] != len(specs):
            raise AssertionError(f"eval path: {name} launched "
                                 f"{counts[name]} times in {len(specs)} "
                                 "batches, expected one a batch")
    poses = res["fused_poses"]
    if poses.shape != (len(ds), cfg.max_people, cfg.num_joints, 5) \
            or not np.isfinite(poses).all():
        raise AssertionError(f"eval fused_poses {poses.shape} or non-finite")
    log(f"eval on {smi}: {res['fps']:.2f} frames/s (first batch excluded), "
        f"batch_ms {json.dumps(res['batch_ms'])}; people kept "
        f"{int((poses[..., 0, 3] >= 0).sum())} of {poses[..., 0, 3].size}")
    log(f"eval metrics (seeded random weights): "
        f"{json.dumps(res['metrics'], default=float)}")

    # batch 0 batched and frame by frame through the same packed model
    e = Engine(cfg, model, dev)
    step = make_eval_step(cfg, e.model, e.packed)
    batched = step(x0, rc).cpu()
    ran = torch.from_numpy(poses[idx0])
    if not torch.equal(batched, ran):
        raise AssertionError("batch 0 differs from run_validation's: "
                             f"{float((batched - ran).abs().max()):.3e}")
    res["tf32_shift_mm"] = tf32_shift(e, step, x0, rc, hm0, batched, smi)
    single = torch.cat([step({k: v[b:b + 1] for k, v in x0.items()}, rc)
                        .cpu() for b in range(len(idx0))])
    masks = (batched[..., 0, 3] >= 0, single[..., 0, 3] >= 0)
    err = float((batched - single).abs().max())
    log(f"eval batch 8 vs batch 1 on the card: masks identical "
        f"{bool(torch.equal(*masks))} ({int(masks[0].sum())} kept), "
        f"fused_poses max_abs_err {err:.3e} mm (tol "
        f"{EVAL_BATCH_TOL_MM:.0e} mm)")
    if not torch.equal(*masks) or not err <= EVAL_BATCH_TOL_MM:
        raise AssertionError("batch 8 and batch 1 differ on the card")

    # two of batch 0's frames on the CPU (the plain path)
    cpu = engine(cfg, "cpu")
    rc_cpu = cpu.rig_constants(rig)
    x_cpu = {k: v[:2].cpu() for k, v in x0.items()}
    with torch.inference_mode():
        hm_cpu = render_heatmaps_device(cfg, *(x_cpu[k]
                                               for k in RENDER_KEYS))
        c_cpu = cpu.model.detect(hm_cpu, rc_cpu, cpu.packed)[
            "proposals"][..., 4]
    ref = make_eval_step(cfg, cpu.model, cpu.packed)(x_cpu, rc_cpu)
    gap = min(float((c_cpu - cfg.min_score).abs().min()),
              float((conf - cfg.min_score).abs().min()))
    passed = int((ref[..., 0, 3] >= 0).sum())
    log(f"eval card vs CPU, frames 0-1: {passed} people pass the gate on "
        f"the CPU, closest confidence {gap:.3e} from it")
    if passed < 2 or gap <= 1e-4:
        raise AssertionError(f"vacuous or fragile gate: {passed} pass, "
                             f"closest confidence {gap} from min_score")
    check_fused(batched[:2], ref, "eval frames 0-1 ")

    # the device splat against the numpy renderer on the same draws
    hm_np = np.stack([numpy_render(ds, int(r), x0, b, generate_input_heatmap)
                      for b, r in enumerate(idx0)])
    err = float(np.abs(hm0.cpu().numpy() - hm_np).max())
    log(f"eval device render {tuple(hm0.shape)} vs the numpy renderer: "
        f"max_abs_err {err:.3e} (tol {RENDER_ATOL:.0e}), peak "
        f"{float(hm_np.max()):.3f}")
    if not err <= RENDER_ATOL or not hm_np.max() > 0.5:
        raise AssertionError("device render differs from the numpy one")

    # where a batch's time goes: render, K1-K5, cuDNN nets, copies, host
    profile_frames(lambda x: step(x, rc), [x0], unit="batch",
                   groups=EVAL_PROFILE_GROUPS)
    batch_kernels(cfg, e, rc, hm0, rows)
    with torch.inference_mode():
        # spins longer than each call's host enqueue (~200 launches for
        # the splat, the model's many more)
        render_ms = time_ms(lambda: render_heatmaps_device(
            cfg, *(x0[k] for k in RENDER_KEYS)), reps=10, spin=LONG_SPIN)
        model_ms = time_ms(lambda: e.model(hm0, rc, e.packed), reps=10,
                           spin=4 * LONG_SPIN)
    log(f"eval batch parts, each alone (device time): the splat "
        f"{render_ms:.3f} ms, the model {model_ms:.3f} ms")
    res["parts_ms"] = {"render": render_ms, "model": model_ms}

    # run_validation times only two batches here, one of them half
    # padding: batch 0 stepped as it steps a batch (host clock between two
    # synchronisations), EVAL_FULL_BATCHES times after one warm-up
    full = []
    for _ in range(EVAL_FULL_BATCHES + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(x0, rc)
        torch.cuda.synchronize()
        full.append((time.perf_counter() - t) * 1e3)
    full = full[1:]
    med = statistics.median(full)
    log(f"eval full batches: batch 0 stepped {len(full)} times, median "
        f"{med:.3f} ms ({min(full):.3f} .. {max(full):.3f}), "
        f"{len(idx0) * 1e3 / med:.2f} frames/s at B = {len(idx0)}")
    res["full_batch_ms"] = full
    return counts, res


def tf32_shift(e, step, x, rc, hm, ref, smi) -> float:
    """How far TF32 moves the eval batch's poses: the model called directly
    with PyTorch's default flags (TF32 on for cuDNN convs; matmuls too), as
    the entry points computed before they entered float32_math, against
    the eval step's float32 poses `ref`; and the eval step itself under
    those flags, which must give `ref` again. Returns the distance in
    mm (people kept in both)."""
    import torch

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            raw = e.model(hm, rc, e.packed)["fused_poses"].cpu()
        fixed = step(x, rc).cpu()
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    keep = (raw[..., 0, 3] >= 0) & (ref[..., 0, 3] >= 0)
    shift = float((raw - ref)[keep][..., :3].abs().max()) if keep.any() \
        else 0.0
    same = bool(torch.equal(raw[..., 0, 3] >= 0, ref[..., 0, 3] >= 0))
    err = float((fixed - ref).abs().max())
    log(f"TF32 on {smi}: the eval batch's fused_poses with TF32 on (the "
        f"model called outside float32_math) move {shift:.4e} mm from the "
        f"float32 ones ({int(keep.sum())} people kept in both, masks "
        f"identical {same}); the eval step under the same flags: "
        f"{err:.3e} mm from float32 (identical {err == 0.0})")
    if not err <= EVAL_BATCH_TOL_MM:
        raise AssertionError("the eval step computed TF32 under global "
                             "TF32 flags")
    return shift


def batch_kernels(cfg, e, rc, hm, rows) -> None:
    """K1-K5 on batch 0's tensors, B = 8 frames and P = 80 people (the
    kept ones sampled by person_planes): each against its plain version on
    the same inputs with phase 3's tolerances, and timed alone (CUDA
    events, as phase 3) beside its B = 1 time there."""
    import torch
    from fvp_torch.ops.kernels import centernet as kcn
    from fvp_torch.ops.kernels import sampler as ksamp
    from fvp_torch.ops.kernels import softargmax as ksa
    from fvp_torch.ops.kernels import weightnet as kwn

    B, K, J = hm.shape[0], cfg.max_people, cfg.num_joints
    n = cfg.ind_voxels_per_axis[0]
    pc, pw, grid = e.packed["center_net"], e.packed["weight_net"], \
        rc.center_grid
    errs = {}
    with torch.inference_mode():
        vol = ksamp.whole_sample(hm, rc, cfg)
        vol_p = ksamp.whole_sample_plain(hm, rc, cfg)
        errs["whole_sample"] = (float((vol - vol_p).abs().max()), 1e-5)
        bev = vol.amax(dim=3).contiguous()
        hm_k, size_k = kcn.centernet_forward(pc, bev)
        hm_p, size_p = kcn.centernet_plain(pc, bev)
        scale = float(max(hm_p.abs().max(), size_p.abs().max()))
        errs["centernet"] = (float(max((hm_k - hm_p).abs().max(),
                                       (size_k - size_p).abs().max())),
                             1e-4 * max(scale, 1.0))
        props = e.model.detect(hm, rc, e.packed)["proposals"]
        mask = props[..., 3] >= 0
        planes, _ = ksamp.person_planes(hm, rc, cfg, props[..., :3],
                                        props[..., 5:7], mask)
        corner, start, end, _ = ksamp.person_bounds(props[..., :3],
                                                    props[..., 5:7], mask,
                                                    cfg)
        planes_p = ksamp.person_planes_plain(hm, rc, cfg, corner, start,
                                             end)
        if not torch.equal(planes > 0, planes_p > 0):
            raise AssertionError(f"person_planes at B = {B}: zero patterns "
                                 "differ")
        errs["person_planes"] = (float((planes - planes_p).abs().max()),
                                 1e-4)
        feats = e.model.joint_net.conv_net(planes.reshape(3 * B * K, n, n, J))
        fl = feats.reshape(3, B * K, n * n, J).contiguous()
        feats = feats.contiguous()
        c_k, p_k = ksa.soft_argmax(fl, grid, cfg.beta)
        c_p, p_p = ksa.soft_argmax_plain(fl, grid, cfg.beta)
        errs["soft_argmax"] = (float(max((c_k - c_p).abs().max(),
                                         (p_k - p_p).abs().max())), 1e-2)
        w_k = kwn.weightnet_pool(feats, pw)
        w_p = kwn.weightnet_pool_plain(feats, pw)
        errs["weightnet_pool"] = (float((w_k - w_p).abs().max()),
                                  1e-4 * max(float(w_p.abs().max()), 1.0))
        times = {
            "whole_sample": time_ms(lambda: ksamp.whole_sample(hm, rc, cfg)),
            "centernet": time_ms(lambda: kcn.centernet_forward(pc, bev)),
            "person_planes": time_ms(lambda: ksamp.person_planes(
                hm, rc, cfg, props[..., :3], props[..., 5:7], mask),
                spin=LONG_SPIN),
            "soft_argmax": time_ms(lambda: ksa.soft_argmax(fl, grid,
                                                           cfg.beta)),
            "weightnet_pool": time_ms(lambda: kwn.weightnet_pool(feats, pw)),
        }
    log(f"eval kernels at B = {B}, P = {B * K} ({int(mask.sum())} people "
        "kept; person_planes samples only those), each against its plain "
        "version on the same inputs, and timed against B = 1 (phase 3; "
        "person_planes there: 10 full cubes):")
    for name, ms in times.items():
        err, tol = errs[name]
        rows[name].update(eval_batch_ms=ms, eval_batch_max_abs_err=err,
                          eval_batch_tol=tol)
        log(f"  {name:15s} max_abs_err {err:.3e} (tol {tol:.1e}); "
            f"{ms:8.4f} ms at B = {B}, {rows[name]['ms']:8.4f} ms at B = 1 "
            f"({ms / rows[name]['ms']:.2f}x)")
        held(name, err, tol, f" at B = {B}")


# ---------------------------------------------------------------------------
# 9. training
# ---------------------------------------------------------------------------

TRAIN_PATH = {"whole_sample": 1, "person_planes": 1}
TRAIN_IMAGE_PATH = {"stem": 1, "deconv_stage": 3, "whole_sample": 1,
                    "person_planes": 1}


def step_launches(K, before, per_step, what) -> dict:
    """The launches since `before` are exactly `per_step` (every other
    kernel 0); returns the counts now."""
    now = launch_counts(K)
    delta = {k: now[k] - before[k] for k in now}
    want = {k: per_step.get(k, 0) for k in now}
    if delta != want:
        raise AssertionError(f"{what}: launches {delta}, expected {want}")
    return now


def _params(module) -> list:
    return [p.detach().clone() for p in module.parameters()]


def _changed(before, module) -> bool:
    import torch

    return any(not torch.equal(a, p) for a, p in zip(before,
                                                     module.parameters()))


def train_phase(K, smi):
    """Phase 9: the trainer on the card. EVAL_CFG's training protocol at
    full width and its train batch of 8 (seq_grouped_batches, device
    render with augmentation), the model from the port's 'flax' init of a
    seeded generator; TRAIN_WARMUP + TRAIN_STEPS steps, each timed on the
    host clock between two synchronisations, each launching K1 once and
    K2 once (with its layout) and no other kernel; the HDN moving on the
    accumulation window's k-th steps only, the JLN exactly when the joint
    loss is > 0; peak memory, a profile of a step, K1 and K2 against their
    plain versions on a training batch's tensors; the first step card
    against CPU; then image-source steps through the frozen ResNet-50.
    Returns (launches over the timed run, results)."""
    import torch
    from fvp_torch.config import load_config
    from fvp_torch.data.loader import seq_grouped_batches
    from fvp_torch.data.registry import build_dataset
    from fvp_torch.engine.init import flax_init
    from fvp_torch.engine.train import Trainer, step_inputs
    from fvp_torch.geometry.grids import build_rig_constants
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose
    from fvp_torch.ops.heatmap_render import render_heatmaps_device
    from fvp_torch.ops.kernels import sampler as ksamp

    dev = torch.device("cuda")
    cfg = load_config(EVAL_CFG, synthetic_num_data=TRAIN_SCENES)
    ds = build_dataset(cfg.train_dataset, cfg, is_train=True)
    batches = list(seq_grouped_batches(ds, cfg.batch_size, cfg.seed, 0))
    n = TRAIN_WARMUP + TRAIN_STEPS
    if len(batches) < n:
        raise AssertionError(f"{len(batches)} batches for {n} steps")
    rc = build_rig_constants(cfg, ds.rigs["synthetic"]).to(dev)
    model = FasterVoxelPose(cfg)
    flax_init(model, torch.Generator().manual_seed(cfg.seed))
    init_state = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(cfg, model, dev)
    hdn, jln = model.pose_net, model.joint_net
    k = cfg.accumulation_steps
    log(f"train phase: {EVAL_CFG}, {len(ds)} training scenes of up to "
        f"{cfg.synthetic_max_people} people, batch {cfg.batch_size}, "
        f"{cfg.num_views} views of {cfg.heatmap_size} heatmaps rendered on "
        f"the card (augmentation {ds.data_augmentation}), "
        f"{cfg.voxels_per_axis} space, K = {cfg.max_people} in "
        f"{cfg.ind_voxels_per_axis} cubes, {cfg.compute_dtype}, lr "
        f"{cfg.lr}, HDN window k = {k}, init 'flax' (generator seed "
        f"{cfg.seed})")

    inputs = [step_inputs(b, dev) for _, b in batches[:n]]
    K.reset_launches()
    counts = launch_counts(K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, moved = [], [], []
    for i, (x, targets, meta) in enumerate(inputs):
        h0, j0 = _params(hdn), _params(jln)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ls = trainer.train_step(x, rc, targets, meta)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        counts = step_launches(K, counts, TRAIN_PATH, f"train step {i}")
        ls = {key: float(v) for key, v in ls.items()}
        losses.append(ls)
        moved.append((_changed(h0, hdn), _changed(j0, jln)))
        if not all(np.isfinite(v) for v in ls.values()):
            raise AssertionError(f"train step {i}: losses {ls}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    timed = step_ms[TRAIN_WARMUP:]
    med = statistics.median(timed)
    log(f"train on {smi}: {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up, "
        f"median {med:.3f} ms ({min(timed):.3f} .. {max(timed):.3f}), "
        f"{cfg.batch_size * 1e3 / med:.2f} scenes/s; peak memory "
        f"{peak:.3f} GB (max_memory_allocated)")
    log(f"train step ms: {', '.join(f'{t:.2f}' for t in step_ms)}")
    for i, (ls, (mh, mj)) in enumerate(zip(losses, moved)):
        log(f"  step {i:2d}: total {ls['total']:.5f} 2d "
            f"{ls['2d_heatmaps']:.6f} 1d {ls['1d_heatmaps']:.5f} bbox "
            f"{ls['bbox']:.5f} joint {ls['joint']:.3f}; HDN moved {mh}, "
            f"JLN moved {mj}")
        if mh != ((i + 1) % k == 0):
            raise AssertionError(f"train step {i}: HDN moved {mh}, window "
                                 f"of {k}")
        if mj != (ls["joint"] > 0):
            raise AssertionError(f"train step {i}: JLN moved {mj}, joint "
                                 f"loss {ls['joint']}")
    if not any(ls["joint"] > 0 for ls in losses):
        raise AssertionError("no training step matched a person: the JLN "
                             "never trained")
    log(f"train path: {n} steps, launches {counts}; each step "
        f"{TRAIN_PATH} (person_planes with its layout kernel), every "
        "other kernel 0")

    # where a step's time goes, and the splat alone
    profile_frames(lambda a: trainer.train_step(a[0], rc, *a[1:]),
                   [inputs[0]], n=2, unit="step",
                   groups=TRAIN_PROFILE_GROUPS)
    x0 = inputs[0][0]
    with torch.inference_mode():
        splat_ms = time_ms(lambda: render_heatmaps_device(
            cfg, *(x0[key] for key in ("mu", "vis", "sigma", "scale",
                                       "occ"))), reps=10, spin=LONG_SPIN)
    log(f"train step parts, alone: the splat {splat_ms:.3f} ms")

    # K1 and K2 on the training batch's tensors against their plain
    # versions (phase 3's tolerances), the proposals matched in train mode
    with torch.no_grad():
        hm = trainer.heatmaps(x0)
        props = model.detect(hm, rc, None, True, inputs[0][2])["proposals"]
        mask = props[..., 3] >= 0
        vol = ksamp.whole_sample(hm, rc, cfg)
        err_ws = float((vol - ksamp.whole_sample_plain(hm, rc, cfg))
                       .abs().max())
        planes, _ = ksamp.person_planes(hm, rc, cfg, props[..., :3],
                                        props[..., 5:7], mask)
        corner, start, end, _ = ksamp.person_bounds(
            props[..., :3], props[..., 5:7], mask, cfg)
        err_pp = float((planes - ksamp.person_planes_plain(
            hm, rc, cfg, corner, start, end)).abs().max())
    log(f"train kernels on batch 0's tensors (B = {hm.shape[0]}, P = "
        f"{props.shape[0] * props.shape[1]}, {int(mask.sum())} matched): "
        f"whole_sample max_abs_err {err_ws:.3e} (tol 1e-05), "
        f"person_planes {err_pp:.3e} (tol 1e-04)")
    held("whole_sample", err_ws, 1e-5, " on the training batch")
    held("person_planes", err_pp, 1e-4, " on the training batch")

    train_card_vs_cpu(cfg, init_state, batches[0][1], ds)
    image_ms = train_image_steps(K, cfg, init_state, batches[0][1],
                                 ds.rigs["synthetic"], smi)
    return counts, {"step_ms": step_ms, "step_ms_median": med,
                    "peak_gb": peak, "losses": losses,
                    "image_step_ms": image_ms}


def pre_bn_biases(model) -> set:
    """Names of the conv biases that feed a BatchNorm: in train mode the
    BatchNorm removes any constant, so their exact gradient is 0 and what
    either device computes for them is float32 summation noise (over 15M
    terms for WeightNet's conv)."""
    import torch

    names = set()
    for prefix, m in model.named_modules():
        if isinstance(m, torch.nn.Sequential):
            kids = list(m.named_children())
            for (a, conv), (_, bn) in zip(kids, kids[1:]):
                if isinstance(conv, (torch.nn.Conv1d, torch.nn.Conv2d,
                                     torch.nn.ConvTranspose1d,
                                     torch.nn.ConvTranspose2d)) \
                        and isinstance(bn, torch.nn.modules.batchnorm
                                       ._BatchNorm):
                    names.add(f"{prefix}.{a}.bias")
    return names


def train_card_vs_cpu(cfg, init_state, batch, ds) -> None:
    """The first step from the same weights on the card and on the CPU, on
    `batch` at full width: the losses (the joint loss > 0: people
    matched), every gradient but those of `pre_bn_biases` and every new
    BatchNorm statistic within the stated tolerances (worst of each
    printed)."""
    import torch
    from fvp_torch.engine.train import Trainer, step_inputs
    from fvp_torch.geometry.grids import build_rig_constants
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose

    runs = {}
    for device in ("cuda", "cpu"):
        model = FasterVoxelPose(cfg)
        model.load_state_dict(init_state)
        tr = Trainer(cfg, model, device)
        rc = build_rig_constants(cfg, ds.rigs["synthetic"]).to(device)
        x, targets, meta = step_inputs(batch, device)
        t = time.perf_counter()
        ls = tr.train_step(x, rc, targets, meta)
        ls = {key: float(v) for key, v in ls.items()}
        runs[device] = (ls, {name: p.grad.detach().cpu() for name, p in
                             model.named_parameters()},
                        {key: v.detach().cpu() for key, v in
                         model.state_dict().items() if "running" in key},
                        time.perf_counter() - t)
    (lg, gg, sg, tg), (lc, gc, sc, tc) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(lg[key] - lc[key]) / max(abs(lc[key]), 1e-12)
                   for key in lc)
    net_scale = {}
    for name, g in gc.items():
        net = ".".join(name.split(".")[:2])
        net_scale[net] = max(net_scale.get(net, 0.0), float(g.abs().max()))
    zero = pre_bn_biases(FasterVoxelPose(cfg))
    grad_worst, grad_name, noise = 0.0, "", 0.0
    for name, g in gc.items():
        net = ".".join(name.split(".")[:2])
        err = float((gg[name] - g).abs().max())
        if name in zero:
            noise = max(noise, err / net_scale[net])
            continue
        tol = TRAIN_GRAD_RTOL * float(g.abs().max()) \
            + TRAIN_GRAD_NET_RTOL * net_scale[net]
        r = err / tol if tol > 0 else (0.0 if err == 0 else float("inf"))
        if r > grad_worst:
            grad_worst, grad_name = r, name
    stats_worst = max(float((sg[key] - v).abs().max())
                      / max(float(v.abs().max()), 1e-12)
                      for key, v in sc.items())
    log(f"train first step card vs CPU (batch 0, all {cfg.batch_size} "
        f"scenes at full width; the CPU step took {tc:.1f} s): joint loss "
        f"{lc['joint']:.3f}; losses within {loss_err:.3e} relative (tol "
        f"{TRAIN_LOSS_RTOL:.0e}); gradients within {grad_worst:.3f} of "
        f"their tolerance ({TRAIN_GRAD_RTOL:.0e} x the tensor's max-abs + "
        f"{TRAIN_GRAD_NET_RTOL:.0e} x its net's; worst {grad_name}); the "
        f"{len(zero)} conv biases before a BatchNorm (exact gradient 0) "
        f"apart by up to {noise:.3e} of their net's largest gradient "
        f"(float32 noise, not held); new BatchNorm statistics within "
        f"{stats_worst:.3e} of their tensors' max-abs (tol "
        f"{TRAIN_STATS_RTOL:.0e})")
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_worst <= 1.0
            and stats_worst <= TRAIN_STATS_RTOL and lc["joint"] > 0):
        raise AssertionError("the first training step differs between the "
                             "card and the CPU")


def train_image_steps(K, cfg, init_state, batch, rig, smi) -> list:
    """TRAIN_IMAGE_STEPS image-source steps at batch TRAIN_IMAGE_BATCH
    through the frozen float32 ResNet-50 (seeded) at 960x512: each launches
    the stem once, the deconv head's three stages, K1 and K2, and nothing
    else; the losses finite; the backbone unchanged. Returns the steps'
    host-clock ms."""
    import torch
    from fvp_torch.engine.train import Trainer
    from fvp_torch.geometry.grids import build_rig_constants
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose
    from fvp_torch.models.resnet import PoseResNet, seeded_state_dict

    dev = torch.device("cuda")
    b = TRAIN_IMAGE_BATCH
    cfg_img = cfg.replace(train_heatmap_src="image")
    backbone = PoseResNet(cfg.num_joints, cfg.resnet_layers)
    backbone.load_state_dict(seeded_state_dict(backbone, seed=0))
    model = FasterVoxelPose(cfg_img)
    model.load_state_dict(init_state)
    tr = Trainer(cfg_img, model, dev, backbone=backbone)
    before = [p.detach().clone() for p in backbone.parameters()]
    images = torch.as_tensor(seeded_images(cfg_img, seed=1, frames=b),
                             device=dev)
    targets, meta = ({key: torch.as_tensor(v[:b], device=dev)
                      for key, v in batch[part].items()}
                     for part in ("targets", "meta"))
    rc = build_rig_constants(cfg_img, rig).to(dev)
    K.reset_launches()
    counts = launch_counts(K)
    ms = []
    for i in range(TRAIN_IMAGE_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ls = tr.train_step(images, rc, targets, meta)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        counts = step_launches(K, counts, TRAIN_IMAGE_PATH,
                               f"image train step {i}")
        ls = {key: float(v) for key, v in ls.items()}
        if not all(np.isfinite(v) for v in ls.values()):
            raise AssertionError(f"image train step {i}: losses {ls}")
    if any(not torch.equal(a, p) for a, p in zip(before,
                                                  backbone.parameters())):
        raise AssertionError("the frozen backbone moved")
    log(f"train image source on {smi}: {TRAIN_IMAGE_STEPS} steps at batch "
        f"{b} through the frozen float32 ResNet-50 at "
        f"{cfg_img.image_size}: {', '.join(f'{t:.2f}' for t in ms)} ms "
        f"(the first with its warm-up); launches {counts}; losses finite, "
        "backbone unchanged")
    return ms


def numpy_render(ds, rec: int, x, b: int, render) -> np.ndarray:
    """Record `rec`'s views rendered by the numpy renderer `render` with
    the augmentation draws packed in row b of the render parameters x:
    (V, J, h, w)."""
    views_2d, views_vis = ds._project_gt_views(ds.records[rec])
    return np.stack([
        render(ds.cfg, j2d, joints_vis=jv, augment=ds.data_augmentation,
               draws=(x["scale"][b, v].cpu().numpy(),
                      x["occ"][b, v].cpu().numpy()))
        for v, (j2d, jv) in enumerate(zip(views_2d, views_vis))])


class Collect:
    """The service's result sink (ServiceConfig.on_result): called in the
    spawned visualization process, it sends each result's numbers back
    through a queue. A module-level class, so that it pickles across the
    spawn."""

    def __init__(self, q):
        self.q = q

    def __call__(self, res) -> None:
        self.q.put({"timestamp": res["timestamp"],
                    "latency_ms": res["latency_ms"], "fps": res["fps"],
                    "people": int((res["poses"][:, 0, 3] >= 0).sum())})


def service_phase(K, state, bb_state, rig, smi):
    """Phase 10: the streaming service at the reference's serving
    configuration, (a) as users run it, (b) its inference process in this
    process with the launch counts, (c) the msgpack layout of the same
    weights. Returns (launches of (b), numbers)."""
    import os
    import queue
    import tempfile

    import torch

    from fvp_torch.config import FVPConfig
    from fvp_torch.engine import flax_msgpack
    from fvp_torch.engine.checkpoint import (load_backbone_state,
                                             load_model_state)
    from fvp_torch.engine.serve import Predictor
    from fvp_torch.models.convert import (to_jax_backbone_variables,
                                          to_jax_variables)
    from fvp_torch.service import pipeline
    from fvp_torch.service.sources import SPAWN, FrameQueue

    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    model_pth = os.path.join(d, "model_best.pth")
    bb_pth = os.path.join(d, "pose_resnet50.pth")
    torch.save(state, model_pth)
    torch.save(bb_state, bb_pth)
    cfg = FVPConfig(min_score=MIN_SCORE_BF16, compute_dtype="bfloat16",
                    pretrained_backbone=bb_pth)
    log(f"service phase: FVPConfig() at compute_dtype='bfloat16', "
        f"{cfg.num_views} views of {cfg.image_size[0]}x{cfg.image_size[1]}, "
        f"heatmaps {cfg.heatmap_size[0]}x{cfg.heatmap_size[1]}, space "
        f"{cfg.voxels_per_axis}, K = {cfg.max_people} in "
        f"{cfg.ind_voxels_per_axis} cubes, ResNet-{cfg.resnet_layers}; "
        f"weights from {os.path.basename(model_pth)} and "
        f"{os.path.basename(bb_pth)}")

    # (a) run_service on the card: spawned source, inference and viz
    sink = SPAWN.Queue()
    out_dir = os.path.join(d, "jpg")
    t0 = time.perf_counter()
    died = pipeline.run_service(pipeline.ServiceConfig(
        checkpoint=model_pth, num_views=cfg.num_views,
        max_frames=SERVICE_FRAMES, view_mode="save", output_dir=out_dir,
        on_result=Collect(sink), cfg_obj=cfg, device="cuda"))
    wall = time.perf_counter() - t0
    got = []
    while True:
        try:
            got.append(sink.get(timeout=1.0))
        except queue.Empty:
            break
    jpgs = len(os.listdir(out_dir)) if os.path.isdir(out_dir) else 0
    if died is not None:
        raise AssertionError(f"service: the {died} process died")
    if not got or jpgs < 1:
        raise AssertionError(f"service: {len(got)} results, {jpgs} JPEGs")
    got.sort(key=lambda r: r["timestamp"])
    lat = [r["latency_ms"] for r in got]
    steady = lat[SERVICE_WARMUP:] or lat
    p90 = float(np.percentile(steady, 90))
    log(f"service (run_service, spawned source/inference/viz, save mode) "
        f"on {smi}: stopped by itself after {SERVICE_FRAMES} frames in "
        f"{wall:.1f} s (process start-up included), no child died; "
        f"{len(got)} results reached the viz process (the queues drop the "
        f"oldest), {jpgs} JPEGs; the pipeline's latency_ms median "
        f"{statistics.median(steady):.3f}, p90 {p90:.3f} over "
        f"{len(steady)} results (first {SERVICE_WARMUP} excluded: "
        f"{', '.join(f'{x:.1f}' for x in lat[:SERVICE_WARMUP])}); its fps "
        f"{got[-1]['fps']:.2f} at the last result; people above the gate "
        f"{[r['people'] for r in got]}")

    # (b) its inference process here, on FRAMES seeded frames at the
    # working size, with the launch counts
    rng = np.random.RandomState(11)
    w, h = cfg.image_size
    frames = [[rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
               for _ in range(cfg.num_views)] for _ in range(FRAMES)]
    frame_q, result_q = FrameQueue(maxsize=FRAMES), \
        FrameQueue(maxsize=FRAMES)
    for q in (frame_q, result_q):
        q.q.cancel_join_thread()     # a failure must not hang the exit
    for i, views in enumerate(frames):
        frame_q.put((float(i), views))
    stop = SPAWN.Value("i", 0)
    svc = pipeline.ServiceConfig(checkpoint=model_pth,
                                 num_views=cfg.num_views, max_frames=FRAMES,
                                 view_mode="none", cfg_obj=cfg,
                                 device="cuda")
    K.reset_launches()
    pipeline.inference_process(svc, frame_q, result_q, stop)
    torch.cuda.synchronize()
    launches = launch_counts(K)
    results = [result_q.get(timeout=10.0) for _ in range(FRAMES)]
    log(f"service inference process: {FRAMES} frames, launches {launches}")
    expect_launches(launches, BF16_IMAGE_PATH, "service path")
    expect_per_frame(launches, {"stem": 1, "deconv_stage": 3},
                     "service path")
    expect_conv_routes(K, "bottleneck_stage", FRAMES, STAGE_ROUTES)
    in_lat = [r["latency_ms"] for r in results]
    log_latency(f"service inference process latency_ms on {smi} "
                "(prepare on the host, copy, Predictor, poses to the host)",
                in_lat)
    pred = Predictor.from_state_dict(
        cfg, load_model_state(model_pth), rig, device="cuda",
        backbone_state_dict=load_backbone_state(bb_pth))
    ref = pred(pipeline._frames_to_images(cfg, frames[0]))["fused_poses"]
    ref = ref[0].cpu().numpy()
    got0 = results[0]["poses"]
    same = got0.shape == ref.shape and np.array_equal(got0, ref)
    err = float(np.abs(got0 - ref).max()) if got0.shape == ref.shape \
        else float("inf")
    log(f"service frame 0 poses {got0.shape} against Predictor(prepare("
        f"frame 0)) built here from the same files: bitwise equal {same} "
        f"(max_abs_err {err:.3e} mm); {int((ref[:, 0, 3] >= 0).sum())} "
        f"people above the gate")
    if not same or not np.isfinite(got0).all():
        raise AssertionError("service: frame 0's poses differ from a "
                             "direct Predictor call")

    # where a service frame's time goes: its steps one by one on frames
    # 1..5 (warm)
    parts = {"prepare (_frames_to_images, host)": [],
             "copy to the card (pageable)": [],
             "Predictor on the card's frame": [], "poses to the host": []}
    for views in frames[1:6]:
        t = [time.perf_counter()]
        x = pipeline._frames_to_images(cfg, views)
        t.append(time.perf_counter())
        xt = torch.as_tensor(x, device="cuda")
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = pred(xt)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out["fused_poses"][0].cpu().numpy()
        t.append(time.perf_counter())
        for name, a, b in zip(parts, t, t[1:]):
            parts[name].append((b - a) * 1e3)
    log(f"service frame by step on {smi} (medians of 5 frames, host "
        f"clock):")
    for name, ms in parts.items():
        log(f"  {statistics.median(ms):8.3f} ms  {name}")

    # (c) the same weights in the reference's flax msgpack layout
    model_msg = os.path.join(d, "model_best.msgpack")
    bb_msg = os.path.join(d, "pose_resnet50.msgpack")
    with open(model_msg, "wb") as f:
        f.write(flax_msgpack.dumps(to_jax_variables(state)))
    with open(bb_msg, "wb") as f:
        f.write(flax_msgpack.dumps(to_jax_backbone_variables(bb_state)))
    for what, msg, pth, load in (
            ("model", model_msg, model_pth, load_model_state),
            ("backbone", bb_msg, bb_pth, load_backbone_state)):
        a, b = load(msg), load(pth)
        keys = [k for k in b if not k.endswith("num_batches_tracked")]
        if set(a) != set(b) or not all(torch.equal(a[k], b[k])
                                       for k in keys):
            raise AssertionError(f"service: the {what} msgpack loads to "
                                 "other weights than the .pth")
        log(f"msgpack {what}: {os.path.getsize(msg) / 1e6:.1f} MB in the "
            f"reference's flax layout loads to the .pth's {len(keys)} "
            f"tensors, bit for bit")
    tmp.cleanup()
    return launches, {"latency_ms": lat, "fps": got[-1]["fps"],
                      "inprocess_latency_ms": in_lat,
                      "parts_ms": {k: statistics.median(v)
                                   for k, v in parts.items()}}


def check_fused(got, ref, label, tol_mm: float = 5e-2) -> None:
    """Fused poses (B, K, J, 5) of the card against the CPU's: identical
    masks, finite, within tol_mm."""
    import torch

    if not torch.equal(got[..., 0, 3] >= 0, ref[..., 0, 3] >= 0):
        raise AssertionError(f"{label}masks differ between card and CPU")
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}shape {tuple(got.shape)} or "
                             "non-finite")
    err = float((got - ref).abs().max())
    log(f"{label}fused_poses {tuple(got.shape)}: card vs CPU max_abs_err "
        f"{err:.3e} mm (tol {tol_mm:.0e} mm)")
    if not err <= tol_mm:
        raise AssertionError(f"{label}fused_poses differ between card and "
                             "CPU")


def profile_frames(pred, frames, n: int = 3, unit: str = "frame",
                   groups=None) -> None:
    """Device time by kernel over n frames (torch.profiler), and the share
    of the window in which the card was busy. Prints "not measured" where
    the profiler records no device time. `unit` names what `pred` takes
    (a frame, or the eval phase's batch); `groups`, [(kind, substrings of
    kernel names)], also sums the device time by kind, the first match
    winning."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(n):
            pred(frames[i % len(frames)])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): a host op's row also
        # carries its kernels' time, which would count them twice
        if e.device_type != DeviceType.CUDA or e.key.startswith("Activity"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log("profile: device time not measured (no device events)")
        return
    units = unit + ("es" if unit.endswith("h") else "s")
    log(f"profile over {n} {units}: device busy {busy / n / 1e3:.3f} ms per "
        f"{unit} of {wall_us / n / 1e3:.3f} ms wall under the profiler "
        f"({100 * busy / wall_us:.1f}% busy)")
    for us, count, key in sorted(rows, reverse=True)[:15]:
        log(f"  {us / n / 1e3:8.4f} ms/{unit}  {count / n:6.1f} "
            f"calls/{unit}  {key[:90]}")
    if groups:
        sums = dict.fromkeys([g for g, _ in groups] + ["other"], 0.0)
        for us, _, key in rows:
            sums[next((g for g, marks in groups
                       if any(m in key for m in marks)), "other")] += us
        idle = 100 * (1 - busy / wall_us)
        log(f"  by kind, ms/{unit}: " + ", ".join(
            f"{g} {v / n / 1e3:.3f}" for g, v in sums.items())
            + f"; the card idle (the host's share) {idle:.1f}% of the wall")


def _leaves(tree):
    if isinstance(tree, (dict, list, tuple)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    elif tree is not None:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
