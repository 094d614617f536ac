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
   launch per call, its GB/s and two calls bitwise equal; and the bf16
   routes that compute_dtype='bfloat16' takes for CenterNet (one launch of
   the persistent bf16 kernel a call, its 16 stages each launched alone,
   beside the earlier route of 24 bf16 conv launches and 2 pools timed in
   the same run as a yardstick) and WeightNet's pool (the banded mma.sync
   kernel, one launch, its plan and GB/s) at B = 1 (frame 0's BEV map,
   P2PNet's features of K2's planes) and at the eval batch (B = 8, P =
   80), each against its plain version, two calls bitwise equal, with its
   bound at bf16's rate and, as its library call, the cuDNN CenterNet
   module in bf16 and a bf16 conv2d;
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
   layer1 (10 conv_wgmma launches a frame), the deconv head (3 a frame),
   K1, K2, K4 and the bf16 routes of CenterNet (1 a frame) and
   WeightNet's pool (1 a frame) ran and nothing else did (the earlier
   layer-by-layer CenterNet route not at all), prints its latency and
   profile beside the same predictor's on the float32 CenterNet and pool
   kernels (in this run), its
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
   frozen float32 ResNet-50 (stem, deconv head, K1, K2 a step), and the
   same 2 at compute_dtype='bfloat16' from the same weights and images
   (the bottleneck stage's 10 launches on layer1 besides; the first
   step's losses within TRAIN_BF16_LOSS_RTOL of float32's); then the
   same steps at compute_dtype='bfloat16' (the nets in bf16 as flax builds
   them) from the same weights: launches, median step and peak memory
   beside float32's, a profile by kind, and the first step's losses
   finite and within TRAIN_BF16_LOSS_RTOL of the float32 first step's on
   the same batch; and the scenes rendered on the host through the native
   renderer (fvp_torch/data/native.py, built here at first use): the same
   maps as the numpy renderer without augmentation, and its time a scene;
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
    deconv head (3 a frame), K1, K2, K4 and the bf16 routes of CenterNet
    and WeightNet's pool ran and nothing else did, and
    frame 0's poses equal, bit for bit, a Predictor built here from the
    same files on the same prepared frame; (c) the same weights written
    in the reference's flax msgpack layout load to the same state dicts
    as the torch files;
11. drives the view-sharded step (fvp_torch/parallel/) and the service's
    multi-host flags on the card, at the bf16 image configuration and the
    float32 heatmap one: K1's sum mode against its plain version (one view
    and all five; view_mean of the five-view sum bit for bit the mean
    mode's volume); (a) a (1, 1) mesh over NCCL in this process, FRAMES
    frames with every launch count set to 0 just before: K1 in sum mode
    and every kernel of the path ran, frame 0 bit for bit the unsharded
    Predictor's, both latencies; (b) SHARD_RANKS spawned ranks sharing
    the card over gloo on a (1, 5) mesh (one view and 2 of the 10 people a
    rank), FRAMES frames each with the counts set to 0 just before:
    every kernel of the path ran on every rank, the ranks agree, rank 0's
    frame 0 against the unsharded frame (bf16: the unsharded HDN+JLN on
    the same per-view heatmaps at the same gate, identical masks, within
    SHARD_BF16_TOL_MM a person with the same voxel pick, a z pick flipped
    only on a near-tie, as phase 7; float32: identical masks, within 5e-2
    mm), the bytes
    staged through host memory a frame and the latency, which is no
    scaling figure; (c) `run_service` with a coordinator at one host
    (spawned, COORD_FRAMES frames) and its inference process in this
    process with the counts: frame 0 bit for bit a direct Predictor
    call's;
12. drives the spatial ('data', 'space') pipeline mesh and the
    data-parallel train step (fvp_torch/parallel/) on the card, at the
    float32 heatmap configuration and phase 9's training batches: (a) a
    (1, 1) pipeline mesh over NCCL in this process, FRAMES frames with
    every launch count set to 0 just before: every kernel of the heatmap
    path ran and frame 0 is bit for bit the unsharded Predictor's; (b)
    SPATIAL_RANKS spawned ranks sharing the card over gloo on a (1, 4)
    pipeline mesh (20 x-rows a rank), FRAMES frames each with the counts
    set to 0 just before: K1 (on its rows), person_planes, soft_argmax and
    weightnet_pool ran on every rank and centernet on none; each rank
    holds K1's row block, person_planes, soft_argmax and weightnet_pool
    against their plain versions on its tensors, spatial_centernet's maps
    against the whole cuDNN module (within SPATIAL_CN_TOL) and
    sharded_nms_topk_2d bit for bit against the whole-map NMS; rank 0's
    frame 0 against the unsharded frame (identical masks, at least two
    people through a gate clear of every confidence, within 5e-2 mm), the
    bytes staged a rank a frame and rank 0's latency; (c) the sharded
    train step on a (1, 1) mesh over NCCL, two steps with the counts set
    to 0 just before, bit for bit Trainer.train_step (losses, parameters,
    running statistics); (d) the sharded train step on a (2, 1) mesh of
    two of (b)'s ranks, 4 scenes a rank, two steps with the counts set to
    0 just before: K1 in sum mode and person_planes once a rank a step
    and held against their plain versions, against (c)'s Trainer on the
    same two steps (losses and running statistics after each, parameters
    after both; tests/test_torch_train_lockstep.py's tolerances), the
    step time and peak memory a rank; (c) and (d) start from the smoke's
    seeded weights;
13. drives Shelf and Campus at full width (configs/shelf/jln64.yaml: 5
    views, 17 joints, 200x152 heatmaps, an 8000 mm space, K = 10;
    configs/campus/jln64.yaml: 3 views, 200x160, 12000 mm, K = 5), each
    from a tree written by fvp_torch/tools/fixtures.py (no real data
    ships): (a) the pose library built by `python -m
    fvp_torch.tools.extract_training_poses --coco17` in a subprocess; (b)
    SC_TRAIN_WARMUP + SC_TRAIN_STEPS train steps at the batch of 8 on the
    synthetic factory fed by that library (rendered by the device splat),
    each launching K1 and K2 once and nothing else, the first held
    against the CPU as in phase 9; (c) run_validation over SC_TEST_FRAMES
    test frames at batch 8 (the 'pred' source: the native host renderer,
    then the card) with the counts set to 0 just before, at a gate chosen
    from the card's confidences (replacing MIN_SCORE 0.1), against the
    same call on the CPU (the PCP dict equal, identical masks, within 5e-2
    mm), K1-K5 on batch 0 against their plain versions; (d) the same eval
    with fuse_p2p (P2PNet and C2CNet as kernels at B = 8) against (c)
    (within FUSE_POSE_TOL_MM) and the two kernels against their plain
    versions on batch 0's planes and columns; (e) one heatmap frame
    through Predictor, FRAMES times with the counts set to 0 just before,
    frame 0 against the CPU;
14. prints one JSON line of the kernels, then the result line.

float32 outside the bf16 kernels and the bf16 path: TF32 is switched off
for cuDNN convs and matmuls, so that the card's plain path and the float32
trunk compute in full float32 (the port's entry points switch it off for
their own work whatever the global flags say).
"""

from __future__ import annotations

import copy
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
# The bf16 CenterNet on the card and on the CPU sum in other orders, so a
# bf16 rounding of an activation may land on the other side of a boundary
# and carry on through the net (CENTERNET_BF16_RTOL of its maps' scale
# against the plain version). Two BEV cells whose scores lie within one
# bf16 ulp of the map's scale (2**-8) of each other on the CPU, on the
# card and on the two other routes read on the card's BEV (the plain
# version and the earlier 26-launch route) are a near-tie at the top-K
# boundary: the card may keep the one and the CPU the other, at most
# BF16_MAX_TRADED cells. Frame 0 of the seeded nets trades one: the
# card's (76, 20) for the CPU's (76, 38), 6.5e-4 and 1.4e-3 of the scale
# apart on the CPU and the card.
BF16_HM_TIE_RTOL = 2.0 ** -8
BF16_MAX_TRADED = 1
# phase 11 (b): the 5-rank bf16 frame against the unsharded HDN+JLN on the
# same per-view heatmaps, a person with the same voxel pick. Only the view
# sum's order and P2PNet's batch (6 planes a rank against 30) differ, so
# the float32 configuration's bound holds (2.6e-2 mm on frame 0).
SHARD_BF16_TOL_MM = 5e-2
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
# The bf16 train steps against the float32 steps from the same weights on
# the same batch: each loss of the first step, relative, at bf16's
# tolerance of 2e-2 (the nets round to bf16 at flax's points).
TRAIN_BF16_LOSS_RTOL = 2e-2
# the host render through the native renderer: scenes rendered, and its
# maps against the numpy renderer's without augmentation (the two sum the
# same gaussians in another order: tests/test_torch_native.py)
NATIVE_SCENES = 8
NATIVE_ATOL = 1e-5
# the image-source train steps (a smaller depth than the heatmap ones)
TRAIN_IMAGE_BATCH = 2
TRAIN_IMAGE_STEPS = 2
# The service phase: frames that run_service serves (its synthetic source
# gives 480x640 frames, resized to the working 960x512 on the host), and
# the results of either run taken as warm-up (cuDNN's first calls).
SERVICE_FRAMES = 20
SERVICE_WARMUP = 2
# The sharded phase: ranks sharing the one card over gloo on a (1, 5)
# mesh (one view and 2 of the 10 people a rank), the seconds they may take
# to start, build and serve, and the frames of the service with a
# coordinator.
SHARD_RANKS = 5
SHARD_TIMEOUT = 600.0
# phase 12: the pipeline mesh's ranks sharing the card ((1, 4): 20 x-rows a
# rank), the data-parallel train step's mesh on two of them, the spatial
# CenterNet against the whole cuDNN module (tests/test_spatial.py's 1e-5;
# the halo convs sum over the same terms on smaller images), and the
# sharded train step against the single Trainer after two steps, at
# tests/test_torch_train_lockstep.py's tolerances (losses relative, the
# first step and the later ones; parameters in lr per update, and the
# share of entries more than 1 lr apart; running statistics after each
# step against each tensor's largest entry, the first step and the later
# ones, the later running means with 2 lr a update of room for the conv
# biases before them, whose gradients are float32 noise)
SPATIAL_RANKS = 4
TRAIN_SHARDED_SHAPE = (2, 1)
SPATIAL_CN_TOL = 1e-5
SHARDED_TRAIN_LOSS_RTOL = (1e-5, 5e-4)
SHARDED_TRAIN_LR_PER_UPDATE = 2.0
# Adam's first update moves an entry by at most lr, so an entry whose
# gradient's sign differs (float32 noise) lands 2 lr away exactly, up to
# the float32 rounding of the two parameters (~1e-4 lr here): the bound
# has that much room above 2 lr a update
SHARDED_TRAIN_ROUNDING_LR = 1e-2
SHARDED_TRAIN_FRAC_OVER_LR = 1e-2
SHARDED_TRAIN_STATS_RTOL = (1e-5, 2e-3)
COORD_FRAMES = 10
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
# The bf16 routes against their plain versions on the card: CenterNet's
# whole net at 1e-2 of its maps' scale (a bf16 flip early in the net
# carries on, as P2PNet's; tests/test_torch_kernels_cuda.py), WeightNet's
# pool at one bf16 ulp of its features' scale (its 9 products are exact,
# only their sum's order differs).
CENTERNET_BF16_RTOL = 1e-2
WEIGHTNET_BF16_RTOL = 2.0 ** -8
# the eval batch of the bf16 routes' phase 3 timing: B frames, P people
EVAL_B, EVAL_P = 8, 80
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

        # the bf16 routes of CenterNet and WeightNet's pool, at B = 1 and
        # at the eval batch
        bf16_route_kernels(pred_bf16, pred, frames, feats, rows)

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
    expect_per_frame(bf16_launches, {"centernet_bf16": 1,
                                     "weightnet_pool_bf16": 1},
                     "bf16 image path")
    bf16_steady = lat[WARMUP_FRAMES:]
    log_latency("bf16 image frame latency", lat)
    # the same predictor on the float32 CenterNet and pool kernels (the
    # earlier lowering), in this run
    pred_f32r = copy.copy(pred_bf16)
    pred_f32r.packed = {k: v for k, v in pred_bf16.packed.items()
                        if k not in ("center_net_bf16", "weight_net_bf16")}
    _, lat32, f32r_launches = drive(pred_f32r, img_frames, K)
    if f32r_launches["centernet"] != FRAMES or \
            f32r_launches["centernet_bf16"] != 0:
        raise AssertionError(f"float32 routes: launches {f32r_launches}")
    log_latency("bf16 image frame latency on the float32 CenterNet and "
                "pool kernels", lat32)
    log(f"bf16 image frame median {statistics.median(bf16_steady):.3f} ms "
        f"on the bf16 routes against "
        f"{statistics.median(lat32[WARMUP_FRAMES:]):.3f} ms on the float32 "
        f"routes ({smi})")
    log("bf16 image frame on the float32 CenterNet and pool kernels:")
    profile_frames(pred_f32r, img_frames)
    log("bf16 image frame on the bf16 routes:")
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

    # 11. sharded serving: the view-sharded step and the service's
    # multi-host flags
    sharded_launches, sharded_res = sharded_phase(
        K, state, bb_state, rig, smi, pred, frames, pred_bf16, img_frames,
        rows)

    # 12. the spatial pipeline mesh and the data-parallel train step
    spatial_launches, spatial_res = spatial_phase(K, state, smi, pred,
                                                  frames, train_res)

    # 13. Shelf and Campus at full width, from their synthesised trees
    sc_launches, sc_res = shelf_campus_phase(K, smi, rows)

    kernels = []
    paths = {"heatmap_path": launches, "image_path": img_launches,
             "fuse_p2p_path": fuse_launches,
             "bf16_image_path": bf16_launches, "eval_path": eval_launches,
             "train_path": train_launches, "service_path": service_launches,
             **sharded_launches, **spatial_launches, **sc_launches}
    for name in ("stem", "deconv_stage", "whole_sample", "person_planes",
                 "centernet", "soft_argmax", "weightnet_pool", "p2pnet",
                 "c2cnet", "bottleneck_stage", "centernet_bf16",
                 "weightnet_pool_bf16"):
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
                    "train_image_bf16_step_ms":
                        train_res["image_bf16_step_ms"],
                    "train_bf16_step_ms": train_res["bf16_step_ms"],
                    "train_bf16_step_ms_median":
                        train_res["bf16_step_ms_median"],
                    "train_bf16_peak_memory_gb": train_res["bf16_peak_gb"],
                    "train_bf16_losses": train_res["bf16_losses"],
                    "native_render_ms_per_scene":
                        train_res["native_ms_per_scene"],
                    "bf16_image_frame_ms_median_float32_routes":
                        statistics.median(lat32[WARMUP_FRAMES:]),
                    "tf32_pose_shift_mm": eval_res["tf32_shift_mm"],
                    "service_latency_ms": service_res["latency_ms"],
                    "service_fps": service_res["fps"],
                    "service_inprocess_latency_ms":
                        service_res["inprocess_latency_ms"],
                    "service_parts_ms": service_res["parts_ms"],
                    "sharded": sharded_res,
                    "spatial": spatial_res,
                    "shelf_campus": sc_res,
                    "card": smi}, default=_plain))
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


def bf16_route_kernels(pred16, pred, frames, feats, rows) -> None:
    """Phase 3 for the bf16 routes (compute_dtype='bfloat16'): CenterNet
    on frame 0's BEV map and WeightNet's pool on P2PNet's features of K2's
    planes (B = 1), then on 8 frames' BEV maps and 80 people's features
    (the eval batch), each against its plain version on the same inputs,
    two calls bitwise equal, timed beside the plain version and one
    library call (the cuDNN CenterNet module in bf16 on the bf16 map, a
    bf16 conv2d of the pool's planes), with its bound at bf16's rate;
    CenterNet's launches per call, its plan, each of its stages launched
    alone, and the earlier route of 24 conv and 2 pool launches
    (`run_bf16` on the conv_bf16.cu kernels) timed in the same run as a
    yardstick; the pool's plan and GB/s. The rows carry B = 1's numbers
    and the eval batch's as `eval_batch_*`."""
    import torch
    import torch.nn.functional as F
    from fvp_torch.engine.packing import bf16_copy
    from fvp_torch.ops.kernels import centernet as kcn
    from fvp_torch.ops.kernels import sampler as ksamp
    from fvp_torch.ops.kernels import weightnet as kwn

    cfg, dev = pred16.cfg, pred16.device
    pc = pred16.packed["center_net_bf16"]
    pw = pred16.packed["weight_net_bf16"]
    net16 = bf16_copy(pred16.model.pose_net.center_net,
                      ("output_hm.2", "output_size.2"))
    hm8 = torch.cat([torch.as_tensor(frames[i % len(frames)], device=dev)
                     for i in range(EVAL_B)])
    bev8 = ksamp.whole_sample(hm8, pred16.rc, cfg).amax(dim=3).contiguous()
    reps = -(-EVAL_B * EVAL_P // feats.shape[0])
    feats8 = feats.repeat(reps, 1, 1, 1)[:3 * EVAL_P].contiguous()
    C = pw["w"].shape[1]
    wconv = pw["w"][:9].t().reshape(C, 1, 3, 3).contiguous()
    for tag, bev, f in (("", bev8[:1].contiguous(), feats),
                        ("eval_batch_", bev8, feats8)):
        B, H, W, J = bev.shape
        # CenterNet's bf16 route: one launch of the persistent kernel
        before, layered = kcn.bf16_launches(), kcn.layered_bf16_launches()
        hm_k, size_k = kcn.centernet_bf16(pc, bev)
        per_call = kcn.bf16_launches() - before
        if per_call != 1 or kcn.layered_bf16_launches() != layered:
            raise AssertionError(f"centernet_bf16: {per_call} launches a "
                                 "call, expected 1 (and none of the "
                                 "layer-by-layer route)")
        hm_p, size_p = kcn.centernet_bf16_plain(pc, bev)
        torch.cuda.synchronize()
        scale = float(max(hm_p.abs().max(), size_p.abs().max()))
        err = float(max((hm_k - hm_p).abs().max(),
                        (size_k - size_p).abs().max()))
        again = kcn.centernet_bf16(pc, bev)
        same = bool(torch.equal(again[0], hm_k)
                    and torch.equal(again[1], size_k))
        hm_l, size_l = kcn.run_bf16(pc, bev, kcn._CUDA_BF16)
        torch.cuda.synchronize()
        layered_err = float(max((hm_l - hm_p).abs().max(),
                                (size_l - size_p).abs().max()))
        bev16 = bev.to(torch.bfloat16)
        cn = {"max_abs_err": err, "tol": CENTERNET_BF16_RTOL * scale,
              "ms": time_ms(lambda: kcn.centernet_bf16(pc, bev)),
              "plain_ms": time_ms(lambda: kcn.centernet_bf16_plain(pc, bev)),
              "library_ms": time_ms(lambda: net16.bev_forward(bev16)),
              "layered_ms": time_ms(lambda: kcn.run_bf16(pc, bev,
                                                         kcn._CUDA_BF16)),
              "layered_max_abs_err": layered_err,
              "launches_per_call": per_call}
        cn["bound_ms"], cn["bound_by"] = bound(
            nbytes(bev, hm_k, size_k, pc["wflat"], pc["affflat"]),
            B * conv_flops(pred.packed["center_net"], H, W), PEAK_BF16)
        plan = kcn.centernet_bf16_plan(B, H, W, J)
        arena = torch.empty(plan.arena_elems, dtype=torch.bfloat16,
                            device=dev)
        out = torch.empty(3 * B * H * W, device=dev)
        kcn.launch_bf16(pc, bev, arena, out)
        cn["stage_ms"] = [
            time_ms(lambda s=s: kcn.launch_bf16(pc, bev, arena, out, s,
                                                s + 1))
            for s in range(len(plan.stages))]
        cn["host_enqueue_ms"] = host_ms(lambda: kcn.centernet_bf16(pc, bev))
        log(f"centernet_bf16 {tuple(bev.shape)}: max_abs_err={err:.3e} "
            f"tol={cn['tol']:.3e} ({CENTERNET_BF16_RTOL:.0e} x scale "
            f"{scale:.3e}) kernel_ms={cn['ms']:.4f} plain_ms="
            f"{cn['plain_ms']:.4f} library_ms={cn['library_ms']:.4f} (cuDNN "
            f"CenterNet module in bf16) bound_ms={cn['bound_ms']:.4f} "
            f"({cn['bound_by']}, bf16 at {PEAK_BF16 / 1e12:.0f} TFLOP/s); "
            f"{per_call} launch a call; two calls bitwise equal {same}; the "
            f"earlier 26-launch route {cn['layered_ms']:.4f} ms in this run "
            f"(a yardstick; max_abs_err {layered_err:.3e} from the plain "
            f"version); host_enqueue_ms {cn['host_enqueue_ms']:.4f}")
        log(f"centernet_bf16 plan {tuple(bev.shape)}: {len(plan.stages)} "
            f"stages, {plan.smem_bytes} B of shared memory a block, "
            f"{plan.max_tiles} tiles in the largest stage; each stage "
            "launched alone (device time):")
        for s, (a, b) in enumerate(plan.stages):
            log(f"  stage {s:2d} {cn['stage_ms'][s]:.4f} ms  " + "; ".join(
                f"{op['name']} {op['h']}x{op['w']} {op['cin']}->"
                f"{op['cout']} tile {op['th']}x{op['tw']}x{op['tn']}, "
                f"{op['tiles']} tiles" for op in plan.ops[a:b]))
        held("centernet_bf16", err, cn["tol"], f" at B = {B}")
        if not same:
            raise AssertionError("centernet_bf16: two calls differ")
        # WeightNet's pool, bf16 route
        before = kwn.WEIGHTNET_POOL_BF16.launches
        w_k = kwn.weightnet_pool_bf16(f, pw)
        w_per_call = kwn.WEIGHTNET_POOL_BF16.launches - before
        if w_per_call != 1:
            raise AssertionError(f"weightnet_pool_bf16: {w_per_call} "
                                 "launches a call, expected 1")
        w_p = kwn.weightnet_pool_bf16_plain(f, pw)
        torch.cuda.synchronize()
        err = float((w_k - w_p).abs().max())
        same = bool(torch.equal(kwn.weightnet_pool_bf16(f, pw), w_k))
        Nn, A, Bb, _ = f.shape
        x1 = f.permute(0, 3, 1, 2).reshape(Nn * J, 1, A, Bb) \
            .to(torch.bfloat16).contiguous()
        w16 = wconv.to(torch.bfloat16)
        wn = {"max_abs_err": err,
              "tol": WEIGHTNET_BF16_RTOL * float(w_p.abs().max()),
              "ms": time_ms(lambda: kwn.weightnet_pool_bf16(f, pw)),
              "plain_ms": time_ms(lambda: kwn.weightnet_pool_bf16_plain(f,
                                                                       pw)),
              "library_ms": time_ms(lambda: F.conv2d(x1, w16, padding=1)),
              "launches_per_call": w_per_call}
        wn["bound_ms"], wn["bound_by"] = bound(
            nbytes(f, w_k, *_leaves(pw)), Nn * J * A * Bb * C * 9 * 2.0,
            PEAK_BF16)
        wn["gb_per_s"] = nbytes(f) / wn["ms"] / 1e6
        wplan = kwn.weightnet_bf16_plan(Nn, A, Bb, J)
        log(f"weightnet_pool_bf16 {tuple(f.shape)}: max_abs_err={err:.3e} "
            f"tol={wn['tol']:.3e} (one bf16 ulp of the scale) kernel_ms="
            f"{wn['ms']:.4f} plain_ms={wn['plain_ms']:.4f} library_ms="
            f"{wn['library_ms']:.4f} (bf16 conv2d alone) bound_ms="
            f"{wn['bound_ms']:.4f} ({wn['bound_by']}); "
            f"{wn['gb_per_s']:.1f} GB/s of its {nbytes(f) / 1e6:.1f} MB "
            f"input; two calls bitwise equal {same}; plan: bands of "
            f"{wplan.rows} rows ({wplan.bands} a map), {wplan.joints} joints "
            f"a block, {wplan.blocks} blocks of {wplan.warps} warps, "
            f"{wplan.smem} B shared")
        held("weightnet_pool_bf16", err, wn["tol"], f" at N = {Nn}")
        if not same:
            raise AssertionError("weightnet_pool_bf16: two calls differ")
        for name, src, tpu, m in (
                ("centernet_bf16", "fvp_torch/csrc/centernet_bf16.cu",
                 "fvp_tpu/ops/pallas/hourglass.py:386", cn),
                ("weightnet_pool_bf16", "fvp_torch/csrc/weightnet.cu",
                 "fvp_tpu/ops/pallas/weightnet.py:84", wn)):
            row = rows.setdefault(name, {"name": name, "route": "cuda",
                                         "source": src, "replaces": tpu})
            row.update({tag + k: v for k, v in m.items()})
            row[tag + "shape"] = list(bev.shape if name == "centernet_bf16"
                                      else f.shape)


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
# compute_dtype='bfloat16': CenterNet and the pool on their bf16 routes
BF16_IMAGE_PATH = ("stem", "deconv_stage", "whole_sample", "person_planes",
                   "soft_argmax", "centernet_bf16", "weightnet_pool_bf16",
                   "bottleneck_stage")


def launch_counts(K) -> dict:
    """Launches per kernel of the JSON line: the wrappers' counters, with
    P2PNet's and the stage's routes summed (person_planes: its planes
    kernel, whose layout kernel launches once beside each)."""
    c = {k.name: k.launches for k in K.all_kernels().values()}
    if c["person_planes.layout"] != c["person_planes"]:
        raise AssertionError("person_planes: layout and planes launches "
                             "differ")
    return {"stem": c["stem"], "deconv_stage": c["deconv_stage"],
            "whole_sample": c["whole_sample"] + c["whole_sample.sum"],
            "person_planes": c["person_planes"],
            "centernet": c["centernet"],
            "soft_argmax": c["soft_argmax"],
            "weightnet_pool": c["weightnet_pool"],
            "p2pnet": c["p2pnet.conv.wgmma"] + c["p2pnet.conv.wmma"]
            + c["p2pnet.pool"],
            "c2cnet": c["c2cnet"],
            "bottleneck_stage": c["bottleneck_stage.wgmma"]
            + c["bottleneck_stage.wmma"],
            "centernet_bf16": c["centernet_bf16"],
            "weightnet_pool_bf16": c["weightnet_pool_bf16"],
            # the earlier layer-by-layer bf16 CenterNet (a yardstick of
            # phase 3): on no path
            "centernet_bf16_layers": c["centernet_bf16.conv.wgmma"]
            + c["centernet_bf16.conv.wmma"] + c["centernet_bf16.pool"]}


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
    heatmaps. The card's kernels and the CPU round at other points (the
    BEV maps' and C2CNet scores' differences are printed). Of each side's
    top-K BEV cells, at most BF16_MAX_TRADED that only one side keeps,
    each such pair of cells a near-tie (within BF16_HM_TIE_RTOL of the
    map's scale) on the CPU, on the card and on both witnesses; every cell
    that both keep paired by cell, with identical masks (the gate clear of
    both sides' confidences), each person whose voxel pick agrees within
    BF16_POSE_TOL_MM, and a person whose z pick differs only where
    C2CNet's scores at the two picks are a near-tie on the CPU (within
    BF16_TIE_RTOL of the person's score scale)."""
    import torch
    from fvp_torch.engine.serve import float32_math
    from fvp_torch.ops.kernels import centernet as kcn
    from fvp_torch.ops.kernels import sampler as ksamp
    from fvp_torch.ops.nms import nms_topk_2d

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
    # each side's top-K BEV cells, paired by cell
    hm_cpu, hm_card = d_cpu["hm2d"][0], d_card["hm2d"][0].cpu()
    hm_scale = float(hm_cpu.abs().max())
    K = c_cpu.numel()
    cells_cpu = [tuple(c) for c in
                 nms_topk_2d(hm_cpu[None], K)[1][0].long().tolist()]
    cells_card = [tuple(c) for c in
                  nms_topk_2d(hm_card[None], K)[1][0].long().tolist()]
    log(f"bf16 image path BEV maps, card vs CPU: max_abs_err "
        f"{float((hm_card - hm_cpu).abs().max()):.3e}, scale {hm_scale:.3e}")
    pairs = [(k, cells_cpu.index(c)) for k, c in enumerate(cells_card)
             if c in cells_cpu]
    only_card = [c for c in cells_card if c not in cells_cpu]
    only_cpu = [c for c in cells_cpu if c not in cells_card]
    if len(only_card) > BF16_MAX_TRADED:
        raise AssertionError(f"top-K cells only the card keeps {only_card}, "
                             f"only the CPU {only_cpu}: more than "
                             f"{BF16_MAX_TRADED}")
    if only_card:
        # the witnesses: the route's plain version and its earlier
        # 26-launch lowering on the card's BEV of the same frame (after the
        # path's launches were read)
        pc = pred.packed["center_net_bf16"]
        with torch.inference_mode(), float32_math():
            bev = ksamp.whole_sample(hm, pred.rc, pred.cfg).amax(dim=3)
            bev = bev.contiguous()
            maps = {"CPU": hm_cpu, "card": hm_card,
                    "plain on the card":
                        kcn.centernet_bf16_plain(pc, bev)[0][0, ..., 0].cpu(),
                    "26-launch route on the card":
                        kcn.run_bf16(pc, bev, kcn._CUDA_BF16)[0][0, ..., 0]
                        .cpu()}
        for a, b in zip(only_card, only_cpu):
            gaps = {name: float(m[a] - m[b]) / hm_scale
                    for name, m in maps.items()}
            log(f"bf16 image path top-K cell traded: the card keeps {a}, "
                f"the CPU {b}; score at {a} less score at {b}, over the "
                f"map's scale: {gaps} (tol {BF16_HM_TIE_RTOL:.3e})")
            if max(abs(g) for g in gaps.values()) > BF16_HM_TIE_RTOL:
                raise AssertionError(f"cells {a} and {b} are no BEV "
                                     f"near-tie: {gaps}")
    kc = torch.tensor([k for k, _ in pairs])
    kp = torch.tensor([k for _, k in pairs])
    if len(pairs) < 2 or not torch.equal(got["mask"][0][kc],
                                         ref["mask"][0][kp]):
        raise AssertionError("masks differ between the card and the CPU")
    for k in ("fused_poses", "proposals"):
        if not torch.isfinite(got[k]).all():
            raise AssertionError(f"{k}: non-finite")
    p_card, p_cpu = got["proposals"][0][kc], ref["proposals"][0][kp]
    same = (p_card[:, :3] == p_cpu[:, :3]).all(dim=-1)
    hm1d = d_cpu["hm1d"][0][kp]                              # (pairs, Z)
    hm1d_card = d_card["hm1d"][0].cpu()[kc]
    z_card = hm1d_card.argmax(dim=-1)
    log(f"bf16 image path C2CNet scores, card vs CPU: max_abs_err "
        f"{float((hm1d_card - hm1d).abs().max()):.3e}, scale "
        f"{float(hm1d.abs().max()):.3e}")
    flips = []
    for i in torch.nonzero(~same).flatten().tolist():
        xy_same = bool((p_card[i, :2] == p_cpu[i, :2]).all())
        tie = float(hm1d[i].max() - hm1d[i, z_card[i]])
        scale = float(hm1d[i].abs().max())
        flips.append((int(kp[i]), int(hm1d[i].argmax()), int(z_card[i]),
                      tie / scale))
        if not (xy_same and tie <= BF16_TIE_RTOL * scale):
            raise AssertionError(f"person {int(kp[i])}: voxel picks differ "
                                 f"beyond a z near-tie ({tie / scale:.3e} "
                                 "of scale)")
    err = (got["fused_poses"][0][kc, :, :3]
           - ref["fused_poses"][0][kp, :, :3]).norm(dim=-1).amax(dim=-1)
    kept = err[same]
    log(f"bf16 image path fused_poses: {int(same.sum())} of {K} people "
        f"with the same voxel pick on card and CPU, joint distance max "
        f"{float(kept.max()):.3e} mm (tol {BF16_POSE_TOL_MM} mm), per "
        f"person {[round(float(e), 3) for e in kept]}; z picks that differ "
        f"on a near-tie (CPU person, CPU z, card z, gap / scale): {flips}")
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


def batch_kernels(cfg, e, rc, hm, rows, key="eval_batch",
                  what="eval") -> None:
    """K1-K5 on batch 0's tensors, B = 8 frames and P = B * K people (the
    kept ones sampled by person_planes): each against its plain version on
    the same inputs with phase 3's tolerances, and timed alone (CUDA
    events, as phase 3) beside its B = 1 time there; kept in each row
    under `key`_ms, `key`_max_abs_err and `key`_tol."""
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
        # the coordinates are sums of 4096 float32 terms of the grid's
        # magnitude, which is the space centre's (~1800 mm at Panoptic's,
        # ~5500 at Campus's): the kernel is held at 1e-2 mm of the float64
        # soft-argmax of the same inputs, and at 1e-2 mm or 80 float32
        # ulps of the grid's largest coordinate, whichever is more, of its
        # plain version (whose own float32 sums part from float64 by up to
        # 1.5e-2 mm on Campus's grid); the confidences at 1e-2
        gmax = float(grid.abs().max())
        errs["soft_argmax"] = (float((c_k - c_p).abs().max()),
                               max(1e-2, 80 * float(np.spacing(
                                   np.float32(gmax)))))
        errs["soft_argmax confs"] = (float((p_k - p_p).abs().max()), 1e-2)
        prob64 = torch.softmax(cfg.beta * fl.double(), dim=2)
        c64 = torch.einsum("spnj,snc->spjc", prob64, grid.double())
        d64 = (float((c_k.double() - c64).abs().max()),
               float((c_p.double() - c64).abs().max()))
        errs["soft_argmax float64"] = (d64[0], 1e-2)
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
    log(f"{what} kernels at B = {B}, P = {B * K} ({int(mask.sum())} people "
        "kept; person_planes samples only those), each against its plain "
        "version on the same inputs, and timed against B = 1 (phase 3; "
        "person_planes there: 10 full cubes):")
    for name, ms in times.items():
        err, tol = errs[name]
        rows[name].update({f"{key}_ms": ms, f"{key}_max_abs_err": err,
                           f"{key}_tol": tol})
        log(f"  {name:15s} max_abs_err {err:.3e} (tol {tol:.1e}); "
            f"{ms:8.4f} ms at B = {B}, {rows[name]['ms']:8.4f} ms at B = 1 "
            f"({ms / rows[name]['ms']:.2f}x)")
        held(name, err, tol, f" at B = {B} ({what})")
    err, tol = errs["soft_argmax confs"]
    log(f"  soft_argmax confidences max_abs_err {err:.3e} (tol {tol:.1e}); "
        f"coordinates (grid up to {gmax:.1f} mm) from the float64 "
        f"soft-argmax: kernel {d64[0]:.3e} (tol 1.0e-02), plain version "
        f"{d64[1]:.3e} mm")
    held("soft_argmax confidences", err, tol, f" at B = {B} ({what})")
    held("soft_argmax", *errs["soft_argmax float64"],
         f" at B = {B} ({what}), against the float64 soft-argmax")
    rows["soft_argmax"][f"{key}_float64_err"] = d64[0]


# ---------------------------------------------------------------------------
# 9. training
# ---------------------------------------------------------------------------

TRAIN_PATH = {"whole_sample": 1, "person_planes": 1}
TRAIN_IMAGE_PATH = {"stem": 1, "deconv_stage": 3, "whole_sample": 1,
                    "person_planes": 1}
# compute_dtype='bfloat16': the backbone serves in bf16, layer1 on the
# bottleneck stage kernel (10 conv_wgmma launches a step)
TRAIN_IMAGE_BF16_PATH = {**TRAIN_IMAGE_PATH, "bottleneck_stage": 10}


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
    image_ms, image_first = train_image_steps(
        K, cfg, init_state, batches[0][1], ds.rigs["synthetic"], smi)
    image_bf16_ms, _ = train_image_steps(
        K, cfg, init_state, batches[0][1], ds.rigs["synthetic"], smi,
        "bfloat16", image_first)
    bf16 = train_bf16_steps(K, cfg, init_state, inputs, rc, losses[0],
                            (med, peak), smi)
    native_ms = native_render(cfg)
    return counts, {"step_ms": step_ms, "step_ms_median": med,
                    "peak_gb": peak, "losses": losses,
                    "image_step_ms": image_ms,
                    "image_bf16_step_ms": image_bf16_ms, **bf16,
                    "native_ms_per_scene": native_ms,
                    # for phase 12: the first two batches
                    "batches": [b for _, b in batches[:2]], "cfg": cfg,
                    "rig": ds.rigs["synthetic"]}


def train_bf16_steps(K, cfg, init_state, inputs, rc, first32, ref32,
                     smi) -> dict:
    """Phase 9's steps at compute_dtype='bfloat16' from the same weights
    and batches: each launching K1 and K2 once and nothing else, the
    losses finite, the median step and peak memory beside float32's
    (`ref32`: its median ms and peak GB in this run), a profile of a step
    by kind, and the first step's losses within TRAIN_BF16_LOSS_RTOL of
    the float32 first step's (`first32`) on the same batch."""
    import torch
    from fvp_torch.engine.train import Trainer
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose

    cfg16 = cfg.replace(compute_dtype="bfloat16")
    model = FasterVoxelPose(cfg16)
    model.load_state_dict(init_state)
    tr = Trainer(cfg16, model, torch.device("cuda"))
    K.reset_launches()
    counts = launch_counts(K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for i, (x, targets, meta) in enumerate(inputs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ls = tr.train_step(x, rc, targets, meta)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        counts = step_launches(K, counts, TRAIN_PATH, f"bf16 train step {i}")
        ls = {key: float(v) for key, v in ls.items()}
        losses.append(ls)
        if not all(np.isfinite(v) for v in ls.values()):
            raise AssertionError(f"bf16 train step {i}: losses {ls}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    timed = step_ms[TRAIN_WARMUP:]
    med = statistics.median(timed)
    log(f"train bf16 on {smi}: {TRAIN_STEPS} steps after {TRAIN_WARMUP} "
        f"warm-up, median {med:.3f} ms ({min(timed):.3f} .. "
        f"{max(timed):.3f}), peak memory {peak:.3f} GB; float32 in this "
        f"run {ref32[0]:.3f} ms, {ref32[1]:.3f} GB; launches {counts}")
    log(f"train bf16 step ms: {', '.join(f'{t:.2f}' for t in step_ms)}")
    first_losses_close("train bf16", "same batch", losses[0], first32)
    profile_frames(lambda a: tr.train_step(a[0], rc, *a[1:]), [inputs[0]],
                   n=2, unit="step", groups=TRAIN_PROFILE_GROUPS)
    return {"bf16_step_ms": step_ms, "bf16_step_ms_median": med,
            "bf16_peak_gb": peak, "bf16_losses": losses}


def native_render(cfg) -> float:
    """The training scenes rendered on the host through the native
    renderer (built here at first use): NATIVE_SCENES augmented samples,
    finite, with people in view; without augmentation the same maps as
    the numpy renderer within NATIVE_ATOL. Returns ms a scene."""
    from fvp_torch.data import native
    from fvp_torch.data.registry import build_dataset

    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    host = cfg.replace(device_render=False, synthetic_num_data=NATIVE_SCENES)
    ds = build_dataset(host.train_dataset, host, is_train=True)
    t = time.perf_counter()
    maps = [ds.sample(i, rng=np.random.RandomState(i))["input_heatmaps"]
            for i in range(NATIVE_SCENES)]
    ms = (time.perf_counter() - t) * 1e3 / NATIVE_SCENES
    if not all(np.isfinite(m).all() for m in maps) or \
            max(float(m.max()) for m in maps) < 0.5:
        raise AssertionError("native render: non-finite or empty maps")
    plain = build_dataset(host.train_dataset, host.replace(
        synthetic_augmentation=False), is_train=True)
    a = plain.sample(0, rng=np.random.RandomState(0))["input_heatmaps"]
    native.ENABLED = False
    try:
        b = plain.sample(0, rng=np.random.RandomState(0))["input_heatmaps"]
    finally:
        native.ENABLED = True
    err = float(np.abs(a - b).max())
    log(f"native host render: {lib.name} built in {build_s:.2f} s; "
        f"{NATIVE_SCENES} augmented scenes of {maps[0].shape} at "
        f"{ms:.2f} ms a scene (host clock); without augmentation against "
        f"the numpy renderer max_abs_err {err:.3e} (tol {NATIVE_ATOL:.0e})")
    if not err <= NATIVE_ATOL:
        raise AssertionError(f"native render differs from numpy by {err}")
    return ms


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


def train_image_steps(K, cfg, init_state, batch, rig, smi,
                      dtype="float32", first32=None) -> tuple[list, dict]:
    """TRAIN_IMAGE_STEPS image-source steps at batch TRAIN_IMAGE_BATCH
    through the frozen ResNet-50 (seeded) at 960x512, at compute_dtype
    `dtype`: each launches the stem once, the deconv head's three stages,
    K1 and K2 (float32: TRAIN_IMAGE_PATH), and under bfloat16 also the
    bottleneck stage's ten conv_wgmma launches on layer1
    (TRAIN_IMAGE_BF16_PATH), and nothing else; the losses finite; the
    backbone unchanged; under bfloat16 the first step's losses within
    TRAIN_BF16_LOSS_RTOL of the float32 first step's (`first32`) on the
    same weights and images. Returns the steps' host-clock ms and the
    first step's losses."""
    import torch
    from fvp_torch.engine.train import Trainer
    from fvp_torch.geometry.grids import build_rig_constants
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose
    from fvp_torch.models.resnet import PoseResNet, seeded_state_dict

    dev = torch.device("cuda")
    b = TRAIN_IMAGE_BATCH
    cfg_img = cfg.replace(train_heatmap_src="image", compute_dtype=dtype)
    path = TRAIN_IMAGE_BF16_PATH if dtype == "bfloat16" else \
        TRAIN_IMAGE_PATH
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
    ms, losses = [], []
    for i in range(TRAIN_IMAGE_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ls = tr.train_step(images, rc, targets, meta)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        counts = step_launches(K, counts, path,
                               f"{dtype} image train step {i}")
        ls = {key: float(v) for key, v in ls.items()}
        losses.append(ls)
        if not all(np.isfinite(v) for v in ls.values()):
            raise AssertionError(f"image train step {i}: losses {ls}")
    if dtype == "bfloat16":
        expect_conv_routes(K, "bottleneck_stage", TRAIN_IMAGE_STEPS,
                           STAGE_ROUTES)
    if any(not torch.equal(a, p) for a, p in zip(before,
                                                  backbone.parameters())):
        raise AssertionError("the frozen backbone moved")
    log(f"train image source on {smi}: {TRAIN_IMAGE_STEPS} steps at batch "
        f"{b} through the frozen ResNet-50 at {cfg_img.image_size}, "
        f"{dtype}: {', '.join(f'{t:.2f}' for t in ms)} ms (the first with "
        f"its warm-up); launches {counts}, each step {path}; losses finite, "
        "backbone unchanged")
    if first32 is not None:
        first_losses_close(f"train image source {dtype}", "same images",
                           losses[0], first32)
    return ms, losses[0]


def first_losses_close(what, same, got, first32) -> None:
    """A bf16 first step's losses `got` against the float32 first step's
    `first32` from the same weights: each relative within
    TRAIN_BF16_LOSS_RTOL, zero where float32's is zero."""
    rel = {key: abs(got[key] - v) / abs(v)
           for key, v in first32.items() if v != 0}
    log(f"{what} first step against float32 (same weights, {same}): "
        + ", ".join(f"{key} {got[key]:.6g} vs {first32[key]:.6g} "
                    f"({rel.get(key, 0.0):.3e})" for key in first32)
        + f"; tol {TRAIN_BF16_LOSS_RTOL:.0e} relative")
    if any((first32[key] == 0) != (got[key] == 0) for key in first32) \
            or max(rel.values()) > TRAIN_BF16_LOSS_RTOL:
        raise AssertionError(f"{what}: the first step's losses differ "
                             "from float32's beyond the tolerance")


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
    expect_per_frame(launches, {"stem": 1, "deconv_stage": 3,
                                "centernet_bf16": 1}, "service path")
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


def check_fused(got, ref, label, tol_mm: float = 5e-2,
                against: str = "card vs CPU") -> None:
    """Fused poses (B, K, J, 5) of the card against the CPU's (or what
    `against` names): identical masks, finite, within tol_mm."""
    import torch

    if not torch.equal(got[..., 0, 3] >= 0, ref[..., 0, 3] >= 0):
        raise AssertionError(f"{label}masks differ between card and CPU")
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}shape {tuple(got.shape)} or "
                             "non-finite")
    err = float((got - ref).abs().max())
    log(f"{label}fused_poses {tuple(got.shape)}: {against} max_abs_err "
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


# ---------------------------------------------------------------------------
# phase 11: sharded serving
# ---------------------------------------------------------------------------

def sharded_phase(K, state, bb_state, rig, smi, pred, frames, pred_bf16,
                  img_frames, rows):
    """Phase 11: the view-sharded step (fvp_torch/parallel/) and the
    service's multi-host flags on the card. (a) a (1, 1) mesh over NCCL in
    this process; (b) SHARD_RANKS spawned ranks sharing the card over gloo
    on a (1, 5) mesh; (c) the service with a coordinator at one host.
    Returns (launches by path, numbers)."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from fvp_torch.parallel import make_mesh, make_sharded_eval_step
    from fvp_torch.parallel.mesh import free_port, init_distributed

    configs = (("bf16 image", pred_bf16, img_frames),
               ("float32 heatmap", pred, frames))
    log(f"sharded phase: {configs[0][0]} (FVPConfig() at compute_dtype="
        f"'bfloat16', 5 views of 960x512, seeded ResNet-50) and "
        f"{configs[1][0]} (FVPConfig(backbone=''), 5 views of 240x128 "
        f"heatmaps); {FRAMES} frames each")
    sum_mode_kernel(pred, frames[0], rows)

    # (a) world 1 over NCCL: the sharded step against the unsharded
    # Predictor, bit for bit, and both latencies in this call
    backend = init_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cuda")
    world1 = {}
    try:
        mesh = make_mesh(1, 1)
        for label, p, fr in configs:
            ref, ref_lat, _ = drive(p, fr, K)
            step = make_sharded_eval_step(p, mesh)
            outs, lat, launches = drive(
                lambda x, step=step, p=p: step(x, p.rc), fr, K)
            sums = K.all_kernels()["whole_sample.sum"].launches
            log(f"sharded world 1 ({backend}), {label}: launches "
                f"{launches}, K1 in sum mode {sums} of them")
            expect_launches(launches, BF16_IMAGE_PATH if p is pred_bf16
                            else HEATMAP_PATH, f"sharded world 1 {label}")
            if p is pred_bf16:
                expect_per_frame(launches, {"centernet_bf16": 1},
                                 f"sharded world 1 {label}")
            if sums != FRAMES:
                raise AssertionError(f"K1 ran {sums} times in sum mode")
            same = all(torch.equal(outs[0][k], ref[0][k])
                       for k in ("fused_poses", "proposals", "mask"))
            log(f"sharded world 1, {label}: frame 0 bitwise equal to the "
                f"unsharded Predictor: {same}; "
                f"{int(ref[0]['mask'].sum())} people above the gate")
            if not same:
                raise AssertionError(f"sharded world 1 {label}: differs "
                                     "from the unsharded Predictor")
            log_latency(f"sharded world 1 {label} frame latency on {smi}",
                        lat)
            log_latency(f"unsharded {label} frame latency on {smi}, the "
                        "same call", ref_lat)
            world1[label] = {"launches": launches,
                             "ms": statistics.median(lat[WARMUP_FRAMES:]),
                             "unsharded_ms": statistics.median(
                                 ref_lat[WARMUP_FRAMES:]),
                             "ref": ref[0]}
    finally:
        dist.destroy_process_group()

    # (b) SHARD_RANKS ranks sharing the card over gloo
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory()
    paths = {"state": os.path.join(tmp.name, "model.pth"),
             "bb": os.path.join(tmp.name, "backbone.pth"),
             "images": os.path.join(tmp.name, "images.npy"),
             "heatmaps": os.path.join(tmp.name, "heatmaps.npy")}
    torch.save(state, paths["state"])
    torch.save(bb_state, paths["bb"])
    np.save(paths["images"], np.stack(img_frames))
    np.save(paths["heatmaps"], np.stack(frames))
    # the bf16 ranks run the backbone on one image each: their reference
    # is the unsharded HDN+JLN on the same per-view heatmaps
    ref_bf16, hm1d_bf16 = per_view_reference(pred_bf16, img_frames[0])
    refs = {configs[0][0]: ref_bf16,
            configs[1][0]: world1[configs[1][0]]["ref"]}
    cfgs = {configs[0][0]: pred_bf16.cfg, configs[1][0]: pred.cfg}
    t0 = time.perf_counter()
    res = run_shard_ranks(SHARD_RANKS, (paths, cfgs))
    log(f"sharded {SHARD_RANKS} ranks (gloo, one card): spawned, built and "
        f"served in {time.perf_counter() - t0:.1f} s")
    tmp.cleanup()
    ranks = {}
    for label, p, fr in configs:
        path = BF16_IMAGE_PATH if p is pred_bf16 else HEATMAP_PATH
        for r in range(SHARD_RANKS):
            got = res[r][label]
            expect_launches(got["launches"], path,
                            f"sharded rank {r} {label}")
            if p is pred_bf16:
                # the HDN runs whole on every rank: one launch a frame
                expect_per_frame(got["launches"], {"centernet_bf16": 1},
                                 f"sharded rank {r} {label}")
            if got["sum_launches"] != FRAMES:
                raise AssertionError(f"rank {r}: K1 ran {got['sum_launches']}"
                                     " times in sum mode")
            log(f"sharded rank {r} {label}: launches {got['launches']}; "
                f"staged {got['staged_per_frame'] / 1e6:.3f} MB a frame "
                f"through host memory")
        lat = res[0][label]["lat"]
        log_latency(f"sharded {label}, {SHARD_RANKS} ranks on one card, "
                    f"not a scaling figure ({smi}), rank 0", lat)
        ref = refs[label]
        out0 = {k: torch.as_tensor(v) for k, v in res[0][label]["out0"]
                .items()}
        for r in range(1, SHARD_RANKS):
            if not all(np.array_equal(res[r][label]["out0"][k],
                                      res[0][label]["out0"][k])
                       for k in ("fused_poses", "proposals", "mask")):
                raise AssertionError(f"rank {r} {label}: its output differs"
                                     " from rank 0's")
        if p is pred_bf16:
            check_sharded_bf16(out0, ref, hm1d_bf16, pred_bf16)
        else:
            gate_clear(p, fr[0], f"sharded {label}")
            check_fused(out0["fused_poses"], ref["fused_poses"].cpu(),
                        f"sharded {SHARD_RANKS} ranks {label}: ", 5e-2,
                        "rank 0 vs the unsharded frame")
        ranks[label] = {"launches": res[0][label]["launches"],
                        "ms": statistics.median(lat[WARMUP_FRAMES:]),
                        "staged_mb": res[0][label]["staged_per_frame"]
                        / 1e6}

    # (c) the service with a coordinator at one host
    svc_launches, svc = coordinator_service(K, state, bb_state, rig, smi)
    return ({"sharded_world1_path": world1["bf16 image"]["launches"],
             "sharded_world1_heatmap_path":
                 world1["float32 heatmap"]["launches"],
             "sharded_path": ranks["bf16 image"]["launches"],
             "sharded_heatmap_path": ranks["float32 heatmap"]["launches"],
             "coordinator_service_path": svc_launches},
            {"world1_ms": {k: v["ms"] for k, v in world1.items()},
             "world1_unsharded_ms": {k: v["unsharded_ms"]
                                     for k, v in world1.items()},
             "ranks_ms_not_a_scaling_figure": {k: v["ms"]
                                               for k, v in ranks.items()},
             "staged_mb_per_frame": {k: v["staged_mb"]
                                     for k, v in ranks.items()},
             "coordinator_service": svc})


def sum_mode_kernel(pred, frame, rows) -> None:
    """K1 in sum mode against its plain version at the shapes the sharded
    step gives it: one view (a rank of the 5-rank mesh) and all five (the
    world-1 mesh); view_mean of the five-view sum bit for bit the mean
    mode's volume."""
    import dataclasses

    import torch

    from fvp_torch.ops.kernels import sampler as ksamp
    from fvp_torch.ops.sampling import view_mean

    cfg, rc = pred.cfg, pred.rc
    hm = torch.as_tensor(frame, device="cuda")
    errs, times = [], {}
    with torch.inference_mode():
        for a, b in ((0, 1), (0, cfg.num_views)):
            rcb = dataclasses.replace(
                rc, whole_sample_px=rc.whole_sample_px[a:b])
            x = hm[:, a:b].contiguous()
            got = ksamp.whole_sample(x, rcb, cfg, view_sum=True)
            ref = ksamp.whole_sample_plain(x, rcb, cfg, view_sum=True)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            errs.append(err)
            ms = time_ms(lambda: ksamp.whole_sample(x, rcb, cfg,
                                                    view_sum=True))
            times[f"{b - a}_views"] = ms
            log(f"whole_sample sum mode, views {a}..{b - 1}: max_abs_err="
                f"{err:.3e} tol={1e-5 * (b - a):.1e} kernel_ms={ms:.4f}")
            held("whole_sample sum mode", err, 1e-5 * (b - a))
        same = torch.equal(view_mean(got, cfg.num_views),
                           ksamp.whole_sample(hm, rc, cfg))
    log(f"whole_sample: view_mean of the sum mode's 5-view volume bitwise "
        f"equal to the mean mode's: {same}")
    if not same:
        raise AssertionError("whole_sample: sum mode + view_mean differs "
                             "from the mean mode")
    rows["whole_sample"].update(sum_mode_max_abs_err=max(errs),
                                sum_mode_ms=times)


def per_view_reference(pred, frame):
    """The reference of phase 11 (b)'s bf16 ranks, which run the backbone
    on their one view each: the unsharded HDN+JLN (`pred`'s model, gate
    and weights) on the backbone's heatmaps of each view alone. Its gate
    must pass at least two people and be clear (1e-4) of every detection
    confidence. Batch 1 against batch 5 of the backbone (cuDNN's bf16
    convs round otherwise) is printed as a reading. Returns the reference
    output on the host and C2CNet's scores (K, Z) of its detection."""
    import torch

    from fvp_torch.engine.serve import float32_math

    V = pred.cfg.num_views
    with torch.inference_mode(), float32_math():
        hm5 = pred.heatmaps(frame)
        hm1 = torch.cat([pred.heatmaps(frame[:, v:v + 1]) for v in range(V)],
                        dim=1)
        d5, d1 = (pred.model.detect(h, pred.rc, pred.packed)
                  for h in (hm5, hm1))
        out = pred.model(hm1, pred.rc, pred.packed)
    conf5, conf1 = (d["proposals"][0, :, 4].cpu() for d in (d5, d1))
    log(f"bf16 backbone, each view alone against the 5 views at once (a "
        f"reading): heatmaps max_abs_err "
        f"{float((hm1 - hm5).abs().max()):.3e}, scale "
        f"{float(hm5.abs().max()):.3e}; detection confidences, 5 at once "
        f"{[round(float(c), 4) for c in conf5]}, one at a time "
        f"{[round(float(c), 4) for c in conf1]} (max shift "
        f"{float((conf5 - conf1).abs().max()):.3e})")
    min_score = pred.cfg.min_score
    passed = int((conf1 > min_score).sum())
    gap = float((conf1 - min_score).abs().min())
    log(f"sharded bf16 reference (the per-view heatmaps): {passed} "
        f"detection confidences above min_score={min_score}, the closest "
        f"{gap:.3e} from it")
    if passed < 2 or gap <= 1e-4:
        raise AssertionError("sharded bf16 reference: vacuous or fragile "
                             "gate")
    return ({k: out[k].cpu() for k in ("fused_poses", "proposals", "mask")},
            d1["hm1d"][0].cpu())


def gate_clear(pred, frame, label) -> None:
    """The unsharded frame's detection confidences: at least two people
    through the gate and none within 1e-4 of it."""
    import torch

    with torch.inference_mode():
        hm = pred.heatmaps(frame) if pred.backbone is not None else \
            torch.as_tensor(frame, device="cuda")
        conf = pred.model.detect(hm, pred.rc, pred.packed)["proposals"][
            0, :, 4].cpu()
    min_score = pred.cfg.min_score
    passed = int((conf > min_score).sum())
    gap = float((conf - min_score).abs().min())
    log(f"{label}: {passed} detection confidences above min_score="
        f"{min_score}, the closest {gap:.3e} from it")
    if passed < 2 or gap <= 1e-4:
        raise AssertionError(f"{label}: vacuous or fragile gate")


def check_sharded_bf16(got, ref, hm1d, pred) -> None:
    """The 5-rank bf16 frame against the unsharded HDN+JLN on the same
    per-view heatmaps (`per_view_reference`), phase 7's rule: identical
    masks, the gate clear of both sides' confidences; each person with
    the same voxel pick within SHARD_BF16_TOL_MM; a person whose pick
    differs only in z where the reference's C2CNet scores `hm1d` (K, Z)
    at the two picks are a near-tie."""
    import torch

    min_score = pred.cfg.min_score
    gap = float(torch.minimum(
        (got["proposals"][0, :, 4] - min_score).abs(),
        (ref["proposals"][0, :, 4] - min_score).abs()).min())
    if gap <= 1e-4:
        raise AssertionError(f"sharded bf16: a confidence {gap} from "
                             f"min_score")
    if not torch.equal(got["mask"], ref["mask"]):
        raise AssertionError("sharded bf16: masks differ from the "
                             "unsharded frame's")
    if not torch.isfinite(got["fused_poses"]).all():
        raise AssertionError("sharded bf16: non-finite poses")
    scale, bias = (t.cpu() for t in pred.rc.voxel_to_mm)
    same = (got["proposals"][0, :, :3] == ref["proposals"][0, :, :3]) \
        .all(dim=-1)
    flips = []
    for k in torch.nonzero(~same).flatten().tolist():
        z = int(torch.round((got["proposals"][0, k, 2] - bias[2])
                            / scale[2]))
        xy_same = bool((got["proposals"][0, k, :2]
                        == ref["proposals"][0, k, :2]).all())
        tie = float(hm1d[k].max() - hm1d[k, z])
        s = float(hm1d[k].abs().max())
        flips.append((k, int(hm1d[k].argmax()), z, tie / s))
        if not (xy_same and tie <= BF16_TIE_RTOL * s):
            raise AssertionError(f"sharded bf16 person {k}: voxel picks "
                                 f"differ beyond a z near-tie")
    kept = same & got["mask"][0]
    if int(kept.sum()) < 2:
        raise AssertionError("sharded bf16: fewer than two kept people "
                             "with the same voxel pick")
    err = (got["fused_poses"][0, :, :, :3] - ref["fused_poses"][0, :, :, :3]
           ).norm(dim=-1).amax(dim=-1)[kept]
    log(f"sharded {SHARD_RANKS} ranks bf16 image fused_poses: "
        f"{int(kept.sum())} of {int(got['mask'].sum())} kept people with "
        f"the same voxel pick as the unsharded frame on the same heatmaps, "
        f"joint distance max {float(err.max()):.3e} mm (tol "
        f"{SHARD_BF16_TOL_MM} mm), per person "
        f"{[round(float(e), 5) for e in err]}; z picks that differ on a "
        f"near-tie (person, unsharded z, sharded z, gap / scale): {flips}")
    if not float(err.max()) <= SHARD_BF16_TOL_MM:
        raise AssertionError("sharded bf16 fused_poses differ from the "
                             "unsharded frame's")


def run_shard_ranks(world: int, args: tuple, target=None) -> dict:
    """`target(rank, world, coordinator, *args)` (by default
    `sharded_rank`) in `world` spawned processes: {rank: result}. Raises
    with a rank's traceback if one failed; kills every rank still running
    after SHARD_TIMEOUT s."""
    import multiprocessing as mp
    import queue

    from fvp_torch.parallel.mesh import free_port

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=target or sharded_rank,
                         args=(r, world, coordinator, *args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    res, deadline = {}, time.monotonic() + SHARD_TIMEOUT
    try:
        while len(res) < world and time.monotonic() < deadline:
            try:
                rank, got = q.get(timeout=1.0)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            if isinstance(got, str):
                raise AssertionError(f"sharded rank {rank} failed:\n{got}")
            res[rank] = got
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
    if len(res) < world:
        raise AssertionError(f"sharded ranks: {world - len(res)} of {world} "
                             f"gave no result (exit codes "
                             f"{[p.exitcode for p in procs]})")
    return res


def sharded_rank(rank, world, coordinator, paths, cfgs, q) -> None:
    """Phase 11 (b), one rank: joins the gloo job on the card (the ranks
    share it), builds each configuration's Predictor from the saved
    weights, and takes FRAMES sharded steps on its block of each frame
    with every launch count set to 0 just before; sends its counts,
    latencies, staged bytes and frame 0's output."""
    import traceback

    import torch
    import torch.distributed as dist

    import fvp_torch.ops.kernels as K
    from fvp_torch.engine.serve import Predictor
    from fvp_torch.geometry.cameras import default_ring_rig
    from fvp_torch.parallel import (make_mesh, make_sharded_eval_step,
                                    shard_batch)
    from fvp_torch.parallel.mesh import init_distributed

    try:
        backend = init_distributed(coordinator, world, rank, "cuda:0",
                                   local_ranks=world)
        if backend != "gloo":
            raise AssertionError(f"ranks sharing a card got {backend}")
        mesh = make_mesh(1, world)
        state = torch.load(paths["state"])
        bb = torch.load(paths["bb"])
        out = {}
        for label, cfg in cfgs.items():
            image = cfg.compute_dtype == "bfloat16"
            frames = np.load(paths["images" if image else "heatmaps"])
            rig = default_ring_rig(cfg.num_views, cfg.space_center,
                                   cfg.ori_image_size)
            pred = Predictor.from_state_dict(
                cfg, state, rig, device="cuda",
                backbone_state_dict=bb if image else None)
            step = make_sharded_eval_step(pred, mesh)
            K.reset_launches()
            mesh.staged_bytes = 0
            lat, outs = [], []
            for i in range(FRAMES):
                torch.cuda.synchronize()
                t = time.perf_counter()
                outs.append(step(shard_batch(mesh, frames[i % len(frames)]),
                                 pred.rc))
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t) * 1e3)
            out[label] = {
                "launches": launch_counts(K),
                "sum_launches": K.all_kernels()["whole_sample.sum"].launches,
                "lat": lat, "staged_per_frame": mesh.staged_bytes / FRAMES,
                "out0": {k: v.cpu().numpy() for k, v in outs[0].items()}}
        q.put((rank, out))
    except BaseException:
        q.put((rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def coordinator_service(K, state, bb_state, rig, smi):
    """Phase 11 (c): the service with --coordinator at one host, at the
    service's bf16 image configuration. (c1) run_service as users run it
    (spawned processes, COORD_FRAMES frames); (c2) its inference process
    in this process on COORD_FRAMES seeded frames with every launch count
    set to 0 just before: frame 0's poses bit for bit a direct Predictor
    call's. Returns (launches of (c2), numbers)."""
    import os
    import queue
    import tempfile

    import torch

    from fvp_torch.config import FVPConfig
    from fvp_torch.engine.checkpoint import (load_backbone_state,
                                             load_model_state)
    from fvp_torch.engine.serve import Predictor
    from fvp_torch.parallel.mesh import free_port
    from fvp_torch.service import pipeline
    from fvp_torch.service.sources import SPAWN, FrameQueue

    tmp = tempfile.TemporaryDirectory()
    model_pth = os.path.join(tmp.name, "model_best.pth")
    bb_pth = os.path.join(tmp.name, "pose_resnet50.pth")
    torch.save(state, model_pth)
    torch.save(bb_state, bb_pth)
    cfg = FVPConfig(min_score=MIN_SCORE_BF16, compute_dtype="bfloat16",
                    pretrained_backbone=bb_pth)

    # (c1) run_service --coordinator 127.0.0.1:<free> --num_hosts 1
    sink = SPAWN.Queue()
    t0 = time.perf_counter()
    died = pipeline.run_service(pipeline.ServiceConfig(
        checkpoint=model_pth, num_views=cfg.num_views,
        max_frames=COORD_FRAMES, view_mode="none", on_result=Collect(sink),
        cfg_obj=cfg, device="cuda", coordinator=f"127.0.0.1:{free_port()}",
        num_hosts=1, host_id=0))
    wall = time.perf_counter() - t0
    got = []
    while True:
        try:
            got.append(sink.get(timeout=1.0))
        except queue.Empty:
            break
    if died is not None or not got:
        raise AssertionError(f"coordinator service: died {died}, "
                             f"{len(got)} results")
    lat = sorted((r["timestamp"], r["latency_ms"]) for r in got)
    lat = [x for _, x in lat]
    log(f"service with --coordinator, one host (run_service, spawned) on "
        f"{smi}: stopped by itself after {COORD_FRAMES} frames in "
        f"{wall:.1f} s, no child died; {len(got)} results; latency_ms "
        f"median {statistics.median(lat[SERVICE_WARMUP:] or lat):.3f} "
        f"(first {SERVICE_WARMUP} excluded)")

    # (c2) its inference process here, with the launch counts
    rng = np.random.RandomState(12)
    w, h = cfg.image_size
    frames = [[rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
               for _ in range(cfg.num_views)] for _ in range(COORD_FRAMES)]
    frame_q = FrameQueue(maxsize=COORD_FRAMES)
    result_q = FrameQueue(maxsize=COORD_FRAMES)
    for q in (frame_q, result_q):
        q.q.cancel_join_thread()     # a failure must not hang the exit
    for i, views in enumerate(frames):
        frame_q.put((float(i), views))
    svc = pipeline.ServiceConfig(
        checkpoint=model_pth, num_views=cfg.num_views,
        max_frames=COORD_FRAMES, view_mode="none", cfg_obj=cfg,
        device="cuda", coordinator=f"127.0.0.1:{free_port()}", num_hosts=1,
        host_id=0)
    K.reset_launches()
    pipeline.inference_process(svc, frame_q, result_q, SPAWN.Value("i", 0))
    torch.cuda.synchronize()
    launches = launch_counts(K)
    sums = K.all_kernels()["whole_sample.sum"].launches
    results = [result_q.get(timeout=10.0) for _ in range(COORD_FRAMES)]
    log(f"coordinator service inference process: {COORD_FRAMES} frames, "
        f"launches {launches}, K1 in sum mode {sums} of them")
    expect_launches(launches, BF16_IMAGE_PATH, "coordinator service path")
    if sums != COORD_FRAMES:
        raise AssertionError(f"K1 ran {sums} times in sum mode")
    in_lat = [r["latency_ms"] for r in results]
    log_latency(f"coordinator service inference process latency_ms on "
                f"{smi}", in_lat)
    pred = Predictor.from_state_dict(
        cfg, load_model_state(model_pth), rig, device="cuda",
        backbone_state_dict=load_backbone_state(bb_pth))
    ref = pred(pipeline._frames_to_images(cfg, frames[0]))["fused_poses"]
    ref = ref[0].cpu().numpy()
    got0 = results[0]["poses"]
    same = got0.shape == ref.shape and np.array_equal(got0, ref)
    log(f"coordinator service frame 0 poses {got0.shape} against "
        f"Predictor(prepare(frame 0)): bitwise equal {same}; "
        f"{int((ref[:, 0, 3] >= 0).sum())} people above the gate")
    if not same or not np.isfinite(got0).all():
        raise AssertionError("coordinator service: frame 0's poses differ "
                             "from a direct Predictor call")
    tmp.cleanup()
    return launches, {"latency_ms": lat, "inprocess_latency_ms": in_lat}


def spatial_phase(K, state, smi, pred, frames, train_res):
    """Phase 12: the spatial pipeline mesh and the data-parallel train
    step on the card. (a) and (c) on (1, 1) meshes over NCCL in this
    process; (b) and (d) in one job of SPATIAL_RANKS spawned ranks sharing
    the card over gloo, which builds the (1, 4) pipeline mesh and the
    (2, 1) train mesh. Returns (launches by path, numbers)."""
    import os
    import pickle
    import tempfile

    import torch
    import torch.distributed as dist

    from fvp_torch.models.faster_voxelpose import FasterVoxelPose
    from fvp_torch.parallel import make_pipeline_mesh, make_spatial_eval_step
    from fvp_torch.parallel.mesh import free_port, init_distributed

    tcfg, batches = train_res["cfg"], train_res["batches"]
    # the train steps start from the smoke's seeded weights, not phase 9's
    # reference init: with its convs at std 0.001 the learning rate (1e-4)
    # is a fifth of a weight, and an entry whose gradient's sign is float32
    # noise on one side moves the next step's statistics by that much
    init_state = random_state_dict(FasterVoxelPose(tcfg), seed=0)
    log(f"spatial phase: the float32 heatmap configuration (80x80x20 "
        f"space, 5 views, 15 joints, K = 10), {FRAMES} frames; the train "
        f"phase's first {len(batches)} batches of {tcfg.batch_size}")
    gate_clear(pred, frames[0], "spatial phase, the unsharded frame")
    res = {}

    # (a) a (1, 1) pipeline mesh and (c) a (1, 1) train mesh over NCCL
    backend = init_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cuda")
    try:
        mesh = make_pipeline_mesh(1, 1)
        ref, ref_lat, _ = drive(pred, frames, K)
        step = make_spatial_eval_step(pred, mesh)
        outs, lat, spatial_w1 = drive(lambda x: step(x, pred.rc), frames, K)
        log(f"spatial world 1 ({backend}): launches {spatial_w1}")
        expect_launches(spatial_w1, HEATMAP_PATH, "spatial world 1")
        same = all(torch.equal(outs[0][k], ref[0][k])
                   for k in ("fused_poses", "proposals", "mask"))
        log(f"spatial world 1: frame 0 bitwise equal to the unsharded "
            f"Predictor: {same}; {int(ref[0]['mask'].sum())} people above "
            f"the gate")
        if not same:
            raise AssertionError("spatial world 1 differs from the "
                                 "unsharded Predictor")
        log_latency(f"spatial world 1 frame latency on {smi}", lat)
        log_latency(f"unsharded frame latency on {smi}, the same call",
                    ref_lat)
        res["world1_ms"] = statistics.median(lat[WARMUP_FRAMES:])
        res["world1_unsharded_ms"] = statistics.median(
            ref_lat[WARMUP_FRAMES:])
        unsharded = {k: v.cpu() for k, v in ref[0].items()}
        train_w1, single = sharded_train_world1(K, smi, tcfg, init_state,
                                                batches, train_res["rig"])
    finally:
        dist.destroy_process_group()
    res["train_world1_ms"] = single["sharded_ms"]

    # (b) and (d): SPATIAL_RANKS ranks sharing the card over gloo
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory()
    paths = {"inputs": os.path.join(tmp.name, "inputs.pkl")}
    with open(paths["inputs"], "wb") as f:
        pickle.dump({"state": state, "cfg": pred.cfg,
                     "heatmaps": np.stack(frames), "tcfg": tcfg,
                     "init_state": init_state, "batches": batches,
                     "rig": train_res["rig"]}, f)
    t0 = time.perf_counter()
    ranks = run_shard_ranks(SPATIAL_RANKS, (paths,), target=spatial_rank)
    log(f"spatial {SPATIAL_RANKS} ranks (gloo, one card): spawned, built, "
        f"served and trained in {time.perf_counter() - t0:.1f} s")
    tmp.cleanup()
    spatial_path = check_spatial_ranks(ranks, unsharded, pred, smi, res)
    train_path = check_train_ranks(ranks, single, tcfg, smi, res)
    return ({"spatial_world1_path": spatial_w1,
             "spatial_path": spatial_path,
             "sharded_train_world1_path": train_w1,
             "sharded_train_path": train_path}, res)


def sharded_train_world1(K, smi, cfg, init_state, batches, rig):
    """Phase 12 (c): two steps of the sharded train step on a (1, 1) mesh
    with every launch count set to 0 just before, then two steps of a
    Trainer from the same weights: losses, parameters and running
    statistics bit for bit. cuDNN and PyTorch take their deterministic
    algorithms for both runs (a scatter's atomics, or a cuDNN backward
    algorithm that splits its sum, would add in another order from run to
    run). Returns (launches, the single Trainer's results)."""
    import torch

    from fvp_torch.engine.train import Trainer, step_inputs
    from fvp_torch.geometry.grids import build_rig_constants
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose
    from fvp_torch.parallel import (make_mesh, make_sharded_train_step,
                                    shard_batch, shard_data)

    rc = build_rig_constants(cfg, rig).to("cuda")
    trainers = []
    for _ in range(2):
        model = FasterVoxelPose(cfg)
        model.load_state_dict(init_state)
        trainers.append(Trainer(cfg, model, "cuda"))
    mesh = make_mesh(1, 1)
    step = make_sharded_train_step(trainers[0], mesh)
    inputs = [step_inputs(b, "cuda") for b in batches]
    saved = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        K.reset_launches()
        a, a_ms = [], []
        for x, targets, meta in inputs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            a.append(step(shard_batch(mesh, x), rc, shard_data(mesh, targets),
                          shard_data(mesh, meta)))
            torch.cuda.synchronize()
            a_ms.append((time.perf_counter() - t) * 1e3)
        launches = launch_counts(K)
        sums = K.all_kernels()["whole_sample.sum"].launches
        b, b_ms, b_stats = [], [], []
        for x, targets, meta in inputs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            b.append(trainers[1].train_step(x, rc, targets, meta))
            torch.cuda.synchronize()
            b_ms.append((time.perf_counter() - t) * 1e3)
            b_stats.append(running_stats(trainers[1].model))
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1])
    log(f"sharded train world 1 (nccl): {len(inputs)} steps, launches "
        f"{launches}, K1 in sum mode {sums} of them")
    expect_per_frame_n(launches, TRAIN_PATH, len(inputs),
                       "sharded train world 1")
    if sums != len(inputs):
        raise AssertionError(f"K1 ran {sums} times in sum mode")
    same_losses = all(torch.equal(x[k], y[k]) for x, y in zip(a, b)
                      for k in x)
    sa, sb = (t.model.state_dict() for t in trainers)
    same_state = all(torch.equal(sa[k], sb[k]) for k in sa)
    log(f"sharded train world 1: {len(inputs)} steps bitwise equal to "
        f"Trainer.train_step: losses {same_losses}, parameters and running "
        f"statistics {same_state}; step ms {[round(t, 2) for t in a_ms]} "
        f"against {[round(t, 2) for t in b_ms]} on {smi} (deterministic "
        f"algorithms)")
    if not (same_losses and same_state):
        raise AssertionError("sharded train world 1 differs from "
                             "Trainer.train_step")
    single = {"losses": [{k: float(v) for k, v in x.items()} for x in b],
              "state": {k: v.detach().cpu() for k, v in sb.items()},
              "stats": b_stats,
              "updates": {"pose_net": trainers[1].hdn_updates,
                          "joint_net": trainers[1].jln_updates},
              "lr": cfg.lr, "sharded_ms": a_ms, "ms": b_ms}
    return launches, single


def running_stats(model) -> dict:
    """The BatchNorms' running statistics of `model` as float64 numpy."""
    return {k: v.detach().double().cpu().numpy()
            for k, v in model.state_dict().items() if "running" in k}


def expect_per_frame_n(counts, per_step, steps, what) -> None:
    """Each kernel of `per_step` launched that many times a step over
    `steps` steps, and no other kernel."""
    for name, c in counts.items():
        if c != per_step.get(name, 0) * steps:
            raise AssertionError(f"{what}: {name} launched {c} times in "
                                 f"{steps} steps")


def check_spatial_ranks(ranks, unsharded, pred, smi, res) -> dict:
    """Phase 12 (b) in the main process: every rank's launches (K1 on its
    rows, person_planes, soft_argmax and weightnet_pool; centernet on
    none), kernels, CenterNet and NMS checks, the ranks' agreement, and
    rank 0's frame 0 against the unsharded frame. Returns rank 0's
    launches."""
    import torch

    path = ("whole_sample", "person_planes", "soft_argmax",
            "weightnet_pool")
    for r in range(SPATIAL_RANKS):
        got = ranks[r]["spatial"]
        expect_launches(got["launches"], path, f"spatial rank {r}")
        log(f"spatial rank {r}: launches {got['launches']}; staged "
            f"{got['staged_per_frame'] / 1e6:.4f} MB a frame through host "
            f"memory; rows {got['rows']}")
        for name, (err, tol) in got["held"].items():
            log(f"  spatial rank {r} {name}: max_abs_err={err:.3e} "
                f"tol={tol:.1e}")
            held(f"spatial rank {r} {name}", err, tol)
        log(f"  spatial rank {r}: sharded_nms_topk_2d bitwise equal to the "
            f"whole-map NMS: {got['nms_same']}; K1 on its rows "
            f"{got['k1_ms']:.4f} ms (plain {got['k1_plain_ms']:.4f} ms)")
        if not got["nms_same"]:
            raise AssertionError(f"spatial rank {r}: sharded NMS differs")
        if r and not all(np.array_equal(got["out0"][k],
                                        ranks[0]["spatial"]["out0"][k])
                         for k in got["out0"]):
            raise AssertionError(f"spatial rank {r}: its output differs "
                                 "from rank 0's")
    r0 = ranks[0]["spatial"]
    log_latency(f"spatial {SPATIAL_RANKS} ranks on one card, not a scaling "
                f"figure ({smi}), rank 0", r0["lat"])
    out0 = {k: torch.as_tensor(v) for k, v in r0["out0"].items()}
    if not torch.equal(out0["mask"], unsharded["mask"]):
        raise AssertionError("spatial: masks differ from the unsharded "
                             "frame's")
    check_fused(out0["fused_poses"], unsharded["fused_poses"],
                f"spatial {SPATIAL_RANKS} ranks: ", 5e-2,
                "rank 0 vs the unsharded frame")
    res["ranks_ms_not_a_scaling_figure"] = statistics.median(
        r0["lat"][WARMUP_FRAMES:])
    res["staged_mb_per_frame"] = r0["staged_per_frame"] / 1e6
    res["held"] = r0["held"]
    return r0["launches"]


def check_train_ranks(ranks, single, cfg, smi, res) -> dict:
    """Phase 12 (d) in the main process: each train rank's launches (K1 in
    sum mode and person_planes once a step), its kernels against their
    plain versions, the ranks' agreement, and rank 0's losses and state
    against the single Trainer of (c) after the same steps. Returns rank
    0's launches."""
    n = TRAIN_SHARDED_SHAPE[0] * TRAIN_SHARDED_SHAPE[1]
    steps = len(single["losses"])
    for r in range(n):
        got = ranks[r]["train"]
        expect_per_frame_n(got["launches"], TRAIN_PATH, steps,
                           f"sharded train rank {r}")
        if got["sum_launches"] != steps:
            raise AssertionError(f"sharded train rank {r}: K1 ran "
                                 f"{got['sum_launches']} times in sum mode")
        log(f"sharded train rank {r} of {TRAIN_SHARDED_SHAPE} (gloo, one "
            f"card, {cfg.batch_size // TRAIN_SHARDED_SHAPE[0]} scenes): "
            f"launches {got['launches']}; step ms "
            f"{[round(t, 2) for t in got['ms']]}; peak memory "
            f"{got['peak_gb']:.3f} GB; staged {got['staged_mb']:.3f} MB a "
            f"step on {smi}")
        for name, (err, tol) in got["held"].items():
            log(f"  sharded train rank {r} {name}: max_abs_err={err:.3e} "
                f"tol={tol:.1e}")
            held(f"sharded train rank {r} {name}", err, tol)
        if r and (got["losses"] != ranks[0]["train"]["losses"] or not all(
                np.array_equal(v, ranks[0]["train"]["state"][k])
                for k, v in got["state"].items())):
            raise AssertionError(f"sharded train rank {r} differs from "
                                 "rank 0")
    got = ranks[0]["train"]
    worst_loss = []
    for i, (a, b) in enumerate(zip(got["losses"], single["losses"])):
        rtol = SHARDED_TRAIN_LOSS_RTOL[min(i, 1)]
        err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b)
        worst_loss.append(err)
        if err > rtol:
            raise AssertionError(f"sharded train step {i}: losses {a} vs "
                                 f"{b}")
    worst_stats = []
    for i, (a, b) in enumerate(zip(got["stats"], single["stats"])):
        worst_stats.append(0.0)
        for k, ref in b.items():
            tol = SHARDED_TRAIN_STATS_RTOL[min(i, 1)] * float(
                np.abs(ref).max())
            if i and k.endswith("running_mean"):
                # a conv bias before this BatchNorm has an exact gradient
                # of 0: its Adam updates are float32 noise on each side,
                # up to 2 lr apart an update, and the batch means the
                # running mean takes move with it
                tol += SHARDED_TRAIN_LR_PER_UPDATE * single["lr"] \
                    * single["updates"][k.split(".")[0]]
            e = float(np.abs(a[k] - ref).max()) / tol
            worst_stats[i] = max(worst_stats[i], e)
            if e > 1.0:
                raise AssertionError(f"sharded train step {i} {k}: {e} of "
                                     "its tolerance")
    worst_lr, over, total = 0.0, 0, 0
    for k, ref in single["state"].items():
        g = np.asarray(got["state"][k], np.float64)
        ref = ref.double().numpy()
        if "num_batches" in k or "running" in k:
            continue
        d = np.abs(g - ref) / single["lr"]
        worst_lr = max(worst_lr, float(d.max()))
        over += int((d > 1.0).sum())
        total += d.size
        bound = SHARDED_TRAIN_LR_PER_UPDATE * single["updates"][
            k.split(".")[0]] + SHARDED_TRAIN_ROUNDING_LR
        if float(d.max()) > bound:
            raise AssertionError(f"sharded train {k}: {float(d.max())} lr")
    log(f"sharded train {TRAIN_SHARDED_SHAPE} after {steps} steps against "
        f"the single Trainer on the same {cfg.batch_size} scenes: losses "
        f"{[f'{e:.2e}' for e in worst_loss]} relative (tol "
        f"{SHARDED_TRAIN_LOSS_RTOL}); parameters within {worst_lr:.6f} lr "
        f"(tol {SHARDED_TRAIN_LR_PER_UPDATE} a update + "
        f"{SHARDED_TRAIN_ROUNDING_LR}, updates "
        f"{single['updates']}), {over} of {total} entries more than 1 lr "
        f"apart; running statistics after each step within "
        f"{[f'{e:.3f}' for e in worst_stats]} of their tolerance (rtol "
        f"{SHARDED_TRAIN_STATS_RTOL}, running means after the first step "
        f"+ {SHARDED_TRAIN_LR_PER_UPDATE} lr a update); joint losses "
        f"{[round(x['joint'], 4) for x in got['losses']]}")
    if over > SHARDED_TRAIN_FRAC_OVER_LR * total:
        raise AssertionError("sharded train: too many parameters apart")
    res["train_rank_ms"] = got["ms"]
    res["train_rank_peak_gb"] = got["peak_gb"]
    res["train_single_ms"] = single["ms"]
    return got["launches"]


def spatial_rank(rank, world, coordinator, paths, q) -> None:
    """Phase 12 (b) and (d), one rank: joins the gloo job on the card,
    builds the (1, world) pipeline mesh and the TRAIN_SHARDED_SHAPE train
    mesh (the ranks past it idle there), runs the spatial step on FRAMES
    frames and, on the train mesh, two sharded train steps, each with
    every launch count set to 0 just before; then holds its kernels
    against their plain versions on its own tensors. Sends its results."""
    import pickle
    import traceback

    import torch.distributed as dist

    from fvp_torch.parallel import make_mesh, make_pipeline_mesh
    from fvp_torch.parallel.mesh import init_distributed

    try:
        backend = init_distributed(coordinator, world, rank, "cuda:0",
                                   local_ranks=world)
        if backend != "gloo":
            raise AssertionError(f"ranks sharing a card got {backend}")
        pipe = make_pipeline_mesh(1, world)
        data = make_mesh(*TRAIN_SHARDED_SHAPE)
        with open(paths["inputs"], "rb") as f:
            inp = pickle.load(f)
        out = {"spatial": spatial_rank_eval(pipe, inp), "train": None}
        if data.active:
            out["train"] = spatial_rank_train(data, inp)
        q.put((rank, out))
    except BaseException:
        q.put((rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spatial_rank_eval(pipe, inp) -> dict:
    """Phase 12 (b) on one rank of the pipeline mesh."""
    import torch

    import fvp_torch.ops.kernels as K
    from fvp_torch.engine.serve import Predictor, float32_math
    from fvp_torch.geometry.cameras import default_ring_rig
    from fvp_torch.ops.kernels import sampler as ksamp
    from fvp_torch.ops.kernels import softargmax as ksa
    from fvp_torch.ops.kernels import weightnet as kwn
    from fvp_torch.ops.nms import nms_topk_2d
    from fvp_torch.parallel import (make_spatial_eval_step, shard_data,
                                    sharded_nms_topk_2d, spatial_centernet)

    cfg = inp["cfg"]
    rig = default_ring_rig(cfg.num_views, cfg.space_center,
                           cfg.ori_image_size)
    pred = Predictor.from_state_dict(cfg, inp["state"], rig, device="cuda")
    frames = inp["heatmaps"]
    step = make_spatial_eval_step(pred, pipe)
    K.reset_launches()
    pipe.staged_bytes = 0
    lat, outs = [], []
    for i in range(FRAMES):
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(step(shard_data(pipe, frames[i % len(frames)]), pred.rc))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    launches = launch_counts(K)
    staged = pipe.staged_bytes / FRAMES

    # the kernels and the sharded ops against their plain versions
    rc, model, packed = pred.rc, pred.model, pred.packed
    nx = cfg.voxels_per_axis[0]
    XL = nx // pipe.shape[1]
    x0 = pipe.coords[1] * XL
    hm = torch.as_tensor(frames[0], device="cuda")
    n, J, Kp = cfg.ind_voxels_per_axis[0], cfg.num_joints, cfg.max_people
    heldd = {}
    with torch.inference_mode(), float32_math():
        rcb = ksamp.row_block(rc, cfg, x0, XL)
        got = ksamp.whole_sample(hm, rcb, cfg, rows=(x0, XL))
        ref = ksamp.whole_sample_plain(hm, rcb, cfg, rows=(x0, XL))
        heldd["whole_sample rows"] = (float((got - ref).abs().max()), 1e-5)
        k1_ms = time_ms(lambda: ksamp.whole_sample(hm, rcb, cfg,
                                                   rows=(x0, XL)))
        k1_plain_ms = time_ms(lambda: ksamp.whole_sample_plain(
            hm, rcb, cfg, rows=(x0, XL)), 5)
        bev = ksamp.whole_sample(hm, rc, cfg).amax(dim=3)
        net = model.pose_net.center_net
        hm_w, size_w = net.bev_forward(bev)
        hm_b, size_b = spatial_centernet(net, bev[:, x0:x0 + XL], pipe)
        heldd["spatial_centernet"] = (float(max(
            (hm_b - hm_w[:, x0:x0 + XL]).abs().max(),
            (size_b - size_w[:, x0:x0 + XL]).abs().max())), SPATIAL_CN_TOL)
        mine = sharded_nms_topk_2d(pipe, hm_w[:, x0:x0 + XL, :, 0]
                                   .contiguous(), Kp)
        whole = nms_topk_2d(hm_w[..., 0], Kp)
        nms_same = all(torch.equal(a, b) for a, b in zip(mine, whole))
        props = outs[0]["proposals"]
        mask = props[..., 3] >= 0
        planes, _ = ksamp.person_planes(hm, rc, cfg, props[..., :3],
                                        props[..., 5:7], mask)
        corner, start, end, _ = ksamp.person_bounds(
            props[..., :3], props[..., 5:7], mask, cfg)
        heldd["person_planes"] = (float((planes - ksamp.person_planes_plain(
            hm, rc, cfg, corner, start, end)).abs().max()), 1e-4)
        feats = model.joint_net.conv_net(planes.reshape(3 * Kp, n, n, J))
        fl = feats.reshape(3, Kp, n * n, J).contiguous()
        c_k, p_k = ksa.soft_argmax(fl, rc.center_grid, cfg.beta)
        c_p, p_p = ksa.soft_argmax_plain(fl, rc.center_grid, cfg.beta)
        heldd["soft_argmax"] = (float(max((c_k - c_p).abs().max(),
                                          (p_k - p_p).abs().max())), 1e-2)
        feats = feats.contiguous()
        w_k = kwn.weightnet_pool(feats, packed["weight_net"])
        w_p = kwn.weightnet_pool_plain(feats, packed["weight_net"])
        heldd["weightnet_pool"] = (float((w_k - w_p).abs().max()),
                                   1e-4 * max(float(w_p.abs().max()), 1.0))
    torch.cuda.synchronize()
    return {"launches": launches, "lat": lat, "staged_per_frame": staged,
            "out0": {k: v.cpu().numpy() for k, v in outs[0].items()},
            "held": heldd, "nms_same": nms_same, "k1_ms": k1_ms,
            "k1_plain_ms": k1_plain_ms, "rows": (x0, x0 + XL - 1)}


def spatial_rank_train(data, inp) -> dict:
    """Phase 12 (d) on one rank of the train mesh: two sharded train steps
    on its 'data' block of the train phase's batches, with the counts set
    to 0 just before; then K1 in sum mode and person_planes against their
    plain versions on its block's tensors."""
    import torch

    import fvp_torch.ops.kernels as K
    from fvp_torch.engine.train import Trainer, step_inputs
    from fvp_torch.geometry.grids import build_rig_constants
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose
    from fvp_torch.ops.kernels import sampler as ksamp
    from fvp_torch.parallel import (make_sharded_train_step, shard_batch,
                                    shard_data)

    cfg = inp["tcfg"]
    model = FasterVoxelPose(cfg)
    model.load_state_dict(inp["init_state"])
    trainer = Trainer(cfg, model, "cuda")
    step = make_sharded_train_step(trainer, data)
    rc = build_rig_constants(cfg, inp["rig"]).to("cuda")
    inputs = [step_inputs(b, "cuda") for b in inp["batches"]]
    blocks = [(shard_batch(data, x), shard_data(data, t),
               shard_data(data, m)) for x, t, m in inputs]
    K.reset_launches()
    data.staged_bytes = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses, stats = [], [], []
    for x, targets, meta in blocks:
        torch.cuda.synchronize()
        t = time.perf_counter()
        ls = step(x, rc, targets, meta)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append({k: float(v) for k, v in ls.items()})
        stats.append(running_stats(model))
    launches = launch_counts(K)
    sums = K.all_kernels()["whole_sample.sum"].launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    staged = data.staged_bytes / len(blocks) / 1e6
    state = {k: v.detach().cpu().numpy() for k, v in model.state_dict()
             .items()}
    heldd = {}
    with torch.no_grad():
        x, _, meta = blocks[0]
        hm = trainer.heatmaps(x)
        got = ksamp.whole_sample(hm, rc, cfg, view_sum=True)
        ref = ksamp.whole_sample_plain(hm, rc, cfg, view_sum=True)
        heldd["whole_sample sum mode"] = (float((got - ref).abs().max()),
                                          1e-5 * cfg.num_views)
        props = model.detect(hm, rc, None, True, meta)["proposals"]
        mask = props[..., 3] >= 0
        planes, _ = ksamp.person_planes(hm, rc, cfg, props[..., :3],
                                        props[..., 5:7], mask)
        corner, start, end, _ = ksamp.person_bounds(
            props[..., :3], props[..., 5:7], mask, cfg)
        heldd["person_planes"] = (float((planes - ksamp.person_planes_plain(
            hm, rc, cfg, corner, start, end)).abs().max()), 1e-4)
    return {"launches": launches, "sum_launches": sums, "ms": ms,
            "losses": losses, "peak_gb": peak, "staged_mb": staged,
            "held": heldd, "state": state, "stats": stats}


# ---------------------------------------------------------------------------
# 13. Shelf and Campus at full width
# ---------------------------------------------------------------------------

# The two evaluation configurations of the paper, each on a tree written by
# fvp_torch/tools/fixtures.py (no real data ships): the name, its config,
# and its data directory beside the shared pose library.
SHELF_CAMPUS = (("shelf", "configs/shelf/jln64.yaml", "Shelf"),
                ("campus", "configs/campus/jln64.yaml", "Campus"))
# the depth each is cut to: test frames (of the 301 and 222 the datasets
# pin), training scenes (of SYNTHETIC.NUM_DATA's 10000) and train steps at
# the config's batch of 8
SC_TEST_FRAMES = 16
SC_TRAIN_SCENES = 40
SC_TRAIN_WARMUP = 2
SC_TRAIN_STEPS = 3
# the Panoptic training sequences the pose library is extracted from
SC_POSE_SEQS, SC_POSE_FRAMES, SC_POSE_PEOPLE = 2, 48, 3
# C2CNet at B = 8 against its plain version (cuDNN's bf16 convs, float32
# sums in another order): over the eval batch's 40-80 columns an activation
# rounded to the other bf16 neighbour somewhere carries on through the 19
# phases (1.29 and 1.58 x NET_RTOL of the scale on Shelf's and Campus's
# batch 0 in this phase's first runs, NVIDIA H100 80GB HBM3, 700.00 W;
# 2.9e-3 .. 9.9e-3 over seeds on the CPU, where the reference lies as far
# from the plain version as from the kernel's emulation:
# tests/test_torch_c2cnet_plan.py). The kernel is also held bit for bit
# against its emulation (ops/kernels/c2cnet.py::emulate).
C2CNET_BATCH_RTOL = 3 * NET_RTOL
# The fuse_p2p eval against the float32 eval: the bf16 C2CNet may pick
# another height than the float32 module where two of its scores lie
# close (Shelf: 19 of 159 people, each also picked by the plain version,
# cuDNN's bf16 convs; its scores up to 3.8e-2 of their scale from the
# float32 module's, for kernel and plain version alike). At most this
# many people may take a height the plain version does not pick (a
# near-tie between the two orders of bf16 sums, as BF16_MAX_TRADED).
FUSE_MAX_KERNEL_ONLY_FLIPS = 1


def sc_tree(tmp) -> str:
    """The synthesised trees under `tmp` (Panoptic training sequences, a
    Shelf and a Campus tree), and the COCO-17 pose library both configs
    read (SYNTHETIC.POSE_FILE '../panoptic_training_pose.pkl'), built by
    the port's tool in a subprocess as a user runs it. Returns the tool's
    output line."""
    import os

    from fvp_torch.config import load_config
    from fvp_torch.data.panoptic import TRAIN_LIST
    from fvp_torch.tools import fixtures

    for i, seq in enumerate(TRAIN_LIST[:SC_POSE_SEQS]):
        fixtures.write_panoptic_sequence(
            os.path.join(tmp, "Panoptic"), seq, n_frames=SC_POSE_FRAMES,
            n_people=SC_POSE_PEOPLE, seed=40 + i)
    for name, path, sub in SHELF_CAMPUS:
        cfg = load_config(path)
        fixtures.write_shelf_tree(os.path.join(tmp, sub), name,
                                  cfg.num_views, cfg.space_center,
                                  cfg.ori_image_size)
    out = os.path.join(tmp, "panoptic_training_pose.pkl")
    t = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "fvp_torch.tools.extract_training_poses",
         "--data_dir", os.path.join(tmp, "Panoptic"), "--out", out,
         "--coco17"], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if run.returncode != 0 or not os.path.exists(out):
        raise AssertionError(f"extract_training_poses failed "
                             f"({run.returncode}): {run.stderr[-2000:]}")
    return (f"{run.stdout.strip()} (python -m "
            f"fvp_torch.tools.extract_training_poses --coco17, a "
            f"subprocess, {time.perf_counter() - t:.1f} s)")


def shelf_campus_phase(K, smi, rows):
    """Phase 13: Shelf and Campus at full width on the card, each from its
    synthesised tree: (a) the trees and the pose library; (b) train steps
    at the config's batch of 8 on the synthetic factory fed by that
    library; (c) run_validation over the cut test split (the 'pred'
    source: the native host renderer, then the card) against the same call
    on the CPU, and K1-K5 on batch 0 against their plain versions; (d) the
    same eval with fuse_p2p, P2PNet and C2CNet as kernels at B = 8, against
    (c) and against their plain versions; (e) one heatmap frame through
    Predictor against the CPU. Returns (launches by path, numbers)."""
    import os
    import tempfile

    import torch

    from fvp_torch.config import load_config

    tmp = tempfile.TemporaryDirectory(prefix="fvp_shelf_campus_")
    t0 = time.perf_counter()
    lib_line = sc_tree(tmp.name)
    log(f"shelf/campus phase: trees written and pose library built in "
        f"{time.perf_counter() - t0:.1f} s: {lib_line}")
    launches, res = {}, {}
    for name, path, sub in SHELF_CAMPUS:
        base = load_config(path, data_dir=os.path.join(tmp.name, sub))
        t = time.perf_counter()
        paths, out = sc_config(K, smi, rows, name, path, base)
        out["phase_s"] = time.perf_counter() - t
        launches.update({f"{name}_{k}": v for k, v in paths.items()})
        res[name] = out
        log(f"{name}: phase 13 took {out['phase_s']:.1f} s")
        torch.cuda.empty_cache()
    tmp.cleanup()
    return launches, res


def sc_config(K, smi, rows, name, path, base):
    """Phase 13 for one configuration, `base` its config on its tree (see
    shelf_campus_phase)."""
    import torch

    from fvp_torch.data.loader import build_samples, collate
    from fvp_torch.data.registry import build_dataset
    from fvp_torch.engine.serve import Engine, Predictor
    from fvp_torch.engine.validate import batch_input, eval_batches, eval_rng
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose

    dev = torch.device("cuda")
    cfg = base.replace(synthetic_num_data=SC_TRAIN_SCENES)
    paths, out = {}, {}
    log(f"{name}: {path}, {cfg.num_views} views of {cfg.heatmap_size} "
        f"heatmaps ({cfg.ori_image_size} images), {cfg.num_joints} joints, "
        f"space {cfg.space_size} mm at {cfg.space_center} in "
        f"{cfg.voxels_per_axis} voxels, K = {cfg.max_people} in "
        f"{cfg.ind_voxels_per_axis} cubes, sigma {cfg.sigma}, "
        f"{cfg.compute_dtype}")

    # (b) training on the synthetic factory fed by the pose library
    paths["train_path"], out["train"] = sc_train(K, smi, name, cfg,
                                                 base.synthetic_num_data)

    # (c) the eval over the cut test split, seeded weights
    ds = build_dataset(cfg.test_dataset, cfg, is_train=False)
    ds.records = ds.records[:SC_TEST_FRAMES]
    ds.frame_range = ds.frame_range[:SC_TEST_FRAMES]
    seq = ds.records[0]["seq"]
    rig = ds.rigs[seq]
    state = random_state_dict(FasterVoxelPose(cfg), seed=0)
    specs = list(eval_batches(ds, cfg.test_batch_size))
    rng = eval_rng(cfg)
    xs = [batch_input(collate(build_samples(ds, idx, rng=rng)), dev)
          for _, idx, _ in specs]
    log(f"{name} eval: {len(ds)} test frames (frames "
        f"{ds.frame_range[0]}..{ds.frame_range[-1]} of the "
        f"{type(ds).__name__}), batches {[int(v) for _, _, v in specs]} of "
        f"{cfg.test_batch_size}, heatmaps {tuple(xs[0].shape)} from the "
        f"offline 2D predictions (source '{cfg.test_heatmap_src}', the "
        f"native host renderer), seeded random weights")

    def engine(c, device):
        model = FasterVoxelPose(c)
        model.load_state_dict(state)
        return Engine(c, model, device)

    # the gate, in the widest gap of the card's confidences over every
    # batch, of the float32 path and the fuse_p2p path, that leaves at
    # least two of frame 0's people above it on both
    det = {}
    for fuse in (False, True):
        e = engine(cfg.replace(fuse_p2p=fuse), dev)
        rc = e.rig_constants(rig)
        with torch.inference_mode():
            det[fuse] = [{k: v.cpu() for k, v in
                          e.model.detect(x, rc, e.packed).items()
                          if k in ("proposals", "hm1d", "columns")}
                         for x in xs]
    conf = {f: torch.cat([d["proposals"][..., 4] for d in det[f]])
            for f in det}
    cfg = cfg.replace(min_score=pick_gate(conf, name))

    paths["eval_path"], out["eval"], poses = sc_eval(
        K, smi, rows, name, cfg, state, ds, specs, xs, rig, det[False])
    paths["fuse_eval_path"], out["fuse_eval"] = sc_fuse_eval(
        K, smi, rows, name, cfg, state, ds, specs, xs, rig, det, poses)

    # (e) one heatmap frame through Predictor, card against CPU
    pred = Predictor.from_state_dict(cfg, state, rig, device=dev)
    frame = xs[0][:1]
    gate_clear(pred, frame.cpu().numpy(), f"{name} frame 0")
    outs, lat, counts = drive(pred, [frame], K)
    log(f"{name} frame path: {FRAMES} frames, launches {counts}")
    expect_launches(counts, HEATMAP_PATH, f"{name} frame path")
    expect_per_frame(counts, {k: 1 for k in HEATMAP_PATH},
                     f"{name} frame path")
    log_latency(f"{name} heatmap frame latency on {smi}", lat)
    cpu = Predictor.from_state_dict(cfg, state, rig, device="cpu")
    check_poses(outs[0], cpu, frame, f"{name} frame ")
    paths["frame_path"] = counts
    out["frame_ms"] = lat
    out["min_score"] = cfg.min_score
    return paths, out


def pick_gate(conf, name) -> float:
    """The midpoint of the widest gap between the confidences `conf`
    (fuse_p2p off and on: (frames, K) each) that leaves at least two of
    frame 0's people above it on both paths. The seeded nets' confidences
    lie ~1e-5 apart, on no trained scale and closer than the bf16 C2CNet
    moves one, so a person's two confidences may lie on the two sides of
    any such gap: fuse_against_float32 compares the people both paths
    keep."""
    import torch

    c = np.sort(torch.cat([v.ravel() for v in conf.values()]).numpy())
    c32, cf = (v.numpy() for v in conf.values())
    fits = [i for i in range(len(c) - 1)
            if c[i + 1] - c[i] > 2e-4
            and all((f[0] > c[i]).sum() >= 2 for f in (c32, cf))]
    if not fits:
        raise AssertionError(f"{name}: no gate clear of the confidences "
                             "leaves two of frame 0's people above it")
    i = max(fits, key=lambda i: c[i + 1] - c[i])
    gate = float((c[i] + c[i + 1]) / 2)
    straddle = int(((c32 > gate) != (cf > gate)).sum())
    log(f"{name} gate: min_score {gate:.6f} replaces the config's MIN_SCORE "
        f"0.1 (seeded weights: detection confidences "
        f"{c[0]:.4f} .. {c[-1]:.4f}, on no trained scale); it lies in the "
        f"widest gap ({c[i]:.6f} .. {c[i + 1]:.6f}) of the card's {len(c)} "
        f"confidences, float32 and fuse_p2p, that leaves at least two of "
        f"frame 0's people above it on both; {int((c > gate).sum())} "
        f"above it in all; people on its two sides on the two paths: "
        f"{straddle}")
    return gate


def sc_train(K, smi, name, cfg, num_data):
    """Phase 13 (b): SC_TRAIN_WARMUP + SC_TRAIN_STEPS train steps at the
    config's batch of 8 on its synthetic factory (the tree's calibration,
    the pose library), rendered on the card by the device splat; each
    launches TRAIN_PATH and nothing else; the first step held against the
    CPU (phase 9's train_card_vs_cpu). Returns (launches, numbers)."""
    import os

    import torch

    from fvp_torch.data.loader import seq_grouped_batches
    from fvp_torch.data.poses import load_pose_library
    from fvp_torch.data.registry import build_dataset
    from fvp_torch.engine.init import flax_init
    from fvp_torch.engine.train import Trainer, step_inputs
    from fvp_torch.geometry.grids import build_rig_constants
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose

    dev = torch.device("cuda")
    cfg = cfg.replace(device_render=True)
    lib = os.path.join(cfg.data_dir, cfg.synthetic_pose_file)
    ds = build_dataset(cfg.train_dataset, cfg, is_train=True)
    n_lib = len(load_pose_library(lib))
    if len(ds.poses) != n_lib or ds.poses[0]["pose"].shape != (17, 3):
        raise AssertionError(f"{name}: the synthetic factory does not read "
                             f"the pose library {lib}")
    n = SC_TRAIN_WARMUP + SC_TRAIN_STEPS
    batches = list(seq_grouped_batches(ds, cfg.batch_size, cfg.seed, 0))
    if len(batches) < n:
        raise AssertionError(f"{len(batches)} batches for {n} steps")
    people = [len(r["joints_3d"]) for r in ds.records]
    log(f"{name} train: {len(ds)} synthetic scenes (of NUM_DATA "
        f"{num_data}) of 1..{cfg.synthetic_max_people} "
        f"people ({sum(people)} placed) from the {n_lib} poses of "
        f"{os.path.basename(lib)} on the tree's rig "
        f"({cfg.synthetic_camera_file}), batch {cfg.batch_size}, rendered "
        f"on the card by the device splat (the config renders on the host; "
        f"DEVICE_RENDER on here), augmentation {ds.data_augmentation}")
    rc = build_rig_constants(cfg, ds.rigs["synthetic"]).to(dev)
    model = FasterVoxelPose(cfg)
    flax_init(model, torch.Generator().manual_seed(cfg.seed))
    init_state = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(cfg, model, dev)
    inputs = [step_inputs(b, dev) for _, b in batches[:n]]
    K.reset_launches()
    counts = launch_counts(K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for i, (x, targets, meta) in enumerate(inputs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ls = trainer.train_step(x, rc, targets, meta)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        counts = step_launches(K, counts, TRAIN_PATH,
                               f"{name} train step {i}")
        ls = {key: float(v) for key, v in ls.items()}
        losses.append(ls)
        if not all(np.isfinite(v) for v in ls.values()):
            raise AssertionError(f"{name} train step {i}: losses {ls}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    timed = step_ms[SC_TRAIN_WARMUP:]
    med = statistics.median(timed)
    log(f"{name} train on {smi}: {SC_TRAIN_STEPS} steps after "
        f"{SC_TRAIN_WARMUP} warm-up, median {med:.3f} ms ({min(timed):.3f} "
        f".. {max(timed):.3f}); peak memory {peak:.3f} GB "
        f"(max_memory_allocated); step ms "
        f"{', '.join(f'{t:.2f}' for t in step_ms)}; launches {counts}, each "
        f"step {TRAIN_PATH}")
    for i, ls in enumerate(losses):
        log(f"  step {i}: total {ls['total']:.5f} 2d "
            f"{ls['2d_heatmaps']:.6f} 1d {ls['1d_heatmaps']:.5f} bbox "
            f"{ls['bbox']:.5f} joint {ls['joint']:.3f}")
    train_card_vs_cpu(cfg, init_state, batches[0][1], ds)
    return counts, {"step_ms": step_ms, "step_ms_median": med,
                    "peak_gb": peak, "losses": losses}


def sc_eval(K, smi, rows, name, cfg, state, ds, specs, xs, rig, det):
    """Phase 13 (c): run_validation at the config's test batch on the card
    with the launch counts set to 0 just before (K1-K5 once a batch, no
    other kernel), against the same call on the CPU (the PCP dict equal,
    identical masks, poses within 5e-2 mm, the gate clear of the CPU's
    confidences too), K1-K5 on batch 0 against their plain versions, and
    batch 0 stepped as run_validation steps it. Returns (launches,
    numbers, the card's poses)."""
    import torch

    from fvp_torch.engine.serve import Engine
    from fvp_torch.engine.validate import make_eval_step, run_validation
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose

    dev = torch.device("cuda")

    def model():
        m = FasterVoxelPose(cfg)
        m.load_state_dict(state)
        return m

    K.reset_launches()
    res = run_validation(cfg, model(), ds, device=dev, log=log)
    counts = launch_counts(K)
    log(f"{name} eval path: {len(specs)} batches, launches {counts}")
    expect_launches(counts, HEATMAP_PATH, f"{name} eval path")
    if any(counts[k] != len(specs) for k in HEATMAP_PATH):
        raise AssertionError(f"{name} eval path: not one launch a batch")
    poses = res["fused_poses"]
    if poses.shape != (len(ds), cfg.max_people, cfg.num_joints, 5) \
            or not np.isfinite(poses).all():
        raise AssertionError(f"{name} eval fused_poses {poses.shape} or "
                             "non-finite")
    log(f"{name} eval on {smi}: batch_ms {json.dumps(res.get('batch_ms'))} "
        f"(first batch excluded), {res.get('fps', float('nan')):.2f} "
        f"frames/s; people kept {int((poses[..., 0, 3] >= 0).sum())} of "
        f"{poses[..., 0, 3].size}")

    # the same call on the CPU, and its confidences against the gate
    t = time.perf_counter()
    res_cpu = run_validation(cfg, model(), ds, device="cpu",
                             log=lambda s: None)
    cpu_s = time.perf_counter() - t
    cpu = Engine(cfg, model(), "cpu")
    rc_cpu = cpu.rig_constants(rig)
    with torch.inference_mode():
        conf = torch.cat([cpu.model.detect(x.cpu(), rc_cpu, cpu.packed)[
            "proposals"][..., 4] for x in xs])
    conf = torch.cat([conf, torch.cat([d["proposals"][..., 4]
                                       for d in det])])
    gap = float((conf - cfg.min_score).abs().min())
    log(f"{name} eval on the CPU (the same run_validation call, "
        f"{cpu_s:.1f} s): the gate {gap:.3e} from the closest confidence "
        f"of the card and the CPU")
    if gap <= 1e-4:
        raise AssertionError(f"{name} eval: fragile gate")
    check_fused(torch.from_numpy(poses),
                torch.from_numpy(res_cpu["fused_poses"]), f"{name} eval ")
    log(f"{name} eval metrics (PCP, seeded weights): card "
        f"{json.dumps(res['metrics'], default=_plain)}")
    if not same_tree(res["metrics"], res_cpu["metrics"]):
        raise AssertionError(f"{name} eval: the PCP dict differs from the "
                             f"CPU's {res_cpu['metrics']}")
    log(f"{name} eval metrics: equal to the CPU's True")

    # K1-K5 on batch 0 against their plain versions, and batch 0 stepped
    e = Engine(cfg, model(), dev)
    rc = e.rig_constants(rig)
    batch_kernels(cfg, e, rc, xs[0], rows, key=f"{name}_batch",
                  what=f"{name} eval")
    step = make_eval_step(cfg, e.model, e.packed)
    ms = []
    for _ in range(EVAL_FULL_BATCHES // 2 + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(xs[0], rc)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    ms = ms[1:]
    log(f"{name} eval batch 0 stepped {len(ms)} times on {smi}: median "
        f"{statistics.median(ms):.3f} ms ({min(ms):.3f} .. {max(ms):.3f}), "
        f"{xs[0].shape[0] * 1e3 / statistics.median(ms):.2f} frames/s at "
        f"B = {xs[0].shape[0]}")
    return counts, {"batch_ms": res.get("batch_ms"), "fps": res.get("fps"),
                    "stepped_ms": ms, "metrics": res["metrics"],
                    "cpu_s": cpu_s}, poses


def sc_fuse_eval(K, smi, rows, name, cfg, state, ds, specs, xs, rig, det,
                 poses32):
    """Phase 13 (d): the same eval with fuse_p2p, the counts set to 0 just
    before (K1-K5, P2PNet's 25 and C2CNet's one launch a batch, P2PNet's
    convs on conv_plan's routes); C2CNet on every batch's columns (`det`,
    read by the detection alone) against its plain version and bit for bit
    against its emulation; its poses against (c)'s (fuse_against_float32);
    P2PNet on batch 0's planes against its plain version, and both nets
    timed there. Returns (launches, numbers)."""
    import torch

    from fvp_torch.engine.serve import Engine, float32_math
    from fvp_torch.engine.validate import run_validation
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose
    from fvp_torch.ops.kernels import c2cnet as kc2c
    from fvp_torch.ops.kernels import hourglass as khg
    from fvp_torch.ops.kernels import sampler as ksamp

    dev = torch.device("cuda")
    cfg = cfg.replace(fuse_p2p=True)
    model = FasterVoxelPose(cfg)
    model.load_state_dict(state)
    nb = len(specs)
    K.reset_launches()
    res = run_validation(cfg, model, ds, device=dev, log=log)
    counts = launch_counts(K)
    log(f"{name} fuse_p2p eval path: {nb} batches, launches {counts}")
    expect_launches(counts, FUSE_PATH, f"{name} fuse_p2p eval path")
    want = {**{k: nb for k in HEATMAP_PATH}, "c2cnet": nb, "p2pnet": 25 * nb}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"{name} fuse_p2p eval path: launches {counts}, "
                             f"expected {want}")
    expect_conv_routes(K, "p2pnet.conv", nb, P2PNET_ROUTES)
    log(f"{name} fuse_p2p eval on {smi}: batch_ms "
        f"{json.dumps(res.get('batch_ms'))} (first batch excluded)")

    e = Engine(cfg, model, dev)
    pk, pc = e.packed["p2p_net"], e.packed["c2c_net"]
    pc_cpu = {k: v.cpu() for k, v in pc.items() if torch.is_tensor(v)}
    # C2CNet on each batch's columns: the kernel's scores as the detection
    # read them, its plain version on the card, its emulation on the CPU
    plain = []
    for b, d in enumerate(det[True]):
        cols = d["columns"]
        got = d["hm1d"].reshape(cols.shape[:2])
        with torch.inference_mode():
            ref = kc2c.c2cnet_plain(pc, cols.to(dev)).cpu()
        emu = kc2c.emulate(kc2c.c2cnet_plan(*cols.shape), pc_cpu, cols)
        err = float((got - ref).abs().max())
        tol = C2CNET_BATCH_RTOL * float(ref.abs().max())
        exact = bool(torch.equal(got, emu))
        log(f"  c2cnet batch {b} {tuple(cols.shape)}: bit for bit its CPU "
            f"emulation (the kernel's order of sums) {exact}; max_abs_err "
            f"{err:.3e} from its plain version (tol {tol:.3e} = "
            f"{C2CNET_BATCH_RTOL:g} x scale; "
            f"{err / tol * C2CNET_BATCH_RTOL:.3e} of the scale)")
        if not exact:
            raise AssertionError(f"{name}: c2cnet at batch {b} differs from "
                                 "its emulation")
        held("c2cnet", err, tol, f" at batch {b} ({name} fuse_p2p eval)")
        if b == 0:
            rows["c2cnet"].update({f"{name}_batch_max_abs_err": err,
                                   f"{name}_batch_tol": tol,
                                   f"{name}_batch_emulation_bitwise": exact})
        plain.append({"hm1d": ref.reshape(d["hm1d"].shape)})
    # the float32 JLN (cuDNN's P2PNet) on the fuse_p2p path's proposals:
    # the pose each person would have in float32 at the height the bf16
    # C2CNet picked (`det` was read before the gate was picked: each
    # proposal's mask field is set here at the gate, as place() sets it)
    m32 = FasterVoxelPose(cfg.replace(fuse_p2p=False))
    m32.load_state_dict(state)
    e32 = Engine(cfg.replace(fuse_p2p=False), m32, dev)
    rc = e.rig_constants(rig)
    with torch.inference_mode(), float32_math():
        for d, dt, x in zip(plain, det[True], xs):
            props = dt["proposals"].to(dev)
            props[..., 3] = (props[..., 4] > cfg.min_score).float() - 1.0
            fused, _, confs = e32.model.localize(x, rc, props, e32.packed)
            d["fused_poses"] = e32.model.finish(props, fused, confs)[
                "fused_poses"].cpu()
    fuse_against_float32(name, res["fused_poses"], poses32, specs,
                         {**det, "plain": plain}, cfg.min_score)

    x = xs[0]
    B, Kp, J = x.shape[0], cfg.max_people, cfg.num_joints
    n = cfg.ind_voxels_per_axis[0]
    with torch.inference_mode():
        props = e.model.detect(x, rc, e.packed)["proposals"]
        mask = props[..., 3] >= 0
        planes, _ = ksamp.person_planes(x, rc, cfg, props[..., :3],
                                        props[..., 5:7], mask)
        planes = planes.reshape(3 * B * Kp, n, n, J).contiguous()
        cols = det[True][0]["columns"].to(dev)
        paired = PairedOps()
        khg.run(pk, planes, paired)
        got, ref = khg.p2pnet(pk, planes), khg.p2pnet_plain(pk, planes)
        again = kc2c.c2cnet(pc, cols).cpu()
        err, tol = (float((got - ref).abs().max()),
                    NET_RTOL * float(ref.abs().max()))
        times = {"p2pnet": time_ms(lambda: khg.p2pnet(pk, planes), reps=10),
                 "c2cnet": time_ms(lambda: kc2c.c2cnet(pc, cols))}
    if not torch.equal(again, det[True][0]["hm1d"].reshape(again.shape)):
        raise AssertionError(f"{name}: c2cnet on batch 0's columns again "
                             "differs from the detection's")
    rows["p2pnet"].update({f"{name}_batch_max_abs_err": err,
                           f"{name}_batch_tol": tol})
    log(f"{name} fuse_p2p kernels on batch 0 (B = {B}): p2pnet "
        f"{tuple(planes.shape)}, its {paired.launches} launches each within "
        f"{paired.ulps:.3f} bf16 ulps of the plain op, the whole net "
        f"max_abs_err {err:.3e} (tol {tol:.3e} = {NET_RTOL} x scale); c2cnet "
        f"{tuple(cols.shape)} as above:")
    for k, ms in times.items():
        rows[k][f"{name}_batch_ms"] = ms
        log(f"  {k:15s} {ms:8.4f} ms at B = {B}, {rows[k]['ms']:8.4f} ms "
            f"at B = 1 ({ms / rows[k]['ms']:.2f}x)")
    held("p2pnet", err, tol, f" at B = {B} ({name} fuse_p2p eval)")
    if not paired.ulps <= 1.0:
        raise AssertionError(f"{name}: a P2PNet launch beyond one bf16 ulp")
    return counts, {"batch_ms": res.get("batch_ms"), "fps": res.get("fps"),
                    "kernel_ms": times}


def fuse_against_float32(name, fuse, f32, specs, det, gate) -> None:
    """The fuse_p2p eval's poses against the float32 eval's on the card:
    each path's mask is its detection confidences above the gate (read
    in `det`, the same batches detected alone); the masks identical but
    where a person's two confidences lie on the two sides of the gate.
    Each person kept on both lies within FUSE_POSE_TOL_MM of the float32
    JLN on the fuse_p2p path's proposals (det["plain"]'s fused_poses);
    where the two paths pick the same voxel, that is the float32 eval's
    pose. A person whose height differs (the bf16 C2CNet's rounding,
    where two float32 scores lie close) keeps its xy pick; at most
    FUSE_MAX_KERNEL_ONLY_FLIPS people take a height that C2CNet's plain
    version (cuDNN's bf16 convs on the same columns, det["plain"]'s
    hm1d) does not pick too."""
    def by_record(f, key):
        out = [None] * len(fuse)
        for (_, idx, valid), d in zip(specs, det[f]):
            for b in range(valid):
                out[int(idx[b])] = d[key][b]
        return np.stack([np.asarray(v) for v in out])

    m32, mf = f32[..., 0, 3] >= 0, fuse[..., 0, 3] >= 0
    p32, pf = by_record(False, "proposals"), by_record(True, "proposals")
    hm32, hmf = by_record(False, "hm1d"), by_record(True, "hm1d")
    hmp, jln32 = by_record("plain", "hm1d"), by_record("plain",
                                                      "fused_poses")
    straddle = (p32[..., 4] > gate) != (pf[..., 4] > gate)
    if not (np.array_equal(m32, p32[..., 4] > gate)
            and np.array_equal(mf, pf[..., 4] > gate)
            and np.array_equal(m32 & ~straddle, mf & ~straddle)
            and np.isfinite(fuse).all()):
        raise AssertionError(f"{name} fuse_p2p eval: masks differ from the "
                             "float32 eval's, or non-finite poses")
    both = m32 & mf
    same = (p32[..., :3] == pf[..., :3]).all(axis=-1) & both
    flip = both & ~same
    dist = np.linalg.norm(fuse[..., :3] - f32[..., :3], axis=-1).max(-1)
    dist_j = np.linalg.norm(fuse[..., :3] - jln32[..., :3], axis=-1).max(-1)
    moved = np.linalg.norm(pf[..., :3] - p32[..., :3], axis=-1)
    scale = np.abs(hm32).max(-1)
    gap = (hm32.max(-1) - np.take_along_axis(
        hm32, hmf.argmax(-1)[..., None], -1)[..., 0]) / scale
    shift_k = np.abs(hmf - hm32).max(-1) / scale
    shift_p = np.abs(hmp - hm32).max(-1) / scale
    plain_flip = both & (hmp.argmax(-1) != hm32.argmax(-1))
    kernel_only = flip & (hmp.argmax(-1) != hmf.argmax(-1))
    xy_same = (p32[..., :2] == pf[..., :2]).all(axis=-1)
    kept = dist[same]
    if kept.size < 2:
        raise AssertionError(f"{name} fuse_p2p eval: {kept.size} people "
                             "with the same voxel pick on both paths")
    log(f"{name} fuse_p2p eval against the float32 eval on the card: masks "
        f"identical but for {int(straddle.sum())} people whose two "
        f"confidences lie on the two sides of the gate; {int(both.sum())} "
        f"kept on both, {int(same.sum())} with the same voxel pick, their "
        f"joint distance max {float(kept.max()):.3e} mm; every person kept "
        f"on both from the float32 JLN on the fuse_p2p path's proposals: "
        f"max {float(dist_j[both].max()):.3e} mm (tol {FUSE_POSE_TOL_MM} "
        f"mm), the people it picks another height for "
        f"{float(dist_j[flip].max()) if flip.any() else 0.0:.3e} mm")
    log(f"  C2CNet's scores of the people kept on both, bf16 against the "
        f"float32 module, of each person's scale: the kernel up to "
        f"{float(shift_k[both].max()):.3e} (median "
        f"{float(np.median(shift_k[both])):.3e}), its plain version up to "
        f"{float(shift_p[both].max()):.3e} (median "
        f"{float(np.median(shift_p[both])):.3e}); heights the float32 "
        f"module does not pick: the kernel {int(flip.sum())}, the plain "
        f"version {int(plain_flip.sum())}, both "
        f"{int((flip & plain_flip).sum())}; the kernel's alone "
        f"{int(kernel_only.sum())} (at most {FUSE_MAX_KERNEL_ONLY_FLIPS})")
    flips = [(int(i), int(k), int(hm32[i, k].argmax()),
              int(hmf[i, k].argmax()), round(float(gap[i, k]), 5),
              round(float(moved[i, k]), 1), round(float(dist[i, k]), 3),
              round(float(dist_j[i, k]), 4))
             for i, k in zip(*np.nonzero(flip))]
    log(f"  the kernel's height flips (frame, person, float32 z, fuse_p2p z, "
        f"float32 gap / scale, cube moved mm, joints from the float32 "
        f"eval's mm, from the float32 JLN on the same cube mm): {flips}")
    if not (float(dist_j[both].max()) <= FUSE_POSE_TOL_MM
            and float(kept.max()) <= FUSE_POSE_TOL_MM):
        raise AssertionError(f"{name} fuse_p2p eval: poses beyond "
                             f"{FUSE_POSE_TOL_MM} mm of the float32 JLN's")
    if (flip & ~xy_same).any():
        raise AssertionError(f"{name} fuse_p2p eval: an xy pick differs "
                             "from the float32 eval's")
    if int(kernel_only.sum()) > FUSE_MAX_KERNEL_ONLY_FLIPS:
        raise AssertionError(f"{name} fuse_p2p eval: {int(kernel_only.sum())}"
                             f" heights that the plain version does not "
                             f"pick")


def same_tree(a, b) -> bool:
    """Equality of nested dicts and lists of numbers and arrays."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y)
                                        for x, y in zip(a, b))
    return bool(np.array_equal(np.asarray(a), np.asarray(b),
                               equal_nan=True))


def _plain(x):
    """json.dumps' fallback for numpy numbers and arrays."""
    return x.tolist() if hasattr(x, "tolist") else str(x)


def _leaves(tree):
    if isinstance(tree, (dict, list, tuple)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    elif tree is not None:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
