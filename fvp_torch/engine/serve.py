"""Serving: a Predictor that answers frames with fused poses.

`Engine` holds the model (and a backbone), their packed kernel weights and
the rig constants on one device; `Predictor` is an engine with one rig
that runs the eval forward per frame, and engine/validate.py evaluates
datasets through an engine. A frame is heatmaps, or, when
the predictor holds a backbone, normalized images. It runs on `cuda` unless
the caller passes a device; without a card and without an explicit device
it raises rather than fall back to the host. `cfg.compute_dtype` is
'float32' or 'bfloat16' (the reference's serving configuration: the
backbone's trunk and the cuDNN task nets in bf16, on the copies that
engine/packing.py::bf16_copy makes at load time); any other raises.

float32 means float32 on the card too: the entry points (Predictor,
Engine.heatmaps, the eval step of engine/validate.py, the trainer of
engine/train.py) compute inside `float32_math`, which turns TF32 off for
cuDNN convs and matmuls whatever the caller's flags say (PyTorch lets
cuDNN convs use TF32 by default) and restores the flags afterwards. The
bf16 kernels and bf16 copies are not affected.
"""

from __future__ import annotations

import contextlib
from typing import Any, Mapping

import torch

from fvp_torch.config import FVPConfig
from fvp_torch.engine.packing import (check_compute_dtype, pack_backbone,
                                      pack_model)
from fvp_torch.geometry.cameras import CameraRig
from fvp_torch.geometry.grids import RigConstants, build_rig_constants
from fvp_torch.models.convert import (from_jax_backbone_variables,
                                      from_jax_variables)
from fvp_torch.models.faster_voxelpose import FasterVoxelPose
from fvp_torch.models.resnet import PoseResNet


@contextlib.contextmanager
def float32_math():
    """TF32 off for cuDNN convs and for matmuls inside; the caller's flags
    restored on the way out. Also a decorator.

    Where torch has the per-backend `fp32_precision` strings, it sets
    `cudnn.conv` and `cuda.matmul` to 'ieee' and restores the two strings
    exactly, and never touches the legacy `allow_tf32` flags: torch
    refuses to read those once a caller has set TF32 through the new
    strings (torch.backends.fp32_precision, cudnn.fp32_precision or
    cuda.matmul.fp32_precision), and a legacy write would leave
    cudnn.conv at a caller's 'tf32'. Autograd reads the same global
    strings, so a backward run inside computes in float32 too. A torch
    without those strings takes the legacy flags."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    conv = getattr(cudnn, "conv", None)
    if hasattr(conv, "fp32_precision"):
        saved = conv.fp32_precision, matmul.fp32_precision
        conv.fp32_precision = matmul.fp32_precision = "ieee"
        try:
            yield
        finally:
            conv.fp32_precision, matmul.fp32_precision = saved
        return
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain path "
                "on the host")
        return torch.device("cuda")
    return torch.device(device)


def backbone_heatmaps(cfg: FVPConfig, backbone: PoseResNet, packed: dict,
                      images: torch.Tensor) -> torch.Tensor:
    """The backbone on normalized float32 images (B, V, H, W, 3) on its
    device -> heatmaps (B, V, J, h, w); they must come out at
    cfg.heatmap_size."""
    x = images.contiguous()
    B, V = x.shape[:2]
    hm = backbone(x.reshape(B * V, *x.shape[2:]), packed)    # (BV, h, w, J)
    w, h = cfg.heatmap_size
    if tuple(hm.shape[1:3]) != (h, w):
        raise ValueError(f"backbone heatmaps {tuple(hm.shape[1:3])} "
                         f"(h, w), config heatmap_size (w, h) {(w, h)}")
    return hm.reshape(B, V, *hm.shape[1:]).permute(0, 1, 4, 2, 3) \
        .contiguous()


class Engine:
    """What serving and evaluation share: the model (and a backbone, where
    given) in eval mode on one device, their kernel weights packed once
    for `cfg.compute_dtype`, and the rig constants on that device.
    `Predictor` serves frames of one rig from it;
    engine/validate.py::run_validation evaluates datasets through it."""

    def __init__(self, cfg: FVPConfig, model: FasterVoxelPose, device=None,
                 backbone: PoseResNet | None = None):
        check_compute_dtype(cfg.compute_dtype)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.eval().to(self.device)
        self.packed = pack_model(self.model, cfg.compute_dtype)
        self.backbone = None
        self.backbone_packed = None
        if backbone is not None:
            self.backbone = backbone.eval().to(self.device)
            self.backbone_packed = pack_backbone(self.backbone,
                                                 cfg.compute_dtype)

    def rig_constants(self, rig: CameraRig) -> RigConstants:
        return build_rig_constants(self.cfg, rig).to(self.device)

    @torch.inference_mode()
    @float32_math()
    def heatmaps(self, images) -> torch.Tensor:
        """The backbone alone: images (B, V, H, W, 3) -> heatmaps (B, V, J,
        h, w) float32 on the engine's device."""
        if self.backbone is None:
            raise ValueError("this engine holds no backbone")
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        return backbone_heatmaps(self.cfg, self.backbone,
                                 self.backbone_packed, x)


class Predictor(Engine):
    """`Predictor(cfg, variables_np, rig, device=None,
    backbone_variables_np=None)`: variables_np is the reference package's
    flax {'params', 'batch_stats'} tree of FasterVoxelPose as numpy arrays,
    backbone_variables_np that of its PoseResNet (cfg.resnet_layers deep).

    `predictor(frame)` returns {'fused_poses' (B, K, J, 5), 'proposals'
    (B, K, 7), 'mask' (B, K)} as tensors on the predictor's device. The
    frame is heatmaps (B, V, J, h, w) without a backbone, and normalized
    float32 images (B, V, H, W, 3) with one; their heatmaps must come out
    at cfg.heatmap_size."""

    def __init__(self, cfg: FVPConfig, variables_np: Mapping[str, Any],
                 rig: CameraRig, device=None,
                 backbone_variables_np: Mapping[str, Any] | None = None):
        bb = None if backbone_variables_np is None \
            else from_jax_backbone_variables(backbone_variables_np)
        self._setup(cfg, from_jax_variables(variables_np), rig, device, bb)

    @classmethod
    def from_state_dict(cls, cfg: FVPConfig,
                        state_dict: Mapping[str, torch.Tensor],
                        rig: CameraRig, device=None,
                        backbone_state_dict: Mapping[str, torch.Tensor]
                        | None = None) -> "Predictor":
        """A predictor from port (reference-keyed) state dicts."""
        self = cls.__new__(cls)
        self._setup(cfg, state_dict, rig, device, backbone_state_dict)
        return self

    def _setup(self, cfg, state_dict, rig, device, backbone_state_dict
               ) -> None:
        model = FasterVoxelPose(cfg)
        model.load_state_dict(state_dict)
        backbone = None
        if backbone_state_dict is not None:
            backbone = PoseResNet(cfg.num_joints, cfg.resnet_layers)
            backbone.load_state_dict(backbone_state_dict)
        Engine.__init__(self, cfg, model, device, backbone)
        self.rc = self.rig_constants(rig)

    @torch.inference_mode()
    @float32_math()
    def __call__(self, frame) -> dict[str, torch.Tensor]:
        if self.backbone is not None:
            hm = self.heatmaps(frame)
        else:
            hm = torch.as_tensor(frame, dtype=torch.float32,
                                 device=self.device).contiguous()
        out = self.model(hm, self.rc, self.packed)
        return {k: out[k] for k in ("fused_poses", "proposals", "mask")}
