"""Serving: a Predictor that answers frames with fused poses.

It holds the model, the rig constants and the packed kernel weights on one
device, and runs the eval forward per frame. A frame is heatmaps, or, when
the predictor holds a backbone, normalized images. It runs on `cuda` unless
the caller passes a device; without a card and without an explicit device
it raises rather than fall back to the host. `cfg.compute_dtype` is
'float32' or 'bfloat16' (the reference's serving configuration: the
backbone's trunk and the cuDNN task nets in bf16, on the copies that
engine/packing.py::bf16_copy makes at load time); any other raises.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from fvp_torch.config import FVPConfig
from fvp_torch.engine.packing import (check_compute_dtype, pack_backbone,
                                      pack_model)
from fvp_torch.geometry.cameras import CameraRig
from fvp_torch.geometry.grids import build_rig_constants
from fvp_torch.models.convert import (from_jax_backbone_variables,
                                      from_jax_variables)
from fvp_torch.models.faster_voxelpose import FasterVoxelPose
from fvp_torch.models.resnet import PoseResNet


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain path "
                "on the host")
        return torch.device("cuda")
    return torch.device(device)


class Predictor:
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
        check_compute_dtype(cfg.compute_dtype)
        self.cfg = cfg
        self.device = resolve_device(device)
        model = FasterVoxelPose(cfg)
        model.load_state_dict(state_dict)
        self.model = model.eval().to(self.device)
        self.rc = build_rig_constants(cfg, rig).to(self.device)
        self.packed = pack_model(self.model, cfg.compute_dtype)
        self.backbone = None
        if backbone_state_dict is not None:
            bb = PoseResNet(cfg.num_joints, cfg.resnet_layers)
            bb.load_state_dict(backbone_state_dict)
            self.backbone = bb.eval().to(self.device)
            self.backbone_packed = pack_backbone(self.backbone,
                                                 cfg.compute_dtype)

    @torch.inference_mode()
    def heatmaps(self, images) -> torch.Tensor:
        """The backbone alone: images (B, V, H, W, 3) -> heatmaps (B, V, J,
        h, w) float32 on the predictor's device."""
        if self.backbone is None:
            raise ValueError("this predictor holds no backbone")
        x = torch.as_tensor(images, dtype=torch.float32,
                            device=self.device).contiguous()
        B, V = x.shape[:2]
        hm = self.backbone(x.reshape(B * V, *x.shape[2:]),
                           self.backbone_packed)          # (BV, h, w, J)
        w, h = self.cfg.heatmap_size
        if tuple(hm.shape[1:3]) != (h, w):
            raise ValueError(f"backbone heatmaps {tuple(hm.shape[1:3])} "
                             f"(h, w), config heatmap_size (w, h) {(w, h)}")
        return hm.reshape(B, V, *hm.shape[1:]).permute(0, 1, 4, 2, 3) \
            .contiguous()

    @torch.inference_mode()
    def __call__(self, frame) -> dict[str, torch.Tensor]:
        if self.backbone is not None:
            hm = self.heatmaps(frame)
        else:
            hm = torch.as_tensor(frame, dtype=torch.float32,
                                 device=self.device).contiguous()
        out = self.model(hm, self.rc, self.packed)
        return {k: out[k] for k in ("fused_poses", "proposals", "mask")}
