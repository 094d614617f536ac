"""Predictor refuses a compute_dtype it does not serve.

The reference package builds its nets in `cfg.compute_dtype`; the port
runs float32 only, so a bf16 config must fail at setup rather than be
served in float32 with poses that differ from the reference's."""

import pytest
import torch

from fvp_torch.config import FVPConfig
from fvp_torch.engine.serve import Predictor
from fvp_torch.geometry.cameras import default_ring_rig
from fvp_torch.models.faster_voxelpose import FasterVoxelPose
from fvp_torch.models.resnet import PoseResNet


def _cfg(**kw):
    return FVPConfig(num_joints=15, num_views=2, heatmap_size=(60, 32),
                     image_size=(240, 128), voxels_per_axis=(16, 16, 8),
                     ind_voxels_per_axis=(8, 8, 8), max_people=2,
                     resnet_layers=18, **kw)


def _predictor(cfg, backbone: bool):
    torch.manual_seed(0)
    rig = default_ring_rig(cfg.num_views, cfg.space_center,
                           cfg.ori_image_size)
    state = FasterVoxelPose(cfg).state_dict()
    bb = PoseResNet(cfg.num_joints, cfg.resnet_layers).state_dict() \
        if backbone else None
    return Predictor.from_state_dict(cfg, state, rig, device="cpu",
                                     backbone_state_dict=bb)


@pytest.mark.parametrize("backbone", [False, True])
def test_bfloat16_is_refused(backbone):
    with pytest.raises(ValueError, match="compute_dtype"):
        _predictor(_cfg(compute_dtype="bfloat16"), backbone)


@pytest.mark.parametrize("backbone", [False, True])
def test_float32_builds(backbone):
    pred = _predictor(_cfg(compute_dtype="float32"), backbone)
    assert pred.device == torch.device("cpu")
    assert (pred.backbone is not None) == backbone
