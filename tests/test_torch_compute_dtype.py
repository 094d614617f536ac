"""Predictor serves the compute_dtypes of the reference package's
configurations, float32 and bfloat16 (its serving configuration), and
refuses any other at setup rather than serve it in another dtype with
poses that differ from the reference's."""

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
def test_other_dtypes_are_refused(backbone):
    with pytest.raises(ValueError, match="compute_dtype"):
        _predictor(_cfg(compute_dtype="float16"), backbone)


@pytest.mark.parametrize("backbone", [False, True])
def test_bfloat16_builds(backbone):
    """The bf16 predictor: its packed weights hold bf16 copies of the
    task nets (float32 heads) and (ResNet-18: all four layers on cuDNN, no
    stage kernel) of the trunk's layers; the model's own parameters stay
    float32."""
    pred = _predictor(_cfg(compute_dtype="bfloat16"), backbone)
    nets = pred.packed["bf16_nets"]
    assert nets["conv_net"].front_layers[0].block[0].weight.dtype \
        == torch.bfloat16
    assert nets["conv_net"].front_layers[0].block[1].weight.dtype \
        == torch.float32                         # BN
    assert nets["conv_net"].output_layer.weight.dtype == torch.float32
    assert nets["c2c_net"].output_hm.weight.dtype == torch.float32
    conv = pred.model.joint_net.conv_net.front_layers[0].block[0]
    assert conv.weight.dtype == torch.float32
    if backbone:
        assert pred.backbone_packed["compute_dtype"] == "bfloat16"
        assert "layer1" not in pred.backbone_packed
        trunk = pred.backbone_packed["trunk"]
        assert len(trunk) == 4
        assert trunk[0][0].conv1.weight.dtype == torch.bfloat16
        assert pred.backbone.layer1[0].conv1.weight.dtype == torch.float32


@pytest.mark.parametrize("backbone", [False, True])
def test_float32_builds(backbone):
    pred = _predictor(_cfg(compute_dtype="float32"), backbone)
    assert pred.device == torch.device("cpu")
    assert (pred.backbone is not None) == backbone
