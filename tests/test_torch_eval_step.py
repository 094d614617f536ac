"""The port's make_eval_step (fvp_torch/engine/validate.py) on the CPU:
for the 'image' heatmap source, images through a small ResNet backbone
and the model against the reference package's eval step; for the 'gt'
source a given backbone is ignored, as the reference ignores it
(fvp_tpu/engine/validate.py:48-49)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import fvp_torch.config as tcfg
from fvp_torch.engine.packing import pack_backbone, pack_model
from fvp_torch.engine.validate import make_eval_step
from fvp_torch.geometry.grids import build_rig_constants as t_rig_constants
from fvp_tpu.engine import validate as jval
from fvp_tpu.geometry.grids import build_rig_constants
from fvp_tpu.models.faster_voxelpose import FasterVoxelPose
from tests.test_torch_backbone import (POSE_ATOL_MM, image_cfg,  # noqa: F401
                                       resnet18)
from tests.test_torch_nets import port_model


def test_eval_step_images_match_reference(resnet18, image_cfg):  # noqa: F811
    """'image' source: images (B, V, H, W, 3) through the backbone and the
    model, against the reference's eval step (its flax backbone with the
    host space-to-depth stem and the Pallas head, as the backbone tests
    hold the port's)."""
    from fvp_tpu.engine.packing import pack_backbone_variables
    from fvp_tpu.models.resnet import PoseResNet as FlaxPoseResNet
    from fvp_tpu.ops.pallas.stem import s2d_host
    from fvp_torch.models.convert import from_jax_backbone_variables
    from fvp_torch.models.resnet import PoseResNet

    _, bb_vars, images, _ = resnet18
    cfg, variables, rig, trig = image_cfg
    cfg = cfg.replace(test_heatmap_src="image")
    flax_bb = FlaxPoseResNet(num_joints=15, num_layers=18, stem="host_s2d",
                             head="pallas")
    B, V = images.shape[:2]
    s2d = s2d_host(images.reshape(B * V, *images.shape[2:]))
    # packed before jit, as the reference's run_validation packs it
    step = jval.make_eval_step(cfg, FasterVoxelPose(cfg=cfg), flax_bb,
                               pack_backbone_variables(bb_vars))
    ref = np.asarray(step(variables, jnp.asarray(
        s2d.reshape(B, V, *s2d.shape[1:])), build_rig_constants(cfg, rig)))

    t = tcfg.FVPConfig(**dataclasses.asdict(cfg))
    model = port_model(cfg, variables)
    bb = PoseResNet(15, 18)
    bb.load_state_dict(from_jax_backbone_variables(bb_vars))
    bb.eval()
    got = make_eval_step(t, model, pack_model(model), bb,
                         pack_backbone(bb))(
        torch.from_numpy(images), t_rig_constants(t, trig).to("cpu")).numpy()
    mask = got[..., 0, 3] >= 0
    assert 2 <= mask.sum()
    np.testing.assert_array_equal(mask, ref[..., 0, 3] >= 0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=POSE_ATOL_MM)


def test_eval_step_ignores_backbone_for_gt_source(  # noqa: F811
        resnet18, image_cfg):
    port_bb = resnet18[0]
    cfg, variables, _, trig = image_cfg
    t = tcfg.FVPConfig(**dataclasses.asdict(cfg)).replace(
        test_heatmap_src="gt")
    model = port_model(cfg, variables)
    packed = pack_model(model)
    rc = t_rig_constants(t, trig).to("cpu")
    w, h = t.heatmap_size
    hm = torch.from_numpy(np.random.RandomState(2).rand(
        2, t.num_views, t.num_joints, h, w).astype(np.float32))
    with_bb = make_eval_step(t, model, packed, port_bb,
                             pack_backbone(port_bb))(hm, rc)
    without = make_eval_step(t, model, packed)(hm, rc)
    with torch.inference_mode():
        direct = model(hm, rc, packed)["fused_poses"]
    assert torch.equal(with_bb, without) and torch.equal(without, direct)
