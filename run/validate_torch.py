#!/usr/bin/env python
"""Validate CLI of the PyTorch port: `python run/validate_torch.py --cfg
configs/test/tiny_synthetic.yaml [--checkpoint model.pth] [--device cpu]`.

Builds the config's test dataset, the model (and, for the image heatmap
source, the backbone from PRETRAINED_BACKBONE), loads the checkpoint, runs
fvp_torch.engine.validate.run_validation and logs FPS (first batch
excluded) and the dataset's metrics. It runs on `cuda` unless --device
says otherwise, and raises without a card.

A checkpoint is a torch state dict of FasterVoxelPose with the original
implementation's keys (`pose_net.center_net.*`, `pose_net.c2c_net.*`,
`joint_net.conv_net.*`, `joint_net.weight_net.*`), plain or wrapped as
{'state_dict': ...}, with or without a `module.` prefix; it is read with
weights_only=True, and missing or unexpected keys raise. Without one the
run warns and uses seeded random weights. PRETRAINED_BACKBONE is a torch
state dict of the PoseResNet in the same layout (.pth / .tar); without one
the image source warns and uses a seeded backbone.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from fvp_torch.config import load_config  # noqa: E402
from fvp_torch.data.registry import build_dataset  # noqa: E402
from fvp_torch.engine.serve import resolve_device  # noqa: E402
from fvp_torch.engine.validate import run_validation  # noqa: E402
from fvp_torch.models.faster_voxelpose import FasterVoxelPose  # noqa: E402
from fvp_torch.models.resnet import PoseResNet, seeded_state_dict  # noqa: E402
from fvp_torch.utils.logging import create_logger  # noqa: E402


def load_state_dict(path: str) -> dict:
    """A reference-keyed state dict from a torch file: the dict itself or
    its 'state_dict' entry, a leading `module.` (DataParallel) dropped."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and isinstance(state.get("state_dict"), dict):
        state = state["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--checkpoint", default=None,
                        help="torch state dict of FasterVoxelPose "
                             "(reference keys)")
    parser.add_argument("--seed", type=int, default=None,
                        help="override cfg.seed: the eval heatmap "
                             "augmentation draws and the held-out "
                             "synthetic scenes derive from it")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu' for the plain path")
    args = parser.parse_args(argv)

    cfg = load_config(args.cfg)
    if args.seed is not None:
        cfg = cfg.replace(seed=args.seed)
    device = resolve_device(None if args.device == "cuda" else args.device)
    cfg_name = os.path.splitext(os.path.basename(args.cfg))[0]
    logger, _ = create_logger(cfg.output_dir, cfg_name, "validate_torch")

    test_ds = build_dataset(cfg.test_dataset, cfg, is_train=False)
    logger.info(f"test: {len(test_ds)} frames on {device}")

    torch.manual_seed(cfg.seed)      # the weights without a checkpoint
    model = FasterVoxelPose(cfg)
    if args.checkpoint:
        model.load_state_dict(load_state_dict(args.checkpoint))
        logger.info(f"loaded {args.checkpoint}")
    else:
        logger.warning("no checkpoint; seeded random weights")

    backbone = None
    if cfg.test_heatmap_src == "image":
        backbone = PoseResNet(cfg.num_joints, cfg.resnet_layers)
        if cfg.pretrained_backbone:
            backbone.load_state_dict(load_state_dict(cfg.pretrained_backbone))
            logger.info(f"loaded backbone {cfg.pretrained_backbone}")
        else:
            logger.warning("no PRETRAINED_BACKBONE; seeded backbone")
            backbone.load_state_dict(seeded_state_dict(backbone, cfg.seed))

    res = run_validation(cfg, model, test_ds, backbone=backbone,
                         device=device, log=logger.info)
    if "fps" in res:
        logger.info(f"FPS (warm-up excluded): {res['fps']:.2f}  "
                    f"batch ms: {res['batch_ms']}")
    if "metrics" in res:
        logger.info(f"metrics: {res['metrics']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
