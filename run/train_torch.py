#!/usr/bin/env python
"""Train CLI of the PyTorch port: `python run/train_torch.py --cfg
configs/test/tiny_synthetic.yaml [--epochs N] [--resume] [--device cpu]`.

The reference package's run/train.py with the port's trainer
(fvp_torch/engine/train.py): the config's train and test datasets, the
model initialised from cfg.seed (the reference package's default scheme,
or the original implementation's with --torch-init / TRAIN.INIT_SCHEME
reference), a frozen backbone from PRETRAINED_BACKBONE for the image
source, batches grouped by sequence (one rig a step), the losses kept on
the device between prints, evaluation through run_validation every
--eval-every epochs (the model is packed anew for it, then goes back to
train mode), and checkpoints in the config's OUTPUT_DIR/<cfg name>/:
checkpoint.pth (the full train state; --resume continues from it, in the
middle of an epoch too) and model_best.pth (a state dict that
run/validate_torch.py --checkpoint reads). It runs on `cuda` unless
--device says otherwise, and raises without a card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fvp_torch.config import load_config  # noqa: E402
from fvp_torch.data.loader import prefetch, seq_grouped_batches  # noqa: E402
from fvp_torch.data.registry import build_dataset  # noqa: E402
from fvp_torch.engine.checkpoint import (load_backbone_state,  # noqa: E402
                                         load_checkpoint, save_best,
                                         save_checkpoint)
from fvp_torch.engine.init import flax_init, reference_reinit  # noqa: E402
from fvp_torch.engine.serve import resolve_device  # noqa: E402
from fvp_torch.engine.train import LOSS_KEYS, Trainer, step_inputs  # noqa: E402
from fvp_torch.engine.validate import run_validation  # noqa: E402
from fvp_torch.geometry.grids import build_rig_constants  # noqa: E402
from fvp_torch.models.faster_voxelpose import FasterVoxelPose  # noqa: E402
from fvp_torch.models.resnet import PoseResNet  # noqa: E402
from fvp_torch.utils.logging import (AverageMeter, MetricWriter,  # noqa: E402
                                     create_logger)


def load_backbone(cfg):
    """The frozen backbone of PRETRAINED_BACKBONE (a reference-keyed torch
    state dict, .pth/.tar, or the reference's backbone msgpack), or None
    without one."""
    if not cfg.pretrained_backbone:
        return None
    backbone = PoseResNet(cfg.num_joints, cfg.resnet_layers)
    backbone.load_state_dict(load_backbone_state(cfg.pretrained_backbone))
    return backbone


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--save-every", type=int, default=0,
                        help="also checkpoint every N steps mid-epoch "
                             "(0 = per-epoch only)")
    parser.add_argument("--checkpoint-every", type=int, default=1,
                        help="save the rolling checkpoint every N epochs "
                             "(always on the final epoch)")
    parser.add_argument("--eval-every", type=int, default=1,
                        help="run the held-out evaluation every N epochs "
                             "(always on the final epoch)")
    parser.add_argument("--torch-init", action="store_true",
                        help="the original implementation's init scheme "
                             "(engine/init.py::reference_reinit)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu' for the plain path")
    args = parser.parse_args(argv)
    if args.checkpoint_every < 1:
        parser.error("--checkpoint-every must be >= 1")
    if args.eval_every < 1:
        parser.error("--eval-every must be >= 1")

    cfg = load_config(args.cfg)
    if args.epochs is not None:
        cfg = cfg.replace(end_epoch=args.epochs)
    device = resolve_device(None if args.device == "cuda" else args.device)
    cfg_name = os.path.splitext(os.path.basename(args.cfg))[0]
    logger, out_dir = create_logger(cfg.output_dir, cfg_name, "train_torch")
    writer = MetricWriter(out_dir)
    logger.info(f"config: {cfg}")
    logger.info(f"device: {device}")

    train_ds = build_dataset(cfg.train_dataset, cfg, is_train=True)
    test_ds = build_dataset(cfg.test_dataset, cfg, is_train=False)
    logger.info(f"train: {len(train_ds)} frames, test: {len(test_ds)}")
    if cfg.lr_decay_epochs and not cfg.steps_per_epoch:
        # the LR schedule counts optimizer updates: fill in the epoch length
        cfg = cfg.replace(
            steps_per_epoch=max(len(train_ds) // cfg.batch_size, 1))

    backbone = load_backbone(cfg)
    if cfg.train_heatmap_src == "image" and backbone is None:
        raise ValueError("TRAIN_HEATMAP_SRC=image requires "
                         "NETWORK.PRETRAINED_BACKBONE")
    model = FasterVoxelPose(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)
    flax_init(model, gen)
    if args.torch_init or cfg.init_scheme == "reference":
        reference_reinit(model, torch.Generator().manual_seed(cfg.seed + 77))
        logger.info("initialised from the original implementation's scheme")
    trainer = Trainer(cfg, model, device,
                      backbone if cfg.train_heatmap_src == "image" else None)
    rcs = {seq: build_rig_constants(cfg, rig).to(device)
           for seq, rig in train_ds.rigs.items()}

    start_epoch, best, start_step = cfg.begin_epoch, -np.inf, 0
    if args.resume:
        restored = load_checkpoint(out_dir, trainer)
        if restored:
            start_epoch, best, start_step = restored
            logger.info(f"resumed from epoch {start_epoch}"
                        + (f" step {start_step}" if start_step else ""))
    steps_per_epoch = max(len(train_ds) // cfg.batch_size, 1)

    for epoch in range(start_epoch, cfg.end_epoch):
        if not (epoch == start_epoch and start_step):
            # the quirk's window restarts each epoch; a mid-epoch resume
            # keeps the checkpointed one
            trainer.reset_accumulation()
        meters = {k: AverageMeter() for k in LOSS_KEYS + ("batch_time",)}
        it = prefetch(iter(seq_grouped_batches(train_ds, cfg.batch_size,
                                               cfg.seed, epoch)))
        pending: list = []
        t_end = time.perf_counter()
        for i, (seq, batch) in enumerate(it):
            if epoch == start_epoch and i < start_step:
                continue       # fast-forward a mid-epoch resume
            x, targets, meta = step_inputs(batch, device)
            # losses stay device scalars until a print needs them
            pending.append(trainer.train_step(x, rcs[seq], targets, meta))
            now = time.perf_counter()
            meters["batch_time"].update(now - t_end)
            t_end = now
            if i % cfg.print_freq == 0:
                for losses in pending:
                    for k in LOSS_KEYS:
                        meters[k].update(float(losses[k]))
                pending.clear()
                logger.info(
                    f"epoch {epoch} [{i}/{steps_per_epoch}] "
                    f"loss {meters['total'].avg:.5f} "
                    f"(2d {meters['2d_heatmaps'].avg:.5f} "
                    f"1d {meters['1d_heatmaps'].avg:.5f} "
                    f"bbox {meters['bbox'].avg:.5f} "
                    f"joint {meters['joint'].avg:.5f}) "
                    f"batch {meters['batch_time'].avg * 1000:.0f} ms")
                writer.add_scalars(trainer.step, **{
                    f"train_loss_{k}": meters[k].avg for k in LOSS_KEYS})
            if args.save_every and i and i % args.save_every == 0:
                save_checkpoint(out_dir, trainer, epoch, best,
                                step_in_epoch=i + 1)

        has_eval = getattr(test_ds, "has_evaluate_function", False)
        # without an evaluator there is no score: best == latest weights
        is_best = not has_eval
        if has_eval and ((epoch + 1) % args.eval_every == 0
                         or epoch == cfg.end_epoch - 1):
            # run_validation packs the current weights and puts the model
            # in eval mode; training resumes in train mode
            res = run_validation(cfg, trainer.model, test_ds,
                                 backbone=backbone, device=device,
                                 log=logger.info)
            trainer.model.train()
            metrics = res.get("metrics", {})
            logger.info(f"epoch {epoch} metrics: {metrics}")
            score = metrics.get("mean_ap", metrics.get("avg_pcp", 0.0))
            if score >= best:
                best = score
                save_best(out_dir, trainer.model)
                logger.info(f"saved model_best (score {score:.4f})")
            writer.add_scalars(trainer.step, eval_score=score)

        if ((epoch + 1) % args.checkpoint_every == 0
                or epoch == cfg.end_epoch - 1):
            save_checkpoint(out_dir, trainer, epoch + 1, best,
                            is_best=is_best)
            logger.info("saved checkpoint")
    return 0


if __name__ == "__main__":
    sys.exit(main())
