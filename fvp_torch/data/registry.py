"""Dataset registry: name -> constructor, as the reference package's
`data/registry.py` (after the original implementation's dynamic dispatch,
lib/dataset/__init__.py:10-14)."""

from __future__ import annotations

import os.path as osp

from fvp_torch.config import FVPConfig


def build_dataset(name: str, cfg: FVPConfig, is_train: bool):
    name = name.lower()
    if name == "panoptic":
        from fvp_torch.data.panoptic import PanopticDataset
        return PanopticDataset(cfg, is_train)
    if name == "shelf":
        from fvp_torch.data.shelf import ShelfDataset
        return ShelfDataset(cfg, is_train)
    if name == "campus":
        from fvp_torch.data.shelf import CampusDataset
        return CampusDataset(cfg, is_train)
    if name == "custom":
        from fvp_torch.data.custom import CustomDataset
        return CustomDataset(cfg, is_train)
    if name == "synthetic":
        from fvp_torch.data.synthetic import SyntheticDataset
        cam_file = osp.join(cfg.data_dir, cfg.synthetic_camera_file)
        if cfg.synthetic_camera_file and osp.exists(cam_file):
            from fvp_torch.data.shelf import load_json_calibration
            rig = load_json_calibration(cam_file)
        else:
            from fvp_torch.geometry.cameras import default_ring_rig
            rig = default_ring_rig(cfg.num_views, cfg.space_center,
                                   cfg.ori_image_size)
        # held-out test split: disjoint scene seed so eval never sees a
        # training scene
        seed = cfg.seed if is_train else cfg.seed + 999983
        return SyntheticDataset(cfg, rig, seed=seed, is_train=is_train)
    raise ValueError(f"unknown dataset {name!r}")
