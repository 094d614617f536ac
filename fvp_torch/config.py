"""Static configuration of the PyTorch port.

A copy of the reference package's `FVPConfig` with the same fields and
defaults, of `load_config`, which reads the reference-schema YAML files
under configs/, and of `gen_config`, which writes one. Unknown keys
raise. The port keeps its own copy so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Sequence

import yaml


def _t3(x: Sequence[float]) -> tuple[float, float, float]:
    a, b, c = x
    return (float(a), float(b), float(c))


def _i3(x: Sequence[int]) -> tuple[int, int, int]:
    a, b, c = x
    return (int(a), int(b), int(c))


def _t2(x: Sequence[float]) -> tuple[float, float]:
    a, b = x
    return (float(a), float(b))


def _i2(x: Sequence[int]) -> tuple[int, int]:
    a, b = x
    return (int(a), int(b))


@dataclass(frozen=True)
class FVPConfig:
    """All static hyper-parameters of the pipeline (frozen, hashable).
    Fields and defaults equal the reference package's FVPConfig; fields
    that only steer the TPU build (band heights, backbone lowering modes,
    sampling_backend) are kept so one YAML file serves both."""

    # --- dataset geometry ------------------------------------------------
    num_joints: int = 15
    num_views: int = 5
    # (w, h) conventions follow the reference YAMLs.
    ori_image_size: tuple[int, int] = (1920, 1080)
    image_size: tuple[int, int] = (960, 512)
    heatmap_size: tuple[int, int] = (240, 128)
    # root joint: int index or tuple of indices (averaged)
    root_joint_id: tuple[int, ...] = (2,)

    # --- capture space ---------------------------------------------------
    space_size: tuple[float, float, float] = (8000.0, 8000.0, 2000.0)
    space_center: tuple[float, float, float] = (0.0, -500.0, 800.0)
    voxels_per_axis: tuple[int, int, int] = (80, 80, 20)
    max_people: int = 10
    min_score: float = 0.3

    # --- per-person (individual) space -----------------------------------
    ind_space_size: tuple[float, float, float] = (2000.0, 2000.0, 2000.0)
    ind_voxels_per_axis: tuple[int, int, int] = (64, 64, 64)

    # --- network ---------------------------------------------------------
    beta: float = 100.0            # soft-argmax temperature
    # y-band heights of the reference package's tiled TPU sampler; the
    # port samples exactly and does not read them
    jln_band_height: int = 16
    whole_band_height: int = 32
    sigma: float = 3.0             # input-heatmap gaussian sigma (heatmap px)
    num_channel_joint_feat: int = 32
    num_channel_joint_hidden: int = 64
    backbone: str = "resnet"       # '' to disable (heatmap-input datasets)
    resnet_layers: int = 50
    pretrained_backbone: str = ""
    # backbone lowering modes of the reference package (not read here)
    backbone_stem: str = "xla"     # xla | s2d | host_s2d (Pallas, s2d feed)
    backbone_head: str = "xla"     # xla | fused | polyphase | pallas
    # run C2CNet and P2PNet as the bf16 kernels of the reference's fused
    # nets (ops/kernels/c2cnet.py, hourglass.py) instead of cuDNN modules
    fuse_p2p: bool = False

    # --- training --------------------------------------------------------
    train_dataset: str = "panoptic"
    test_dataset: str = "panoptic"
    train_heatmap_src: str = "image"   # image | gt | pred
    test_heatmap_src: str = "image"
    data_dir: str = ""
    batch_size: int = 8
    test_batch_size: int = 8
    lr: float = 1e-4
    # optional step-decay schedule (extension; the reference trains a
    # fixed LR): multiply LR by lr_decay_factor at each listed epoch.
    # steps_per_epoch is filled in by the train CLI from the dataset size.
    lr_decay_epochs: tuple = ()
    lr_decay_factor: float = 0.1
    steps_per_epoch: int = 0
    begin_epoch: int = 0
    end_epoch: int = 10
    lambda_loss_2d: float = 1.0
    lambda_loss_1d: float = 1.0
    lambda_loss_bbox: float = 0.1
    lambda_loss_fused: float = 5.0
    accumulation_steps: int = 4    # HDN-loss gradient accumulation window
    # Quirk-exact replication of the reference's accumulate-then-step
    # interleaving (lib/core/function.py:28,79-85): the HDN optimizer steps
    # at every k-th batch on the PREVIOUS k-1 batches' mean detection loss
    # and the k-th batch's detection loss is dropped from the window
    # entirely (its `else` branch never runs); the window also resets at
    # each epoch boundary. False = clean optax.MultiSteps k-batch average.
    accumulation_quirk: bool = False
    # weight-init family (extension): 'flax' = flax defaults
    # (lecun_normal kernels + zero biases); 'reference' = the reference's
    # actual scheme (N(0, 0.001) + zero bias for CenterNet/C2C/P2P —
    # lib/models/cnns_2d.py:224-232, cnns_1d.py:231-241 — and torch
    # DEFAULTS for WeightNet, whose _initialize_weights is never invoked,
    # weight_net.py:82-90). See fvp_tpu/engine/init.py.
    init_scheme: str = "flax"
    data_augmentation: bool = False
    # render gt/pred input heatmaps on the device instead of the host
    device_render: bool = False

    # --- synthetic data factory ------------------------------------------
    synthetic_camera_file: str = ""
    synthetic_pose_file: str = ""
    synthetic_max_people: int = 10
    synthetic_num_data: int = 10000
    synthetic_augmentation: bool = True
    # Framework extension (no reference counterpart): load pre-generated
    # scene records from a pickle instead of sampling them, so two
    # frameworks can train on byte-identical scenes (cross-framework A/B).
    synthetic_scene_file: str = ""

    # --- runtime ---------------------------------------------------------
    output_dir: str = "output"
    print_freq: int = 100
    seed: int = 0
    # the reference package's sampler choice: 'auto', 'pallas' or 'exact'
    # (the port always samples exactly, in its kernels on the card)
    sampling_backend: str = "auto"
    # network compute dtype: 'float32' or 'bfloat16' (the reference's
    # serving configuration; engine/serve.py)
    compute_dtype: str = "float32"

    # ------------------------------------------------------------------
    def __post_init__(self):
        # fail fast in EVERY consumer (not just run/train.py): a YAML typo
        # like INIT_SCHEME: torch must not silently mean 'flax'
        if self.init_scheme not in ("flax", "reference"):
            raise ValueError(
                f"TRAIN.INIT_SCHEME {self.init_scheme!r} is not one of "
                "('flax', 'reference')")
        if self.sampling_backend not in ("auto", "pallas", "exact"):
            raise ValueError(
                f"sampling_backend {self.sampling_backend!r} is not one of "
                "('auto', 'pallas', 'exact')")

    @property
    def fine_voxels_per_axis(self) -> tuple[int, int, int]:
        """Fine-grid axis counts: whole-space voxelization at the individual
        cube's pitch (reference: project_individual.py:50)."""
        return tuple(
            int(ws / is_ * (v - 1)) + 1
            for ws, is_, v in zip(
                self.space_size, self.ind_space_size, self.ind_voxels_per_axis
            )
        )

    @property
    def num_bins(self) -> int:
        vx, vy, vz = self.voxels_per_axis
        return vx * vy * vz

    def replace(self, **kw: Any) -> "FVPConfig":
        return dataclasses.replace(self, **kw)


# YAML section -> (config attr, converter) mapping for the reference schema.
def _apply_yaml(cfg_kw: dict[str, Any], doc: dict[str, Any]) -> None:
    known_ignored = {"CUDNN", "HIGHER_HRNET", "DEVICE", "WORKERS", "MODEL",
                     "LOG_DIR", "TEST"}

    def take(section: dict, key: str, attr: str, conv=lambda x: x):
        if key in section:
            cfg_kw[attr] = conv(section.pop(key))

    for sec_name, sec in list(doc.items()):
        if sec_name == "DATASET":
            take(sec, "NUM_JOINTS", "num_joints", int)
            take(sec, "CAMERA_NUM", "num_views", int)
            take(sec, "ORI_IMAGE_SIZE", "ori_image_size", _i2)
            take(sec, "IMAGE_SIZE", "image_size", _i2)
            take(sec, "HEATMAP_SIZE", "heatmap_size", _i2)
            take(sec, "DATADIR", "data_dir", str)
            take(sec, "TRAIN_DATASET", "train_dataset", str)
            take(sec, "TEST_DATASET", "test_dataset", str)
            take(sec, "TRAIN_HEATMAP_SRC", "train_heatmap_src", str)
            take(sec, "TEST_HEATMAP_SRC", "test_heatmap_src", str)
            take(sec, "DATA_AUGMENTATION", "data_augmentation", bool)
            take(sec, "DEVICE_RENDER", "device_render", bool)
            if "ROOT_JOINT_ID" in sec:
                rid = sec.pop("ROOT_JOINT_ID")
                cfg_kw["root_joint_id"] = (
                    (int(rid),) if isinstance(rid, int)
                    else tuple(int(r) for r in rid)
                )
            sec.pop("COLOR_RGB", None)
            sec.pop("MEAN", None)
            sec.pop("STD", None)
        elif sec_name == "CAPTURE_SPEC":
            take(sec, "SPACE_SIZE", "space_size", _t3)
            take(sec, "SPACE_CENTER", "space_center", _t3)
            take(sec, "VOXELS_PER_AXIS", "voxels_per_axis", _i3)
            take(sec, "MAX_PEOPLE", "max_people", int)
            take(sec, "MIN_SCORE", "min_score", float)
        elif sec_name == "INDIVIDUAL_SPEC":
            take(sec, "SPACE_SIZE", "ind_space_size", _t3)
            take(sec, "VOXELS_PER_AXIS", "ind_voxels_per_axis", _i3)
        elif sec_name == "NETWORK":
            take(sec, "BETA", "beta", float)
            take(sec, "JLN_BAND_HEIGHT", "jln_band_height", int)
            take(sec, "WHOLE_BAND_HEIGHT", "whole_band_height", int)
            take(sec, "SIGMA", "sigma", float)
            take(sec, "NUM_CHANNEL_JOINT_FEAT", "num_channel_joint_feat", int)
            take(sec, "NUM_CHANNEL_JOINT_HIDDEN", "num_channel_joint_hidden", int)
            take(sec, "PRETRAINED_BACKBONE", "pretrained_backbone", str)
        elif sec_name == "RESNET":
            take(sec, "NUM_LAYERS", "resnet_layers", int)
            take(sec, "STEM", "backbone_stem", str)
            take(sec, "HEAD", "backbone_head", str)
            for k in list(sec):
                sec.pop(k)
        elif sec_name == "TRAIN":
            take(sec, "BATCH_SIZE", "batch_size", int)
            take(sec, "LR", "lr", float)
            take(sec, "LR_DECAY_EPOCHS", "lr_decay_epochs",
                 lambda v: tuple(int(e) for e in v))
            take(sec, "LR_DECAY_FACTOR", "lr_decay_factor", float)
            take(sec, "BEGIN_EPOCH", "begin_epoch", int)
            take(sec, "END_EPOCH", "end_epoch", int)
            take(sec, "LAMBDA_LOSS_2D", "lambda_loss_2d", float)
            take(sec, "LAMBDA_LOSS_1D", "lambda_loss_1d", float)
            take(sec, "LAMBDA_LOSS_BBOX", "lambda_loss_bbox", float)
            take(sec, "LAMBDA_LOSS_FUSED", "lambda_loss_fused", float)
            take(sec, "INIT_SCHEME", "init_scheme", str)
            take(sec, "ACCUMULATION_QUIRK", "accumulation_quirk", bool)
            for k in list(sec):
                sec.pop(k)
        elif sec_name == "SYNTHETIC":
            take(sec, "CAMERA_FILE", "synthetic_camera_file", str)
            take(sec, "POSE_FILE", "synthetic_pose_file", str)
            take(sec, "MAX_PEOPLE", "synthetic_max_people", int)
            take(sec, "NUM_DATA", "synthetic_num_data", int)
            take(sec, "DATA_AUGMENTATION", "synthetic_augmentation", bool)
            take(sec, "SCENE_FILE", "synthetic_scene_file", str)
        elif sec_name == "BACKBONE":
            cfg_kw["backbone"] = str(sec)
            continue
        elif sec_name in ("OUTPUT_DIR",):
            cfg_kw["output_dir"] = str(sec)
            continue
        elif sec_name == "PRINT_FREQ":
            cfg_kw["print_freq"] = int(sec)
            continue
        elif sec_name in known_ignored:
            continue
        else:
            raise ValueError(f"unknown config section {sec_name!r}")
        if isinstance(sec, dict) and sec:
            raise ValueError(f"unknown keys in {sec_name}: {sorted(sec)}")


def load_config(path: str, **overrides: Any) -> FVPConfig:
    """Load an FVPConfig from a reference-schema YAML file."""
    with open(path) as f:
        doc = yaml.safe_load(f)
    kw: dict[str, Any] = {}
    _apply_yaml(kw, doc)
    kw.update(overrides)
    return FVPConfig(**kw)


def config_to_yaml_dict(cfg: FVPConfig) -> dict[str, Any]:
    """FVPConfig -> reference-schema YAML document (the inverse of
    `_apply_yaml`): `load_config(gen_config(cfg, path)) == cfg`.

    A copy of the reference package's `config_to_yaml_dict`: sections and
    keys follow the reference layout, so the dumped file is readable by
    both packages' loaders; keys that are extensions of the schema
    (DEVICE_RENDER, SCENE_FILE, LR_DECAY_*, RESNET.STEM/HEAD) only appear
    when they differ from the defaults, so a default-config dump keeps to
    the schema."""
    d = FVPConfig()  # defaults, for extension-key elision

    def ext(section: dict, key: str, val, default):
        if val != default:
            section[key] = val

    dataset = {
        "TRAIN_DATASET": cfg.train_dataset,
        "TEST_DATASET": cfg.test_dataset,
        "TRAIN_HEATMAP_SRC": cfg.train_heatmap_src,
        "TEST_HEATMAP_SRC": cfg.test_heatmap_src,
        "DATADIR": cfg.data_dir,
        "CAMERA_NUM": cfg.num_views,
        "ORI_IMAGE_SIZE": list(cfg.ori_image_size),
        "IMAGE_SIZE": list(cfg.image_size),
        "HEATMAP_SIZE": list(cfg.heatmap_size),
        "NUM_JOINTS": cfg.num_joints,
        "ROOT_JOINT_ID": (cfg.root_joint_id[0]
                          if len(cfg.root_joint_id) == 1
                          else list(cfg.root_joint_id)),
        "DATA_AUGMENTATION": cfg.data_augmentation,
    }
    ext(dataset, "DEVICE_RENDER", cfg.device_render, d.device_render)

    network = {
        "PRETRAINED_BACKBONE": cfg.pretrained_backbone,
        "NUM_CHANNEL_JOINT_FEAT": cfg.num_channel_joint_feat,
        "NUM_CHANNEL_JOINT_HIDDEN": cfg.num_channel_joint_hidden,
        "SIGMA": cfg.sigma,
        "BETA": cfg.beta,
    }
    ext(network, "JLN_BAND_HEIGHT", cfg.jln_band_height, d.jln_band_height)
    ext(network, "WHOLE_BAND_HEIGHT", cfg.whole_band_height,
        d.whole_band_height)

    train = {
        "BATCH_SIZE": cfg.batch_size,
        "BEGIN_EPOCH": cfg.begin_epoch,
        "END_EPOCH": cfg.end_epoch,
        "LR": cfg.lr,
        "LAMBDA_LOSS_2D": cfg.lambda_loss_2d,
        "LAMBDA_LOSS_1D": cfg.lambda_loss_1d,
        "LAMBDA_LOSS_BBOX": cfg.lambda_loss_bbox,
        "LAMBDA_LOSS_FUSED": cfg.lambda_loss_fused,
    }
    ext(train, "LR_DECAY_EPOCHS", list(cfg.lr_decay_epochs),
        list(d.lr_decay_epochs))
    ext(train, "LR_DECAY_FACTOR", cfg.lr_decay_factor, d.lr_decay_factor)
    ext(train, "INIT_SCHEME", cfg.init_scheme, d.init_scheme)
    ext(train, "ACCUMULATION_QUIRK", cfg.accumulation_quirk,
        d.accumulation_quirk)

    synthetic = {
        "CAMERA_FILE": cfg.synthetic_camera_file,
        "POSE_FILE": cfg.synthetic_pose_file,
        "MAX_PEOPLE": cfg.synthetic_max_people,
        "NUM_DATA": cfg.synthetic_num_data,
        "DATA_AUGMENTATION": cfg.synthetic_augmentation,
    }
    ext(synthetic, "SCENE_FILE", cfg.synthetic_scene_file,
        d.synthetic_scene_file)

    resnet = {}
    ext(resnet, "NUM_LAYERS", cfg.resnet_layers, d.resnet_layers)
    ext(resnet, "STEM", cfg.backbone_stem, d.backbone_stem)
    ext(resnet, "HEAD", cfg.backbone_head, d.backbone_head)

    doc = {
        "BACKBONE": cfg.backbone,
        "OUTPUT_DIR": cfg.output_dir,
        "PRINT_FREQ": cfg.print_freq,
        "DATASET": dataset,
        "SYNTHETIC": synthetic,
        "NETWORK": network,
        "TRAIN": train,
        "CAPTURE_SPEC": {
            "SPACE_SIZE": list(cfg.space_size),
            "SPACE_CENTER": list(cfg.space_center),
            "VOXELS_PER_AXIS": list(cfg.voxels_per_axis),
            "MAX_PEOPLE": cfg.max_people,
            "MIN_SCORE": cfg.min_score,
        },
        "INDIVIDUAL_SPEC": {
            "SPACE_SIZE": list(cfg.ind_space_size),
            "VOXELS_PER_AXIS": list(cfg.ind_voxels_per_axis),
        },
    }
    if resnet:
        doc["RESNET"] = resnet
    return doc


def gen_config(cfg: FVPConfig, path: str) -> None:
    """Dump `cfg` to a reference-schema YAML file (see
    config_to_yaml_dict)."""
    with open(path, "w") as f:
        yaml.safe_dump(config_to_yaml_dict(cfg), f,
                       default_flow_style=None, sort_keys=False)
