"""The port's `gen_config` / `config_to_yaml_dict` and its two matplotlib
figures (`save_3d_planes`, `save_heatmap_grid`) against the reference
package's on the same configurations and seeded poses and heatmaps."""

import dataclasses

import numpy as np
import pytest

import fvp_torch.config as tcfg
import fvp_tpu.config as jcfg

EXTENDED = dict(num_views=3, heatmap_size=(120, 64),
                voxels_per_axis=(48, 48, 12), root_joint_id=(11, 12),
                lr_decay_epochs=(55, 70), lr_decay_factor=0.5,
                device_render=True, backbone_stem="pallas",
                backbone_head="pallas", resnet_layers=18,
                synthetic_scene_file="/data/scenes.pkl",
                train_dataset="synthetic", data_augmentation=True,
                init_scheme="reference")


@pytest.mark.parametrize("kw", [{}, EXTENDED], ids=["defaults", "extended"])
def test_config_to_yaml_dict_matches_reference(kw):
    cfg = tcfg.FVPConfig(**kw)
    ref = jcfg.FVPConfig(**dataclasses.asdict(cfg))
    doc = tcfg.config_to_yaml_dict(cfg)
    assert doc == jcfg.config_to_yaml_dict(ref)
    if kw:
        assert doc["RESNET"] == {"NUM_LAYERS": 18, "STEM": "pallas",
                                 "HEAD": "pallas"}
        assert doc["TRAIN"]["LR_DECAY_EPOCHS"] == [55, 70]
        assert doc["TRAIN"]["LR_DECAY_FACTOR"] == 0.5
    else:
        assert "RESNET" not in doc
        assert "LR_DECAY_EPOCHS" not in doc["TRAIN"]


@pytest.mark.parametrize("kw", [{}, EXTENDED], ids=["defaults", "extended"])
def test_gen_config_round_trips(tmp_path, kw):
    cfg = tcfg.FVPConfig(**kw)
    path = str(tmp_path / "dump.yaml")
    tcfg.gen_config(cfg, path)
    assert tcfg.load_config(path) == cfg
    # the reference package reads the port's dump as its own config
    assert dataclasses.asdict(jcfg.load_config(path)) == \
        dataclasses.asdict(cfg)


def _poses(seed, people=3, joints=15):
    """(5, J, 5) fused poses: `people` valid rows, the rest flagged -1."""
    rng = np.random.RandomState(seed)
    fused = np.full((5, joints, 5), -1.0, np.float32)
    base = rng.uniform(-1500, 1500, (people, 1, 3))
    fused[:people, :, :3] = base + rng.normal(0, 300, (people, joints, 3))
    fused[:people, :, 3] = 0.0
    fused[:people, :, 4] = rng.rand(people, joints)
    return fused


def _pixels(path):
    import matplotlib.image as mpimg
    return mpimg.imread(path)


def test_save_3d_planes_matches_reference(tmp_path):
    pytest.importorskip("matplotlib")
    from fvp_torch.utils import vis as tvis
    from fvp_tpu.utils import vis as jvis
    fused = _poses(0)
    rng = np.random.RandomState(1)
    centers = np.concatenate([fused[:3, 0, :3], rng.rand(3, 2),
                              rng.uniform(0.2, 0.5, (3, 2))], axis=1)
    got, ref = str(tmp_path / "port.png"), str(tmp_path / "ref.png")
    tvis.save_3d_planes(fused, got, proposal_centers=centers)
    jvis.save_3d_planes(fused, ref, proposal_centers=centers)
    a, b = _pixels(got), _pixels(ref)
    assert a.shape == b.shape and a.shape[0] > 100
    assert np.array_equal(a, b)
    # no valid person: no figure
    none = str(tmp_path / "none.png")
    tvis.save_3d_planes(np.full((2, 15, 5), -1.0, np.float32), none)
    assert not (tmp_path / "none.png").exists()


@pytest.mark.parametrize("views", [5, 7])
def test_save_heatmap_grid_matches_reference(tmp_path, views):
    pytest.importorskip("matplotlib")
    from fvp_torch.utils import vis as tvis
    from fvp_tpu.utils import vis as jvis
    heatmaps = np.random.RandomState(views).rand(views, 15, 32, 60) \
        .astype(np.float32)
    got, ref = str(tmp_path / "port.png"), str(tmp_path / "ref.png")
    tvis.save_heatmap_grid(heatmaps, got)
    jvis.save_heatmap_grid(heatmaps, ref)
    a, b = _pixels(got), _pixels(ref)
    assert a.shape == b.shape and a.shape[0] > 100
    assert np.array_equal(a, b)
