"""The port's datasets and host batch pipeline (fvp_torch/data) against
the reference package's (fvp_tpu/data), on the CPU.

Synthetic scenes: the same records and bit-identical samples (render
parameters or host-rendered heatmaps, meta, targets) for the same config
and RNG, augmentation on and off. Panoptic, Shelf and Campus: the same
records, rigs, samples and `evaluate` results on the on-disk trees that
the reference package's fixture tests write. `collate`, `build_samples`,
`batch_iterator` and `eval_batches`: the same batches, padding included.

Both packages render host heatmaps with their native C++ renderer where
it is on (the same maps as the numpy renderer within 1e-5, augmentation
from another RNG stream); these tests switch it off on both sides and
compare the numpy paths, bit for bit (tests/test_torch_native.py holds
the native paths against each other).
"""

import dataclasses
import os

import numpy as np
import pytest

import fvp_torch.config as tcfg
import fvp_torch.data.loader as tloader
import fvp_torch.data.native as tnative
import fvp_torch.data.registry as treg
import fvp_torch.engine.validate as tval
import fvp_tpu.data.loader as jloader
import fvp_tpu.data.native as jnative
import fvp_tpu.data.registry as jreg
import fvp_tpu.engine.validate as jval
from fvp_tpu.config import FVPConfig, load_config

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def numpy_renderer(monkeypatch):
    """Both packages' host renderers on their numpy paths."""
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    monkeypatch.setattr(tnative, "ENABLED", False)


def port_cfg(cfg: FVPConfig) -> tcfg.FVPConfig:
    return tcfg.FVPConfig(**dataclasses.asdict(cfg))


def assert_same(got, ref, path="sample"):
    """Nested dicts / lists of arrays and scalars: equal keys, equal dtypes,
    equal values bit for bit."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            assert_same(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, f"{path}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)):
        g = np.asarray(got)
        assert g.dtype == np.asarray(ref).dtype, path
        np.testing.assert_array_equal(g, ref, err_msg=path)
    else:
        assert got == ref, path


def assert_same_rigs(got, ref):
    assert sorted(got) == sorted(ref)
    for seq in ref:
        for f in ("R", "T", "f", "c", "k", "p"):
            np.testing.assert_array_equal(getattr(got[seq], f),
                                          getattr(ref[seq], f))


def _synthetic_cfg(augment, device_render):
    return FVPConfig(num_views=3, heatmap_size=(60, 32),
                     voxels_per_axis=(16, 16, 8), max_people=4,
                     synthetic_num_data=5, synthetic_max_people=3,
                     synthetic_augmentation=augment,
                     device_render=device_render,
                     train_heatmap_src="gt", test_heatmap_src="gt")


@pytest.mark.parametrize("is_train", [False, True],
                         ids=["held_out", "train"])
@pytest.mark.parametrize("augment,device_render", [
    (False, False), (True, False), (False, True), (True, True)],
    ids=["host", "host_augmented", "device", "device_augmented"])
def test_synthetic_matches_reference(augment, device_render, is_train):
    cfg = _synthetic_cfg(augment, device_render)
    ref = jreg.build_dataset("synthetic", cfg, is_train=is_train)
    got = treg.build_dataset("synthetic", port_cfg(cfg), is_train=is_train)
    assert len(got) == len(ref) == 5
    assert got.has_evaluate_function == ref.has_evaluate_function \
        == (not is_train)
    assert_same(got.records, ref.records, "records")
    assert_same_rigs(got.rigs, ref.rigs)
    key = "render_params" if device_render else "input_heatmaps"
    for i in range(len(ref)):
        s_got = got.sample(i, rng=np.random.RandomState(100 + i))
        s_ref = ref.sample(i, rng=np.random.RandomState(100 + i))
        assert key in s_ref
        assert_same(s_got, s_ref, f"sample {i}")
    if not device_render:
        assert s_ref[key].max() > 0.5        # people inside the views


def test_synthetic_evaluate_matches_reference():
    cfg = _synthetic_cfg(False, True)
    ref = jreg.build_dataset("synthetic", cfg, is_train=False)
    got = treg.build_dataset("synthetic", port_cfg(cfg), is_train=False)
    rng = np.random.RandomState(3)
    K, J = cfg.max_people, cfg.num_joints
    preds = np.zeros((len(ref), K, J, 5), np.float32)
    preds[:, :, :, 3] = -1.0
    for i, rec in enumerate(ref.records):
        for p, g in enumerate(rec["joints_3d"][:K]):
            preds[i, p, :, :3] = g + rng.normal(0, 30.0, g.shape)
            preds[i, p, :, 3:] = (0.0, 0.9 - 0.1 * p)
    m = ref.evaluate(preds)
    assert 0.0 < m["mean_ap"] < 1.0
    assert_same(got.evaluate(preds), m, "metrics")


def test_panoptic_matches_reference(tmp_path):
    from fvp_torch.data.panoptic import PanopticDataset as TPanoptic
    from fvp_tpu.data.panoptic import PanopticDataset as JPanoptic
    from tests.test_panoptic_fixture import SEQ, _cfg, _write_tree

    _write_tree(tmp_path)
    cfg = _cfg(tmp_path)
    cache = tmp_path / "validation_meta_fvp.pkl"
    got = TPanoptic(port_cfg(cfg), is_train=False, sequences=[SEQ])
    cache.unlink()                       # each indexes the tree itself
    ref = JPanoptic(cfg, is_train=False, sequences=[SEQ])
    assert len(ref) == 2
    assert_same(got.records, ref.records, "records")
    assert_same_rigs(got.rigs, ref.rigs)
    # the port reads the reference package's meta cache
    cached = TPanoptic(port_cfg(cfg), is_train=False, sequences=[SEQ])
    assert_same(cached.records, ref.records, "cached records")
    for i in range(len(ref)):
        assert_same(got.sample(i, rng=np.random.RandomState(i)),
                    ref.sample(i, rng=np.random.RandomState(i)),
                    f"sample {i}")
    rng = np.random.RandomState(5)
    preds = np.zeros((2, cfg.max_people, cfg.num_joints, 5), np.float32)
    preds[:, :, :, 3] = -1.0
    for i, rec in enumerate(ref.records):
        for p, g in enumerate(rec["joints_3d"]):
            preds[i, p, :, :3] = g + rng.normal(0, 20.0, g.shape)
            preds[i, p, :, 3:] = (1.0, 0.95 - 0.1 * p)
    assert_same(got.evaluate(preds), ref.evaluate(preds), "metrics")


@pytest.mark.parametrize("seq", ["shelf", "campus"])
def test_shelf_campus_match_reference(tmp_path, seq):
    from fvp_torch.data import shelf as tshelf
    from fvp_tpu.data import shelf as jshelf
    from tests.test_shelf_fixture import _write_fixture

    cfg = load_config(os.path.join(HERE, f"configs/{seq}/jln64.yaml"),
                      data_dir=str(tmp_path))
    if seq == "shelf":
        frame_range = list(range(300, 312))
        _write_fixture(str(tmp_path), seq, cfg.num_views, frame_range, cfg)
        ref = jshelf.ShelfDataset(cfg, frame_range=frame_range)
        got = tshelf.ShelfDataset(port_cfg(cfg), frame_range=frame_range)
    else:
        # CampusDataset pins the original implementation's frame ranges
        frame_range = list(range(350, 471)) + list(range(650, 751))
        _write_fixture(str(tmp_path), seq, cfg.num_views, frame_range, cfg)
        ref = jshelf.CampusDataset(cfg)
        got = tshelf.CampusDataset(port_cfg(cfg))
    assert len(ref) == len(frame_range)
    assert_same(got.records, ref.records, "records")
    assert_same_rigs(got.rigs, ref.rigs)
    for i in (0, 1, len(ref) - 1):
        assert_same(got.sample(i, rng=np.random.RandomState(i)),
                    ref.sample(i, rng=np.random.RandomState(i)),
                    f"sample {i}")
    # COCO-17 predictions near the views' people: PCP between 0 and 1
    rng = np.random.RandomState(9)
    preds = np.zeros((len(ref), cfg.max_people, 17, 5), np.float32)
    preds[:, :, 0, 3] = -1.0
    centers = [(-900.0, -300.0), (700.0, 400.0)]
    for i in range(len(ref)):
        for n, c in enumerate(centers):
            preds[i, n, :, :3] = rng.uniform(-200, 200, (17, 3)) \
                + (c[0], c[1], 900.0)
            preds[i, n, 0, 3] = 1.0
    assert_same(got.evaluate(preds), ref.evaluate(preds), "metrics")


class _Records:
    """A dataset of records only, over several sequences."""

    def __init__(self, seqs):
        self.records = [{"seq": s} for s in seqs]


@pytest.mark.parametrize("seqs,bs", [
    (["synthetic"] * 7, 3),
    (["synthetic"] * 8, 8),
    (["a", "a", "b", "b", "b", "a", "c"], 2),
])
def test_eval_batches_match_reference(seqs, bs):
    ds = _Records(seqs)
    got = list(tval.eval_batches(ds, bs))
    ref = list(jval.eval_batches(ds, bs))
    assert len(got) == len(ref)
    for (gs, gi, gv), (rs, ri, rv) in zip(got, ref):
        assert gs == rs and gv == rv
        assert_same(gi, ri, "indices")
        assert len(gi) == bs                  # padded to the batch size


@pytest.mark.parametrize("device_render", [False, True],
                         ids=["host", "device"])
def test_collate_and_batches_match_reference(device_render):
    cfg = _synthetic_cfg(True, device_render)
    ref = jreg.build_dataset("synthetic", cfg, is_train=False)
    got = treg.build_dataset("synthetic", port_cfg(cfg), is_train=False)
    # a padded eval batch: 5 records at batch 4 -> [4, 4 (1 valid)]
    for (_, idx, valid), (_, ridx, _) in zip(
            tval.eval_batches(got, 4), jval.eval_batches(ref, 4)):
        b_got = tloader.collate(tloader.build_samples(
            got, idx, rng=np.random.RandomState(11)))
        b_ref = jloader.collate(jloader.build_samples(
            ref, ridx, rng=np.random.RandomState(11)))
        assert_same(b_got, b_ref, f"batch valid={valid}")
    assert valid == 1
    for b_got, b_ref in zip(
            tloader.prefetch(tloader.batch_iterator(got, 2, shuffle=True,
                                                    seed=4)),
            jloader.batch_iterator(ref, 2, shuffle=True, seed=4)):
        assert_same(b_got, b_ref, "train batch")
