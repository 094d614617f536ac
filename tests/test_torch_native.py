"""The port's native host heatmap renderer (fvp_torch/data/native.py)
against the reference package's (fvp_tpu/data/native.py), on the CPU:
its source is the reference's (the code byte for byte), its maps equal the
reference's for the same joints and seed, the port's augmented host
samples equal the reference's with both native renderers on, bit for bit
(synthetic scenes, held out and train; the Shelf fixture's 'pred'
source), and a build that fails raises with the compiler's output."""

import os

import numpy as np
import pytest

import fvp_torch.data.native as tnative
import fvp_torch.data.registry as treg
import fvp_tpu.data.native as jnative
import fvp_tpu.data.registry as jreg
from tests.test_torch_data import (HERE, _synthetic_cfg, assert_same,
                                   port_cfg)
from tests.test_torch_data import \
    test_shelf_campus_match_reference as shelf_campus


@pytest.fixture(autouse=True)
def native_on():
    """Both renderers on their native paths, both libraries built."""
    assert tnative.ENABLED
    assert jnative.get_lib() is not None
    tnative.get_lib()


def _code(text: str) -> list[str]:
    """The source's lines without its // comments."""
    return [line.split("//")[0].rstrip() for line in text.splitlines()]


def test_source_is_the_references():
    """The port's copy is the reference's source: every line of code the
    same bytes; the comments differ in one line only (the reference's
    names a path of the machine it was written on)."""
    ref = os.path.join(HERE, "native", "heatmap_renderer.cc")
    with open(ref) as f:
        ref_text = f.read()
    got_text = tnative.SRC.read_text()
    assert _code(got_text) == _code(ref_text)
    diff = [(a, b) for a, b in zip(got_text.splitlines(),
                                   ref_text.splitlines()) if a != b]
    assert len(diff) == 1 and all(a.startswith("//") for a in diff[0])
    assert tnative.library_path().parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "fvp_torch")


@pytest.mark.parametrize("augment", [False, True])
def test_maps_equal_the_references(augment):
    cfg = _synthetic_cfg(augment, False)
    rng = np.random.RandomState(4)
    W, H = cfg.image_size
    joints = [rng.uniform((0, 0), (W, H), (cfg.num_joints, 2))
              .astype(np.float32) for _ in range(3)]
    vis = [rng.rand(cfg.num_joints) < 0.8 for _ in range(3)]
    got = tnative.generate_input_heatmap_native(
        port_cfg(cfg), joints, vis, augment=augment, seed=1234)
    ref = jnative.generate_input_heatmap_native(
        cfg, joints, vis, augment=augment, seed=1234)
    assert got.shape == (cfg.num_joints, cfg.heatmap_size[1],
                         cfg.heatmap_size[0])
    assert got.max() > 0.5
    np.testing.assert_array_equal(got, ref)
    assert tnative.generate_input_heatmap_native(port_cfg(cfg), [], None,
                                                 augment, 1) is None


@pytest.mark.parametrize("is_train", [False, True],
                         ids=["held_out", "train"])
@pytest.mark.parametrize("augment", [False, True],
                         ids=["host", "host_augmented"])
def test_synthetic_native_matches_reference(augment, is_train):
    """Host-rendered samples (native maps, the seed drawn from the
    sample's RNG per augmented view) bit for bit the reference's."""
    cfg = _synthetic_cfg(augment, False)
    ref = jreg.build_dataset("synthetic", cfg, is_train=is_train)
    got = treg.build_dataset("synthetic", port_cfg(cfg), is_train=is_train)
    for i in range(len(ref)):
        s_got = got.sample(i, rng=np.random.RandomState(100 + i))
        s_ref = ref.sample(i, rng=np.random.RandomState(100 + i))
        assert_same(s_got, s_ref, f"sample {i}")
    assert s_ref["input_heatmaps"].max() > 0.5


def test_native_differs_from_numpy_when_augmented():
    """Not vacuous: with augmentation the native stream draws other
    jitter than the numpy path does from the same sample RNG."""
    cfg = port_cfg(_synthetic_cfg(True, False))
    ds = treg.build_dataset("synthetic", cfg, is_train=True)
    a = ds.sample(0, rng=np.random.RandomState(7))["input_heatmaps"]
    tnative.ENABLED = False
    try:
        b = ds.sample(0, rng=np.random.RandomState(7))["input_heatmaps"]
    finally:
        tnative.ENABLED = True
    assert a.shape == b.shape and not np.array_equal(a, b)


def test_shelf_pred_source_native_matches_reference(tmp_path):
    """The Shelf fixture's samples (the 'pred' heatmap source) with both
    native renderers on."""
    shelf_campus(tmp_path, "shelf")


def test_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that fails: the build raises with its output, and no
    library is loaded or falls back."""
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed .*bad.cc"):
        tnative.build()
    with pytest.raises(RuntimeError, match="cannot run"):
        tnative.build(compiler=str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(tnative, "_lib", None)
    cfg = port_cfg(_synthetic_cfg(True, False))
    with pytest.raises(RuntimeError, match="failed"):
        tnative.generate_input_heatmap_native(
            cfg, [np.zeros((cfg.num_joints, 2), np.float32)], None, True, 1)
