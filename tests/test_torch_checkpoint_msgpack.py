"""The reference package's flax msgpack checkpoints in the port, with no
JAX or flax in the port: engine/flax_msgpack.py against flax's own
msgpack_restore and msgpack_serialize, models/convert.py's inverse
converters against the reference's, `model_best.msgpack` written by
fvp_tpu's save_best and a backbone msgpack written as
tools/convert_backbone.py writes one, each loaded bit for bit, and the
validate and train CLIs given either format."""

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from flax import serialization

from fvp_torch.engine import flax_msgpack
from fvp_torch.engine.checkpoint import load_backbone_state, load_model_state
from fvp_torch.models.convert import (from_jax_backbone_variables,
                                      from_jax_variables,
                                      to_jax_backbone_variables,
                                      to_jax_variables)
from fvp_torch.models.resnet import PoseResNet, seeded_state_dict
from fvp_tpu.config import load_config
from fvp_tpu.engine.checkpoint import save_best
from fvp_tpu.models.convert_tasknets import convert_task_nets
from fvp_tpu.models.resnet import convert_torch_state
from tests.test_torch_nets import perturbed_variables, small_cfg
from tests.test_torch_validate_cli import _cli, _tiny_yaml, _weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree():
    """Every leaf kind flax writes: float32 and int arrays, a bfloat16
    array, numpy scalars, a complex, Python scalars, strings and a list."""
    rng = np.random.RandomState(0)
    return {
        "params": {"a": {"kernel": rng.randn(3, 3, 4, 5).astype(np.float32),
                         "bias": rng.randn(5).astype(np.float32)},
                   "b": rng.randint(-9, 9, (7, 2)).astype(np.int64)},
        "bf16": np.asarray(jnp.asarray(rng.randn(6, 20), jnp.bfloat16)),
        "scalar32": np.float32(2.5),
        "scalar64": np.int64(-3),
        "complex": 1.5 - 2.0j,
        "epoch": 7, "best": 0.25, "name": "x", "flag": True,
        "leaves": [np.arange(3, dtype=np.float32), 4],
    }


def _same(got, ref, path="") -> None:
    """Leaf by leaf: same type, dtype, shape and bits (a bfloat16 leaf of
    flax's against the port's torch.bfloat16 tensor by its 16 bits)."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), path
        for k in ref:
            _same(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _same(g, r, f"{path}/{i}")
    elif isinstance(ref, np.ndarray) and ref.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == ref.shape, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      ref.view(np.int16))
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(got) is type(ref), (path, type(got), type(ref))
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        np.testing.assert_array_equal(got, ref)
    else:
        assert type(got) is type(ref) and got == ref, (path, got, ref)


@pytest.mark.parametrize("chunk", [None, 64])
def test_decoder_matches_flax(monkeypatch, chunk):
    """flax's bytes decoded by the port equal flax's own decoding; with
    chunk = 64, flax writes every array over 64 bytes (the bfloat16 one
    included) as a chunked map."""
    if chunk is not None:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    data = serialization.msgpack_serialize(_tree())
    if chunk is not None:
        assert b"__msgpack_chunked_array__" in data
    ref = serialization.msgpack_restore(data)
    got = flax_msgpack.loads(data)
    _same(got, ref)
    assert isinstance(ref["bf16"], np.ndarray)


def test_writer_reads_back_in_flax():
    """flax_msgpack.dumps writes what flax reads: the same tree of numpy
    leaves (flax gives tuples back as lists, as msgpack does)."""
    tree = {k: v for k, v in _tree().items() if k not in ("bf16", "complex")}
    data = flax_msgpack.dumps(tree)
    _same(serialization.msgpack_restore(data), tree)
    _same(flax_msgpack.loads(data), tree)


def test_unknown_extension_raises():
    import msgpack
    data = msgpack.packb({"x": msgpack.ExtType(9, b"?")})
    with pytest.raises(ValueError, match="extension type 9"):
        flax_msgpack.loads(data)


def _equal_trees(got, ref) -> None:
    flat_ref = jtu.tree_flatten_with_path(ref)[0]
    flat_got = dict(jtu.tree_flatten_with_path(got)[0])
    assert len(flat_got) == len(flat_ref)
    for path, r in flat_ref:
        g = flat_got[path]
        assert g.dtype == r.dtype and g.shape == r.shape, path
        np.testing.assert_array_equal(g, r)


@pytest.fixture(scope="module")
def model_variables():
    """The reference's FasterVoxelPose variables, perturbed (numpy)."""
    return perturbed_variables(small_cfg(), 7)


def test_to_jax_variables_inverts_from_jax(model_variables):
    """state dict -> flax tree equals the reference's own converter
    (fvp_tpu/models/convert_tasknets.py) and the tree it started from."""
    state = from_jax_variables(model_variables)
    back = to_jax_variables(state)
    _equal_trees(back, model_variables)
    _equal_trees(back, convert_task_nets(state))


@pytest.fixture(scope="module")
def backbone_state():
    """A seeded ResNet-18 PoseResNet state dict of the port."""
    return seeded_state_dict(PoseResNet(15, 18), seed=3)


def test_to_jax_backbone_variables_inverts_from_jax(backbone_state):
    """As above for the backbone, against fvp_tpu's convert_torch_state."""
    back = to_jax_backbone_variables(backbone_state)
    ref = convert_torch_state(
        {k: v.numpy() for k, v in backbone_state.items()}, num_layers=18)
    _equal_trees(back, ref)
    again = from_jax_backbone_variables(back)
    for k, v in backbone_state.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(again[k], v), k


def _equal_states(got, ref) -> None:
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_best_msgpack_loads_bit_exact(tmp_path, model_variables,
                                            dtype):
    """model_best.msgpack from fvp_tpu's save_best loads into the state
    dict the numpy tree gives through from_jax_variables, bit for bit; a
    tree saved in bfloat16 loads widened to float32, which is exact."""
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype), model_variables["params"])
    path = save_best(str(tmp_path), types.SimpleNamespace(
        params=params, batch_stats=model_variables["batch_stats"]))
    assert path.endswith("model_best.msgpack")
    ref = {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), params),
        "batch_stats": model_variables["batch_stats"]}
    _equal_states(load_model_state(path), from_jax_variables(ref))


def test_backbone_msgpack_loads_bit_exact(tmp_path, backbone_state):
    """A backbone msgpack as tools/convert_backbone.py writes it loads
    into the state dict its numpy tree gives, bit for bit."""
    variables = convert_torch_state(
        {k: v.numpy() for k, v in backbone_state.items()}, num_layers=18)
    path = tmp_path / "pose_resnet18.msgpack"
    path.write_bytes(serialization.msgpack_serialize(variables))
    got = load_backbone_state(str(path))
    _equal_states(got, from_jax_backbone_variables(variables))
    model = PoseResNet(15, 18)
    model.load_state_dict(got)


def test_msgpack_without_variables_raises(tmp_path):
    path = tmp_path / "x.msgpack"
    path.write_bytes(serialization.msgpack_serialize({"params": {}}))
    with pytest.raises(ValueError, match="batch_stats"):
        load_model_state(str(path))


def _metrics(cfg_path) -> str:
    out = os.path.join(os.path.dirname(cfg_path), "out", "tiny")
    (log,) = [f for f in os.listdir(out) if f.startswith("validate_torch")]
    lines = [ln for ln in open(os.path.join(out, log))
             if "metrics: {" in ln]
    assert len(lines) == 1
    return lines[0].split("metrics: ", 1)[1]


def test_validate_cli_msgpack_equals_pth(tmp_path):
    """run/validate_torch.py --checkpoint on the reference's
    model_best.msgpack gives the metrics of the .pth of the same weights."""
    from tests.test_torch_nets import port_model

    metrics = {}
    for kind in ("pth", "msgpack"):
        d = tmp_path / kind
        d.mkdir()
        cfg_path = _tiny_yaml(d)
        variables = _weights()
        if kind == "pth":
            ckpt = str(d / "model.pth")
            torch.save(port_model(load_config(cfg_path),
                                  variables).state_dict(), ckpt)
        else:
            ckpt = save_best(str(d), types.SimpleNamespace(
                params=variables["params"],
                batch_stats=variables["batch_stats"]))
        assert _cli().main(["--cfg", cfg_path, "--device", "cpu",
                            "--checkpoint", ckpt]) == 0
        metrics[kind] = _metrics(cfg_path)
    assert "'ap'" in metrics["pth"]
    assert metrics["msgpack"] == metrics["pth"]


def test_train_cli_backbone_msgpack_equals_pth(tmp_path, backbone_state):
    """run/train_torch.py's PRETRAINED_BACKBONE takes a torch file or a
    backbone msgpack (chosen by extension) to the same weights."""
    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(ROOT, "run/train_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    pth = tmp_path / "bb.pth.tar"
    torch.save(backbone_state, pth)
    msg = tmp_path / "bb.msgpack"
    msg.write_bytes(serialization.msgpack_serialize(convert_torch_state(
        {k: v.numpy() for k, v in backbone_state.items()}, num_layers=18)))
    from fvp_torch.config import load_config as t_load_config
    base = t_load_config(os.path.join(ROOT,
                                      "configs/test/tiny_synthetic.yaml"))
    got = {}
    for path in (pth, msg):
        cfg = base.replace(pretrained_backbone=str(path), resnet_layers=18)
        got[path.suffix] = cli.load_backbone(cfg).state_dict()
    for k, v in got[".tar"].items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[".msgpack"][k], v), k
