"""The port's validate CLI (run/validate_torch.py) on the CPU: FPS and
metrics logged, without a checkpoint and with a reference-keyed state dict
(plain, and {'state_dict'} with a `module.` prefix); strict keys; without
a card and without --device it raises, as run_validation does without a
device; `--mesh data=2,space=2` gives the unsharded poses and refuses an
unknown axis or a missing --device."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import fvp_torch.config as tcfg
from fvp_torch.data.registry import build_dataset as tbuild
from fvp_torch.engine.validate import run_validation, validate_on_mesh
from fvp_tpu.config import load_config
from tests.test_torch_nets import perturbed_variables, port_model
from tests.test_torch_spatial import _variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/test/tiny_synthetic.yaml")


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference package's variables for the tiny config, perturbed as
    the parity tests perturb them."""
    return perturbed_variables(load_config(TINY), 7)


def _cli():
    spec = importlib.util.spec_from_file_location(
        "validate_torch", os.path.join(ROOT, "run/validate_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny_yaml(tmp_path):
    """The tiny synthetic config with its output under tmp_path and 10
    held-out scenes (two batches, so that FPS is measured)."""
    text = open(TINY).read()
    text = text.replace("OUTPUT_DIR: '/tmp/fvp_out'",
                        f"OUTPUT_DIR: '{tmp_path / 'out'}'")
    text = text.replace("NUM_DATA: 6", "NUM_DATA: 10")
    assert str(tmp_path) in text and "NUM_DATA: 10" in text
    path = tmp_path / "tiny.yaml"
    path.write_text(text)
    return str(path)


def _log(tmp_path):
    (d,) = [tmp_path / "out" / "tiny"]
    (f,) = [p for p in d.iterdir() if p.name.startswith("validate_torch")]
    return f.read_text()


@pytest.mark.parametrize("layout", ["none", "plain", "wrapped"])
def test_validate_cli_on_cpu(tmp_path, layout):
    cli = _cli()
    cfg_path = _tiny_yaml(tmp_path)
    args = ["--cfg", cfg_path, "--device", "cpu"]
    if layout != "none":
        cfg = load_config(cfg_path)
        state = port_model(cfg, _weights()).state_dict()
        if layout == "wrapped":
            state = {"state_dict": {f"module.{k}": v
                                    for k, v in state.items()}}
        torch.save(state, tmp_path / "model.pth")
        args += ["--checkpoint", str(tmp_path / "model.pth")]
    assert cli.main(args) == 0
    log = _log(tmp_path)
    assert "FPS (warm-up excluded)" in log and "metrics: {'ap'" in log
    assert ("no checkpoint; seeded random weights" in log) == \
        (layout == "none")
    assert ("loaded " in log) == (layout != "none")


def test_validate_cli_checkpoint_keys_must_match(tmp_path):
    cli = _cli()
    cfg_path = _tiny_yaml(tmp_path)
    cfg = load_config(cfg_path)
    state = port_model(cfg, _weights()).state_dict()
    state.pop(next(iter(state)))
    torch.save(state, tmp_path / "model.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        cli.main(["--cfg", cfg_path, "--device", "cpu",
                  "--checkpoint", str(tmp_path / "model.pth")])


def test_validate_cli_needs_a_card_without_device(tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        _cli().main(["--cfg", _tiny_yaml(tmp_path)])


def test_run_validation_needs_a_card_without_device():
    cfg = tcfg.load_config(TINY)
    ds = tbuild("synthetic", cfg, is_train=False)
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose as TFVP
    with pytest.raises(RuntimeError, match="CUDA"):
        run_validation(cfg, TFVP(cfg), ds)


def test_predictor_and_run_validation_share_one_setup():
    """Predictor is the engine run_validation builds, with one rig."""
    import fvp_torch.engine.validate as tval
    from fvp_torch.engine.serve import Engine, Predictor
    assert issubclass(Predictor, Engine) and tval.Engine is Engine


def test_validate_cli_mesh_on_cpu(tmp_path, monkeypatch):
    """`--mesh data=2,space=2 --device cpu`: four spawned ranks on the tiny
    config (a 32x32x8 space: 16 x-rows a 'space' rank, batches of 8 split
    4 and 4) give the poses of the unsharded run_validation, within
    tests/test_spatial.py's pipeline tolerance (rtol 1e-4, atol 5e-3 mm);
    rank 0 logs. The weights are tests/test_torch_spatial.py's (their
    detection maps have no near-ties) and the gate is open (MIN_SCORE
    -1), so that every proposal's pose is held."""
    cli = _cli()
    cfg_path = _tiny_yaml(tmp_path)
    text = open(cfg_path).read()
    assert "MIN_SCORE: 0.1" in text
    open(cfg_path, "w").write(text.replace("MIN_SCORE: 0.1",
                                           "MIN_SCORE: -1.0"))
    cfg = load_config(cfg_path)
    state = port_model(cfg, _variables()).state_dict()
    torch.save(state, tmp_path / "model.pth")
    got = []

    def keep(*a, **kw):
        got.append(validate_on_mesh(*a, **kw))
        return got[-1]

    monkeypatch.setattr(cli, "validate_on_mesh", keep)
    assert cli.main(["--cfg", cfg_path, "--device", "cpu", "--mesh",
                     "data=2,space=2", "--checkpoint",
                     str(tmp_path / "model.pth")]) == 0
    log = _log(tmp_path)
    assert "pipeline mesh: 2 data x 2 space over 4 ranks (gloo, cpu)" in log
    assert "FPS (warm-up excluded)" in log and "metrics: {'ap'" in log
    tc = tcfg.load_config(cfg_path)
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose as TFVP
    model = TFVP(tc)
    model.load_state_dict(state)
    ref = run_validation(tc, model, tbuild(tc.test_dataset, tc,
                                           is_train=False),
                         device="cpu", log=lambda s: None)["fused_poses"]
    poses = got[0]["fused_poses"]
    np.testing.assert_array_equal(poses[..., 3], ref[..., 3])
    assert (ref[:, :, 0, 3] >= 0).all()
    np.testing.assert_allclose(poses[..., :3], ref[..., :3], rtol=1e-4,
                               atol=5e-3)


@pytest.mark.parametrize("argv,msg", [
    (["--mesh", "data=2,view=2", "--device", "cpu"], "unknown mesh axes"),
    (["--mesh", "data=2,space=2"], "needs an explicit --device")])
def test_validate_cli_mesh_refused(tmp_path, capsys, argv, msg):
    with pytest.raises(SystemExit):
        _cli().main(["--cfg", _tiny_yaml(tmp_path), *argv])
    assert msg in capsys.readouterr().err
