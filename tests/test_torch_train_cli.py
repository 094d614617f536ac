"""The port's train CLI (run/train_torch.py) on the CPU: one epoch of the
tiny synthetic config with its evaluation, checkpoint and best model, then
--resume for a second epoch from the checkpoint; without a card and
without --device it raises, as the trainer does without a device."""

import importlib.util
import json
import os

import pytest
import torch

from fvp_torch.config import load_config
from fvp_torch.models.faster_voxelpose import FasterVoxelPose


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread at these small shapes: parallel test workers
    then do not oversubscribe the cores (the previous count restored)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/test/tiny_synthetic.yaml")


def _cli():
    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(ROOT, "run/train_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny_yaml(tmp_path):
    text = open(TINY).read().replace("OUTPUT_DIR: '/tmp/fvp_out'",
                                     f"OUTPUT_DIR: '{tmp_path / 'out'}'")
    assert str(tmp_path) in text
    path = tmp_path / "tiny.yaml"
    path.write_text(text)
    return str(path)


def test_train_cli_on_cpu_and_resume(tmp_path):
    cli = _cli()
    cfg_path = _tiny_yaml(tmp_path)
    out = tmp_path / "out" / "tiny"
    assert cli.main(["--cfg", cfg_path, "--epochs", "1",
                     "--device", "cpu"]) == 0
    ckpt = torch.load(out / "checkpoint.pth", weights_only=True)
    assert ckpt["epoch"] == 1 and ckpt["trainer"]["step"] == 3
    model = FasterVoxelPose(load_config(cfg_path))
    model.load_state_dict(torch.load(out / "model_best.pth",
                                     weights_only=True))
    (log,) = [p for p in out.iterdir() if p.name.startswith("train_torch")]
    text = log.read_text()
    assert "epoch 0 [0/3] loss" in text and "epoch 0 metrics" in text
    scalars = [json.loads(s) for s in
               (out / "scalars.jsonl").read_text().splitlines()]
    assert any("eval_score" in s for s in scalars)

    assert cli.main(["--cfg", cfg_path, "--epochs", "2", "--resume",
                     "--device", "cpu"]) == 0
    ckpt = torch.load(out / "checkpoint.pth", weights_only=True)
    assert ckpt["epoch"] == 2 and ckpt["trainer"]["step"] == 6
    text = "".join(p.read_text() for p in out.iterdir()
                   if p.name.startswith("train_torch"))
    assert "resumed from epoch 1" in text and "epoch 1 metrics" in text
    # the reference's run summary reads the port's train logs
    spec = importlib.util.spec_from_file_location(
        "summarize_run", os.path.join(ROOT, "tools/summarize_run.py"))
    summarize = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(summarize)
    epochs = summarize.parse_logs(str(out))
    assert sorted(epochs) == [0, 1]
    assert all("mean_ap" in m and "recall@500" in m for m in epochs.values())


def test_train_cli_needs_a_card_or_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cli().main(["--cfg", _tiny_yaml(tmp_path), "--epochs", "1"])
