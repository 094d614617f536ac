"""engine/serve.py::float32_math under each way a caller can turn TF32 on:
PyTorch's per-backend `fp32_precision` strings (global, cudnn, cudnn.conv,
cuda.matmul), `torch.set_float32_matmul_precision('high')` and the legacy
`allow_tf32` flags. For each, the context enters without raising,
computes with 'ieee' convs and matmuls inside, and gives every flag back
as it was; and a Predictor call under global TF32 strings returns the
same poses as without them. On the CPU the flags do not change the
arithmetic; tests/test_torch_kernels_cuda.py holds the card's float32
under them."""

import dataclasses

import numpy as np
import pytest
import torch

import fvp_torch.config as tcfg
import fvp_torch.geometry.cameras as tcam
from fvp_torch.engine.serve import Predictor, float32_math
from tests.test_torch_model import _setup

B = torch.backends
# the fp32_precision strings, parents before children: writing a parent
# writes its children
NAMES = ["", "cudnn", "mkldnn", "cuda.matmul", "cudnn.conv", "cudnn.rnn"]
NAMES += [f"mkldnn.{n}" for n in ("matmul", "conv", "rnn")
          if hasattr(B.mkldnn, n)]


def _backend(name: str):
    o = B
    for part in filter(None, name.split(".")):
        o = getattr(o, part)
    return o


def _read(fn):
    try:
        return fn()
    except RuntimeError:
        return "raises"


def flags() -> dict:
    """Every flag a caller can set, as read now ('raises' where torch
    refuses to read a legacy flag after the new API was used)."""
    out = {n: _backend(n).fp32_precision for n in NAMES}
    out["legacy cudnn"] = _read(lambda: B.cudnn.allow_tf32)
    out["legacy matmul"] = _read(lambda: B.cuda.matmul.allow_tf32)
    out["matmul precision"] = _read(torch.get_float32_matmul_precision)
    return out


def _strings() -> dict:
    return {n: _backend(n).fp32_precision for n in NAMES}


def _set_strings(saved: dict) -> None:
    for n, v in saved.items():
        _backend(n).fp32_precision = v


@pytest.fixture(autouse=True)
def _restore_flags():
    """The global flags as they were before the test, for every other
    test of the process."""
    precision = torch.get_float32_matmul_precision()
    saved = _strings()
    yield
    torch.set_float32_matmul_precision(precision)
    _set_strings(saved)


def _legacy():
    B.cudnn.allow_tf32 = True
    B.cuda.matmul.allow_tf32 = True


SETTINGS = {
    "global": lambda: setattr(B, "fp32_precision", "tf32"),
    "cudnn": lambda: setattr(B.cudnn, "fp32_precision", "tf32"),
    "cudnn.conv": lambda: setattr(B.cudnn.conv, "fp32_precision", "tf32"),
    "cuda.matmul": lambda: setattr(B.cuda.matmul, "fp32_precision",
                                   "tf32"),
    "matmul precision high":
        lambda: torch.set_float32_matmul_precision("high"),
    "legacy allow_tf32": _legacy,
}


@pytest.mark.parametrize("setting", SETTINGS)
def test_float32_math_under_tf32(setting):
    SETTINGS[setting]()
    before = flags()
    with float32_math():
        assert B.cudnn.conv.fp32_precision == "ieee"
        assert B.cuda.matmul.fp32_precision == "ieee"
    assert flags() == before
    if setting == "legacy allow_tf32":
        # the caller's legacy reads still work, and read what they set
        assert B.cudnn.allow_tf32 and B.cuda.matmul.allow_tf32


def test_float32_math_restores_on_exception():
    B.fp32_precision = "tf32"
    before = flags()
    with pytest.raises(KeyError):
        with float32_math():
            raise KeyError("inside")
    assert flags() == before


def test_predictor_under_global_tf32_strings():
    """A float32 entry point under torch.backends.fp32_precision = 'tf32'
    (which made every one of them raise before) returns the poses it
    returns without it, and leaves the strings as they were."""
    cfg, variables, rig, hm = _setup()
    trig = tcam.CameraRig(rig.R, rig.T, rig.f, rig.c, rig.k, rig.p)
    pred = Predictor(tcfg.FVPConfig(**dataclasses.asdict(cfg)), variables,
                     trig, device="cpu")
    saved = _strings()
    B.fp32_precision = "tf32"
    before = flags()
    got = pred(hm)["fused_poses"].numpy()
    assert flags() == before
    _set_strings(saved)
    ref = pred(hm)["fused_poses"].numpy()
    assert (ref[..., 0, 3] >= 0).sum() >= 2
    np.testing.assert_array_equal(got, ref)
