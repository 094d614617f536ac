"""The port's hand-written CUDA kernels and their wrappers.

Each wrapper takes its kernel's plain PyTorch version for a tensor on the
CPU, and for a CUDA tensor launches the kernel or raises: there is no
fallback. Each counts its kernel launches in `launches`, so a run can show
that it went through the kernels. No kernel has a backward: a CUDA input
that requires grad raises rather than give an output cut from the graph
(the training path's K1 and K2 take inputs that carry none).
"""

from __future__ import annotations

import functools

import torch

from fvp_torch.ops.kernels._build import load


class Kernel:
    """A named kernel entry point with its launch count."""

    def __init__(self, name: str, fn: str):
        self.name = name
        self.fn = fn
        self.launches = 0

    def __call__(self, *args) -> None:
        lib = load()
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, self.fn)(*args, stream)
        self.launches += 1
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA error {err}: "
                               f"{lib.fvp_error_string(err).decode()}")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, shape=None,
          dtype=torch.float32, device=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and
    `shape`, where given; None entries match any size) that does not
    require grad."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.requires_grad:
        raise ValueError(f"{name}: requires grad; the kernel has no "
                         "backward")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is not None and (len(shape) != t.dim() or any(
            s is not None and s != d for s, d in zip(shape, t.shape))):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (a persistent grid's size)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


_COUNTERS: dict = {}


def last_block_counters(device, n: int) -> torch.Tensor:
    """At least `n` zeroed int32 counters for a kernel whose last block
    (of a map, of a person) is found by counting, one buffer for each
    (device, stream): the kernels leave them zero, and launches on one
    stream run in order, so each launch finds its stream's counters at
    zero. Two streams never share counters."""
    key = (str(device), torch.cuda.current_stream(device).cuda_stream)
    if key not in _COUNTERS or _COUNTERS[key].numel() < n:
        _COUNTERS[key] = torch.zeros(max(n, 256), dtype=torch.int32,
                                     device=device)
    return _COUNTERS[key]


def all_kernels() -> dict[str, Kernel]:
    """name -> Kernel for every kernel entry point of the port."""
    from fvp_torch.ops.kernels import c2cnet, centernet, deconv_head
    from fvp_torch.ops.kernels import hourglass, sampler, softargmax, stem
    from fvp_torch.ops.kernels import trunk, weightnet
    ks = [stem.STEM, deconv_head.DECONV, sampler.WHOLE_SAMPLE,
          sampler.WHOLE_SAMPLE_SUM, sampler.PERSON_LAYOUT,
          sampler.PERSON_PLANES, centernet.CENTERNET,
          centernet.CENTERNET_BF16, softargmax.SOFT_ARGMAX,
          weightnet.WEIGHTNET_POOL, weightnet.WEIGHTNET_POOL_BF16,
          centernet.CONV_BF16.wgmma, centernet.CONV_BF16.wmma,
          centernet.POOL_BF16,
          hourglass.CONV.wgmma, hourglass.CONV.wmma, hourglass.POOL, c2cnet.C2C,
          trunk.CONV.wgmma, trunk.CONV.wmma]
    return {k.name: k for k in ks}


def reset_launches() -> None:
    for k in all_kernels().values():
        k.launches = 0
