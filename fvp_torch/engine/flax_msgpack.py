"""The reference package's checkpoint format: flax's msgpack, without flax.

flax.serialization.msgpack_serialize writes a tree of nested maps with
string keys whose leaves are msgpack's own types or these extensions:

- ext type 1, an ndarray: a packed (shape, dtype name, C-order bytes);
- ext type 2, a Python complex: a packed (real, imag);
- ext type 3, a numpy scalar: an ndarray of shape ();

and arrays over 2**30 bytes as maps {'__msgpack_chunked_array__': True,
'shape': {'0': ...}, 'chunks': {'0': ...}} of flat pieces.
`fvp_tpu/engine/checkpoint.py::save_best` writes `model_best.msgpack`
({'params', 'batch_stats'}) this way, and tools/convert_backbone.py the
backbone's variables.

`load` decodes a file into numpy leaves, except that a `bfloat16` leaf
(numpy has no such dtype without ml_dtypes) comes back as a
torch.bfloat16 tensor of the same bits. `dumps` writes a tree of numpy
leaves in the same layout. The `msgpack` package is imported
where it is used.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


def _msgpack():
    try:
        import msgpack
    except ImportError as e:
        raise ImportError("reading a flax msgpack checkpoint needs the "
                          "`msgpack` package") from e
    return msgpack


def _ndarray(data: bytes):
    shape, name, buf = _msgpack().unpackb(data, raw=True)
    if name == b"bfloat16":
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16) \
            .reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape)


def _ext(code: int, data: bytes):
    if code == _NDARRAY:
        return _ndarray(data)
    if code == _NPSCALAR:
        return _ndarray(data)[()]
    if code == _COMPLEX:
        re, im = _msgpack().unpackb(data)
        return complex(re, im)
    raise ValueError(f"flax msgpack: unknown extension type {code}")


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    flat = torch.cat(chunks) if isinstance(chunks[0], torch.Tensor) \
        else np.concatenate(chunks)
    return flat.reshape(shape)


def _restore(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        return _unchunk(tree)
    return {k: _restore(v) for k, v in tree.items()}


def loads(data: bytes) -> Any:
    """flax msgpack bytes -> the tree they hold."""
    return _restore(_msgpack().unpackb(data, ext_hook=_ext, raw=False))


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return loads(f.read())


def _pack(x):
    msgpack = _msgpack()
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_NDARRAY, msgpack.packb(
            (x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True))
    if isinstance(x, np.generic):
        a = np.asarray(x)
        return msgpack.ExtType(_NPSCALAR, msgpack.packb(
            (a.shape, a.dtype.name, a.tobytes("C")), use_bin_type=True))
    raise TypeError(f"flax msgpack: cannot write {type(x).__name__}")


def dumps(tree) -> bytes:
    """A tree of dicts with string keys and numpy leaves -> flax msgpack
    bytes. Nothing is chunked: flax chunks only arrays over 2**30 bytes,
    and reads an unchunked one all the same."""
    return _msgpack().packb(tree, default=_pack, strict_types=True)
