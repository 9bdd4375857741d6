"""Checkpointing.

The port of ``mtad_gat_tpu/training/checkpoint.py``. A run directory holds
two files, written with ``torch.save`` and read with
``torch.load(weights_only=True)`` (tensors and plain containers only):

- ``model.pt``: the model's ``state_dict`` under the reference's keys, what
  ``predict_cli`` and the reference's own loader read;
- ``train_state.pt``: ``{"params": state_dict, "optimizer":
  optimizer.state_dict(), "step": global step}``, the full-resume state.

``read_flax_msgpack`` reads what the JAX package writes instead
(``model.msgpack``: flax's ``to_bytes`` of ``{"params": tree}``), with its
own decoder of the msgpack subset flax uses, so no ``msgpack`` package is
needed. ``utils/weights.jax_params_to_state_dict`` maps its ``params`` to
this package's ``state_dict``.

On a mesh only the primary rank writes (``parallel/multihost.is_primary``):
the ranks hold the same parameters, and the run directory has one writer.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Tuple

import numpy as np
import torch

from mtad_gat_tpu_torch.parallel import multihost


def save_checkpoint(path: str, obj: Any) -> None:
    """``torch.save`` of ``obj`` at ``path``, on the primary rank only."""
    if not multihost.is_primary():
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(obj, path)


def load_checkpoint(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


# ---------------------------------------------------------------------------
# flax msgpack (flax/serialization.py): maps with str keys, and ndarray
# leaves as ext type 1 holding a packed (shape, dtype name, bytes) triple,
# numpy scalars as ext type 3 (the same triple of a 0-d array). Arrays over
# 2**30 bytes are split into a {"__msgpack_chunked_array__": True, "shape":
# {...}, "chunks": {...}} map.
# ---------------------------------------------------------------------------

# dtypes the port takes from a checkpoint; anything else (bfloat16, complex,
# strings) is refused by name rather than cast
_MSGPACK_DTYPES = ("float16", "float32", "float64", "int8", "int16", "int32", "int64",
                   "uint8", "uint16", "uint32", "uint64", "bool")
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A decoder of the msgpack format (https://msgpack.org/ spec) over one
    bytes object; ``value()`` reads the next object."""

    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self) -> Any:
        t = self.unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in fixed:
            return self.unpack(fixed[t])
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if t in sized:
            fmt, kind = sized[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        if 0xD4 <= t <= 0xD8:
            return self.ext(1 << (t - 0xD4))
        raise ValueError(f"msgpack type byte 0x{t:02x} is not defined")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not an array flax writes "
                             "(1 ndarray, 3 numpy scalar)")
        arr = _ndarray(payload)
        return arr if code == _EXT_NDARRAY else arr[()]


def _ndarray(payload: bytes) -> np.ndarray:
    """flax ``_ndarray_from_bytes``: a packed (shape, dtype name, C-order
    bytes) triple."""
    r = _Reader(payload)
    triple = r.value()
    if not (isinstance(triple, list) and len(triple) == 3):
        raise ValueError("a flax ndarray is a (shape, dtype, bytes) triple")
    shape, name, buf = triple
    name = name.decode() if isinstance(name, bytes) else name
    if name not in _MSGPACK_DTYPES:
        raise ValueError(f"checkpoint array of dtype {name!r}: the port reads "
                         f"{', '.join(_MSGPACK_DTYPES)} and does not cast others")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(tuple(shape)).copy()


def _unchunk(tree: Any) -> Any:
    """Reassemble flax's chunked arrays (``_unchunk``) wherever they sit."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = _dict_tuple(tree["shape"])
        chunks = _dict_tuple(tree["chunks"])
        flat = np.concatenate([np.asarray(c).reshape(-1) for c in chunks])
        if flat.size != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"chunked array of shape {shape} holds {flat.size} values")
        return flat.reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def _dict_tuple(d: dict) -> Tuple:
    if not isinstance(d, dict) or sorted(d) != sorted(str(i) for i in range(len(d))):
        raise ValueError("a chunked array's shape and chunks are maps keyed '0', '1', ...")
    return tuple(d[str(i)] for i in range(len(d)))


def read_flax_msgpack(path: str) -> Any:
    """The tree a flax ``to_bytes`` wrote to ``path`` (the JAX package's
    ``model.msgpack`` and ``train_state.msgpack``): nested dicts with numpy
    array leaves, chunked arrays reassembled. Raises ValueError on data
    that is not flax's msgpack subset or holds a dtype the port does not
    read (such as bfloat16)."""
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(data):
        raise ValueError(f"{path}: {len(data) - r.pos} bytes after the msgpack object")
    return _unchunk(tree)
