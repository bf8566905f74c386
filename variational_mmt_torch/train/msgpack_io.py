"""The msgpack subset that flax writes, without ``msgpack`` or ``flax``.

A checkpoint's ``state.msgpack`` is ``flax.serialization.msgpack_serialize``
of a tree of dicts (train/checkpoint.py). This module writes the same bytes
and reads them back:

- nil, booleans, ints, floats (64-bit; 32-bit when reading), strings, bin,
  arrays (lists) and maps, in msgpack's smallest encodings;
- flax's ext types: code 1, an ndarray packed as ``(shape, dtype name,
  buffer)``; code 3, a numpy scalar packed as a 0-d ndarray;
- dict keys in sorted order, as flax's copy of the tree (``jax.tree_util``)
  leaves them;
- arrays over ``MAX_CHUNK_SIZE`` bytes split into flax's
  ``__msgpack_chunked_array__`` form, and joined back when read.

Array leaves are numpy arrays or torch tensors. ``bfloat16``, which numpy
cannot name without ``ml_dtypes``, is written from and read into
``torch.bfloat16`` tensors; every other dtype reads back as numpy.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"

_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
                torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8",
                torch.bool: "bool"}


# -- writing -------------------------------------------------------------

def packb(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, byte for byte."""
    out = bytearray()
    _pack(_chunk_leaves(_sorted(tree)), out)
    return bytes(out)


def _sorted(x: Any) -> Any:
    """A copy with every dict's keys sorted, as ``jax.tree_util`` rebuilds
    a tree."""
    if type(x) is dict:
        return {k: _sorted(x[k]) for k in sorted(x)}
    if type(x) is list:
        return [_sorted(v) for v in x]
    return x


def _is_array(x: Any) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk(arr) -> dict:
    """flax ``_chunk``: flat pieces of at most MAX_CHUNK_SIZE bytes."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def _chunk_leaves(x: Any) -> Any:
    """flax ``_chunk_array_leaves_in_place``: dict values (and a top-level
    array) over MAX_CHUNK_SIZE bytes become chunk dicts; lists are not
    entered."""
    if type(x) is dict:
        return {k: (_chunk(v) if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE
                    else _chunk_leaves(v) if type(v) is dict else v) for k, v in x.items()}
    if _is_array(x) and _nbytes(x) > MAX_CHUNK_SIZE:
        return _chunk(x)
    return x


def _array_payload(x) -> bytes:
    """The ext payload of an ndarray: msgpack of (shape, dtype name, bytes)."""
    if isinstance(x, torch.Tensor):
        if x.dtype not in _TORCH_NAMES:
            raise TypeError(f"cannot serialize a {x.dtype} tensor")
        t = x.detach().cpu().contiguous()
        name = _TORCH_NAMES[t.dtype]
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        shape = list(t.shape)
    else:
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not serializable")
        name, raw, shape = x.dtype.name, x.tobytes("C"), list(x.shape)
    out = bytearray()
    _pack([shape, name, raw], out)
    return bytes(out)


def _pack(x: Any, out: bytearray) -> None:
    t = type(x)
    if x is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if x else 0xC2)
    elif t is int:
        _pack_int(x, out)
    elif t is float:
        out += b"\xcb" + struct.pack(">d", x)
    elif t is str:
        b = x.encode("utf-8")
        _head(len(b), out, fix=(0xA0, 32), sizes=((0xD9, "B"), (0xDA, ">H"), (0xDB, ">I")))
        out += b
    elif t in (bytes, bytearray):
        _head(len(x), out, fix=None, sizes=((0xC4, "B"), (0xC5, ">H"), (0xC6, ">I")))
        out += x
    elif t is list:
        _head(len(x), out, fix=(0x90, 16), sizes=((0xDC, ">H"), (0xDD, ">I")))
        for v in x:
            _pack(v, out)
    elif t is dict:
        _head(len(x), out, fix=(0x80, 16), sizes=((0xDE, ">H"), (0xDF, ">I")))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif _is_array(x):
        _pack_ext(EXT_NDARRAY, _array_payload(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(x)), out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def _head(n: int, out: bytearray, fix, sizes) -> None:
    """A length header: the fix form below its limit, else the first of
    ``sizes`` ((marker, struct format)) whose field holds ``n``."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for marker, fmt in sizes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(marker)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"object of length {n} is too large for msgpack")


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 128:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        for marker, fmt in ((0xCC, "B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
            if x < 1 << (8 * struct.calcsize(fmt)):
                out.append(marker)
                out += struct.pack(fmt, x)
                return
        raise OverflowError("int too big to serialize")
    else:
        for marker, fmt in ((0xD0, "b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
            if x >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                out.append(marker)
                out += struct.pack(fmt, x)
                return
        raise OverflowError("int too big to serialize")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _head(len(data), out, fix=None, sizes=((0xC7, "B"), (0xC8, ">H"), (0xC9, ">I")))
    out += struct.pack("b", code)
    out += data


# -- reading -------------------------------------------------------------

def unpackb(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore(data)``: the tree, with
    chunked arrays joined."""
    value, pos = _unpack(memoryview(data), 0, raw=False)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes after the msgpack object")
    return _unchunk_leaves(value)


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTHS = {0xC4: ("bin", "B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", "B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", "B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(buf: memoryview, pos: int, raw: bool) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _container("map", b & 0x0F, buf, pos, raw)
    if 0x90 <= b <= 0x9F:
        return _container("array", b & 0x0F, buf, pos, raw)
    if 0xA0 <= b <= 0xBF:
        return _string(buf, pos, b & 0x1F, raw)
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    if 0xD4 <= b <= 0xD8:
        return _ext(buf, pos, 1 << (b - 0xD4))
    if b in _LENGTHS:
        kind, fmt = _LENGTHS[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        if kind == "bin":
            return bytes(buf[pos:pos + n]), pos + n
        if kind == "str":
            return _string(buf, pos, n, raw)
        if kind == "ext":
            return _ext(buf, pos, n)
        return _container(kind, n, buf, pos, raw)
    raise ValueError(f"unknown msgpack byte 0x{b:02x} at {pos - 1}")


def _string(buf: memoryview, pos: int, n: int, raw: bool):
    data = bytes(buf[pos:pos + n])
    return (data if raw else data.decode("utf-8")), pos + n


def _container(kind: str, n: int, buf: memoryview, pos: int, raw: bool):
    if kind == "array":
        items: List[Any] = []
        for _ in range(n):
            v, pos = _unpack(buf, pos, raw)
            items.append(v)
        return items, pos
    d = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos, raw)
        d[k], pos = _unpack(buf, pos, raw)
    return d, pos


def _ext(buf: memoryview, pos: int, n: int):
    code = struct.unpack_from("b", buf, pos)[0]
    data = buf[pos + 1:pos + 1 + n]
    pos += 1 + n
    if code == EXT_NDARRAY:
        return _array(data), pos
    if code == EXT_NPSCALAR:
        arr = _array(data)
        return arr[()], pos
    raise ValueError(f"msgpack ext type {code} is not one that flax writes for arrays")


def _array(data: memoryview):
    (shape, name, raw), _ = _unpack(data, 0, raw=True)
    if name == b"bfloat16":
        return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name.decode())).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(x: Any) -> Any:
    """flax ``_unchunk_array_leaves_in_place``."""
    if type(x) is dict:
        if CHUNKED in x:
            return _unchunk(x)
        for k, v in x.items():
            if type(v) is dict:
                x[k] = _unchunk(v) if CHUNKED in v else _unchunk_leaves(v)
    return x
