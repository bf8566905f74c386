"""The msgpack subset that flax writes, over ``struct`` and numpy only.

This module imports no torch: the serving wire (``serve/rpc.py``,
``serve/frontend.py``) runs in dispatcher processes that must never load
it. Checkpoints add torch tensors on top (``train/msgpack_io.py``), through
an :class:`ArrayCodec` that says how array leaves are written and read.

- nil, booleans, ints, floats (64-bit; 32-bit when reading), strings, bin,
  arrays (lists) and maps, in msgpack's smallest encodings;
- flax's ext types: code 1, an ndarray packed as ``(shape, dtype name,
  buffer)``; code 3, a numpy scalar packed as a 0-d ndarray;
- dict keys in sorted order, as flax's copy of the tree (``jax.tree_util``)
  leaves them;
- arrays over ``max_chunk`` bytes split into flax's
  ``__msgpack_chunked_array__`` form, and joined back when read.
"""

from __future__ import annotations

import struct
from typing import Any, List, Optional, Tuple

import numpy as np

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


class ArrayCodec:
    """Array leaves as numpy arrays. ``parts`` gives an array's (shape,
    dtype name, bytes); ``read`` rebuilds one from them."""

    types: Tuple[type, ...] = (np.ndarray,)

    def nbytes(self, x) -> int:
        return x.nbytes

    def itemsize(self, x) -> int:
        return x.dtype.itemsize

    def parts(self, x) -> Tuple[List[int], str, bytes]:
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not serializable")
        return list(x.shape), x.dtype.name, x.tobytes("C")

    def read(self, shape: List[int], name: str, raw: bytes):
        if name == "bfloat16":
            raise ValueError("a bfloat16 array needs torch: read it with train/msgpack_io.py")
        return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)

    def concat(self, chunks: list, shape: Tuple[int, ...]):
        return np.concatenate(chunks).reshape(shape)


NUMPY = ArrayCodec()


# -- writing -------------------------------------------------------------

def packb(tree: Any, arrays: ArrayCodec = NUMPY, max_chunk: Optional[int] = None) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, byte for byte."""
    out = bytearray()
    limit = MAX_CHUNK_SIZE if max_chunk is None else max_chunk
    _pack(_chunk_leaves(_sorted(tree), arrays, limit), out, arrays)
    return bytes(out)


def _sorted(x: Any) -> Any:
    """A copy with every dict's keys sorted, as ``jax.tree_util`` rebuilds
    a tree."""
    if type(x) is dict:
        return {k: _sorted(x[k]) for k in sorted(x)}
    if type(x) is list:
        return [_sorted(v) for v in x]
    return x


def _chunk(arr, arrays: ArrayCodec, limit: int) -> dict:
    """flax ``_chunk``: flat pieces of at most ``limit`` bytes."""
    size = max(1, int(limit / arrays.itemsize(arr)))
    flat = arr.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, len(flat), size))}}


def _chunk_leaves(x: Any, arrays: ArrayCodec, limit: int) -> Any:
    """flax ``_chunk_array_leaves_in_place``: dict values (and a top-level
    array) over ``limit`` bytes become chunk dicts; lists are not entered."""
    big = lambda v: isinstance(v, arrays.types) and arrays.nbytes(v) > limit  # noqa: E731
    if type(x) is dict:
        return {k: (_chunk(v, arrays, limit) if big(v)
                    else _chunk_leaves(v, arrays, limit) if type(v) is dict else v)
                for k, v in x.items()}
    if big(x):
        return _chunk(x, arrays, limit)
    return x


def _array_payload(parts: Tuple[List[int], str, bytes]) -> bytes:
    """The ext payload of an ndarray: msgpack of (shape, dtype name, bytes)."""
    out = bytearray()
    _pack(list(parts), out, NUMPY)
    return bytes(out)


def _pack(x: Any, out: bytearray, arrays: ArrayCodec) -> None:
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
            _pack(v, out, arrays)
    elif t is dict:
        _head(len(x), out, fix=(0x80, 16), sizes=((0xDE, ">H"), (0xDF, ">I")))
        for k, v in x.items():
            _pack(k, out, arrays)
            _pack(v, out, arrays)
    elif isinstance(x, arrays.types):
        _pack_ext(EXT_NDARRAY, _array_payload(arrays.parts(x)), out)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(NUMPY.parts(np.asarray(x))), out)
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

def unpackb(data: bytes, arrays: ArrayCodec = NUMPY) -> Any:
    """``flax.serialization.msgpack_restore(data)``: the tree, with
    chunked arrays joined."""
    try:
        value, pos = _unpack(memoryview(data), 0, False, arrays)
    except (struct.error, IndexError) as e:
        raise ValueError(f"truncated or malformed msgpack data: {e}") from e
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes after the msgpack object")
    return _unchunk_leaves(value, arrays)


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTHS = {0xC4: ("bin", "B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", "B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", "B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(buf: memoryview, pos: int, raw: bool, arrays: ArrayCodec) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _container("map", b & 0x0F, buf, pos, raw, arrays)
    if 0x90 <= b <= 0x9F:
        return _container("array", b & 0x0F, buf, pos, raw, arrays)
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
        return _ext(buf, pos, 1 << (b - 0xD4), arrays)
    if b in _LENGTHS:
        kind, fmt = _LENGTHS[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        if kind == "bin":
            return bytes(buf[pos:pos + n]), pos + n
        if kind == "str":
            return _string(buf, pos, n, raw)
        if kind == "ext":
            return _ext(buf, pos, n, arrays)
        return _container(kind, n, buf, pos, raw, arrays)
    raise ValueError(f"unknown msgpack byte 0x{b:02x} at {pos - 1}")


def _string(buf: memoryview, pos: int, n: int, raw: bool):
    if pos + n > len(buf):
        raise ValueError("truncated msgpack data")
    data = bytes(buf[pos:pos + n])
    return (data if raw else data.decode("utf-8")), pos + n


def _container(kind: str, n: int, buf: memoryview, pos: int, raw: bool, arrays: ArrayCodec):
    if kind == "array":
        items: List[Any] = []
        for _ in range(n):
            v, pos = _unpack(buf, pos, raw, arrays)
            items.append(v)
        return items, pos
    d = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos, raw, arrays)
        d[k], pos = _unpack(buf, pos, raw, arrays)
    return d, pos


def _ext(buf: memoryview, pos: int, n: int, arrays: ArrayCodec):
    code = struct.unpack_from("b", buf, pos)[0]
    data = buf[pos + 1:pos + 1 + n]
    pos += 1 + n
    if code in (EXT_NDARRAY, EXT_NPSCALAR):
        (shape, name, raw), _ = _unpack(data, 0, True, NUMPY)
        arr = arrays.read(shape, name.decode(), raw)
        return (arr if code == EXT_NDARRAY else arr[()]), pos
    raise ValueError(f"msgpack ext type {code} is not one that flax writes for arrays")


def _unchunk(d: dict, arrays: ArrayCodec):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    return arrays.concat([d["chunks"][str(i)] for i in range(len(d["chunks"]))], shape)


def _unchunk_leaves(x: Any, arrays: ArrayCodec) -> Any:
    """flax ``_unchunk_array_leaves_in_place``."""
    if type(x) is dict:
        if CHUNKED in x:
            return _unchunk(x, arrays)
        for k, v in x.items():
            if type(v) is dict:
                x[k] = _unchunk(v, arrays) if CHUNKED in v else _unchunk_leaves(v, arrays)
    return x
