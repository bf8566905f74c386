"""The msgpack subset that flax writes, without ``msgpack`` or ``flax``,
for checkpoints: the torch-free codec of ``utils/msgpack_codec.py`` with
torch tensors as array leaves too.

A checkpoint's ``state.msgpack`` is ``flax.serialization.msgpack_serialize``
of a tree of dicts (train/checkpoint.py). This module writes the same bytes
and reads them back. Array leaves are numpy arrays or torch tensors.
``bfloat16``, which numpy cannot name without ``ml_dtypes``, is written from
and read into ``torch.bfloat16`` tensors; every other dtype reads back as
numpy. Arrays over ``MAX_CHUNK_SIZE`` bytes are split into flax's chunked
form.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from variational_mmt_torch.utils import msgpack_codec

MAX_CHUNK_SIZE = msgpack_codec.MAX_CHUNK_SIZE  # flax.serialization.MAX_CHUNK_SIZE

_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
                torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8",
                torch.bool: "bool"}


class _TorchArrays(msgpack_codec.ArrayCodec):
    """numpy arrays and torch tensors; bfloat16 reads into torch."""

    types = (np.ndarray, torch.Tensor)

    def nbytes(self, x) -> int:
        return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes

    def itemsize(self, x) -> int:
        return x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize

    def parts(self, x) -> Tuple[List[int], str, bytes]:
        if not isinstance(x, torch.Tensor):
            return super().parts(x)
        if x.dtype not in _TORCH_NAMES:
            raise TypeError(f"cannot serialize a {x.dtype} tensor")
        t = x.detach().cpu().contiguous()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        return list(t.shape), _TORCH_NAMES[t.dtype], raw

    def read(self, shape: List[int], name: str, raw: bytes):
        if name == "bfloat16":
            return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).reshape(shape)
        return super().read(shape, name, raw)

    def concat(self, chunks: list, shape: Tuple[int, ...]):
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return super().concat(chunks, shape)


_ARRAYS = _TorchArrays()


def packb(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, byte for byte."""
    return msgpack_codec.packb(tree, _ARRAYS, MAX_CHUNK_SIZE)


def unpackb(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore(data)``: the tree, with
    chunked arrays joined."""
    return msgpack_codec.unpackb(data, _ARRAYS)
