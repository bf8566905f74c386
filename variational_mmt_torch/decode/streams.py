"""Per-sentence random streams for decoding: the port's counterpart of the
JAX translator's fold-in discipline (``variational_mmt_tpu/decode/
translator.py:134-141``, :149-151, :167-172 and :212).

JAX folds the sentence's stream id (its corpus index, or the caller's
``stream_ids``) into a base key, then folds 0 and the ensemble member for
the latent draw and 1 and the step for the token draws. Threefry's bits
cannot be reproduced here, so the port draws from a counter-based hash in
plain torch integer ops: splitmix64's finalizer over int64 tensors (whose
products wrap modulo 2**64 on the CPU and the card alike, and whose logical
right shifts are masked arithmetic ones) folds ``(decode_seed, stream id,
sub-stream, step, element)`` into 64 bits, whose top 23 make an exact
float32 uniform in (0, 1), never 0 or 1. Gumbel noise for the token draws and normal
``eps`` for the latent draw are derived from those uniforms in float64 and
rounded to float32. The bits and uniforms are identical on the CPU and the
card; a draw depends only on its own coordinates, so it is invariant to
the batch and bucket a sentence lands in; the seed is explicit and no
global generator is touched.
"""

from __future__ import annotations

import math
from typing import Union

import torch

_MASK = (1 << 64) - 1


def _signed(c: int) -> int:
    """A 64-bit pattern as the int64 value with the same bits."""
    c &= _MASK
    return c - (1 << 64) if c >= 1 << 63 else c


GOLDEN = _signed(0x9E3779B97F4A7C15)
_C1 = _signed(0xBF58476D1CE4E5B9)
_C2 = _signed(0x94D049BB133111EB)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 tensors."""
    x = x ^ _shr(x, 30)
    x = x * _C1
    x = x ^ _shr(x, 27)
    x = x * _C2
    return x ^ _shr(x, 31)


def fold(h: torch.Tensor, v: Union[int, torch.Tensor]) -> torch.Tensor:
    """The key of coordinate ``v`` under key ``h`` (broadcasting)."""
    if isinstance(v, int):
        return mix64(h + _signed((v + 1) * GOLDEN))
    return mix64(h + (v.long() + 1) * GOLDEN)


def row_keys(seed: int, stream_ids: torch.Tensor) -> torch.Tensor:
    """One key per sentence (B,) from the decode seed and its stream id."""
    base = mix64(torch.full_like(stream_ids, _signed(seed), dtype=torch.long))
    return fold(base, stream_ids)


def uniforms(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) float32 in (0, 1): element j of row b from ``fold(keys[b], j)``."""
    bits = fold(keys[:, None], torch.arange(n, device=keys.device))
    # (2k + 1) / 2**24 for the top 23 bits k: 24 significant bits, exact in f32
    return (_shr(bits, 41).to(torch.float32) + 0.5) * (2.0 ** -23)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) standard Gumbel noise, float32."""
    u = uniforms(keys, n).double()
    return (-torch.log(-torch.log(u))).float()


def normal(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) standard normals by Box-Muller over element pairs, float32."""
    u = uniforms(keys, 2 * n).double()
    r = torch.sqrt(-2.0 * torch.log(u[:, 0::2]))
    return (r * torch.cos(2.0 * math.pi * u[:, 1::2])).float()


class DecodeStreams:
    """The draws of one batch's decode. Sub-stream 0 then the ensemble
    member keys the latent draw, sub-stream 1 then the step keys the token
    draws, as in JAX."""

    def __init__(self, seed: int, stream_ids: torch.Tensor):
        self.keys = row_keys(int(seed), stream_ids.long())
        self._tok = fold(self.keys, 1)

    def latent_eps(self, member: int, n: int) -> torch.Tensor:
        """eps (B, n) of ``z = mu + sigma * eps``."""
        return normal(fold(fold(self.keys, 0), member), n)

    def token_gumbel(self, t: int, n: int) -> torch.Tensor:
        """Gumbel noise (B, n) of step ``t``'s draw over n tokens."""
        return gumbel(fold(self._tok, t), n)
