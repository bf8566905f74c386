"""GRU recurrences. Mirrors ``variational_mmt_tpu/models/gru.py`` (GRU
cells only; LSTM is not ported yet).

The input projection of every timestep is hoisted out of the recurrence as
one GEMM; only ``h @ Wh`` recurs. Masked steps pass the carry through, so
the reverse direction is right over right-padded batches. Gates follow the
cuDNN convention: ``r, z`` sigmoid, ``n = tanh(x_n + r * (h @ Whn + bhn))``.

Sequence packing (several sentences a row) resets the carry to zero at
each segment's first token in both directions (:114-170, :241-298).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import torch
from torch import nn

from variational_mmt_torch.models.layers import Dense

log = logging.getLogger(__name__)
_wide_logged = set()  # (hidden, dtype) of the layers already logged as too wide


def gru_gates(x_proj: torch.Tensor, h_proj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """New hidden state from precomputed projections, [r | z | n] layout.
    x_proj, h_proj (..., 3H); h (..., H)."""
    xr, xz, xn = x_proj.chunk(3, dim=-1)
    hr, hz, hn = h_proj.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_bwd_core(dh_new: torch.Tensor, x_proj: torch.Tensor, h_proj: torch.Tensor,
                 h_prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hand-derived local VJP of :func:`gru_gates` (one cell application).
    Returns (dx_proj [dr|dz|dn_pre], dh_proj [dr|dz|dhn], dh_prev without
    the ``Wh^T`` product, which the caller owns)."""
    xr, xz, xn = x_proj.chunk(3, dim=-1)
    hr, hz, hn = h_proj.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    dz = dh_new * (h_prev - n)
    dn = dh_new * (1.0 - z)
    dh_prev = dh_new * z
    dn_pre = dn * (1.0 - n * n)
    dr = dn_pre * hn
    dhn = dn_pre * r
    dz_pre = dz * z * (1.0 - z)
    dr_pre = dr * r * (1.0 - r)
    return (torch.cat([dr_pre, dz_pre, dn_pre], dim=-1),
            torch.cat([dr_pre, dz_pre, dhn], dim=-1), dh_prev)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as ``flax.linen.Dropout`` computes it (kept values
    scaled by 1/keep in x's dtype), the mask drawn from ``generator``.
    Identity when ``generator`` is None (deterministic) or rate is 0."""
    if generator is None or rate == 0.0:
        return x
    return x * dropout_mask(x.shape, rate, generator, x.dtype, x.device)


def dropout_mask(shape, rate: float, generator: torch.Generator, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """Bernoulli(1 - rate) / (1 - rate) in ``dtype``."""
    keep = 1.0 - rate
    u = torch.rand(shape, generator=generator, device=device)
    return (u < keep).to(dtype) / keep


def cell_layer_scan(x_proj: torch.Tensor, carry0: torch.Tensor, wh: torch.Tensor,
                    bh: torch.Tensor, mask: Optional[torch.Tensor] = None,
                    reverse: bool = False, reset: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan one GRU layer over x_proj (B,T,3H) in plain PyTorch: the
    ``use_pallas=False`` path. ``reset`` (B,T): where > 0 the carry becomes
    zero before the cell consumes position t (a packed segment's start; the
    ``init_seq`` form of JAX is not ported). Returns (outs (B,T,H), final
    (B,H))."""
    T = x_proj.shape[1]
    h = carry0
    outs: List[Optional[torch.Tensor]] = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if reset is not None:
            h = torch.where(reset[:, t, None] > 0, torch.zeros_like(h), h)
        h_new = gru_gates(x_proj[:, t], h @ wh + bh, h)
        if mask is not None:
            h_new = torch.where(mask[:, t, None] > 0, h_new, h)
        h = h_new
        outs[t] = h
    return torch.stack(outs, dim=1), h


class UniGRU(nn.Module):
    """One direction, one layer. Returns (outputs (B,T,H), final (B,H)).
    With ``use_pallas`` the recurrence runs in the GRU-scan kernels
    (ops/gru_scan.py), as the JAX package runs its Pallas kernel, where
    they hold the width (``scan_kernel_holds``: H <= 512); a wider layer
    takes the plain scan, logged once."""

    def __init__(self, in_dim: int, hidden: int, reverse: bool = False,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False):
        super().__init__()
        self.hidden = hidden
        self.reverse = reverse
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.ih = Dense(in_dim, 3 * hidden, dtype=dtype)
        self.hh_kernel = nn.Parameter(torch.empty(hidden, 3 * hidden))
        self.hh_bias = nn.Parameter(torch.empty(3 * hidden))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                reset: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``reset`` (B,T) f32: 1 at a packed segment's start (None: none)."""
        x_proj = self.ih(x)
        h0 = torch.zeros((x.shape[0], self.hidden), dtype=self.dtype, device=x.device)
        if self.use_pallas and _scan_route(self.hidden, self.dtype):
            from variational_mmt_torch.ops.gru_scan import gru_layer_scan_ad

            # as the JAX Pallas path: Wh in the compute dtype, bh in f32,
            # f32 results cast to the compute dtype
            outs, final = gru_layer_scan_ad(x_proj, mask, h0, self.hh_kernel.to(self.dtype),
                                            self.hh_bias, self.reverse, reset)
            return outs.to(self.dtype), final.to(self.dtype)
        return cell_layer_scan(x_proj, h0, self.hh_kernel.to(self.dtype),
                               self.hh_bias.to(self.dtype), mask=mask.to(self.dtype),
                               reverse=self.reverse, reset=reset)


def _scan_route(hidden: int, dtype: torch.dtype) -> bool:
    """Whether a ``use_pallas`` layer of ``hidden`` units takes the scan
    kernels; logs the first layer of each width that does not."""
    from variational_mmt_torch.ops.gru_scan import SCAN_MAX_HIDDEN, scan_kernel_holds

    if scan_kernel_holds(hidden, dtype):
        return True
    if (hidden, dtype) not in _wide_logged:
        _wide_logged.add((hidden, dtype))
        log.warning("GRU layer of %d units (%s): wider than the scan kernels hold (%d); "
                    "it takes the plain scan", hidden, dtype, SCAN_MAX_HIDDEN)
    return False


class BiGRUEncoder(nn.Module):
    """Bidirectional multi-layer GRU encoder. ``hidden`` is the total size:
    each direction gets hidden // 2. Dropout (rate ``dropout``) applies to
    the input of every layer after the first, drawn from the generator
    passed to ``forward`` (none: deterministic)."""

    def __init__(self, in_dim: int, hidden: int, layers: int = 2,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        if hidden % 2:
            raise ValueError(f"BiGRUEncoder hidden must be even, got {hidden}")
        self.layers = layers
        self.dropout = dropout
        half = hidden // 2
        for layer in range(layers):
            d = in_dim if layer == 0 else hidden
            self.add_module(f"fwd{layer}", UniGRU(d, half, False, dtype, use_pallas))
            self.add_module(f"bwd{layer}", UniGRU(d, half, True, dtype, use_pallas))

    def forward(self, emb: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                seg: Optional[torch.Tensor] = None,
                seg_bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """emb (B,T,E), mask (B,T) -> (memory (B,T,H), finals per layer
        (B,H) laid out [fwd_final | bwd_final]).

        Sequence packing: ``seg`` (B,T) segment ids, -1 at pads, resets the
        carry at each segment's first token (forward) and last token
        (backward), so each segment is encoded as if alone in its row. With
        ``seg_bounds = (first, last)`` ((B,K) positions) the finals are per
        segment, (B,K,H): the forward output at the segment's last token
        beside the backward output at its first."""
        reset_f = reset_b = None
        if seg is not None:
            valid = seg >= 0
            edge = torch.full_like(seg[:, :1], -2)
            prev = torch.cat([edge, seg[:, :-1]], dim=1)
            nxt = torch.cat([seg[:, 1:], edge], dim=1)
            reset_f = (valid & (seg != prev)).float()
            reset_b = (valid & (seg != nxt)).float()
        x = emb
        finals: List[torch.Tensor] = []
        for layer in range(self.layers):
            if layer > 0:
                x = dropout(x, self.dropout, generator)
            fwd_out, fwd_fin = getattr(self, f"fwd{layer}")(x, mask, reset_f)
            bwd_out, bwd_fin = getattr(self, f"bwd{layer}")(x, mask, reset_b)
            x = torch.cat([fwd_out, bwd_out], dim=-1)
            if seg_bounds is not None:
                first, last = seg_bounds
                fwd_fin, bwd_fin = _gather_rows(fwd_out, last), _gather_rows(bwd_out, first)
            finals.append(torch.cat([fwd_fin, bwd_fin], dim=-1))
        return x, finals


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B,T,H) at positions idx (B,K) -> (B,K,H)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B,T,H), (B,T) -> (B,H) mean over real positions."""
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


def segment_mean(x: torch.Tensor, seg: torch.Tensor, n_segments: int) -> torch.Tensor:
    """(B,T,H), seg (B,T) ids in [-1, K) -> (B,K,H): the mean over each
    packed segment's positions (the packed form of :func:`masked_mean`), as
    one product with the one-hot segment matrix."""
    ids = torch.arange(n_segments, device=seg.device)
    onehot = (seg[:, None, :] == ids[None, :, None]).to(x.dtype)  # (B,K,T)
    counts = onehot.sum(dim=-1, keepdim=True)
    return (onehot @ x) / torch.clamp(counts, min=1.0)
