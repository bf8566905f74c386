"""GRU and LSTM recurrences. Mirrors ``variational_mmt_tpu/models/gru.py``.

The input projection of every timestep is hoisted out of the recurrence as
one GEMM; only ``h @ Wh`` recurs. Masked steps pass the carry through, so
the reverse direction is right over right-padded batches. GRU gates follow
the cuDNN convention: ``r, z`` sigmoid, ``n = tanh(x_n + r * (h @ Whn +
bhn))``. LSTM cells (``cell_type='lstm'``, the reference's ``-rnn_type
LSTM``) project to ``[i | f | g | o]`` (4H), add 1 to the forget gate's
pre-activation (:33-48) and carry ``[h | c]`` (B, 2H) as one tensor.

Sequence packing (several sentences a row) resets the carry at each
segment's first token in both directions, to zero or to a given state
(``init_seq``, the packed decoder's per-segment bridge states)
(:114-170, :241-298).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import torch
from torch import nn

from variational_mmt_torch.models.layers import Dense

log = logging.getLogger(__name__)
_wide_logged = set()  # (role, hidden, dtype) of the layers already logged as too wide


def lstm_gates(x_proj: torch.Tensor, h_proj: torch.Tensor,
               c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """LSTM cell from precomputed projections, [i | f | g | o] layout, with
    the forget gate's bias +1. x_proj, h_proj (..., 4H); c (..., H).
    Returns (h', c')."""
    xi, xf, xg, xo = x_proj.chunk(4, dim=-1)
    hi, hf, hg, ho = h_proj.chunk(4, dim=-1)
    i = torch.sigmoid(xi + hi)
    f = torch.sigmoid(xf + hf + 1.0)
    g = torch.tanh(xg + hg)
    o = torch.sigmoid(xo + ho)
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def n_gates(cell_type: str) -> int:
    """Projection multiple: GRU packs 3 gate blocks, LSTM 4."""
    return 4 if cell_type == "lstm" else 3


def cell_step(x_proj: torch.Tensor, s: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
              cell_type: str = "gru") -> torch.Tensor:
    """One cell on the state s, (B,H) for GRU or (B,2H) [h|c] for LSTM,
    from its input projection x_proj (B,G*H); returns the new state."""
    if cell_type == "lstm":
        h, c = s.chunk(2, dim=-1)
        return torch.cat(lstm_gates(x_proj, h @ wh + bh, c), dim=-1)
    return gru_gates(x_proj, s @ wh + bh, s)


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
                    reverse: bool = False, reset: Optional[torch.Tensor] = None,
                    cell_type: str = "gru", init_seq: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan one layer over x_proj (B,T,G*H) in plain PyTorch (JAX
    :114-166). ``carry0`` is (B,H) for GRU, (B,2H) ``[h | c]`` for LSTM.
    With ``mask`` (B,T), masked steps pass the carry through. ``reset``
    (B,T): where > 0 the carry is replaced before the cell consumes
    position t, by ``init_seq[:, t]`` when ``init_seq`` (B,T,H) is given
    (``[init_seq[:, t] | 0]`` for LSTM), else by zeros. Returns (outs
    (B,T,H), final carry)."""
    T = x_proj.shape[1]
    lstm = cell_type == "lstm"
    H = carry0.shape[-1] // 2 if lstm else carry0.shape[-1]
    s = carry0
    outs: List[Optional[torch.Tensor]] = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if reset is not None:
            if init_seq is None:
                fresh = torch.zeros_like(s)
            else:
                fresh = init_seq[:, t]
                if lstm:
                    fresh = torch.cat([fresh, torch.zeros_like(fresh)], dim=-1)
            s = torch.where(reset[:, t, None] > 0, fresh, s)
        s_new = cell_step(x_proj[:, t], s, wh, bh, cell_type)
        if mask is not None:
            s_new = torch.where(mask[:, t, None] > 0, s_new, s)
        s = s_new
        outs[t] = s[..., :H]
    return torch.stack(outs, dim=1), s


class UniGRU(nn.Module):
    """One direction, one layer. Returns (outputs (B,T,H), final state):
    (B,H) for GRU, (B,2H) ``[h | c]`` for LSTM (``cell_type``), whose
    weights are (H,4H). With ``use_pallas`` a GRU layer runs in the GRU-scan
    kernels (ops/gru_scan.py), as the JAX package runs its Pallas kernel,
    where they hold the width (``scan_kernel_holds``: H <= 1024); a wider
    layer takes the plain scan, logged once, naming ``role`` (the encoder,
    the target encoder). An LSTM layer always takes the plain scan: the JAX
    package has no LSTM kernel and routes it the same way (JAX :185,
    :206-222), so this is its route, not a fallback."""

    def __init__(self, in_dim: int, hidden: int, reverse: bool = False,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 cell_type: str = "gru", role: str = "encoder"):
        super().__init__()
        self.hidden = hidden
        self.reverse = reverse
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.cell_type = cell_type
        self.role = role
        G = n_gates(cell_type)
        self.ih = Dense(in_dim, G * hidden, dtype=dtype)
        self.hh_kernel = nn.Parameter(torch.empty(hidden, G * hidden))
        self.hh_bias = nn.Parameter(torch.empty(G * hidden))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                reset: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``reset`` (B,T) f32: 1 at a packed segment's start (None: none)."""
        x_proj = self.ih(x)
        h0 = torch.zeros((x.shape[0], self.hidden), dtype=self.dtype, device=x.device)
        if self.cell_type == "gru" and self.use_pallas \
                and scan_route(self.hidden, self.dtype, self.role):
            from variational_mmt_torch.ops.gru_scan import gru_layer_scan_ad

            # as the JAX Pallas path: Wh in the compute dtype, bh in f32,
            # f32 results cast to the compute dtype
            outs, final = gru_layer_scan_ad(x_proj, mask, h0, self.hh_kernel.to(self.dtype),
                                            self.hh_bias, self.reverse, reset)
            return outs.to(self.dtype), final.to(self.dtype)
        carry0 = torch.cat([h0, h0], dim=-1) if self.cell_type == "lstm" else h0
        return cell_layer_scan(x_proj, carry0, self.hh_kernel.to(self.dtype),
                               self.hh_bias.to(self.dtype), mask=mask.to(self.dtype),
                               reverse=self.reverse, reset=reset, cell_type=self.cell_type)


def scan_route(hidden: int, dtype: torch.dtype, role: str) -> bool:
    """Whether a ``use_pallas`` GRU layer of ``hidden`` units takes the scan
    kernels; logs the first layer of each role and width that does not."""
    from variational_mmt_torch.ops.gru_scan import SCAN_MAX_HIDDEN, scan_kernel_holds

    if scan_kernel_holds(hidden, dtype):
        return True
    if (role, hidden, dtype) not in _wide_logged:
        _wide_logged.add((role, hidden, dtype))
        log.warning("%s GRU layer of %d units (%s): wider than the scan kernels hold (%d); "
                    "it takes the plain scan", role, hidden, dtype, SCAN_MAX_HIDDEN)
    return False


class BiGRUEncoder(nn.Module):
    """Bidirectional multi-layer GRU (or LSTM, ``cell_type``) encoder.
    ``hidden`` is the total size: each direction gets hidden // 2. Dropout
    (rate ``dropout``) applies to the input of every layer after the first,
    drawn from the generator passed to ``forward`` (none: deterministic).
    ``role`` names the encoder in the log line of a layer too wide for the
    scan kernels."""

    def __init__(self, in_dim: int, hidden: int, layers: int = 2,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 dropout: float = 0.0, cell_type: str = "gru", role: str = "encoder"):
        super().__init__()
        if hidden % 2:
            raise ValueError(f"BiGRUEncoder hidden must be even, got {hidden}")
        self.layers = layers
        self.dropout = dropout
        self.cell_type = cell_type
        half = hidden // 2
        for layer in range(layers):
            d = in_dim if layer == 0 else hidden
            for name, reverse in ((f"fwd{layer}", False), (f"bwd{layer}", True)):
                self.add_module(name, UniGRU(d, half, reverse, dtype, use_pallas, cell_type,
                                             role))

    def forward(self, emb: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                seg: Optional[torch.Tensor] = None,
                seg_bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """emb (B,T,E), mask (B,T) -> (memory (B,T,H), finals per layer:
        (B,H) laid out [fwd_final | bwd_final] for GRU, (B,2H) laid out
        [h_f h_b | c_f c_b] for LSTM, so that final[:, :H] is the hidden).

        Sequence packing: ``seg`` (B,T) segment ids, -1 at pads, resets the
        carry at each segment's first token (forward) and last token
        (backward), so each segment is encoded as if alone in its row. With
        ``seg_bounds = (first, last)`` ((B,K) positions) the finals are per
        segment, (B,K,H): the forward output at the segment's last token
        beside the backward output at its first. GRU only, as in JAX: the
        output stream carries h, not the LSTM cell state."""
        if seg_bounds is not None and self.cell_type == "lstm":
            raise ValueError("sequence packing supports rnn_type=gru only (the output "
                             "stream carries h, not the LSTM cell state)")
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
            if self.cell_type == "lstm":
                # per-direction [h|c] halves repacked as [h_f h_b | c_f c_b]
                fh, fc = fwd_fin.chunk(2, dim=-1)
                bh, bc = bwd_fin.chunk(2, dim=-1)
                finals.append(torch.cat([fh, bh, fc, bc], dim=-1))
            else:
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
