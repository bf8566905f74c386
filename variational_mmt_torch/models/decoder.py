"""Input-feeding decoder with global attention, GRU or LSTM cells. Mirrors
``variational_mmt_tpu/models/decoder.py``: ``DecoderStep`` (:43-110) and,
from ``GRUDecoder``, ``ih_emb``, ``init_carry`` (:135), the teacher-forced
sequence (``__call__``, :141-249), its sequence-packed form
(``packed_seq``, :251-331), ``project_memory`` (:333) and ``one_step``
(:357-411).

With ``input_feed=False`` no attention feeds back into the recurrence, so
each layer is a unidirectional sequence of its own (:157-181): the
teacher-forced path scans layer by layer, through the GRU-scan kernels
with ``use_pallas`` and GRU cells, then runs one batched attention.

Dropout between the layers is one mask ``dmid`` (B,T,H) drawn up front from
the caller's generator, as the JAX package's fused paths draw it
(:208-215), and it serves every route of the teacher-forced sequence: the
decoder sequence kernels, the custom-backward ``fused_decoder``
(models/fused_decoder.py) and the plain loop (:190-235).

Carry = (per-layer states, (B,H) for GRU and (B,2H) ``[h | c]`` for LSTM;
input-feed vector = the previous attentional hidden, (B,H)).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from variational_mmt_torch.models.attention import GlobalAttention
from variational_mmt_torch.models.fused_decoder import fused_input_feed_decoder
from variational_mmt_torch.models.gru import (cell_layer_scan, cell_step, dropout,
                                              dropout_mask, n_gates)
from variational_mmt_torch.models.layers import Dense
from variational_mmt_torch.ops.decode_step import (decode_step, gru_chain, pad_step_weights,
                                                   pad_units, padded_width)
from variational_mmt_torch.ops.decoder import fused_decoder_pallas

DecoderCarry = Tuple[Tuple[torch.Tensor, ...], torch.Tensor]


class DecoderStep(nn.Module):
    """One decoder timestep over the whole batch, from the embedding part of
    the layer-0 input projection (``emb_proj`` (B, G*H), G = 3 for GRU, 4
    for LSTM). Holds the recurrent weights as raw (H, G*H) parameters, as
    the JAX module does; ``ih_feed`` exists only with ``input_feed``."""

    def __init__(self, hidden: int, layers: int = 2, attn_type: str = "general",
                 dtype: torch.dtype = torch.float32, input_feed: bool = True,
                 cell_type: str = "gru"):
        super().__init__()
        self.hidden = hidden
        self.layers = layers
        self.dtype = dtype
        self.input_feed = input_feed
        self.cell_type = cell_type
        G = n_gates(cell_type)
        for l in range(layers):
            setattr(self, f"hh_kernel{l}", nn.Parameter(torch.empty(hidden, G * hidden)))
            setattr(self, f"hh_bias{l}", nn.Parameter(torch.empty(G * hidden)))
        if input_feed:
            self.ih_feed = Dense(hidden, G * hidden, use_bias=False, dtype=dtype)
        for l in range(layers - 1):
            self.add_module(f"ih_mid{l}", Dense(hidden, G * hidden, dtype=dtype))
        self.attn = GlobalAttention(hidden, attn_type, dtype)

    def hh(self, l: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer l's recurrent kernel and bias, cast to the compute dtype."""
        return (getattr(self, f"hh_kernel{l}").to(self.dtype),
                getattr(self, f"hh_bias{l}").to(self.dtype))

    def h(self, s: torch.Tensor) -> torch.Tensor:
        """The hidden half of a layer state (JAX ``_h``, :87-88)."""
        return s[..., :self.hidden] if self.cell_type == "lstm" else s

    def forward(self, carry: DecoderCarry, emb_proj: torch.Tensor, memory: torch.Tensor,
                src_mask: torch.Tensor, keys: torch.Tensor = None,
                dmid: Optional[torch.Tensor] = None):
        """``dmid`` (B,H): dropout scales applied to each layer's output
        before the next layer's input projection (None: no dropout)."""
        hs, feed = carry
        x_proj = emb_proj + self.ih_feed(feed) if self.input_feed else emb_proj
        new_hs: List[torch.Tensor] = []
        for l in range(self.layers):
            s_new = cell_step(x_proj, hs[l], *self.hh(l), self.cell_type)
            new_hs.append(s_new)
            if l + 1 < self.layers:
                h = self.h(s_new)
                x_proj = getattr(self, f"ih_mid{l}")(h if dmid is None else h * dmid)
        attn_h, align = self.attn(self.h(new_hs[-1]), memory, src_mask, keys=keys)
        return (tuple(new_hs), attn_h), (attn_h, align)


def fused_step_eligible(cfg) -> bool:
    """Whether the decode-step kernels (``pallas_step`` 1 and 2) compute
    this decoder: 2 layers, general attention, GRU cells, input feed
    (``variational_mmt_tpu/decode/translator.py:184-188``) of the
    ModelConfig ``cfg``."""
    return (cfg.dec_layers == 2 and cfg.attn_type == "general" and cfg.rnn_type == "gru"
            and cfg.input_feed)


class GRUDecoder(nn.Module):
    """The teacher-forced sequence takes one of three routes.
    ``input_feed=False``: a scan per layer, then one batched attention
    (JAX :157-181); with ``use_pallas`` and GRU cells each layer runs in the
    GRU-scan kernels (``gru_layer_scan_ad``, forward and backward) from its
    bridge state, where they hold the width (H <= 512). Otherwise, for the
    decoders that the fused routes know (2 layers, general attention, GRU
    cells: JAX's ``eligible``, :192-198), ``use_pallas and pallas_decoder``
    takes the decoder sequence kernels (ops/decoder.py) and else ``fused``
    the custom-backward loop (``fused_input_feed_decoder``); every other
    decoder takes a Python loop over ``DecoderStep`` that autograd
    differentiates."""

    def __init__(self, emb_dim: int, hidden: int, layers: int = 2,
                 attn_type: str = "general", dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, use_pallas: bool = False,
                 pallas_decoder: bool = False, fused: bool = False,
                 input_feed: bool = True, cell_type: str = "gru"):
        super().__init__()
        self.hidden = hidden
        self.layers = layers
        self.attn_type = attn_type
        self.dtype = dtype
        self.dropout = dropout
        self.use_pallas = use_pallas
        self.pallas_decoder = pallas_decoder
        self.fused = fused
        self.input_feed = input_feed
        self.cell_type = cell_type
        self.ih_emb = Dense(emb_dim, n_gates(cell_type) * hidden, dtype=dtype)
        self.step = DecoderStep(hidden, layers, attn_type, dtype, input_feed, cell_type)

    def init_carry(self, init_hs: List[torch.Tensor]) -> DecoderCarry:
        # the feed is (B,H), also beside LSTM states (B,2H)
        return (tuple(init_hs), torch.zeros_like(init_hs[-1][..., :self.hidden]))

    def forward(self, emb: torch.Tensor, memory: torch.Tensor, src_mask: torch.Tensor,
                init_hs: List[torch.Tensor], generator: Optional[torch.Generator] = None,
                extra_input_proj: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced sequence: emb (B,T,E) target-input embeddings,
        memory (B,S,H), src_mask (B,S), per-layer init states. Dropout draws
        from ``generator`` (None: deterministic). Returns (attentional
        hiddens (B,T,H), alignments (B,T,S))."""
        B, T, _ = emb.shape
        H, dt = self.hidden, self.dtype
        emb_proj = self.ih_emb(emb)
        if extra_input_proj is not None:
            emb_proj = emb_proj + extra_input_proj[:, None, :]
        drop = generator is not None and self.dropout > 0.0
        dmid = dropout_mask((B, T, H), self.dropout, generator, dt, emb.device) if drop else None
        if not self.input_feed:
            top = self._layer_scans(emb_proj, init_hs, dmid)
            attn_hs, aligns = self.step.attn(top, memory, src_mask)
            return dropout(attn_hs, self.dropout, generator), aligns
        keys = self.step.attn.project_memory(memory)
        eligible = self.layers == 2 and self.attn_type == "general" and self.cell_type == "gru"
        kernels = self.use_pallas and self.pallas_decoder and eligible
        if kernels or (self.fused and eligible):
            step = self.step
            p_out = step.attn.linear_out.kernel.to(dt)
            mem_v = memory @ p_out[:H]
            mask_bias = (1.0 - src_mask.float()) * -1e9
            wh0, bh0 = step.hh(0)
            wh1, bh1 = step.hh(1)
            if dmid is None:
                dmid = torch.ones((B, T, H), dtype=dt, device=emb.device)
            run = fused_decoder_pallas if kernels else fused_input_feed_decoder
            attn_hs, aligns = run(
                emb_proj, dmid, init_hs[0], init_hs[1], step.ih_feed.kernel.to(dt), wh0, bh0,
                step.ih_mid0.kernel.to(dt), step.ih_mid0.bias.to(dt), wh1, bh1, keys, mem_v,
                p_out[H:], mask_bias)
            attn_hs = attn_hs.to(dt)
        else:
            carry = self.init_carry(init_hs)
            outs, aligns = [], []
            for t in range(T):
                carry, (attn_h, align) = self.step(carry, emb_proj[:, t], memory, src_mask,
                                                   keys, None if dmid is None else dmid[:, t])
                outs.append(attn_h)
                aligns.append(align)
            attn_hs, aligns = torch.stack(outs, dim=1), torch.stack(aligns, dim=1)
        return dropout(attn_hs, self.dropout, generator), aligns

    def _layer_scans(self, x_proj: torch.Tensor, init_hs: List[torch.Tensor],
                     dmid: Optional[torch.Tensor]) -> torch.Tensor:
        """The ``input_feed=False`` recurrence: each layer scanned over the
        whole sequence from its init state, its outputs (times ``dmid``)
        projected into the next layer's input. Returns the top layer's
        hiddens (B,T,H). As JAX (:160-171), the kernel route gets a mask of
        ones and Wh and bh in the compute dtype (the wrapper widens bh to
        f32, so bh is rounded first as JAX rounds it), and its f32 outputs
        come back in the compute dtype; the bridge state's gradient flows
        back through the kernel's dh0."""
        B, T, _ = x_proj.shape
        dt = self.dtype
        kernel = self.use_pallas and self.cell_type == "gru"
        if kernel:
            from variational_mmt_torch.ops.gru_scan import gru_layer_scan_ad

            ones = torch.ones((B, T), dtype=torch.float32, device=x_proj.device)
        for l in range(self.layers):
            wh, bh = self.step.hh(l)
            if kernel:
                outs, _ = gru_layer_scan_ad(x_proj, ones, init_hs[l], wh, bh, False)
                outs = outs.to(dt)
            else:
                outs, _ = cell_layer_scan(x_proj, init_hs[l], wh, bh, cell_type=self.cell_type)
            if l + 1 < self.layers:
                x_proj = getattr(self.step, f"ih_mid{l}")(outs if dmid is None else outs * dmid)
        return outs

    def packed_seq(self, emb: torch.Tensor, memory: torch.Tensor, src_seg: torch.Tensor,
                   tgt_seg: torch.Tensor, init_hs_seg: List[torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   extra_input_proj_seg: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced sequence over a sequence-packed batch: emb (B,T,E)
        packed target inputs, memory (B,S,H) packed source memory, segment
        ids src_seg (B,S) and tgt_seg (B,T) (-1 at pads), per-layer
        per-segment init states (B,K,H), the optional per-segment input
        projection of z (B,K,3H). Each segment decodes as if alone: at its
        first position the layer states become its own bridge init and the
        input feed zero, and it attends only to its own source positions.
        GRU cells only, and always the plain scan or loop, as in JAX
        (neither the sequence kernels nor ``fused`` know resets; with
        ``input_feed=False`` each layer scans with the reset stream and
        ``init_seq``, :293-309). Dropout draws from ``generator`` as
        :meth:`forward` does. Returns (attentional hiddens (B,T,H),
        alignments (B,T,S))."""
        if self.cell_type != "gru":
            raise ValueError("sequence packing supports rnn_type=gru only")
        B, T, _ = emb.shape
        H, dt = self.hidden, self.dtype
        emb_proj = self.ih_emb(emb)
        seg_idx = tgt_seg.clamp(min=0).long()[..., None]  # (B,T,1)

        def per_position(per_seg: torch.Tensor) -> torch.Tensor:
            """(B,K,D) -> (B,T,D): each position's segment row."""
            return torch.gather(per_seg, 1, seg_idx.expand(-1, -1, per_seg.shape[-1]))

        if extra_input_proj_seg is not None:
            emb_proj = emb_proj + per_position(extra_input_proj_seg.to(emb_proj.dtype))
        init_sel = [per_position(h.to(dt)) for h in init_hs_seg]
        edge = torch.full_like(tgt_seg[:, :1], -2)
        starts = (tgt_seg >= 0) & (tgt_seg != torch.cat([edge, tgt_seg[:, :-1]], dim=1))
        # per-step attention mask (B,T,S): a position sees its own segment's source
        amask = ((tgt_seg[:, :, None] == src_seg[:, None, :])
                 & (src_seg >= 0)[:, None, :]).float()
        keys = self.step.attn.project_memory(memory)
        drop = generator is not None and self.dropout > 0.0
        dmid = dropout_mask((B, T, H), self.dropout, generator, dt, emb.device) if drop else None
        if not self.input_feed:
            x_proj, reset = emb_proj, starts.float()
            for l in range(self.layers):
                wh, bh = self.step.hh(l)
                outs, _ = cell_layer_scan(x_proj, torch.zeros_like(init_sel[l][:, 0]), wh, bh,
                                          reset=reset, init_seq=init_sel[l])
                if l + 1 < self.layers:
                    x_proj = getattr(self.step, f"ih_mid{l}")(
                        outs if dmid is None else outs * dmid)
            attn_hs, aligns = self.step.attn(outs, memory, amask, keys=keys)
            return dropout(attn_hs, self.dropout, generator), aligns
        hs = tuple(torch.zeros_like(i[:, 0]) for i in init_sel)
        feed = torch.zeros((B, H), dtype=dt, device=emb.device)
        outs, aligns = [], []
        for t in range(T):
            r = starts[:, t, None]
            hs = tuple(torch.where(r, i[:, t], h) for i, h in zip(init_sel, hs))
            feed = torch.where(r, torch.zeros_like(feed), feed)
            (hs, feed), (attn_h, align) = self.step(
                (hs, feed), emb_proj[:, t], memory, amask[:, t], keys,
                None if dmid is None else dmid[:, t])
            outs.append(attn_h)
            aligns.append(align)
        return (dropout(torch.stack(outs, dim=1), self.dropout, generator),
                torch.stack(aligns, dim=1))

    def project_memory(self, memory: torch.Tensor, with_values: bool = False):
        """Pre-projected attention keys for repeated ``one_step`` calls;
        ``with_values`` also hoists the context half of linear_out
        (``mem_v = memory @ Wc_ctx``) and returns ``(keys, mem_v)``, the
        layout the fused decode-step kernel reads (``VMMTModel.project_memory``
        asks ``fused_step_eligible`` first); on the card both at the
        kernel's width, zero-padded once here for every step."""
        keys = self.step.attn.project_memory(memory)
        if not with_values:
            return keys
        p_out = self.step.attn.linear_out.kernel
        mem_v = memory @ p_out[: self.hidden].to(memory.dtype)
        H, Hp = self.hidden, self._kernel_width(memory.device)
        return pad_units(keys, H, Hp), pad_units(mem_v, H, Hp)

    def _kernel_width(self, device: torch.device) -> int:
        """The width the decode-step kernels compute on ``device``: H padded
        to a multiple of 4 on the card, H on the CPU (the plain versions)."""
        return self.hidden if device.type == "cpu" else padded_width(self.hidden)

    def step_weights(self) -> tuple:
        """The fused step's weights (Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1,
        Wc_q) in the compute dtype and, on the card, at the kernel's width:
        prepared once a request and passed to every ``one_step``."""
        step, dt = self.step, self.dtype
        wh0, bh0 = step.hh(0)
        wh1, bh1 = step.hh(1)
        w = (step.ih_feed.kernel.to(dt), wh0, bh0, step.ih_mid0.kernel.to(dt),
             step.ih_mid0.bias.to(dt), wh1, bh1,
             step.attn.linear_out.kernel.to(dt)[self.hidden:])
        return w if self._kernel_width(w[0].device) == self.hidden else pad_step_weights(*w)

    def one_step(self, carry: DecoderCarry, tok_emb: torch.Tensor, memory: torch.Tensor,
                 src_mask: torch.Tensor, extra_input_proj: torch.Tensor = None, keys=None,
                 weights: Optional[tuple] = None):
        """Single decode step. ``keys`` selects the path as in JAX: a tensor
        takes the plain step; a ``(keys, mem_v)`` 2-tuple the fused
        decode-step kernel; a ``(keys,)`` 1-tuple the GRU-chain kernel with
        attention in plain PyTorch. ``weights``: the kernels' weights from
        :meth:`step_weights`, prepared once a request (None: here)."""
        emb_proj = self.ih_emb(tok_emb)
        if extra_input_proj is not None:
            emb_proj = emb_proj + extra_input_proj
        if not isinstance(keys, tuple):
            new_carry, (attn_h, align) = self.step(carry, emb_proj, memory, src_mask, keys)
            return new_carry, (attn_h, align)
        hs, feed = carry
        *wargs, wc_q = self.step_weights() if weights is None else weights
        if len(keys) == 1:
            h0n, h1n = gru_chain(emb_proj, hs[0], hs[1], feed, *wargs)
            attn_h, probs = self.step.attn(h1n, memory, src_mask, keys=keys[0])
        else:
            k, mem_v = keys
            mask_bias = (1.0 - src_mask.float()) * -1e9
            h0n, h1n, attn_h, probs = decode_step(emb_proj, hs[0], hs[1], feed, *wargs,
                                                  k, mem_v, wc_q, mask_bias)
        return ((h0n, h1n), attn_h), (attn_h, probs)
