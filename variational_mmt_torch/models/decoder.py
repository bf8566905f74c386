"""Input-feeding GRU decoder with global attention. Mirrors
``variational_mmt_tpu/models/decoder.py``: ``DecoderStep`` (:43-110) and,
from ``GRUDecoder``, ``ih_emb``, ``init_carry`` (:135), the teacher-forced
sequence (``__call__``, :141-249, input-feed path), its sequence-packed form
(``packed_seq``, :251-331, input-feed path), ``project_memory`` (:333) and
``one_step`` (:357-411).

Dropout between the layers is one mask ``dmid`` (B,T,H) drawn up front from
the caller's generator, as the JAX package's fused paths draw it
(:208-215), and it serves both routes of the teacher-forced sequence.

Carry = (per-layer hidden states, input-feed vector = the previous
attentional hidden).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from variational_mmt_torch.models.attention import GlobalAttention
from variational_mmt_torch.models.gru import dropout, dropout_mask, gru_gates
from variational_mmt_torch.models.layers import Dense
from variational_mmt_torch.ops.decode_step import (decode_step, gru_chain, pad_step_weights,
                                                   pad_units, padded_width)
from variational_mmt_torch.ops.decoder import fused_decoder_pallas

DecoderCarry = Tuple[Tuple[torch.Tensor, ...], torch.Tensor]


class DecoderStep(nn.Module):
    """One decoder timestep over the whole batch, from the embedding part of
    the layer-0 input projection (``emb_proj`` (B, 3H)). Holds the recurrent
    weights as raw (H, 3H) parameters, as the JAX module does."""

    def __init__(self, hidden: int, layers: int = 2, attn_type: str = "general",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = hidden
        self.layers = layers
        self.dtype = dtype
        for l in range(layers):
            setattr(self, f"hh_kernel{l}", nn.Parameter(torch.empty(hidden, 3 * hidden)))
            setattr(self, f"hh_bias{l}", nn.Parameter(torch.empty(3 * hidden)))
        self.ih_feed = Dense(hidden, 3 * hidden, use_bias=False, dtype=dtype)
        for l in range(layers - 1):
            self.add_module(f"ih_mid{l}", Dense(hidden, 3 * hidden, dtype=dtype))
        self.attn = GlobalAttention(hidden, attn_type, dtype)

    def hh(self, l: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer l's recurrent kernel and bias, cast to the compute dtype."""
        return (getattr(self, f"hh_kernel{l}").to(self.dtype),
                getattr(self, f"hh_bias{l}").to(self.dtype))

    def forward(self, carry: DecoderCarry, emb_proj: torch.Tensor, memory: torch.Tensor,
                src_mask: torch.Tensor, keys: torch.Tensor = None,
                dmid: Optional[torch.Tensor] = None):
        """``dmid`` (B,H): dropout scales applied to each layer's output
        before the next layer's input projection (None: no dropout)."""
        hs, feed = carry
        x_proj = emb_proj + self.ih_feed(feed)
        new_hs: List[torch.Tensor] = []
        for l in range(self.layers):
            wh, bh = self.hh(l)
            s_new = gru_gates(x_proj, hs[l] @ wh + bh, hs[l])
            new_hs.append(s_new)
            if l + 1 < self.layers:
                x_proj = getattr(self, f"ih_mid{l}")(s_new if dmid is None else s_new * dmid)
        attn_h, align = self.attn(new_hs[-1], memory, src_mask, keys=keys)
        return (tuple(new_hs), attn_h), (attn_h, align)


def fused_step_eligible(cfg) -> bool:
    """Whether the decode-step kernels (``pallas_step`` 1 and 2) compute
    this decoder: 2 layers, general attention, GRU cells, input feed
    (``variational_mmt_tpu/decode/translator.py:184-188``) of the
    ModelConfig ``cfg``."""
    return (cfg.dec_layers == 2 and cfg.attn_type == "general" and cfg.rnn_type == "gru"
            and cfg.input_feed)


class GRUDecoder(nn.Module):
    """``use_pallas and pallas_decoder`` runs the teacher-forced sequence
    through the decoder sequence kernels (ops/decoder.py) when the decoder
    is one they compute (2 layers, general attention: JAX's ``eligible``,
    :192-198); otherwise a Python loop over ``DecoderStep`` that autograd
    differentiates. ``fused`` (the JAX custom-VJP scan) is not ported."""

    def __init__(self, emb_dim: int, hidden: int, layers: int = 2,
                 attn_type: str = "general", dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, use_pallas: bool = False,
                 pallas_decoder: bool = False, fused: bool = False):
        super().__init__()
        self.hidden = hidden
        self.layers = layers
        self.attn_type = attn_type
        self.dtype = dtype
        self.dropout = dropout
        self.use_pallas = use_pallas
        self.pallas_decoder = pallas_decoder
        self.fused = fused
        self.ih_emb = Dense(emb_dim, 3 * hidden, dtype=dtype)
        self.step = DecoderStep(hidden, layers, attn_type, dtype)

    def init_carry(self, init_hs: List[torch.Tensor]) -> DecoderCarry:
        return (tuple(init_hs), torch.zeros_like(init_hs[-1]))

    def forward(self, emb: torch.Tensor, memory: torch.Tensor, src_mask: torch.Tensor,
                init_hs: List[torch.Tensor], generator: Optional[torch.Generator] = None,
                extra_input_proj: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced sequence: emb (B,T,E) target-input embeddings,
        memory (B,S,H), src_mask (B,S), per-layer init states (B,H).
        Dropout draws from ``generator`` (None: deterministic). Returns
        (attentional hiddens (B,T,H), alignments (B,T,S))."""
        if self.fused:
            raise NotImplementedError("fused_decoder (the custom-VJP decoder scan) is not "
                                      "ported yet; use pallas_decoder or the plain loop")
        B, T, _ = emb.shape
        H, dt = self.hidden, self.dtype
        emb_proj = self.ih_emb(emb)
        if extra_input_proj is not None:
            emb_proj = emb_proj + extra_input_proj[:, None, :]
        keys = self.step.attn.project_memory(memory)
        drop = generator is not None and self.dropout > 0.0
        dmid = dropout_mask((B, T, H), self.dropout, generator, dt, emb.device) if drop else None
        eligible = self.layers == 2 and self.attn_type == "general"  # GRU cells: this class
        if self.use_pallas and self.pallas_decoder and eligible:
            step = self.step
            p_out = step.attn.linear_out.kernel.to(dt)
            mem_v = memory @ p_out[:H]
            mask_bias = (1.0 - src_mask.float()) * -1e9
            wh0, bh0 = step.hh(0)
            wh1, bh1 = step.hh(1)
            if dmid is None:
                dmid = torch.ones((B, T, H), dtype=dt, device=emb.device)
            attn_hs, aligns = fused_decoder_pallas(
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
        Always the plain loop, as in JAX (neither the sequence kernels nor
        ``fused`` know resets). Dropout draws from ``generator`` as
        :meth:`forward` does. Returns (attentional hiddens (B,T,H),
        alignments (B,T,S))."""
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
