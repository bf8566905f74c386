"""The input-feed decoder sequence with a hand-derived backward. Mirrors
``variational_mmt_tpu/models/fused_decoder.py`` (the ``fused_decoder``
option): ``fused_input_feed_decoder`` takes JAX's arguments in JAX's order
and is a ``torch.autograd.Function``.

- Forward (JAX ``_fwd_scan``, :45-70): one loop over T carrying (h0, h1,
  feed); the attention query projection is folded into ``keys`` and the
  context half of the output projection into ``mem_v`` by the caller. It
  saves h0', h1', the attention outputs and the probabilities of every
  step.
- Backward (JAX ``_fused_bwd``, :107-166): one reverse loop that carries
  only (dh0, dh1, dfeed) and emits each step's local gradients (the cells'
  from ``models/gru.py`` ``gru_bwd_core``); every weight gradient is then
  one product over the T*B stream, not T small ones inside the loop.

Like JAX's custom-VJP scan, states, products and gradients stay in the
compute dtype (no f32 carries, no rounded products): only the attention
scores, their softmax and its backward run in f32. This is not the
contract of the decoder sequence kernels (``ops/decoder.py``), which keep
states in f32. Scope: 2-layer GRU decoders with general attention and
input feed; ``models/decoder.py`` sends the others to the plain loop. The
gradients of the dropout masks ``dmid`` and of ``mask_bias`` are zero.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from variational_mmt_torch.models.gru import gru_bwd_core, gru_gates


def _gru_bwd_local(dh_new: torch.Tensor, x_proj: torch.Tensor, h_prev: torch.Tensor,
                   wh: torch.Tensor, bh: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Local VJP of ``h_new = gru_gates(x_proj, h_prev @ wh + bh, h_prev)``:
    (dx_proj, dh_proj, dh_prev with the ``wh^T`` product)."""
    dx, dhp, dh_prev = gru_bwd_core(dh_new, x_proj, h_prev @ wh + bh, h_prev)
    return dx, dhp, dh_prev + dhp @ wh.T


class _FusedDecoder(torch.autograd.Function):

    @staticmethod
    def forward(ctx, emb_proj, dmid, h00, h01, wfeed, wh0, bh0, wmid, bmid, wh1, bh1, keys,
                mem_v, wc_q, mask_bias):
        T = emb_proj.shape[1]
        h0, h1 = h00, h01
        feed = torch.zeros_like(h01)
        attn_hs: List[torch.Tensor] = []
        h0s: List[torch.Tensor] = []
        h1s: List[torch.Tensor] = []
        probs: List[torch.Tensor] = []
        for t in range(T):
            x0 = emb_proj[:, t] + feed @ wfeed
            h0 = gru_gates(x0, h0 @ wh0 + bh0, h0)
            x1 = (dmid[:, t] * h0) @ wmid + bmid
            h1 = gru_gates(x1, h1 @ wh1 + bh1, h1)
            scores = torch.einsum("bh,bsh->bs", h1, keys).float() + mask_bias
            p = torch.softmax(scores, dim=-1).to(h1.dtype)
            feed = torch.tanh(torch.einsum("bs,bsh->bh", p, mem_v) + h1 @ wc_q)
            attn_hs.append(feed)
            h0s.append(h0)
            h1s.append(h1)
            probs.append(p)
        attn_hs, h0s, h1s, probs = (torch.stack(x, dim=1) for x in (attn_hs, h0s, h1s, probs))
        ctx.save_for_backward(emb_proj, dmid, h00, h01, wfeed, wh0, bh0, wmid, bmid, wh1, bh1,
                              keys, mem_v, wc_q, attn_hs, h0s, h1s, probs)
        return attn_hs, probs

    @staticmethod
    def backward(ctx, d_attn_seq, d_probs_seq):
        (emb_proj, dmid, h00, h01, wfeed, wh0, bh0, wmid, bmid, wh1, bh1, keys, mem_v, wc_q,
         attn_hs, h0s, h1s, probs) = ctx.saved_tensors
        B, T, H = attn_hs.shape
        dt = attn_hs.dtype
        # the step-t inputs: feed_t = attn_{t-1}, and the previous states
        zeros = torch.zeros((B, 1, H), dtype=dt, device=attn_hs.device)
        feed_hist = torch.cat([zeros, attn_hs[:, :-1]], dim=1)
        h0_hist = torch.cat([h00[:, None], h0s[:, :-1]], dim=1)
        h1_hist = torch.cat([h01[:, None], h1s[:, :-1]], dim=1)
        mid_hist = dmid * h0s  # the dropped layer-1 inputs, recomputed
        dh0 = torch.zeros((B, H), dtype=dt, device=attn_hs.device)
        dh1, dfeed = torch.zeros_like(dh0), torch.zeros_like(dh0)
        outs: List[Tuple[torch.Tensor, ...]] = [()] * T
        for t in range(T - 1, -1, -1):
            attn = attn_hs[:, t]
            da = d_attn_seq[:, t] + dfeed
            pre = (1.0 - attn * attn) * da
            dq = pre @ wc_q.T
            dprobs = (torch.einsum("bh,bsh->bs", pre, mem_v) + d_probs_seq[:, t]).float()
            prf = probs[:, t].float()
            dscores = (prf * (dprobs - (dprobs * prf).sum(-1, keepdim=True))).to(dt)
            dh1n = dq + torch.einsum("bs,bsh->bh", dscores, keys) + dh1
            x1 = mid_hist[:, t] @ wmid + bmid
            dx1, dhp1, dh1 = _gru_bwd_local(dh1n, x1, h1_hist[:, t], wh1, bh1)
            dh0n = dmid[:, t] * (dx1 @ wmid.T) + dh0
            x0 = emb_proj[:, t] + feed_hist[:, t] @ wfeed
            dx0, dhp0, dh0 = _gru_bwd_local(dh0n, x0, h0_hist[:, t], wh0, bh0)
            dfeed = dx0 @ wfeed.T
            outs[t] = (dx0, dhp0, dx1, dhp1, pre, dscores)
        dx0, dhp0, dx1, dhp1, pre, dscores = (torch.stack(x, dim=0) for x in zip(*outs))

        def tm(x: torch.Tensor) -> torch.Tensor:  # (B,T,..) -> (T,B,..)
            return x.transpose(0, 1)

        # every weight gradient as one product over the T*B stream
        return (dx0.transpose(0, 1), torch.zeros_like(dmid), dh0, dh1,
                torch.einsum("tbh,tbk->hk", tm(feed_hist), dx0),
                torch.einsum("tbh,tbk->hk", tm(h0_hist), dhp0), dhp0.sum((0, 1)),
                torch.einsum("tbh,tbk->hk", tm(mid_hist), dx1), dx1.sum((0, 1)),
                torch.einsum("tbh,tbk->hk", tm(h1_hist), dhp1), dhp1.sum((0, 1)),
                torch.einsum("tbs,tbh->bsh", dscores, tm(h1s)),
                torch.einsum("tbs,tbh->bsh", tm(probs), pre),
                torch.einsum("tbh,tbk->hk", tm(h1s), pre),
                torch.zeros((B, probs.shape[-1]), dtype=torch.float32, device=probs.device))


def fused_input_feed_decoder(emb_proj, dmid, h00, h01, wfeed, wh0, bh0, wmid, bmid, wh1, bh1,
                             keys, mem_v, wc_q, mask_bias, unroll: int = 1
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """emb_proj (B,T,3H) with its biases and z's input projection, dmid
    (B,T,H) dropout scales (ones when deterministic), init states (B,H),
    the decoder's weights in the compute dtype, keys and mem_v (B,S,H) the
    pre-projected memory, wc_q (H,H), mask_bias (B,S) additive f32.
    Returns (attentional hiddens (B,T,H), alignments (B,T,S)). ``unroll``
    is accepted for JAX's signature and ignored."""
    return _FusedDecoder.apply(emb_proj, dmid, h00, h01, wfeed, wh0, bh0, wmid, bmid, wh1, bh1,
                               keys, mem_v, wc_q, mask_bias)
