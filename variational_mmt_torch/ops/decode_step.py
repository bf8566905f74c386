"""Fused beam-decode step and GRU chain: the CUDA kernels' wrappers and
their plain versions.

Mirrors ``variational_mmt_tpu/ops/pallas/decode_step.py``
(``decode_step_pallas`` and ``gru_chain_pallas``, same argument order).

Source note. Replaces the Pallas kernels ``_step_kernel``
(decode_step.py:49, ``pallas_call`` at :176) and ``_chain_kernel``
(:85, ``pallas_call`` at :118) with ``csrc/decode_step.cu``. On the H100 a
step at N=1024 rows, S=24, H=500 in bf16 moves about 56 MB, mostly keys
and mem_v, and does 6.9 GFLOP: bytes bound it at about 17 us if the
products ran on the tensor cores. The chain needs every column of h0'
before GRU1 and all of h1' before attention, which a block-parallel grid
cannot give without a grid-wide sync, so one call launches a short
sequence of kernels on the stream: the GRU0 cell and the GRU1 cell (tiles
of rows x hidden units, products tiled through shared memory), then
``h1' @ Wc_q`` and one attention block per row. The simple design does
its products on the CUDA cores in f32, which bounds it by FMA throughput;
the TPU's row chunking (``_rows_per_chunk``, a VMEM budget) is not
carried over.
"""

from __future__ import annotations

from typing import Tuple

import torch

from variational_mmt_torch import kernels
from variational_mmt_torch.models.gru import gru_gates

f32 = torch.float32


def rounded_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to w's dtype, product accumulated in f32 (the Pallas
    ``jnp.dot(a.astype(cdt), w, preferred_element_type=f32)``)."""
    return a.to(w.dtype).float() @ w.float()


def _chain_f32(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1):
    """GRU0 -> GRU1 with f32 state; returns (h0n, h1n) in f32."""
    h0f, h1f = h0.float(), h1.float()
    x0 = emb_proj.float() + rounded_dot(feed.float(), Wfeed)
    h0n = gru_gates(x0, rounded_dot(h0f, Wh0) + bh0.float(), h0f)
    x1 = rounded_dot(h0n, Wmid) + bmid.float()
    h1n = gru_gates(x1, rounded_dot(h1f, Wh1) + bh1.float(), h1f)
    return h0n, h1n


def gru_chain_ref(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1):
    """Plain version of the GRU chain. Returns (h0n, h1n) in the carry dtypes."""
    h0n, h1n = _chain_f32(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1)
    return h0n.to(h0.dtype), h1n.to(h1.dtype)


def decode_step_ref(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1,
                    keys, mem_v, Wc_q, mask_bias):
    """Plain version of the fused step, as the Pallas body computes it.
    Returns (h0n, h1n, attn, probs): carries in their input dtypes, probs in
    keys.dtype."""
    cdt = Wfeed.dtype
    h0n_f, h1n_f = _chain_f32(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1)
    h0n, h1n = h0n_f.to(h0.dtype), h1n_f.to(h1.dtype)
    scores = (h1n_f[:, None, :].to(cdt) * keys).sum(-1, dtype=f32)
    scores = scores + mask_bias.float()
    scores = scores - scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores)
    probs = e / e.sum(dim=-1, keepdim=True)
    ctx = (probs[:, :, None].to(cdt) * mem_v).sum(1, dtype=f32)
    attn = torch.tanh(ctx + rounded_dot(h1n_f, Wc_q))
    return h0n, h1n, attn.to(feed.dtype), probs.to(keys.dtype)


def _chain_args(what, emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1):
    """Validate the chain inputs for the kernel; returns them contiguous,
    biases as f32."""
    N, H3 = emb_proj.shape
    H = H3 // 3
    dt = Wfeed.dtype
    if dt not in kernels.DTYPE_CODE:
        raise TypeError(f"{what} kernel: weights must be float32 or bfloat16, got {dt}")
    same = dict(emb_proj=emb_proj, h0=h0, h1=h1, feed=feed, Wfeed=Wfeed, Wh0=Wh0,
                Wmid=Wmid, Wh1=Wh1)
    for name, t in same.items():
        if t.dtype != dt:
            raise TypeError(f"{what} kernel: {name} is {t.dtype}; every tensor but "
                            f"the biases must be {dt}")
    for name, t in dict(h0=h0, h1=h1, feed=feed).items():
        if tuple(t.shape) != (N, H):
            raise ValueError(f"{what} kernel: {name} {tuple(t.shape)} != {(N, H)}")
    for name, t in dict(Wfeed=Wfeed, Wh0=Wh0, Wmid=Wmid, Wh1=Wh1).items():
        if tuple(t.shape) != (H, H3):
            raise ValueError(f"{what} kernel: {name} {tuple(t.shape)} != {(H, H3)}")
    for name, t in dict(bh0=bh0, bmid=bmid, bh1=bh1).items():
        if tuple(t.shape) != (H3,):
            raise ValueError(f"{what} kernel: {name} {tuple(t.shape)} != {(H3,)}")
    args = [t.contiguous() for t in (emb_proj, h0, h1, feed, Wfeed, Wh0)]
    args += [bh0.to(f32).contiguous(), Wmid.contiguous(), bmid.to(f32).contiguous(),
             Wh1.contiguous(), bh1.to(f32).contiguous()]
    names = ("emb_proj", "h0", "h1", "feed", "Wfeed", "Wh0", "bh0", "Wmid", "bmid",
             "Wh1", "bh1")
    kernels.require_cuda(what, emb_proj.device, **dict(zip(names, args)))
    return args, N, H, dt


def gru_chain(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused 2-layer input-feed GRU chain for one decode step (attention
    outside). Returns (h0n, h1n). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if emb_proj.device.type == "cpu":
        return gru_chain_ref(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1)
    args, N, H, dt = _chain_args("gru_chain", emb_proj, h0, h1, feed, Wfeed, Wh0, bh0,
                                 Wmid, bmid, Wh1, bh1)
    h0n = torch.empty_like(args[1])
    h1n = torch.empty_like(args[2])
    lib = kernels.library("decode_step")
    err = lib.vmmt_gru_chain(kernels.DTYPE_CODE[dt], *(a.data_ptr() for a in args),
                             h0n.data_ptr(), h1n.data_ptr(), N, H,
                             kernels.stream_of(h0n))
    kernels.check(lib, err, "gru_chain")
    gru_chain.launches += 1
    return h0n, h1n


def decode_step(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1,
                keys, mem_v, Wc_q, mask_bias):
    """One fused decode step over N rows: emb_proj (N,3H); h0, h1, feed
    (N,H); four (H,3H) weights; keys, mem_v (N,S,H); Wc_q (H,H); mask_bias
    (N,S) (0 real, -1e9 pad). Returns (h0n, h1n, attn, probs). CPU tensors
    take the plain version; CUDA tensors launch the kernels."""
    if emb_proj.device.type == "cpu":
        return decode_step_ref(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1,
                               bh1, keys, mem_v, Wc_q, mask_bias)
    args, N, H, dt = _chain_args("decode_step", emb_proj, h0, h1, feed, Wfeed, Wh0, bh0,
                                 Wmid, bmid, Wh1, bh1)
    S = keys.shape[1]
    for name, t in dict(keys=keys, mem_v=mem_v, Wc_q=Wc_q).items():
        if t.dtype != dt:
            raise TypeError(f"decode_step kernel: {name} is {t.dtype}, expected {dt}")
    if tuple(keys.shape) != (N, S, H) or tuple(mem_v.shape) != (N, S, H) \
            or tuple(Wc_q.shape) != (H, H) or tuple(mask_bias.shape) != (N, S):
        raise ValueError("decode_step kernel: keys/mem_v (N,S,H), Wc_q (H,H) and "
                         "mask_bias (N,S) do not match")
    extra = [keys.contiguous(), mem_v.contiguous(), Wc_q.contiguous(),
             mask_bias.to(f32).contiguous()]
    kernels.require_cuda("decode_step", emb_proj.device, keys=extra[0], mem_v=extra[1],
                         Wc_q=extra[2], mask_bias=extra[3])
    h0n = torch.empty_like(args[1])
    h1n = torch.empty_like(args[2])
    attn = torch.empty_like(args[3])
    probs = torch.empty((N, S), dtype=dt, device=h0n.device)
    qw = torch.empty((N, H), dtype=f32, device=h0n.device)
    lib = kernels.library("decode_step")
    err = lib.vmmt_decode_step(kernels.DTYPE_CODE[dt], *(a.data_ptr() for a in args + extra),
                               h0n.data_ptr(), h1n.data_ptr(), attn.data_ptr(),
                               probs.data_ptr(), qw.data_ptr(), N, S, H,
                               kernels.stream_of(h0n))
    kernels.check(lib, err, "decode_step")
    decode_step.launches += 1
    return h0n, h1n, attn, probs


gru_chain.launches = 0
decode_step.launches = 0
