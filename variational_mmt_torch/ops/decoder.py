"""Fused input-feed decoder over a whole teacher-forced sequence, forward
and backward: the CUDA kernels' wrappers, their plain versions and the
differentiable ``fused_decoder_pallas``.

Mirrors ``variational_mmt_tpu/ops/pallas/decoder.py`` (``decoder_fwd_pallas``,
``decoder_bwd_pallas`` and the custom VJP ``fused_decoder_pallas``, same
argument order, batch-major streams).

Source note. Replaces the Pallas kernels ``_dec_fwd_kernel``
(decoder.py:61, ``pallas_call`` at :153) and ``_dec_bwd_kernel`` (:194,
``pallas_call`` at :304) with ``csrc/decoder.cu``. On the TPU each grid
step ran a whole decoder step with the five weight blocks resident in VMEM.
On the H100 a step needs every column of h0' before GRU1, all of h1' before
attention and all of the new feed before the next step. At the flagship's
B=64, T=25, S=24, H=500 a step's work is a few MFLOP and its bytes and
FLOPs bound each pass at about 10-20 us; the serial chain bounds it.

Each pass is one persistent cooperative kernel that walks time in four
phases a step separated by grid barriers. Each CTA owns a few hidden units
of a tile of batch rows and keeps the units' slices of the five weights in
shared memory for the whole call, in place of re-reading the weights from
L2 at every step; the products (mma.sync in bf16 and f16) read the other CTAs'
rounded results from L2, which bounds the phases.
:func:`decoder_fwd_plan` and :func:`decoder_bwd_plan` size the grid to the
card's SMs and the shared memory and refuse what one launch cannot hold
(row chunks and the streamed plan below take the rest); the wrappers check
with the card that each grid is co-resident.

Forward, one launch: GRU0 after ``round(feed) @ Wfeed``; GRU1 after
``round(dmid * h0') @ Wmid``; the attention (a CTA a batch row); ``tanh``
into the next feed. The last two phases arrive at their barrier once what
the other CTAs read is written and, while it completes, run the products
that only their CTA reads: ``hp1`` of the next step with ``h1' @ Wc_q``,
then ``hp0`` of the next step.

Backward, two launches (a chain of small kernels would take 8 a step and 5
weight transposes, 205 at T=25). The cells' four gate products read only
saved forward streams, so one tiled product (tensor cores in bf16 and f16)
computes them for every (row, t) first. Then the persistent kernel walks
time in reverse (attention backward; GRU1's cell backward; GRU0's; the
products into dh0 and dfeed); two of its CTAs fit an SM at the flagship's
width.

Both kernels take an optional ``probe``: an int64 tensor of
:func:`probe_len` ``(T)`` entries into which CTA 0 writes ``%globaltimer``
(ns) at its start, after the prologue and as it arrives at and leaves each
grid barrier (``tools/phase_times.py``).

The state (h0, h1, feed and, backward, dh0, dh1, dfeed) stays f32 across
time; only the saved streams are rounded to the compute dtype. The weight
gradients are products over the (T*B)-long streams outside the kernels, as
``_pal_bwd`` computes them outside Pallas (decoder.py:398-416).

Batches. A resident CTA's shared memory grows with its batch rows, so a
batch the plan cannot hold in one launch runs in row chunks, one launch
each, as JAX's wrappers split a batch above ``_fwd_rows`` / ``_bwd_rows``
(decoder.py:111-117, :259-266): :func:`decoder_row_chunks` cuts the
largest multiple of 16 rows whose plan holds (shared memory within a CTA's,
the grid within the card's co-resident CTAs by
:func:`co_resident_estimate`). Each row's outputs, local cotangents, dh00
and dh01 depend on that row alone, so the chunks write their rows of the
outputs; the weight gradients sum over the whole batch afterwards. The
chunks reuse the scratch in stream order (each launch zeroes its barrier
counter and carries in its prologue).

The streamed plan (the kernels' ``kStream`` variants). The resident plan
keeps each CTA's slices of the five weights in shared memory and a
co-resident CTA for every tile: bf16's forward holds no chunk of 16 rows
from H = 932 (its slices outgrow a CTA), the backward from 1060, and f32's
grid outgrows a 132-SM card from H = 532 (the backward from 536). JAX
keeps the weights whole in VMEM and takes any width. Where no chunk of 16
rows holds the resident plan,
:func:`decoder_stream_plan` runs the same phases on a grid capped at two
CTAs an SM: each CTA takes its (unit tile, row tile) pairs in turn within
every phase, reads each tile's weight slices from global memory, laid out
once a call by :func:`_stream_weights` in the slices' own order (through
L2; from HBM every step where the five weights, 13 H^2 values, exceed the
50 MB L2: bf16 above about 1387 units, f32 above about 980), and keeps the
f32 carries in global memory, each read and written only by the thread
that owns its cell. A tile's rows are capped at ``DEC_STREAM_MAX_ROWS``,
so a streamed CTA's shared memory is its product buffer and attention row
whatever B, and all row tiles run in one launch. :func:`decoder_launches`
makes the choice for both wrappers; a shape that no plan holds raises
NotImplementedError, and nothing falls back to the plain versions.

Widths. The attention reads keys and mem_v 4 values at a time, so the
kernels compute a width that is a multiple of 4; both wrappers take any H
and zero-pad it up to ``padded_width`` (weights, biases, states, dmid,
keys, mem_v and, backward, the saved streams and d_attn), then slice the
outputs back: exact, as ops/decode_step.py sets out (a padded unit stays 0
and so does its cotangent).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch

from variational_mmt_torch import kernels
from variational_mmt_torch.models.gru import gru_bwd_core, gru_gates
from variational_mmt_torch.ops.decode_step import (pad_step_weights, pad_units, padded_width,
                                                   rounded_dot, unpad_units)

f32 = torch.float32


def decoder_fwd_ref(emb_proj, dmid, h00, h01, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1,
                    keys, mem_v, Wc_q, mask_bias):
    """Plain version of the forward kernel: the step of
    ``models/fused_decoder.py:_fwd_scan`` under the Pallas kernel's
    precision contract (f32 state across time; product operands rounded to
    the weights' dtype with f32 accumulation; each attention product rounded
    before its f32 sum). Returns (attn_hs, h0s, h1s (B,T,H), probs (B,T,S))
    in keys.dtype."""
    cdt = keys.dtype
    B, T, _ = emb_proj.shape
    h0, h1 = h00.float(), h01.float()
    feed = torch.zeros_like(h0)
    outs = [[], [], [], []]
    for t in range(T):
        x0 = emb_proj[:, t].float() + rounded_dot(feed, Wfeed)
        h0 = gru_gates(x0, rounded_dot(h0, Wh0) + bh0.float(), h0)
        x1 = rounded_dot(dmid[:, t].float() * h0, Wmid) + bmid.float()
        h1 = gru_gates(x1, rounded_dot(h1, Wh1) + bh1.float(), h1)
        scores = (h1[:, None, :].to(cdt) * keys).sum(-1, dtype=f32) + mask_bias.float()
        scores = scores - scores.amax(dim=-1, keepdim=True)
        e = torch.exp(scores)
        probs = e / e.sum(dim=-1, keepdim=True)
        ctx = (probs[:, :, None].to(cdt) * mem_v).sum(1, dtype=f32)
        feed = torch.tanh(ctx + rounded_dot(h1, Wc_q))
        for acc, v in zip(outs, (feed, h0, h1, probs)):
            acc.append(v.to(cdt))
    return tuple(torch.stack(acc, dim=1) for acc in outs)


def rounded_dot_t(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w^T`` with ``a`` rounded to w's dtype, f32 accumulation."""
    return a.to(w.dtype).float() @ w.float().t()


def decoder_bwd_ref(emb_proj, dmid, h00, h01, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1,
                    keys, mem_v, Wc_q, attn_hs, h0s, h1s, probs, d_attn, d_probs):
    """Plain version of the backward kernel: the reverse scan of
    ``models/fused_decoder.py:_fused_bwd`` with the Pallas kernel's
    precision contract (f32 carries; operands rounded to the weights' dtype
    before each product). Returns (dx0, dhp0, dx1, dhp1 (B,T,3H), pre
    (B,T,H), dscores (B,T,S), dh00, dh01 (B,H)), all f32."""
    cdt = Wfeed.dtype
    B, T, H = attn_hs.shape
    dh0 = torch.zeros((B, H), dtype=f32, device=emb_proj.device)
    dh1, dfeed = torch.zeros_like(dh0), torch.zeros_like(dh0)
    outs = [[None] * T for _ in range(6)]
    for t in range(T - 1, -1, -1):
        attn = attn_hs[:, t].float()
        pre = (1.0 - attn * attn) * (d_attn[:, t].float() + dfeed)
        dq = rounded_dot_t(pre, Wc_q)
        dprobs = (pre[:, None, :].to(cdt) * mem_v).sum(-1, dtype=f32) + d_probs[:, t].float()
        prf = probs[:, t].float()
        dscores = prf * (dprobs - (dprobs * prf).sum(-1, keepdim=True))
        dh1n = dq + (dscores[:, :, None].to(cdt) * keys).sum(1, dtype=f32) + dh1
        dm = dmid[:, t].float()
        x1 = rounded_dot(dm * h0s[:, t].float(), Wmid) + bmid.float()
        h1prev = h01.float() if t == 0 else h1s[:, t - 1].float()
        dx1, dhp1, dh1p = gru_bwd_core(dh1n, x1, rounded_dot(h1prev, Wh1) + bh1.float(), h1prev)
        dh1 = dh1p + rounded_dot_t(dhp1, Wh1)
        dh0n = dm * rounded_dot_t(dx1, Wmid) + dh0
        fprev = torch.zeros_like(attn) if t == 0 else attn_hs[:, t - 1].float()
        x0 = emb_proj[:, t].float() + rounded_dot(fprev, Wfeed)
        h0prev = h00.float() if t == 0 else h0s[:, t - 1].float()
        dx0, dhp0, dh0p = gru_bwd_core(dh0n, x0, rounded_dot(h0prev, Wh0) + bh0.float(), h0prev)
        dh0 = dh0p + rounded_dot_t(dhp0, Wh0)
        dfeed = rounded_dot_t(dx0, Wfeed)
        for acc, v in zip(outs, (dx0, dhp0, dx1, dhp1, pre, dscores)):
            acc[t] = v
    return tuple(torch.stack(acc, dim=1) for acc in outs) + (dh0, dh1)


_NAMES = ("emb_proj", "dmid", "h00", "h01", "Wfeed", "Wh0", "bh0", "Wmid", "bmid", "Wh1",
          "bh1", "keys", "mem_v", "Wc_q")
_F32 = ("h00", "h01", "bh0", "bmid", "bh1")  # passed to the kernels as f32


def _pad_args(args) -> Tuple[tuple, int, int]:
    """The 14 inputs shared by both kernels at the kernels' width: (args,
    H, padded H)."""
    (emb_proj, dmid, h00, h01, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1,
     keys, mem_v, Wc_q) = args
    H = h00.shape[-1]
    Hp = padded_width(H)
    if Hp == H:
        return tuple(args), H, Hp
    w = pad_step_weights(Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1, Wc_q)
    return ((pad_units(emb_proj, H, Hp, -1, 3), pad_units(dmid, H, Hp), pad_units(h00, H, Hp),
             pad_units(h01, H, Hp), *w[:7], pad_units(keys, H, Hp), pad_units(mem_v, H, Hp),
             w[7]), H, Hp)


def _kernel_args(what, args):
    """Validate the 14 inputs shared by both kernels; returns them
    contiguous (state and biases as f32) and (B, T, S, H, dtype)."""
    named = dict(zip(_NAMES, args))
    B, T, H3 = named["emb_proj"].shape
    H = H3 // 3
    S = named["keys"].shape[1]
    dt = named["Wfeed"].dtype
    kernels.dtype_code(what, dt)
    shapes = dict(emb_proj=(B, T, H3), dmid=(B, T, H), h00=(B, H), h01=(B, H), Wfeed=(H, H3),
                  Wh0=(H, H3), bh0=(H3,), Wmid=(H, H3), bmid=(H3,), Wh1=(H, H3), bh1=(H3,),
                  keys=(B, S, H), mem_v=(B, S, H), Wc_q=(H, H))
    out = []
    for name in _NAMES:
        t = named[name]
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{what} kernel: {name} {tuple(t.shape)} != {shapes[name]}")
        if name in _F32:
            t = t.to(f32)
        elif t.dtype != dt:
            raise TypeError(f"{what} kernel: {name} is {t.dtype}; every tensor but the "
                            f"states and biases must be {dt}")
        out.append(t.contiguous())
    kernels.require_cuda(what, out[0].device, **dict(zip(_NAMES[1:], out[1:])))
    return out, (B, T, S, H, dt)


def decoder_fwd(emb_proj, dmid, h00, h01, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1,
                keys, mem_v, Wc_q, mask_bias, probe=None):
    """Forward over the sequence: emb_proj (B,T,3H) with the biases folded
    in, dmid (B,T,H) dropout scales, h00, h01 (B,H), four (H,3H) weights and
    their biases, keys and mem_v (B,S,H), Wc_q (H,H), mask_bias (B,S) (0
    real, -1e9 pad). Returns (attn_hs, h0s, h1s (B,T,H), probs (B,T,S)) in
    the compute dtype. CPU tensors take the plain version; CUDA tensors
    launch the kernel at the padded width, once, or once a row chunk
    (:func:`decoder_launches`; the call's plan, with the card's SMs and its
    count of co-resident CTAs, is kept in ``decoder_fwd.plan``, and
    ``launches`` counts every launch). ``probe``: an optional int64 tensor
    for the phase stamps (of the last launch, where there are chunks)."""
    args = (emb_proj, dmid, h00, h01, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1, keys, mem_v, Wc_q)
    if emb_proj.device.type == "cpu":
        return decoder_fwd_ref(*args, mask_bias)
    args, H0, _ = _pad_args(args)
    ins, (B, T, S, H, dt) = _kernel_args("decoder_fwd", args)
    if tuple(mask_bias.shape) != (B, S):
        raise ValueError(f"decoder_fwd kernel: mask_bias {tuple(mask_bias.shape)} != {(B, S)}")
    mb = mask_bias.to(f32).contiguous()
    dev = ins[0].device
    kernels.require_cuda("decoder_fwd", dev, mask_bias=mb)
    probe_ptr = _probe_ptr("decoder_fwd", probe, T, dev)
    lib = kernels.library("decoder")
    code = kernels.DTYPE_CODE[dt]
    launches = _checked_launches("decoder_fwd", B, S, H, dt, dev)
    decoder_fwd.plan = plan = _call_plan(launches)
    streamed = plan["layout"] == "streamed"
    outs = [torch.empty((B, T, H), dtype=dt, device=dev) for _ in range(3)]
    outs.append(torch.empty((B, T, S), dtype=dt, device=dev))
    rows = max(b1 - b0 for b0, b1, _ in launches)
    # a launch's rounded h0' (two steps), h1', dmid * h0' and attn that the
    # CTAs exchange, rows padded to 32; the attention context, the streamed
    # plan's carries and a grid barrier's counter; the chunks reuse them in
    # stream order
    tscratch = torch.empty((5, rows, kernels.pad32(H)), dtype=dt, device=dev)
    fscratch = torch.empty((rows * H * (10 if streamed else 1) + 1,), dtype=f32, device=dev)
    wt = _stream_weights("decoder_fwd", *(ins[i] for i in (4, 5, 7, 9, 13)), plan) \
        if streamed else None

    def launch(p, part, out):
        part[11], part[12] = kernels.aligned(part[11]), kernels.aligned(part[12])
        err = lib.vmmt_decoder_fwd(code, *(a.data_ptr() for a in part),
                                   *(o.data_ptr() for o in out), tscratch.data_ptr(),
                                   fscratch.data_ptr(), None if wt is None else wt.data_ptr(),
                                   probe_ptr, part[0].shape[0], T, S, H, p["units"], p["rows"],
                                   p["grid"], kernels.stream_of(ins[0]))
        kernels.check(lib, err, "decoder_fwd")
        decoder_fwd.launches += 1

    in_row_chunks(launch, launches, ins + [mb], FWD_BATCHED, outs)
    return tuple(unpad_units(o, H0, H) for o in outs[:3]) + (outs[3],)


# the arguments with a batch dimension: the forward's emb_proj, dmid, h00,
# h01, keys, mem_v and mask_bias; the backward's also its streams and
# cotangents
FWD_BATCHED = (0, 1, 2, 3, 11, 12, 14)
BWD_BATCHED = (0, 1, 2, 3, 11, 12, 14, 15, 16, 17, 18, 19)


def in_row_chunks(launch, launches, args, batched, outs) -> None:
    """The chunk loop of both wrappers: for each (first row, end row, plan)
    of ``launches``, ``launch(plan, args of the chunk, outs of the chunk)``
    with those rows of the arguments whose index is in ``batched`` (the
    others whole) and of every output, which the launch writes: the
    chunks' outputs join along B, as JAX's wrappers concatenate theirs."""
    for b0, b1, plan in launches:
        launch(plan, [a[b0:b1] if i in batched else a for i, a in enumerate(args)],
               [o[b0:b1] for o in outs])


# hidden units per CTA, both passes (tile_rows of csrc/block_product.cuh)
DEC_UNITS = {torch.bfloat16: 8, torch.float16: 8, torch.float32: 4}
DEC_WARPS = 8  # warps of a CTA (kDecWarps of csrc/decoder.cu)
DEC_PHASES = 4  # grid-barrier phases of a step (kDecPhases)
DEC_STREAM_MAX_ROWS = 128  # batch rows of a streamed tile; more rows make more row tiles
DEC_STREAM_PER_SM = 2  # most CTAs an SM of the streamed kernels (kDecStreamPerSm)


def probe_len(T: int) -> int:
    """Entries of a phase probe for a call of T steps: the start, the end
    of the prologue, and two stamps a phase."""
    return 2 + 2 * DEC_PHASES * T


def _tiling(what: str, B: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    """CTA tiling of both persistent kernels: ``unit_tiles * row_tiles``
    CTAs each own ``units`` hidden units of ``rows`` batch rows (row tiles
    halve what each CTA reads of the other CTAs' results, as long as the
    tiles stay within a CTA an SM); the grid also has a CTA for each batch
    row up to one an SM, for the attention phase."""
    kernels.dtype_code(what, dtype)
    if B < 1 or H < 1:
        raise NotImplementedError(f"{what} kernel: B={B}, H={H}")
    units = DEC_UNITS[dtype]
    unit_tiles = -(-H // units)
    row_tiles = max(1, min(-(-B // 16), sms // unit_tiles))
    rows = kernels.align16(-(-B // row_tiles))
    row_tiles = -(-B // rows)
    grid = max(unit_tiles * row_tiles, min(B, sms))
    return dict(layout="resident", units=units, rows=rows, unit_tiles=unit_tiles,
                row_tiles=row_tiles, grid=grid)


def _checked_smem(what: str, smem: int, B: int, S: int, H: int) -> int:
    if smem > kernels.SMEM_PER_BLOCK:
        raise NotImplementedError(f"{what} kernel: {smem} bytes of shared memory per CTA "
                                  f"exceed {kernels.SMEM_PER_BLOCK} (B={B}, S={S}, H={H})")
    return smem


def _fwd_smem(rows: int, S: int, H: int, dtype: torch.dtype, streamed: bool = False) -> int:
    """Shared memory of a forward CTA of ``rows`` batch rows at the padded
    width H (``DecFwdLayout`` of csrc/decoder.cu): the product buffer (4
    n-tiles of 8 floats a row, with room for 8 warps' K-split partial sums
    of 16 rows in 16 bits) and the attention row (3H + S floats); resident,
    also the units' gate columns of Wfeed, Wh0, Wmid and Wh1 (three n-tiles
    of 8 columns in bf16 and f16, 4 in f32) and columns of Wc_q (one
    n-tile), each a (columns, K) slice at the padded stride, the f32
    carries h0, h1, qw (rows, units) and the hidden products hp0, hp1
    (rows, units, 3)."""
    mma = kernels.mma_dtype(dtype)
    a16 = kernels.align16
    prod_rows = max(DEC_WARPS * 16, rows) if mma else rows
    smem = prod_rows * 4 * 8 * 4 + a16((3 * H + S) * 4)
    if streamed:
        return smem
    tsize, units, tile = dtype.itemsize, DEC_UNITS[dtype], 8 if mma else 4
    ldw = kernels.frag_ld(H, mma)
    return (smem + 4 * a16(3 * tile * ldw * tsize) + a16(tile * ldw * tsize)
            + 3 * a16(rows * units * 4) + 2 * a16(rows * units * 3 * 4))


def _bwd_smem(rows: int, S: int, H: int, dtype: torch.dtype, streamed: bool = False) -> int:
    """Shared memory of a backward CTA (``DecLayout`` of csrc/decoder.cu):
    the product buffer and the attention row (H + 2S floats); resident, also
    the units' rows of Wc_q, Wh1, Wmid, Wh0 and Wfeed (rows padded to 32,
    16-bit ones to an odd multiple of 64 bytes for conflict-free 16-byte
    reads) and two (rows, units) f32 carries."""
    mma = kernels.mma_dtype(dtype)
    prod_rows = max(DEC_WARPS * 16, rows) if mma else rows
    smem = prod_rows * 8 * 4 + kernels.align16((H + 2 * S) * 4)
    if streamed:
        return smem
    tsize, units = dtype.itemsize, DEC_UNITS[dtype]
    wrows = 8 if mma else units
    return (smem + kernels.align16(wrows * kernels.frag_ld(H, mma) * tsize)
            + 4 * kernels.align16(wrows * kernels.frag_ld(3 * H, mma) * tsize)
            + 2 * kernels.align16(rows * units * 4))


def _resident(what: str, B: int, S: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    """The resident plan of one launch of B rows at the padded width, its
    shared memory not yet checked."""
    H = padded_width(H)
    plan = _tiling(what, B, H, dtype, sms)
    return dict(plan, padded=H, smem=_SMEM[what](plan["rows"], S, H, dtype), chunks=1)


def decoder_fwd_plan(B: int, S: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    """Resident launch plan of the forward's persistent kernel for one
    launch of B rows on a card of ``sms`` SMs: the tiling of :func:`_tiling`
    and ``smem`` bytes of dynamic shared memory per CTA (:func:`_fwd_smem`,
    mirrors ``DecFwdLayout`` of csrc/decoder.cu). At the flagship's width a
    bf16 or f16 CTA takes about 141 KB, one an SM. Planned at the padded
    width ``padded`` (the wrapper pads H to a multiple of 4). Raises
    NotImplementedError for what the design cannot hold."""
    plan = _resident("decoder_fwd", B, S, H, dtype, sms)
    _checked_smem("decoder_fwd", plan["smem"], B, S, H)
    return plan


def decoder_bwd_plan(B: int, S: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    """Resident launch plan of the backward's persistent kernel for one
    launch of B rows on a card of ``sms`` SMs: the tiling of :func:`_tiling`
    and ``smem`` bytes of dynamic shared memory per CTA (:func:`_bwd_smem`,
    mirrors ``DecLayout`` of csrc/decoder.cu). Planned at the padded width
    ``padded``, as the forward. Raises NotImplementedError for what the
    design cannot hold."""
    plan = _resident("decoder_bwd", B, S, H, dtype, sms)
    _checked_smem("decoder_bwd", plan["smem"], B, S, H)
    return plan


_SMEM = {"decoder_fwd": _fwd_smem, "decoder_bwd": _bwd_smem}


def co_resident_estimate(smem: int, sms: int) -> int:
    """CTAs of ``smem`` bytes of dynamic shared memory that a card of
    ``sms`` SMs holds at once by its shared memory (1 KB reserved a CTA);
    the wrappers check each grid with the card itself."""
    return sms * (kernels.SMEM_PER_SM // (smem + 1024))


def _resident_plan(what: str, B: int, S: int, H: int, dtype: torch.dtype,
                   sms: int) -> Optional[dict]:
    """The resident plan of one launch of B rows where it holds (shared
    memory within a CTA's, grid within :func:`co_resident_estimate`), else
    None."""
    if B < 1 or H < 1:
        return None
    plan = _resident(what, B, S, H, dtype, sms)
    holds = plan["smem"] <= kernels.SMEM_PER_BLOCK \
        and plan["grid"] <= co_resident_estimate(plan["smem"], sms)
    return plan if holds else None


def _resident_rows(what: str, B: int, S: int, H: int, dtype: torch.dtype,
                   sms: int) -> Optional[int]:
    """Rows of one resident launch: B where the plan holds the batch, else
    the largest multiple of 16 below B that it holds (a plan of fewer rows
    takes no more shared memory and no larger grid), else None."""
    if _resident_plan(what, B, S, H, dtype, sms) is not None:
        return B
    lo, hi = 0, (B - 1) // 16  # 16 lo rows hold (none at 0); 16 (hi + 1) do not, or reach B
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if _resident_plan(what, 16 * mid, S, H, dtype, sms) is not None:
            lo = mid
        else:
            hi = mid - 1
    return 16 * lo or None


def decoder_row_chunks(what: str, B: int, S: int, H: int, dtype: torch.dtype,
                       sms: int) -> List[slice]:
    """The batch slices of ``what`` (``"decoder_fwd"`` or ``"decoder_bwd"``)
    whose resident plans each hold one launch, in order: the whole batch
    where it holds, else chunks of the largest multiple of 16 rows that
    holds and the rest, as ``decoder_fwd_pallas`` and ``decoder_bwd_pallas``
    slice a batch above ``_fwd_rows`` / ``_bwd_rows`` (``_slices``,
    ops/pallas/decoder.py:187). Raises NotImplementedError where no chunk of
    16 rows holds."""
    rows = _resident_rows(what, B, S, H, dtype, sms)
    if rows is None:
        raise NotImplementedError(f"{what} kernel: the resident plan holds no chunk of 16 rows "
                                  f"(B={B}, S={S}, H={H})")
    return [slice(b, min(b + rows, B)) for b in range(0, B, rows)]


def decoder_stream_plan(what: str, B: int, S: int, H: int, dtype: torch.dtype,
                        sms: int) -> dict:
    """Streamed launch plan of ``what`` for B rows on a card of ``sms``
    SMs: ``unit_tiles`` of ``units`` units (8 in bf16 and f16, 4 in f32)
    times ``row_tiles`` of ``rows`` batch rows (a multiple of 16, at most
    ``DEC_STREAM_MAX_ROWS``), all in one launch (``chunks`` 1) of ``grid``
    CTAs: as many as there are tiles or batch rows, at most
    ``DEC_STREAM_PER_SM`` an SM; each CTA takes ``tiles_per_cta`` tiles at
    most a phase. Shared memory: the product buffer and the attention row
    (:func:`_fwd_smem`, :func:`_bwd_smem`), whatever B; the weights stay in
    global memory (:func:`_stream_weights`). Raises NotImplementedError for
    what it cannot hold."""
    kernels.dtype_code(what, dtype)
    H = padded_width(H)
    if B < 1 or H < 1:
        raise NotImplementedError(f"{what} kernel: B={B}, H={H}")
    units = DEC_UNITS[dtype]
    unit_tiles = -(-H // units)
    row_tiles = -(-B // DEC_STREAM_MAX_ROWS)
    rows = kernels.align16(-(-B // row_tiles))
    smem = _checked_smem(what, _SMEM[what](rows, S, H, dtype, streamed=True), B, S, H)
    tiles = unit_tiles * row_tiles
    per_sm = min(DEC_STREAM_PER_SM, kernels.SMEM_PER_SM // (smem + 1024))
    grid = min(max(tiles, B), per_sm * sms)
    return dict(layout="streamed", units=units, rows=rows, unit_tiles=unit_tiles,
                row_tiles=row_tiles, grid=grid, padded=H, smem=smem, chunks=1, tiles=tiles,
                tiles_per_cta=-(-tiles // grid))


@functools.lru_cache(maxsize=None)
def decoder_launches(what: str, B: int, S: int, H: int, dtype: torch.dtype,
                     sms: int) -> Tuple[Tuple[int, int, dict], ...]:
    """The launches of one call of ``what`` on B rows, each (first row, end
    row, launch plan), the one choice both wrappers make: the resident plan
    where it holds, in row chunks (:func:`decoder_row_chunks`) where it
    holds only fewer rows than B; else the streamed plan
    (:func:`decoder_stream_plan`) in one launch; else NotImplementedError.
    The wrappers check each plan with the card; nothing falls back to the
    plain versions."""
    rows = _resident_rows(what, B, S, H, dtype, sms)
    if rows is None:
        return ((0, B, decoder_stream_plan(what, B, S, H, dtype, sms)),)
    return tuple((s.start, s.stop, _resident(what, s.stop - s.start, S, H, dtype, sms))
                 for s in decoder_row_chunks(what, B, S, H, dtype, sms))


def _co_resident_plan(what: str, plan: dict, code: int, S: int, H: int, device: int) -> dict:
    """``plan`` checked against the card's count of co-resident CTAs of its
    kernel (resident or streamed) and the kernel's own shared-memory count,
    with the card's SMs and that count."""
    fn = f"vmmt_{what}_{'stream_' if plan['layout'] == 'streamed' else ''}occupancy"
    co_resident, smem = kernels.occupancy(device, "decoder", fn, code, plan["rows"], S, H,
                                          plan["units"])
    if plan["grid"] > co_resident:
        raise NotImplementedError(f"{what} kernel: {plan['grid']} CTAs of the {plan['layout']} "
                                  f"plan with {smem} bytes of shared memory each exceed the "
                                  f"{co_resident} the card holds at once")
    if smem != plan["smem"]:
        raise RuntimeError(f"{what} kernel: plan of {plan['smem']} bytes of shared memory, "
                           f"the kernel takes {smem}")
    return dict(plan, sms=kernels.sm_count(device), max_co_resident=co_resident)


def _checked_launches(what: str, B: int, S: int, H: int, dtype: torch.dtype,
                      device: torch.device) -> list:
    """:func:`decoder_launches` on ``device``'s card, each plan checked
    with it (:func:`_co_resident_plan`)."""
    code = kernels.DTYPE_CODE[dtype]
    launches = decoder_launches(what, B, S, H, dtype, kernels.sm_count(device.index))
    return [(b0, b1, _co_resident_plan(what, plan, code, S, H, device.index))
            for b0, b1, plan in launches]


def _call_plan(launches: list) -> dict:
    """What a wrapper keeps of a call's launches: the plan of its one
    launch, or the first launch's plan with the chunk count and every
    launch's plan."""
    plans = [plan for _, _, plan in launches]
    return plans[0] if len(plans) == 1 else dict(plans[0], chunks=len(plans), launch_plans=plans)


def _stream_weights(what: str, Wfeed, Wh0, Wmid, Wh1, Wc_q, plan: dict) -> torch.Tensor:
    """The five weights laid out once a call for the streamed kernels (``wt``
    of ``DecFwd`` and ``DecBwd``): for each unit tile, the slices a resident
    CTA keeps in shared memory, in their order and at their strides, zero
    past H and past the tile's units. Forward: (unit_tiles, 13, units,
    frag_ld(H)), whose [tile, 3 w + g, u, k] is W_w[k, g H + tile units + u]
    for W_w = Wfeed, Wh0, Wmid, Wh1 (w = 0..3, gate g) and [tile, 12, u, k]
    Wc_q[k, tile units + u]. Backward: (unit_tiles, units (frag_ld(H) + 4
    frag_ld(3H))): a tile's rows u of Wc_q (frag_ld(H) wide), then of Wh1,
    Wmid, Wh0 and Wfeed (frag_ld(3H) wide), row tile units + u of each."""
    H = Wfeed.shape[0]
    units, ut = plan["units"], plan["unit_tiles"]
    mma = kernels.mma_dtype(Wfeed.dtype)
    if what == "decoder_bwd":
        def rows(W, K):
            out = W.new_zeros((ut * units, kernels.frag_ld(K, mma)))
            out[:H, :K] = W
            return out.view(ut, -1)

        return torch.cat([rows(Wc_q, H)] + [rows(W, 3 * H) for W in (Wh1, Wmid, Wh0, Wfeed)],
                         dim=1)

    def cols(W, gates):
        out = W.new_zeros((gates, ut * units, kernels.frag_ld(H, mma)))
        out[:, :H, :H] = W.view(H, gates, H).permute(1, 2, 0)  # [g, u, k] = W[k, g H + u]
        return out.view(gates, ut, units, -1).transpose(0, 1)

    return torch.cat([cols(W, 3) for W in (Wfeed, Wh0, Wmid, Wh1)] + [cols(Wc_q, 1)],
                     dim=1).contiguous()


def _probe_ptr(what: str, probe, T: int, device) -> int:
    """The data pointer of a phase probe (0: none)."""
    if probe is None:
        return 0
    if probe.dtype != torch.int64 or probe.numel() < probe_len(T) or probe.device != device \
            or not probe.is_contiguous():
        raise ValueError(f"{what}: probe must be a contiguous int64 tensor of at least "
                         f"{probe_len(T)} entries on {device}")
    return probe.data_ptr()


def decoder_bwd(emb_proj, dmid, h00, h01, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1,
                keys, mem_v, Wc_q, attn_hs, h0s, h1s, probs, d_attn, d_probs, probe=None):
    """Reverse-time backward over the sequence: the forward's inputs (but
    mask_bias), its four streams and the cotangents d_attn (B,T,H) and
    d_probs (B,T,S). Returns (dx0, dhp0, dx1, dhp1, pre, dscores, dh00,
    dh01) in f32. CPU tensors take the plain version; CUDA tensors launch
    the kernels at the padded width, once or once a row chunk, as the
    forward (the call's plan is kept in ``decoder_bwd.plan``); each row's
    outputs depend on that row alone, so the chunks' join by row.
    ``probe``: an optional int64 tensor for the phase stamps."""
    args = (emb_proj, dmid, h00, h01, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1, keys, mem_v, Wc_q)
    if emb_proj.device.type == "cpu":
        return decoder_bwd_ref(*args, attn_hs, h0s, h1s, probs, d_attn, d_probs)
    args, H0, Hp = _pad_args(args)
    attn_hs, h0s, h1s, d_attn = (pad_units(t, H0, Hp) for t in (attn_hs, h0s, h1s, d_attn))
    ins, (B, T, S, H, dt) = _kernel_args("decoder_bwd", args)
    streams = dict(attn_hs=(attn_hs, (B, T, H), dt), h0s=(h0s, (B, T, H), dt),
                   h1s=(h1s, (B, T, H), dt), probs=(probs, (B, T, S), dt),
                   d_attn=(d_attn, (B, T, H), f32), d_probs=(d_probs, (B, T, S), f32))
    extra = []
    for name, (t, shape, want) in streams.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"decoder_bwd kernel: {name} {tuple(t.shape)} != {shape}")
        if want == dt and t.dtype != dt:
            raise TypeError(f"decoder_bwd kernel: {name} is {t.dtype}, expected {dt}")
        extra.append(t.to(want).contiguous())
    kernels.require_cuda("decoder_bwd", ins[0].device, **dict(zip(streams, extra)))
    probe_ptr = _probe_ptr("decoder_bwd", probe, T, ins[0].device)
    lib = kernels.library("decoder")
    dev = ins[0].device
    code = kernels.DTYPE_CODE[dt]
    launches = _checked_launches("decoder_bwd", B, S, H, dt, dev)
    decoder_bwd.plan = plan = _call_plan(launches)
    streamed = plan["layout"] == "streamed"
    outs = [torch.empty((B, T, 3 * H), dtype=f32, device=dev) for _ in range(4)]
    outs += [torch.empty((B, T, H), dtype=f32, device=dev),
             torch.empty((B, T, S), dtype=f32, device=dev),
             torch.empty((B, H), dtype=f32, device=dev),
             torch.empty((B, H), dtype=f32, device=dev)]
    rows = max(b1 - b0 for b0, b1, _ in launches)  # the chunks reuse the scratch in turn
    gates = torch.empty((4, rows, T, 3 * H), dtype=f32, device=dev)  # hoisted gate products
    # dfeed, the attention part of dh1' and, streamed, the carries dh1' z1, dh0' z0
    fscratch = torch.empty((4 if streamed else 2, rows, H), dtype=f32, device=dev)
    # pre and the four local gradients of a step, rounded, rows padded to 32
    tscratch = torch.empty((rows * (kernels.pad32(H) + 4 * kernels.pad32(3 * H)),), dtype=dt,
                           device=dev)
    wt = _stream_weights("decoder_bwd", *(ins[i] for i in (4, 5, 7, 9, 13)), plan) \
        if streamed else None

    def launch(p, part, out):
        err = lib.vmmt_decoder_bwd(code, *(a.data_ptr() for a in part),
                                   *(o.data_ptr() for o in out), gates.data_ptr(),
                                   fscratch.data_ptr(), tscratch.data_ptr(),
                                   None if wt is None else wt.data_ptr(), probe_ptr,
                                   part[0].shape[0], T, S, H, p["units"], p["rows"], p["grid"],
                                   kernels.stream_of(ins[0]))
        kernels.check(lib, err, "decoder_bwd")
        decoder_bwd.launches += 1

    in_row_chunks(launch, launches, ins + extra, BWD_BATCHED, outs)
    return (tuple(unpad_units(o, H0, H, -1, 3) for o in outs[:4])
            + (unpad_units(outs[4], H0, H), outs[5])
            + tuple(unpad_units(o, H0, H) for o in outs[6:]))


decoder_fwd.launches = 0
decoder_bwd.launches = 0
decoder_fwd.plan = None
decoder_bwd.plan = None


def _mm_bt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over (b, t) of a[b,t,:]^T b[b,t,:] -> (Ha, Hb), in f32."""
    return a.float().reshape(-1, a.shape[-1]).t() @ b.float().reshape(-1, b.shape[-1])


def _weight_grads(res, d):
    """``_pal_bwd`` (decoder.py:398-423): the weight gradients as products
    over the streams, every operand cast to f32 (the JAX einsums promote
    bf16 x f32 to f32), each gradient cast to its input's dtype."""
    (emb_proj, dmid, h00, h01, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1,
     keys, mem_v, Wc_q, attn_hs, h0s, h1s, probs) = res
    dx0, dhp0, dx1, dhp1, pre, dscores, dh00, dh01 = d
    B, T, H = attn_hs.shape
    # histories: the inputs of step t
    zeros_h = torch.zeros((B, 1, H), dtype=f32, device=attn_hs.device)
    feed_hist = torch.cat([zeros_h, attn_hs[:, :-1].float()], dim=1)
    h0_hist = torch.cat([h00.float()[:, None], h0s[:, :-1].float()], dim=1)
    h1_hist = torch.cat([h01.float()[:, None], h1s[:, :-1].float()], dim=1)
    mid_hist = dmid.float() * h0s.float()
    dkeys = dscores.transpose(1, 2) @ h1s.float()     # bts,bth->bsh
    dmem_v = probs.float().transpose(1, 2) @ pre      # bts,bth->bsh
    return (dx0.to(emb_proj.dtype), None, dh00.to(h00.dtype), dh01.to(h01.dtype),
            _mm_bt(feed_hist, dx0).to(Wfeed.dtype), _mm_bt(h0_hist, dhp0).to(Wh0.dtype),
            dhp0.sum((0, 1)).to(bh0.dtype), _mm_bt(mid_hist, dx1).to(Wmid.dtype),
            dx1.sum((0, 1)).to(bmid.dtype), _mm_bt(h1_hist, dhp1).to(Wh1.dtype),
            dhp1.sum((0, 1)).to(bh1.dtype), dkeys.to(keys.dtype), dmem_v.to(mem_v.dtype),
            _mm_bt(h1s, pre).to(Wc_q.dtype), None)


class _FusedDecoder(torch.autograd.Function):
    """Forward: :func:`decoder_fwd`; backward: :func:`decoder_bwd` plus the
    weight-gradient products (the custom VJP ``_pal_fwd`` / ``_pal_bwd``).
    dmid and mask_bias get no gradient (JAX returns zeros for them)."""

    @staticmethod
    def forward(ctx, *args):
        attn_hs, h0s, h1s, probs = decoder_fwd(*args)
        ctx.save_for_backward(*args[:14], attn_hs, h0s, h1s, probs)
        return attn_hs, probs

    @staticmethod
    def backward(ctx, d_attn, d_probs):
        res = ctx.saved_tensors
        d = decoder_bwd(*res, d_attn.float(), d_probs.float())
        return _weight_grads(res, d)


def fused_decoder_pallas(emb_proj, dmid, h00, h01, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1,
                         keys, mem_v, Wc_q, mask_bias) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable decoder sequence (both passes are kernels on CUDA
    tensors). Returns (attn_hs (B,T,H), probs (B,T,S)) in the compute
    dtype; gradients reach every input but dmid and mask_bias."""
    return _FusedDecoder.apply(emb_proj, dmid, h00, h01, Wfeed, Wh0, bh0, Wmid, bmid, Wh1,
                               bh1, keys, mem_v, Wc_q, mask_bias)
