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
L2 at every step; the products (mma.sync in bf16) read the other CTAs'
rounded results from L2, which bounds the phases.
:func:`decoder_fwd_plan` and :func:`decoder_bwd_plan` size the grid to the
card's SMs and the shared memory and refuse what the design cannot hold;
the wrappers check with the card that the grid is co-resident.

Forward, one launch: GRU0 after ``round(feed) @ Wfeed``; GRU1 after
``round(dmid * h0') @ Wmid``; the attention (a CTA a batch row); ``tanh``
into the next feed. The last two phases arrive at their barrier once what
the other CTAs read is written and, while it completes, run the products
that only their CTA reads: ``hp1`` of the next step with ``h1' @ Wc_q``,
then ``hp0`` of the next step.

Backward, two launches (a chain of small kernels would take 8 a step and 5
weight transposes, 205 at T=25). The cells' four gate products read only
saved forward streams, so one tiled product (tensor cores in bf16)
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
``_pal_bwd`` computes them outside Pallas (decoder.py:398-416). The TPU row
chunking (``_fwd_rows``, ``_bwd_rows``, a VMEM budget) is not carried over.

Widths. The attention reads keys and mem_v 4 values at a time, so the
kernels compute a width that is a multiple of 4; both wrappers take any H
and zero-pad it up to ``padded_width`` (weights, biases, states, dmid,
keys, mem_v and, backward, the saved streams and d_attn), then slice the
outputs back: exact, as ops/decode_step.py sets out (a padded unit stays 0
and so does its cotangent).
"""

from __future__ import annotations

from typing import Tuple

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
    if dt not in kernels.DTYPE_CODE:
        raise TypeError(f"{what} kernel: weights must be float32 or bfloat16, got {dt}")
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
    launch the kernel at the padded width (the plan of the last launch,
    with the card's SMs and its count of co-resident CTAs, is kept in
    ``decoder_fwd.plan``). ``probe``: an optional int64 tensor for the
    phase stamps."""
    args = (emb_proj, dmid, h00, h01, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1, keys, mem_v, Wc_q)
    if emb_proj.device.type == "cpu":
        return decoder_fwd_ref(*args, mask_bias)
    args, H0, _ = _pad_args(args)
    ins, (B, T, S, H, dt) = _kernel_args("decoder_fwd", args)
    if tuple(mask_bias.shape) != (B, S):
        raise ValueError(f"decoder_fwd kernel: mask_bias {tuple(mask_bias.shape)} != {(B, S)}")
    mb = mask_bias.to(f32).contiguous()
    ins[11], ins[12] = kernels.aligned(ins[11]), kernels.aligned(ins[12])  # keys, mem_v
    dev = ins[0].device
    kernels.require_cuda("decoder_fwd", dev, mask_bias=mb)
    probe_ptr = _probe_ptr("decoder_fwd", probe, T, dev)
    lib = kernels.library("decoder")
    code = kernels.DTYPE_CODE[dt]
    plan = _co_resident_plan("decoder_fwd", "vmmt_decoder_fwd_occupancy",
                             decoder_fwd_plan(B, S, H, dt, kernels.sm_count(dev.index)),
                             code, S, H, dev.index)
    decoder_fwd.plan = plan
    outs = [torch.empty((B, T, H), dtype=dt, device=dev) for _ in range(3)]
    outs.append(torch.empty((B, T, S), dtype=dt, device=dev))
    # the rounded h0' (two steps), h1', dmid * h0' and attn that the CTAs
    # exchange, rows padded to 32; the attention context and a grid
    # barrier's counter
    tscratch = torch.empty((5, B, kernels.pad32(H)), dtype=dt, device=dev)
    fscratch = torch.empty((B * H + 1,), dtype=f32, device=dev)
    err = lib.vmmt_decoder_fwd(code, *(a.data_ptr() for a in ins + [mb]),
                               *(o.data_ptr() for o in outs), tscratch.data_ptr(),
                               fscratch.data_ptr(), probe_ptr, B, T, S, H, plan["units"],
                               plan["rows"], plan["grid"], kernels.stream_of(ins[0]))
    kernels.check(lib, err, "decoder_fwd")
    decoder_fwd.launches += 1
    return tuple(unpad_units(o, H0, H) for o in outs[:3]) + (outs[3],)


DEC_UNITS = {torch.bfloat16: 8, torch.float32: 4}  # hidden units per CTA, both passes
DEC_WARPS = 8  # warps of a CTA (kDecWarps of csrc/decoder.cu)
DEC_PHASES = 4  # grid-barrier phases of a step (kDecPhases)


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
    if dtype not in DEC_UNITS:
        raise TypeError(f"{what} kernel: dtype {dtype}")
    if B < 1 or H < 1:
        raise NotImplementedError(f"{what} kernel: B={B}, H={H}")
    units = DEC_UNITS[dtype]
    unit_tiles = -(-H // units)
    row_tiles = max(1, min(-(-B // 16), sms // unit_tiles))
    rows = kernels.align16(-(-B // row_tiles))
    row_tiles = -(-B // rows)
    grid = max(unit_tiles * row_tiles, min(B, sms))
    return dict(units=units, rows=rows, unit_tiles=unit_tiles, row_tiles=row_tiles, grid=grid)


def _checked_smem(what: str, smem: int, B: int, S: int, H: int) -> int:
    if smem > kernels.SMEM_PER_BLOCK:
        raise NotImplementedError(f"{what} kernel: {smem} bytes of shared memory per CTA "
                                  f"exceed {kernels.SMEM_PER_BLOCK} (B={B}, S={S}, H={H})")
    return smem


def decoder_fwd_plan(B: int, S: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    """Launch plan of the forward's persistent kernel on a card of ``sms``
    SMs: the tiling of :func:`_tiling` and ``smem`` bytes of dynamic shared
    memory per CTA: the units' gate columns of Wfeed, Wh0, Wmid and Wh1
    (three n-tiles of 8 columns in bf16, 4 in f32) and columns of Wc_q (one
    n-tile), each a (columns, K) slice at the padded stride; the product
    buffer (4 n-tiles of 8 floats a row, with room for 8 warps' K-split
    partial sums of 16 rows in bf16); the f32 carries h0, h1, qw (rows,
    units); the hidden products hp0, hp1 (rows, units, 3); the attention
    row (3H + S floats). Mirrors ``DecFwdLayout`` of csrc/decoder.cu. At the
    flagship's width a bf16 CTA takes about 141 KB, one an SM. Planned at
    the padded width ``padded`` (the wrapper pads H to a multiple of 4).
    Raises NotImplementedError for what the design cannot hold."""
    H = padded_width(H)
    plan = _tiling("decoder_fwd", B, H, dtype, sms)
    bf16 = dtype == torch.bfloat16
    tsize = torch.finfo(dtype).bits // 8
    rows, units = plan["rows"], plan["units"]
    tile = 8 if bf16 else 4
    ldw = kernels.frag_ld(H, bf16)
    prod_rows = max(DEC_WARPS * 16, rows) if bf16 else rows
    a16 = kernels.align16
    smem = (4 * a16(3 * tile * ldw * tsize) + a16(tile * ldw * tsize) + prod_rows * 4 * 8 * 4
            + 3 * a16(rows * units * 4) + 2 * a16(rows * units * 3 * 4) + a16((3 * H + S) * 4))
    return dict(plan, padded=H, smem=_checked_smem("decoder_fwd", smem, B, S, H))


def decoder_bwd_plan(B: int, S: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    """Launch plan of the backward's persistent kernel on a card of ``sms``
    SMs: the tiling of :func:`_tiling` and ``smem`` bytes of dynamic shared
    memory per CTA: the units' rows of Wc_q, Wh1, Wmid, Wh0 and Wfeed (rows
    padded to 32, bf16 ones to an odd multiple of 64 bytes for
    conflict-free 16-byte reads), the product buffer, two (rows, units)
    carries and the attention row. Mirrors ``DecLayout`` of
    csrc/decoder.cu. Planned at the padded width ``padded``, as the
    forward. Raises NotImplementedError for what the design cannot hold."""
    H = padded_width(H)
    plan = _tiling("decoder_bwd", B, H, dtype, sms)
    bf16 = dtype == torch.bfloat16
    tsize = torch.finfo(dtype).bits // 8
    rows, units = plan["rows"], plan["units"]
    wrows = 8 if bf16 else units
    prod_rows = max(DEC_WARPS * 16, rows) if bf16 else rows
    smem = (kernels.align16(wrows * kernels.frag_ld(H, bf16) * tsize)
            + 4 * kernels.align16(wrows * kernels.frag_ld(3 * H, bf16) * tsize)
            + prod_rows * 8 * 4 + 2 * kernels.align16(rows * units * 4)
            + kernels.align16((H + 2 * S) * 4))
    return dict(plan, padded=H, smem=_checked_smem("decoder_bwd", smem, B, S, H))


def _co_resident_plan(what: str, fn: str, plan: dict, code: int, S: int, H: int,
                      device: int) -> dict:
    """``plan`` checked against the kernel's own shared-memory count and the
    card's count of co-resident CTAs, with the card's SMs and that count."""
    co_resident, smem = kernels.occupancy(device, "decoder", fn, code, plan["rows"], S, H,
                                          plan["units"])
    if smem != plan["smem"]:
        raise RuntimeError(f"{what} kernel: plan of {plan['smem']} bytes of shared memory, "
                           f"the kernel takes {smem}")
    if plan["grid"] > co_resident:
        raise NotImplementedError(f"{what} kernel: {plan['grid']} CTAs with {smem} bytes "
                                  f"of shared memory each exceed the {co_resident} the card "
                                  "holds at once")
    return dict(plan, sms=kernels.sm_count(device), max_co_resident=co_resident)


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
    the kernels at the padded width (the plan of the last launch, with the
    card's SMs and its count of co-resident CTAs, is kept in
    ``decoder_bwd.plan``). ``probe``: an optional int64 tensor for the
    phase stamps."""
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
    plan = _co_resident_plan("decoder_bwd", "vmmt_decoder_bwd_occupancy",
                             decoder_bwd_plan(B, S, H, dt, kernels.sm_count(dev.index)),
                             code, S, H, dev.index)
    decoder_bwd.plan = plan
    outs = [torch.empty((B, T, 3 * H), dtype=f32, device=dev) for _ in range(4)]
    outs += [torch.empty((B, T, H), dtype=f32, device=dev),
             torch.empty((B, T, S), dtype=f32, device=dev),
             torch.empty((B, H), dtype=f32, device=dev),
             torch.empty((B, H), dtype=f32, device=dev)]
    gates = torch.empty((4, B, T, 3 * H), dtype=f32, device=dev)  # hoisted gate products
    fscratch = torch.empty((2, B, H), dtype=f32, device=dev)  # dfeed, attention part of dh1'
    # pre and the four local gradients of a step, rounded, rows padded to 32
    tscratch = torch.empty((B * (kernels.pad32(H) + 4 * kernels.pad32(3 * H)),), dtype=dt,
                           device=dev)
    err = lib.vmmt_decoder_bwd(code, *(a.data_ptr() for a in ins + extra),
                               *(o.data_ptr() for o in outs), gates.data_ptr(),
                               fscratch.data_ptr(), tscratch.data_ptr(), probe_ptr, B, T, S, H,
                               plan["units"], plan["rows"], plan["grid"],
                               kernels.stream_of(ins[0]))
    kernels.check(lib, err, "decoder_bwd")
    decoder_bwd.launches += 1
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
