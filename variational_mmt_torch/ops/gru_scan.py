"""Fused GRU layer scan, forward and backward: the CUDA kernels' wrappers,
their plain versions and the differentiable ``gru_layer_scan_ad``.

Mirrors ``variational_mmt_tpu/ops/pallas/gru.py`` (``gru_layer_scan``,
``_gru_scan_bwd_impl`` and the custom VJP ``gru_layer_scan_ad``).

Source note, forward. Replaces the Pallas kernel ``_gru_fwd_kernel``
(ops/pallas/gru.py:54, ``pallas_call`` at :165) with ``vmmt_gru_scan`` in
``csrc/gru_scan.cu``. Its bytes (about 15 MB at B=256, T=24, H=250 in bf16)
and FLOPs (2.3 GFLOP) bound it at a few microseconds; what bounds it on the
H100 is the latency of T dependent steps, each waiting for the whole
previous state, and its product cannot be hoisted (h_prev is its own
output). The design runs the scan on thread-block clusters: C CTAs per
``rows`` batch rows (C = 8 at H=250; up to 16, the H100's largest
cluster, at H=512), each holding its 32 units' columns
of Wh for the three gates in shared memory for the whole sequence (48 KB
in bf16), forming its share of ``round(h) @ Wh`` from shared memory (bf16
on the tensor cores, f32 by FMAs), applying the gates from inputs
prefetched a step ahead, and pushing its rounded slice of h' into every
peer's double-buffered copy of the state through distributed shared
memory, with one cluster barrier a step. :func:`scan_fwd_plan` sizes the
clusters (4 rows while the grid stays within one CTA an SM, else 8, the
mma's columns) and shared memory and refuses what a cluster cannot hold;
the wrapper checks with the card that a cluster fits. The TPU's row
chunking (``_max_rows``, a VMEM budget) is not carried over: the grid
covers B.

Source note, reset stream (sequence packing). Both Pallas kernels take an
optional ``reset`` (B,T) stream (the ``has_reset`` branches, gru.py:68-71,
:205-210 and :244-245): before the cell of a step with reset 1 the carry is
multiplied by ``1 - reset``; the backward recomputes the gates from that
zeroed state and stops the carry's cotangent at the boundary. Both CUDA
kernels take it as a nullable pointer (null: today's path), prefetched
with the mask, one float per (row, step). ``reset`` is a constant: it gets
no cotangent. Launches that carry a reset stream are also counted in
``reset_launches``.

Source note, backward. Replaces ``_gru_bwd_kernel`` (ops/pallas/gru.py:186,
``pallas_call`` at :297) with ``vmmt_gru_scan_bwd`` in the same
``csrc/gru_scan.cu``. Its serial part is T dependent steps, each with two
(rows, H) x (H, 3H) products, so the latency of the chain bounds it on the
H100, far above its bytes and FLOPs; a block per 4 rows would use 16 SMs
at B=64 and re-read Wh (375 KB in bf16) from L2 every step. The design
takes off the chain what does not belong there: the gate recompute
``round(h_prev) @ Wh`` reads only saved forward outputs, so one tiled
product (tensor cores in bf16) computes it for all (row, t) first. The
reverse scan then runs on thread-block clusters: C CTAs per 4 batch rows
(C = 8 at H=250: 128 CTAs at B=64; 2 rows in f32 above 448 units), each
holding its 32 rows of Wh in shared
memory for the whole sequence and exchanging its slice of ``dh_proj``
through distributed shared memory with one cluster barrier a step; its
share of ``dh_proj @ Wh^T`` runs on the tensor cores in bf16. The TPU
kernel summed dWh and dbh in VMEM across its sequential grid; here one
more tiled product reduces ``h_prev^T dh_proj`` over K = B*T (both
operands rounded to Wh's dtype, as the Pallas body rounds them; K split
over several blocks a tile, added in a fixed order) and sums dbh in the
same launch, deterministically. :func:`scan_bwd_plan` sizes the
clusters and shared memory and refuses what the design cannot hold; the
wrapper checks with the card that a cluster fits.

Source note, the wide plan (H from 513 to 1024, ``vmmt_gru_wide`` and
``vmmt_gru_wide_bwd`` in the same source). Above 512 units the three gate
blocks of Wh no longer fit one cluster of 16 CTAs: at H = 1024 Wh is 6.3 MB
in bf16 (12.6 MB in f32). The wide plan spreads its 3H columns over the
whole card, as the decoder kernels (rows 5 and 6) spread theirs: a
persistent cooperative kernel whose CTAs each own 8 units in bf16 (one
mma n-tile; 128 CTAs at H = 1024, 49 KB of Wh each) or 4 in f32 (256 CTAs,
two an SM), of a tile of batch rows, and keep those units' columns of Wh in
shared memory for the call. h_{t-1} crosses CTAs through global memory
(L2): each step writes its units of round(h') into one of two exchange
buffers, waits at one grid barrier, and the next step's product streams
the (rows, H) state from L2 straight into the mma fragments (the CTA never
holds it whole: 256 KB at B = 64, H = 1024 in f32). The backward's
serial part runs the same way on round(dh_proj), (rows, 3H) a step; its
hoisted gate recompute and its dWh product are the cluster plan's
(``tile_gemm.cuh`` takes any shape). Batches above 256 rows a CTA run in
chunks, one launch each. :func:`scan_fwd_plan` and :func:`scan_bwd_plan`
plan it (``layout`` ``"wide"``); the wrapper checks with the card that
the grid is co-resident and raises ``NotImplementedError`` naming the plan
when it is not.

Source note, the streamed plan (H above 1024, the same two kernels with
``kStream``). The wide plan ties the grid (a CTA a unit tile) and each
CTA's shared memory (its slice of Wh, 98 KB at H = 2048) to H. The
streamed plan breaks both links: the grid is capped at what the card holds
at once (one bf16 CTA an SM, two in f32), each CTA takes unit tiles in
turn within every step, and the weights stay in global memory, laid out
once a call by the wrapper (:func:`_stream_weights`) in the slices' own
order so that ``block_product`` reads its fragments from L2 (from HBM
every step where Wh exceeds the 50 MB L2: f32 at 2048 units and wider).
The carries move to global memory (the forward reads h back from its own
``outs``, the backward keeps dh in ``dh0``), so a CTA's shared memory is
its product buffer alone, whatever H. All row tiles run in one launch.

Widths. Both kernels take every H >= 1 in f32, bf16 and f16
(:func:`scan_kernel_holds`): clusters up to 512 units, the wide plan to
1024, the streamed plan above, as the Pallas scan takes any H.

float16 takes bf16's path on every plan (``kernels.mma_dtype``: the same
mma.sync tiling, strides and shared memory with f16 operands); what is
said of bf16 here holds for both.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from variational_mmt_torch import kernels
from variational_mmt_torch.models.gru import gru_bwd_core, gru_gates


def _keep(reset: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B,T,1) f32 ``1 - reset``, or None without a reset stream."""
    return None if reset is None else (1.0 - reset.float())[..., None]


def gru_layer_scan_ref(x_proj: torch.Tensor, mask: torch.Tensor, h0: torch.Tensor,
                       Wh: torch.Tensor, bh: torch.Tensor, reverse: bool = False,
                       reset: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, step by step as the Pallas body
    computes it: f32 state, ``h`` rounded to Wh's dtype for the product with
    f32 accumulation, f32 bias and gate math; with ``reset`` (B,T), the
    carry multiplied by ``1 - reset`` before each step's cell. Returns (outs
    (B,T,H) f32, final (B,H) f32)."""
    B, T, H3 = x_proj.shape
    h = h0.float()
    w = Wh.float()
    b = bh.float()
    m = mask.float()
    keep = _keep(reset)
    outs = torch.empty((B, T, H3 // 3), dtype=torch.float32, device=x_proj.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if keep is not None:
            h = h * keep[:, t]
        h_proj = h.to(Wh.dtype).float() @ w + b
        h_new = gru_gates(x_proj[:, t].float(), h_proj, h)
        h = torch.where(m[:, t, None] > 0, h_new, h)
        outs[:, t] = h
    return outs, h


def gru_layer_scan(x_proj: torch.Tensor, mask: torch.Tensor, h0: torch.Tensor,
                   Wh: torch.Tensor, bh: torch.Tensor, reverse: bool = False,
                   reset: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GRU layer over the sequence. x_proj (B,T,3H) and Wh (H,3H) in
    one dtype (float32, bfloat16 or float16); mask (B,T), reset (B,T) or None, h0
    (B,H) and bh (3H,) are taken as f32. Returns (outs (B,T,H) f32, final
    (B,H) f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel (the
    plan of the last launch, with the card's count of co-resident clusters,
    is kept in ``gru_layer_scan.plan``)."""
    if x_proj.device.type == "cpu":
        return gru_layer_scan_ref(x_proj, mask, h0, Wh, bh, reverse, reset)
    B, T, H3 = x_proj.shape
    H = H3 // 3
    dt = Wh.dtype
    kernels.dtype_code("gru_layer_scan", dt)
    if x_proj.dtype != dt:
        raise TypeError(f"gru_layer_scan kernel: x_proj {x_proj.dtype} and Wh {dt} must "
                        "have one dtype")
    if tuple(Wh.shape) != (H, H3) or tuple(mask.shape) != (B, T) or tuple(h0.shape) != (B, H) \
            or tuple(bh.shape) != (H3,) or (reset is not None and tuple(reset.shape) != (B, T)):
        raise ValueError("gru_layer_scan kernel: shapes do not match x_proj (B,T,3H)")
    x = x_proj.contiguous()
    m = mask.to(torch.float32).contiguous()
    r = _reset_arg(reset)
    h = h0.to(torch.float32).contiguous()
    w = Wh.contiguous()
    b = bh.to(torch.float32).contiguous()
    kernels.require_cuda("gru_layer_scan", x.device, mask=m, h0=h, Wh=w, bh=b,
                         **({} if r is None else {"reset": r}))
    outs = torch.empty((B, T, H), dtype=torch.float32, device=x.device)
    final = torch.empty((B, H), dtype=torch.float32, device=x.device)
    lib = kernels.library("gru_scan")
    plan = scan_fwd_plan(B, T, H, dt, kernels.sm_count(x.device.index))
    code = kernels.DTYPE_CODE[dt]
    if plan["layout"] in ("wide", "streamed"):
        gru_layer_scan.plan = _co_resident_wide("gru_layer_scan", 0, plan, code, H,
                                                x.device.index)
        xch = _exchange(plan, H, dt, x.device)
        wt = _stream_weights(w, 0, plan) if plan["layout"] == "streamed" else None
        err = lib.vmmt_gru_wide(code, x.data_ptr(), m.data_ptr(), _ptr(r), h.data_ptr(),
                                w.data_ptr(), b.data_ptr(), outs.data_ptr(), final.data_ptr(),
                                xch.data_ptr(), _ptr(wt), B, T, H, int(reverse), plan["units"],
                                plan["rows"], plan["row_tiles"], plan["grid"],
                                kernels.stream_of(x))
    else:
        co_resident, smem = kernels.occupancy(x.device.index, "gru_scan",
                                              "vmmt_gru_scan_occupancy", code, H,
                                              plan["cluster"], plan["rows"])
        _check_cluster("gru_layer_scan", plan, co_resident, smem)
        gru_layer_scan.plan = dict(plan, max_active_clusters=co_resident,
                                   one_wave=co_resident >= plan["clusters"])
        err = lib.vmmt_gru_scan(code, x.data_ptr(), m.data_ptr(), _ptr(r), h.data_ptr(),
                                w.data_ptr(), b.data_ptr(), outs.data_ptr(), final.data_ptr(),
                                B, T, H, int(reverse), plan["cluster"], plan["units"],
                                plan["rows"], kernels.stream_of(x))
    kernels.check(lib, err, "gru_layer_scan")
    gru_layer_scan.launches += 1
    gru_layer_scan.reset_launches += r is not None
    return outs, final


def _reset_arg(reset: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if reset is None else reset.to(torch.float32).contiguous()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's address for a nullable pointer argument (None: null)."""
    return None if t is None else t.data_ptr()


def _check_cluster(what: str, plan: dict, co_resident: int, smem: int) -> None:
    """Raise unless the kernel's own shared-memory count is the plan's and
    the card holds at least one of its clusters."""
    if smem != plan["smem"]:
        raise RuntimeError(f"{what} kernel: plan of {plan['smem']} bytes of shared memory, "
                           f"the kernel takes {smem}")
    if co_resident < 1:
        raise NotImplementedError(f"{what} kernel: a cluster of {plan['cluster']} CTAs with "
                                  f"{smem} bytes of shared memory each does not fit the card")


def _co_resident_wide(what: str, pass_: int, plan: dict, code: int, H: int,
                      device: int) -> dict:
    """A wide or streamed ``plan`` checked against the kernel's own
    shared-memory count and the card's count of co-resident CTAs, with that
    count."""
    streamed = plan["layout"] == "streamed"
    co_resident, smem = kernels.occupancy(device, "gru_scan", "vmmt_gru_wide_occupancy", code,
                                          pass_, H, plan["units"], plan["rows"], int(streamed))
    if smem != plan["smem"]:
        raise RuntimeError(f"{what} kernel: plan of {plan['smem']} bytes of shared memory, "
                           f"the kernel takes {smem}")
    if plan["grid"] > co_resident:
        raise NotImplementedError(
            f"{what} kernel: the {plan['layout']} plan's {plan['grid']} CTAs "
            f"({plan['unit_tiles']} tiles "
            f"of {plan['units']} units x {plan['row_tiles']} of {plan['rows']} rows) with "
            f"{smem} bytes of shared memory each exceed the {co_resident} the card holds "
            "at once")
    return dict(plan, max_co_resident=co_resident)


def _exchange(plan: dict, width: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The wide kernels' two exchange buffers for one chunk of rows, rows
    of ``width`` padded to 32, in the compute dtype."""
    return torch.empty((2 * plan["rows"] * plan["row_tiles"] * kernels.pad32(width),),
                       dtype=dtype, device=device)


def _prev_states(h0: torch.Tensor, outs: torch.Tensor, reverse: bool) -> torch.Tensor:
    """(B,T,H) f32: the state each step started from, in forward time
    order: h0 at the first step processed, else the previous step's output."""
    h0 = h0.float()[:, None]
    if reverse:
        return torch.cat([outs[:, 1:], h0], dim=1)
    return torch.cat([h0, outs[:, :-1]], dim=1)


def gru_layer_scan_bwd_ref(x_proj: torch.Tensor, mask: torch.Tensor, h0: torch.Tensor,
                           Wh: torch.Tensor, bh: torch.Tensor, outs: torch.Tensor,
                           g: torch.Tensor, reverse: bool = False,
                           reset: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the backward kernel, step by step as the
    Pallas body (``_gru_bwd_kernel``) computes it: gates recomputed from the
    previous state, masked steps passing dh through, ``dh_proj`` rounded to
    Wh's dtype for ``dh_proj @ Wh^T`` and for dWh; with ``reset``, the
    previous state multiplied by ``keep = 1 - reset`` and each step's dh_prev
    too. ``g`` (B,T,H) is the cotangent of ``outs`` with the final state's
    already folded in. Returns (dx_proj (B,T,3H), dh0 (B,H), dWh (H,3H), dbh
    (3H,)), all f32."""
    B, T, H3 = x_proj.shape
    cdt = Wh.dtype
    w = Wh.float()
    b = bh.float()
    m = mask.float()
    keep = _keep(reset)
    prev = _prev_states(h0, outs, reverse)
    dh = torch.zeros((B, H3 // 3), dtype=torch.float32, device=x_proj.device)
    dx = torch.empty((B, T, H3), dtype=torch.float32, device=x_proj.device)
    dWh = torch.zeros((H3 // 3, H3), dtype=torch.float32, device=x_proj.device)
    dbh = torch.zeros((H3,), dtype=torch.float32, device=x_proj.device)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        h_prev = prev[:, t] if keep is None else prev[:, t] * keep[:, t]
        h_proj = h_prev.to(cdt).float() @ w + b
        m_t = m[:, t, None]
        dh_total = g[:, t].float() + dh
        dx_t, dhp, dh_part = gru_bwd_core(m_t * dh_total, x_proj[:, t].float(), h_proj, h_prev)
        dhp_c = dhp.to(cdt).float()
        dh = (1.0 - m_t) * dh_total + dh_part + dhp_c @ w.t()
        if keep is not None:
            dh = dh * keep[:, t]
        dx[:, t] = dx_t
        dWh += h_prev.to(cdt).float().t() @ dhp_c
        dbh += dhp.sum(0)
    return dx, dh, dWh, dbh


SCAN_BWD_ROWS = 4  # batch rows per cluster (kScanRows of csrc/gru_scan.cu)
SCAN_BWD_F32_WIDE_ROWS = 2  # f32 where 4 rows of dh_proj buffers do not fit
SCAN_BWD_UNITS = 32  # most hidden units one CTA owns (kScanUnits)
SCAN_BWD_MAX_CLUSTER = 16  # the H100's largest (non-portable) cluster (kMaxCluster)
SCAN_BWD_WARPS = 8  # warps of a CTA (kScanWarps)
SCAN_FWD_SLOTS = 8  # batch-row slots of the forward's state buffers (kFwdSlots)
SCAN_FWD_FEW_SLOTS = 4  # f32 where 8 slots do not fit (kFwdFewSlots)
SCAN_FWD_PARTS = 4  # K split of the forward's step product (kFwdParts)
SCAN_FWD_SMALL_ROWS = 4  # rows per cluster while the grid stays within one CTA an SM
# 512: the widest a cluster holds
SCAN_CLUSTER_MAX_HIDDEN = SCAN_BWD_MAX_CLUSTER * SCAN_BWD_UNITS
SCAN_WIDE_MAX_HIDDEN = 1024  # the widest the wide plan takes; the streamed plan above
# units of a wide CTA (tile_rows) and CTAs an SM (WideBlocks::kPerSm)
SCAN_WIDE_UNITS = {torch.bfloat16: 8, torch.float16: 8, torch.float32: 4}
SCAN_WIDE_PER_SM = {torch.bfloat16: 1, torch.float16: 1, torch.float32: 2}
SCAN_WIDE_MAX_ROWS = 256  # batch rows of a wide CTA; more rows run in chunks
SCAN_WIDE_WARPS = 8  # warps of a wide CTA (kDecWarps of csrc/block_product.cuh)
H100_SMS = 132  # SMs of an H100 SXM: what scan_kernel_holds, a pure function, plans for


def _mma_ld(k: int) -> int:
    """Row stride, in 16-bit elements, of an mma operand of k columns held in
    shared memory (``slice_ld`` of csrc/tile_gemm.cuh): k padded to 16, then
    to 4 words more than a multiple of 32 so that fragment reads miss no
    bank."""
    k = kernels.align16(k)
    return k + (72 - k % 64) % 64


def _cluster_units(what: str, H: int) -> Tuple[int, int]:
    """(CTAs of a cluster, hidden units of a CTA) for H units, or
    NotImplementedError when one cluster cannot hold them."""
    if not 1 <= H <= SCAN_CLUSTER_MAX_HIDDEN:
        raise NotImplementedError(
            f"{what} kernel: hidden {H} needs more than {SCAN_BWD_MAX_CLUSTER} "
            f"CTAs of {SCAN_BWD_UNITS} units in a cluster")
    cluster = -(-H // SCAN_BWD_UNITS)
    return cluster, -(-H // cluster)


def _fwd_smem(H: int, dtype: torch.dtype, rows: int) -> int:
    """Shared memory of a forward CTA (``FwdLayout`` and ``fwd_slots``):
    the CTA's 96 gate-unit columns of Wh and two state buffers of 8 row
    slots in the compute dtype, 16-bit rows at the mma stride; the K-split
    partial products in f32. In f32 4 slots where clusters of at most 4 rows
    would not fit with 8 (H > 448)."""
    mma = kernels.mma_dtype(dtype)
    tsize = dtype.itemsize
    ld = _mma_ld(H) if mma else H
    cols = 3 * SCAN_BWD_UNITS

    def smem(slots: int) -> int:
        return (kernels.align16(cols * ld * tsize) + kernels.align16(2 * slots * ld * tsize)
                + SCAN_FWD_PARTS * cols * slots * 4)

    if not mma and rows <= SCAN_FWD_FEW_SLOTS and smem(SCAN_FWD_SLOTS) > kernels.SMEM_PER_BLOCK:
        return smem(SCAN_FWD_FEW_SLOTS)
    return smem(SCAN_FWD_SLOTS)


def _bwd_smem(H: int, dtype: torch.dtype, units: int, rows: int) -> int:
    """Shared memory of a backward scan CTA (``ScanLayout``): its rows of Wh
    and two ``dh_proj`` buffers of ``rows`` rows in the compute dtype, 16-bit
    rows at the mma stride; dh, dh_part and, in 16 bits, the warps' partial
    products in f32."""
    mma = kernels.mma_dtype(dtype)
    tsize = dtype.itemsize
    wrows, ld = (SCAN_BWD_UNITS, _mma_ld(3 * H)) if mma else (units, 3 * H)
    return (kernels.align16(wrows * ld * tsize) + kernels.align16(2 * rows * ld * tsize)
            + 2 * rows * units * 4
            + (SCAN_BWD_WARPS // 2 * SCAN_BWD_UNITS * rows * 4 if mma else 0))


def _bwd_rows(H: int, dtype: torch.dtype, units: int) -> int:
    """Batch rows of a backward cluster: 4, or 2 in f32 where 4 do not fit."""
    if dtype == torch.float32 and _bwd_smem(H, dtype, units, SCAN_BWD_ROWS) \
            > kernels.SMEM_PER_BLOCK:
        return SCAN_BWD_F32_WIDE_ROWS
    return SCAN_BWD_ROWS


def _wide_smem(pass_: int, H: int, dtype: torch.dtype, rows: int,
               streamed: bool = False) -> int:
    """Shared memory of a wide CTA of ``rows`` batch rows (``WideFwdLayout``
    and ``WideBwdLayout`` of csrc/gru_scan.cu). Forward: its units' three
    gate columns of Wh as (3 tile rows, K) slices at the padded stride, the
    product buffer (3 n-tiles of 8 floats a row, room for 8 warps' K-split
    partial sums of 16 rows in 16 bits) and the f32 carry. Backward: its units'
    rows of Wh (K = 3H), one n-tile of product and the f32 dh and dh_part.
    ``streamed``: the product buffer alone."""
    mma = kernels.mma_dtype(dtype)
    tsize = dtype.itemsize
    units = SCAN_WIDE_UNITS[dtype]
    prod_rows = max(SCAN_WIDE_WARPS * 16, rows) if mma else rows
    carry = 0 if streamed else kernels.align16(rows * units * 4)
    if pass_ == 0:
        w = 0 if streamed else kernels.align16(3 * units * kernels.frag_ld(H, mma) * tsize)
        return w + prod_rows * 3 * 8 * 4 + carry
    w = 0 if streamed else kernels.align16(units * kernels.frag_ld(3 * H, mma) * tsize)
    return w + prod_rows * 8 * 4 + 2 * carry


def _wide_plan(what: str, pass_: int, B: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    """The wide plan of pass 0 (forward) or 1 (backward): ``unit_tiles``
    CTAs of ``units`` units (8 in bf16 and f16, 4 in f32) times ``row_tiles`` of
    ``rows`` batch rows (a multiple of 16, at most 256; row tiles halve
    what each CTA reads of the state, as long as the grid stays within a
    CTA an SM), ``grid`` CTAs a launch, ``chunks`` launches a call."""
    units = SCAN_WIDE_UNITS[dtype]
    unit_tiles = -(-H // units)
    B = max(B, 1)
    row_tiles = max(1, min(-(-B // 16), sms // unit_tiles))
    rows = min(kernels.align16(-(-B // row_tiles)), SCAN_WIDE_MAX_ROWS)
    row_tiles = min(row_tiles, -(-B // rows))
    smem = _wide_smem(pass_, H, dtype, rows)
    if smem > kernels.SMEM_PER_BLOCK:
        raise NotImplementedError(f"{what} kernel: the wide plan's {smem} bytes of shared "
                                  f"memory per CTA exceed {kernels.SMEM_PER_BLOCK}")
    grid = unit_tiles * row_tiles
    return dict(layout="wide", units=units, rows=rows, unit_tiles=unit_tiles,
                row_tiles=row_tiles, grid=grid, ctas=grid,
                chunks=-(-B // (rows * row_tiles)), smem=smem)


def _stream_plan(pass_: int, B: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    """The streamed plan of pass 0 (forward) or 1 (backward): ``unit_tiles``
    of ``units`` units (8 in bf16 and f16, 4 in f32) times ``row_tiles`` of ``rows``
    batch rows (a multiple of 16, at most 256), all in one launch
    (``chunks`` 1) of ``grid`` CTAs, as many as the card holds at once
    (``SCAN_WIDE_PER_SM`` an SM) or as there are tiles; each CTA takes
    ``tiles_per_cta`` tiles at most a step. Shared memory: the product
    buffer, whatever H."""
    units = SCAN_WIDE_UNITS[dtype]
    unit_tiles = -(-H // units)
    B = max(B, 1)
    row_tiles = -(-B // SCAN_WIDE_MAX_ROWS)
    rows = kernels.align16(-(-B // row_tiles))
    tiles = unit_tiles * row_tiles
    grid = min(tiles, SCAN_WIDE_PER_SM[dtype] * sms)
    return dict(layout="streamed", units=units, rows=rows, unit_tiles=unit_tiles,
                row_tiles=row_tiles, tiles=tiles, grid=grid, ctas=grid,
                tiles_per_cta=-(-tiles // grid), chunks=1,
                smem=_wide_smem(pass_, H, dtype, rows, streamed=True))


def _stream_weights(Wh: torch.Tensor, pass_: int, plan: dict) -> torch.Tensor:
    """Wh (H, 3H) laid out for the streamed kernels (``Wide::wt`` of
    csrc/gru_scan.cu), zero past H and past each row's width. Forward: per
    unit tile its three gates' columns as rows, (unit_tiles, 3, units,
    frag_ld(H)); backward: Wh's rows, (unit_tiles * units, frag_ld(3H))."""
    H = Wh.shape[0]
    units, ut = plan["units"], plan["unit_tiles"]
    mma = kernels.mma_dtype(Wh.dtype)
    if pass_ == 1:
        wt = Wh.new_zeros((ut * units, kernels.frag_ld(3 * H, mma)))
        wt[:H, :3 * H] = Wh
        return wt
    cols = Wh.new_zeros((3, ut * units, kernels.frag_ld(H, mma)))
    cols[:, :H, :H] = Wh.view(H, 3, H).permute(1, 2, 0)  # [gate, unit, k] = Wh[k, gate*H+unit]
    return cols.view(3, ut, units, -1).transpose(0, 1).contiguous()


def scan_kernel_holds(H: int, dtype: torch.dtype) -> bool:
    """Whether both scan kernels (forward and backward) compute a layer of
    H units in ``dtype`` at every batch size: every H >= 1. Up to 512 units
    on clusters (16 CTAs of 32 units, the largest cluster) with both CTAs'
    shared memory within the card's; to 1024 on the wide plan, whose CTAs
    at the most rows fit the card's shared memory, two an SM where the grid
    exceeds an H100's 132 SMs; above, on the streamed plan, whose grid and
    shared memory do not grow with H. ``UniGRU`` sends every ``use_pallas``
    GRU layer to the kernels, as JAX sends it to the Pallas scan."""
    if dtype not in kernels.DTYPE_CODE or H < 1:
        return False
    if H > SCAN_WIDE_MAX_HIDDEN:  # the streamed plan: nothing in it grows with H
        return True
    if H > SCAN_CLUSTER_MAX_HIDDEN:
        per_sm = 1 if -(-H // SCAN_WIDE_UNITS[dtype]) <= H100_SMS else 2
        return all(per_sm * (_wide_smem(p, H, dtype, SCAN_WIDE_MAX_ROWS) + 1024)
                   <= kernels.SMEM_PER_SM
                   and _wide_smem(p, H, dtype, SCAN_WIDE_MAX_ROWS) <= kernels.SMEM_PER_BLOCK
                   for p in (0, 1))
    cluster, units = _cluster_units("gru_layer_scan", H)
    return (_fwd_smem(H, dtype, SCAN_FWD_FEW_SLOTS) <= kernels.SMEM_PER_BLOCK
            and _bwd_smem(H, dtype, units, _bwd_rows(H, dtype, units))
            <= kernels.SMEM_PER_BLOCK)


def scan_fwd_plan(B: int, T: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    """Launch plan of the forward for B rows, T steps and H units on a card
    of ``sms`` SMs. Up to 512 units (``layout`` ``"cluster"``): clusters of
    ``cluster`` CTAs (up to 16), each owning ``units`` hidden units of
    ``rows`` batch rows, with ``smem`` bytes of dynamic shared memory per
    CTA (:func:`_fwd_smem`, mirrors ``FwdLayout`` of csrc/gru_scan.cu).
    ``rows`` is 4 while the grid fits one CTA an SM of the card, else 8
    (the mma's columns); in f32 also 4 where 8 row slots do not fit (H >
    448). From 513 to 1024 units the wide plan (:func:`_wide_plan`), above
    the streamed plan (:func:`_stream_plan`). Raises NotImplementedError
    for what the design cannot hold."""
    kernels.dtype_code("gru_layer_scan", dtype)
    if H > SCAN_WIDE_MAX_HIDDEN:
        return _stream_plan(0, B, H, dtype, sms)
    if H > SCAN_CLUSTER_MAX_HIDDEN:
        return _wide_plan("gru_layer_scan", 0, B, H, dtype, sms)
    cluster, units = _cluster_units("gru_layer_scan", H)
    rows = SCAN_FWD_SMALL_ROWS
    if -(-B // rows) * cluster > sms and _fwd_smem(H, dtype, SCAN_FWD_SLOTS) \
            <= kernels.SMEM_PER_BLOCK:
        rows = SCAN_FWD_SLOTS
    smem = _fwd_smem(H, dtype, rows)
    if smem > kernels.SMEM_PER_BLOCK:
        raise NotImplementedError(f"gru_layer_scan kernel: {smem} bytes of shared memory "
                                  f"per CTA exceed {kernels.SMEM_PER_BLOCK}")
    clusters = -(-B // rows)
    return dict(layout="cluster", cluster=cluster, rows=rows, units=units, clusters=clusters,
                ctas=clusters * cluster, threads=3 * SCAN_BWD_UNITS * SCAN_FWD_PARTS, smem=smem)


def scan_bwd_plan(B: int, T: int, H: int, dtype: torch.dtype, sms: int = H100_SMS) -> dict:
    """Launch plan of the backward for B rows, T steps and H units on a
    card of ``sms`` SMs. Up to 512 units (``layout`` ``"cluster"``):
    clusters of ``cluster`` CTAs (up to 16), each owning ``units`` hidden
    units of ``rows`` batch rows (4, or 2 in f32 above 448 units), with
    ``smem`` bytes of dynamic shared memory per CTA (:func:`_bwd_smem`,
    mirrors ``ScanLayout`` of csrc/gru_scan.cu); from 513 to 1024 units the
    wide plan (:func:`_wide_plan`), above the streamed plan
    (:func:`_stream_plan`). All with the dWh product's 64 x 64 tiles, each
    split over ``dwh_splits`` blocks along K = B*T (1 on the wide and
    streamed plans, whose 243 or more tiles fill the card). Raises
    NotImplementedError for what the design cannot hold."""
    kernels.dtype_code("gru_layer_scan_bwd", dtype)
    dwh_tiles = -(-H // 64) * -(-3 * H // 64)
    if H > SCAN_WIDE_MAX_HIDDEN:
        return dict(_stream_plan(1, B, H, dtype, sms), dwh_tiles=dwh_tiles, dwh_splits=1)
    if H > SCAN_CLUSTER_MAX_HIDDEN:
        return dict(_wide_plan("gru_layer_scan_bwd", 1, B, H, dtype, sms), dwh_tiles=dwh_tiles,
                    dwh_splits=1)
    cluster, units = _cluster_units("gru_layer_scan_bwd", H)
    rows = _bwd_rows(H, dtype, units)
    smem = _bwd_smem(H, dtype, units, rows)
    if smem > kernels.SMEM_PER_BLOCK:
        raise NotImplementedError(f"gru_layer_scan_bwd kernel: {smem} bytes of shared memory "
                                  f"per CTA exceed {kernels.SMEM_PER_BLOCK}")
    clusters = -(-B // rows)
    dwh_splits = max(1, min(8, -(-B * T // 32) // 4))
    return dict(layout="cluster", cluster=cluster, rows=rows, units=units, clusters=clusters,
                ctas=clusters * cluster, smem=smem, dwh_tiles=dwh_tiles, dwh_splits=dwh_splits)


def gru_layer_scan_bwd(x_proj: torch.Tensor, mask: torch.Tensor, h0: torch.Tensor,
                       Wh: torch.Tensor, bh: torch.Tensor, outs: torch.Tensor,
                       g: torch.Tensor, reverse: bool = False,
                       reset: Optional[torch.Tensor] = None):
    """Backward of :func:`gru_layer_scan` (same inputs, plus its f32
    ``outs`` and their cotangent ``g``). Returns (dx_proj, dh0, dWh, dbh) in
    f32. CPU tensors take the plain version; CUDA tensors launch the
    kernels (the plan of the last launch, with the card's count of
    co-resident clusters, is kept in ``gru_layer_scan_bwd.plan``)."""
    if x_proj.device.type == "cpu":
        return gru_layer_scan_bwd_ref(x_proj, mask, h0, Wh, bh, outs, g, reverse, reset)
    B, T, H3 = x_proj.shape
    H = H3 // 3
    dt = Wh.dtype
    kernels.dtype_code("gru_layer_scan_bwd", dt)
    if x_proj.dtype != dt:
        raise TypeError(f"gru_layer_scan_bwd kernel: x_proj {x_proj.dtype} and Wh {dt} must "
                        "have one dtype")
    if tuple(Wh.shape) != (H, H3) or tuple(mask.shape) != (B, T) or tuple(h0.shape) != (B, H) \
            or tuple(bh.shape) != (H3,) or tuple(outs.shape) != (B, T, H) \
            or tuple(g.shape) != (B, T, H) \
            or (reset is not None and tuple(reset.shape) != (B, T)):
        raise ValueError("gru_layer_scan_bwd kernel: shapes do not match x_proj (B,T,3H)")
    lib = kernels.library("gru_scan")
    plan = scan_bwd_plan(B, T, H, dt, kernels.sm_count(x_proj.device.index))
    f32 = torch.float32
    x = x_proj.contiguous()
    args = [x, mask.to(f32).contiguous(), h0.to(f32).contiguous(), Wh.contiguous(),
            bh.to(f32).contiguous(), outs.to(f32).contiguous(), g.to(f32).contiguous()]
    r = _reset_arg(reset)
    kernels.require_cuda("gru_layer_scan_bwd", x.device,
                         **dict(zip(("mask", "h0", "Wh", "bh", "outs", "g"), args[1:])),
                         **({} if r is None else {"reset": r}))
    args.insert(2, r)
    dx = torch.empty((B, T, H3), dtype=f32, device=x.device)
    dh0 = torch.empty((B, H), dtype=f32, device=x.device)
    dWh = torch.empty((H, H3), dtype=f32, device=x.device)
    dbh = torch.empty((H3,), dtype=f32, device=x.device)
    hp = torch.empty((B, T, H3), dtype=f32, device=x.device)  # hoisted gate product
    dhn = torch.empty((B, T, H), dtype=f32, device=x.device)  # third block of dh_proj
    splits, tiles = plan["dwh_splits"], plan["dwh_tiles"]
    partial = torch.empty((tiles * splits * 64 * 64 if splits > 1 else 1,), dtype=f32,
                          device=x.device)
    counters = torch.zeros((tiles,), dtype=torch.int32, device=x.device)
    code = kernels.DTYPE_CODE[dt]
    outputs = (dx.data_ptr(), dh0.data_ptr(), dWh.data_ptr(), dbh.data_ptr(), hp.data_ptr(),
               dhn.data_ptr(), partial.data_ptr(), counters.data_ptr())
    if plan["layout"] in ("wide", "streamed"):
        gru_layer_scan_bwd.plan = _co_resident_wide("gru_layer_scan_bwd", 1, plan, code, H,
                                                    x.device.index)
        xch = _exchange(plan, H3, dt, x.device)
        wt = _stream_weights(args[4], 1, plan) if plan["layout"] == "streamed" else None
        err = lib.vmmt_gru_wide_bwd(code, *map(_ptr, args), *outputs, xch.data_ptr(), _ptr(wt),
                                    B, T, H, int(reverse), plan["units"], plan["rows"],
                                    plan["row_tiles"], plan["grid"], splits,
                                    kernels.stream_of(x))
    else:
        co_resident, smem = kernels.occupancy(x.device.index, "gru_scan",
                                              "vmmt_gru_scan_bwd_occupancy", code, H,
                                              plan["cluster"], plan["units"], plan["rows"])
        _check_cluster("gru_layer_scan_bwd", plan, co_resident, smem)
        gru_layer_scan_bwd.plan = dict(plan, max_active_clusters=co_resident,
                                       one_wave=co_resident >= plan["clusters"])
        err = lib.vmmt_gru_scan_bwd(code, *map(_ptr, args), *outputs, B, T, H, int(reverse),
                                    plan["cluster"], plan["units"], plan["rows"], splits,
                                    kernels.stream_of(x))
    kernels.check(lib, err, "gru_layer_scan_bwd")
    gru_layer_scan_bwd.launches += 1
    gru_layer_scan_bwd.reset_launches += r is not None
    return dx, dh0, dWh, dbh


gru_layer_scan.launches = 0
gru_layer_scan.reset_launches = 0  # the launches that carried a reset stream
gru_layer_scan.plan = None
gru_layer_scan_bwd.launches = 0
gru_layer_scan_bwd.reset_launches = 0
gru_layer_scan_bwd.plan = None


class _GruLayerScanAD(torch.autograd.Function):
    """Forward: :func:`gru_layer_scan`; backward: :func:`gru_layer_scan_bwd`
    (the custom VJP ``_gru_ad_fwd`` / ``_gru_ad_bwd``, gru.py:346-384)."""

    @staticmethod
    def forward(ctx, x_proj, mask, h0, Wh, bh, reverse, reset):
        outs, final = gru_layer_scan(x_proj, mask, h0, Wh, bh, reverse, reset)
        ctx.save_for_backward(x_proj, mask, h0, Wh, bh, outs, reset)
        ctx.reverse = reverse
        return outs, final

    @staticmethod
    def backward(ctx, g_outs, g_fin):
        x_proj, mask, h0, Wh, bh, outs, reset = ctx.saved_tensors
        # fold the final state's cotangent into the last step processed:
        # exact, because every step writes out[t] = carry, so out[last] == final
        g = g_outs.float().clone()
        g[:, 0 if ctx.reverse else -1] += g_fin.float()
        dx, dh0, dWh, dbh = gru_layer_scan_bwd(x_proj, mask, h0, Wh, bh, outs, g, ctx.reverse,
                                               reset)
        # reset, like mask, is a constant: no cotangent (Pallas gru.py:383)
        return (dx.to(x_proj.dtype), None, dh0.to(h0.dtype), dWh.to(Wh.dtype),
                dbh.to(bh.dtype), None, None)


def gru_layer_scan_ad(x_proj: torch.Tensor, mask: torch.Tensor, h0: torch.Tensor,
                      Wh: torch.Tensor, bh: torch.Tensor, reverse: bool = False,
                      reset: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable :func:`gru_layer_scan` (both passes are kernels on
    CUDA tensors). Gradients come back in the inputs' dtypes; ``mask`` and
    ``reset`` have none."""
    return _GruLayerScanAD.apply(x_proj, mask, h0, Wh, bh, reverse, reset)
