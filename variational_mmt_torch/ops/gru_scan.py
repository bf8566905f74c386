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

Source note, the forward's tiled plan (``vmmt_gru_tiled_fwd`` in the same
source; above 512 units, and below wherever the cluster plan's clusters
would run in waves: 16-CTA clusters, 7 of which an H100 holds at once, from
449 units at B >= 64). Above 512 units the three gate blocks of Wh no
longer fit one cluster of 16 CTAs: at H = 1024 Wh is 6.3 MB in bf16 (12.6
MB in f32), so the state crosses CTAs through global memory (L2) with one
grid barrier a step. The serial part is T steps of h_proj = round(h) @ Wh +
bh, a (B, H) x (H, 3H) product whose operand is the step before's output,
and the gates; its FLOPs are few, and what bounds it on the H100 is the
bytes each SM pulls from L2 a step and the grid barriers. The tiled plan
makes the product output-stationary, as the backward's below: each CTA owns
a tile of ``rows`` x ``units`` cells (32 to 128 rows, 8 to 128 units) for
the call, whose N is the 3 * units r, z and n columns of its own units, so
the gates need nothing from another CTA. K = H moves through a ``cp.async``
ring in shared memory (4 stages, 2 where 4 do not fit), or, where the
tile's columns of Wh stay in shared memory for the call and the CTA's whole
K of its state rows fits beside them, arrives in one stage by the TMA
unit's bulk copies (a row each, one mbarrier, no barrier between K chunks);
the warps' partial products take the ring's bytes where Wh is resident.
``ldmatrix`` feeds ``mma.sync`` in bf16 and f16 (``ldmatrix.trans`` for
Wh's (K, N) rows; FMAs in f32), and a step's state leaves L2 H / units
times. Tiles of 8 units (N = 24, warp tiles of 16 x 24) give 64 or more
CTAs each all of K at B = 64, with no K split and so no sums across CTAs;
where B leaves few tiles, a thread-block cluster of 2 or 4 CTAs splits K a
tile and adds its partial products through distributed shared memory in
rank order (deterministic); the launch is cooperative and clustered at
once. Each CTA keeps the f32 carry of its own cells and its units' biases
in shared memory, and its threads' first gate inputs load under the
product. Wh is read in place where each gate's columns start on a 16-byte
piece (H * itemsize a multiple of 16), else from a padded copy made once a
call (:func:`_tiled_fwd_weights`). :func:`tiled_fwd_plan` picks the tiling
and ring whose grid the card holds at once by its own cost model
(:func:`_tiled_fwd_cost`); batches above a launch's rows run in chunks.
The wrapper checks the plan with the card and raises ``NotImplementedError``
where the grid is not co-resident.

Source note, the backward's tiled plan (``vmmt_gru_tiled_bwd`` in the same
source; above 512 units, and below wherever the cluster plan's clusters
would run in waves: 16-CTA clusters, 7 of which an H100 holds at once, from
449 units at B >= 64). The serial part of the backward is T steps of the
gate backward and dh = dh_part + round(dh_proj) @ Wh^T, a (B, 3H) x (3H,
H) product whose operand is the step's own output. Its FLOPs are few; what
bounds it on the H100 is the bytes each SM pulls from L2 a step and the
grid barrier of each step. The tiled plan makes the product
output-stationary: each CTA owns a tile of ``rows`` x ``units`` cells for
the call (32 to 128 a side in 32 x 32 warp tiles, or the narrow tiles of 16
rows or 8 and 16 units in 16 x 8 warp tiles, so that 64 or more CTAs each
take all of K at B = 64 with no K split), and a step's dh_proj leaves L2 H /
units times. K = 3H moves through a 4-stage ``cp.async`` ring in shared
memory (Wh's rows stay there for the call where a CTA's share fits), or,
where the tile's rows of Wh stay resident and the CTA's whole K of its
rows of dh_proj fits beside them, arrives in one stage by the TMA unit's
bulk copies (a row each, one mbarrier, no barrier between K chunks; the
warps' partial products then take the stage's bytes). ``ldmatrix`` feeds
``mma.sync`` in bf16 and f16 (FMAs in f32). Where B leaves few tiles, a
thread-block cluster of 2 or 4 CTAs splits K a tile and adds its partial
products through distributed shared memory in rank order
(deterministic); without a cluster there is no sums pass: the next step's
gate backward adds the K groups' partial products in group order as it
reads dh. The launch is cooperative and clustered at once. Each CTA keeps
the dh carry and dh_part of its own cells in shared memory, and loads (on
the narrow tiles) or prefetches into L2 the next step's gate inputs while
the product runs. Wh is read in place where 3H elements are whole 16-byte
pieces, else from a padded copy made once a call (:func:`_tiled_weights`).
:func:`_tiled_plan` picks the tiling and ring whose grid the card holds at
once (:func:`tiled_co_resident`) by its cost model (:func:`_tiled_cost`,
by phase); batches above a launch's rows run in chunks. The wrapper checks
the plan with the card and raises ``NotImplementedError`` where the grid is
not co-resident.

Source note, the backward's hoisted products (row 2's (a) gate recompute
``hp = round(h_prev) @ Wh + bh`` and (c) ``dWh = round(h_prev)^T
round(dh_proj)``, gru.py:218 and :249, gathered over all (row, t) under
both plans). At B = 256, T = 24, H = 1024-2048 they are 77-309 GFLOP, so
the card's 989 TFLOP/s bound them, where tile_gemm.cuh (written for H =
250: one shared-memory stage filled through registers from f32 operands,
``mma.sync``) ran at about 5% of it. In bf16 and f16 (:func:`products_plan`,
engine ``"wgmma"``) an operand pass writes the rounded operands once in
the compute dtype, rows padded to 8 values (Hs before the scan, dP and dbh
after it), and ``csrc/wgmma_gemm.cuh`` forms each product: TMA boxes into a
ring of 128-byte-swizzled stages guarded by mbarriers, one producer thread,
two consumer warpgroups on ``wgmma.mma_async`` m64n128/256k16, MN-major
operands read through the transpose bits, dWh's K split in a fixed order
where its tiles leave most SMs idle. f32 keeps tile_gemm.cuh's FMAs (JAX's
f32 products are not TF32). :func:`scan_bwd_products` runs the products
alone, :func:`scan_bwd_products_ref` is their plain version.

Widths. Both kernels take every H >= 1 in f32, bf16 and f16 that a card's
132 SMs tile (:func:`scan_kernel_holds`; from 16897 units they do not):
each on clusters up to 512 units where they run in one wave, else on its
tiled plan (:func:`scan_fwd_plan`, :func:`scan_bwd_plan`), as the Pallas
scan takes any H.

float16 takes bf16's path on every plan (``kernels.mma_dtype``: the same
mma.sync tiling, strides and shared memory with f16 operands); what is
said of bf16 here holds for both.
"""

from __future__ import annotations

import functools
import math
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
                   reset: Optional[torch.Tensor] = None,
                   probe: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GRU layer over the sequence. x_proj (B,T,3H) and Wh (H,3H) in
    one dtype (float32, bfloat16 or float16); mask (B,T), reset (B,T) or None, h0
    (B,H) and bh (3H,) are taken as f32. Returns (outs (B,T,H) f32, final
    (B,H) f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel (the
    plan of the last launch, with the card's count of co-resident clusters
    or CTAs, is kept in ``gru_layer_scan.plan``). ``probe``: on the tiled
    plan, an int64 tensor of ``1 + 4 * T`` entries on the
    device for the first launch's ``%globaltimer`` stamps (ns) of CTA 0:
    after its first grid barrier, then each step's product, sums, gates and
    grid barrier."""
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
    _check_probe("gru_layer_scan", plan, probe, T, x.device)
    if plan["layout"] == "tiled":
        gru_layer_scan.plan = _co_resident_tiled(
            "gru_layer_scan", "vmmt_gru_tiled_fwd_occupancy", plan, code, H, x.device.index,
            plan["stages"])
        w = kernels.aligned(w)  # the ring reads Wh's rows in 16-byte pieces
        xch = _exchange(plan, plan["ldx"], dt, x.device)
        wt = _tiled_fwd_weights(w, plan)
        err = lib.vmmt_gru_tiled_fwd(code, x.data_ptr(), m.data_ptr(), _ptr(r), h.data_ptr(),
                                     w.data_ptr(), b.data_ptr(), outs.data_ptr(),
                                     final.data_ptr(), xch.data_ptr(), _ptr(wt), B, T, H,
                                     int(reverse), plan["rows"], plan["units"], plan["cluster"],
                                     plan["row_tiles"], int(plan["resident"]), plan["stages"],
                                     _ptr(probe), kernels.stream_of(x))
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


def _co_resident_tiled(what: str, fn: str, plan: dict, code: int, H: int, device: int,
                       *extra: int) -> dict:
    """A tiled ``plan`` checked against the kernel's own shared-memory count
    (the occupancy query ``fn`` with the tiling and ``extra``) and the CTAs
    the card holds at once in clusters of the plan's size, with that count."""
    co_resident, smem = kernels.occupancy(device, "gru_scan", fn, code, H, plan["rows"],
                                          plan["units"], plan["cluster"], int(plan["resident"]),
                                          *extra)
    if smem != plan["smem"]:
        raise RuntimeError(f"{what} kernel: plan of {plan['smem']} bytes of shared "
                           f"memory, the kernel takes {smem}")
    if plan["grid"] > co_resident:
        raise NotImplementedError(
            f"{what} kernel: the tiled plan's {plan['grid']} CTAs ({plan['tiles']} "
            f"tiles of {plan['rows']} rows x {plan['units']} units, clusters of "
            f"{plan['cluster']}) with {smem} bytes of shared memory each exceed the "
            f"{co_resident} the card holds at once")
    return dict(plan, max_co_resident=co_resident)


def _check_probe(what: str, plan: dict, probe: Optional[torch.Tensor], T: int, device) -> None:
    """Raise unless ``probe`` is None or, on the tiled plan, ``1 + 4 * T``
    int64 stamps on the device."""
    if probe is not None and (plan["layout"] != "tiled" or probe.dtype != torch.int64
                              or probe.numel() < 1 + 4 * T or probe.device != device):
        raise ValueError(f"{what}: probe takes 1 + 4 * T int64 stamps on the device, on the "
                         "tiled plan")


def _exchange(plan: dict, ld: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A tiled plan's two exchange buffers for one chunk of rows, rows
    ``ld`` apart, in the compute dtype."""
    return torch.empty((2 * plan["rows"] * plan["row_tiles"] * ld,), dtype=dtype, device=device)


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


def scan_bwd_operands_ref(h0: torch.Tensor, outs: torch.Tensor, dtype: torch.dtype,
                          dx: torch.Tensor, dhn: torch.Tensor, reverse: bool = False,
                          reset: Optional[torch.Tensor] = None):
    """Plain version of the wgmma engine's operand pass: Hs (B*T, H) =
    round(h_prev * keep) and dP (B*T, 3H) = round([dx[..., :2H] | dhn]) in
    ``dtype``, and dbh (3H,) f32, the unrounded column sums of dh_proj."""
    B, T, H = outs.shape
    prev = _prev_states(h0, outs, reverse)
    keep = _keep(reset)
    hs = (prev if keep is None else prev * keep).to(dtype).reshape(B * T, H)
    dhp = torch.cat([dx.float()[..., :2 * H], dhn.float()], -1).reshape(B * T, 3 * H)
    return hs, dhp.to(dtype), dhp.sum(0)


def scan_bwd_products_ref(h0: torch.Tensor, outs: torch.Tensor, Wh: torch.Tensor,
                          bh: torch.Tensor, dx: torch.Tensor, dhn: torch.Tensor,
                          reverse: bool = False, reset: Optional[torch.Tensor] = None):
    """Plain version of row 2's two hoisted products (the wgmma engine's
    operand pass, gate recompute and weight gradient): Hs and dP in Wh's
    dtype (:func:`scan_bwd_operands_ref`), then hp (B,T,3H) = Hs @ Wh + bh
    and dWh (H,3H) = Hs^T dP as f32 products over all (row, t), and dbh
    (3H,) the unrounded column sums of dh_proj. What ``_gru_bwd_kernel``
    forms step by step (gru.py:218 and :249) and
    :func:`gru_layer_scan_bwd_ref` too. Returns (hp, dWh, dbh), f32."""
    B, T, H = outs.shape
    hs, dp, dbh = scan_bwd_operands_ref(h0, outs, Wh.dtype, dx, dhn, reverse, reset)
    hp = hs.float() @ Wh.float() + bh.float()
    return hp.reshape(B, T, 3 * H), hs.float().t() @ dp.float(), dbh


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


# The backward's tiled plan (``gru_tiled_bwd_kernel`` of csrc/gru_scan.cu;
# above 512 units, and below wherever the cluster plan's clusters would run
# in waves). A CTA's tile of the step's product: ``rows`` batch rows x
# ``units`` hidden units in warp tiles of 32 x 32, or on the narrow tiles (16
# rows, or 8 or 16 units) of 16 x 8 (:func:`tiled_warp_tile`); the eight
# warps split K by 8 / warp tiles. 32 x 32 (8 K groups) takes no cluster.
TILED_THREADS = 256
TILED_WARP_TILE = 32
TILED_TILES = ((32, 64), (64, 32), (64, 64), (32, 128), (128, 32), (64, 128), (128, 64),
               (32, 32), (16, 16), (16, 32), (32, 8), (32, 16), (64, 8), (64, 16))
TILED_CLUSTERS = (1, 2, 4)  # CTAs splitting K a tile (a thread-block cluster)
TILED_STAGES = 4  # stages of the K ring (kTiledStages)
TILED_CHUNK = 128  # bytes of one row's K chunk in a stage (kTiledChunk)
TILED_PITCH = TILED_CHUNK + 16  # bytes from one row of a stage to the next
# (Wh's rows resident, the ring's stages): what a backward plan may take.
# One stage (TILED_BWD_WHOLE_K, ``kBwdWholeK``, with Wh resident only): the
# CTA's whole K of the tile's rows of round(dh_proj) each step, one bulk
# copy a row
TILED_BWD_WHOLE_K = 1
TILED_BWD_RINGS = ((True, TILED_BWD_WHOLE_K), (True, TILED_STAGES), (False, TILED_STAGES))
# what the backward's plan assumes of the card when it ranks the tilings
# and rings (not limits; fitted to an H100's µs a step by phase, the
# kernel's probe, at B = 64 and 256, H = 448-2048 in bf16, PERF.md). The
# product through the ring: a K chunk takes the longer of its bytes at
# TILED_L2_SM, the most one SM pulls from L2, and TILED_CHUNK_S with its
# FLOPs at the mma.sync or f32 FMA rate of one SM (TILED_MMA_SM,
# TILED_FMA_SM) and TILED_STEP_S for each k16 step a warp takes in it; all
# SMs together pull at most TILED_L2. On the whole-K stage each K chunk
# TILED_BWD_BULK_CHUNK_S and its bytes at TILED_BWD_BULK_SM, and the
# FLOPs. A step's grid barrier. In a cluster, the gate backward's first
# batch of cells and each cell more a thread (TILED_GATE_FIRST,
# TILED_GATE_CELL) and the sums of the partial products, a step and each
# cell a thread (TILED_SUMS_STEP, TILED_SUMS_CELL); without one the gate
# backward, TILED_BWD_GATE_S and each cell a thread TILED_BWD_GATE_CELL, with
# TILED_BWD_FOLD_GROUP a cell for each K group it adds, and the warps'
# partial products into shared memory behind a CTA barrier
# (TILED_BWD_SYNC_S; on the ring a cluster barrier, TILED_BWD_RING_SYNC_S),
# TILED_BWD_ACC_S for each accumulator a thread past the narrow tiles' 4
TILED_CHUNK_S, TILED_STEP_S, TILED_L2_SM, TILED_L2 = 0.45e-6, 0.035e-6, 25e9, 3.5e12
TILED_BWD_BULK_CHUNK_S, TILED_BWD_BULK_SM = 0.107e-6, 25.5e9
TILED_MMA_SM, TILED_FMA_SM = 4.0e12, 0.35e12
TILED_BARRIER = 1.2e-6
TILED_GATE_FIRST, TILED_GATE_CELL = 1.2e-6, 0.9e-6
TILED_SUMS_STEP, TILED_SUMS_CELL = 2.7e-6, 0.6e-6
TILED_BWD_GATE_S, TILED_BWD_GATE_CELL, TILED_BWD_FOLD_GROUP = 0.45e-6, 0.36e-6, 0.009e-6
TILED_BWD_SYNC_S, TILED_BWD_RING_SYNC_S, TILED_BWD_ACC_S = 0.11e-6, 0.67e-6, 0.058e-6
H100_L2_BYTES = 50 * 2**20


def tiled_kc(dtype: torch.dtype) -> int:
    """Elements of one row's K chunk (``tiled_kc`` of csrc/gru_scan.cu)."""
    return TILED_CHUNK // dtype.itemsize


def tiled_ld(H: int, dtype: torch.dtype) -> int:
    """Row stride of the tiled plan's exchange buffers and laid-out weights
    (``tiled_ld``): 3H padded to a whole K chunk."""
    kc = tiled_kc(dtype)
    return -(-3 * H // kc) * kc


def tiled_k_chunks(H: int, dtype: torch.dtype, cluster: int, rank: int) -> range:
    """The K chunks that CTA ``rank`` of a cluster of ``cluster`` CTAs
    reduces a step: chunk c covers columns [c * kc, (c + 1) * kc) of 3H."""
    nk = -(-3 * H // tiled_kc(dtype))
    return range(rank * nk // cluster, (rank + 1) * nk // cluster)


def tiled_kc_own(H: int, dtype: torch.dtype, cluster: int) -> int:
    """The most K chunks one CTA of a cluster reduces a step."""
    return -(-(-(-3 * H // tiled_kc(dtype))) // cluster)


def tiled_warp_tile(rows: int, units: int) -> Tuple[int, int]:
    """A backward warp's rows and units of its tile (``bwd_warp_m`` and
    ``bwd_warp_n``): 16 x 8 on the narrow tiles (16 rows, or 8 or 16
    units), else 32 x 32."""
    return (16, 8) if rows < 32 or units < 32 else (TILED_WARP_TILE, TILED_WARP_TILE)


def tiled_k_groups(rows: int, units: int) -> int:
    """The K groups the eight warps of a backward CTA split K into: 8 over
    the tile's warp tiles."""
    wm, wn = tiled_warp_tile(rows, units)
    return TILED_THREADS // 32 // ((rows // wm) * (units // wn))


def tiled_smem(rows: int, units: int, cluster: int, resident: bool, kc_own: int,
               stages: int = TILED_STAGES) -> int:
    """Shared memory of a tiled CTA (``TiledLayout``): with ``resident``
    its rows of Wh over its ``kc_own`` K chunks (``units`` rows of kc_own *
    TILED_CHUNK + 16 bytes); the ring of ``stages`` stages of ``rows`` (and
    without ``resident`` ``units`` more) K-chunk rows at TILED_PITCH, or
    (TILED_BWD_WHOLE_K) one stage of ``rows`` rows over all kc_own chunks at
    Wh's pitch; the warps' partial products (K-split groups x rows x (units
    + 4) f32), which take the whole-K stage's bytes; the dh carry and
    dh_part of the cells the CTA owns (rows / cluster x units f32 each);
    with the whole-K stage its mbarrier. The same bytes in every dtype."""
    pitch = kc_own * TILED_CHUNK + 16
    w = units * pitch if resident else 0
    red = tiled_k_groups(rows, units) * rows * (units + 4) * 4
    cells = 2 * (rows // cluster) * units * 4
    if stages == TILED_BWD_WHOLE_K:
        return kernels.align16(w + max(rows * pitch, red) + cells) + 16
    return w + stages * (rows + (0 if resident else units)) * TILED_PITCH + red + cells


def tiled_co_resident(cluster: int, sms: int) -> int:
    """The CTAs of clusters of ``cluster`` CTAs, one CTA an SM, that the
    plan counts on a card of ``sms`` SMs holding at once: every SM alone,
    SM pairs in twos, and in fours all but 3 quads (an H100 SXM held 30
    clusters of 4 at once, 120 of its 132 SMs: its GPCs leave SMs that no
    quad takes). The wrapper asks the card."""
    if cluster == 1:
        return sms
    if cluster == 2:
        return sms // 2 * 2
    return max(0, sms // 4 - 3) * 4


def _tiled_cost(B: int, H: int, dtype: torch.dtype, plan: dict) -> float:
    """What the backward's plan ranks tilings and rings by: seconds a call
    takes per step of the time axis, its launches' steps by phase
    (:func:`tiled_bwd_phases`) summed."""
    return plan["chunks"] * sum(tiled_bwd_phases(B, H, dtype, plan))


def tiled_bwd_phases(B: int, H: int, dtype: torch.dtype, plan: dict) -> Tuple[float, ...]:
    """Seconds a step of one launch of the backward's tiled plan by phase, as
    its probe splits it: the gate backward (with the K groups' sums without
    a cluster), the grid barrier, the product (the busiest CTA's K chunks
    through its ring, dh_proj's rows and Wh's where they are not resident,
    or its whole K's bulk copies; and its FLOPs) and the sums of a
    cluster's partial products (TILED_* constants)."""
    rows, units, cluster = plan["rows"], plan["units"], plan["cluster"]
    mma = kernels.mma_dtype(dtype)
    nk = tiled_kc_own(H, dtype, cluster)
    busy_rows, busy_units = min(rows, B), min(units, H)
    flops = 2.0 * rows * units * nk * tiled_kc(dtype) / (TILED_MMA_SM if mma else TILED_FMA_SM)
    whole = plan["stages"] == TILED_BWD_WHOLE_K
    wm, wn = tiled_warp_tile(rows, units)
    if whole:
        product = nk * (TILED_BWD_BULK_CHUNK_S + busy_rows * TILED_CHUNK / TILED_BWD_BULK_SM) \
            + flops
    else:
        ring_rows = busy_rows + (0 if plan["resident"] else busy_units)
        steps = -(-tiled_kc(dtype) // (16 if mma else 4) // tiled_k_groups(rows, units))
        chunk = max(ring_rows * TILED_CHUNK / TILED_L2_SM,
                    TILED_CHUNK_S + flops / nk + steps * TILED_STEP_S)
        product = max(nk * chunk, plan["grid"] * ring_rows * nk * TILED_CHUNK / TILED_L2)
    cells = -(-busy_rows * busy_units // (cluster * TILED_THREADS))
    if cluster > 1:
        gate = TILED_GATE_FIRST + TILED_GATE_CELL * max(0, cells - 4)
        sums = TILED_SUMS_STEP + TILED_SUMS_CELL * cells
    else:
        gate = TILED_BWD_GATE_S + cells * (TILED_BWD_GATE_CELL + TILED_BWD_FOLD_GROUP
                                           * tiled_k_groups(rows, units))
        sums = (TILED_BWD_SYNC_S if whole else TILED_BWD_RING_SYNC_S) \
            + TILED_BWD_ACC_S * (wm * wn // 32 - 4)
    return gate, TILED_BARRIER, product, sums


def _tiled_plan(B: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    """The backward's tiled plan for B rows and H units on a card of ``sms``
    SMs: of the tilings and rings whose grid the card holds at once
    (TILED_TILES x TILED_CLUSTERS x TILED_BWD_RINGS), the one
    :func:`_tiled_cost` ranks first (then the smaller grid). Each CTA owns
    ``rows`` x ``units`` cells of a chunk of ``rows * row_tiles`` batch rows
    for the whole call (``chunks`` launches a call); ``cluster`` CTAs split
    K = 3H a tile. Wh's rows are read in place where 3H elements are a
    whole number of 16-byte pieces (``in_place``), else laid out once a call
    (:func:`_tiled_weights`); a CTA's rows of them stay in its shared memory
    where they fit (``resident``), and ``wh_from`` says where they come
    from: shared memory, L2, or device memory every step."""
    B = max(B, 1)
    best = None
    for rows, units in TILED_TILES:
        for cluster in TILED_CLUSTERS:
            for ring in TILED_BWD_RINGS:
                plan = tiled_plan_for(B, H, dtype, sms, rows, units, cluster, (ring,))
                if plan is None:
                    continue
                key = (_tiled_cost(B, H, dtype, plan), plan["grid"])
                if best is None or key < best[0]:
                    best = (key, plan)
    if best is None:
        raise NotImplementedError(f"gru_layer_scan_bwd kernel: no tiling of {H} units fits "
                                  f"the card's {sms} SMs at once")
    return best[1]


def tiled_valid(rows: int, units: int, cluster: int) -> bool:
    """Whether the backward kernel takes a tile of ``rows`` x ``units`` in
    clusters of ``cluster`` (``valid_tile``): 8 K groups (32 x 32) only
    without a cluster, as a cluster's sums pass adds at most 4."""
    return (rows, units) in TILED_TILES and cluster in TILED_CLUSTERS and \
        (cluster == 1 or tiled_k_groups(rows, units) <= 4)


def tiled_plan_for(B: int, H: int, dtype: torch.dtype, sms: int, rows: int, units: int,
                   cluster: int, rings=TILED_BWD_RINGS) -> Optional[dict]:
    """The tiled plan of one tiling: as many row tiles a launch as the card
    holds at once with the unit tiles and clusters (at most the batch's),
    ``chunks`` launches for B rows; of ``rings``, the first (``resident``,
    ``stages``) whose shared memory fits (by default Wh's rows resident
    beside the whole K of the tile's rows of dh_proj, else beside a ring of
    4 stages, else a ring of 4 stages that brings them); None where the
    tiling is not the kernel's, or the grid of one row tile or the shared
    memory does not fit the card."""
    if H < 1 or not tiled_valid(rows, units, cluster):
        return None
    B = max(B, 1)
    unit_tiles = -(-H // units)
    most = tiled_co_resident(cluster, sms) // (unit_tiles * cluster)
    kc_own = tiled_kc_own(H, dtype, cluster)
    for resident, stages in rings:
        smem = tiled_smem(rows, units, cluster, resident, kc_own, stages)
        if smem <= kernels.SMEM_PER_BLOCK:
            break
    else:
        return None
    if most < 1:
        return None
    row_tiles = min(-(-B // rows), most)
    grid = row_tiles * unit_tiles * cluster
    kc = tiled_kc(dtype)
    in_place = 3 * H * dtype.itemsize % 16 == 0
    wh_bytes = H * (3 * H if in_place else tiled_ld(H, dtype)) * dtype.itemsize
    return dict(layout="tiled", rows=rows, units=units, cluster=cluster, unit_tiles=unit_tiles,
                row_tiles=row_tiles, tiles=unit_tiles * row_tiles, grid=grid, ctas=grid,
                chunks=-(-B // (rows * row_tiles)), stages=stages, resident=resident,
                kc=kc, k_chunks=-(-3 * H // kc), ldx=tiled_ld(H, dtype), in_place=in_place,
                wh_from="smem" if resident else "l2" if wh_bytes <= H100_L2_BYTES else "hbm",
                smem=smem)


def _tiled_weights(Wh: torch.Tensor, plan: dict) -> Optional[torch.Tensor]:
    """Wh's rows for the tiled backward: None where the kernel reads Wh in
    place, else Wh (H, 3H) padded to rows of ``plan["ldx"]`` (zero past
    3H), so that each row's K chunks are whole 16-byte pieces."""
    if plan["in_place"]:
        return None
    H = Wh.shape[0]
    wt = Wh.new_zeros((H, plan["ldx"]))
    wt[:, :3 * H] = Wh
    return wt


# The forward's tiled plan (``gru_tiled_fwd_kernel`` of csrc/gru_scan.cu).
# A CTA's tile of the step's product: ``rows`` batch rows x ``units`` hidden
# units, whose N is its units' 3 * units r, z and n columns, in warp tiles of
# 32 rows x 48 columns (16 x 24 at 8 units); the eight warps split K by 8 /
# warp tiles.
TILED_FWD_WARP_N = 48
TILED_FWD_TILES = ((32, 8), (64, 8), (128, 8), (64, 16), (128, 16), (32, 32), (32, 64),
                   (64, 32), (64, 64), (32, 128), (128, 32))
# (Wh's columns resident, the ring's stages): what a plan may take. One
# stage (TILED_FWD_WHOLE_K, ``kFwdWholeK``, with Wh resident only, the one
# tiles of 8 units take): the CTA's whole K of the tile's state rows each
# step, one bulk copy a row
TILED_FWD_WHOLE_K = 1
TILED_FWD_RINGS = ((True, TILED_FWD_WHOLE_K), (True, TILED_STAGES), (False, TILED_STAGES),
                   (False, 2))
# what the forward's plan assumes of the card when it ranks the tilings and
# rings (not limits; fitted to an H100's µs a step by phase, the kernel's
# probe, of every tiling and ring at B = 32-256, H = 512-1024 in bf16,
# PERF.md; f32 keeps the backward's FMA rate): the product through a ring,
# TILED_FWD_PRODUCT_S, then each K chunk TILED_FWD_CHUNK_S (with 4 stages;
# 3/(stages - 1) of it with fewer) and its bytes at TILED_FWD_L2_SM, plus
# its FLOPs at TILED_FWD_MMA_SM (the loads and mma.sync work add up rather
# than overlap); the product on the whole-K stage, TILED_FWD_BULK_S, then
# each K chunk TILED_FWD_BULK_CHUNK_S and its bytes at TILED_FWD_BULK_SM,
# and its FLOPs at TILED_FWD_MMA_SM; in a cluster the sums of the partial
# products, TILED_FWD_SUMS_S, TILED_FWD_SUMS_CELL each cell a thread and
# TILED_FWD_SPLIT_S for each halving of K across it; the gates,
# TILED_FWD_GATE_CELL each cell a thread and, without a cluster,
# TILED_FWD_GATE_GROUP each K group more they add; the grid barrier and the
# step's fixed part, TILED_FWD_STEP_S
TILED_FWD_PRODUCT_S, TILED_FWD_CHUNK_S, TILED_FWD_L2_SM = 1.89e-6, 0.044e-6, 39.5e9
TILED_FWD_BULK_S, TILED_FWD_BULK_CHUNK_S, TILED_FWD_BULK_SM = 1.30e-6, 0.085e-6, 43.5e9
TILED_FWD_MMA_SM = 4.65e12
TILED_FWD_SUMS_S, TILED_FWD_SUMS_CELL, TILED_FWD_SPLIT_S = 2.28e-6, 0.131e-6, 0.234e-6
TILED_FWD_GATE_CELL, TILED_FWD_GATE_GROUP, TILED_FWD_STEP_S = 0.47e-6, 0.029e-6, 1.29e-6


def tiled_fwd_k_chunks(H: int, dtype: torch.dtype, cluster: int, rank: int) -> range:
    """The K chunks that CTA ``rank`` of a cluster of ``cluster`` CTAs
    reduces a step in the forward: chunk c covers k in [c * kc, (c + 1) *
    kc) of H."""
    nk = -(-H // tiled_kc(dtype))
    return range(rank * nk // cluster, (rank + 1) * nk // cluster)


def tiled_fwd_kc_own(H: int, dtype: torch.dtype, cluster: int) -> int:
    """The most K chunks one CTA of a cluster reduces a step in the forward."""
    return -(-(-(-H // tiled_kc(dtype))) // cluster)


def tiled_fwd_warp_tile(units: int) -> Tuple[int, int]:
    """A forward warp's rows and columns of its tile (``fwd_warp_m`` and
    ``fwd_warp_n``): 32 x 48, or 16 x 24 at 8 units (a tile N of 24), so
    that a tile of 32 rows still leaves each warp a K group of its own."""
    return (16, 24) if units == 8 else (TILED_WARP_TILE, TILED_FWD_WARP_N)


def tiled_fwd_k_groups(rows: int, units: int) -> int:
    """The K groups the eight warps of a forward CTA split K into: 8 over
    the tile's warp tiles."""
    wm, wn = tiled_fwd_warp_tile(units)
    return TILED_THREADS // 32 // ((rows // wm) * (3 * units // wn))


def tiled_fwd_smem(rows: int, units: int, cluster: int, resident: bool, stages: int,
                   kc_own: int, dtype: torch.dtype) -> int:
    """Shared memory of a forward tiled CTA (``TiledFwdLayout``): with
    ``resident`` the tile's columns of Wh over its ``kc_own`` K chunks
    (kc_own * kc k-rows of 3 * units elements, 16 bytes more apart); the ring
    of ``stages`` stages of ``rows`` K-chunk rows at TILED_PITCH (and without
    ``resident`` kc k-rows of Wh's columns); the warps' partial products
    (K-split groups x rows x (3 * units + 4) f32), which with ``resident``
    take the ring's bytes; the units' biases and the carry of the cells the
    CTA owns (rows / cluster x units), f32."""
    kc = tiled_kc(dtype)
    wk = tiled_fwd_k_groups(rows, units)
    w_pitch = 3 * units * dtype.itemsize + 16
    if stages == TILED_FWD_WHOLE_K:  # one stage of the whole K, and an mbarrier
        ring = rows * (kc_own * TILED_CHUNK + 16)
    else:
        ring = stages * (rows * TILED_PITCH + (0 if resident else kc * w_pitch))
    red = wk * rows * (3 * units + 4) * 4
    w = kc_own * kc * w_pitch if resident else 0
    total = (w + (max(ring, red) if resident else ring + red)
             + (3 * units + (rows // cluster) * units) * 4)
    return kernels.align16(total) + 16 if stages == TILED_FWD_WHOLE_K else total


def _tiled_fwd_cost(B: int, H: int, dtype: torch.dtype, plan: dict) -> float:
    """What the forward's plan ranks tilings by: seconds a call takes per
    step of the time axis, its launches' steps by phase
    (:func:`tiled_fwd_phases`) summed."""
    return plan["chunks"] * sum(tiled_fwd_phases(B, H, dtype, plan))


def tiled_fwd_phases(B: int, H: int, dtype: torch.dtype, plan: dict) -> Tuple[float, ...]:
    """Seconds a step of one launch of the forward's tiled plan by phase, as
    its probe splits it: the product (the busiest CTA's K chunks through its
    ring, state rows and Wh's k-rows where they are not resident, or its
    whole K's bulk copies; and its FLOPs), the sums of the partial products,
    the gates, and the grid barrier with the step's fixed part (TILED_FWD_*
    constants)."""
    rows, units, cluster = plan["rows"], plan["units"], plan["cluster"]
    kc = tiled_kc(dtype)
    nk = tiled_fwd_kc_own(H, dtype, cluster)
    busy_rows, busy_units = min(rows, B), min(units, H)
    chunk = busy_rows * TILED_CHUNK + (0 if plan["resident"]
                                       else kc * 3 * busy_units * dtype.itemsize)
    flops = 2.0 * rows * 3 * units * nk * kc / (TILED_FWD_MMA_SM if kernels.mma_dtype(dtype)
                                                else TILED_FMA_SM)
    if plan["stages"] == TILED_FWD_WHOLE_K:
        product = (TILED_FWD_BULK_S + nk * (TILED_FWD_BULK_CHUNK_S + chunk / TILED_FWD_BULK_SM)
                   + flops)
    else:
        latency = TILED_FWD_CHUNK_S * (TILED_STAGES - 1) / (plan["stages"] - 1)
        product = TILED_FWD_PRODUCT_S + nk * (latency + chunk / TILED_FWD_L2_SM) + flops
    cells = -(-busy_rows * busy_units // (cluster * TILED_THREADS))
    # a cluster adds its partial products in a pass of their own; without
    # one the gates add the K groups'
    groups = 1 if cluster > 1 else tiled_fwd_k_groups(rows, units)
    sums = (cluster > 1) * (TILED_FWD_SUMS_S + TILED_FWD_SUMS_CELL * cells
                            + TILED_FWD_SPLIT_S * math.log2(cluster))
    gates = cells * (TILED_FWD_GATE_CELL + TILED_FWD_GATE_GROUP * (groups - 1))
    return product, sums, gates, TILED_FWD_STEP_S


def tiled_fwd_plan(B: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    """The forward's tiled plan for B rows and H units on a card of ``sms``
    SMs: of the tilings and rings whose grid the card holds at once
    (TILED_FWD_TILES x TILED_CLUSTERS x TILED_FWD_RINGS), the one
    :func:`_tiled_fwd_cost` ranks first (then the smaller grid)."""
    B = max(B, 1)
    best = None
    for rows, units in TILED_FWD_TILES:
        for cluster in TILED_CLUSTERS:
            for ring in TILED_FWD_RINGS:
                plan = tiled_fwd_plan_for(B, H, dtype, sms, rows, units, cluster, (ring,))
                if plan is None:
                    continue
                key = (_tiled_fwd_cost(B, H, dtype, plan), plan["grid"])
                if best is None or key < best[0]:
                    best = (key, plan)
    if best is None:
        raise NotImplementedError(f"gru_layer_scan kernel: no tiling of {H} units fits the "
                                  f"card's {sms} SMs at once")
    return best[1]


def tiled_fwd_plan_for(B: int, H: int, dtype: torch.dtype, sms: int, rows: int, units: int,
                       cluster: int, rings=TILED_FWD_RINGS) -> Optional[dict]:
    """The forward's tiled plan of one tiling: as many row tiles a launch as
    the card holds at once with the unit tiles and clusters (at most the
    batch's), ``chunks`` launches for B rows; of ``rings``, the first
    (``resident``, ``stages``) whose shared memory fits (by default the
    tile's columns of Wh resident there beside the whole K of its state
    rows, else beside a ring of 4 stages; else a ring of 4 stages that
    brings them, else of 2); None where the grid of one row tile or the
    shared memory does not fit the card. Each CTA owns ``rows`` x ``units``
    cells of a chunk of ``rows * row_tiles`` batch rows for the whole call;
    ``cluster`` CTAs split K = H a tile. Wh is read in place where each gate's columns start on a 16-byte
    piece (``in_place``), else from a copy whose gates are ``ldg`` columns
    apart (:func:`_tiled_fwd_weights`); ``wh_from`` says where a step's
    weights come from: shared memory, L2, or device memory every step."""
    if H < 1:
        return None
    B = max(B, 1)
    unit_tiles = -(-H // units)
    most = tiled_co_resident(cluster, sms) // (unit_tiles * cluster)
    kc_own = tiled_fwd_kc_own(H, dtype, cluster)
    for resident, stages in rings:
        if units == 8 and stages != TILED_FWD_WHOLE_K:
            continue  # 8-unit tiles take the whole-K stage only (valid_fwd_tile)
        smem = tiled_fwd_smem(rows, units, cluster, resident, stages, kc_own, dtype)
        if smem <= kernels.SMEM_PER_BLOCK:
            break
    else:
        return None
    if most < 1:
        return None
    row_tiles = min(-(-B // rows), most)
    grid = row_tiles * unit_tiles * cluster
    kc, per = tiled_kc(dtype), 16 // dtype.itemsize
    in_place = H % per == 0
    ldg = -(-H // per) * per
    return dict(layout="tiled", rows=rows, units=units, cluster=cluster, unit_tiles=unit_tiles,
                row_tiles=row_tiles, tiles=unit_tiles * row_tiles, grid=grid, ctas=grid,
                chunks=-(-B // (rows * row_tiles)), stages=stages, resident=resident, kc=kc,
                k_chunks=-(-H // kc), ldx=-(-H // kc) * kc, ldg=ldg, in_place=in_place,
                wh_from="smem" if resident else "l2" if H * 3 * ldg * dtype.itemsize
                <= H100_L2_BYTES else "hbm", smem=smem)


def _tiled_fwd_weights(Wh: torch.Tensor, plan: dict) -> Optional[torch.Tensor]:
    """Wh for the tiled forward: None where the kernel reads Wh in place,
    else Wh (H, 3H) with each gate's H columns padded to ``plan["ldg"]``
    (zero past H), (H, 3 * ldg), so that every gate starts on a 16-byte
    piece."""
    if plan["in_place"]:
        return None
    H = Wh.shape[0]
    wt = Wh.new_zeros((H, 3, plan["ldg"]))
    wt[:, :, :H] = Wh.view(H, 3, H)
    return wt.view(H, 3 * plan["ldg"])


def scan_kernel_holds(H: int, dtype: torch.dtype) -> bool:
    """Whether both scan kernels (forward and backward) compute a layer of
    H units in ``dtype`` at every batch size on an H100's 132 SMs. Up to 512
    units on clusters (16 CTAs of 32 units, the largest cluster) with both
    CTAs' shared memory within the card's; above, both tiled plans, where a
    tiling's grid fits the card (a tile's shared memory stops growing with
    H once Wh streams through its ring; :func:`tiled_fwd_plan` and
    :func:`_tiled_plan` find one for every H to 16896 units). ``UniGRU``
    sends every ``use_pallas`` GRU layer to the kernels, as JAX sends it to
    the Pallas scan."""
    if dtype not in kernels.DTYPE_CODE or H < 1:
        return False
    if H > SCAN_CLUSTER_MAX_HIDDEN:
        return all(any(plan_for(1, H, dtype, H100_SMS, rows, units, cluster) is not None
                       for rows, units in tiles for cluster in TILED_CLUSTERS)
                   for plan_for, tiles in ((tiled_fwd_plan_for, TILED_FWD_TILES),
                                           (tiled_plan_for, TILED_TILES)))
    cluster, units = _cluster_units("gru_layer_scan", H)
    return (_fwd_smem(H, dtype, SCAN_FWD_FEW_SLOTS) <= kernels.SMEM_PER_BLOCK
            and _bwd_smem(H, dtype, units, _bwd_rows(H, dtype, units))
            <= kernels.SMEM_PER_BLOCK)


# The forward's choice between its plans up to 512 units. Clusters of the
# cluster plan that an H100 SXM (132 SMs) holds at once, by (CTAs a
# cluster, CTAs an SM by shared memory; at most FWD_CLUSTER_CTAS_PER_SM):
# the card's own count (cudaOccupancyMaxActiveClusters of the cluster
# kernel at H = 32 to 512 in bf16 and f32, ``kernel_times.py -crossover``,
# PERF.md). Clusters above 8 CTAs are placed within a GPC, so 7 of 15 or 16
# CTAs fit at once (112 SMs).
H100_FWD_CLUSTERS = {
    (1, 3): 396, (2, 3): 198, (3, 3): 124, (4, 3): 92, (5, 3): 69, (6, 3): 62, (7, 3): 47,
    (8, 3): 45, (5, 2): 47, (6, 2): 39, (7, 2): 32, (9, 2): 23, (10, 2): 21, (11, 2): 16,
    (12, 2): 16, (13, 2): 14, (14, 2): 14, (8, 1): 15, (9, 1): 9, (10, 1): 7, (11, 1): 7,
    (12, 1): 7, (13, 1): 7, (14, 1): 7, (15, 1): 7, (16, 1): 7}
FWD_CLUSTER_CTAS_PER_SM = 3  # what the cluster kernel's registers allow an SM
H100_SMEM_PER_SM = 233_472  # an SM's shared memory, 1 KB of it reserved per CTA


def fwd_cluster_waves(plan: dict, sms: int) -> int:
    """The waves of the forward's cluster ``plan`` on a card of ``sms`` SMs:
    its clusters over those the plan counts on the card holding at once (an
    H100's count, H100_FWD_CLUSTERS, by CTAs a cluster and the CTAs an SM's
    shared memory takes; 7/8 of its SMs where it has none; in proportion to
    the SMs). The wrapper asks the card for the count."""
    cluster = plan["cluster"]
    per_sm = max(1, min(FWD_CLUSTER_CTAS_PER_SM, H100_SMEM_PER_SM // (plan["smem"] + 1024)))
    held = H100_FWD_CLUSTERS.get((cluster, per_sm), per_sm * H100_SMS * 7 // (8 * cluster))
    return -(-plan["clusters"] // max(1, held * sms // H100_SMS))


# The backward's choice between its plans up to 512 units: clusters of the
# backward's cluster plan that an H100 SXM (132 SMs) holds at once, by (CTAs
# a cluster, CTAs an SM by shared memory; at most BWD_CLUSTER_CTAS_PER_SM):
# the card's own count (cudaOccupancyMaxActiveClusters of the backward
# cluster kernel at H = 32 to 512 in bf16 and f32, ``kernel_times.py
# -crossover -bwd``, PERF.md). Clusters of 15 and 16 CTAs, whose CTAs take
# an SM each from 449 units, fit 7 at once.
H100_BWD_CLUSTERS = {
    (1, 4): 528, (2, 4): 264, (3, 4): 163, (4, 4): 124, (5, 4): 94, (6, 4): 79, (7, 3): 47,
    (8, 3): 45, (9, 3): 37, (4, 3): 92, (10, 2): 21, (11, 2): 16, (12, 2): 16, (13, 2): 14,
    (14, 2): 14, (5, 2): 47, (6, 2): 39, (7, 2): 32, (8, 1): 15, (9, 1): 9, (10, 1): 7,
    (11, 1): 7, (12, 1): 7, (13, 1): 7, (14, 1): 7, (15, 1): 7, (16, 1): 7}
BWD_CLUSTER_CTAS_PER_SM = 4  # what the backward cluster kernel's registers allow an SM


def bwd_cluster_waves(plan: dict, sms: int) -> int:
    """The waves of the backward's cluster ``plan`` on a card of ``sms``
    SMs: its clusters over those the plan counts on the card holding at once
    (an H100's count, H100_BWD_CLUSTERS, by CTAs a cluster and the CTAs an
    SM's shared memory takes; 7/8 of its SMs where it has none; in
    proportion to the SMs). The wrapper asks the card for the count."""
    cluster = plan["cluster"]
    per_sm = max(1, min(BWD_CLUSTER_CTAS_PER_SM, H100_SMEM_PER_SM // (plan["smem"] + 1024)))
    held = H100_BWD_CLUSTERS.get((cluster, per_sm), per_sm * H100_SMS * 7 // (8 * cluster))
    return -(-plan["clusters"] // max(1, held * sms // H100_SMS))


def scan_fwd_plan(B: int, T: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    """Launch plan of the forward for B rows, T steps and H units on a card
    of ``sms`` SMs. Up to 512 units, where its clusters run in one wave
    (``layout`` ``"cluster"``): clusters of ``cluster`` CTAs (up to 16),
    each owning ``units`` hidden units of ``rows`` batch rows, with
    ``smem`` bytes of dynamic shared memory per CTA (:func:`_fwd_smem`,
    mirrors ``FwdLayout`` of csrc/gru_scan.cu). ``rows`` is 4 while the grid
    fits one CTA an SM of the card, else 8 (the mma's columns); in f32 also
    4 where 8 row slots do not fit (H > 448). Above 512 units, and wherever
    the cluster plan's clusters would not all fit the card at once
    (:func:`fwd_cluster_waves`), the tiled plan (:func:`tiled_fwd_plan`,
    ``layout`` ``"tiled"``): on an H100 each further wave of the cluster
    plan took about as long as the first, while the tiled plan's grid runs
    in one (the crossover sweep of both plans, ``kernel_times.py
    -crossover``, bf16 and f32, B = 32 to 1024, H = 128 to 512: the rule
    picked the faster plan in 154 of 156 cells, missing by 6% and 12% at
    f32's B = 64, H = 288 and B = 512, H = 128, where one wave of clusters
    lost too; PERF.md). Raises
    NotImplementedError for what the design cannot hold. Each call returns
    a copy of a plan cached by B, H, dtype and SMs (ranking the tilings
    takes a call's launch time over again)."""
    return dict(_scan_fwd_plan(B, H, dtype, sms))


@functools.cache
def _scan_fwd_plan(B: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    kernels.dtype_code("gru_layer_scan", dtype)
    if H > SCAN_CLUSTER_MAX_HIDDEN:
        return tiled_fwd_plan(B, H, dtype, sms)
    plan = _cluster_fwd_plan(B, H, dtype, sms)
    if fwd_cluster_waves(plan, sms) > 1:
        return tiled_fwd_plan(B, H, dtype, sms)
    return plan


def _cluster_fwd_plan(B: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    """The forward's cluster plan (:func:`scan_fwd_plan`, H up to 512)."""
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


# Row 2's hoisted products (a) and (c). The "wgmma" engine (bf16 and f16;
# csrc/wgmma_gemm.cuh): tiles of GEMM_BM x bn (GEMM_BNS) through a ring of
# GEMM_STAGES stages of GEMM_BK-deep K slices, which TMA fills in boxes of at
# most TMA_BOX rows of 64 values (128 bytes); Hs and dP written by an operand
# pass with rows padded to 8 values; dP's column sums (dbh) in blocks of
# OPERAND_ROWS rows. The "tile" engine (f32, whose products JAX does not
# take in TF32): tile_gemm.cuh's 64 x 64 tiles of FMAs.
GEMM_BM, GEMM_BK = 128, 64  # kWgBM, kWgBK
GEMM_BNS = (128, 256)
GEMM_STAGES = 4
GEMM_THREADS = 384  # kWgThreads: a producer warpgroup, two consumer warpgroups
GEMM_MAX_SPLITS = 8  # most CTAs that split dWh's K a tile
GEMM_SPLIT_MIN_K = 4  # fewest K slices a split takes
TMA_BOX = 256  # most rows (and values) of a TMA box a side
OPERAND_ROWS = 128  # kOperandRows
TILE_GEMM = 64  # tile_gemm.cuh's tile side


def pad8(n: int) -> int:
    """n padded to a multiple of 8 values (``pad8`` of csrc/gru_scan.cu): a
    16-bit row of whole 16-byte pieces, as TMA addresses it."""
    return -(-n // 8) * 8


def gemm_smem(bn: int, stages: int) -> int:
    """Dynamic shared memory of a wgmma product CTA (``wg_smem``): 1 KB to
    align the ring to the 1024-byte swizzle pattern, ``stages`` stages of A's
    128 x 64 and B's 64 x bn 16-bit values, two mbarriers a stage."""
    return 1024 + stages * (GEMM_BM + bn) * GEMM_BK * 2 + 2 * stages * 8


def gemm_k_splits(k_slices: int, splits: int) -> list:
    """The K slices that each of ``splits`` CTAs of a dWh tile reduces, in
    the order the last CTA adds their partials (``wgmma_gemm_kernel``)."""
    return [range(s * k_slices // splits, (s + 1) * k_slices // splits) for s in range(splits)]


def products_engine(dtype: torch.dtype) -> str:
    """The engine of row 2's products, which the dtype alone picks:
    ``"tile"`` in f32, ``"wgmma"`` in bf16 and f16."""
    return "wgmma" if kernels.mma_dtype(dtype) else "tile"


def products_plan(B: int, T: int, H: int, dtype: torch.dtype, sms: int, tiled: bool) -> dict:
    """The products' part of the backward's plan on the ``engine`` of
    :func:`products_engine`. ``"tile"``:
    dWh's 64 x 64 tiles (``dwh_tiles``), each split over ``dwh_splits``
    blocks along K = B*T (1 on the tiled plan, whose 243 or more tiles fill
    the card). ``"wgmma"``: tiles of 128 x ``gemm_bn`` (256 where (a)'s tiles
    at 256 fill the card), ``gemm_stages`` stages, ``gemm_smem`` bytes a
    CTA; Hs and dP rows ``ld_h`` and ``ld_3h`` apart, Wh copied to rows of
    ``ld_3h`` where (on the cluster plan) its own are not whole 16-byte
    pieces (``wh_copy``); the TMA ``boxes`` (rows, values), dWh's K slices
    split over ``dwh_splits`` CTAs a tile where its tiles would leave more
    than half the SMs idle (:func:`gemm_k_splits`); scratch of
    ``partial_floats`` floats and ``counters`` ints."""
    M, N = B * T, 3 * H
    if products_engine(dtype) == "tile":
        tiles = -(-H // TILE_GEMM) * -(-N // TILE_GEMM)
        splits = 1 if tiled else max(1, min(8, -(-M // 32) // 4))
        return dict(engine="tile", dwh_tiles=tiles, dwh_splits=splits,
                    partial_floats=tiles * splits * TILE_GEMM ** 2 if splits > 1 else 1,
                    counters=tiles)
    tiles_of = lambda m, bn: -(-m // GEMM_BM) * -(-N // bn)  # noqa: E731
    bn = GEMM_BNS[1] if tiles_of(M, GEMM_BNS[1]) >= sms else GEMM_BNS[0]
    k_slices = -(-M // GEMM_BK)
    tiles = tiles_of(H, bn)
    # dWh's split where its tiles leave most SMs idle: the fewest CTAs a
    # tile whose waves over the card take the least time, each CTA's share
    # of K being 1 / splits of it
    most = 1 if 2 * tiles >= sms else max(1, min(GEMM_MAX_SPLITS, k_slices // GEMM_SPLIT_MIN_K))
    splits = min(range(1, most + 1), key=lambda n: (-(-tiles * n // sms) / n, n))
    chunks = -(-M // OPERAND_ROWS)
    strips = -(-pad8(N) // 32)
    return dict(engine="wgmma", gemm_bm=GEMM_BM, gemm_bn=bn, gemm_bk=GEMM_BK,
                gemm_stages=GEMM_STAGES, gemm_smem=gemm_smem(bn, GEMM_STAGES),
                ld_h=pad8(H), ld_3h=pad8(N), wh_copy=not tiled and N * dtype.itemsize % 16 != 0,
                boxes={"hs": (GEMM_BM, GEMM_BK), "hs_t": (GEMM_BK, 64), "wh": (GEMM_BK, 64),
                       "dp": (GEMM_BK, 64)},
                hoist_tiles=tiles_of(M, bn), dwh_tiles=tiles, dwh_splits=splits,
                k_slices=k_slices, operand_chunks=chunks,
                partial_floats=max(tiles * splits * GEMM_BM * bn if splits > 1 else 1,
                                   chunks * N),
                counters=tiles + strips)


def scan_bwd_plan(B: int, T: int, H: int, dtype: torch.dtype, sms: int = H100_SMS) -> dict:
    """Launch plan of the backward for B rows, T steps and H units on a
    card of ``sms`` SMs. Up to 512 units, where its clusters run in one wave
    (``layout`` ``"cluster"``): clusters of ``cluster`` CTAs (up to 16),
    each owning ``units`` hidden units of ``rows`` batch rows (4, or 2 in
    f32 above 448 units), with ``smem`` bytes of dynamic shared memory per
    CTA (:func:`_bwd_smem`, mirrors ``ScanLayout`` of csrc/gru_scan.cu).
    Above 512 units, and wherever the cluster plan's clusters would not all
    fit the card at once (:func:`bwd_cluster_waves`), the tiled plan
    (:func:`_tiled_plan`, ``layout`` ``"tiled"``), as the forward's rule
    (:func:`scan_fwd_plan`) does. All with the hoisted products' plan
    (:func:`products_plan`). Raises NotImplementedError for what the design
    cannot hold. Cached as :func:`scan_fwd_plan` is."""
    return dict(_scan_bwd_plan(B, T, H, dtype, sms))


@functools.cache
def _scan_bwd_plan(B: int, T: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    kernels.dtype_code("gru_layer_scan_bwd", dtype)
    if H > SCAN_CLUSTER_MAX_HIDDEN:
        return tiled_bwd_plan(B, T, H, dtype, sms)
    plan = _cluster_bwd_plan(B, H, dtype, sms)
    if bwd_cluster_waves(plan, sms) > 1:
        return tiled_bwd_plan(B, T, H, dtype, sms)
    return dict(plan, **products_plan(B, T, H, dtype, sms, False))


def tiled_bwd_plan(B: int, T: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    """The backward's tiled plan (:func:`_tiled_plan`) with its products'
    plan: what :func:`scan_bwd_plan` takes above 512 units and wherever the
    cluster plan runs in waves."""
    return dict(_tiled_plan(B, H, dtype, sms), **products_plan(B, T, H, dtype, sms, True))


def _cluster_bwd_plan(B: int, H: int, dtype: torch.dtype, sms: int) -> dict:
    """The backward's cluster plan (:func:`scan_bwd_plan`, H up to 512),
    without its products' plan."""
    cluster, units = _cluster_units("gru_layer_scan_bwd", H)
    rows = _bwd_rows(H, dtype, units)
    smem = _bwd_smem(H, dtype, units, rows)
    if smem > kernels.SMEM_PER_BLOCK:
        raise NotImplementedError(f"gru_layer_scan_bwd kernel: {smem} bytes of shared memory "
                                  f"per CTA exceed {kernels.SMEM_PER_BLOCK}")
    clusters = -(-B // rows)
    return dict(layout="cluster", cluster=cluster, rows=rows, units=units, clusters=clusters,
                ctas=clusters * cluster, smem=smem)


class LaunchCount:
    """The launch count of a kernel that wrappers run inside their calls
    (row 2's operand pass and wgmma product): ``launches``, as each
    wrapper's own, under the kernel's ``__name__``."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


scan_bwd_operands = LaunchCount("scan_bwd_operands")  # the operand pass: two launches a call
wgmma_gemm = LaunchCount("wgmma_gemm")  # (a) and (c): two launches a call


SCRATCH_ALIGN = 256  # bytes between the parts of the products' scratch (TMA takes 16)


def _products_scratch(plan: dict, B: int, T: int, H: int, dt: torch.dtype, device):
    """((Hs, dP, Wh's copy, partials) addresses, zeroed counters, the tensor
    that holds the four) of the products' ``plan``: Hs, dP and the copy
    None on the tile engine, the copy None where the plan needs none. One
    allocation of SCRATCH_ALIGN-aligned parts holds the four: each
    allocation costs host time, which a small call pays in full."""
    size = dt.itemsize
    parts = [B * T * plan.get("ld_h", 0) * size, B * T * plan.get("ld_3h", 0) * size,
             H * plan["ld_3h"] * size if plan.get("wh_copy") else 0, plan["partial_floats"] * 4]
    spans = [-(-n // SCRATCH_ALIGN) * SCRATCH_ALIGN for n in parts]
    buf = torch.empty((sum(spans),), dtype=torch.uint8, device=device)
    counters = torch.zeros((plan["counters"],), dtype=torch.int32, device=device)
    base, ptrs = buf.data_ptr(), []
    for n, span in zip(parts, spans):
        ptrs.append(base if n else None)
        base += span
    return tuple(ptrs), counters, buf


def _products_checked(what: str, plan: dict, code: int, device: int) -> dict:
    """``plan`` with, on the wgmma engine, the CTAs of its product an SM
    holds (``gemm_per_sm``), checked against the kernel's own shared-memory
    count; raises where none fits."""
    if plan["engine"] == "tile":
        return plan
    per_sm, smem = kernels.occupancy(device, "gru_scan", "vmmt_gru_products_occupancy", code,
                                     plan["gemm_bn"], plan["gemm_stages"])
    if smem != plan["gemm_smem"]:
        raise RuntimeError(f"{what} kernel: products plan of {plan['gemm_smem']} bytes of "
                           f"shared memory, the kernel takes {smem}")
    if per_sm < 1:
        raise NotImplementedError(f"{what} kernel: a wgmma product CTA with {smem} bytes of "
                                  "shared memory does not fit an SM")
    return dict(plan, gemm_per_sm=per_sm)


def _count_products(plan: dict) -> None:
    if plan["engine"] == "wgmma":
        scan_bwd_operands.launches += 2
        wgmma_gemm.launches += 2


def gru_layer_scan_bwd(x_proj: torch.Tensor, mask: torch.Tensor, h0: torch.Tensor,
                       Wh: torch.Tensor, bh: torch.Tensor, outs: torch.Tensor,
                       g: torch.Tensor, reverse: bool = False,
                       reset: Optional[torch.Tensor] = None,
                       probe: Optional[torch.Tensor] = None):
    """Backward of :func:`gru_layer_scan` (same inputs, plus its f32
    ``outs`` and their cotangent ``g``). Returns (dx_proj, dh0, dWh, dbh) in
    f32. CPU tensors take the plain version; CUDA tensors launch the
    kernels (the plan of the last launch, with the card's count of
    co-resident clusters, is kept in ``gru_layer_scan_bwd.plan``; its
    ``engine`` says which engine ran the hoisted products: ``"wgmma"`` in
    bf16 and f16, ``"tile"`` in f32). ``probe``: on
    the tiled plan, an int64 tensor of ``1 + 4 *
    T`` entries on the device for the first launch's ``%globaltimer`` stamps
    (ns) of CTA 0: after its first grid barrier, then each step's gate
    backward, grid barrier, product and sums. A launch that is refused
    raises, and no other engine runs in its place."""
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
    # scratch holds hs, dp, wp and partial until the launches are queued
    (hs, dp, wp, partial), counters, scratch = _products_scratch(plan, B, T, H, dt, x.device)
    code = kernels.DTYPE_CODE[dt]
    outputs = (dx.data_ptr(), dh0.data_ptr(), dWh.data_ptr(), dbh.data_ptr(), hp.data_ptr(),
               dhn.data_ptr(), partial, counters.data_ptr())
    products = (plan.get("gemm_bn", 0), plan.get("gemm_stages", 0))
    _check_probe("gru_layer_scan_bwd", plan, probe, T, x.device)
    if plan["engine"] == "wgmma" or plan["layout"] == "tiled":
        # TMA and the tiled ring read Wh's rows in 16-byte pieces
        args[4] = kernels.aligned(args[4])
    if plan["layout"] == "tiled":
        plan = _co_resident_tiled(
            "gru_layer_scan_bwd", "vmmt_gru_tiled_bwd_occupancy", plan, code, H, x.device.index,
            plan["stages"])
        gru_layer_scan_bwd.plan = _products_checked("gru_layer_scan_bwd", plan, code,
                                                    x.device.index)
        xch = _exchange(plan, plan["ldx"], dt, x.device)
        wt = _tiled_weights(args[4], plan)
        err = lib.vmmt_gru_tiled_bwd(code, *map(_ptr, args), *outputs, hs, dp,
                                     xch.data_ptr(), _ptr(wt), B, T, H, int(reverse),
                                     plan["rows"], plan["units"], plan["cluster"],
                                     plan["row_tiles"], int(plan["resident"]), plan["stages"],
                                     plan["dwh_splits"],
                                     *products, _ptr(probe), kernels.stream_of(x))
    else:
        co_resident, smem = kernels.occupancy(x.device.index, "gru_scan",
                                              "vmmt_gru_scan_bwd_occupancy", code, H,
                                              plan["cluster"], plan["units"], plan["rows"])
        _check_cluster("gru_layer_scan_bwd", plan, co_resident, smem)
        gru_layer_scan_bwd.plan = _products_checked(
            "gru_layer_scan_bwd", dict(plan, max_active_clusters=co_resident,
                                       one_wave=co_resident >= plan["clusters"]),
            code, x.device.index)
        err = lib.vmmt_gru_scan_bwd(code, *map(_ptr, args), *outputs, hs, dp, wp, B, T, H,
                                    int(reverse), plan["cluster"], plan["units"], plan["rows"],
                                    plan["dwh_splits"], *products, kernels.stream_of(x))
    kernels.check(lib, err, "gru_layer_scan_bwd")
    gru_layer_scan_bwd.launches += 1
    gru_layer_scan_bwd.reset_launches += r is not None
    _count_products(plan)
    return dx, dh0, dWh, dbh


def scan_bwd_products(h0: torch.Tensor, outs: torch.Tensor, Wh: torch.Tensor,
                      bh: torch.Tensor, dx: torch.Tensor, dhn: torch.Tensor,
                      reverse: bool = False, reset: Optional[torch.Tensor] = None):
    """Row 2's hoisted products alone on the wgmma engine, as
    :func:`gru_layer_scan_bwd` runs them around its scan: (hp, dWh, dbh)
    from the saved ``outs`` and a backward's ``dx`` (B,T,3H) and ``dhn``
    (B,T,H), f32; Wh bfloat16 or float16. CPU tensors take
    :func:`scan_bwd_products_ref`; CUDA tensors launch the operand pass and
    the product twice (``scan_bwd_products.plan``: the products' plan)."""
    if outs.device.type == "cpu":
        return scan_bwd_products_ref(h0, outs, Wh, bh, dx, dhn, reverse, reset)
    B, T, H = outs.shape
    dt = Wh.dtype
    code = kernels.dtype_code("scan_bwd_products", dt)
    if products_engine(dt) != "wgmma":
        raise ValueError(f"scan_bwd_products kernel: the wgmma engine takes bfloat16 and "
                         f"float16, not {dt}")
    if tuple(Wh.shape) != (H, 3 * H) or tuple(h0.shape) != (B, H) or tuple(bh.shape) != (3 * H,) \
            or tuple(dx.shape) != (B, T, 3 * H) or tuple(dhn.shape) != (B, T, H) \
            or (reset is not None and tuple(reset.shape) != (B, T)):
        raise ValueError("scan_bwd_products kernel: shapes do not match outs (B,T,H)")
    plan = products_plan(B, T, H, dt, kernels.sm_count(outs.device.index), False)
    f32 = torch.float32
    ins = [h0.to(f32).contiguous(), outs.to(f32).contiguous(), _reset_arg(reset),
           kernels.aligned(Wh), bh.to(f32).contiguous(), dx.to(f32).contiguous(),
           dhn.to(f32).contiguous()]
    kernels.require_cuda("scan_bwd_products", outs.device,
                         **{k: t for k, t in zip(("h0", "outs", "reset", "Wh", "bh", "dx", "dhn"),
                                                 ins) if t is not None})
    hp = torch.empty((B, T, 3 * H), dtype=f32, device=outs.device)
    dWh = torch.empty((H, 3 * H), dtype=f32, device=outs.device)
    dbh = torch.empty((3 * H,), dtype=f32, device=outs.device)
    # scratch holds hs, dp, wp and partial until the launches are queued
    (hs, dp, wp, partial), counters, scratch = _products_scratch(plan, B, T, H, dt, outs.device)
    scan_bwd_products.plan = _products_checked("scan_bwd_products", plan, code,
                                               outs.device.index)
    lib = kernels.library("gru_scan")
    err = lib.vmmt_gru_bwd_products(code, *map(_ptr, ins), hp.data_ptr(), dWh.data_ptr(),
                                    dbh.data_ptr(), hs, dp, wp, partial, counters.data_ptr(),
                                    B, T, H, int(reverse), plan["dwh_splits"], plan["gemm_bn"],
                                    plan["gemm_stages"], kernels.stream_of(outs))
    kernels.check(lib, err, "scan_bwd_products")
    _count_products(plan)
    return hp, dWh, dbh


gru_layer_scan.launches = 0
gru_layer_scan.reset_launches = 0  # the launches that carried a reset stream
gru_layer_scan.plan = None
gru_layer_scan_bwd.launches = 0
gru_layer_scan_bwd.reset_launches = 0
gru_layer_scan_bwd.plan = None
scan_bwd_products.plan = None


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
