"""Times of the six kernels (rows 1-6 of PERF.md's table) at the main
paths' shapes, for comparing two trees of the port on one card.

    PYTHONPATH=<tree> python <this file> [-dtype bfloat16|float16|float32]

imports ``variational_mmt_torch`` from ``<tree>`` (so one copy of this
script times an older tree too: it calls only the wrappers' public
signatures) and prints one JSON line: for the GRU-scan forward at B=256
(serving) and B=64 (training), T=24, H=250, its backward at B=64 (both
without a reset stream), the decode step and GRU chain at N=1024,
S=24, H=500, and the decoder sequence forward and backward at the training
shape (B=64, T=25, S=24, H=500, attention memory std 0.1), all in
``-dtype`` (bfloat16 by default; a tree older than
the float16 kernels refuses float16), the time of one call by CUDA
events over 50 calls after 5 (``ms``: what ``chip_smoke.py`` reports, the
host's launch work included when it is the slower side) and the device
time of one call under ``torch.profiler`` (``device_ms``: the kernels'
own time, summed over the CUDA kernels of 10 calls), with the card's name
and power limit.

    PYTHONPATH=<tree> python <this file> -wide [BxTxH,...]

times rows 1 and 2 (the GRU-scan forward and backward, reset-free, bf16)
at those shapes instead (by default B=64 and 256, T=24, H=512 and the
eleven shapes of ``chip_smoke.py`` phase 13, B=64 T=25 and B=256 T=24 at H
= 520 to 2500): for each shape and
row the call's time by CUDA events (``ms``), the device time of each CUDA
kernel of one call under ``torch.profiler``, grouped by kernel name
(``kernels``; row 2: the hoisted gate product, the reverse scan, the dWh
product, the operand pass on the wgmma engine, the fill of the counters)
with the count of its records over 10 calls (``records``), their sum
(``device_ms``), the wrapper's plan and, on a tiled plan, the scan's µs a
step by phase (its probe); row 2's device time split into the reverse
scan, the hoisted products (``products_ms``: the operand pass, the wgmma or
tile_gemm products) and the rest, with the products' TFLOP/s (12 B T H^2
FLOPs); beside rows 1 and 2, cuDNN's ``nn.GRU`` forward and backward by
kernel on the same clock (they also compute the input projection and its
gradients). Then the CUDA
kernels that the profiler records for one call of rows 5 and 6 at the
training shape and at H = 2048 (``decoder``, by H), whose kernels launch
through ``cudaLaunchCooperativeKernel``; row 6's split names its hoisted
gate products (``DecHoist`` on tile_gemm.cuh) apart.

    PYTHONPATH=<tree> python <this file> -host [BxTxH,...]

says where the host's time of rows 2 and 1 goes at those shapes (bf16,
reset-free; by default the quality gate's B=64 T=32 H=128 and the
flagship's B=64 T=24 H=250), each over 100 calls after 10, synchronized
only before and after: the call by CUDA events and on the device clock,
then host µs a call of the wrapper (``call_us``), of its C entry point
alone on the arguments the wrapper passed it (``entry_us``: launches,
tensor-map encodings, attribute calls), of the wgmma products' C entry
alone (``products_us``), of the products' scratch allocations
(``scratch_us``), and of one ``cuTensorMapEncodeTiled`` through ctypes
(``encode_us``, ctypes' own cost included); a part this tree lacks is null;
and under ``fwd`` row 1's plan, its call by events and on the device clock,
and the host µs a call of its wrapper and of its C entry point.

    PYTHONPATH=<tree> python <this file> -tilings BxTxH[,...] [-fwd | -bwd]

times every tiling and ring of both passes' tiled plans at those shapes
(this tree's plans only; ``-fwd``: the forward's alone, ``-bwd``: the
backward's): each scan's device ms and µs a step by phase beside the
plan's cost model.

    PYTHONPATH=<tree> python <this file> -crossover [float32,bfloat16] [-bwd]

times the forward's (``-bwd``: the backward's) two plans in turns (cluster,
tiled, tiled, cluster) at
B = 32 to 1024, T = 24, H = 128 to 512 (``CROSSOVER_BATCHES`` x
``CROSSOVER_WIDTHS``), reset-free, in each dtype (this tree only): each
plan's device ms by the profiler (with its records of 10 calls) and by
CUDA events around 20 calls queued behind a sleep on the device
(``queued_ms``: the host's launch work hidden), the cluster plan's
clusters the card holds at once, the tiled plan's tiling and its cost
model, its largest error from the plain version and whether two of its
launches are bit-identical, and cuDNN's nn.GRU forward (bf16) on the same
clock (``-bwd``: cuDNN's backward, bf16); first, under
``clusters_at_once``, the card's count of clusters held at once for each
cluster size (H = 32 to 512 in steps of 32, 250 and 500) and whether
``gru_scan.fwd_cluster_waves`` (``bwd_cluster_waves``) counts the same.
What the plans' choice between them was derived from.

    PYTHONPATH=<tree> python <this file> -row4

times row 4 (the GRU chain) at N = 1024, H = 250 (the kernels' width 252)
on the device clock in turns with cuDNN's 2-layer ``nn.GRU`` over one step
(kernel, padded, cuDNN, cuDNN, padded, kernel): ``kernel`` every input
already at 252, ``padded`` the weights padded once and the activations
padded and cut back by the wrapper at each call, as a request's steps
call it; ``padding_ms`` is their difference.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from variational_mmt_torch.ops import decode_step as ds
from variational_mmt_torch.ops import decoder as dec
from variational_mmt_torch.ops import gru_scan


def event_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int = 20) -> float:
    """ms of one call on the device's clock: CUDA events around ``iters``
    calls enqueued while the device sleeps, so that they run back to back
    whatever the host's time a call (after one untimed call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # about 25 ms at the H100's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and "Memset" not in e.name)
    return us / iters / 1e3


WIDE_SHAPES = ("64x24x512,256x24x512,64x25x520,256x24x520,64x25x1000,256x24x1000,64x25x1024,"
               "256x24x1024,64x25x1040,64x25x1536,64x25x2048,256x24x2048,64x25x2500")


def kernel_name(name: str) -> str:
    """A CUDA kernel's name without its namespaces and arguments: the
    function and its template arguments."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            return name[:i].strip()
    return name.strip()


def kernels_ms(fn, iters: int = 10, records: dict = None) -> dict:
    """Device ms of one call of ``fn`` by CUDA kernel name (memsets and
    fills included), over ``iters`` calls under the profiler; with
    ``records``, the count of each kernel's records goes there (the
    profiler has been seen to drop every record of some calls, which shows
    as fewer records than launches)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = kernel_name(e.name)
            out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / iters / 1e3
            if records is not None:
                records[key] = records.get(key, 0) + 1
    return out


def scan_bwd_args(shape: str, r, g):
    """Row 2's inputs at a ``BxTxH`` shape in bf16, with ragged lengths."""
    B, T, H = map(int, shape.split("x"))
    lengths = torch.randint(T // 3, T + 1, (B,), generator=g, device="cuda")
    mask = (torch.arange(T, device="cuda")[None] < lengths[:, None]).float()
    args = (r(B, T, 3 * H).to(torch.bfloat16), mask, 0.1 * r(B, H),
            (r(H, 3 * H) / math.sqrt(H)).to(torch.bfloat16), 0.1 * r(3 * H))
    outs, _ = gru_scan.gru_layer_scan_ref(*args, True)
    return (B, T, H), (*args, outs, r(B, T, H), True)


def phases_us(args, T: int) -> dict:
    """µs a step of the tiled reverse scan by phase, from its probe's
    ``%globaltimer`` stamps (CTA 0 of one call): the gate backward, the grid
    barrier, the product and the sums of the partial products."""
    probe = torch.zeros(1 + 4 * T, dtype=torch.int64, device="cuda")
    gru_scan.gru_layer_scan_bwd(*args, probe=probe)
    return step_phases(probe, T, ("gate", "barrier", "product", "sums"))


def fwd_phases_us(args, T: int) -> dict:
    """µs a step of the tiled forward by phase, from its probe (CTA 0 of one
    call): the product, the sums of the partial products, the gates and
    the grid barrier."""
    probe = torch.zeros(1 + 4 * T, dtype=torch.int64, device="cuda")
    gru_scan.gru_layer_scan(*args, probe=probe)
    return step_phases(probe, T, ("product", "sums", "gates", "barrier"))


def step_phases(probe, T: int, names) -> dict:
    """Mean µs a step of each of a probe's four phases."""
    torch.cuda.synchronize()
    stamps = probe.tolist()
    steps = [[(stamps[1 + 4 * s + k] - stamps[4 * s + k]) / 1e3 for k in range(4)]
             for s in range(T)]
    return {name: sum(st[k] for st in steps) / T for k, name in enumerate(names)}


def timed(fn, plan_of, phases, args, T: int) -> dict:
    """One row's call: CUDA-event ms, device ms by kernel, the plan and, on a
    tiled plan, µs a step by phase."""
    records = {}
    by_kernel = kernels_ms(fn, records=records)
    rec = {"ms": event_ms(fn, iters=10, warmup=2), "device_ms": sum(by_kernel.values()),
           "kernels": by_kernel, "records": records, "plan": plan_of()}
    if rec["plan"].get("layout") == "tiled":
        rec["us_a_step"] = phases(args, T)
    return rec


# row 2's CUDA kernels by part: the reverse scan, the hoisted products
# (the wgmma engine's operand pass and product, or tile_gemm's gate
# recompute and dWh)
SCAN_KERNELS = ("gru_scan_bwd_kernel", "gru_tiled_bwd_kernel", "gru_wide_bwd_kernel",
                "gru_stream_bwd_kernel")
PRODUCT_KERNELS = ("scan_hs_kernel", "scan_dp_kernel", "wgmma_gemm_kernel", "tile_gemm_kernel")


def row2_split(by_kernel: dict, B: int, T: int, H: int) -> dict:
    """Row 2's device ms by part (scan, products, operand pass, the rest)
    and the products' TFLOP/s: (a) and (c) are 6 B T H^2 FLOPs each."""
    part = lambda keys: sum(v for k, v in by_kernel.items()  # noqa: E731
                            if k.split("<", 1)[0] in keys)
    out = {"scan_ms": part(SCAN_KERNELS), "products_ms": part(PRODUCT_KERNELS),
           "operand_pass_ms": part(PRODUCT_KERNELS[:2]), "gemm_ms": part(PRODUCT_KERNELS[2:])}
    out["rest_ms"] = sum(by_kernel.values()) - out["scan_ms"] - out["products_ms"]
    flops = 12.0 * B * T * H * H
    out["products_tflops"] = flops / out["products_ms"] / 1e9 if out["products_ms"] else None
    out["gemm_tflops"] = flops / out["gemm_ms"] / 1e9 if out["gemm_ms"] else None
    return out


def wide_times(shapes: str, r, g) -> dict:
    """Rows 1 and 2 at each ``BxTxH`` shape in bf16: each call by CUDA
    events, the device ms of each of its CUDA kernels and, on a tiled plan,
    the scan's µs a step by phase; row 2's split; cuDNN's nn.GRU forward and
    backward by kernel."""
    out = {}
    for shape in shapes.split(","):
        (B, T, H), args = scan_bwd_args(shape, r, g)
        fargs = args[:5] + (True,)
        rec = {"fwd": timed(lambda a=fargs: gru_scan.gru_layer_scan(*a),
                            lambda: gru_scan.gru_layer_scan.plan, fwd_phases_us, fargs, T),
               "bwd": timed(lambda a=args: gru_scan.gru_layer_scan_bwd(*a),
                            lambda: gru_scan.gru_layer_scan_bwd.plan, phases_us, args, T)}
        rec["bwd"]["split"] = row2_split(rec["bwd"]["kernels"], B, T, H)
        gru = torch.nn.GRU(2 * H, H, batch_first=True, device="cuda", dtype=torch.bfloat16)
        xin = r(B, T, 2 * H).to(torch.bfloat16)
        with torch.no_grad():
            cudnn = kernels_ms(lambda: gru(xin))
        rec["fwd"]["cudnn_kernels"], rec["fwd"]["cudnn_device_ms"] = cudnn, sum(cudnn.values())
        cudnn = kernels_ms(cudnn_bwd_call(B, T, H, torch.bfloat16, r))
        rec["bwd"]["cudnn_kernels"], rec["bwd"]["cudnn_device_ms"] = cudnn, sum(cudnn.values())
        out[f"B={B} T={T} H={H}"] = rec
    return out


def cudnn_bwd_call(B: int, T: int, H: int, dt, r):
    """A call of cuDNN's nn.GRU backward at (B, T, H) in ``dt`` (which also
    computes the input-projection gradients that row 2 leaves to cuBLAS)."""
    gru = torch.nn.GRU(2 * H, H, batch_first=True, device="cuda", dtype=dt)
    gru.flatten_parameters()
    xin = r(B, T, 2 * H).to(dt).requires_grad_(True)
    y, _ = gru(xin)
    gy = r(*y.shape).to(dt)
    return lambda: torch.autograd.grad(y, [xin, *gru.parameters()], gy, retain_graph=True)


def tilings(shapes: str, r, g, fwd_only: bool = False, bwd_only: bool = False) -> dict:
    """Every tiling of both tiled plans (``gru_scan.TILED_TILES`` x
    ``TILED_BWD_RINGS`` or ``TILED_FWD_TILES`` x ``TILED_FWD_RINGS``, x
    ``TILED_CLUSTERS``) at each ``BxTxH`` shape in bf16: each scan's device ms and its µs a
    step by phase, beside what the plan's cost model predicts, the plan's
    own choice marked. What the plans' constants were fitted to."""
    out = {}
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planners = (gru_scan.scan_fwd_plan, gru_scan.scan_bwd_plan)
    try:
        for shape in shapes.split(","):
            (B, T, H), args = scan_bwd_args(shape, r, g)
            fargs = args[:5] + (True,)
            chosen = dict(planners[1](B, T, H, bf16, sms))
            if chosen["layout"] != "tiled":  # the products' plan of the tiled plan
                chosen = dict(gru_scan.tiled_bwd_plan(B, T, H, bf16, sms), layout="cluster")
            rows = []
            for tile_rows, units in () if fwd_only else gru_scan.TILED_TILES:
                for cluster in gru_scan.TILED_CLUSTERS:
                    for ring in gru_scan.TILED_BWD_RINGS:  # every ring that fits
                        plan = gru_scan.tiled_plan_for(B, H, bf16, sms, tile_rows, units,
                                                       cluster, (ring,))
                        if plan is None:
                            continue
                        p = dict(chosen, **plan)  # the products' plan kept
                        gru_scan.scan_bwd_plan = lambda *a, _p=p, **k: dict(_p)
                        scan = sum(v for n, v in kernels_ms(lambda: gru_scan.gru_layer_scan_bwd(
                            *args)).items() if "tiled" in n)
                        rows.append({"tile": [tile_rows, units, cluster], "resident": ring[0],
                                     "stages": ring[1], "grid": p["grid"], "chunks": p["chunks"],
                                     "scan_ms": scan, "model_ms": gru_scan._tiled_cost(
                                         B, H, bf16, p) * T * 1e3,
                                     "model_us": [x * 1e6 for x in gru_scan.tiled_bwd_phases(
                                         B, H, bf16, p)],
                                     "us_a_step": phases_us(args, T),
                                     "chosen": chosen["layout"] == "tiled" and all(
                                         p[k] == chosen[k] for k in (
                                             "rows", "units", "cluster", "resident", "stages"))})
            gru_scan.scan_bwd_plan = planners[1]
            chosen = planners[0](B, T, H, bf16, sms)
            fwd = []
            for tile_rows, units in () if bwd_only else gru_scan.TILED_FWD_TILES:
                for cluster in gru_scan.TILED_CLUSTERS:
                    for ring in gru_scan.TILED_FWD_RINGS:  # every ring that fits
                        p = gru_scan.tiled_fwd_plan_for(B, H, bf16, sms, tile_rows, units,
                                                        cluster, (ring,))
                        if p is None:
                            continue
                        resident, stages = ring
                        gru_scan.scan_fwd_plan = lambda *a, _p=p, **k: dict(_p)
                        scan = sum(v for n, v in kernels_ms(lambda: gru_scan.gru_layer_scan(
                            *fargs)).items() if "tiled" in n)
                        fwd.append({"tile": [tile_rows, units, cluster], "resident": resident,
                                    "stages": stages, "grid": p["grid"], "chunks": p["chunks"],
                                    "scan_ms": scan, "model_ms": gru_scan._tiled_fwd_cost(
                                        B, H, bf16, p) * T * 1e3,
                                    "us_a_step": fwd_phases_us(fargs, T),
                                    "chosen": all(p[k] == chosen[k] for k in (
                                        "rows", "units", "cluster", "resident", "stages"))})
            gru_scan.scan_fwd_plan = planners[0]
            out[f"B={B} T={T} H={H}"] = {"bwd": rows, "fwd": fwd}
    finally:
        gru_scan.scan_fwd_plan, gru_scan.scan_bwd_plan = planners
    return out


# the scans' two plans against each other: B, T = 24 and H (steps of 32
# from 256, of 16 from 448; and the flagship's 250 and the gate's 128)
CROSSOVER_BATCHES = (32, 64, 128, 256, 512, 1024)
CROSSOVER_WIDTHS = (128, 250, 256, 288, 320, 352, 384, 416, 448, 464, 480, 496, 512)
# the widths whose clusters at once ``clusters_at_once`` reads
CLUSTER_WIDTHS = tuple(range(32, 513, 32)) + (250, 500)


def clusters_at_once(dtypes: str, bwd: bool) -> dict:
    """The card's count of the cluster plan's clusters held at once, for
    each cluster size (H in CLUSTER_WIDTHS) and dtype, the CTAs an SM's
    shared memory takes (``per_sm``), and whether the plan's wave count
    (``fwd_cluster_waves`` or, with ``bwd``, ``bwd_cluster_waves``) agrees:
    one wave for that many clusters, two for one more."""
    from variational_mmt_torch import kernels

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for dt_name in dtypes.split(","):
        dt = getattr(torch, dt_name)
        for H in sorted(CLUSTER_WIDTHS):
            if bwd:
                plan = gru_scan._cluster_bwd_plan(1, H, dt, sms)
                held, smem = kernels.occupancy(0, "gru_scan", "vmmt_gru_scan_bwd_occupancy",
                                               kernels.DTYPE_CODE[dt], H, plan["cluster"],
                                               plan["units"], plan["rows"])
                waves = gru_scan.bwd_cluster_waves
            else:
                plan = gru_scan._cluster_fwd_plan(1, H, dt, sms)
                held, smem = kernels.occupancy(0, "gru_scan", "vmmt_gru_scan_occupancy",
                                               kernels.DTYPE_CODE[dt], H, plan["cluster"],
                                               plan["rows"])
                waves = gru_scan.fwd_cluster_waves
            # what the plan counts on: a wave of `held` clusters, so one
            # more cluster than that takes two
            out[f"{dt_name} H={H}"] = {
                "cluster": plan["cluster"], "smem": smem, "per_sm": gru_scan.H100_SMEM_PER_SM
                // (smem + 1024), "at_once": held,
                "plan_agrees": waves(dict(plan, clusters=held), sms) == 1
                and waves(dict(plan, clusters=held + 1), sms) == 2}
    return out


def crossover(dtypes: str, r, g, bwd: bool = False) -> dict:
    """The cluster and tiled plans of the forward (``bwd``: the backward) in
    turns at each B and H of CROSSOVER_BATCHES x CROSSOVER_WIDTHS in each of
    ``dtypes`` (the module docstring's ``-crossover``)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    name = "scan_bwd_plan" if bwd else "scan_fwd_plan"
    planner = getattr(gru_scan, name)
    out = {"clusters_at_once": clusters_at_once(dtypes, bwd)}
    try:
        for dt_name in dtypes.split(","):
            dt = getattr(torch, dt_name)
            for B in CROSSOVER_BATCHES:
                for H in CROSSOVER_WIDTHS:
                    T = 24
                    lengths = torch.randint(T // 3, T + 1, (B,), generator=g, device="cuda")
                    mask = (torch.arange(T, device="cuda")[None] < lengths[:, None]).float()
                    args = (r(B, T, 3 * H).to(dt), mask, 0.1 * r(B, H),
                            (r(H, 3 * H) / math.sqrt(H)).to(dt), 0.1 * r(3 * H))
                    if bwd:
                        outs, _ = gru_scan.gru_layer_scan_ref(*args, True)
                        args = args + (outs, r(B, T, H), True)
                        call = lambda: gru_scan.gru_layer_scan_bwd(*args)  # noqa: E731
                        ref, wrapper = gru_scan.gru_layer_scan_bwd_ref, gru_scan.gru_layer_scan_bwd
                        plans = {"cluster": dict(gru_scan._cluster_bwd_plan(B, H, dt, sms),
                                                 **gru_scan.products_plan(B, T, H, dt, sms, False)),
                                 "tiled": gru_scan.tiled_bwd_plan(B, T, H, dt, sms)}
                        cost = gru_scan._tiled_cost
                    else:
                        args = args + (True,)
                        call = lambda: gru_scan.gru_layer_scan(*args)  # noqa: E731
                        ref, wrapper = gru_scan.gru_layer_scan_ref, gru_scan.gru_layer_scan
                        plans = {"cluster": gru_scan._cluster_fwd_plan(B, H, dt, sms),
                                 "tiled": gru_scan.tiled_fwd_plan(B, H, dt, sms)}
                        cost = gru_scan._tiled_fwd_cost
                    rec = {k: {"device_ms": [], "records": [], "queued_ms": []} for k in plans}
                    for layout in ("cluster", "tiled", "tiled", "cluster"):
                        setattr(gru_scan, name, lambda *a, _p=plans[layout], **k: dict(_p))
                        records = {}
                        by_kernel = kernels_ms(call, records=records)
                        rec[layout]["device_ms"].append(sum(by_kernel.values()))
                        rec[layout]["records"].append(sum(records.values()))
                        rec[layout]["queued_ms"].append(queued_ms(call))
                        if layout == "cluster":
                            rec[layout]["plan"] = wrapper.plan
                    tiled = plans["tiled"]
                    setattr(gru_scan, name, lambda *a, **k: dict(tiled))
                    first, second = call(), call()
                    want = ref(*args)
                    rec["tiled"].update(
                        tiling=[tiled[k] for k in ("rows", "units", "cluster", "resident",
                                                   "stages", "grid")],
                        model_ms=cost(B, H, dt, tiled) * T * 1e3,
                        max_abs_err=max((a - b).abs().max().item() for a, b in zip(first, want)),
                        bit_identical=all(torch.equal(a, b) for a, b in zip(first, second)))
                    rec["rule"] = planner(B, T, H, dt, sms)["layout"]
                    if dt == torch.bfloat16:
                        if bwd:
                            lib = cudnn_bwd_call(B, T, H, dt, r)
                        else:
                            gru = torch.nn.GRU(2 * H, H, batch_first=True, device="cuda",
                                               dtype=dt)
                            xin = r(B, T, 2 * H).to(dt)
                            lib = lambda: gru(xin)  # noqa: E731
                        with torch.no_grad() if not bwd else torch.enable_grad():
                            rec["cudnn_device_ms"] = sum(kernels_ms(lib).values())
                    out[f"{dt_name} B={B} T={T} H={H}"] = rec
    finally:
        setattr(gru_scan, name, planner)
    return out


def row4_times(r, g) -> dict:
    """Row 4 at N = 1024, H = 250 beside cuDNN's step (the module
    docstring's ``-row4``): device ms of each turn."""
    from variational_mmt_torch.ops.decode_step import pad_step_weights, pad_units, padded_width

    N, H = 1024, 250
    Hp = padded_width(H)
    bf = torch.bfloat16
    w = lambda *s: (r(*s) / math.sqrt(H)).to(bf)  # noqa: E731
    acts = (r(N, 3 * H).to(bf), torch.tanh(r(N, H)).to(bf), torch.tanh(r(N, H)).to(bf),
            torch.tanh(r(N, H)).to(bf))
    weights = pad_step_weights(w(H, 3 * H), w(H, 3 * H), 0.1 * r(3 * H), w(H, 3 * H),
                               0.1 * r(3 * H), w(H, 3 * H), 0.1 * r(3 * H))
    wide = (pad_units(acts[0], H, Hp, -1, 3),) + tuple(pad_units(a, H, Hp) for a in acts[1:])
    gru = torch.nn.GRU(2 * H, H, num_layers=2, batch_first=True, device="cuda", dtype=bf)
    x = r(N, 1, 2 * H).to(bf)
    h = torch.tanh(r(2, N, H)).to(bf)

    def cudnn():
        with torch.no_grad():
            return gru(x, h)

    calls = {"kernel": lambda: ds.gru_chain(*wide, *weights),
             "padded": lambda: ds.gru_chain(*acts, *weights), "cudnn": cudnn}
    out = {k: [] for k in calls}
    for name in ("kernel", "padded", "cudnn", "cudnn", "padded", "kernel"):
        out[name].append(sum(kernels_ms(calls[name], iters=50).values()))
    out["padding_ms"] = [p - k for p, k in zip(out["padded"], out["kernel"])]
    out["plan"] = ds.gru_chain.plan
    return out


HOST_SHAPES = "64x32x128,64x24x250"  # the quality gate's encoder direction, the flagship's


def host_us(fn, iters: int = 100, warmup: int = 10) -> float:
    """Host µs a call of ``fn``, synchronized only before and after."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / iters
    torch.cuda.synchronize()
    return us


def entry_of(lib, name: str, call):
    """A function that calls C entry point ``name`` of ``lib`` with the
    arguments ``call()`` passed it (None where ``call`` did not reach it).
    The wrapper's scratch is freed by then, but nothing else allocates from
    PyTorch's cache while the entry runs, so the pointers stay mapped; the
    counters are not zeroed again, which may change values, not bounds."""
    real = getattr(lib, name)
    seen = []
    setattr(lib, name, lambda *a: seen.append(a) or real(*a))
    try:
        call()
    finally:
        setattr(lib, name, real)
    return (lambda: real(*seen[-1])) if seen else None


def encode_us(iters: int = 1000):
    """Host µs of one cuTensorMapEncodeTiled of a bf16 (4096, 1024) matrix
    in 64 x 128 boxes, 128-byte swizzle, through ctypes (None where the
    libcuda does not offer it or refuses the map)."""
    try:
        fn = ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled
    except (OSError, AttributeError):
        return None
    raw = ctypes.create_string_buffer(256)
    tmap = ctypes.c_void_p((ctypes.addressof(raw) + 63) // 64 * 64)  # 64-byte aligned
    base = torch.empty((4096, 1024), dtype=torch.bfloat16, device="cuda")
    u64, u32 = ctypes.c_uint64 * 2, ctypes.c_uint32 * 2
    dims, strides = u64(1024, 4096), u64(2048, 0)
    box, step = u32(64, 128), u32(1, 1)
    bf16, swizzle_128b, l2_256b = 9, 3, 3  # CUtensorMapDataType, ..Swizzle, ..L2promotion
    args = (tmap, bf16, 2, ctypes.c_void_p(base.data_ptr()), dims, strides, box, step, 0,
            swizzle_128b, l2_256b, 0)
    if fn(*args) != 0:
        return None
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) * 1e6 / iters


def host_times(shapes: str, r, g) -> dict:
    """Row 2's call at each ``BxTxH`` shape in bf16 and where its host time
    goes (the module docstring's ``-host``)."""
    from variational_mmt_torch import kernels

    lib = kernels.library("gru_scan")
    out = {"encode_us": encode_us()}
    for shape in shapes.split(","):
        (B, T, H), args = scan_bwd_args(shape, r, g)
        call = lambda a=args: gru_scan.gru_layer_scan_bwd(*a)  # noqa: E731
        call()
        plan = gru_scan.gru_layer_scan_bwd.plan
        entry = "vmmt_gru_tiled_bwd" if plan["layout"] == "tiled" else "vmmt_gru_scan_bwd"
        rec = {"ms": event_ms(call, iters=100, warmup=10), "device_ms": device_ms(call),
               "plan_engine": plan.get("engine"), "call_us": host_us(call),
               "entry_us": host_us(entry_of(lib, entry, call)),
               "products_us": None, "scratch_us": None}
        products = getattr(gru_scan, "scan_bwd_products", None)
        if products is not None and hasattr(lib, "vmmt_gru_bwd_products"):
            h0, outs, wh, bh = args[2], args[5], args[3], args[4]
            dx, dhn = r(B, T, 3 * H), r(B, T, H)
            fn = entry_of(lib, "vmmt_gru_bwd_products",
                          lambda: products(h0, outs, wh, bh, dx, dhn, True))
            rec["products_us"] = host_us(fn)
            pplan = gru_scan.scan_bwd_products.plan
            rec["scratch_us"] = host_us(lambda: gru_scan._products_scratch(
                pplan, B, T, H, torch.bfloat16, outs.device))
        fwd = lambda a=args[:5] + (True,): gru_scan.gru_layer_scan(*a)  # noqa: E731
        fwd()
        fplan = gru_scan.gru_layer_scan.plan
        rec["fwd"] = {"layout": fplan["layout"], "ms": event_ms(fwd, iters=100, warmup=10),
                      "device_ms": device_ms(fwd), "call_us": host_us(fwd),
                      "entry_us": host_us(entry_of(lib, "vmmt_gru_tiled_fwd" if fplan["layout"]
                                                   == "tiled" else "vmmt_gru_scan", fwd))}
        out[f"B={B} T={T} H={H}"] = rec
    return out


DECODER_WIDTHS = (500, 2048)  # rows 5 and 6 under -wide: the training width, the streamed plan


def decoder_calls(r, g, bf, H: int = 500) -> dict:
    """Rows 5 and 6 at the training shape (B=64, T=25, S=24, H=500, memory
    std 0.1) or at width H, ``bf``: {name: a call}."""
    B, T, S = 64, 25, 24
    w = lambda *s: (r(*s) / math.sqrt(H)).to(bf)  # noqa: E731
    dmid = ((torch.rand(B, T, H, generator=g, device="cuda") > 0.3).float() / 0.7).to(bf)
    lengths = torch.randint(8, S + 1, (B,), generator=g, device="cuda")
    mask_bias = (torch.arange(S, device="cuda")[None] >= lengths[:, None]).float() * -1e9
    seq = (r(B, T, 3 * H).to(bf), dmid, torch.tanh(r(B, H)), torch.tanh(r(B, H)),
           w(H, 3 * H), w(H, 3 * H), 0.1 * r(3 * H), w(H, 3 * H), 0.1 * r(3 * H),
           w(H, 3 * H), 0.1 * r(3 * H), (0.1 * r(B, S, H)).to(bf), (0.1 * r(B, S, H)).to(bf),
           w(H, H))
    streams = dec.decoder_fwd_ref(*seq, mask_bias)
    grads = (r(B, T, H), r(B, T, S))
    return {"decoder_fwd": lambda: dec.decoder_fwd(*seq, mask_bias),
            "decoder_bwd": lambda: dec.decoder_bwd(*seq, *streams, *grads)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser("kernel_times")
    p.add_argument("-dtype", default="bfloat16", choices=["bfloat16", "float16", "float32"])
    p.add_argument("-wide", nargs="?", const=WIDE_SHAPES, default=None,
                   help="time rows 1 and 2 at these BxTxH shapes (bf16) instead")
    p.add_argument("-host", nargs="?", const=HOST_SHAPES, default=None,
                   help="say where row 2's host time goes at these BxTxH shapes (bf16)")
    p.add_argument("-tilings", default=None,
                   help="time every tiling of both tiled plans at these BxTxH shapes")
    p.add_argument("-fwd", action="store_true", help="-tilings: the forward's alone")
    p.add_argument("-crossover", nargs="?", const="bfloat16,float32", default=None,
                   help="time the forward's cluster and tiled plans in turns in these dtypes")
    p.add_argument("-bwd", action="store_true",
                   help="-crossover: the backward's plans; -tilings: the backward's alone")
    p.add_argument("-row4", action="store_true",
                   help="time row 4 at N = 1024, H = 250 beside cuDNN's step instead")
    opt = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(5)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    if opt.wide is not None:
        decoder = {}
        for H in DECODER_WIDTHS:
            calls = decoder_calls(r, g, torch.bfloat16, H)
            decoder[f"H={H}"] = {name: {"ms": event_ms(fn, iters=10, warmup=2),
                                        "kernels": kernels_ms(fn)} for name, fn in calls.items()}
            bwd = decoder[f"H={H}"]["decoder_bwd"]["kernels"]
            hoist = sum(v for k, v in bwd.items() if "DecHoist" in k)
            bwd_ms = sum(bwd.values())
            decoder[f"H={H}"]["decoder_bwd"]["hoist_ms"] = hoist
            decoder[f"H={H}"]["decoder_bwd"]["hoist_share"] = hoist / bwd_ms if bwd_ms else None
        print(json.dumps({"wide_times": wide_times(opt.wide, r, g),
                          "decoder": decoder, "card": card}, default=str))
        return
    if opt.host is not None:
        print(json.dumps({"host_times": host_times(opt.host, r, g), "card": card}))
        return
    if opt.tilings is not None:
        print(json.dumps({"tilings": tilings(opt.tilings, r, g, opt.fwd, opt.bwd),
                          "card": card}))
        return
    if opt.crossover is not None:
        print(json.dumps({"crossover": crossover(opt.crossover, r, g, opt.bwd), "card": card},
                         default=str))
        return
    if opt.row4:
        print(json.dumps({"row4": row4_times(r, g), "card": card}, default=str))
        return
    bf = getattr(torch, opt.dtype)
    calls = {}
    H = 250
    for B in (256, 64):
        lengths = torch.randint(8, 25, (B,), generator=g, device="cuda")
        mask = (torch.arange(24, device="cuda")[None] < lengths[:, None]).float()
        args = (r(B, 24, 3 * H).to(bf), mask, 0.1 * r(B, H),
                (r(H, 3 * H) / math.sqrt(H)).to(bf), 0.1 * r(3 * H))
        calls[f"gru_layer_scan B={B}"] = lambda a=args: gru_scan.gru_layer_scan(*a, True)
    outs, _ = gru_scan.gru_layer_scan_ref(*args, True)
    g_outs = r(64, 24, H)
    calls["gru_layer_scan_bwd B=64"] = lambda: gru_scan.gru_layer_scan_bwd(*args, outs, g_outs,
                                                                            True)
    N, S, H = 1024, 24, 500
    w = lambda *s: (r(*s) / math.sqrt(H)).to(bf)  # noqa: E731
    chain = (r(N, 3 * H).to(bf), torch.tanh(r(N, H)).to(bf), torch.tanh(r(N, H)).to(bf),
             torch.tanh(r(N, H)).to(bf), w(H, 3 * H), w(H, 3 * H), 0.1 * r(3 * H),
             w(H, 3 * H), 0.1 * r(3 * H), w(H, 3 * H), 0.1 * r(3 * H))
    lengths = torch.randint(8, S + 1, (N,), generator=g, device="cuda")
    mask_bias = (torch.arange(S, device="cuda")[None] >= lengths[:, None]).float() * -1e9
    attn = ((0.5 * r(N, S, H)).to(bf), (0.5 * r(N, S, H)).to(bf), w(H, H), mask_bias)
    calls["decode_step"] = lambda: ds.decode_step(*chain, *attn)
    calls["gru_chain"] = lambda: ds.gru_chain(*chain)
    calls.update(decoder_calls(r, g, bf))
    out = {name: {"ms": event_ms(fn), "device_ms": device_ms(fn)} for name, fn in calls.items()}
    print(json.dumps({"kernel_times": out, "dtype": opt.dtype, "card": card}))


if __name__ == "__main__":
    main()
