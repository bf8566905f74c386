"""PyTorch port: the GRU-scan kernels (rows 1 and 2) above 1024 units and
both passes' tiled plans above 512, on the CPU.

- The plain versions ``gru_layer_scan_ref`` and ``gru_layer_scan_bwd_ref``
  (what the tiled kernels are held to on the card) against JAX's
  ``gru_layer_scan`` and ``gru_layer_scan_ad`` in interpret mode at H =
  1040 and 1100, B = 3, T = 5, both directions, with and without a reset
  stream, f32: outputs, finals, dx, dh0, dWh, dbh and the VJP within 1e-5.
- Both tiled plans (``layout`` ``"tiled"``) at H = 1040, 1536, 2048, 2500
  and 4096 in the three dtypes, batches 1, 61, 64, 256 and 1000: the
  units and row tiles covering H and B, the grid within what 132 SMs hold
  at once, shared memory within a CTA's.
- Wh as the tiled kernels read it: the forward's (in place where each
  gate's columns start on a 16-byte piece, else the copy
  ``_tiled_fwd_weights`` pads), read the way its ring reads a unit tile's
  K chunks, gives round(h) @ Wh of that tile's three gate columns, zero
  past H; the backward's (``_tiled_weights``), read the way its ring reads
  a K chunk, gives dh_proj @ Wh^T, zero past 3H.
- The wrappers launch both tiled entry points with the plans, Wh in place
  or padded, and the grid, and raise naming the plan, before any launch,
  where the card cannot hold the grid at once.
- Both tiled plans at H = 513 to 4096 and B = 1 to 4096 in the three
  dtypes on cards of 132 and 114 SMs: every (row, unit) cell owned by
  exactly one CTA of one launch, each tile's K chunks covering K (H
  forward, 3H backward) once, the forward's tile N holding its units'
  three gate columns, the ring and carries within a CTA's shared memory
  (counted by hand), the grid within the co-residency estimate, float16's
  plan bf16's; H = 0 refused, and the forward past 16896 units.
"""

import numpy as np
import pytest
import torch

from test_torch_wide_scan import check_plain_scans_against_jax, meta
from variational_mmt_torch import kernels
from variational_mmt_torch.ops import gru_scan

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
STREAMED = [1040, 1536, 2048, 2500, 4096]
H100_SMS = 132
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_reset", [False, True], ids=["no_reset", "reset"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("H", [1040, 1100])
def test_plain_scans_match_jax_kernels_above_1024(H, reverse, with_reset):
    check_plain_scans_against_jax(H, reverse, with_reset, TOL, TOL)


@pytest.mark.parametrize("B", [1, 61, 64, 256, 1000])
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("H", STREAMED)
def test_streamed_plans_hold_every_width_above_1024(H, dt, B):
    fwd = gru_scan.scan_fwd_plan(B, 24, H, dt, H100_SMS)
    bwd = gru_scan.scan_bwd_plan(B, 24, H, dt, H100_SMS)
    assert gru_scan.scan_kernel_holds(H, dt)
    # the forward's tiled plan: a CTA's rows x units cells for the call,
    # clusters splitting K, the grid co-resident, the row tiles and chunks
    # covering B
    plan = fwd
    assert plan["layout"] == "tiled" and (plan["rows"], plan["units"]) in gru_scan.TILED_FWD_TILES
    assert plan["unit_tiles"] * plan["units"] >= H > (plan["unit_tiles"] - 1) * plan["units"]
    assert plan["tiles"] == plan["unit_tiles"] * plan["row_tiles"]
    assert plan["grid"] == plan["ctas"] == plan["tiles"] * plan["cluster"] \
        <= gru_scan.tiled_co_resident(plan["cluster"], H100_SMS)
    chunk = plan["rows"] * plan["row_tiles"]
    assert plan["chunks"] * chunk >= B > (plan["chunks"] - 1) * chunk
    assert plan["smem"] == gru_scan.tiled_fwd_smem(
        plan["rows"], plan["units"], plan["cluster"], plan["resident"], plan["stages"],
        gru_scan.tiled_fwd_kc_own(H, dt, plan["cluster"]), dt) <= kernels.SMEM_PER_BLOCK
    # the backward's tiled plan: a cluster's CTAs own every cell of its
    # tile, the grid within what the card holds at once, shared memory
    # that does not grow with H
    assert bwd["layout"] == "tiled" and bwd["tiles"] == bwd["unit_tiles"] * bwd["row_tiles"]
    assert bwd["unit_tiles"] * bwd["units"] >= H > (bwd["unit_tiles"] - 1) * bwd["units"]
    assert bwd["grid"] <= gru_scan.tiled_co_resident(bwd["cluster"], H100_SMS)
    assert bwd["smem"] == gru_scan.tiled_smem(bwd["rows"], bwd["units"], bwd["cluster"],
                                              bwd["resident"],
                                              gru_scan.tiled_kc_own(H, dt, bwd["cluster"]),
                                              bwd["stages"])
    if bwd["engine"] == "tile":  # f32: tile_gemm.cuh's 64 x 64 tiles of dWh, no K split
        assert dt == torch.float32
        assert bwd["dwh_splits"] == 1 and bwd["dwh_tiles"] == -(-H // 64) * -(-3 * H // 64)
    else:  # the wgmma engine's 128 x bn tiles (tests/test_torch_scan_products.py)
        assert bwd["dwh_tiles"] == -(-H // 128) * -(-3 * H // bwd["gemm_bn"])


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_scan_kernel_holds_every_width(dt):
    assert all(gru_scan.scan_kernel_holds(H, dt) for H in range(1, 4097, 7))
    assert gru_scan.scan_kernel_holds(10_000, dt)
    assert not gru_scan.scan_kernel_holds(0, dt)
    assert gru_scan.scan_kernel_holds(1040, torch.float16)
    assert not gru_scan.scan_kernel_holds(1040, torch.float64)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("H", [257, 448, 500, 512, 1024, 1033, 2500])
def test_laid_out_weights_give_each_tiles_products(dt, H):
    """Emulates the tiled forward's ring on Wh as it reads it (in place
    where H elements are whole 16-byte pieces, else ``_tiled_fwd_weights``'
    copy), for every width of unit tile the plan takes (8 to 128): piece e
    of k-row k of unit tile t is ``per`` elements from k * ldw + g * ldg + t
    * units + u (gate g = e // ppg, u = (e % ppg) * per), zero where k >= H
    or t * units + u >= H, so the tile's operand over its K chunks gives
    round(h) @ Wh at its units' three gate columns, zero past H. Where the
    backward takes its tiled plan (above 512 units), emulates its ring on
    its weights: row u's K chunk c (kc elements at tiled_ld(H) a row) is
    Wh[u, c*kc:(c+1)*kc], zero past 3H, so the padded K adds nothing to
    dh_proj @ Wh^T."""
    rng = np.random.default_rng(H)
    Wh = torch.from_numpy(rng.standard_normal((H, 3 * H)).astype(np.float32)).to(dt)
    plans = {p["units"]: p for rows, units in gru_scan.TILED_FWD_TILES
             for p in [gru_scan.tiled_fwd_plan_for(16, H, dt, H100_SMS, rows, units, 1)]
             if p is not None}
    # the plan's own unit tile among them; 8 units to 512 at least (their
    # whole K beside Wh's columns in a CTA's shared memory), none past 132 *
    # 8 (a CTA an SM)
    assert fwd_tiled_plan(16, H, dt, H100_SMS)["units"] in plans
    assert (H > 512 or 8 in plans) and (H <= 8 * H100_SMS or 8 not in plans)
    for plan in plans.values():
        check_fwd_weights(Wh, plan, rng)
    bwd = gru_scan.scan_bwd_plan(16, 4, H, dt, H100_SMS)
    if bwd["layout"] == "tiled":
        check_bwd_weights(Wh, bwd, rng)


def check_fwd_weights(Wh: torch.Tensor, plan: dict, rng) -> None:
    """The tiled forward's ring on Wh, as ``test_laid_out_weights_give_each_tiles_products``
    says, for one plan."""
    H, dt = Wh.shape[0], Wh.dtype
    per = 16 // dt.itemsize
    wt = gru_scan._tiled_fwd_weights(Wh, plan)
    assert plan["in_place"] == (H % per == 0) == (wt is None)
    ldg = H if wt is None else plan["ldg"]
    assert ldg % per == 0 and 0 <= ldg - H < per
    w = Wh if wt is None else wt
    assert w.shape == (H, 3 * ldg) and w.is_contiguous()
    if wt is not None:
        assert not wt.view(H, 3, ldg)[:, :, H:].any()
        assert torch.equal(wt.view(H, 3, ldg)[:, :, :H], Wh.view(H, 3, H))
    units, kc, nk = plan["units"], plan["kc"], plan["k_chunks"]
    ppg = units * dt.itemsize // 16
    assert kc * dt.itemsize == gru_scan.TILED_CHUNK and (nk - 1) * kc < H <= nk * kc
    act = torch.zeros(5, plan["ldx"])  # the exchange buffer: zero past H
    act[:, :H] = torch.from_numpy(rng.standard_normal((5, H)).astype(np.float32))
    want = act[:, :H] @ Wh.float()
    ut = plan["unit_tiles"]
    for t in (0, ut // 2, ut - 1):
        u0 = t * units
        op = torch.zeros(nk * kc, 3 * units)  # the tile's operand, k-rows as the ring holds them
        for e in range(3 * ppg):
            g, u = divmod(e, ppg)
            u *= per
            if u0 + u < H:
                op[:H, g * units + u:g * units + u + per] = \
                    w[:, g * ldg + u0 + u:g * ldg + u0 + u + per].float()
        prod = torch.zeros(5, 3 * units)
        for c in range(nk):  # the ring's chunks
            prod += act[:, c * kc:(c + 1) * kc] @ op[c * kc:(c + 1) * kc]
        for g in range(3):
            for u in range(units):
                j = u0 + u
                if j < H:
                    torch.testing.assert_close(prod[:, g * units + u], want[:, g * H + j],
                                               rtol=1e-5, atol=1e-4)
                else:
                    assert not op[:, g * units + u].any()


def check_bwd_weights(Wh: torch.Tensor, bwd: dict, rng) -> None:
    """The tiled backward's ring on its weights, for one plan."""
    H, dt = Wh.shape[0], Wh.dtype
    wb = gru_scan._tiled_weights(Wh, bwd)
    assert bwd["in_place"] == (3 * H * dt.itemsize % 16 == 0)
    w = Wh if wb is None else wb
    ldw = 3 * H if wb is None else bwd["ldx"]
    assert w.shape == (H, ldw) and ldw * dt.itemsize % 16 == 0
    kc = bwd["kc"]
    dp = torch.zeros(5, bwd["ldx"])  # the exchange buffer: zero past 3H
    dp[:, :3 * H] = torch.from_numpy(rng.standard_normal((5, 3 * H)).astype(np.float32))
    got = torch.zeros(5, H)
    for c in range(bwd["k_chunks"]):  # the ring's chunks; pieces past ldw read as zero
        piece = torch.zeros(H, kc)
        piece[:, :max(0, min(kc, ldw - c * kc))] = w[:, c * kc:(c + 1) * kc].float()
        got += dp[:, c * kc:(c + 1) * kc] @ piece.t()
    torch.testing.assert_close(got, dp[:, :3 * H] @ Wh.float().t(), rtol=1e-5, atol=1e-3)
    if wb is not None:
        assert not wb[:, 3 * H:].any()


@pytest.fixture
def streamed_lib(monkeypatch):
    """A library that records the tiled launches' arguments."""
    calls = []

    class Lib:
        def vmmt_gru_tiled_fwd(self, *args):
            # padded weights, B, T, H, reverse, rows, units, cluster,
            # row_tiles, resident, stages (then probe, stream)
            calls.append(("fwd", args[-13]) + args[-12:-2])
            return 0

        def vmmt_gru_tiled_bwd(self, *args):
            # padded weights, B, T, H, reverse, rows, units, cluster,
            # row_tiles, resident, the scan's stages, splits, the wgmma
            # products' tile N and stages (then probe, stream)
            calls.append(("bwd", args[-16]) + args[-15:-2])
            return 0

    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    monkeypatch.setattr(kernels, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "aligned", lambda t: t.contiguous())
    return monkeypatch, calls


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_wrappers_launch_the_streamed_plan(streamed_lib, dt):
    """H = 2500: each pass reads Wh padded where its row pieces are not
    whole 16-byte pieces (the forward's 2500 elements of a gate and the
    backward's 7500 of a row in 16-bit dtypes), in place in f32."""
    monkeypatch, calls = streamed_lib
    B, T, H = 64, 25, 2500
    fwd = gru_scan.scan_fwd_plan(B, T, H, dt, H100_SMS)
    bwd = gru_scan.scan_bwd_plan(B, T, H, dt, H100_SMS)
    seen = []

    def occupancy(dev, lib, fn, code, *a):
        seen.append((fn, *a))
        if fn == "vmmt_gru_products_occupancy":  # the wgmma products: tile N, stages
            return 1, gru_scan.gemm_smem(*a)
        return 264, fwd["smem"] if fn == "vmmt_gru_tiled_fwd_occupancy" else bwd["smem"]

    monkeypatch.setattr(kernels, "occupancy", occupancy)
    ins = (meta(B, T, 3 * H, dtype=dt), meta(B, T), meta(B, H), meta(H, 3 * H, dtype=dt),
           meta(3 * H))
    probe = meta(1 + 4 * T, dtype=torch.int64)
    gru_scan.gru_layer_scan(*ins, reverse=True, probe=probe)
    gru_scan.gru_layer_scan_bwd(*ins, meta(B, T, H), meta(B, T, H))
    wgmma = bwd["engine"] == "wgmma"
    assert wgmma == (dt != torch.float32)
    products = (bwd["gemm_bn"], bwd["gemm_stages"]) if wgmma else (0, 0)
    assert seen == [("vmmt_gru_tiled_fwd_occupancy", H, fwd["rows"], fwd["units"],
                     fwd["cluster"], int(fwd["resident"]), fwd["stages"]),
                    ("vmmt_gru_tiled_bwd_occupancy", H, bwd["rows"], bwd["units"], bwd["cluster"],
                     int(bwd["resident"]), bwd["stages"])] + \
        [("vmmt_gru_products_occupancy", *products)] * wgmma
    assert fwd["in_place"] == bwd["in_place"] == (dt == torch.float32)
    assert [c[1] is not None for c in calls] == [dt != torch.float32] * 2
    if dt != torch.float32:
        wt = gru_scan._tiled_fwd_weights(meta(H, 3 * H, dtype=dt), fwd)
        assert tuple(wt.shape) == (H, 3 * fwd["ldg"]) and fwd["ldg"] == 2504
    assert [c[0:1] + c[2:] for c in calls] == [
        ("fwd", B, T, H, 1, fwd["rows"], fwd["units"], fwd["cluster"], fwd["row_tiles"],
         int(fwd["resident"]), fwd["stages"]),
        ("bwd", B, T, H, 0, bwd["rows"], bwd["units"], bwd["cluster"], bwd["row_tiles"],
         int(bwd["resident"]), bwd["stages"], bwd["dwh_splits"], *products)]
    assert gru_scan.gru_layer_scan.plan == dict(fwd, max_co_resident=264)
    assert gru_scan.gru_layer_scan_bwd.plan == dict(bwd, max_co_resident=264,
                                                    **({"gemm_per_sm": 1} if wgmma else {}))
    with pytest.raises(ValueError, match="probe"):
        gru_scan.gru_layer_scan(*ins, probe=meta(4 * T, dtype=torch.int64))


def test_wrappers_refuse_a_streamed_grid_the_card_cannot_hold(streamed_lib):
    """Raises naming the tiled plan before anything is launched; never the
    plain scan in the kernel's place."""
    monkeypatch, calls = streamed_lib
    B, T, H = 64, 25, 2048
    plan = gru_scan.scan_fwd_plan(B, T, H, torch.float32, H100_SMS)
    monkeypatch.setattr(kernels, "occupancy", lambda *a: (plan["grid"] - 1, plan["smem"]))
    ins = (meta(B, T, 3 * H), meta(B, T), meta(B, H), meta(H, 3 * H), meta(3 * H))
    with pytest.raises(NotImplementedError, match="tiled plan.*at once"):
        gru_scan.gru_layer_scan(*ins)
    monkeypatch.setattr(kernels, "occupancy", lambda *a: (1000, plan["smem"] + 16))
    with pytest.raises(RuntimeError, match="shared"):
        gru_scan.gru_layer_scan(*ins)
    assert calls == []


# the backward's tiled plan at every width above 512 and every batch, and
# below 513 units, where it competes with the cluster plan
TILED_WIDTHS = [513, 520, 1000, 1002, 1024, 1040, 2048, 2500, 4096]
TILED_BATCHES = [1, 17, 64, 256, 1024, 4096]
TILED_BWD_WIDTHS = [449, 480, 500, 512] + TILED_WIDTHS
# the forward's tiled plan also below 513 units, where it competes with the
# cluster plan (500: gates not on 16-byte pieces in 16 bits)
TILED_FWD_WIDTHS = [257, 300, 384, 448, 500, 512] + TILED_WIDTHS


def fwd_tiled_plan(B: int, H: int, dt, sms: int) -> dict:
    """The forward's tiled plan: the wrapper's plan above 512 units, the
    tiled planner's below (where the wrapper's may be the cluster plan)."""
    if H > gru_scan.SCAN_CLUSTER_MAX_HIDDEN:
        return gru_scan.scan_fwd_plan(B, 24, H, dt, sms)
    return gru_scan.tiled_fwd_plan(B, H, dt, sms)


@pytest.mark.parametrize("sms", [H100_SMS, 114])
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B", TILED_BATCHES)
@pytest.mark.parametrize("H", TILED_BWD_WIDTHS)
def test_tiled_plan_covers_every_cell_once(H, B, dt, sms):
    """Follows the kernel's own index arithmetic (gru_tiled_bwd_kernel,
    launch_tiled): launch chunks of rows * row_tiles rows, CTA b of a
    launch in tile b // cluster (unit tile fastest), owning rows / cluster
    of its rows and units below H; every (row, unit) cell is owned exactly
    once, and the unit tiles reach no further than the last. Each rank's
    K chunks are disjoint and cover 3H once within the exchange row; the
    tile is whole warp tiles (16 x 8 on the narrow tiles, 32 x 32 else)
    whose K groups fill the eight warps, at most 4 in a cluster; the ring,
    the partial products and the carries fit a CTA's shared memory (counted
    by hand: Wh's rows held there beside the whole K of the tile's rows of
    dh_proj, or beside 4 stages, or brought by the ring), the ring the
    cheapest by the plan's cost model of those that fit; the grid is within
    the co-residency estimate; float16's plan is bf16's. Below 513 units
    the tiled planner's plan (the wrapper's where the cluster plan runs in
    waves)."""
    plan = (gru_scan.scan_bwd_plan(B, 24, H, dt, sms) if H > gru_scan.SCAN_CLUSTER_MAX_HIDDEN
            else gru_scan.tiled_bwd_plan(B, 24, H, dt, sms))
    rows, units, C = plan["rows"], plan["units"], plan["cluster"]
    assert plan["layout"] == "tiled" and (rows, units) in gru_scan.TILED_TILES
    assert C in gru_scan.TILED_CLUSTERS and rows % 16 == 0 and units % 8 == 0
    chunk = rows * plan["row_tiles"]
    assert (plan["unit_tiles"] - 1) * units < H <= plan["unit_tiles"] * units
    owned = np.zeros((B, H), np.int8)
    launches = 0
    for b0 in range(0, B, chunk):
        nb = min(chunk, B - b0)
        grid = -(-nb // rows) * plan["unit_tiles"] * C
        assert grid <= plan["grid"] <= gru_scan.tiled_co_resident(C, sms)
        for blk in range(grid):
            tile, rank = divmod(blk, C)
            r0 = b0 + (tile // plan["unit_tiles"]) * rows + rank * (rows // C)
            u0 = (tile % plan["unit_tiles"]) * units
            owned[r0:min(r0 + rows // C, b0 + nb), u0:min(u0 + units, H)] += 1
        launches += 1
    assert launches == plan["chunks"]
    assert (owned == 1).all()

    kc, nk = plan["kc"], plan["k_chunks"]
    assert kc * dt.itemsize == gru_scan.TILED_CHUNK and (nk - 1) * kc < 3 * H <= nk * kc
    assert nk * kc <= plan["ldx"] == gru_scan.tiled_ld(H, dt)
    parts = [gru_scan.tiled_k_chunks(H, dt, C, r) for r in range(C)]
    assert [c for part in parts for c in part] == list(range(nk))
    assert all(len(part) > 0 for part in parts)

    narrow = rows < 32 or units < 32
    warp_m, warp_n = (16, 8) if narrow else (32, 32)
    assert gru_scan.tiled_warp_tile(rows, units) == (warp_m, warp_n)
    wk = 8 // ((rows // warp_m) * (units // warp_n))
    assert (rows // warp_m) * (units // warp_n) * wk == 8 and wk in ((1, 2, 4, 8) if C == 1
                                                                     else (1, 2, 4))
    pitch = -(-nk // C) * 128 + 16
    w = units * pitch
    red = wk * rows * (units + 4) * 4
    cells = 2 * (rows // C) * units * 4

    def ring_smem(res: bool, stages: int) -> int:
        if stages == 1:  # the whole K of the tile's rows at Wh's pitch, and an mbarrier
            return -(-(w + max(rows * pitch, red) + cells) // 16) * 16 + 16
        return res * w + stages * (rows + (0 if res else units)) * 144 + red + cells

    fits = [ring for ring in gru_scan.TILED_BWD_RINGS if ring_smem(*ring) <= kernels.SMEM_PER_BLOCK]
    res, stages = plan["resident"], plan["stages"]
    assert (res, stages) in fits and stages in (1, 4) and (res or stages > 1)
    cost = gru_scan._tiled_cost(B, H, dt, plan)
    for ring in fits:
        other = gru_scan.tiled_plan_for(B, H, dt, sms, rows, units, C, (ring,))
        assert other["smem"] == ring_smem(*ring) and cost <= gru_scan._tiled_cost(B, H, dt, other)
    assert plan["smem"] == ring_smem(res, stages) <= kernels.SMEM_PER_BLOCK
    assert plan["wh_from"] in (("smem",) if res else ("l2", "hbm"))
    assert plan["in_place"] == (3 * H * dt.itemsize % 16 == 0)
    if dt == torch.float16:
        assert plan == (gru_scan.scan_bwd_plan(B, 24, H, torch.bfloat16, sms)
                        if H > gru_scan.SCAN_CLUSTER_MAX_HIDDEN
                        else gru_scan.tiled_bwd_plan(B, 24, H, torch.bfloat16, sms))


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_tiled_plan_refuses_no_width(dt):
    """H = 0 is refused before anything is launched; every H from 513 on
    has a tiled plan on 132 and 114 SMs, and so has every H from 449 to 512
    (where the wrapper takes it wherever the cluster plan runs in waves),
    with tiles of 8 and 16 units among those that fit there."""
    with pytest.raises(NotImplementedError):
        gru_scan.scan_bwd_plan(64, 24, 0, dt, H100_SMS)
    for H in range(513, 4097, 97):
        for sms in (H100_SMS, 114):
            assert gru_scan.scan_bwd_plan(64, 24, H, dt, sms)["layout"] == "tiled"
    for H in range(449, 513, 7):
        for sms in (H100_SMS, 114):
            assert gru_scan.tiled_bwd_plan(64, 24, H, dt, sms)["layout"] == "tiled"
            narrow = [gru_scan.tiled_plan_for(64, H, dt, sms, rows, units, 1)
                      for rows, units in gru_scan.TILED_TILES if units < 32]
            assert any(p is not None and p["stages"] == gru_scan.TILED_BWD_WHOLE_K
                       for p in narrow)


@pytest.mark.parametrize("sms", [H100_SMS, 114])
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B", TILED_BATCHES)
@pytest.mark.parametrize("H", TILED_FWD_WIDTHS)
def test_tiled_fwd_plan_covers_every_cell_once(H, B, dt, sms):
    """Follows the forward kernel's own index arithmetic
    (gru_tiled_fwd_kernel, launch_tiled_fwd): launch chunks of rows *
    row_tiles rows, CTA b of a launch in tile b // cluster (unit tile
    fastest), owning rows / cluster of its rows and units below H; every
    (row, unit) cell is owned exactly once. Each rank's K chunks are
    disjoint and cover H once within the exchange row; each tile's N (its
    warps' 48-column tiles, 24 at 8 units) holds its units' three gate
    columns of Wh once, as the ring's pieces read them; the ring, the
    partial products, the biases and the carry fit a CTA's shared memory
    (counted by hand, with Wh's columns held there or brought by the ring),
    the ring the cheapest by the plan's cost model of those that fit; the
    grid is within the co-residency estimate; float16's plan is bf16's."""
    plan = fwd_tiled_plan(B, H, dt, sms)
    rows, units, C = plan["rows"], plan["units"], plan["cluster"]
    assert plan["layout"] == "tiled" and (rows, units) in gru_scan.TILED_FWD_TILES
    assert C in gru_scan.TILED_CLUSTERS
    chunk = rows * plan["row_tiles"]
    assert (plan["unit_tiles"] - 1) * units < H <= plan["unit_tiles"] * units
    owned = np.zeros((B, H), np.int8)
    launches = 0
    for b0 in range(0, B, chunk):
        nb = min(chunk, B - b0)
        grid = -(-nb // rows) * plan["unit_tiles"] * C
        assert grid <= plan["grid"] <= gru_scan.tiled_co_resident(C, sms)
        for blk in range(grid):
            tile, rank = divmod(blk, C)
            r0 = b0 + (tile // plan["unit_tiles"]) * rows + rank * (rows // C)
            u0 = (tile % plan["unit_tiles"]) * units
            owned[r0:min(r0 + rows // C, b0 + nb), u0:min(u0 + units, H)] += 1
        launches += 1
    assert launches == plan["chunks"]
    assert (owned == 1).all()

    kc, nk = plan["kc"], plan["k_chunks"]
    assert kc * dt.itemsize == gru_scan.TILED_CHUNK and (nk - 1) * kc < H <= nk * kc
    assert plan["ldx"] == nk * kc
    parts = [gru_scan.tiled_fwd_k_chunks(H, dt, C, r) for r in range(C)]
    assert [c for part in parts for c in part] == list(range(nk))
    assert all(len(part) > 0 for part in parts)

    # the tile's N: the warps' 48-column tiles (32 rows each; 16 x 24 at 8
    # units), the ring's pieces of a k-row (per elements of gate e // ppg
    # at unit (e % ppg) * per)
    warp_m, warp_n = (16, 24) if units == 8 else (32, 48)
    assert gru_scan.tiled_fwd_warp_tile(units) == (warp_m, warp_n)
    wn = 3 * units // warp_n
    assert wn * warp_n == 3 * units and rows % warp_m == 0
    per, ppg = 16 // dt.itemsize, units * dt.itemsize // 16
    for u0 in {0, (plan["unit_tiles"] - 1) * units}:
        cols = [g * H + u0 + (e % ppg) * per + i for e in range(3 * ppg)
                for g in [e // ppg] for i in range(per) if u0 + (e % ppg) * per + i < H]
        assert sorted(cols) == [g * H + j for g in range(3) for j in range(u0, min(u0 + units, H))]

    wk = 8 // ((rows // warp_m) * wn)
    assert wk in (1, 2, 4) and (rows // warp_m) * wn * wk == 8
    w_pitch = 3 * units * dt.itemsize + 16
    red = wk * rows * (3 * units + 4) * 4
    fixed = (3 * units + rows // C * units) * 4
    w = -(-nk // C) * kc * w_pitch

    def ring_smem(res: bool, stages: int) -> int:
        if stages == 1:  # the whole K of the tile's rows, 16 bytes apart, and an mbarrier
            return -(-(w + max(rows * (-(-nk // C) * 128 + 16), red) + fixed) // 16) * 16 + 16
        return w + max(stages * rows * 144, red) + fixed if res else \
            stages * (rows * 144 + kc * w_pitch) + red + fixed

    # of the rings that fit (Wh's columns resident or brought by a ring of 4
    # or 2 stages; resident, the whole K in one stage), the plan takes the
    # one its cost model ranks first
    fits = [ring for ring in gru_scan.TILED_FWD_RINGS  # 8 units: the whole-K stage only
            if ring_smem(*ring) <= kernels.SMEM_PER_BLOCK and (units > 8 or ring[1] == 1)]
    res, stages = plan["resident"], plan["stages"]
    assert (res, stages) in fits and stages in (1, 2, 4) and (res or stages > 1)
    cost = gru_scan._tiled_fwd_cost(B, H, dt, plan)
    for ring in fits:
        other = gru_scan.tiled_fwd_plan_for(B, H, dt, sms, rows, units, C, (ring,))
        assert other["smem"] == ring_smem(*ring) and cost <= gru_scan._tiled_fwd_cost(B, H, dt,
                                                                                     other)
    assert plan["smem"] == ring_smem(res, stages) <= kernels.SMEM_PER_BLOCK
    assert plan["wh_from"] in (("smem",) if res else ("l2", "hbm"))
    assert plan["in_place"] == (H % per == 0)
    if dt == torch.float16:
        assert plan == fwd_tiled_plan(B, H, torch.bfloat16, sms)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_tiled_fwd_plan_refuses_no_width(dt):
    """H = 0 is refused before anything is launched; every H from 513 on
    has a tiled forward plan on 132 and 114 SMs, to 16896 units on 132 (a
    unit tile of 128 an SM, its ring of 2 stages); 16897 has none."""
    with pytest.raises(NotImplementedError):
        gru_scan.scan_fwd_plan(64, 24, 0, dt, H100_SMS)
    for H in range(513, 4097, 97):
        for sms in (H100_SMS, 114):
            assert gru_scan.scan_fwd_plan(64, 24, H, dt, sms)["layout"] == "tiled"
    widest = gru_scan.scan_fwd_plan(64, 24, 16896, dt, H100_SMS)
    assert (widest["units"], widest["grid"], widest["stages"]) == (128, 132, 2)
    with pytest.raises(NotImplementedError, match="no tiling"):
        gru_scan.scan_fwd_plan(64, 24, 16897, dt, H100_SMS)
    assert gru_scan.scan_kernel_holds(16896, dt) and not gru_scan.scan_kernel_holds(16897, dt)
