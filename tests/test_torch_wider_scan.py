"""PyTorch port: the GRU-scan kernels (rows 1 and 2) above 1024 units (the
forward's streamed plan) and the backward's tiled plan above 512, on the
CPU.

- The plain versions ``gru_layer_scan_ref`` and ``gru_layer_scan_bwd_ref``
  (what the streamed kernels are held to on the card) against JAX's
  ``gru_layer_scan`` and ``gru_layer_scan_ad`` in interpret mode at H =
  1040 and 1100, B = 3, T = 5, both directions, with and without a reset
  stream, f32: outputs, finals, dx, dh0, dWh, dbh and the VJP within 1e-5.
- The forward's streamed launch plans (``layout`` ``"streamed"``) at H =
  1040, 1536, 2048, 2500 and 4096 in the three dtypes, batches 1, 61, 64,
  256 and 1000: one launch, the grid within what 132 SMs hold at once and
  at most the tiles, every tile owned, shared memory the product buffer
  alone (counted by hand) whatever H; the backward's tiled plans there.
- The weights as the wrappers lay them out for the kernels: the forward's
  (``_stream_weights``), read the way ``block_product`` reads a unit
  tile's slice, give round(h) @ Wh of that tile's units, zero past H; the
  backward's (``_tiled_weights``), read the way the tiled kernel's ring
  reads a K chunk, give dh_proj @ Wh^T, zero past 3H.
- The wrappers launch the streamed and tiled entry points with the plans,
  the laid-out weights and the grid, and raise naming the plan, before any
  launch, where the card cannot hold the grid at once.
- The tiled plan at H = 513 to 4096 and B = 1 to 4096 in the three dtypes
  on cards of 132 and 114 SMs: every (row, unit) cell owned by exactly one
  CTA of one launch, each tile's K chunks covering 3H once, the ring and
  carries within a CTA's shared memory, the grid within the co-residency
  estimate, float16's plan bf16's; H = 0 refused.
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
    bf16 = dt != torch.float32  # bf16 and f16: the tensor cores' tiling
    rows = kernels.align16(-(-B // -(-B // 256)))
    plan = fwd
    assert plan["layout"] == "streamed" and plan["chunks"] == 1
    assert plan["units"] == (8 if bf16 else 4)
    assert plan["unit_tiles"] * plan["units"] >= H > (plan["unit_tiles"] - 1) * plan["units"]
    assert plan["rows"] == rows <= gru_scan.SCAN_WIDE_MAX_ROWS
    assert plan["row_tiles"] * plan["rows"] >= B > (plan["row_tiles"] - 1) * plan["rows"]
    assert plan["tiles"] == plan["unit_tiles"] * plan["row_tiles"]
    # a cooperative grid: co-resident on 132 SMs (one bf16 CTA an SM, two
    # in f32), each CTA taking tiles_per_cta tiles at most a step
    assert plan["grid"] == plan["ctas"] == min(plan["tiles"], (1 if bf16 else 2) * H100_SMS)
    assert (plan["tiles_per_cta"] - 1) * plan["grid"] < plan["tiles"] \
        <= plan["tiles_per_cta"] * plan["grid"]
    # shared memory: the product buffer (3 n-tiles of 8 floats a row; in
    # bf16 at least 128 rows for the warps' K-split partial sums), nothing
    # that grows with H
    prod_rows = max(128, rows) if bf16 else rows
    assert plan["smem"] == prod_rows * 3 * 8 * 4
    # the backward's tiled plan: a cluster's CTAs own every cell of its
    # tile, the grid within what the card holds at once, shared memory
    # that does not grow with H
    assert bwd["layout"] == "tiled" and bwd["tiles"] == bwd["unit_tiles"] * bwd["row_tiles"]
    assert bwd["unit_tiles"] * bwd["units"] >= H > (bwd["unit_tiles"] - 1) * bwd["units"]
    assert bwd["grid"] <= gru_scan.tiled_co_resident(bwd["cluster"], H100_SMS)
    assert bwd["smem"] == gru_scan.tiled_smem(bwd["rows"], bwd["units"], bwd["cluster"],
                                              bwd["resident"],
                                              gru_scan.tiled_kc_own(H, dt, bwd["cluster"]))
    assert bwd["dwh_splits"] == 1 and bwd["dwh_tiles"] == -(-H // 64) * -(-3 * H // 64)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_scan_kernel_holds_every_width(dt):
    assert all(gru_scan.scan_kernel_holds(H, dt) for H in range(1, 4097, 7))
    assert gru_scan.scan_kernel_holds(10_000, dt)
    assert not gru_scan.scan_kernel_holds(0, dt)
    assert gru_scan.scan_kernel_holds(1040, torch.float16)
    assert not gru_scan.scan_kernel_holds(1040, torch.float64)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("H", [1033, 2500])
def test_laid_out_weights_give_each_tiles_products(dt, H):
    """Emulates ``block_product`` on the forward's laid-out weights: unit
    tile t's n-tile g, row u is column g*H + t*units + u of Wh over K, zero
    past H. Emulates the tiled kernel's ring on the backward's: row u's K
    chunk c (kc elements at tiled_ld(H) a row) is Wh[u, c*kc:(c+1)*kc],
    zero past 3H, so the padded K adds nothing to dh_proj @ Wh^T."""
    rng = np.random.default_rng(H)
    Wh = torch.from_numpy(rng.standard_normal((H, 3 * H)).astype(np.float32)).to(dt)
    plan = gru_scan.scan_fwd_plan(16, 4, H, dt, H100_SMS)
    units, ut = plan["units"], plan["unit_tiles"]
    bf16 = dt != torch.float32  # bf16 and f16: rows at the mma stride
    wt = gru_scan._stream_weights(Wh, plan)
    ld = kernels.frag_ld(H, bf16)
    assert wt.shape == (ut, 3, units, ld) and wt.is_contiguous()
    act = torch.zeros(5, kernels.pad32(H))  # the exchange buffer: zero past H
    act[:, :H] = torch.from_numpy(rng.standard_normal((5, H)).astype(np.float32))
    want = act[:, :H] @ Wh.float()
    for t in (0, ut // 2, ut - 1):
        prod = act @ wt[t, :, :, :act.shape[1]].float().reshape(3 * units, -1).t()
        for g in range(3):
            for u in range(units):
                j = t * units + u
                if j < H:
                    torch.testing.assert_close(prod[:, g * units + u], want[:, g * H + j],
                                               rtol=1e-5, atol=1e-4)
                else:
                    assert not wt[t, g, u].any()
    assert not wt[..., H:].any()

    bwd = gru_scan.scan_bwd_plan(16, 4, H, dt, H100_SMS)
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
    """A library that records the streamed launches' arguments."""
    calls = []

    class Lib:
        def vmmt_gru_wide(self, *args):
            # laid-out weights, B, T, H, reverse, units, rows, row_tiles, grid
            calls.append(("fwd", args[-10]) + args[-9:-1])
            return 0

        def vmmt_gru_tiled_bwd(self, *args):
            # padded weights, B, T, H, reverse, rows, units, cluster,
            # row_tiles, resident, splits (then probe, stream)
            calls.append(("bwd", args[-13]) + args[-12:-2])
            return 0

    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    monkeypatch.setattr(kernels, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    return monkeypatch, calls


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_wrappers_launch_the_streamed_plan(streamed_lib, dt):
    monkeypatch, calls = streamed_lib
    B, T, H = 64, 25, 2048
    fwd = gru_scan.scan_fwd_plan(B, T, H, dt, H100_SMS)
    bwd = gru_scan.scan_bwd_plan(B, T, H, dt, H100_SMS)
    seen = []

    def occupancy(dev, lib, fn, code, *a):
        seen.append((fn, *a))
        return 264, fwd["smem"] if fn == "vmmt_gru_wide_occupancy" else bwd["smem"]

    monkeypatch.setattr(kernels, "occupancy", occupancy)
    ins = (meta(B, T, 3 * H, dtype=dt), meta(B, T), meta(B, H), meta(H, 3 * H, dtype=dt),
           meta(3 * H))
    gru_scan.gru_layer_scan(*ins, reverse=True)
    gru_scan.gru_layer_scan_bwd(*ins, meta(B, T, H), meta(B, T, H))
    assert seen == [("vmmt_gru_wide_occupancy", H, fwd["units"], fwd["rows"], 1),
                    ("vmmt_gru_tiled_bwd_occupancy", H, bwd["rows"], bwd["units"], bwd["cluster"],
                     int(bwd["resident"]))]
    # the forward's weights laid out; the backward reads Wh in place (3H
    # elements are whole 16-byte pieces at H = 2048)
    assert [c[1] is not None for c in calls] == [True, False]
    assert [c[0:1] + c[2:] for c in calls] == [
        ("fwd", B, T, H, 1, fwd["units"], fwd["rows"], fwd["row_tiles"], fwd["grid"]),
        ("bwd", B, T, H, 0, bwd["rows"], bwd["units"], bwd["cluster"], bwd["row_tiles"],
         int(bwd["resident"]), 1)]
    assert gru_scan.gru_layer_scan.plan == dict(fwd, max_co_resident=264)
    assert gru_scan.gru_layer_scan_bwd.plan == dict(bwd, max_co_resident=264)


def test_wrappers_refuse_a_streamed_grid_the_card_cannot_hold(streamed_lib):
    """Raises naming the streamed plan before anything is launched; never
    the plain scan in the kernel's place."""
    monkeypatch, calls = streamed_lib
    B, T, H = 64, 25, 2048
    plan = gru_scan.scan_fwd_plan(B, T, H, torch.float32, H100_SMS)
    monkeypatch.setattr(kernels, "occupancy", lambda *a: (plan["grid"] - 1, plan["smem"]))
    ins = (meta(B, T, 3 * H), meta(B, T), meta(B, H), meta(H, 3 * H), meta(3 * H))
    with pytest.raises(NotImplementedError, match="streamed plan.*at once"):
        gru_scan.gru_layer_scan(*ins)
    monkeypatch.setattr(kernels, "occupancy", lambda *a: (1000, plan["smem"] + 16))
    with pytest.raises(RuntimeError, match="shared"):
        gru_scan.gru_layer_scan(*ins)
    assert calls == []


# the backward's tiled plan at every width above 512 and every batch
TILED_WIDTHS = [513, 520, 1000, 1002, 1024, 1040, 2048, 2500, 4096]
TILED_BATCHES = [1, 17, 64, 256, 1024, 4096]


@pytest.mark.parametrize("sms", [H100_SMS, 114])
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B", TILED_BATCHES)
@pytest.mark.parametrize("H", TILED_WIDTHS)
def test_tiled_plan_covers_every_cell_once(H, B, dt, sms):
    """Follows the kernel's own index arithmetic (gru_tiled_bwd_kernel,
    launch_tiled): launch chunks of rows * row_tiles rows, CTA b of a
    launch in tile b // cluster (unit tile fastest), owning rows / cluster
    of its rows and units below H; every (row, unit) cell is owned exactly
    once, and the unit tiles reach no further than the last. Each rank's
    K chunks are disjoint and cover 3H once within the exchange row; the
    ring, the partial products and the carries fit a CTA's shared memory
    (counted by hand; Wh's rows held there where they fit beside the 4
    stages); the grid is within the co-residency estimate;
    float16's plan is bf16's."""
    plan = gru_scan.scan_bwd_plan(B, 24, H, dt, sms)
    rows, units, C = plan["rows"], plan["units"], plan["cluster"]
    assert plan["layout"] == "tiled" and (rows, units) in gru_scan.TILED_TILES
    assert C in gru_scan.TILED_CLUSTERS and rows % 16 == 0 and units >= 32
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

    wk = 8 * 32 * 32 // (rows * units)
    assert wk in (1, 2, 4) and (rows // 32) * (units // 32) * wk == 8
    res = plan["resident"]
    fixed = wk * rows * (units + 4) * 4 + 2 * (rows // C) * units * 4
    w = units * (-(-nk // C) * 128 + 16)
    assert res == (w + 4 * rows * 144 + fixed <= kernels.SMEM_PER_BLOCK)
    assert plan["stages"] == 4
    smem = res * w + 4 * (rows + (0 if res else units)) * 144 + fixed
    assert plan["smem"] == smem <= kernels.SMEM_PER_BLOCK
    assert plan["wh_from"] in (("smem",) if res else ("l2", "hbm"))
    assert plan["in_place"] == (3 * H * dt.itemsize % 16 == 0)
    if dt == torch.float16:
        assert plan == gru_scan.scan_bwd_plan(B, 24, H, torch.bfloat16, sms)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_tiled_plan_refuses_no_width(dt):
    """H = 0 is refused before anything is launched; every H from 513 on
    has a tiled plan on 132 and 114 SMs."""
    with pytest.raises(NotImplementedError):
        gru_scan.scan_bwd_plan(64, 24, 0, dt, H100_SMS)
    for H in range(513, 4097, 97):
        for sms in (H100_SMS, 114):
            assert gru_scan.scan_bwd_plan(64, 24, H, dt, sms)["layout"] == "tiled"
