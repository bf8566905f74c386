"""PyTorch port: the GRU-scan kernels (rows 1 and 2) above 1024 units, the
streamed plan, on the CPU.

- The plain versions ``gru_layer_scan_ref`` and ``gru_layer_scan_bwd_ref``
  (what the streamed kernels are held to on the card) against JAX's
  ``gru_layer_scan`` and ``gru_layer_scan_ad`` in interpret mode at H =
  1040 and 1100, B = 3, T = 5, both directions, with and without a reset
  stream, f32: outputs, finals, dx, dh0, dWh, dbh and the VJP within 1e-5.
- The streamed launch plans (``layout`` ``"streamed"``) at H = 1040, 1536,
  2048, 2500 and 4096 in the three dtypes, batches 1, 61, 64, 256 and 1000: one
  launch, the grid within what 132 SMs hold at once and at most the tiles,
  every tile owned, shared memory the product buffer alone (counted by
  hand) whatever H.
- The weights as the wrapper lays them out for the kernels
  (``_stream_weights``), read the way ``block_product`` reads a unit
  tile's slice, give round(h) @ Wh (forward) and dh_proj @ Wh^T
  (backward) of that tile's units, zero past H.
- The wrappers launch the streamed entry points with the plan, the laid
  out weights and the grid, and raise naming the plan, before any launch,
  where the card cannot hold the grid at once.
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
    for pass_, plan in ((0, fwd), (1, bwd)):
        assert plan["layout"] == "streamed" and plan["chunks"] == 1
        assert plan["units"] == (8 if bf16 else 4)
        assert plan["unit_tiles"] * plan["units"] >= H > (plan["unit_tiles"] - 1) * plan["units"]
        assert plan["rows"] == rows <= gru_scan.SCAN_WIDE_MAX_ROWS
        assert plan["row_tiles"] * plan["rows"] >= B > (plan["row_tiles"] - 1) * plan["rows"]
        assert plan["tiles"] == plan["unit_tiles"] * plan["row_tiles"]
        # a cooperative grid: co-resident on 132 SMs (one bf16 CTA an SM,
        # two in f32), each CTA taking tiles_per_cta tiles at most a step
        assert plan["grid"] == plan["ctas"] == min(plan["tiles"], (1 if bf16 else 2) * H100_SMS)
        assert (plan["tiles_per_cta"] - 1) * plan["grid"] < plan["tiles"] \
            <= plan["tiles_per_cta"] * plan["grid"]
        # shared memory: the product buffer (3 n-tiles of 8 floats a row
        # forward, one backward; in bf16 at least 128 rows for the warps'
        # K-split partial sums), nothing that grows with H
        prod_rows = max(128, rows) if bf16 else rows
        assert plan["smem"] == prod_rows * (3 if pass_ == 0 else 1) * 8 * 4
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
    """Emulates ``block_product`` on the laid-out weights: forward, unit
    tile t's n-tile g, row u is column g*H + t*units + u of Wh over K; the
    backward's row u is row t*units + u of Wh over 3H. Both zero past H
    (and past the row's width), so the padded K adds nothing."""
    rng = np.random.default_rng(H)
    Wh = torch.from_numpy(rng.standard_normal((H, 3 * H)).astype(np.float32)).to(dt)
    plan = gru_scan.scan_fwd_plan(16, 4, H, dt, H100_SMS)
    units, ut = plan["units"], plan["unit_tiles"]
    bf16 = dt != torch.float32  # bf16 and f16: rows at the mma stride
    wt = gru_scan._stream_weights(Wh, 0, plan)
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

    wb = gru_scan._stream_weights(Wh, 1, plan)
    assert wb.shape == (ut * units, kernels.frag_ld(3 * H, bf16))
    dp = torch.zeros(5, kernels.pad32(3 * H))
    dp[:, :3 * H] = torch.from_numpy(rng.standard_normal((5, 3 * H)).astype(np.float32))
    torch.testing.assert_close((dp @ wb[:, :dp.shape[1]].float().t())[:, :H],
                               dp[:, :3 * H] @ Wh.float().t(), rtol=1e-5, atol=1e-4)
    assert not wb[H:].any() and not wb[:, 3 * H:].any()


@pytest.fixture
def streamed_lib(monkeypatch):
    """A library that records the streamed launches' arguments."""
    calls = []

    class Lib:
        def vmmt_gru_wide(self, *args):
            # laid-out weights, B, T, H, reverse, units, rows, row_tiles, grid
            calls.append(("fwd", args[-10]) + args[-9:-1])
            return 0

        def vmmt_gru_wide_bwd(self, *args):
            calls.append(("bwd", args[-11]) + args[-10:-1])  # ..., grid, splits
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
    smem = {0: fwd["smem"], 1: bwd["smem"]}
    seen = []

    def occupancy(dev, lib, fn, code, pass_, H_, units, rows, streamed):
        seen.append((fn, pass_, H_, units, rows, streamed))
        return 264, smem[pass_]

    monkeypatch.setattr(kernels, "occupancy", occupancy)
    ins = (meta(B, T, 3 * H, dtype=dt), meta(B, T), meta(B, H), meta(H, 3 * H, dtype=dt),
           meta(3 * H))
    gru_scan.gru_layer_scan(*ins, reverse=True)
    gru_scan.gru_layer_scan_bwd(*ins, meta(B, T, H), meta(B, T, H))
    assert seen == [("vmmt_gru_wide_occupancy", p, H, plan["units"], plan["rows"], 1)
                    for p, plan in ((0, fwd), (1, bwd))]
    assert [c[1] is not None for c in calls] == [True, True]  # weights laid out
    assert [c[0:1] + c[2:] for c in calls] == [
        ("fwd", B, T, H, 1, fwd["units"], fwd["rows"], fwd["row_tiles"], fwd["grid"]),
        ("bwd", B, T, H, 0, bwd["units"], bwd["rows"], bwd["row_tiles"], bwd["grid"], 1)]
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
