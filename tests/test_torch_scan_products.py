"""PyTorch port: row 2's hoisted products on the wgmma engine (the gate
recompute hp = round(h_prev) @ Wh + bh and dWh = round(h_prev)^T
round(dh_proj), ``csrc/wgmma_gemm.cuh``), on the CPU.

- The products' launch plan (``products_plan`` inside ``scan_bwd_plan``)
  at H = 8-4096, B = 1-4096, T = 24 and 1, the three dtypes, on 132 and
  114 SMs, checked by hand: float32 keeps tile_gemm.cuh ("tile"), float16
  plans as bfloat16; Hs and dP rows padded to 8 values; TMA boxes within
  256 a side with inner rows of 16-byte multiples within the 128-byte
  swizzle; shared memory as the kernel counts it and within a CTA's 227
  KB; dWh's K split in a fixed order covering every 64-deep slice once;
  scratch enough for the split and the operand pass's column sums.
- ``scan_bwd_products_ref`` (what the kernels are held to on the card)
  against JAX's ``_gru_scan_bwd_impl`` in interpret mode: dWh and dbh from
  the port's own backward's dx_proj and dh_proj, and hp against the gate
  products ``gru_layer_scan_bwd_ref`` forms step by step; H = 40, 250 (3H
  not a whole number of 16-byte pieces: Wh copied) and 520 (the tiled
  plan), both directions, with and without a reset stream: against the
  step-by-step products within 1e-5 in every dtype; against JAX within
  1e-5 in float32, and bfloat16 and float16's dWh within 1e-3 of its
  largest entry (``JAX_16BIT_TOL``: 16-bit roundings of dh_proj that the
  frameworks' f32 sums leave an ulp apart).
- The wrappers on a library that records its arguments: the engine the
  dtype picks, tile N, stages and split the plan gives, the scratch (Wh's copy where it needs
  one), the launch counts, and the refusals before any launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variational_mmt_tpu.ops.pallas.gru import _gru_scan_bwd_impl
from variational_mmt_torch import kernels
from variational_mmt_torch.ops import gru_scan

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
H100_SMS = 132
SMEM_PER_BLOCK = 232_448  # what one CTA of an H100 may take (227 KB)
TOL = dict(rtol=1e-5, atol=1e-5)
# 16-bit dWh against JAX, relative to its largest entry: the two frameworks'
# f32 dh_proj differ by an ulp here and there (their step-by-step sums run in
# other orders), and such a value can round to the neighbouring 16-bit one,
# a step of 2^-8 in one term of a sum (readings up to 4.2e-4 at H = 520 in
# bf16, the same in the port's own gru_layer_scan_bwd_ref)
JAX_16BIT_TOL = 1e-3


def cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("sms", [H100_SMS, 114])
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B", [1, 61, 256, 4096])
@pytest.mark.parametrize("H", [8, 40, 250, 500, 512, 513, 1000, 1024, 2048, 2500, 4096])
def test_products_plan_by_hand(H, B, dt, sms):
    for T in (24, 1):
        plan = gru_scan.scan_bwd_plan(B, T, H, dt, sms)
        M, N = B * T, 3 * H
        if dt == torch.float32:
            assert plan["engine"] == "tile" and "gemm_bn" not in plan
            assert plan["dwh_tiles"] == cdiv(H, 64) * cdiv(N, 64)
            continue
        assert plan["engine"] == "wgmma"
        if dt == torch.float16:
            assert plan == gru_scan.scan_bwd_plan(B, T, H, torch.bfloat16, sms)
        # rows of whole 16-byte pieces, as TMA addresses them
        assert plan["ld_h"] % 8 == 0 and H <= plan["ld_h"] < H + 8
        assert plan["ld_3h"] % 8 == 0 and N <= plan["ld_3h"] < N + 8
        assert plan["wh_copy"] == (plan["layout"] == "cluster" and N % 8 != 0)
        # boxes (rows, values): at most 256 a side, inner rows of 16-bit
        # values a multiple of 16 bytes and within the 128-byte swizzle
        for rows, vals in plan["boxes"].values():
            assert 1 <= rows <= 256 and 1 <= vals <= 256
            assert vals * 2 % 16 == 0 and vals * 2 <= 128
        assert plan["boxes"]["hs"] == (128, 64)  # (a)'s A: 128 rows of a tile, a 64-deep slice
        bm, bn, bk, stages = (plan[k] for k in ("gemm_bm", "gemm_bn", "gemm_bk", "gemm_stages"))
        assert (bm, bk) == (128, 64) and bn in (128, 256) and stages >= 2
        assert plan["gemm_smem"] == 1024 + stages * (bm + bn) * bk * 2 + 2 * stages * 8
        assert plan["gemm_smem"] <= SMEM_PER_BLOCK
        assert plan["hoist_tiles"] == cdiv(M, 128) * cdiv(N, bn)
        assert plan["dwh_tiles"] == cdiv(H, 128) * cdiv(N, bn)
        # dWh's K = B*T in 64-deep slices, split in a fixed order: every
        # slice once, no split empty
        assert plan["k_slices"] == cdiv(M, 64)
        splits = plan["dwh_splits"]
        assert 1 <= splits <= min(8, plan["k_slices"])
        assert splits == 1 or 2 * plan["dwh_tiles"] < sms
        ranges = gru_scan.gemm_k_splits(plan["k_slices"], splits)
        assert [k for r in ranges for k in r] == list(range(plan["k_slices"]))
        assert all(len(r) >= 1 for r in ranges)
        # scratch: the split's partial tiles and the operand pass's column
        # sums share the floats; a counter a tile and a 32-column strip
        chunks = cdiv(M, 128)
        assert plan["operand_chunks"] == chunks
        assert plan["partial_floats"] >= chunks * N
        assert plan["partial_floats"] >= (plan["dwh_tiles"] * splits * bm * bn if splits > 1
                                          else 1)
        assert plan["counters"] == plan["dwh_tiles"] + cdiv(plan["ld_3h"], 32)


def scan_inputs(H, B=3, T=4, seed=0):
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((B, T, 3 * H)).astype(np.float32)
    m = (np.arange(T)[None, :] < np.array([4, 2, 3])[:B, None]).astype(np.float32)
    h0 = (0.3 * rng.standard_normal((B, H))).astype(np.float32)
    wh = (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    bh = (0.1 * rng.standard_normal(3 * H)).astype(np.float32)
    reset = np.zeros((B, T), np.float32)
    reset[:, 0] = 1.0
    reset[0, 2] = 1.0  # a segment start inside a row
    reset[1, 2] = 1.0  # on the first padded step
    g_outs = rng.standard_normal((B, T, H)).astype(np.float32)
    return (xp, m, h0, wh, bh), reset, g_outs


def steps_of(monkeypatch, T, reverse):
    """Records the gate products (h_proj) and dh_proj that
    ``gru_layer_scan_bwd_ref`` forms at each step, by time index."""
    order = list(range(T) if reverse else range(T - 1, -1, -1))
    seen = {"hp": {}, "dhp": {}}
    core = gru_scan.gru_bwd_core

    def recording(dhat, x, h_proj, h_prev):
        t = order[len(seen["hp"])]
        out = core(dhat, x, h_proj, h_prev)
        seen["hp"][t], seen["dhp"][t] = h_proj, out[1]
        return out

    monkeypatch.setattr(gru_scan, "gru_bwd_core", recording)
    return seen


@pytest.mark.parametrize("with_reset", [False, True], ids=["no_reset", "reset"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("H", [40, 250, 520])
def test_products_ref_matches_jax(monkeypatch, H, dt, reverse, with_reset):
    (xp, m, h0, wh, bh), reset, g_outs = scan_inputs(H)
    B, T = m.shape
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[dt]
    x_t, wh_t = (torch.from_numpy(a).to(dt) for a in (xp, wh))
    m_t, h0_t, bh_t, g_t = (torch.from_numpy(a) for a in (m, h0, bh, g_outs))
    r_t = torch.from_numpy(reset) if with_reset else None
    outs, _ = gru_scan.gru_layer_scan_ref(x_t, m_t, h0_t, wh_t, bh_t, reverse, r_t)
    seen = steps_of(monkeypatch, T, reverse)
    dx, _, dWh_ref, dbh_ref = gru_scan.gru_layer_scan_bwd_ref(x_t, m_t, h0_t, wh_t, bh_t, outs,
                                                              g_t, reverse, r_t)
    by_t = lambda d: torch.stack([d[t] for t in range(T)], 1)  # noqa: E731
    hp_steps, dhp = by_t(seen["hp"]), by_t(seen["dhp"])
    hp, dWh, dbh = gru_scan.scan_bwd_products_ref(h0_t, outs, wh_t, bh_t, dx, dhp[..., 2 * H:],
                                                  reverse, r_t)
    assert hp.dtype == dWh.dtype == dbh.dtype == torch.float32
    assert tuple(hp.shape) == (B, T, 3 * H) and tuple(dWh.shape) == (H, 3 * H)
    # the same rounded operands as the step-by-step backward: sums in
    # another order only
    np.testing.assert_allclose(hp.numpy(), hp_steps.numpy(), **TOL)
    np.testing.assert_allclose(dWh.numpy(), dWh_ref.numpy(), **TOL)
    np.testing.assert_allclose(dbh.numpy(), dbh_ref.numpy(), **TOL)
    swap = lambda a: jnp.asarray(a).swapaxes(0, 1)  # noqa: E731
    want = _gru_scan_bwd_impl(swap(xp).astype(jdt), swap(m)[:, None, :], jnp.asarray(h0),
                              jnp.asarray(wh, jdt), jnp.asarray(bh).reshape(1, -1),
                              swap(outs.numpy()), swap(g_outs), reverse, True,
                              swap(reset)[:, None, :] if with_reset else None)
    want_dwh = np.asarray(want[2], np.float32)
    if dt == torch.float32:
        np.testing.assert_allclose(dWh.numpy(), want_dwh, **TOL)
    else:
        assert np.abs(dWh.numpy() - want_dwh).max() <= JAX_16BIT_TOL * np.abs(want_dwh).max()
    np.testing.assert_allclose(dbh.numpy(), np.asarray(want[3], np.float32).reshape(-1), **TOL)


def test_products_wrapper_takes_the_plain_version_on_cpu():
    (xp, m, h0, wh, bh), reset, _ = scan_inputs(40)
    rng = np.random.default_rng(3)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    args = (t(h0), t(rng.standard_normal((3, 4, 40))), t(wh).to(torch.bfloat16), t(bh),
            t(rng.standard_normal((3, 4, 120))), t(rng.standard_normal((3, 4, 40))))
    for r in (None, t(reset)):
        got = gru_scan.scan_bwd_products(*args, True, r)
        want = gru_scan.scan_bwd_products_ref(*args, True, r)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


@pytest.fixture
def lib(monkeypatch):
    """A library that records every entry point's arguments, on a card of
    132 SMs that holds every plan (the products' shared memory as the plan
    counts it)."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    def occupancy(device, library, fn, code, *args):
        if fn == "vmmt_gru_products_occupancy":
            return 1, gru_scan.gemm_smem(*args)
        return 1000, plan_smem[0]

    plan_smem = [0]
    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    monkeypatch.setattr(kernels, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "aligned", lambda t: t.contiguous())
    monkeypatch.setattr(kernels, "occupancy", occupancy)
    return calls, plan_smem


def bwd_args(B, T, H, dt):
    return (meta(B, T, 3 * H, dtype=dt), meta(B, T), meta(B, H), meta(H, 3 * H, dtype=dt),
            meta(3 * H), meta(B, T, H), meta(B, T, H))


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B,T,H", [(64, 24, 250), (64, 24, 256), (256, 24, 512), (64, 25, 1000),
                                   (256, 24, 2048)])
def test_bwd_wrapper_passes_the_products_plan(lib, B, T, H, dt):
    """The backward's entry points get the products of the engine the dtype
    picks (wgmma in 16 bits, tile_gemm.cuh in f32): tile N, stages and
    dWh's split of the plan, Hs and dP where the wgmma engine runs, and
    Wh's copy on the cluster plan where 3H values are not whole 16-byte
    pieces (H = 250); each wgmma call counts two launches of the operand
    pass and two of the product."""
    calls, plan_smem = lib
    plan = gru_scan.scan_bwd_plan(B, T, H, dt, H100_SMS)
    plan_smem[0] = plan["smem"]
    counts = (gru_scan.scan_bwd_operands.launches, gru_scan.wgmma_gemm.launches)
    gru_scan.gru_layer_scan_bwd(*bwd_args(B, T, H, dt))
    fn, args = calls[-1]
    assert len(args) == len(kernels.SIGNATURES["gru_scan"][fn])
    wgmma = dt != torch.float32
    assert plan["engine"] == ("wgmma" if wgmma else "tile")
    assert gru_scan.gru_layer_scan_bwd.plan["engine"] == plan["engine"]
    products = (plan["gemm_bn"], plan["gemm_stages"]) if wgmma else (0, 0)
    if plan["layout"] == "cluster":
        assert fn == "vmmt_gru_scan_bwd"
        hs, dp, wp = args[17:20]
        assert args[-4:-1] == (plan["dwh_splits"],) + products
        assert (wp is not None) == (wgmma and 3 * H % 8 != 0)
    else:
        assert fn == "vmmt_gru_tiled_bwd"
        hs, dp = args[17:19]
        assert args[-7:-2] == (int(plan["resident"]), plan["stages"], plan["dwh_splits"]) \
            + products
    assert (hs is not None, dp is not None) == (wgmma, wgmma)
    assert (gru_scan.scan_bwd_operands.launches, gru_scan.wgmma_gemm.launches) == \
        (counts[0] + 2 * wgmma, counts[1] + 2 * wgmma)


def test_products_wrapper_launches_with_the_plan(lib):
    calls, _ = lib
    B, T, H = 64, 24, 250
    bf16 = torch.bfloat16
    counts = (gru_scan.scan_bwd_operands.launches, gru_scan.wgmma_gemm.launches)
    hp, dWh, dbh = gru_scan.scan_bwd_products(meta(B, H), meta(B, T, H), meta(H, 3 * H, dtype=bf16),
                                              meta(3 * H), meta(B, T, 3 * H), meta(B, T, H),
                                              True, meta(B, T))
    assert [tuple(t.shape) for t in (hp, dWh, dbh)] == [(B, T, 3 * H), (H, 3 * H), (3 * H,)]
    plan = gru_scan.scan_bwd_products.plan
    assert plan == dict(gru_scan.products_plan(B, T, H, bf16, H100_SMS, False),
                        gemm_per_sm=1)
    fn, args = calls[-1]
    assert fn == "vmmt_gru_bwd_products"
    assert len(args) == len(kernels.SIGNATURES["gru_scan"][fn])
    assert args[-8:-1] == (B, T, H, 1, plan["dwh_splits"], plan["gemm_bn"], plan["gemm_stages"])
    assert args[13] is not None  # Wh's copy: 750 values are not whole 16-byte pieces
    assert (gru_scan.scan_bwd_operands.launches, gru_scan.wgmma_gemm.launches) == \
        (counts[0] + 2, counts[1] + 2)


def test_wrappers_refuse_before_launching(lib, monkeypatch):
    """The products alone refuse float32, which has no wgmma engine, before
    anything is launched; a card that holds no product CTA or counts other
    shared memory raises too, and nothing runs in its place."""
    calls, plan_smem = lib
    with pytest.raises(ValueError, match="wgmma engine"):
        gru_scan.scan_bwd_products(meta(4, 40), meta(4, 5, 40), meta(40, 120), meta(120),
                                   meta(4, 5, 120), meta(4, 5, 40))
    bf16 = gru_scan.scan_bwd_plan(4, 5, 40, torch.bfloat16)
    plan_smem[0] = bf16["smem"]
    for answer, error in (((0, bf16["gemm_smem"]), NotImplementedError),
                          ((1, bf16["gemm_smem"] + 16), RuntimeError)):
        monkeypatch.setattr(kernels, "occupancy", lambda *a, _r=answer: (
            _r if a[2] == "vmmt_gru_products_occupancy" else (1000, bf16["smem"])))
        with pytest.raises(error):
            gru_scan.gru_layer_scan_bwd(*bwd_args(4, 5, 40, torch.bfloat16))
    assert calls == []


def test_tools_attribute_the_products_to_row_2():
    """``profile_train`` counts the operand pass and the wgmma products in
    the GRU-scan layer; ``kernel_times -wide`` splits row 2's call into
    its reverse scan, products and the rest."""
    from variational_mmt_torch.tools import kernel_times, profile_train

    own = "void (anonymous namespace)::"
    for name in ("wgmma_gemm_kernel<__nv_bfloat16, 256, true>(CUtensorMap_st, CUtensorMap_st, "
                 "(anonymous namespace)::WgGemm)", "scan_hs_kernel<__half>(float const*)",
                 "scan_dp_kernel<__nv_bfloat16>(float const*)"):
        assert profile_train.layer_of(own + name) == "GRU-scan kernels (rows 1, 2)"
    split = kernel_times.row2_split({"gru_tiled_bwd_kernel<__nv_bfloat16>": 1.0,
                                     "wgmma_gemm_kernel<__nv_bfloat16, 256, false>": 0.25,
                                     "wgmma_gemm_kernel<__nv_bfloat16, 256, true>": 0.25,
                                     "scan_hs_kernel<__nv_bfloat16>": 0.1,
                                     "scan_dp_kernel<__nv_bfloat16>": 0.15, "Memset": 0.05},
                                    256, 24, 1024)
    assert (split["scan_ms"], split["gemm_ms"], split["operand_pass_ms"]) == (1.0, 0.5, 0.25)
    assert split["products_ms"] == 0.75 and abs(split["rest_ms"] - 0.05) < 1e-12
    assert split["gemm_tflops"] == 12.0 * 256 * 24 * 1024 ** 2 / 0.5 / 1e9
