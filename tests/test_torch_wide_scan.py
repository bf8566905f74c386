"""PyTorch port: the GRU-scan kernels (rows 1 and 2) above 512 units, on
the CPU.

- The plain versions ``gru_layer_scan_ref`` and ``gru_layer_scan_bwd_ref``
  (what the wide kernels are held to on the card) against JAX's
  ``gru_layer_scan`` and ``gru_layer_scan_ad`` in interpret mode at H = 520
  and 640 (and 500, where the forward's tiled plan also runs), B = 3, T =
  5, both directions, with and without a reset stream, f32: outputs and
  finals within 1e-5, dx, dh0, dWh and dbh within 1e-4.
- Both passes' tiled launch plans (``layout`` ``"tiled"``) at every width
  from 513 to 1024 that the repo's configs reach or bound, the three
  dtypes, batches 1, 61, 64 and 256: shared memory within a CTA's, the
  cooperative grid within what 132 SMs hold at once, the units covering H
  and the row tiles and chunks covering B; the layouts at 1024 counted by
  hand; the wrappers launching both tiled entry points with the plans and
  raising, before any launch, where the card cannot hold the grid at once.
- The fast config (``input_feed=False``, ``use_pallas``) at hidden 1040:
  the port's loss and every gradient on its kernel route (the wrappers'
  plain versions on the CPU; encoder halves of 520 units and decoder
  layers of 1040 on the tiled plans' route, no plain GRU scan) against
  JAX's Pallas route in interpret mode, from JAX's parameters through the
  converter: loss within 1e-5 relative, gradients 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_options_model import STEP, TRAIN, jax_tree
from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.config import TrainConfig as JaxTrainConfig
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.ops.pallas.gru import _gru_scan_bwd_impl
from variational_mmt_tpu.ops.pallas.gru import gru_layer_scan as jax_gru_layer_scan
from variational_mmt_tpu.ops.pallas.gru import gru_layer_scan_ad as jax_gru_layer_scan_ad
from variational_mmt_tpu.train.loss import compute_loss as jax_compute_loss
from variational_mmt_torch import kernels
from variational_mmt_torch.config import Config, ModelConfig, TrainConfig
from variational_mmt_torch.convert import flatten, grads_to_jax, params_from_jax
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.models import gru as gru_mod
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.ops import gru_scan
from variational_mmt_torch.train.trainer import batch_tensors, loss_and_grads

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
WIDE = [513, 520, 640, 768, 1000, 1024]
H100_SMS = 132
SMEM_PER_SM = 233_472  # an H100 SM's shared memory, 1 KB of it reserved per CTA


def scan_inputs(H, B=3, T=5, seed=0):
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((B, T, 3 * H)).astype(np.float32)
    lengths = np.array([5, 2, 4])[:B]  # ragged right padding
    m = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    h0 = (0.3 * rng.standard_normal((B, H))).astype(np.float32)
    wh = (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    bh = (0.1 * rng.standard_normal(3 * H)).astype(np.float32)
    reset = np.zeros((B, T), np.float32)
    reset[:, 0] = 1.0
    reset[0, 3] = reset[2, 2] = 1.0  # segment starts inside rows
    reset[1, 2] = 1.0  # on the first padded step
    g_outs = rng.standard_normal((B, T, H)).astype(np.float32)
    g_fin = rng.standard_normal((B, H)).astype(np.float32)
    return (xp, m, h0, wh, bh), reset, g_outs, g_fin


@pytest.mark.parametrize("with_reset", [False, True], ids=["no_reset", "reset"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("H", [520, 640])
def test_plain_scans_match_jax_kernels_above_512(H, reverse, with_reset):
    """Forward against ``gru_layer_scan(interpret=True)``; the backward's
    raw outputs against ``_gru_scan_bwd_impl`` (time-major in JAX) and
    ``gru_layer_scan_ad``'s gradients against ``jax.vjp``."""
    check_plain_scans_against_jax(H, reverse, with_reset, FWD_TOL, BWD_TOL)


@pytest.mark.parametrize("with_reset", [False, True], ids=["no_reset", "reset"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_plain_scans_match_jax_kernels_at_500(reverse, with_reset):
    """H = 500, where the forward may take its tiled plan below 513 units
    (gates not on 16-byte pieces in 16 bits): the same checks."""
    check_plain_scans_against_jax(500, reverse, with_reset, FWD_TOL, BWD_TOL)


def check_plain_scans_against_jax(H, reverse, with_reset, fwd_tol, bwd_tol):
    """The plain scans at H units (B = 3, T = 5) against the Pallas scan in
    interpret mode, forward, backward and VJP, at the given tolerances."""
    args, reset, g_outs, g_fin = scan_inputs(H)
    r_np = reset if with_reset else None
    r = None if r_np is None else torch.from_numpy(r_np)
    jr = None if r_np is None else jnp.asarray(r_np)
    t = [torch.from_numpy(a) for a in args]
    want = jax_gru_layer_scan(*map(jnp.asarray, args), reverse=reverse, interpret=True,
                              reset=jr)
    got = gru_scan.gru_layer_scan_ref(*t, reverse, r)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **fwd_tol)

    xp, m, h0, wh, bh = args
    outs = got[0].numpy()
    swap = lambda a: jnp.asarray(a).swapaxes(0, 1)  # noqa: E731
    want_b = _gru_scan_bwd_impl(swap(xp), swap(m)[:, None, :], jnp.asarray(h0), jnp.asarray(wh),
                                jnp.asarray(bh).reshape(1, -1), swap(outs), swap(g_outs),
                                reverse, True, None if jr is None else swap(jr)[:, None, :])
    got_b = gru_scan.gru_layer_scan_bwd_ref(*t, got[0], torch.from_numpy(g_outs), reverse, r)
    np.testing.assert_allclose(got_b[0].numpy(), np.asarray(want_b[0]).swapaxes(0, 1),
                               **bwd_tol)
    np.testing.assert_allclose(got_b[1].numpy(), np.asarray(want_b[1]), **bwd_tol)
    np.testing.assert_allclose(got_b[2].numpy(), np.asarray(want_b[2]), **bwd_tol)
    np.testing.assert_allclose(got_b[3].numpy(), np.asarray(want_b[3]).reshape(-1), **bwd_tol)

    jargs = [jnp.asarray(a) for a in args]
    _, vjp = jax.vjp(lambda x, h, w, b: jax_gru_layer_scan_ad(x, jargs[1], h, w, b, reverse,
                                                              True, jr),
                     jargs[0], jargs[2], jargs[3], jargs[4])
    want_g = vjp((jnp.asarray(g_outs), jnp.asarray(g_fin)))
    for i in (0, 2, 3, 4):
        t[i].requires_grad_(True)
    outs_t, fin_t = gru_scan.gru_layer_scan_ad(*t, reverse=reverse, reset=r)
    torch.autograd.backward((outs_t, fin_t), (torch.from_numpy(g_outs), torch.from_numpy(g_fin)))
    for i, w in zip((0, 2, 3, 4), want_g):
        np.testing.assert_allclose(t[i].grad.numpy(), np.asarray(w), **bwd_tol)


@pytest.mark.parametrize("B", [1, 61, 64, 256])
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("H", WIDE)
def test_wide_plans_hold_every_width_to_1024(H, dt, B):
    fwd = gru_scan.scan_fwd_plan(B, 24, H, dt, H100_SMS)
    bwd = gru_scan.scan_bwd_plan(B, 24, H, dt, H100_SMS)
    assert gru_scan.scan_kernel_holds(H, dt)
    assert fwd["layout"] == "tiled" and (fwd["rows"], fwd["units"]) in gru_scan.TILED_FWD_TILES
    assert bwd["layout"] == "tiled" and (bwd["rows"], bwd["units"]) in gru_scan.TILED_TILES
    for plan in (fwd, bwd):
        assert plan["unit_tiles"] * plan["units"] >= H > (plan["unit_tiles"] - 1) * plan["units"]
        assert plan["rows"] in (16, 32, 64, 128) and plan["cluster"] in gru_scan.TILED_CLUSTERS
        chunk = plan["rows"] * plan["row_tiles"]
        assert plan["chunks"] * chunk >= B > (plan["chunks"] - 1) * chunk
        assert 0 < plan["smem"] <= kernels.SMEM_PER_BLOCK
        # a cooperative launch: the grid within what 132 SMs hold at once
        # (one CTA an SM; clusters of 4 on 120 of them)
        assert plan["grid"] == plan["unit_tiles"] * plan["row_tiles"] * plan["cluster"] \
            == plan["ctas"]
        assert plan["grid"] <= (120 if plan["cluster"] == 4 else H100_SMS)
    assert (fwd["resident"], fwd["stages"]) in gru_scan.TILED_FWD_RINGS
    assert (bwd["resident"], bwd["stages"]) in gru_scan.TILED_BWD_RINGS
    assert fwd["k_chunks"] == -(-H // fwd["kc"])
    if bwd["engine"] == "tile":  # f32: tile_gemm.cuh's 64 x 64 tiles of dWh, no K split
        assert dt == torch.float32
        assert bwd["dwh_splits"] == 1 and bwd["dwh_tiles"] == -(-H // 64) * -(-3 * H // 64)
    else:  # the wgmma engine's 128 x bn tiles (tests/test_torch_scan_products.py)
        assert bwd["dwh_tiles"] == -(-H // 128) * -(-3 * H // bwd["gemm_bn"])


def test_wide_plans_mirror_the_kernels_layout_at_1024():
    """H=1024, B=64. The forward's tiled plan: in bf16 32 x 32 cells a CTA,
    K split over clusters of 2 (128 CTAs), its shared memory the tile's 96
    columns of Wh over its 8 K chunks of 64 (512 k-rows of 208 bytes), the
    partial products of four K groups (32 rows of 100 floats each), which
    take the bytes of the whole-K stage (32 rows of its 8 chunks, 1040
    bytes apart), the biases and the carry of half the tile, and the bulk
    copies' mbarrier (16 bytes); in f32 64 x 16 cells, clusters
    of 2 (128 CTAs), the tile's 48 columns of Wh over its 16 K chunks of 32
    (512 k-rows of 208 bytes) and four K groups' partial products (64 rows
    of 52 floats each) in the ring's bytes (64 rows of 144 a stage). The
    backward's tiled plan: 64 x 64 cells a CTA in bf16, K split over
    clusters of 4 (64 CTAs); its shared memory the CTA's 64 rows of Wh over
    its 12 K chunks (1552 bytes apart), the whole-K stage of the tile's 64
    rows of dh_proj over those chunks at the same pitch, whose bytes the two
    K groups' partial products (64 rows of 68 floats) take, the dh carry and
    dh_part of a quarter of the tile and the bulk copies' mbarrier."""
    bf16, f32 = torch.bfloat16, torch.float32
    fb = gru_scan.scan_fwd_plan(64, 24, 1024, bf16, H100_SMS)
    ff = gru_scan.scan_fwd_plan(64, 24, 1024, f32, H100_SMS)
    assert (fb["rows"], fb["units"], fb["cluster"], fb["grid"]) == (32, 32, 2, 128)
    assert (fb["resident"], fb["stages"], fb["wh_from"], fb["in_place"]) == (True, 1, "smem", True)
    assert fb["smem"] == 8 * 64 * 208 + max(32 * (8 * 128 + 16), 4 * 32 * 100 * 4) \
        + (96 + 16 * 32) * 4 + 16 == 160144
    assert (fb["kc"], fb["k_chunks"], fb["ldx"]) == (64, 16, 1024)
    assert (ff["rows"], ff["units"], ff["cluster"], ff["grid"]) == (64, 16, 2, 128)
    assert (ff["resident"], ff["stages"], ff["wh_from"]) == (True, 4, "smem")
    assert ff["smem"] == 16 * 32 * 208 + max(4 * 64 * 144, 4 * 64 * 52 * 4) + (48 + 32 * 16) * 4 \
        == 161984
    assert (ff["kc"], ff["k_chunks"], ff["ldx"]) == (32, 32, 1024)
    bb = gru_scan.scan_bwd_plan(64, 24, 1024, bf16)
    assert (bb["rows"], bb["units"], bb["cluster"], bb["grid"]) == (64, 64, 4, 64)
    assert (bb["resident"], bb["stages"], bb["wh_from"]) == (True, 1, "smem")
    assert bb["smem"] == 64 * (12 * 128 + 16) + max(64 * (12 * 128 + 16), 2 * 64 * 68 * 4) \
        + 2 * 16 * 64 * 4 + 16 == 206864
    assert (bb["kc"], bb["k_chunks"], bb["ldx"], bb["in_place"]) == (64, 48, 3072, True)
    # batches above what a launch holds run in chunks
    big = gru_scan.scan_fwd_plan(3000, 24, 1024, bf16, H100_SMS)
    assert big["chunks"] == -(-3000 // (big["rows"] * big["row_tiles"])) >= 2


def test_scan_kernel_holds_every_width_to_1024():
    """Every width to 1024 and on past it: 1025 takes the tiled plan too."""
    for dt in DTYPES:
        assert all(gru_scan.scan_kernel_holds(H, dt) for H in range(1, 1025))
        assert gru_scan.scan_kernel_holds(1025, dt)
        assert gru_scan.scan_fwd_plan(64, 24, 1025, dt, H100_SMS)["layout"] == "tiled"


def meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


@pytest.fixture
def wide_lib(monkeypatch):
    """A library that records the tiled entry points' ints."""
    calls = []

    class Lib:
        def vmmt_gru_tiled_fwd(self, *args):
            # padded weights (None: Wh in place), B, T, H, reverse, rows,
            # units, cluster, row_tiles, resident, stages (then probe,
            # stream)
            calls.append(("fwd", args[-13] is None) + args[-12:-2])
            return 0

        def vmmt_gru_tiled_bwd(self, *args):
            # padded weights (None: Wh in place), B, T, H, reverse, rows,
            # units, cluster, row_tiles, resident, the scan's stages, splits,
            # the wgmma products' tile N and stages (then probe, stream)
            calls.append(("bwd", args[-16] is None) + args[-15:-2])
            return 0

    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    monkeypatch.setattr(kernels, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "aligned", lambda t: t.contiguous())
    return monkeypatch, calls


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_wrappers_launch_the_wide_plan(wide_lib, dt):
    monkeypatch, calls = wide_lib
    B, T, H = 64, 25, 1000
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
    gru_scan.gru_layer_scan(*ins, reverse=True)
    gru_scan.gru_layer_scan_bwd(*ins, meta(B, T, H), meta(B, T, H))
    assert fwd["layout"] == bwd["layout"] == "tiled"
    assert fwd["in_place"] and bwd["in_place"]  # H and 3H elements: whole 16-byte pieces
    wgmma = bwd["engine"] == "wgmma"
    assert wgmma == (dt != torch.float32)
    products = (bwd["gemm_bn"], bwd["gemm_stages"]) if wgmma else (0, 0)
    assert seen == [("vmmt_gru_tiled_fwd_occupancy", H, fwd["rows"], fwd["units"],
                     fwd["cluster"], int(fwd["resident"]), fwd["stages"]),
                    ("vmmt_gru_tiled_bwd_occupancy", H, bwd["rows"], bwd["units"],
                     bwd["cluster"], int(bwd["resident"]), bwd["stages"])] \
        + [("vmmt_gru_products_occupancy", *products)] * wgmma
    assert calls == [("fwd", True, B, T, H, 1, fwd["rows"], fwd["units"], fwd["cluster"],
                      fwd["row_tiles"], int(fwd["resident"]), fwd["stages"]),
                     ("bwd", True, B, T, H, 0, bwd["rows"], bwd["units"], bwd["cluster"],
                      bwd["row_tiles"], int(bwd["resident"]), bwd["stages"],
                      bwd["dwh_splits"], *products)]
    assert gru_scan.gru_layer_scan.plan == dict(fwd, max_co_resident=264)
    assert gru_scan.gru_layer_scan_bwd.plan == dict(bwd, max_co_resident=264,
                                                    **({"gemm_per_sm": 1} if wgmma else {}))


def test_wrappers_refuse_a_wide_grid_the_card_cannot_hold(wide_lib):
    """Raises naming the tiled plan before anything is launched; never the
    plain scan in the kernel's place."""
    monkeypatch, calls = wide_lib
    B, T, H = 64, 25, 1024
    plan = gru_scan.scan_fwd_plan(B, T, H, torch.float32, H100_SMS)
    monkeypatch.setattr(kernels, "occupancy", lambda *a: (plan["grid"] - 1, plan["smem"]))
    ins = (meta(B, T, 3 * H), meta(B, T), meta(B, H), meta(H, 3 * H), meta(3 * H))
    with pytest.raises(NotImplementedError, match="gru_layer_scan kernel: the tiled plan.*at once"):
        gru_scan.gru_layer_scan(*ins)
    monkeypatch.setattr(kernels, "occupancy", lambda *a: (1000, 1))
    with pytest.raises(RuntimeError, match="shared"):
        gru_scan.gru_layer_scan(*ins)
    assert calls == []


@pytest.mark.parametrize("H", [520, 1000])
def test_unigru_sends_a_wide_layer_to_the_kernels(monkeypatch, H):
    """``use_pallas`` at H = 520 and 1000 calls ``gru_layer_scan_ad``, not
    ``cell_layer_scan``."""
    import variational_mmt_torch.ops.gru_scan as ops_scan

    calls = []
    monkeypatch.setattr(ops_scan, "gru_layer_scan_ad",
                        lambda *a, **k: calls.append("kernel") or (a[0][..., :H], a[2]))
    monkeypatch.setattr(gru_mod, "cell_layer_scan",
                        lambda *a, **k: calls.append("plain"))
    layer = gru_mod.UniGRU(3, H, use_pallas=True)
    torch.nn.init.zeros_(layer.hh_kernel)
    torch.nn.init.zeros_(layer.hh_bias)
    layer(torch.zeros(2, 4, 3), torch.ones(2, 4))
    assert calls == ["kernel"]


FAST = dict(model_type="vmmt_c", z_cond="init+input", src_vocab_size=20, tgt_vocab_size=20,
            emb_dim=16, hidden_dim=1040, latent_dim=4, img_feat_dim=6, enc_layers=1,
            dec_layers=2, compute_dtype="float32", dropout=0.3, word_dropout=0.1,
            input_feed=False, use_pallas=True)


def test_fast_config_at_hidden_1040_matches_jax_pallas_route():
    """vmmt_c, ``input_feed=False``, ``use_pallas``: one batch of B = 2,
    T = 4; JAX's loss and gradients through its Pallas scans (interpret)."""
    jcfg = JaxModelConfig(**FAST)
    tree = jax_tree(FAST)
    rng = np.random.default_rng(3)
    src = [rng.integers(4, 20, n).astype(np.int32) for n in (4, 3)]
    tgt = [rng.integers(4, 20, n).astype(np.int32) for n in (3, 2)]
    img = rng.standard_normal((2, 6)).astype(np.float32)
    batch = next(BucketIterator(BinarizedDataset(src, tgt), 2, [4], img_feats=img).epoch())
    jmodel = jax_build_model(jcfg)

    def jax_loss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(batch.src), jnp.asarray(batch.tgt_in),
                           jnp.asarray(batch.img), deterministic=True, sample=False,
                           tgt_out=jnp.asarray(batch.tgt_out))
        return jax_compute_loss(out, jnp.asarray(batch.tgt_out), jnp.asarray(batch.example_mask),
                                jnp.asarray(batch.img), jcfg, JaxTrainConfig(**TRAIN),
                                jnp.int32(STEP))[0]

    want_loss, want_grads = jax.value_and_grad(jax_loss)(tree)
    cfg = Config(model=ModelConfig(**FAST), train=TrainConfig(**TRAIN))
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg.model))
    plain = gru_mod.cell_layer_scan.gru_scans
    loss, _, _ = loss_and_grads(cfg, model, batch_tensors(batch, torch.device("cpu")), STEP,
                                None, deterministic=True, sample=False)
    assert gru_mod.cell_layer_scan.gru_scans == plain  # every GRU layer took the kernels' route
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = flatten(grads_to_jax(model))
    want = flatten(jax.device_get(want_grads))
    assert set(got) == set(want)
    for name in sorted(want):
        w = np.asarray(want[name])
        np.testing.assert_allclose(got[name], w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=name)
