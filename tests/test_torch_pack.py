"""PyTorch port: sequence-packed training against the JAX package on a tiny
vmmt_c (Pallas kernels in interpret mode, as tests/test_pallas.py runs
them), and packed against unpacked within the port.

- The GRU scan's reset stream: the plain versions of both kernels against
  the Pallas ``has_reset`` branches, and ``gru_layer_scan_ad`` against
  ``jax.vjp`` of the custom VJP: both directions, right-padded rows, resets
  at t=0, mid-row and on a masked step. f32, 1e-5 absolute and relative.
- ``cell_layer_scan(reset=)``, the segment-reset encoder with per-segment
  finals and ``segment_mean`` against JAX at the same tolerance.
- ``PackedBucketIterator`` against JAX's Python packer: every array equal.
- ``forward_packed`` + ``compute_loss(tgt_seg=)``: loss and every gradient
  against ``jax.grad`` at tests/test_torch_train.py's tolerances (loss
  1e-5 relative; gradients 1e-4 relative plus 1e-5 of the largest entry).
- Packed = unpacked in the port at tests/test_pack.py's tolerances (loss
  and metrics 2e-5 relative; gradients 2e-4 relative, 2e-5 absolute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.config import TrainConfig as JaxTrainConfig
from variational_mmt_tpu.data.dataset import BinarizedDataset as JaxBinarizedDataset
from variational_mmt_tpu.data.packing import PackedBucketIterator as JaxPackedBucketIterator
from variational_mmt_tpu.models import gru as jax_gru
from variational_mmt_tpu.models.model import VMMTModel as JaxVMMTModel
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.models.model import generator_params as jax_generator_params
from variational_mmt_tpu.models.model import init_params as jax_init_params
from variational_mmt_tpu.ops.pallas.gru import _gru_scan_bwd_impl
from variational_mmt_tpu.ops.pallas.gru import gru_layer_scan as jax_gru_layer_scan
from variational_mmt_tpu.ops.pallas.gru import gru_layer_scan_ad as jax_gru_layer_scan_ad
from variational_mmt_tpu.train.loss import compute_loss as jax_compute_loss
from variational_mmt_torch.config import Config, ModelConfig, TrainConfig
from variational_mmt_torch.convert import flatten, grads_to_jax, params_from_jax
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.data.packing import PackedBatch, PackedBucketIterator
from variational_mmt_torch.data.vocab import BOS, PAD, UNK
from variational_mmt_torch.models.gru import cell_layer_scan, segment_mean
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.ops import gru_scan
from variational_mmt_torch.train.trainer import Trainer, batch_tensors, loss_and_grads

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(model_type="vmmt_c", src_vocab_size=24, tgt_vocab_size=24, emb_dim=16,
            hidden_dim=16, latent_dim=4, img_feat_dim=6, compute_dtype="float32",
            dropout=0.3, word_dropout=0.1)
KERNEL_ROUTE = dict(use_pallas=True, pallas_decoder=True, fused_ce=True)
TRAIN = dict(label_smoothing=0.1, kl_anneal_steps=10)
L, K = 16, 3  # packed row length, most segments a row


def reset_inputs(seed=0, B=5, T=8, H=8):
    """Scan inputs with right padding (lengths 8, 4, 8, 1, 6) and resets at
    every row's t=0, mid-row, and at t=5 of row 1, a masked step."""
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((B, T, 3 * H)).astype(np.float32)
    lengths = np.array([8, 4, 8, 1, 6])
    m = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    reset = np.zeros((B, T), np.float32)
    reset[:, 0] = 1.0
    reset[0, 3] = reset[2, 2] = reset[2, 6] = reset[4, 4] = 1.0
    reset[1, 5] = 1.0  # masked
    h0 = (0.3 * rng.standard_normal((B, H))).astype(np.float32)
    wh = (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    bh = (0.1 * rng.standard_normal(3 * H)).astype(np.float32)
    g_outs = rng.standard_normal((B, T, H)).astype(np.float32)
    g_fin = rng.standard_normal((B, H)).astype(np.float32)
    return (xp, m, h0, wh, bh), reset, g_outs, g_fin


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_scan_ref_with_reset_matches_jax_kernel(reverse):
    args, reset, _, _ = reset_inputs()
    want = jax_gru_layer_scan(*map(jnp.asarray, args), reverse=reverse, interpret=True,
                              reset=jnp.asarray(reset))
    got = gru_scan.gru_layer_scan_ref(*map(torch.from_numpy, args), reverse,
                                      torch.from_numpy(reset))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the reset changes the result: the check is not of a no-op
    plain = gru_scan.gru_layer_scan_ref(*map(torch.from_numpy, args), reverse)
    assert float((plain[0] - got[0]).abs().max()) > 0.1


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_scan_bwd_ref_with_reset_matches_jax_kernel(reverse):
    """dx_proj, dh0, dWh and dbh against ``_gru_scan_bwd_impl(reset=)``
    (time-major in JAX, batch-major here)."""
    args, reset, g_outs, _ = reset_inputs(seed=1)
    t = [torch.from_numpy(a) for a in args]
    r = torch.from_numpy(reset)
    outs = gru_scan.gru_layer_scan_ref(*t, reverse, r)[0].numpy()
    xp, m, h0, wh, bh = args
    tm = lambda a: jnp.asarray(a).swapaxes(0, 1)  # noqa: E731
    want = _gru_scan_bwd_impl(tm(xp), tm(m)[:, None, :], jnp.asarray(h0), jnp.asarray(wh),
                              jnp.asarray(bh).reshape(1, -1), tm(outs), tm(g_outs), reverse,
                              True, reset=tm(reset)[:, None, :])
    got = gru_scan.gru_layer_scan_bwd(*t, torch.from_numpy(outs), torch.from_numpy(g_outs),
                                      reverse, r)  # CPU tensors: the plain version
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]).swapaxes(0, 1), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **TOL)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]).reshape(-1), **TOL)
    # forward, every row's first step is a reset: no cotangent reaches h0
    assert (float(got[1].abs().max()) == 0.0) != reverse


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_scan_ad_with_reset_matches_jax_vjp(reverse):
    args, reset, g_outs, g_fin = reset_inputs(seed=2)
    reset[:, 0] = 0.0  # h0 reaches the first segment: dh0 is not zero
    jargs = [jnp.asarray(a) for a in args]
    _, vjp = jax.vjp(lambda x, h0, wh, bh: jax_gru_layer_scan_ad(
        x, jargs[1], h0, wh, bh, reverse, True, jnp.asarray(reset)),
        jargs[0], jargs[2], jargs[3], jargs[4])
    want = vjp((jnp.asarray(g_outs), jnp.asarray(g_fin)))
    t = [torch.from_numpy(a) for a in args]
    for i in (0, 2, 3, 4):
        t[i].requires_grad_(True)
    r = torch.from_numpy(reset)
    outs, fin = gru_scan.gru_layer_scan_ad(*t, reverse=reverse, reset=r)
    torch.autograd.backward((outs, fin), (torch.from_numpy(g_outs), torch.from_numpy(g_fin)))
    for got, w in zip((t[0].grad, t[2].grad, t[3].grad, t[4].grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)
    assert float(t[2].grad.abs().max()) > 0 and r.grad is None


def test_gru_layer_scan_with_reset_takes_the_plain_version_on_cpu():
    args, reset, g_outs, _ = reset_inputs(seed=3)
    t = [torch.from_numpy(a) for a in args]
    r = torch.from_numpy(reset)
    before = gru_scan.gru_layer_scan.reset_launches, gru_scan.gru_layer_scan_bwd.reset_launches
    got = gru_scan.gru_layer_scan(*t, True, r)
    for g, w in zip(got, gru_scan.gru_layer_scan_ref(*t, True, r)):
        assert torch.equal(g, w)
    g = torch.from_numpy(g_outs)
    for a, b in zip(gru_scan.gru_layer_scan_bwd(*t, got[0], g, True, r),
                    gru_scan.gru_layer_scan_bwd_ref(*t, got[0], g, True, r)):
        assert torch.equal(a, b)
    # only a launched kernel counts
    assert (gru_scan.gru_layer_scan.reset_launches,
            gru_scan.gru_layer_scan_bwd.reset_launches) == before


@pytest.mark.parametrize("reverse", [False, True])
def test_cell_layer_scan_with_reset_matches_jax(reverse):
    (xp, m, h0, wh, bh), reset, _, _ = reset_inputs(seed=4)
    want = jax_gru.cell_layer_scan(*map(jnp.asarray, (xp, h0, wh, bh)), mask=jnp.asarray(m),
                                   reverse=reverse, reset=jnp.asarray(reset))
    got = cell_layer_scan(*map(torch.from_numpy, (xp, h0, wh, bh)), mask=torch.from_numpy(m),
                          reverse=reverse, reset=torch.from_numpy(reset))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_segment_mean_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 9, 4)).astype(np.float32)
    seg = np.array([[0, 0, 1, 1, 1, 2, -1, -1, -1], [0, 0, 0, 0, 0, 0, 0, 0, 0],
                    [-1] * 9], np.int32)
    want = jax_gru.segment_mean(jnp.asarray(x), jnp.asarray(seg), 3)
    got = segment_mean(torch.from_numpy(x), torch.from_numpy(seg).long(), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def corpus(n=9, seed=0, lo=2, hi=9):
    rng = np.random.default_rng(seed)
    src = [rng.integers(4, 24, rng.integers(lo, hi)).astype(np.int32) for _ in range(n)]
    tgt = [rng.integers(4, 24, rng.integers(lo, hi)).astype(np.int32) for _ in range(n)]
    img = rng.standard_normal((n, TINY["img_feat_dim"])).astype(np.float32)
    return src, tgt, img


def packed_batch(seed=0):
    """The first packed batch of 3 rows of L tokens over a 9-pair corpus:
    rows of 2 and 3 segments."""
    src, tgt, img = corpus(seed=seed)
    it = PackedBucketIterator(BinarizedDataset(src, tgt), 3, [L], img_feats=img,
                              shuffle=False, max_segments=K)
    pb = next(iter(it.epoch()))
    assert sorted(pb.seg_mask.sum(1).tolist())[-1] >= 2
    return pb, (src, tgt, img)


def perturbed_jax_params(cfg, seed=0):
    tree = jax.device_get(jax_init_params(jax_build_model(cfg), jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


def port_model(over, tree):
    cfg = ModelConfig(**TINY, **over)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    return model


@pytest.mark.parametrize("use_pallas", [True, False])
def test_segment_reset_encoder_matches_jax(use_pallas):
    """Packed memory and per-segment finals (B,K,H) of the source encoder."""
    over = dict(use_pallas=use_pallas)
    jcfg = JaxModelConfig(**TINY, **over)
    tree = perturbed_jax_params(jcfg)
    pb, _ = packed_batch()
    seg, first, last = (jnp.asarray(a) for a in (pb.src_seg, pb.seg_first, pb.seg_last))
    memory, finals = jax_build_model(jcfg).apply(
        {"params": tree}, jnp.asarray(pb.src),
        method=lambda m, s: m.encoder(m.src_embed(s), (seg >= 0).astype(jnp.float32),
                                      deterministic=True, seg=seg, seg_bounds=(first, last)))
    model = port_model(over, tree)
    tseg = torch.from_numpy(pb.src_seg).long()
    with torch.no_grad():
        t_memory, t_finals = model.encoder(
            model.src_embed(torch.from_numpy(pb.src).long()), (tseg >= 0).float(), seg=tseg,
            seg_bounds=(torch.from_numpy(pb.seg_first), torch.from_numpy(pb.seg_last)))
    np.testing.assert_allclose(t_memory.numpy(), np.asarray(memory), **TOL)
    for g, w in zip(t_finals, finals):
        assert g.shape == (3, K, TINY["hidden_dim"])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


FIELDS = ("src", "tgt_in", "tgt_out", "src_seg", "tgt_seg", "seg_first", "seg_last", "indices",
          "seg_mask", "img")


@pytest.mark.parametrize("shuffle", [False, True])
def test_packed_bucket_iterator_matches_jax(shuffle):
    src, tgt, img = corpus(n=41, seed=6, lo=1, hi=14)
    kw = dict(batch_size=4, buckets=[8, 16], img_feats=img, shuffle=shuffle, seed=3,
              max_segments=3)
    jit = JaxPackedBucketIterator(JaxBinarizedDataset(src, tgt), use_native=False, **kw)
    it = PackedBucketIterator(BinarizedDataset(src, tgt), **kw)
    assert len(it) == len(jit)
    for epoch in (0, 1):
        want, got = list(jit.epoch(epoch)), list(it.epoch(epoch))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            for field in FIELDS:
                np.testing.assert_array_equal(getattr(g, field), getattr(w, field),
                                              err_msg=field)
            assert (g.n_tokens, g.n_sentences) == (w.n_tokens, w.n_sentences)


def test_packer_places_every_example_once():
    src, tgt, img = corpus(n=57, seed=7, lo=1, hi=20)
    it = PackedBucketIterator(BinarizedDataset(src, tgt), 4, [16, 24], img_feats=img, seed=2)
    seen = []
    for pb in it.epoch(0):
        for r, k in zip(*np.nonzero(pb.seg_mask)):
            i = pb.indices[r, k]
            seen.append(i)
            s = pb.src[r][pb.src_seg[r] == k]
            np.testing.assert_array_equal(s, src[i][:24])
            assert pb.seg_first[r, k] == np.flatnonzero(pb.src_seg[r] == k)[0]
            assert pb.seg_last[r, k] == np.flatnonzero(pb.src_seg[r] == k)[-1]
            t_in = pb.tgt_in[r][pb.tgt_seg[r] == k]
            assert t_in[0] == BOS
            np.testing.assert_array_equal(t_in[1:], tgt[i][:23])
            np.testing.assert_array_equal(pb.img[r, k], img[i])
        assert (pb.seg_mask.sum(1) <= 3 + 1).all()
        assert ((pb.src == PAD) == (pb.src_seg < 0)).all()
    assert sorted(seen) == list(range(57))


def test_packer_refuses_empty_lines():
    src, tgt, _ = corpus(n=5, seed=8)
    for side in ("src", "tgt"):
        bad = {"src": list(src), "tgt": list(tgt)}
        bad[side][3] = np.zeros((0,), np.int32)
        with pytest.raises(ValueError, match="empty"):
            PackedBucketIterator(BinarizedDataset(bad["src"], bad["tgt"]), 2, [16])


def jax_packed_loss(jcfg, pb, step):
    jmodel = jax_build_model(jcfg)
    jtcfg = JaxTrainConfig(**TRAIN)
    B, Kp = pb.seg_mask.shape
    a = {f: jnp.asarray(getattr(pb, f)) for f in FIELDS}

    def loss(params):
        out = jmodel.apply({"params": params}, a["src"], a["tgt_in"], a["src_seg"], a["tgt_seg"],
                           a["seg_first"], a["seg_last"], a["img"], deterministic=True,
                           sample=False, tgt_out=a["tgt_out"],
                           method=JaxVMMTModel.forward_packed)
        gen = jax_generator_params(params, jcfg) if jcfg.fused_ce else None
        return jax_compute_loss(out, a["tgt_out"], a["seg_mask"].reshape(-1),
                                a["img"].reshape(B * Kp, -1), jcfg, jtcfg, jnp.int32(step),
                                generator_params=gen, tgt_seg=a["tgt_seg"])[0]

    return loss


@pytest.mark.parametrize("over", [{}, dict(fused_ce=True), KERNEL_ROUTE],
                         ids=["plain", "fused_ce", "kernels"])
def test_packed_loss_and_every_gradient_match_jax(over):
    jcfg = JaxModelConfig(**TINY, **over)
    tree = perturbed_jax_params(jcfg)
    pb, _ = packed_batch(seed=1)
    step = 7
    want_loss, want_grads = jax.value_and_grad(jax_packed_loss(jcfg, pb, step))(tree)

    cfg = Config(model=ModelConfig(**TINY, **over), train=TrainConfig(**TRAIN, pack=True))
    model = port_model(over, tree)
    loss, metrics, _ = loss_and_grads(cfg, model, batch_tensors(pb, torch.device("cpu")), step,
                                      None, deterministic=True, sample=False)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    assert float(metrics["n_tokens"]) == pb.n_tokens
    assert float(metrics["n_sents"]) == pb.n_sentences
    got = flatten(grads_to_jax(model))
    want = flatten(jax.device_get(want_grads))
    assert set(got) == set(want)
    for name in sorted(want):
        w = np.asarray(want[name])
        np.testing.assert_allclose(got[name], w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=name)


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_packed_equals_unpacked_in_the_port(route):
    """The same sentences packed (rows of 2 and 3 segments) and unpacked
    (one a row): loss, metrics and every gradient."""
    over = KERNEL_ROUTE if route == "kernels" else {}
    tree = perturbed_jax_params(JaxModelConfig(**TINY, **over), seed=2)
    pb, (src, tgt, img) = packed_batch(seed=2)
    idx = sorted(pb.indices[pb.seg_mask > 0].tolist())
    unpacked = next(BucketIterator(BinarizedDataset([src[i] for i in idx], [tgt[i] for i in idx]),
                                   len(idx), [L], img_feats=img[idx]).epoch())
    res = {}
    for name, batch, pack in (("packed", pb, True), ("unpacked", unpacked, False)):
        cfg = Config(model=ModelConfig(**TINY, **over), train=TrainConfig(**TRAIN, pack=pack))
        model = port_model(over, tree)
        loss, metrics, grads = loss_and_grads(cfg, model, batch_tensors(batch, torch.device("cpu")),
                                              3, None, deterministic=True, sample=False)
        res[name] = float(loss.detach()), metrics, [g.detach().clone() for g in grads]
    (lp, mp, gp), (lu, mu, gu) = res["packed"], res["unpacked"]
    assert np.isclose(lp, lu, rtol=2e-5), (lp, lu)
    for k in ("ce_sum", "kl_sum", "img_loss_sum", "n_tokens", "n_sents", "n_correct"):
        a, b = float(mp[k].detach()), float(mu[k].detach())
        assert np.isclose(a, b, rtol=2e-5), (k, a, b)
    for a, b in zip(gp, gu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)


def test_word_dropout_spares_pad_and_every_segment_bos():
    """At word_dropout 1 every other target input becomes UNK."""
    cfg = ModelConfig(**{**TINY, "word_dropout": 1.0})
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(perturbed_jax_params(JaxModelConfig(**TINY)), cfg))
    pb, _ = packed_batch(seed=3)
    b = batch_tensors(pb, torch.device("cpu"))
    seen = []
    model.tgt_embed.register_forward_hook(lambda mod, args, out: seen.append(args[0].clone()))
    model.forward_packed(b["src"], b["tgt_in"], b["src_seg"], b["tgt_seg"], b["seg_first"],
                         b["seg_last"], b["img"], deterministic=False, sample=True,
                         tgt_out=b["tgt_out"], generator=torch.Generator().manual_seed(0))
    dec_in = seen[-1]  # q embeds the gold target first, the decoder its inputs last
    tgt_in = b["tgt_in"]
    keep = (tgt_in == PAD) | (tgt_in == BOS)
    assert int((tgt_in == BOS).sum()) == pb.n_sentences  # one BOS a segment
    assert torch.equal(dec_in[keep], tgt_in[keep])
    assert bool((dec_in[~keep] == UNK).all())


def test_trainer_takes_finite_packed_steps_on_the_cpu():
    src, tgt, img = corpus(n=12, seed=9)
    cfg = Config(model=ModelConfig(**TINY, **KERNEL_ROUTE),
                 train=TrainConfig(**TRAIN, seed=5, pack=True, pack_segments=K))
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(
        perturbed_jax_params(JaxModelConfig(**TINY, **KERNEL_ROUTE)), cfg.model))
    it = PackedBucketIterator(BinarizedDataset(src, tgt), 2, [L], img_feats=img,
                              max_segments=cfg.train.pack_segments)
    trainer = Trainer(cfg, model, it, device="cpu")
    hist = trainer.train(3)
    assert len(hist) == 3 and trainer.state.step == 3
    for h in hist:
        assert all(np.isfinite(v) for v in h.values())
        assert h["n_sents"] > 2  # more sentences than rows


def test_pack_flag_and_batch_must_agree():
    pb, _ = packed_batch()
    model = port_model({}, perturbed_jax_params(JaxModelConfig(**TINY)))
    cfg = Config(model=ModelConfig(**TINY), train=TrainConfig(**TRAIN))
    b = batch_tensors(pb, torch.device("cpu"))
    assert isinstance(pb, PackedBatch) and b["img"].shape == (3, K, TINY["img_feat_dim"])
    with pytest.raises(ValueError, match="packed"):
        loss_and_grads(cfg, model, b, 0, None, deterministic=True, sample=False)
    with pytest.raises(ValueError, match="packed"):
        loss_and_grads(dataclasses.replace(cfg, train=TrainConfig(pack=True)), model,
                       batch_tensors(next(BucketIterator(BinarizedDataset(*corpus()[:2]), 2,
                                                         [L]).epoch()), torch.device("cpu")),
                       0, None, deterministic=True, sample=False)
