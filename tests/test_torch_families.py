"""PyTorch port: the model families nmt and vmmt_f and ``z_cond=init+input``
against the JAX package on tiny models (Pallas kernels in interpret mode),
on the kernel route (use_pallas, pallas_decoder, fused_ce) and the plain
route, f32 throughout:

- loss and every parameter gradient against ``jax.grad`` of the JAX
  package's plain route (computed once a family, the same math as its
  Pallas route), unpacked, and
  for nmt and vmmt_c+init+input also sequence-packed
  (``forward_packed``); tolerances of tests/test_torch_train.py (loss 1e-5
  relative; each gradient 1e-4 relative plus 1e-5 of its largest entry);
- the parameter tree of each configuration round-trips through
  ``convert.py`` with exactly JAX's key set;
- beam-4 translation: n-best ids identical to JAX's ``Translator``, scores
  within 1e-4 (tests/test_torch_translate.py), at pallas_step 0, 1 and 2.

nmt runs as the quality gate builds it: no image features (img_feat_dim 0),
and here with ``use_img_predict`` left on, which builds no image head.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variational_mmt_tpu.config import DecodeConfig as JaxDecodeConfig
from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.config import TrainConfig as JaxTrainConfig
from variational_mmt_tpu.data.vocab import SPECIALS as JAX_SPECIALS
from variational_mmt_tpu.data.vocab import Vocab as JaxVocab
from variational_mmt_tpu.decode.translator import Translator as JaxTranslator
from variational_mmt_tpu.models.model import VMMTModel as JaxVMMTModel
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.models.model import init_params as jax_init_params
from variational_mmt_tpu.train.loss import compute_loss as jax_compute_loss
from variational_mmt_torch.config import Config, DecodeConfig, ModelConfig, TrainConfig
from variational_mmt_torch.convert import flatten, grads_to_jax, params_from_jax, params_to_jax
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.data.packing import PackedBucketIterator
from variational_mmt_torch.data.vocab import SPECIALS, Vocab
from variational_mmt_torch.decode.translator import Translator
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.train.trainer import batch_tensors, loss_and_grads

TINY = dict(src_vocab_size=24, tgt_vocab_size=24, emb_dim=16, hidden_dim=16, latent_dim=4,
            img_feat_dim=6, compute_dtype="float32", dropout=0.3, word_dropout=0.1)
FAMILIES = {
    "nmt": dict(model_type="nmt", img_feat_dim=0),
    "vmmt_f": dict(model_type="vmmt_f"),
    "vmmt_c+init+input": dict(model_type="vmmt_c", z_cond="init+input"),
    "vmmt_f+init+input": dict(model_type="vmmt_f", z_cond="init+input"),
}
KERNEL_ROUTE = dict(use_pallas=True, pallas_decoder=True, fused_ce=True)
ROUTES = {"kernels": KERNEL_ROUTE, "plain": {}}
TRAIN = dict(label_smoothing=0.1, kl_anneal_steps=10)
STEP = 7  # KL beta 0.7


def config(family, route="plain"):
    return {**TINY, **FAMILIES[family], **ROUTES[route]}


def corpus(family, n=9, seed=0, lo=2, hi=9):
    """n pairs of ids in 4..23 and, unless the family is nmt, image rows."""
    rng = np.random.default_rng(seed)
    src = [rng.integers(4, 24, rng.integers(lo, hi)).astype(np.int32) for _ in range(n)]
    tgt = [rng.integers(4, 24, rng.integers(lo, hi)).astype(np.int32) for _ in range(n)]
    img = rng.standard_normal((n, TINY["img_feat_dim"])).astype(np.float32)
    return src, tgt, (None if family == "nmt" else img)


def jax_tree(kw, seed=0, noise=0.1):
    """JAX's initial parameters, plus noise so that zero biases are not."""
    tree = jax.device_get(jax_init_params(jax_build_model(JaxModelConfig(**kw)),
                                          jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + noise * rng.standard_normal(np.shape(a)))
                        .astype(np.float32), tree)


def port_model(kw, tree):
    cfg = ModelConfig(**kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    return model


def jnp_or_none(a):
    return None if a is None else jnp.asarray(a)


def assert_loss_and_grads_match(kw, tree, want_loss, want_grads, batch, pack):
    cfg = Config(model=ModelConfig(**kw), train=TrainConfig(**TRAIN, pack=pack))
    model = port_model(kw, tree)
    loss, _, _ = loss_and_grads(cfg, model, batch_tensors(batch, torch.device("cpu")), STEP,
                                None, deterministic=True, sample=False)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = flatten(grads_to_jax(model))
    want = flatten(jax.device_get(want_grads))
    assert set(got) == set(want)
    for name in sorted(want):
        w = np.asarray(want[name])
        np.testing.assert_allclose(got[name], w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=name)


@functools.lru_cache(maxsize=None)
def jax_unpacked(family):
    """(tree, batch, loss, gradients) of JAX's plain route on one batch."""
    kw = config(family)
    jcfg = JaxModelConfig(**kw)
    tree = jax_tree(kw)
    src, tgt, img = corpus(family)
    batch = next(BucketIterator(BinarizedDataset(src, tgt), 6, [10], img_feats=img).epoch())
    jmodel = jax_build_model(jcfg)

    def jax_loss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(batch.src), jnp.asarray(batch.tgt_in),
                           jnp_or_none(batch.img), deterministic=True, sample=False,
                           tgt_out=jnp.asarray(batch.tgt_out))
        assert ("mu_q" in out) == (family != "nmt")
        return jax_compute_loss(out, jnp.asarray(batch.tgt_out), jnp.asarray(batch.example_mask),
                                jnp_or_none(batch.img), jcfg, JaxTrainConfig(**TRAIN),
                                jnp.int32(STEP))[0]

    return (tree, batch) + tuple(jax.value_and_grad(jax_loss)(tree))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_every_gradient_match_jax(family, route):
    tree, batch, want_loss, want_grads = jax_unpacked(family)
    assert_loss_and_grads_match(config(family, route), tree, want_loss, want_grads, batch,
                                pack=False)


@functools.lru_cache(maxsize=None)
def jax_packed(family):
    """(tree, packed batch, loss, gradients) of JAX's plain route."""
    kw = config(family)
    jcfg = JaxModelConfig(**kw)
    tree = jax_tree(kw, seed=1)
    src, tgt, img = corpus(family, seed=1)
    pb = next(iter(PackedBucketIterator(BinarizedDataset(src, tgt), 3, [16], img_feats=img,
                                        shuffle=False, max_segments=3).epoch()))
    assert pb.seg_mask.sum(1).max() >= 2
    B, K = pb.seg_mask.shape
    a = {f: jnp.asarray(getattr(pb, f)) for f in
         ("src", "tgt_in", "tgt_out", "src_seg", "tgt_seg", "seg_first", "seg_last", "seg_mask")}
    img_j = None if pb.img is None else jnp.asarray(pb.img)
    jmodel = jax_build_model(jcfg)

    def jax_loss(params):
        out = jmodel.apply({"params": params}, a["src"], a["tgt_in"], a["src_seg"], a["tgt_seg"],
                           a["seg_first"], a["seg_last"], img_j, deterministic=True,
                           sample=False, tgt_out=a["tgt_out"],
                           method=JaxVMMTModel.forward_packed)
        return jax_compute_loss(out, a["tgt_out"], a["seg_mask"].reshape(-1),
                                None if img_j is None else img_j.reshape(B * K, -1), jcfg,
                                JaxTrainConfig(**TRAIN), jnp.int32(STEP),
                                tgt_seg=a["tgt_seg"])[0]

    return (tree, pb) + tuple(jax.value_and_grad(jax_loss)(tree))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("family", ["nmt", "vmmt_c+init+input"])
def test_packed_loss_and_every_gradient_match_jax(family, route):
    tree, pb, want_loss, want_grads = jax_packed(family)
    assert_loss_and_grads_match(config(family, route), tree, want_loss, want_grads, pb,
                                pack=True)


def test_nmt_packed_forward_needs_no_gold_target():
    """Only the posterior reads ``tgt_out``: nmt's packed forward runs
    without it, a latent model's raises (as in JAX)."""
    src, tgt, _ = corpus("nmt", seed=1)
    pb = next(iter(PackedBucketIterator(BinarizedDataset(src, tgt), 3, [16], shuffle=False,
                                        max_segments=3).epoch()))
    t = batch_tensors(pb, torch.device("cpu"))
    args = (t["src"], t["tgt_in"], t["src_seg"], t["tgt_seg"], t["seg_first"], t["seg_last"])
    nmt = port_model(config("nmt"), jax_tree(config("nmt")))
    with torch.no_grad():
        out = nmt.forward_packed(*args, sample=False)
    assert set(out) == {"logits", "aligns"}
    kw = config("vmmt_f")
    with pytest.raises(ValueError, match="tgt_out"):
        port_model(kw, jax_tree(kw)).forward_packed(*args, sample=False)


ROUND_TRIP = {**{f: FAMILIES[f] for f in FAMILIES},
              "nmt+init+input": dict(model_type="nmt", z_cond="init+input"),
              "vmmt_c": dict(model_type="vmmt_c")}


@pytest.mark.parametrize("family", ROUND_TRIP)
def test_parameter_tree_round_trips_with_jax_key_set(family):
    kw = {**TINY, **ROUND_TRIP[family], "use_pallas": True}
    tree = jax_tree(kw, noise=0.0)
    flat = flatten(tree)
    latent = kw["model_type"] != "nmt"
    for sub in ("tgt_encoder", "infnet", "img_pred"):
        assert any(k.startswith(sub + ".") for k in flat) == latent, sub
    assert any(k.startswith("prior.") for k in flat) == (kw["model_type"] == "vmmt_c")
    assert ("z_input_proj.kernel" in flat) == (latent and kw.get("z_cond") == "init+input")
    H = TINY["hidden_dim"]
    assert flat["bridge0.kernel"].shape == (H + (TINY["latent_dim"] if latent else 0), H)
    cfg = ModelConfig(**kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))  # strict: every key
    got = flatten(params_to_jax(model.state_dict()))
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


SRC = [[5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15], [4, 20], [16, 17, 18, 19, 5]]


@pytest.mark.parametrize("pallas_step", [0, 1, 2])
@pytest.mark.parametrize("family", FAMILIES)
def test_translator_matches_jax(family, pallas_step):
    kw = {**TINY, **FAMILIES[family], "use_pallas": True}
    tree = jax_tree(kw, seed=2)
    img = None
    if family != "nmt":
        img = np.random.default_rng(2).standard_normal(
            (len(SRC), TINY["img_feat_dim"])).astype(np.float32)
    dkw = dict(beam_size=4, n_best=4, max_length=10, batch_size=4, pallas_step=pallas_step)
    words = [f"w{i}" for i in range(20)]
    jvocab = JaxVocab(JAX_SPECIALS + words)
    jtr = JaxTranslator(jax_build_model(JaxModelConfig(**kw)), tree, jvocab, jvocab,
                        JaxDecodeConfig(**dkw), buckets=[8])
    vocab = Vocab(SPECIALS + words)
    tr = Translator(port_model(kw, tree), vocab, vocab, DecodeConfig(**dkw), buckets=[8],
                    device="cpu")
    want = jtr.translate_ids(SRC, img)
    got = tr.translate_ids(SRC, img)
    assert len(got) == len(want) == len(SRC)
    for g_nbest, w_nbest in zip(got, want):
        assert [ids for _, ids in g_nbest] == [ids for _, ids in w_nbest]
        np.testing.assert_allclose([s for s, _ in g_nbest], [s for s, _ in w_nbest],
                                   rtol=1e-4, atol=1e-4)
