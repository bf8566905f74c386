"""PyTorch port: the K-sample IW-ELBO (``decode/iw_eval.py``) against the
JAX package's ``make_iw_elbo_fn`` and ``iw_elbo_corpus`` on tiny models,
f32 on the CPU (the kernel route runs the kernels' plain versions here,
JAX's Pallas kernels in interpret mode). JAX's own noise is injected: the
eps of sample k is ``jax.random.normal(keys[k], mu.shape)`` over
``keys = jax.random.split(rng, K)`` (the corpus folds the batch index into
``rng`` first), as ``reparameterize`` draws it (models/latent.py:119-121).
Tolerances: ``iw_elbo_sum`` and ``iw_text_sum`` 1e-5 relative, the
corpus's per-sentence bounds and IW perplexity 1e-5 relative; ``n_sents``
and ``n_tokens`` exact. ``nmt`` raises in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.data.dataset import BinarizedDataset as JaxBinarizedDataset
from variational_mmt_tpu.data.dataset import BucketIterator as JaxBucketIterator
from variational_mmt_tpu.decode.iw_eval import iw_elbo_corpus as jax_iw_elbo_corpus
from variational_mmt_tpu.decode.iw_eval import make_iw_elbo_fn as jax_make_iw_elbo_fn
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.models.model import init_params as jax_init_params
from variational_mmt_torch.config import ModelConfig
from variational_mmt_torch.convert import params_from_jax
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.decode.iw_eval import iw_elbo_corpus, make_iw_elbo_fn
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.train.trainer import batch_tensors

TINY = dict(src_vocab_size=24, tgt_vocab_size=24, emb_dim=16, hidden_dim=16, latent_dim=4,
            img_feat_dim=6, compute_dtype="float32")
KERNEL_ROUTE = dict(use_pallas=True, pallas_decoder=True, fused_ce=True)
LAYOUT = ("src", "tgt_in", "tgt_out", "example_mask", "img")


def models(over, seed=0):
    """(JAX model, JAX params, the port's model with the same params)."""
    kw = {**TINY, **over}
    jmodel = jax_build_model(JaxModelConfig(**kw))
    tree = jax.device_get(jax_init_params(jmodel, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a)))
                        .astype(np.float32), tree)
    cfg = ModelConfig(**kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    return jmodel, tree, model


def corpus(n=11, seed=1):
    rng = np.random.default_rng(seed)
    src = [rng.integers(4, 24, rng.integers(2, 9)).astype(np.int32) for _ in range(n)]
    tgt = [rng.integers(4, 24, rng.integers(2, 8)).astype(np.int32) for _ in range(n)]
    img = rng.standard_normal((n, TINY["img_feat_dim"])).astype(np.float32)
    return src, tgt, img


def host_batches(batch_size=4):
    src, tgt, img = corpus()
    return list(BucketIterator(BinarizedDataset(src, tgt), batch_size, [5, 10],
                               img_feats=img).epoch(0))


def jax_eps(rng, k_samples, shape):
    """(K, B, D): the draws of JAX's K samples from ``rng``."""
    keys = jax.random.split(rng, k_samples)
    return np.stack([np.asarray(jax.random.normal(k, shape, dtype=jnp.float32)) for k in keys])


CASES = [(fam, img_pred, k, route) for fam in ("vmmt_c", "vmmt_f") for img_pred in (True, False)
         for k, route in ((1, "plain"), (3, "kernels"))]


@pytest.mark.parametrize("family,img_pred,k_samples,route", CASES,
                         ids=lambda v: str(v))
def test_iw_elbo_fn_matches_jax(family, img_pred, k_samples, route):
    over = dict(model_type=family, use_img_predict=img_pred,
                **(KERNEL_ROUTE if route == "kernels" else {}))
    jmodel, tree, model = models(over)
    batch = host_batches()[0]
    rng = jax.random.PRNGKey(5)
    want = jax.jit(jax_make_iw_elbo_fn(jmodel, k_samples))(
        tree, {k: jnp.asarray(getattr(batch, k)) for k in LAYOUT}, rng)
    bt = batch_tensors(batch, torch.device("cpu"))
    mu_shape = (batch.batch_size, TINY["latent_dim"])
    got = make_iw_elbo_fn(model, k_samples)(
        bt, eps=torch.from_numpy(jax_eps(rng, k_samples, mu_shape)))
    for k in ("iw_elbo_sum", "iw_text_sum"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    for k in ("n_sents", "n_tokens"):
        assert float(got[k]) == float(want[k])
    if not img_pred:
        assert float(got["iw_elbo_sum"]) == float(got["iw_text_sum"])


def test_iw_elbo_corpus_matches_jax_over_three_batches():
    jmodel, tree, model = models(dict(model_type="vmmt_c"))
    src, tgt, img = corpus()
    kw = dict(batch_size=4, buckets=[5, 10], img_feats=img, shuffle=False)
    jbatches = [{k: jnp.asarray(getattr(b, k)) for k in LAYOUT}
                for b in JaxBucketIterator(JaxBinarizedDataset(src, tgt), use_native=False,
                                           **kw).epoch(0)]
    batches = list(BucketIterator(BinarizedDataset(src, tgt), **kw).epoch(0))
    assert len(batches) == len(jbatches) == 3
    rng = jax.random.PRNGKey(7)
    want = jax_iw_elbo_corpus(jmodel, tree, jbatches, 2, rng)
    shapes = [(b.batch_size, TINY["latent_dim"]) for b in batches]
    got = iw_elbo_corpus(model, [batch_tensors(b, torch.device("cpu")) for b in batches], 2,
                         eps=lambda i: torch.from_numpy(
                             jax_eps(jax.random.fold_in(rng, i), 2, shapes[i])))
    assert set(got) == set(want) and got["n_sents"] == want["n_sents"] == 11
    for k in ("iw_elbo_per_sent", "iw_text_per_sent", "iw_ppl"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_iw_elbo_corpus_draws_from_its_seed():
    _, _, model = models(dict(model_type="vmmt_c"))
    batches = [batch_tensors(b, torch.device("cpu")) for b in host_batches()]
    a = iw_elbo_corpus(model, batches, 3, seed=4)
    b = iw_elbo_corpus(model, batches, 3, seed=4)
    c = iw_elbo_corpus(model, batches, 3, seed=5)
    assert a == b and a != c
    assert np.isfinite(a["iw_elbo_per_sent"]) and a["iw_ppl"] > 1.0


def test_nmt_raises_in_both_packages():
    jmodel, _, model = models(dict(model_type="nmt", img_feat_dim=0))
    with pytest.raises(ValueError, match="latent"):
        jax_make_iw_elbo_fn(jmodel, 2)
    with pytest.raises(ValueError, match="latent"):
        make_iw_elbo_fn(model, 2)
