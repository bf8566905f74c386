"""PyTorch port: the latent diagnostics (``decode/diagnostics.py``) against
the JAX package's on tiny vmmt_c and vmmt_f, f32 on the CPU: the
per-dimension sums of one batch within 1e-5 relative, and the corpus's
aggregate (active units at delta 0.01, the KL spectrum) with ``au`` and
``kl_active_dims`` exact and every float within 1e-5 relative. The host
aggregation is held equal to JAX's on hand-made sums too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_iw_eval import LAYOUT, corpus, models
from variational_mmt_tpu.data.dataset import BinarizedDataset as JaxBinarizedDataset
from variational_mmt_tpu.data.dataset import BucketIterator as JaxBucketIterator
from variational_mmt_tpu.decode.diagnostics import aggregate_latent_stats as jax_aggregate
from variational_mmt_tpu.decode.diagnostics import latent_stats_corpus as jax_stats_corpus
from variational_mmt_tpu.decode.diagnostics import make_latent_stats_fn as jax_stats_fn
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.decode.diagnostics import (aggregate_latent_stats,
                                                      latent_stats_corpus,
                                                      make_latent_stats_fn)
from variational_mmt_torch.train.trainer import batch_tensors


def batches(img):
    src, tgt, feats = corpus(n=13, seed=2)
    kw = dict(batch_size=4, buckets=[5, 10], img_feats=feats if img else None, shuffle=False)
    jb = [{k: jnp.asarray(getattr(b, k)) for k in LAYOUT if getattr(b, k) is not None}
          for b in JaxBucketIterator(JaxBinarizedDataset(src, tgt), use_native=False,
                                     **kw).epoch(0)]
    pb = [batch_tensors(b, torch.device("cpu"))
          for b in BucketIterator(BinarizedDataset(src, tgt), **kw).epoch(0)]
    return jb, pb


@pytest.mark.parametrize("family", ["vmmt_c", "vmmt_f"])
def test_latent_stats_match_jax(family):
    jmodel, tree, model = models(dict(model_type=family))
    jb, pb = batches(img=True)
    want = jax.device_get(jax_stats_fn(jmodel)(tree, jb[0]))
    got = make_latent_stats_fn(model)(pb[0])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = jax_stats_corpus(jmodel, tree, jb)
    got = latent_stats_corpus(model, pb)
    assert set(got) == set(want)
    for k in ("n_sents", "latent_dim", "au", "kl_active_dims"):
        assert got[k] == want[k], k
    for k in ("kl_per_sent", "var_mu_max", "var_mu_median", "au_delta"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["kl_top8"], want["kl_top8"], rtol=1e-5, atol=1e-4)


def test_aggregate_matches_jax_on_hand_made_sums():
    rng = np.random.default_rng(3)
    stats = [{"sum_mu": rng.standard_normal(6), "sum_mu2": 2.0 + rng.random(6),
              "sum_kl": rng.random(6) * np.array([0, 1, 0.001, 2, 0, 0.5]),
              "n_sents": 4.0} for _ in range(3)]
    for delta in (0.01, 0.2):
        assert aggregate_latent_stats(stats, delta) == jax_aggregate(stats, delta)
    for bad in ([], [dict(stats[0], n_sents=0.0)]):
        with pytest.raises(ValueError):
            aggregate_latent_stats(bad)


def test_nmt_raises():
    _, _, model = models(dict(model_type="nmt", img_feat_dim=0))
    with pytest.raises(ValueError, match="latent"):
        make_latent_stats_fn(model)
