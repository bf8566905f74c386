"""PyTorch port: the conditional prior and whole beam-search translation
against the JAX package on a tiny vmmt_c (Pallas kernels in interpret
mode). N-best token ids must be identical; scores agree to 1e-4 (f32 sums
of up to ten log-probs, each within 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variational_mmt_tpu.config import DecodeConfig as JaxDecodeConfig
from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.data.vocab import SPECIALS as JAX_SPECIALS
from variational_mmt_tpu.data.vocab import Vocab as JaxVocab
from variational_mmt_tpu.decode.translator import Translator as JaxTranslator
from variational_mmt_tpu.models.model import VMMTModel as JaxVMMTModel
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.models.model import init_params as jax_init_params
from variational_mmt_torch.config import DecodeConfig, ModelConfig
from variational_mmt_torch.convert import params_from_jax
from variational_mmt_torch.data.vocab import SPECIALS, Vocab
from variational_mmt_torch.decode.translator import Translator
from variational_mmt_torch.models.model import build_model

TINY = dict(model_type="vmmt_c", src_vocab_size=24, tgt_vocab_size=24, emb_dim=16,
            hidden_dim=16, latent_dim=4, img_feat_dim=6, compute_dtype="float32",
            use_pallas=True)
SRC = [[5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15], [4, 20], [16, 17, 18, 19, 5]]


def setup(seed=0):
    jcfg = JaxModelConfig(**TINY)
    jmodel = jax_build_model(jcfg)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))).astype(np.float32),
        jax.device_get(jax_init_params(jmodel, jax.random.PRNGKey(seed))))
    cfg = ModelConfig(**TINY)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    img = rng.standard_normal((len(SRC), TINY["img_feat_dim"])).astype(np.float32)
    return jmodel, tree, model, img


def test_prior_latent_matches_jax():
    jmodel, tree, model, img = setup()
    summary = np.tanh(np.random.default_rng(5).standard_normal((4, 16))).astype(np.float32)
    mu, sigma = jmodel.apply({"params": tree}, jnp.asarray(summary), jnp.asarray(img),
                             method=JaxVMMTModel.prior_params)
    with torch.no_grad():
        t_mu, t_sigma = model.prior_params(torch.from_numpy(summary), torch.from_numpy(img))
        t_z = model.prior_latent(torch.from_numpy(summary), torch.from_numpy(img))
    np.testing.assert_allclose(t_mu.numpy(), np.asarray(mu), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_sigma.numpy(), np.asarray(sigma), rtol=1e-5, atol=1e-5)
    assert torch.equal(t_z, t_mu)


@pytest.mark.parametrize("pallas_step,beam_size", [(0, 4), (1, 4), (1, 2), (2, 4)])
def test_translator_matches_jax(pallas_step, beam_size):
    jmodel, tree, model, img = setup()
    kw = dict(beam_size=beam_size, n_best=beam_size, max_length=10, batch_size=4,
              pallas_step=pallas_step)
    words = [f"w{i}" for i in range(20)]
    jtr = JaxTranslator(jmodel, tree, JaxVocab(JAX_SPECIALS + words),
                        JaxVocab(JAX_SPECIALS + words), JaxDecodeConfig(**kw), buckets=[8])
    vocab = Vocab(SPECIALS + words)
    tr = Translator(model, vocab, vocab, DecodeConfig(**kw), buckets=[8], device="cpu")
    want = jtr.translate_ids(SRC, img)
    got = tr.translate_ids(SRC, img)
    assert len(got) == len(want) == len(SRC)
    for g_nbest, w_nbest in zip(got, want):
        assert [ids for _, ids in g_nbest] == [ids for _, ids in w_nbest]
        np.testing.assert_allclose([s for s, _ in g_nbest], [s for s, _ in w_nbest],
                                   rtol=1e-4, atol=1e-4)
    tokens = [[f"w{i - 4}" for i in s] for s in SRC]
    text = tr.translate_tokens(tokens, img)
    assert [t for _, t in text[0]] == [vocab.ids_to_text(ids) for _, ids in got[0]]


def test_greedy_path_matches_jax():
    jmodel, tree, model, img = setup(seed=1)
    kw = dict(beam_size=1, n_best=1, max_length=10, batch_size=4)
    words = [f"w{i}" for i in range(20)]
    jtr = JaxTranslator(jmodel, tree, JaxVocab(JAX_SPECIALS + words),
                        JaxVocab(JAX_SPECIALS + words), JaxDecodeConfig(**kw), buckets=[8])
    vocab = Vocab(SPECIALS + words)
    tr = Translator(model, vocab, vocab, DecodeConfig(**kw), buckets=[8], device="cpu")
    want = jtr.translate_ids(SRC, img)
    got = tr.translate_ids(SRC, img)
    for (gs, gi), (ws, wi) in zip((n[0] for n in got), (n[0] for n in want)):
        assert gi == wi
        assert abs(gs - ws) <= 1e-4
