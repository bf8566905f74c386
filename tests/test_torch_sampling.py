"""PyTorch port: sampling decode and ``latent_from=sample`` against JAX's.

JAX draws from threefry keys folded from (seed, stream id), which the port
cannot reproduce; it draws from counter-based streams
(variational_mmt_torch/decode/streams.py). So parity is held with injected
noise: a stand-in for ``Translator.streams`` draws JAX's own Gumbel noise
and latent ``eps`` on JAX's keys, and the port's tokens and z must then be
JAX's: n-best ids identical, scores within 1e-4 (f32), at pallas_step 0, 1
and 2. ``jax.random.categorical`` is ``argmax(logits + gumbel(key))``
(checked here for the installed JAX). Without injection, the port's own
streams pass the properties of tests/test_sampling.py: the limits equal
greedy (and JAX's greedy), determinism and seed sensitivity, invariance to
batch and bucket, ``stream_ids`` replacing positions, sampled scores equal
to force-decode scores (1e-3, as JAX's test), ``min_length``, and JAX's
messages for the rejected configs."""

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
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.models.model import init_params as jax_init_params
from variational_mmt_tpu.ops import beam as jax_beam
from variational_mmt_torch.config import DecodeConfig, ModelConfig
from variational_mmt_torch.convert import params_from_jax
from variational_mmt_torch.data.vocab import EOS, SPECIALS, Vocab
from variational_mmt_torch.decode import streams
from variational_mmt_torch.decode.score import score_corpus
from variational_mmt_torch.decode.translator import Translator
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.ops import beam

WORDS = [f"w{i}" for i in range(20)]
SRC = [[5, 6, 7], [8, 9], [10, 11, 12], [13], [14, 15], [16, 17, 18]]
_TREES = {}


class JaxStreams:
    """JAX's draws on JAX's keys (translator.py:134-141, :167-172, :212):
    row key fold_in(PRNGKey(seed), stream id); the latent's eps
    normal(fold_in(fold_in(row, 0), member)); step t's Gumbel noise
    gumbel(fold_in(fold_in(row, 1), t)), which categorical adds."""

    def __init__(self, seed, stream_ids):
        base = jax.random.PRNGKey(seed)
        ids = jnp.asarray(stream_ids.cpu().numpy(), jnp.int32)
        self.rows = jax.vmap(lambda i: jax.random.fold_in(base, i))(ids)

    def latent_eps(self, member, n):
        keys = jax.vmap(lambda k: jax.random.fold_in(jax.random.fold_in(k, 0), member))(self.rows)
        return torch.tensor(np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (n,), jnp.float32))(keys)))

    def token_gumbel(self, t, n):
        keys = jax.vmap(lambda k: jax.random.fold_in(jax.random.fold_in(k, 1), t))(self.rows)
        return torch.tensor(np.asarray(jax.vmap(
            lambda k: jax.random.gumbel(k, (n,), jnp.float32))(keys)))


def setup(model_type="nmt", **dec):
    """JAX's model and parameters (init + noise) and the port's on them
    (the shapes of tests/test_sampling.py)."""
    mcfg = dict(model_type=model_type, src_vocab_size=24, tgt_vocab_size=24, emb_dim=16,
                hidden_dim=32, enc_layers=1, dec_layers=2, latent_dim=4, img_feat_dim=8,
                dropout=0.0, compute_dtype="float32", use_pallas=True)
    jmodel = jax_build_model(JaxModelConfig(**mcfg))
    if model_type not in _TREES:
        rng = np.random.default_rng(7)
        _TREES[model_type] = jax.tree.map(
            lambda a: (np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a))).astype(
                np.float32), jax.device_get(jax_init_params(jmodel, jax.random.PRNGKey(7))))
    tree = _TREES[model_type]
    cfg = ModelConfig(**mcfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    dcfg = DecodeConfig(**{"beam_size": 1, "max_length": 12, "batch_size": 4, **dec})
    return jmodel, tree, model, dcfg, Vocab(SPECIALS + WORDS)


def port(model, dcfg, vocab, buckets=(8,), jax_noise=False):
    tr = Translator(model, vocab, vocab, dcfg, buckets=list(buckets), device="cpu")
    if jax_noise:
        tr.streams = JaxStreams
    return tr


def top1(out):
    return [nbest[0] for nbest in out]


FEATS = np.random.default_rng(0).standard_normal((len(SRC), 8)).astype(np.float32)


def test_categorical_is_argmax_of_gumbel_plus_logits():
    key = jax.random.PRNGKey(3)
    logits = jnp.asarray(np.random.default_rng(1).standard_normal((64, 24)), jnp.float32)
    keys = jax.random.split(key, 64)
    want = jax.vmap(jax.random.categorical)(keys, logits)
    got = jnp.argmax(logits + jax.vmap(lambda k: jax.random.gumbel(k, (24,), jnp.float32))(keys),
                     axis=-1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("temp,topk,topp", [(1.0, 0, 0.0), (0.7, 5, 0.0), (1.3, 0, 0.6),
                                            (1.0, 3, 0.9), (2.0, 1, 0.0)])
def test_sampling_filter_keeps_what_jax_keeps(temp, topk, topp):
    """The kept set (and the renormalized log-probs) of the port's
    ``sampling_filter`` against JAX's lines (ops/beam.py:408-431, restated
    with jnp) on random logits with ties, EOS blocked or not."""
    rng = np.random.default_rng(int(temp * 10) + topk)
    lp = rng.standard_normal((32, 24)).astype(np.float32)
    lp[:, 5:9] = lp[:, 5:6]  # a tie of four tokens
    lp[::3, 10:12] = lp[::3, 12:13] = 3.0  # tied maxima
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(lp), axis=-1))
    for block in (False, True):
        filt = jnp.asarray(lp)
        if block:
            filt = filt.at[:, EOS].set(beam.NEG_INF)
        if temp != 1.0:
            filt = jax.nn.log_softmax(filt / temp, axis=-1)
        if topk:
            kth = jax.lax.top_k(filt, topk)[0][:, -1]
            filt = jax.nn.log_softmax(jnp.where(filt < kth[:, None], beam.NEG_INF, filt), -1)
        if topp:
            sorted_lp = -jnp.sort(-filt, axis=-1)
            probs = jnp.exp(sorted_lp)
            keep = (jnp.cumsum(probs, axis=-1) - probs) < topp
            thresh = jnp.min(jnp.where(keep, sorted_lp, jnp.inf), axis=-1)
            filt = jnp.where(filt < thresh[:, None], beam.NEG_INF, filt)
        want = np.asarray(filt)
        got = beam.sampling_filter(torch.tensor(lp), block, temp, topk, topp).numpy()
        np.testing.assert_array_equal(got > beam.NEG_INF / 2, want > beam.NEG_INF / 2)
        kept = want > beam.NEG_INF / 2
        np.testing.assert_allclose(got[kept], want[kept], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(temperature=1.0), dict(temperature=0.8, topk=4),
                                dict(temperature=1.2, topp=0.7), dict(min_length=4)],
                         ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_sampling_search_matches_jax_with_its_noise(kw):
    V, B, L = 12, 5, 9
    rng = np.random.default_rng(2)
    table = np.asarray(jax.nn.log_softmax(jnp.asarray(
        rng.standard_normal((V, V)).astype(np.float32)), axis=-1))
    rows = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(5), i))(jnp.arange(B))
    jt, js = jax_beam.sampling_search(lambda c, k: (c, jnp.asarray(table)[k]),
                                      jnp.zeros((B,)), B, L, rows, **kw)

    def noise(t, n):
        keys = jax.vmap(lambda k: jax.random.fold_in(k, t))(rows)
        return torch.tensor(np.asarray(jax.vmap(
            lambda k: jax.random.gumbel(k, (n,), jnp.float32))(keys)))

    tt = torch.tensor(table)
    pt, ps = beam.sampling_search(lambda c, k: (c, tt[k]), torch.zeros(B), B, L, noise, **kw)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("dec", [
    dict(sampling_temp=1.3, sampling_topk=5), dict(sampling_temp=0.9, sampling_topp=0.8),
    dict(latent_from="sample", beam_size=4, n_best=2),
], ids=["topk", "topp", "latent_sample"])
def test_translator_matches_jax_with_its_noise(dec, mode):
    jmodel, tree, model, dcfg, vocab = setup("vmmt_c", pallas_step=mode, decode_seed=11, **dec)
    jv = JaxVocab(JAX_SPECIALS + WORDS)
    jkw = {"beam_size": 1, "max_length": 12, "batch_size": 4, "pallas_step": mode,
           "decode_seed": 11, **dec}
    want = JaxTranslator(jmodel, tree, jv, jv, JaxDecodeConfig(**jkw),
                         buckets=[8]).translate_ids(SRC, FEATS)
    got = port(model, dcfg, vocab, jax_noise=True).translate_ids(SRC, FEATS)
    for g_nb, w_nb in zip(got, want):
        assert [ids for _, ids in g_nb] == [ids for _, ids in w_nb]
        np.testing.assert_allclose([s for s, _ in g_nb], [s for s, _ in w_nb], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("dec", [dict(sampling_topk=1), dict(sampling_topp=1e-9),
                                 dict(sampling_temp=1e-4)],
                         ids=["topk1", "tiny_topp", "low_temperature"])
def test_limits_equal_greedy_and_jax_greedy(dec):
    jmodel, tree, model, dcfg, vocab = setup()
    greedy = top1(port(model, dcfg, vocab).translate_ids(SRC))
    jv = JaxVocab(JAX_SPECIALS + WORDS)
    jgreedy = top1(JaxTranslator(jmodel, tree, jv, jv, JaxDecodeConfig(
        beam_size=1, max_length=12, batch_size=4), buckets=[8]).translate_ids(SRC))
    assert [ids for _, ids in greedy] == [ids for _, ids in jgreedy]
    sdcfg = DecodeConfig(**{**dcfg.__dict__, "sampling_temp": 1.0, **dec})
    sampled = top1(port(model, sdcfg, vocab).translate_ids(SRC))
    assert [ids for _, ids in sampled] == [ids for _, ids in greedy]
    if "sampling_topk" in dec:
        for (ss, _), (gs, _) in zip(sampled, greedy):
            assert ss == pytest.approx(gs, abs=1e-5)


def test_sampling_deterministic_and_seed_sensitive():
    _, _, model, dcfg, vocab = setup(sampling_temp=2.0)
    a = top1(port(model, dcfg, vocab).translate_ids(SRC))
    assert a == top1(port(model, dcfg, vocab).translate_ids(SRC))
    tr = port(model, dcfg, vocab)
    assert [ids for _, ids in top1(tr.translate_ids(SRC, seed=999))] != [ids for _, ids in a]
    assert top1(tr.translate_ids(SRC)) == a  # the override lasts one call


def test_sampling_batch_and_bucket_invariance():
    _, _, model, dcfg, vocab = setup(sampling_temp=1.0)
    small = top1(port(model, dcfg, vocab).translate_ids(SRC))
    big = top1(port(model, DecodeConfig(**{**dcfg.__dict__, "batch_size": 6}), vocab)
               .translate_ids(SRC))
    split = top1(port(model, dcfg, vocab, buckets=(2, 8)).translate_ids(SRC))
    assert small == big == split


def test_stream_ids_override_corpus_position():
    _, _, model, dcfg, vocab = setup(sampling_temp=1.2)
    tr = port(model, dcfg, vocab)
    base = tr.translate_ids(SRC)
    moved = tr.translate_ids([SRC[2], SRC[0]], stream_ids=[2, 0])
    assert moved[0] == base[2] and moved[1] == base[0]
    with pytest.raises(ValueError, match="one entry per sentence"):
        tr.translate_ids(SRC, stream_ids=[1, 2])


def test_sampled_scores_match_force_decode():
    _, _, model, dcfg, vocab = setup(sampling_temp=1.5, max_length=16)
    out = top1(port(model, dcfg, vocab).translate_ids(SRC))
    rows = [i for i, (_, ids) in enumerate(out) if len(ids) < 16]
    assert rows, "no sampled hypothesis terminated; enlarge max_length"
    logp, _ = score_corpus(model, [SRC[i] for i in rows], [out[i][1] for i in rows], None,
                           buckets=[8], batch_size=4)
    for lp, i in zip(logp, rows):
        assert out[i][0] == pytest.approx(lp, abs=1e-3)


def test_sampling_min_length():
    _, _, model, dcfg, vocab = setup(sampling_temp=1.0, min_length=3)
    assert all(len(ids) >= 3 for _, ids in top1(port(model, dcfg, vocab).translate_ids(SRC)))


def test_latent_sample_deterministic_and_differs_from_mean():
    _, _, model, dcfg, vocab = setup("vmmt_c", beam_size=4)
    mean = top1(port(model, dcfg, vocab).translate_ids(SRC, FEATS))
    sdcfg = DecodeConfig(**{**dcfg.__dict__, "latent_from": "sample"})
    s1 = top1(port(model, sdcfg, vocab).translate_ids(SRC, FEATS))
    assert s1 == top1(port(model, sdcfg, vocab).translate_ids(SRC, FEATS))
    assert [s for s, _ in s1] != [s for s, _ in mean]
    s3 = top1(port(model, sdcfg, vocab).translate_ids(SRC, FEATS, seed=999))
    assert [s for s, _ in s3] != [s for s, _ in s1]


def test_latent_sample_batch_invariance():
    _, _, model, dcfg, vocab = setup("vmmt_c", beam_size=4, latent_from="sample")
    small = top1(port(model, dcfg, vocab).translate_ids(SRC, FEATS))
    big = top1(port(model, DecodeConfig(**{**dcfg.__dict__, "batch_size": 6}), vocab)
               .translate_ids(SRC, FEATS))
    assert small == big


def test_latent_sample_rejected_for_nmt():
    _, _, model, dcfg, vocab = setup("nmt", latent_from="sample")
    with pytest.raises(ValueError, match="no latent"):
        port(model, dcfg, vocab)


@pytest.mark.parametrize("dec,msg", [
    (dict(sampling_topk=5), "imply sampling"),
    (dict(sampling_topp=0.9), "imply sampling"),
    (dict(sampling_temp=1.0, beam_size=4), "beam_size must be 1"),
    (dict(sampling_temp=1.0, beam_size=4, n_best=2), "n_best must be 1"),
    (dict(sampling_temp=1.0, replace_unk=True), "replace_unk"),
    (dict(sampling_temp=1.0, dump_beam=True), "dump_beam"),
    (dict(sampling_temp=1.0, coverage_beta=0.2), "coverage_beta"),
    (dict(sampling_temp=1.0, block_ngram_repeat=2), "block_ngram_repeat"),
    (dict(sampling_temp=-1.0), "must be >= 0"),
    (dict(latent_from="posterior"), "latent_from"),
])
def test_invalid_sampling_configs_rejected(dec, msg):
    _, _, model, dcfg, vocab = setup("vmmt_c", **dec)
    with pytest.raises(ValueError, match=msg):
        port(model, dcfg, vocab)


def test_streams_are_splitmix_over_their_coordinates():
    """The bits are splitmix64's finalizer over (seed, stream, sub-stream,
    step, element), checked against Python integers; a row's draws depend
    only on its own coordinates; the noise has the right moments."""
    M = (1 << 64) - 1

    def mix(x):
        x &= M
        x ^= x >> 30
        x = (x * 0xBF58476D1CE4E5B9) & M
        x ^= x >> 27
        x = (x * 0x94D049BB133111EB) & M
        return x ^ (x >> 31)

    def fold(h, v):
        return mix(h + (v + 1) * 0x9E3779B97F4A7C15)

    seed, ids = 1234, [0, 7, 2**40 + 3]
    keys = streams.row_keys(seed, torch.tensor(ids))
    assert [k & M for k in keys.tolist()] == [fold(mix(seed), i) for i in ids]
    u = streams.uniforms(keys, 5)
    for r, i in enumerate(ids):
        for j in range(5):
            bits = fold(fold(mix(seed), i), j)
            assert u[r, j].item() == ((bits >> 41) + 0.5) * 2.0 ** -23
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    alone = streams.DecodeStreams(seed, torch.tensor([7]))
    many = streams.DecodeStreams(seed, torch.tensor(ids))
    assert torch.equal(alone.token_gumbel(3, 24)[0], many.token_gumbel(3, 24)[1])
    assert torch.equal(alone.latent_eps(0, 8)[0], many.latent_eps(0, 8)[1])
    assert not torch.equal(many.token_gumbel(3, 24), many.token_gumbel(4, 24))
    g = streams.DecodeStreams(5, torch.arange(4)).token_gumbel(0, 50000)
    assert abs(g.mean().item() - 0.5772) < 0.02 and abs(g.std().item() - 1.2825) < 0.02
    z = streams.DecodeStreams(5, torch.arange(4)).latent_eps(0, 50000)
    assert abs(z.mean().item()) < 0.02 and abs(z.std().item() - 1.0) < 0.02
