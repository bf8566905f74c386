"""PyTorch port: the beam search's options against JAX's.

First the port's ``beam_search`` against JAX's on the same deterministic
step function (a fixed Markov LM with attention that depends on the token
and the step, as tests/test_beam.py builds its toy LMs): the coverage
penalty (golden value and preference), n-gram blocking (bigram cycle,
unigram, g longer than the output, exclusion tokens, a fuzz over g), the
search trace and the argmax positions of ``return_attn``. Tokens, trace
and positions must be identical; scores agree within 1e-5 (f32 sums of up
to ten log-probs).

Then the ``Translator`` end to end against JAX's ``Translator`` on
converted parameters, for each option (coverage, blocking with exclusions,
``replace_unk`` with a phrase table, ``dump_beam``) at pallas_step 0, 1 and
2 (on the CPU the kernels' plain versions; JAX's Pallas step runs in
interpret mode as its own tests run it): n-best ids identical, scores
within 1e-4, the replaced text and the dumped trees equal.
"""

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
from variational_mmt_torch.data.vocab import EOS, PAD, SPECIALS, UNK, Vocab
from variational_mmt_torch.decode.translator import Translator
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.ops import beam

S = 5


def toy(V=9, seed=0, attn="probs"):
    """(jax step, port step): log p(next | prev) from a fixed table; the
    attention probs depend on the previous token and the step (carry: the
    step count per row). ``attn``: "probs" (N, S), "argmax" (N,) or None."""
    rng = np.random.default_rng(seed)
    table = np.asarray(jax.nn.log_softmax(jnp.asarray(
        rng.standard_normal((V, V)).astype(np.float32)), axis=-1))
    att = rng.standard_normal((V, S)).astype(np.float32)

    def jstep(t, toks):
        probs = jax.nn.softmax(jnp.asarray(att)[toks] + 0.7 * t[:, None], axis=-1)
        out = (t + 1.0, jnp.asarray(table)[toks])
        if attn == "probs":
            return out + (probs,)
        if attn == "argmax":
            return out + ((toks * 3 + t.astype(jnp.int32)) % S,)
        return out

    tt, ta = torch.tensor(table), torch.tensor(att)

    def pstep(t, toks):
        probs = torch.softmax(ta[toks] + 0.7 * t[:, None], dim=-1)
        out = (t + 1.0, tt[toks])
        if attn == "probs":
            return out + (probs,)
        if attn == "argmax":
            return out + ((toks * 3 + t.long()) % S,)
        return out

    return jstep, pstep


def cycle(V=9, a=4, b=5, bonus=10.0):
    """An LM that loves the cycle a -> b -> a (tests/test_beam.py cycle_lm),
    with small distinct logits elsewhere: top-k's order among exactly equal
    scores is the library's (lax.top_k takes the lower index, torch.topk
    does not promise one), and the comparison is about blocking."""
    logits = 0.1 * np.random.default_rng(0).standard_normal((V, V)).astype(np.float32)
    logits[2, a] = logits[a, b] = logits[b, a] = bonus
    table = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    return (lambda t, toks: (t + 1.0, jnp.asarray(table)[toks]),
            lambda t, toks: (t + 1.0, torch.tensor(table)[toks]))


def both(steps, B, K, L, src_mask=None, **kw):
    """Run JAX's and the port's beam_search on the same toy; returns both
    output tuples as numpy (the trace as a dict of numpy)."""
    jstep, pstep = steps
    jm = None if src_mask is None else jnp.asarray(src_mask)
    tm = None if src_mask is None else torch.from_numpy(src_mask)
    jout = jax_beam.beam_search(jstep, jnp.zeros((B,), jnp.float32), B, K, L, src_mask=jm, **kw)
    pout = beam.beam_search(pstep, torch.zeros(B), B, K, L, src_mask=tm, **kw)
    conv = lambda x: {k: np.asarray(v) for k, v in x.items()} if isinstance(x, dict) \
        else np.asarray(x)  # noqa: E731
    return [conv(x) for x in jout], [conv(x) for x in pout]


def assert_same(jout, pout):
    """Scores within 1e-5; hypotheses identical rank by rank, except that
    hypotheses with equal scores (a cycle's rotations sum the same
    log-probs) may come in either order."""
    np.testing.assert_allclose(pout[1], jout[1], rtol=1e-5, atol=1e-5)
    for b in range(pout[0].shape[0]):
        sc = pout[1][b]
        for k in range(len(sc)):
            tied = np.abs(sc - sc[k]) <= 1e-5
            if tied.sum() == 1:
                np.testing.assert_array_equal(pout[0][b, k], jout[0][b, k])
            else:
                assert sorted(map(tuple, pout[0][b, tied].tolist())) == \
                    sorted(map(tuple, jout[0][b, tied].tolist()))


def emitted(row):
    out = []
    for t in np.asarray(row).tolist():
        if t == PAD:
            continue
        out.append(t)
        if t == EOS:
            break
    return out


def has_repeat(seq, g):
    grams = [tuple(seq[i:i + g]) for i in range(len(seq) - g + 1)]
    return len(grams) != len(set(grams))


@pytest.mark.parametrize("beta", [0.3, -0.2])
def test_coverage_matches_jax(beta):
    mask = np.ones((3, S), np.float32)
    mask[1, 3:] = 0.0  # a shorter source: its padding never counts
    jout, pout = both(toy(seed=1), 3, 4, 8, src_mask=mask, coverage_beta=beta)
    assert_same(jout, pout)


def test_coverage_golden_and_preference():
    """K=1 with uniform attention: the score adds beta * S * log(min(n/S, 1))
    (tests/test_beam.py:235); and of two equal continuations the one whose
    attention covers the source wins (:262)."""
    V = 7
    table = torch.log_softmax(torch.randn(V, V, generator=torch.Generator().manual_seed(0)), -1)

    def uniform(t, toks):
        return t + 1, table[toks], torch.full((toks.shape[0], S), 1.0 / S)

    t0, s0 = beam.beam_search(lambda c, k: uniform(c, k)[:2], torch.zeros(1), 1, 1, 6)
    t1, s1 = beam.beam_search(uniform, torch.zeros(1), 1, 1, 6, coverage_beta=0.3,
                              src_mask=torch.ones(1, S))
    assert torch.equal(t0, t1)
    n = len([x for x in t0[0, 0].tolist() if x != PAD])
    np.testing.assert_allclose(float(s1[0, 0]), float(s0[0, 0]) + 0.3 * S * np.log(min(n / S, 1)),
                               rtol=1e-5)

    base = torch.full((6,), -1e9)
    base[4] = base[5] = float(np.log(0.5))

    def prefer(t, toks):
        late = (t >= 2)[:, None]
        eos = torch.arange(6) == EOS
        logp = torch.where(late & eos, 0.0, torch.where(late, -1e9, base))
        probs = torch.where((toks == 4)[:, None], torch.nn.functional.one_hot(
            torch.zeros_like(toks), S).float(), torch.full((toks.shape[0], S), 1.0 / S))
        return t + 1, logp, probs

    tokens, _ = beam.beam_search(prefer, torch.zeros(4, dtype=torch.long), 4, 4, 4,
                                 coverage_beta=0.5, src_mask=torch.ones(4, S))
    assert torch.equal(tokens[:, 0, :2], torch.full((4, 2), 5))


def test_coverage_freezes_on_finished_beams():
    """A finished beam's PAD steps attend nowhere: its coverage, so its
    score, stays what it was when it emitted EOS (JAX :268)."""
    jout, pout = both(toy(V=6, seed=3), 2, 3, 12, src_mask=np.ones((2, S), np.float32),
                      coverage_beta=0.4)
    assert_same(jout, pout)
    assert (pout[0] == EOS).any()


def test_block_bigram_breaks_cycle():
    jout, pout = both(cycle(), 1, 4, 8, block_ngram_repeat=2)
    assert_same(jout, pout)
    plain = beam.beam_search(cycle()[1], torch.zeros(1), 1, 4, 8)[0]
    assert has_repeat(emitted(plain[0, 0]), 2)
    assert all(not has_repeat(emitted(pout[0][0, k]), 2) for k in range(4))


def test_block_unigram_all_distinct():
    jout, pout = both(cycle(a=4, b=4), 1, 3, 6, block_ngram_repeat=1)
    assert_same(jout, pout)
    assert all(len(set(emitted(pout[0][0, k]))) == len(emitted(pout[0][0, k]))
               for k in range(3))


def test_block_ngram_longer_than_output_is_identity():
    steps = toy(seed=5, attn=None)
    jout, pout = both(steps, 2, 4, 6, block_ngram_repeat=9)
    _, plain = both(steps, 2, 4, 6)
    assert_same(jout, pout)
    np.testing.assert_array_equal(pout[0], plain[0])


def test_block_exclusion_tokens_exempt_the_cycle():
    jout, pout = both(cycle(), 1, 4, 8, block_ngram_repeat=2, exclusion_tokens=(4,))
    assert_same(jout, pout)
    _, plain = both(cycle(), 1, 4, 8)
    assert_same(plain, pout)


@pytest.mark.parametrize("g", [1, 2, 3])
def test_block_ngram_fuzz_matches_jax(g):
    for seed in range(3):
        jout, pout = both(toy(V=12, seed=seed, attn=None), 2, 4, 7, block_ngram_repeat=g,
                          exclusion_tokens=(5,) if seed == 2 else ())
        assert_same(jout, pout)
        for b in range(2):
            for k in range(4):
                seq = emitted(pout[0][b, k])
                if seed != 2:
                    assert not has_repeat(seq, g), (seed, b, k, seq)


def test_trace_matches_jax_and_reconstructs_hypotheses():
    B, K, L = 3, 4, 9
    jout, pout = both(toy(V=12, seed=11, attn=None), B, K, L, alpha=0.0, return_trace=True)
    assert_same(jout, pout)
    jt, pt = jout[2], pout[2]
    n = int(pt["n_steps"])
    assert n == int(jt["n_steps"])
    for key in ("parents", "tokens"):
        np.testing.assert_array_equal(pt[key], jt[key][:, :, :n])
    np.testing.assert_allclose(pt["scores"], jt["scores"][:, :, :n], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pt["order"], jt["order"])
    for b in range(B):
        for rank in range(K):
            s, rebuilt = pt["order"][b, rank], []
            for t in range(n - 1, -1, -1):
                rebuilt.append(pt["tokens"][b, s, t])
                s = pt["parents"][b, s, t]
            rebuilt = rebuilt[::-1] + [PAD] * (L - n)
            np.testing.assert_array_equal(rebuilt, pout[0][b, rank])
            np.testing.assert_allclose(pt["scores"][b, pt["order"][b, rank], n - 1],
                                       pout[1][b, rank], rtol=1e-5)


@pytest.mark.parametrize("attn", ["probs", "argmax"])
def test_return_attn_positions_match_jax(attn):
    jout, pout = both(toy(seed=4, attn=attn), 2, 3, 6, return_attn=True)
    assert_same(jout, pout)
    np.testing.assert_array_equal(pout[2], jout[2])


def test_return_attn_and_coverage_require_attention():
    _, pstep = toy(attn=None)
    with pytest.raises(ValueError, match="third output"):
        beam.beam_search(pstep, torch.zeros(1), 1, 2, 6, return_attn=True)
    with pytest.raises(ValueError, match="third output"):
        beam.beam_search(pstep, torch.zeros(1), 1, 2, 6, coverage_beta=0.2,
                         src_mask=torch.ones(1, S))
    with pytest.raises(ValueError, match="src_mask"):
        beam.beam_search(pstep, torch.zeros(1), 1, 2, 6, coverage_beta=0.2)


# -- the Translator end to end ------------------------------------------

TINY = dict(model_type="vmmt_c", src_vocab_size=24, tgt_vocab_size=24, emb_dim=16,
            hidden_dim=16, latent_dim=4, img_feat_dim=6, compute_dtype="float32",
            use_pallas=True)
SRC = [[5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15], [4, 20], [16, 17, 18, 19, 5],
       [6, 6, 7, 7]]
WORDS = [f"w{i}" for i in range(20)]
OPTIONS = {
    "coverage": dict(coverage_beta=0.3),
    "blocking": dict(block_ngram_repeat=2, ignore_when_blocking="w3 w5 absent"),
    "replace_unk": dict(replace_unk=True),
    "dump_beam": dict(dump_beam=True, n_best=2),
}
_JAX = {}


def setup():
    """JAX's parameters (init + noise, the generator biased toward UNK so
    replace_unk has work) and the port's model on them."""
    jmodel = jax_build_model(JaxModelConfig(**TINY))
    rng = np.random.default_rng(3)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))).astype(np.float32),
        jax.device_get(jax_init_params(jmodel, jax.random.PRNGKey(3))))
    tree["generator"]["bias"][UNK] += 2.0
    cfg = ModelConfig(**TINY)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    img = rng.standard_normal((len(SRC), TINY["img_feat_dim"])).astype(np.float32)
    return jmodel, tree, model, img


def jax_run(option, mode, jmodel, tree, img):
    """JAX's n-best, texts and traces for one option and step mode (cached:
    each is a compile)."""
    if (option, mode) not in _JAX:
        kw = {"beam_size": 3, "n_best": 1, "max_length": 10, "batch_size": 4,
              "pallas_step": mode, **OPTIONS[option]}
        jv = JaxVocab(JAX_SPECIALS + WORDS)
        jtr = JaxTranslator(jmodel, tree, jv, jv, JaxDecodeConfig(**kw), buckets=[8])
        jtr.phrase_table = {"w6": "six"}
        ids = jtr.translate_ids(SRC, img)
        texts = [jtr.nbest_to_text(nb, [f"w{i - 4}" for i in s]) for nb, s in zip(ids, SRC)]
        _JAX[option, mode] = (kw, ids, texts, dict(jtr.beam_traces))
    return _JAX[option, mode]


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_translator_option_matches_jax(option, mode):
    jmodel, tree, model, img = setup()
    kw, want, want_text, want_traces = jax_run(option, mode, jmodel, tree, img)
    vocab = Vocab(SPECIALS + WORDS)
    tr = Translator(model, vocab, vocab, DecodeConfig(**kw), buckets=[8], device="cpu")
    tr.phrase_table = {"w6": "six"}
    got = tr.translate_ids(SRC, img)
    for g_nb, w_nb in zip(got, want):
        assert [e[1] for e in g_nb] == [e[1] for e in w_nb]
        np.testing.assert_allclose([e[0] for e in g_nb], [e[0] for e in w_nb], rtol=1e-4,
                                   atol=1e-4)
        assert [e[2:] for e in g_nb] == [e[2:] for e in w_nb]  # replace_unk's positions
    texts = [tr.nbest_to_text(nb, [f"w{i - 4}" for i in s]) for nb, s in zip(got, SRC)]
    assert [[t for _, t in nb] for nb in texts] == [[t for _, t in nb] for nb in want_text]
    if option == "replace_unk":
        assert any(UNK in e[1] for nb in got for e in nb), "fixture must emit <unk>"
        assert "<unk>" not in " ".join(t for nb in texts for _, t in nb)
    if option == "dump_beam":
        assert sorted(tr.beam_traces) == sorted(want_traces) == list(range(len(SRC)))
        for i, w in want_traces.items():
            g = tr.beam_traces[i]
            assert (g["parents"], g["tokens"], g["order"]) == \
                (w["parents"], w["tokens"], w["order"])
            np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-4, atol=1e-4)


def test_option_checks_take_jax_messages():
    _, _, model, _ = setup()
    vocab = Vocab(SPECIALS + WORDS)
    for kw, msg in ((dict(block_ngram_repeat=-1), "must be >= 0"),
                    (dict(ignore_when_blocking="w1"), "requires -block_ngram_repeat"),
                    (dict(n_best=5, beam_size=4), "cannot exceed")):
        with pytest.raises(ValueError, match=msg):
            Translator(model, vocab, vocab, DecodeConfig(**kw), device="cpu")
    tr = Translator(model, vocab, vocab, DecodeConfig(block_ngram_repeat=2,
                                                      ignore_when_blocking="w3 absent w1"),
                    device="cpu")
    assert tr._exclusion_ids == tuple(sorted({UNK, vocab.stoi["w3"], vocab.stoi["w1"]}))
