"""PyTorch port: checkpoint ensembles against the JAX package
(tests/test_ensemble.py, without the device mesh of ROADMAP item 5.8), on
converted parameters, f32, the CPU.

- ``_combine_logps`` in both modes (and against JAX's);
- a self-ensemble decodes as the single model, beam and greedy;
- a mixed-family ensemble (vmmt_c + nmt + vmmt_f, different widths) gives
  JAX's ensemble's tokens with scores within rtol = atol = 1e-5: beam,
  greedy, ``replace_unk`` (attention positions too), coverage, the search
  trace, ``logprob`` mode, and the kernel routes (pallas_step 1 and 2,
  their plain versions here);
- ``latent_from=sample`` with JAX's draws injected, member by member;
- the ensemble is the combination, not a member;
- refusals: the member count against the parameter trees, the image
  interface, an empty ``-model`` segment, the flags an ensemble refuses,
  tensor parallelism (JAX's refusal) and a mesh that is not one;
- the service over an ensemble answers as the offline ensemble does, and
  sizes request features to the vmmt_c member; the CLIs through
  checkpoints on disk."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variational_mmt_tpu.config import DecodeConfig as JaxDecodeConfig
from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.data.vocab import SPECIALS as JAX_SPECIALS
from variational_mmt_tpu.data.vocab import Vocab as JaxVocab
from variational_mmt_tpu.decode import translator as jax_translator
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.models.model import init_params as jax_init_params
from variational_mmt_torch.cli import serve as cli_serve
from variational_mmt_torch.cli import translate as cli_translate
from variational_mmt_torch.cli.loading import load_model_spec
from variational_mmt_torch.config import Config, DecodeConfig, ModelConfig, TrainConfig
from variational_mmt_torch.convert import params_from_jax
from variational_mmt_torch.data.vocab import SPECIALS, Vocab
from variational_mmt_torch.decode.translator import Translator, _combine_logps
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.parallel.mesh import Mesh
from variational_mmt_torch.serve import ServeConfig, TranslationService
from variational_mmt_torch.train import checkpoint as ck
from variational_mmt_torch.train.trainer import create_train_state

WORDS = [f"w{i}" for i in range(20)]
BASE = dict(src_vocab_size=24, tgt_vocab_size=24, emb_dim=16, hidden_dim=32, enc_layers=1,
            dec_layers=2, latent_dim=4, img_feat_dim=8, dropout=0.0, compute_dtype="float32",
            use_pallas=True)
MEMBERS = {  # model type, seed, overrides
    "c": ("vmmt_c", 1, {}),
    "n": ("nmt", 2, dict(hidden_dim=48, enc_layers=2)),
    "f": ("vmmt_f", 3, dict(z_cond="init+input")),
    "c2": ("vmmt_c", 4, {}),
}
SRC = [[5, 6, 7], [8, 9], [10, 11, 12, 13], [14, 15, 16, 17, 18, 19], [4], [20, 21, 5, 9]]
FEATS = np.random.default_rng(0).standard_normal((len(SRC), 8)).astype(np.float32)
TOL = dict(rtol=1e-5, atol=1e-5)
_TREES = {}


def member(key):
    """(JAX model, JAX tree, port model, port ModelConfig) of a member:
    JAX's initial parameters plus noise, so that zero biases are not."""
    model_type, seed, over = MEMBERS[key]
    kw = {**BASE, "model_type": model_type, **over}
    jmodel = jax_build_model(JaxModelConfig(**kw))
    if key not in _TREES:
        rng = np.random.default_rng(seed)
        _TREES[key] = jax.tree.map(
            lambda a: (np.asarray(a) + 0.3 * rng.standard_normal(np.shape(a))).astype(
                np.float32), jax.device_get(jax_init_params(jmodel, jax.random.PRNGKey(seed))))
    cfg = ModelConfig(**kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_TREES[key], cfg))
    return jmodel, _TREES[key], model, cfg


def vocabs():
    return Vocab(SPECIALS + WORDS), JaxVocab(JAX_SPECIALS + WORDS)


def both(keys, dec, jax_noise=False, src=SRC, feats=FEATS):
    """(port n-best, JAX n-best) of the ensemble ``keys`` under ``dec``."""
    parts = [member(k) for k in keys]
    vocab, jvocab = vocabs()
    dkw = {"max_length": 10, "batch_size": 4, **dec}
    want = jax_translator.Translator(
        [p[0] for p in parts], [p[1] for p in parts], jvocab, jvocab, JaxDecodeConfig(**dkw),
        buckets=[8]).translate_ids(src, feats)
    tr = Translator([p[2] for p in parts], vocab, vocab, DecodeConfig(**dkw), buckets=[8],
                    device="cpu")
    if jax_noise:
        tr.streams = JaxStreams
    return tr.translate_ids(src, feats), want


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [e[1] for e in g] == [e[1] for e in w]
        np.testing.assert_allclose([e[0] for e in g], [e[0] for e in w], **TOL)
        if len(w[0]) == 3:  # replace_unk: the attention positions
            assert [list(e[2]) for e in g] == [list(map(int, e[2])) for e in w]


class JaxStreams:
    """JAX's draws on JAX's keys (translator.py:134-141, :167-172): row key
    fold_in(PRNGKey(seed), stream id); member j's eps
    normal(fold_in(fold_in(row, 0), j)); step t's Gumbel noise
    gumbel(fold_in(fold_in(row, 1), t))."""

    def __init__(self, seed, stream_ids):
        base = jax.random.PRNGKey(seed)
        ids = jnp.asarray(stream_ids.cpu().numpy(), jnp.int32)
        self.rows = jax.vmap(lambda i: jax.random.fold_in(base, i))(ids)

    def latent_eps(self, member, n):
        keys = jax.vmap(lambda k: jax.random.fold_in(jax.random.fold_in(k, 0), member))(
            self.rows)
        return torch.tensor(np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (n,), jnp.float32))(keys)))

    def token_gumbel(self, t, n):
        keys = jax.vmap(lambda k: jax.random.fold_in(jax.random.fold_in(k, 1), t))(self.rows)
        return torch.tensor(np.asarray(jax.vmap(
            lambda k: jax.random.gumbel(k, (n,), jnp.float32))(keys)))


def test_combine_logps_math_and_jax():
    rng = np.random.default_rng(1)
    a = np.log(rng.dirichlet(np.ones(11), size=3)).astype(np.float32)
    b = np.log(rng.dirichlet(np.ones(11), size=3)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    prob = _combine_logps([ta, tb], "prob")
    np.testing.assert_allclose(np.exp(prob.numpy()), (np.exp(a) + np.exp(b)) / 2.0,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_combine_logps([ta, tb], "logprob").numpy(), (a + b) / 2.0,
                               rtol=1e-6)
    for mode in ("prob", "logprob"):
        assert torch.equal(_combine_logps([ta], mode), ta)  # one member: the identity
        want = jax_translator._combine_logps([jnp.asarray(a), jnp.asarray(b), jnp.asarray(a)],
                                             mode)
        np.testing.assert_allclose(_combine_logps([ta, tb, ta], mode).numpy(),
                                   np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="ensemble_mode"):
        _combine_logps([ta, tb], "mean")


@pytest.mark.parametrize("mode", ["prob", "logprob"])
@pytest.mark.parametrize("beam", [4, 1])
def test_self_ensemble_matches_single(mode, beam):
    """[m, m, m] decodes as m: both rules are the identity on identical
    distributions (prob up to an ulp: logsumexp(x, x, x) - log 3)."""
    _, _, model, _ = member("c")
    vocab, _ = vocabs()
    dcfg = DecodeConfig(beam_size=beam, n_best=beam, max_length=10, batch_size=4,
                        ensemble_mode=mode)
    single = Translator(model, vocab, vocab, dcfg, buckets=[8],
                        device="cpu").translate_ids(SRC, FEATS)
    trio = Translator([model] * 3, vocab, vocab, dcfg, buckets=[8],
                      device="cpu").translate_ids(SRC, FEATS)
    assert_same(trio, single)


MIXED = {
    "beam": dict(beam_size=4, n_best=4),
    "greedy": dict(beam_size=1),
    "replace_unk": dict(beam_size=3, n_best=2, replace_unk=True),
    "coverage_trace": dict(beam_size=3, coverage_beta=0.2, dump_beam=True),
    "logprob_blocking": dict(beam_size=4, n_best=2, ensemble_mode="logprob",
                             block_ngram_repeat=2),
    "pallas_step_1": dict(beam_size=4, pallas_step=1),
    "pallas_step_2": dict(beam_size=4, pallas_step=2),
}


@pytest.mark.parametrize("case", MIXED)
def test_mixed_family_ensemble_matches_jax(case):
    got, want = both(["c", "n", "f"], MIXED[case])
    assert_same(got, want)


@pytest.mark.parametrize("dec", [dict(latent_from="sample", beam_size=4, n_best=2),
                                 dict(sampling_temp=1.2, sampling_topk=6, beam_size=1)],
                         ids=["latent_sample", "sampling"])
def test_ensemble_draws_match_jax_with_its_noise(dec):
    """Member j draws its eps from ``latent_eps(j, ...)``; the nmt member
    has none; the token draws are the combined distribution's."""
    got, want = both(["c", "n", "f"], {"decode_seed": 11, **dec}, jax_noise=True)
    assert_same(got, want)


def test_ensemble_is_the_combination_not_a_member():
    src = [[4 + (i * 3 + j) % 19 for j in range(1 + i % 5)] for i in range(12)]
    feats = np.random.default_rng(5).standard_normal((12, 8)).astype(np.float32)
    vocab, _ = vocabs()
    dcfg = DecodeConfig(beam_size=4, max_length=12, batch_size=4)
    out = {}
    for name, keys in (("a", ["c"]), ("b", ["c2"]), ("e", ["c", "c2"])):
        models = [member(k)[2] for k in keys]
        out[name] = [nb[0][1] for nb in Translator(models, vocab, vocab, dcfg, buckets=[8],
                                                   device="cpu").translate_ids(src, feats)]
    assert out["a"] != out["b"]
    assert out["e"] != out["a"] and out["e"] != out["b"]


def test_member_count_mismatch_rejected():
    _, _, model, _ = member("c")
    vocab, _ = vocabs()
    state = model.state_dict()
    with pytest.raises(ValueError, match="param trees"):
        Translator([model, model], vocab, vocab, DecodeConfig(), params=[state],
                   device="cpu")
    with pytest.raises(ValueError, match="single tree"):
        Translator([model, model], vocab, vocab, DecodeConfig(), params=state, device="cpu")
    with pytest.raises(KeyError, match="parameter names"):
        Translator(model, vocab, vocab, DecodeConfig(), params={"x": torch.ones(2)},
                   device="cpu")
    # matching trees: member j decodes with params[j], not its own weights
    _, _, other, _ = member("c2")
    vocab_out = Translator([model, model], vocab, vocab, DecodeConfig(max_length=8),
                           params=[other.state_dict()] * 2, buckets=[8],
                           device="cpu").translate_ids(SRC, FEATS)
    want = Translator(other, vocab, vocab, DecodeConfig(max_length=8), buckets=[8],
                      device="cpu").translate_ids(SRC, FEATS)
    assert_same(vocab_out, want)


def test_latent_sample_needs_some_latent_member_and_mesh_names_5_8():
    vocab, _ = vocabs()
    nmt = member("n")[2]
    with pytest.raises(ValueError, match="no latent"):
        Translator([nmt, nmt], vocab, vocab, DecodeConfig(latent_from="sample"), device="cpu")
    Translator([nmt, member("f")[2]], vocab, vocab, DecodeConfig(latent_from="sample"),
               device="cpu")
    # item 5.8 ported the mesh: an ensemble refuses tensor parallelism (JAX's
    # refusal), and a mesh must be one
    tp2 = Mesh(n_data=1, n_model=2, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not compose with tensor parallelism"):
        Translator([nmt, nmt], vocab, vocab, DecodeConfig(), mesh=tp2, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        Translator([nmt, nmt], vocab, vocab, DecodeConfig(), mesh=object(), device="cpu")


def save(tmp_path, key, img_dim=8, name=None):
    """Member ``key`` as a checkpoint of the port's writer (image width
    ``img_dim``); returns its run directory."""
    model_type, seed, over = MEMBERS[key]
    cfg = Config(model=ModelConfig(**{**BASE, "model_type": model_type, **over,
                                      "img_feat_dim": img_dim}), train=TrainConfig(seed=seed))
    model = build_model(cfg.model, device="cpu")
    if img_dim == 8:
        model.load_state_dict(member(key)[2].state_dict())
    run = str(tmp_path / (name or key))
    vocab, _ = vocabs()
    ck.save_checkpoint(run, create_train_state(cfg, model), cfg, vocab, vocab)
    return run


def test_model_spec_refusals(tmp_path):
    for spec in ("ckpts/a,", ",ckpts/a", "a,,b"):
        with pytest.raises(SystemExit, match="empty checkpoint path"):
            load_model_spec(spec, device="cpu")
    a, b = save(tmp_path, "c"), save(tmp_path, "c2", img_dim=16, name="wide")
    with pytest.raises(SystemExit, match="image-feature interface"):
        load_model_spec(f"{a},{b}", device="cpu")
    # a vmmt_f member on other features may join: it ignores the image at decode
    f_wide = save(tmp_path, "f", img_dim=16, name="f_wide")
    lm = load_model_spec(f"{a},{f_wide}", device="cpu")
    assert lm.ensemble and len(lm.translator_args()) == 2 and lm.steps == [0, 0]
    other = tmp_path / "other"
    cfg = Config(model=ModelConfig(**{**BASE, "model_type": "nmt"}))
    vocab = Vocab(SPECIALS + [f"x{i}" for i in range(20)])
    ck.save_checkpoint(str(other), create_train_state(cfg, build_model(cfg.model, "cpu")),
                       cfg, vocab, vocab)
    with pytest.raises(SystemExit, match="different vocab"):
        load_model_spec(f"{a},{other}", device="cpu")
    for main, extra in ((cli_translate.main, ["-src", "x"]), (cli_serve.main, ["-port", "0"])):
        with pytest.raises(SystemExit, match="image-feature interface"):
            main(["-model", f"{a},{b}", "-device", "cpu", *extra])


@pytest.mark.parametrize("flag", [["-verbose"], ["-iw_eval", "4"], ["-latent_diag"],
                                  ["-dump_attn", "x.npz"], ["-tensor_parallel", "2"]])
def test_translate_refuses_what_an_ensemble_cannot(flag):
    # -tensor_parallel is refused for an ensemble, as JAX refuses it
    match = ("does not compose with tensor parallelism" if flag[0] == "-tensor_parallel"
             else "not supported with an ensemble")
    with pytest.raises(SystemExit, match=match):
        cli_translate.main(["-model", "a,b", "-src", "x", "-device", "cpu", *flag])


def test_serve_ensemble_matches_offline():
    vocab, _ = vocabs()
    models = [member(k)[2] for k in ("c", "n", "f")]
    dcfg = DecodeConfig(beam_size=2, max_length=10, batch_size=4)
    svc = TranslationService(models, vocab, vocab, dcfg, buckets=[8], device="cpu",
                             scfg=ServeConfig(max_wait_ms=50.0, warmup=False))
    try:
        texts = ["w1 w2 w3", "w4 w5", "w6 w7 w8 w9"]
        online = svc.translate_text(texts, FEATS[:3])
    finally:
        svc.stop()
    offline = Translator(models, vocab, vocab, dcfg, buckets=[8], device="cpu"
                         ).translate_tokens([t.split() for t in texts], FEATS[:3])
    assert [nb[0][1] for nb in online] == [nb[0][1] for nb in offline]
    assert [nb[0][0] for nb in online] == [nb[0][0] for nb in offline]


def test_serve_mixed_family_uses_vmmt_c_feature_interface(tmp_path):
    """A vmmt_f member on wider features first, a vmmt_c member second:
    requests are sized to the vmmt_c member's image."""
    vocab, _ = vocabs()
    f_wide = ModelConfig(**{**BASE, "model_type": "vmmt_f", "img_feat_dim": 16})
    m_f = build_model(f_wide, device="cpu")
    m_f.load_state_dict({k: torch.randn(v.shape) * 0.1 for k, v in m_f.state_dict().items()})
    svc = TranslationService([m_f, member("c")[2]], vocab, vocab,
                             DecodeConfig(beam_size=2, max_length=8, batch_size=4),
                             buckets=[8], device="cpu",
                             scfg=ServeConfig(max_wait_ms=50.0, warmup=False))
    try:
        assert svc._feat_shape() == (8,)
        out = svc.translate_text(["w1 w2", "w3"], np.zeros((2, 8), np.float32))
        assert len(out) == 2 and all(math.isfinite(nb[0][0]) for nb in out)
    finally:
        svc.stop()
