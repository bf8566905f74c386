"""PyTorch port: decoding and parameter trees under each option of
ROADMAP.md item 5.5, against the JAX package on a tiny vmmt_c with
``z_cond='init+input'`` (JAX weights through ``convert.py`` plus noise),
f32 (the training step's parity is in tests/test_torch_options_model.py):

- beam-4 translation with n-best 4: ids identical to JAX's ``Translator``,
  scores within 1e-4 (tests/test_torch_translate.py); pallas_step 1 and 2
  decode these models with the plain step, as JAX's translator does, and
  the port's ``Translator.step_routes`` says so;
- the online service (``TranslationService``, conv features (R, D) a
  request) answers with JAX's n-best under each option;
- the parameter tree of each option, and of all of them at once,
  round-trips through ``convert.py`` with exactly JAX's key set and the
  option's shapes (LSTM's (H,4H) blocks and (2H+Z,H) bridge, the attention
  types' layers, no ``ih_feed`` without input feed, ``region_pool``).
"""

import functools

import numpy as np
import pytest

from variational_mmt_tpu.config import DecodeConfig as JaxDecodeConfig
from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.data.vocab import SPECIALS as JAX_SPECIALS
from variational_mmt_tpu.data.vocab import Vocab as JaxVocab
from variational_mmt_tpu.decode.translator import Translator as JaxTranslator
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_torch.config import DecodeConfig, ModelConfig
from variational_mmt_torch.convert import flatten, params_from_jax, params_to_jax
from variational_mmt_torch.data.vocab import SPECIALS, Vocab
from variational_mmt_torch.decode.translator import Translator
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.serve import ServeConfig, TranslationService
from test_torch_options_model import OPTIONS, REGIONS, TINY, images, jax_tree, port_model


@pytest.mark.parametrize("option", [*OPTIONS, "all"])
def test_parameter_tree_round_trips_with_jax_key_set(option):
    over = ({k: v for o in OPTIONS.values() for k, v in o.items()} if option == "all"
            else OPTIONS[option])
    kw = {**TINY, **over, "use_pallas": True}
    tree = jax_tree(kw, noise=0.0)
    flat = flatten(tree)
    H, Z, lstm = TINY["hidden_dim"], TINY["latent_dim"], over.get("rnn_type") == "lstm"
    G = 4 if lstm else 3
    assert flat["bridge0.kernel"].shape == ((2 * H if lstm else H) + Z, H)
    assert flat["decoder.step.hh_kernel1"].shape == (H, G * H)
    assert flat["z_input_proj.kernel"].shape == (Z, G * H)
    assert ("decoder.step.ih_feed.kernel" in flat) == over.get("input_feed", True)
    attn = {k.split(".")[3] for k in flat if k.startswith("decoder.step.attn.")}
    assert attn == {"general": {"linear_in", "linear_out"}, "dot": {"linear_out"},
                    "mlp": {"linear_query", "linear_context", "v", "linear_out"}}[
                        over.get("attn_type", "general")]
    assert any(k.startswith("region_pool.") for k in flat) == ("img_pool" in over)
    cfg = ModelConfig(**kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))  # strict: every key
    got = flatten(params_to_jax(model.state_dict()))
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


SRC = [[5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15], [4, 20], [16, 17, 18, 19, 5]]
WORDS = [f"w{i}" for i in range(20)]
DECODE = dict(beam_size=4, n_best=4, max_length=10, batch_size=4)


def port_translator(kw, tree, pallas_step):
    vocab = Vocab(SPECIALS + WORDS)
    return Translator(port_model(kw, tree), vocab, vocab,
                      DecodeConfig(**DECODE, pallas_step=pallas_step), buckets=[8], device="cpu")


@functools.lru_cache(maxsize=None)
def jax_nbest(option):
    kw = {**TINY, **OPTIONS[option]}
    tree = jax_tree(kw, seed=2)
    img = images(kw, len(SRC), np.random.default_rng(2))
    jvocab = JaxVocab(JAX_SPECIALS + WORDS)
    jtr = JaxTranslator(jax_build_model(JaxModelConfig(**kw)), tree, jvocab, jvocab,
                        JaxDecodeConfig(**DECODE), buckets=[8])
    return kw, tree, img, jtr.translate_ids(SRC, img)


def assert_nbest_equal(got, want):
    assert len(got) == len(want) == len(SRC)
    for g_nbest, w_nbest in zip(got, want):
        assert [ids for _, ids in g_nbest] == [ids for _, ids in w_nbest]
        np.testing.assert_allclose([s for s, _ in g_nbest], [s for s, _ in w_nbest],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("option", OPTIONS)
def test_translator_matches_jax(option):
    kw, tree, img, want = jax_nbest(option)
    tr = port_translator({**kw, "use_pallas": True}, tree, 0)
    assert tr.step_routes == ["plain"]
    assert_nbest_equal(tr.translate_ids(SRC, img), want)


@pytest.mark.parametrize("pallas_step", [1, 2])
@pytest.mark.parametrize("option", ["lstm", "mlp", "no_input_feed"])
def test_ineligible_models_decode_with_the_plain_step(option, pallas_step):
    """JAX's translator sends a decoder the step kernels do not compute to
    its plain step at any pallas_step; so does the port, and records it."""
    kw, tree, img, want = jax_nbest(option)
    tr = port_translator({**kw, "use_pallas": True}, tree, pallas_step)
    assert tr.step_routes == ["plain"]
    assert_nbest_equal(tr.translate_ids(SRC, img), want)


@pytest.mark.parametrize("option", OPTIONS)
def test_service_answers_as_jax_translates(option):
    """The online service decodes a model of each option (conv features as
    (R, D) a request, ``ServeConfig.conv_regions``) with JAX's n-best."""
    kw, tree, img, want = jax_nbest(option)
    vocab = Vocab(SPECIALS + WORDS)
    svc = TranslationService(port_model(kw, tree), vocab, vocab, DecodeConfig(**DECODE),
                             buckets=[8], device="cpu",
                             scfg=ServeConfig(max_wait_ms=20.0, warmup=False,
                                              conv_regions=REGIONS))
    try:
        got = [f.result(60) for f in svc.submit_ids_batch(SRC, img)]
    finally:
        svc.stop()
    assert_nbest_equal(got, want)
