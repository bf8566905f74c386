"""PyTorch port: ``-infer_dtype bfloat16`` and ``int8`` against the JAX
package (tests/test_translator.py:328-425, without tensor parallelism).

- ``quantize_params_int8`` on a converted tree: codes and scales bit-equal
  to JAX's; ``dequantize_params`` bit-equal; the error bound; an exact
  round trip on grid weights;
- decoding at bfloat16 and at int8 (tiny vmmt_c, f32 compute, the scan
  kernels' route, beam 4, 32 sentences): top-1 equal to JAX's on at least
  31 of 32 sentences, and scores within 2e-2 absolute where they are equal
  (the two packages round the same weights the same way, but sum in other
  orders, and a bf16-rounded weight moves a near tie either way);
- what the translator holds: bfloat16 tensors, or int8 codes with f32
  scales and f32 1-D leaves (a quarter of f32's bytes for the leaves of two
  or more dimensions), and parameterless models; the caller's model is
  left as it was;
- the translate and serve CLIs read the checkpoints into host memory at
  bfloat16 and int8 (onto the decode device at float32), and an int8
  translate run holds int8 codes only, with ``-verbose`` still scoring in
  f32;
- an unknown dtype refused."""

import dataclasses

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
from variational_mmt_torch.cli import loading
from variational_mmt_torch.cli import serve as cli_serve
from variational_mmt_torch.cli import train as cli_train
from variational_mmt_torch.cli import translate as cli_translate
from variational_mmt_torch.config import Config, DecodeConfig, ModelConfig
from variational_mmt_torch.convert import flatten, params_from_jax
from variational_mmt_torch.data.vocab import SPECIALS, Vocab
from variational_mmt_torch.decode.translator import (Translator, cast_params_for_inference,
                                                     dequantize_params, quantize_params_int8)
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.train import checkpoint as ck
from variational_mmt_torch.train.trainer import create_train_state

TINY = dict(model_type="vmmt_c", src_vocab_size=24, tgt_vocab_size=24, emb_dim=16,
            hidden_dim=16, latent_dim=4, img_feat_dim=6, compute_dtype="float32",
            use_pallas=True, z_cond="init+input")
WORDS = [f"w{i}" for i in range(20)]
N_SENT = 32
SCORE_ATOL = 2e-2  # bf16-rounded weights, two summation orders
MIN_TOP1 = 31  # of 32


def jax_tree(kw, seed=0, noise=0.1):
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


def bits(x):
    """The raw bits of a tensor or array, for bit equality."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else bits(x.numpy())
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int8) if a.dtype == np.int8 else a.view(np.int32)


def test_int8_codes_and_scales_bit_equal_to_jax():
    kw = {**TINY, "share_decoder_embeddings": True}
    tree = jax_tree(kw, seed=3, noise=0.3)
    tree["tgt_embed"]["embedding"][:, 2] = 0.0  # an all-zero column: the scale floor
    want = flatten(jax.device_get(jax_translator.quantize_params_int8(tree)))
    got = quantize_params_int8(params_from_jax(tree, ModelConfig(**kw)))
    n_pairs = 0
    for name, v in got.items():
        if isinstance(v, dict):
            n_pairs += 1
            for part in ("int8", "scale"):
                w = want[f"{name}.{part}"]
                assert v[part].dtype == {"int8": torch.int8, "scale": torch.float32}[part]
                np.testing.assert_array_equal(bits(v[part].numpy()), bits(np.asarray(w)),
                                              err_msg=f"{name}.{part}")
        else:
            assert v.dim() == 1 and v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[name]))
    assert n_pairs == sum(1 for k in want if k.endswith(".int8")) > 10
    scale = got["tgt_embed.embedding"]["scale"]
    assert float(scale[2]) == np.finfo(np.float32).tiny
    # dequantized: one rounding of the f32 product to bf16, bit for bit
    want_deq = flatten(jax.device_get(jax_translator.dequantize_params(
        jax_translator.quantize_params_int8(tree))))
    got_deq = dequantize_params(got)
    for name, v in got_deq.items():
        assert v.dtype == (torch.bfloat16 if isinstance(got[name], dict) else torch.float32)
        np.testing.assert_array_equal(bits(v), bits(np.asarray(want_deq[name])), err_msg=name)


def test_int8_quant_dequant_error_bound():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 48)) * rng.lognormal(0, 1, 48)).astype(np.float32)
    q = quantize_params_int8({"w": torch.from_numpy(x), "b": torch.ones(48)})
    assert q["w"]["int8"].dtype == torch.int8 and tuple(q["w"]["scale"].shape) == (48,)
    assert q["b"].dtype == torch.float32  # 1-D leaves stay f32
    deq = dequantize_params(q)["w"].float().numpy()
    step = np.abs(x).max(axis=0) / 127.0
    assert (np.abs(deq - x) <= step * 1.05 + 1e-12).all()


def test_int8_grid_weights_roundtrip_exact():
    rng = np.random.default_rng(1)
    ints = rng.integers(-127, 128, (32, 16)).astype(np.float32)
    ints[0, :] = 127  # each column's max is attained: its scale is exact
    x = ints * (2.0 ** -6)
    deq = dequantize_params(quantize_params_int8({"w": torch.from_numpy(x)}))["w"]
    assert (deq.float().numpy() == x).all()


def test_cast_bfloat16_rounds_as_jax():
    tree = jax_tree(TINY, seed=4)
    want = flatten(jax.device_get(jax_translator.cast_params_for_inference(tree, "bfloat16")))
    got = cast_params_for_inference(params_from_jax(tree, ModelConfig(**TINY)), "bfloat16")
    for name, v in got.items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(bits(v), bits(np.asarray(want[name])), err_msg=name)
    assert cast_params_for_inference({"w": torch.ones(2, 2)}, "float32")["w"].dtype \
        == torch.float32


def sentences(n=N_SENT, seed=5):
    rng = np.random.default_rng(seed)
    src = [rng.integers(4, 24, rng.integers(2, 9)).tolist() for _ in range(n)]
    img = rng.standard_normal((n, TINY["img_feat_dim"])).astype(np.float32)
    return src, img


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_infer_dtype_decode_matches_jax(dtype):
    tree = jax_tree(TINY, seed=6, noise=0.3)
    src, img = sentences()
    dkw = dict(beam_size=4, max_length=10, batch_size=8, infer_dtype=dtype)
    jvocab = JaxVocab(JAX_SPECIALS + WORDS)
    want = jax_translator.Translator(jax_build_model(JaxModelConfig(**TINY)), tree, jvocab,
                                     jvocab, JaxDecodeConfig(**dkw), buckets=[8]
                                     ).translate_ids(src, img)
    vocab = Vocab(SPECIALS + WORDS)
    model = port_model(TINY, tree)
    tr = Translator(model, vocab, vocab, DecodeConfig(**dkw), buckets=[8], device="cpu")
    got = tr.translate_ids(src, img)
    same = [g[0][1] == w[0][1] for g, w in zip(got, want)]
    assert sum(same) >= MIN_TOP1, f"{sum(same)}/{N_SENT} top-1 equal"
    dscore = [abs(g[0][0] - w[0][0]) for g, w, s in zip(got, want, same) if s]
    assert max(dscore) <= SCORE_ATOL
    # f32 decodes differ from these somewhere: the dtype took effect
    f32 = Translator(model, vocab, vocab, DecodeConfig(**{**dkw, "infer_dtype": "float32"}),
                     buckets=[8], device="cpu").translate_ids(src, img)
    assert any(a[0][0] != b[0][0] for a, b in zip(f32, got))


def test_bf16_translator_holds_bf16_and_leaves_the_model_alone():
    tree = jax_tree(TINY, seed=7)
    model = port_model(TINY, tree)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    vocab = Vocab(SPECIALS + WORDS)
    tr = Translator(model, vocab, vocab, DecodeConfig(infer_dtype="bfloat16", max_length=6),
                    buckets=[8], device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in tr.weights[0].values())
    assert all(p.device.type == "meta" for p in tr.models[0].parameters())
    out = tr.translate_tokens([["w1", "w2"], ["w3"]], sentences(2)[1])
    assert all(np.isfinite(nbest[0][0]) and isinstance(nbest[0][1], str) for nbest in out)
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, before[k]), k


def test_infer_dtype_bf16_ensemble_members_cast():
    vocab = Vocab(SPECIALS + WORDS)
    models = [port_model(TINY, jax_tree(TINY, seed=s)) for s in (8, 9)]
    tr = Translator(models, vocab, vocab, DecodeConfig(infer_dtype="bfloat16", max_length=6),
                    buckets=[8], device="cpu")
    assert len(tr.weights) == 2
    for w in tr.weights:
        assert all(v.dtype == torch.bfloat16 for v in w.values())
    out = tr.translate_ids([[5, 6, 7]], np.zeros((1, 6), np.float32))
    assert len(out) == 1 and np.isfinite(out[0][0][0])


def test_int8_footprint_a_quarter_between_calls():
    tree = jax_tree(TINY, seed=10)
    model = port_model(TINY, tree)
    vocab = Vocab(SPECIALS + WORDS)
    tr = Translator(model, vocab, vocab, DecodeConfig(infer_dtype="int8", max_length=6),
                    buckets=[8], device="cpu")
    f32 = {k: v for k, v in model.state_dict().items()}
    held = tr.weights[0]
    assert set(held) == set(f32)
    wide_f32 = sum(v.numel() * 4 for v in f32.values() if v.dim() >= 2)
    codes = scales = ones = 0
    for k, v in held.items():
        if f32[k].dim() >= 2:
            assert set(v) == {"int8", "scale"} and v["int8"].dtype == torch.int8
            assert v["scale"].dtype == torch.float32
            assert tuple(v["scale"].shape) == (f32[k].shape[-1],)
            codes += v["int8"].numel()
            scales += v["scale"].numel() * 4
        else:
            assert v.dtype == torch.float32 and v.dim() == 1
            ones += v.numel() * 4
    assert codes * 4 == wide_f32  # a quarter of f32's bytes, before the scales
    assert tr.weight_bytes() == codes + scales + ones
    assert all(p.device.type == "meta" for p in tr.models[0].parameters())
    out = tr.translate_tokens([["w1", "w2"], ["w3"]], sentences(2)[1])
    assert all(np.isfinite(nbest[0][0]) for nbest in out)
    # still codes after a request: the bf16 weights lived for the call only
    assert all(isinstance(v, dict) for k, v in tr.weights[0].items() if f32[k].dim() >= 2)
    assert all(p.device.type == "meta" for p in tr.models[0].parameters())


def test_infer_dtype_invalid_rejected():
    model = port_model(TINY, jax_tree(TINY))
    vocab = Vocab(SPECIALS + WORDS)
    for bad in ("float16", "int4"):
        with pytest.raises(ValueError, match="infer_dtype"):
            Translator(model, vocab, vocab, dataclasses.replace(DecodeConfig(),
                                                                infer_dtype=bad),
                       buckets=[8], device="cpu")
    with pytest.raises(ValueError, match="infer_dtype"):
        cast_params_for_inference({"w": torch.ones(2, 2)}, "float16")


class _Loaded(Exception):
    """Stops a CLI once it has asked for its checkpoints."""


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("cli", ["translate", "serve"])
def test_clis_read_cast_checkpoints_into_host_memory(monkeypatch, cli, dtype):
    """At bfloat16 and int8 both CLIs read the checkpoints into host
    memory, so the card holds only the translator's cast weights; at
    float32 onto the card, where the translator uses them as they are. The
    CLI's device is a card here, and the run stops before anything lies
    on it."""
    card = torch.device("cuda")
    asked = []

    def spy(spec, use_ema=False, device=None):
        asked.append(torch.device(device))
        raise _Loaded

    monkeypatch.setattr(cli_train, "cli_device", lambda name: card)
    monkeypatch.setattr(cli_translate, "cli_device", lambda name: card)
    monkeypatch.setattr(loading, "load_model_spec", spy)
    monkeypatch.setattr(cli_translate, "load_model_spec", spy)
    main, extra = ((cli_translate.main, ["-src", "x"]) if cli == "translate"
                   else (cli_serve.main, ["-port", "0"]))
    with pytest.raises(_Loaded):
        main(["-model", "ckpt", "-infer_dtype", dtype, *extra])
    assert asked == [card if dtype == "float32" else torch.device("cpu")]


def test_int8_translate_run_holds_only_codes(monkeypatch, tmp_path, capsys):
    """An int8 run of the translate CLI: the translator holds int8 codes
    and f32 scales for every weight of two or more dimensions, its models
    have no parameters, and ``-verbose`` scores with the f32 model."""
    cfg = Config(model=ModelConfig(**TINY))
    model = port_model(TINY, jax_tree(TINY, seed=11))
    vocab = Vocab(SPECIALS + WORDS)
    run = str(tmp_path / "run")
    ck.save_checkpoint(run, create_train_state(cfg, model), cfg, vocab, vocab)
    src, img = sentences(4)
    with open(tmp_path / "src.txt", "w") as f:
        f.writelines(" ".join(vocab.itos[i] for i in s) + "\n" for s in src)
    np.save(tmp_path / "img.npy", img)
    built = []

    class Spy(Translator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(cli_translate, "Translator", Spy)
    cli_translate.main(["-model", run, "-src", str(tmp_path / "src.txt"), "-img_feats",
                        str(tmp_path / "img.npy"), "-pretokenized", "-output",
                        str(tmp_path / "out.txt"), "-infer_dtype", "int8", "-verbose",
                        "-max_length", "6", "-device", "cpu"])
    (tr,) = built
    shapes = {k: v.dim() for k, v in model.state_dict().items()}
    for k, v in tr.weights[0].items():
        if shapes[k] >= 2:
            assert set(v) == {"int8", "scale"} and v["int8"].dtype == torch.int8, k
        else:
            assert v.dtype == torch.float32, k
    assert all(p.device.type == "meta" for p in tr.models[0].parameters())
    assert capsys.readouterr().out.count("PRED SCORE") == len(src)
