"""PyTorch port: the quality gate's pieces and the repairs that came with
the model families.

- The port's copies of the synthetic corpora (data/synthetic.py) and of
  BLEU (evals/bleu.py) give the JAX package's output exactly.
- The gate's runner (tools/quality_gate.py) completes a tiny run of each
  family on the CPU's plain route and appends well-formed JSON lines; its
  decode-time defects act as documented and are undone; it refuses the
  options that are not ported.
- ``fused_step_eligible`` is JAX's fused-step gate, and
  ``project_memory(with_values=True)`` raises where it is false.
- ``init_params`` draws flax's truncated lecun-normal.
"""

import json

import numpy as np
import pytest
import torch

from variational_mmt_tpu.data import synthetic as jax_synthetic
from variational_mmt_tpu.data.vocab import SPECIALS as JAX_SPECIALS
from variational_mmt_tpu.data.vocab import Vocab as JaxVocab
from variational_mmt_tpu.evals import bleu as jax_bleu
from variational_mmt_torch.config import ModelConfig
from variational_mmt_torch.convert import flatten
from variational_mmt_torch.data import synthetic
from variational_mmt_torch.data.vocab import SPECIALS, Vocab
from variational_mmt_torch.evals import bleu
from variational_mmt_torch.models import attention
from variational_mmt_torch.models import model as model_mod
from variational_mmt_torch.models.decoder import fused_step_eligible
from variational_mmt_torch.models.model import build_model, init_params
from variational_mmt_torch.tools import quality_gate


def assert_same_corpus(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, JaxVocab):
            assert g.itos == w.itos
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("seed,regions", [(0, 0), (7, 0), (0, 3)],
                         ids=["seed0", "seed7", "regions"])
def test_ambiguous_corpus_equals_jax(seed, regions):
    kw = dict(vocab_size=60, img_dim=16, seed=seed, regions=regions)
    assert_same_corpus(synthetic.make_ambiguous_corpus(40, **kw),
                       jax_synthetic.make_ambiguous_corpus(40, **kw))


@pytest.mark.parametrize("seed", [0, 7])
def test_plain_corpus_and_label_noise_equal_jax(seed):
    kw = dict(vocab_size=60, img_dim=16, seed=seed)
    got, want = synthetic.make_corpus(30, **kw), jax_synthetic.make_corpus(30, **kw)
    assert_same_corpus(got, want)
    n = synthetic.corrupt_targets(got[1], 0.3, 60, seed=seed + 1)
    assert n == jax_synthetic.corrupt_targets(want[1], 0.3, 60, seed=seed + 1) > 0
    assert got[1] == want[1]


@pytest.mark.parametrize("seed", [0, 7])
def test_oracle_bounds_and_ideal_hypotheses_equal_jax(seed):
    src, tgt, _, _, _, senses, amb = synthetic.make_ambiguous_corpus(
        80, vocab_size=60, img_dim=16, seed=seed)
    assert synthetic.ideal_hypotheses(src, senses, amb, 60) == \
        jax_synthetic.ideal_hypotheses(src, senses, amb, 60)
    got = synthetic.oracle_bleu_bounds(src, tgt, senses, amb, 60)
    assert got == jax_synthetic.oracle_bleu_bounds(src, tgt, senses, amb, 60)
    assert got[0] > got[1] > 0


@pytest.mark.parametrize("seed", [0, 7])
def test_bleu_equals_jax(seed):
    rng = np.random.default_rng(seed)
    words = [f"t{i}" for i in range(12)]
    line = lambda: [words[i] for i in rng.integers(0, 12, rng.integers(1, 15))]  # noqa: E731
    hyps = [line() for _ in range(30)]
    refs = [[line(), line()] for _ in range(30)]
    assert bleu.corpus_bleu(hyps, refs) == jax_bleu.corpus_bleu(hyps, refs)
    for h, r in zip(hyps, refs):
        assert bleu.sentence_bleu(h, r[0]) == jax_bleu.sentence_bleu(h, r[0])


def test_vocab_decode_equals_jax():
    words = ["a", "b", "c"]
    ids = [2, 4, 0, 5, 99, 6, 3, 4]
    assert Vocab(SPECIALS + words).decode(ids) == JaxVocab(JAX_SPECIALS + words).decode(ids)
    assert Vocab(SPECIALS + words).decode(ids, strip_special=False) == \
        JaxVocab(JAX_SPECIALS + words).decode(ids, strip_special=False)


TINY_GATE = ["-steps", "3", "-n_train", "64", "-n_test", "16", "-n_valid", "16", "-device",
             "cpu", "-seeds", "11", "-vocab_size", "40", "-emb_dim", "16",
             "-hidden_dim", "16", "-latent_dim", "4", "-img_dim", "8"]


@pytest.mark.parametrize("family", ["nmt", "vmmt_f", "vmmt_c"])
def test_gate_runner_completes_on_the_cpu(family, tmp_path):
    out = tmp_path / "gate.jsonl"
    res = quality_gate.main(TINY_GATE + ["-models", family, "-out", str(out)])
    lines = [json.loads(s) for s in out.read_text().splitlines()]
    assert lines == res and len(lines) == 1
    r = lines[0]
    assert (r["model"], r["seed"], r["steps"], r["route"], r["device"], r["card"]) == \
        (family, 11, 3, "plain", "cpu", "cpu")
    assert 0.0 <= r["test_bleu"] <= 100.0 and 0.0 <= r["valid_bleu"] <= 100.0
    assert r["oracle_bleu"] >= r["text_asymptote"]
    assert set(r["launches"]) == set(quality_gate.COUNTERS)


def test_gate_runner_packs_and_takes_defects(tmp_path):
    orig = model_mod.VMMTModel.prior_latent
    res = quality_gate.main(TINY_GATE + ["-models", "vmmt_c", "-pack", "1", "-defect", "z_zero",
                                         "-out", str(tmp_path / "gate.jsonl")])
    assert res[0]["pack"] == 1 and res[0]["defect"] == "z_zero"
    assert model_mod.VMMTModel.prior_latent is orig
    with quality_gate.z_zero_defect():
        model = build_model(ModelConfig(src_vocab_size=20, tgt_vocab_size=20, emb_dim=8,
                                        hidden_dim=8, latent_dim=4, img_feat_dim=6,
                                        model_type="vmmt_c", compute_dtype="float32"),
                            device="cpu")
        with torch.no_grad():
            for p in model.parameters():
                p.normal_()
            z = model.prior_latent(torch.randn(3, 8), torch.randn(3, 6))
    assert z.shape == (3, 4) and not z.any()
    assert model_mod.VMMTModel.prior_latent is orig


@pytest.mark.parametrize("ramp", [1, 0])
def test_gate_runner_decodes_the_ema_weights(ramp, tmp_path, monkeypatch):
    """-ema_decay (JAX's :193-204): the run keeps an EMA of the weights and
    also decodes the test split with it; the row records test_bleu_ema,
    ema_decay and ema_ramp. The EMA decode runs a copy of the model that
    holds the trainer's EMA tensors."""
    copies = []
    orig = quality_gate.ema_model

    def spy(trainer):
        model = orig(trainer)
        copies.append((model, trainer))
        return model

    monkeypatch.setattr(quality_gate, "ema_model", spy)
    res = quality_gate.main(TINY_GATE + ["-models", "vmmt_c", "-ema_decay", "0.9",
                                         "-ema_ramp", str(ramp),
                                         "-out", str(tmp_path / "gate.jsonl")])
    r = res[0]
    assert (r["ema_decay"], r["ema_ramp"]) == (0.9, bool(ramp))
    assert 0.0 <= r["test_bleu_ema"] <= 100.0
    (model, trainer), = copies
    assert model is not trainer.model
    for p, e, q in zip(model.parameters(), trainer.state.ema, trainer.model.parameters()):
        assert torch.equal(p, e)
    assert any(not torch.equal(e, q) for e, q in zip(trainer.state.ema,
                                                      trainer.model.parameters()))
    assert quality_gate.build_cfg("vmmt_c", 11, quality_gate.parse_args(
        ["-ema_decay", "0.9", "-ema_ramp", str(ramp)])).train.ema_ramp is bool(ramp)


@pytest.mark.parametrize("with_values", [False, True])
def test_attn_shift_rolls_the_keys_once_and_is_undone(with_values):
    cfg = ModelConfig(src_vocab_size=20, tgt_vocab_size=20, emb_dim=8, hidden_dim=8,
                      latent_dim=4, img_feat_dim=6, compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.normal_()
    memory = torch.randn(2, 5, 8)
    clean = model.project_memory(memory, with_values)
    orig = (model_mod.VMMTModel.project_memory, attention.GlobalAttention.forward)
    with quality_gate.attn_shift_defect():
        shifted = model.project_memory(memory, with_values)
        attn = model.decoder.step.attn
        q, mask = torch.randn(2, 8), torch.ones(2, 5)
        assert torch.equal(attn(q, memory, mask)[0],
                           orig[1](attn, q, memory, mask, torch.roll(attn.project_memory(memory),
                                                                    1, dims=1))[0])
    assert (model_mod.VMMTModel.project_memory, attention.GlobalAttention.forward) == orig
    if with_values:
        assert torch.equal(shifted[0], torch.roll(clean[0], 1, dims=1))
        assert torch.equal(shifted[1], clean[1])  # the values stay in place
    else:
        assert torch.equal(shifted, torch.roll(clean, 1, dims=1))


@pytest.mark.parametrize("argv, route, model", [
    ([], "kernels", dict(compute_dtype="bfloat16", use_pallas=True, pallas_decoder=True,
                         fused_ce=True)),
    (["-route", "scans"], "scans", dict(compute_dtype="bfloat16", use_pallas=True,
                                        pallas_decoder=False, fused_ce=True)),
    (["-route", "plain"], "plain", dict(compute_dtype="float32", use_pallas=False,
                                        pallas_decoder=False, fused_ce=False)),
    (["-device", "cpu"], "plain", dict(compute_dtype="float32", use_pallas=False,
                                       pallas_decoder=False, fused_ce=False)),
], ids=["cuda", "cuda_scans", "cuda_plain", "cpu"])
def test_gate_route_follows_the_device(argv, route, model):
    args = quality_gate.parse_args(argv)
    assert args.route == route
    m = quality_gate.build_cfg("vmmt_c", 11, args).model
    assert {k: getattr(m, k) for k in model} == model


@pytest.mark.parametrize("route", ["kernels", "scans"])
def test_gate_runner_refuses_kernel_routes_on_the_cpu(route, capsys):
    with pytest.raises(SystemExit):
        quality_gate.parse_args(["-device", "cpu", "-route", route])
    assert "-route" in capsys.readouterr().err


@pytest.mark.parametrize("pool", ["attn", "mean"])
def test_gate_runner_takes_region_features_with_either_pool(pool):
    """Once refused for attn: conv-style region features pooled by
    attention or by their mean, as JAX's gate runner takes them."""
    args = quality_gate.parse_args(["-device", "cpu", "-img_pool", pool, "-img_regions", "4"])
    m = quality_gate.build_cfg("vmmt_c", 11, args).model
    assert (m.img_feat_type, m.img_pool) == ("conv", pool)
    model = build_model(m, device="cpu")
    assert hasattr(model, "region_pool") == (pool == "attn")


GATE = dict(dec_layers=2, attn_type="general", rnn_type="gru", input_feed=True)


@pytest.mark.parametrize("over", [{}, dict(dec_layers=3), dict(dec_layers=1),
                                  dict(attn_type="dot"), dict(rnn_type="lstm"),
                                  dict(input_feed=False)],
                         ids=["eligible", "layers3", "layers1", "dot", "lstm", "no_input_feed"])
def test_fused_step_gate_matches_jax_and_project_memory_follows_it(over):
    cfg = ModelConfig(src_vocab_size=20, tgt_vocab_size=20, emb_dim=8, hidden_dim=8,
                      latent_dim=4, img_feat_dim=6, compute_dtype="float32", **{**GATE, **over})
    eligible = not over
    assert fused_step_eligible(cfg) == eligible
    model = build_model(cfg, device="cpu")  # every option builds
    with torch.no_grad():
        for p in model.parameters():
            p.normal_()
    memory = torch.randn(2, 5, 8)
    if eligible:
        keys, mem_v = model.project_memory(memory, with_values=True)
        assert keys.shape == mem_v.shape == memory.shape
    else:
        with pytest.raises(ValueError, match="2-layer GRU"):
            model.project_memory(memory, with_values=True)
        # the plain step's keys: memory @ Wq^T for general, the memory for dot
        keys = model.project_memory(memory)
        attn = model.decoder.step.attn
        want = memory if over.get("attn_type") == "dot" else memory @ attn.linear_in.kernel.t()
        torch.testing.assert_close(keys, want, rtol=0, atol=0)


def test_init_params_draw_truncated_lecun_normal():
    cfg = ModelConfig(model_type="vmmt_c", src_vocab_size=200, tgt_vocab_size=200,
                      emb_dim=256, hidden_dim=256, latent_dim=64, img_feat_dim=512,
                      z_cond="init+input")
    flat = flatten(init_params(cfg, seed=3))
    w = flat["bridge0.kernel"][:256]  # a 256 x 256 block of a (320, 256) kernel
    fan = flat["bridge0.kernel"].shape[0]
    assert np.abs(w).max() <= 2.0 / np.sqrt(fan) / model_mod.TRUNC_STD
    assert abs(w.var() * fan - 1.0) < 0.02
    hh = flat["decoder.step.hh_kernel0"]  # (256, 768), recurrent
    assert np.abs(hh).max() <= 2.0 / np.sqrt(256) / model_mod.TRUNC_STD
    assert abs(hh.var() * 256 - 1.0) < 0.02
    for name, a in flat.items():
        if a.ndim == 1:
            assert not a.any(), name  # biases zero
        elif not name.endswith("embedding"):
            assert np.abs(a).max() * np.sqrt(a.shape[0]) * model_mod.TRUNC_STD <= 2.0, name
    emb = flat["tgt_embed.embedding"]  # untruncated normal, std 1/sqrt(E)
    assert abs(emb.std() * np.sqrt(256) - 1.0) < 0.02
    assert np.abs(emb).max() * np.sqrt(256) > 3.0
