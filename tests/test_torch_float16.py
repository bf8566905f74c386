"""PyTorch port: ``compute_dtype`` float16 against the JAX package's float16
on the CPU (Pallas kernels in interpret mode), at tiny widths.

- Rows 1-6: each kernel's plain version, given float16 tensors, against
  the Pallas kernel in interpret mode in float16: f32 outputs within 1e-5
  absolute and relative, float16 outputs within 1e-3 absolute and relative
  (one float16 step at 1).
- Training: the loss and every parameter gradient on the kernel route
  (``use_pallas``, ``pallas_decoder``, ``fused_ce``) and on the plain
  route, against ``jax.value_and_grad``: the loss within 1e-4 relative,
  each gradient within 1e-2 of its largest entry (float16 products summed
  in other orders; bf16's counterpart, tests/test_torch_fused_decoder.py,
  allows 5e-2).
- The ``Translator``, beam 4: at ``pallas_step`` 1 and 2 the n-best ids
  equal JAX's and the scores within 1e-4, as in f32; at ``pallas_step`` 0
  (the plain step, whose float16 products round in another order than
  JAX's) the top-1 ids equal JAX's, the scores agree rank by rank within
  1e-2 (bf16's counterpart allows 2e-2), and a lower rank may hold another
  hypothesis only where its score lies within 1e-2 of a neighbouring
  rank's, or at the last rank, whose rival is off the list.
- The entry point: ``cli.train -config`` with a float16 file trains in
  float16 and writes the config that JAX's train CLI writes from the same
  file and flags; JAX's translate CLI and the port's decode the port's
  checkpoint to the same top-1 lines, with the force-decoded scores of the
  top-1 and of the reference within 1e-2.
  ``-compute_dtype float16`` stays refused by both flag parsers.
- The kernels take exactly float32, bfloat16 and float16: every wrapper
  raises TypeError for float64 before any launch.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variational_mmt_tpu.cli import preprocess as jax_preprocess
from variational_mmt_tpu.cli import train as jax_train
from variational_mmt_tpu.cli import translate as jax_translate
from variational_mmt_tpu.config import DecodeConfig as JaxDecodeConfig
from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.config import TrainConfig as JaxTrainConfig
from variational_mmt_tpu.data import synthetic
from variational_mmt_tpu.data.vocab import SPECIALS as JAX_SPECIALS
from variational_mmt_tpu.data.vocab import Vocab as JaxVocab
from variational_mmt_tpu.decode.translator import Translator as JaxTranslator
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.models.model import generator_params as jax_generator_params
from variational_mmt_tpu.ops.pallas.decode_step import decode_step_pallas, gru_chain_pallas
from variational_mmt_tpu.ops.pallas.decoder import decoder_bwd_pallas, decoder_fwd_pallas
from variational_mmt_tpu.ops.pallas.gru import _gru_scan_bwd_impl
from variational_mmt_tpu.ops.pallas.gru import gru_layer_scan as jax_gru_layer_scan
from variational_mmt_tpu.train.loss import compute_loss as jax_compute_loss
from variational_mmt_torch import kernels
from variational_mmt_torch.cli import train as cli_train
from variational_mmt_torch.cli import translate as cli_translate
from variational_mmt_torch.config import Config, DecodeConfig, ModelConfig, TrainConfig
from variational_mmt_torch.convert import flatten, grads_to_jax, params_from_jax
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.data.vocab import SPECIALS, Vocab
from variational_mmt_torch.decode.translator import Translator
from variational_mmt_torch.models.model import DTYPES, build_model
from variational_mmt_torch.ops import decode_step as ds
from variational_mmt_torch.ops import decoder, gru_scan
from variational_mmt_torch.train import checkpoint as ck
from variational_mmt_torch.train.trainer import batch_tensors, loss_and_grads

import test_torch_decode_step as step_tests
import test_torch_decoder as decoder_tests
import test_torch_gru_scan_bwd as scan_tests
from test_torch_train import KERNEL_ROUTE, TINY, TRAIN, corpus, perturbed_jax_params

F16 = dict(TINY, compute_dtype="float16")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
F16_TOL = dict(rtol=1e-3, atol=1e-3)
LOSS_RTOL, GRAD_TOL = 1e-4, 1e-2
SCORE_TOL = 1e-2


def close(got, want):
    """A port output (torch) against a JAX output (float16 or f32)."""
    want = np.asarray(want)
    tol = F16_TOL if want.dtype == np.float16 else F32_TOL
    assert got.dtype == (torch.float16 if want.dtype == np.float16 else torch.float32)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), **tol)


def as16(arrays, keep_f32=()):
    """numpy arrays as (JAX, torch) pairs of lists, float16 but at
    ``keep_f32``."""
    j = [jnp.asarray(a, jnp.float32 if i in keep_f32 else jnp.float16)
         for i, a in enumerate(arrays)]
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.float32 if i in keep_f32 else torch.float16) for i, a in enumerate(arrays)]
    return j, t


# --- rows 1-6: the plain versions against the Pallas kernels in float16 ---

@pytest.mark.parametrize("reverse", [False, True])
def test_row_1_and_2_plain_scans_match_jax_kernels(reverse):
    (xp, m, h0, wh, bh), g, _ = scan_tests.scan_inputs()
    (jx, jm, jh0, jwh, jbh), (tx, tm, th0, twh, tbh) = as16((xp, m, h0, wh, bh), (1, 2, 4))
    want = jax_gru_layer_scan(jx, jm, jh0, jwh, jbh, reverse=reverse, interpret=True)
    got = gru_scan.gru_layer_scan_ref(tx, tm, th0, twh, tbh, reverse)
    for a, b in zip(got, want):
        close(a, b)
    outs = got[0].numpy()
    want = _gru_scan_bwd_impl(jx.swapaxes(0, 1), jm.swapaxes(0, 1)[:, None, :], jh0, jwh,
                              jbh.reshape(1, -1), jnp.asarray(outs).swapaxes(0, 1),
                              jnp.asarray(g).swapaxes(0, 1), reverse, True)
    got = gru_scan.gru_layer_scan_bwd_ref(tx, tm, th0, twh, tbh, torch.from_numpy(outs),
                                          torch.from_numpy(g), reverse)
    want = (np.asarray(want[0]).swapaxes(0, 1), want[1], want[2], np.asarray(want[3]).reshape(-1))
    for a, b in zip(got, want):
        close(a, b)


def test_row_3_and_4_plain_steps_match_jax_kernels():
    chain, attn = step_tests.step_inputs()
    keep = (6, 8, 10, 14)  # the biases and mask_bias stay f32
    j, t = as16(chain + attn, keep)
    for a, b in zip(ds.decode_step_ref(*t), decode_step_pallas(*j, interpret=True)):
        close(a, b)
    for a, b in zip(ds.gru_chain_ref(*t[:11]), gru_chain_pallas(*j[:11], interpret=True)):
        close(a, b)


def test_row_5_and_6_plain_decoder_matches_jax_kernels():
    args = decoder_tests.dec_inputs(seed=1, dropout=True)
    keep = (2, 3, 6, 8, 10, 14)  # h00, h01, the biases and mask_bias stay f32
    j, t = as16(args, keep)
    want = decoder_fwd_pallas(*j, interpret=True)
    got = decoder.decoder_fwd_ref(*t)
    for a, b in zip(got, want):
        close(a, b)
    rng = np.random.default_rng(2)
    (B, T, H), S = args[1].shape, args[14].shape[1]
    d_attn = rng.standard_normal((B, T, H)).astype(np.float32)
    d_probs = rng.standard_normal((B, T, S)).astype(np.float32)
    want = decoder_bwd_pallas(*j[:14], *want, jnp.asarray(d_attn), jnp.asarray(d_probs),
                              interpret=True)
    got = decoder.decoder_bwd_ref(*t[:14], *got, torch.from_numpy(d_attn),
                                  torch.from_numpy(d_probs))
    for a, b in zip(got, want):
        close(a, b)


# --- the model, its training loss and every gradient ---

def test_float16_model_builds_on_the_cpu():
    model = build_model(ModelConfig(**F16), device="cpu")
    assert model.dt == torch.float16 and DTYPES["float16"] == torch.float16
    assert all(p.dtype == torch.float32 for p in model.parameters())  # params stay f32


@pytest.mark.parametrize("route", ["kernels", "plain"])
def test_float16_loss_and_every_gradient_match_jax(route):
    over = KERNEL_ROUTE if route == "kernels" else {}
    jcfg = JaxModelConfig(**F16, **over)
    tree = perturbed_jax_params(jcfg)
    src, tgt, img = corpus()
    batch = next(BucketIterator(BinarizedDataset(src, tgt), 6, [10], img_feats=img).epoch())
    step = 7
    jmodel = jax_build_model(jcfg)

    def jax_loss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(batch.src), jnp.asarray(batch.tgt_in),
                           jnp.asarray(batch.img), deterministic=True, sample=False,
                           tgt_out=jnp.asarray(batch.tgt_out))
        gen = jax_generator_params(params, jcfg) if jcfg.fused_ce else None
        return jax_compute_loss(out, jnp.asarray(batch.tgt_out), jnp.asarray(batch.example_mask),
                                jnp.asarray(batch.img), jcfg, JaxTrainConfig(**TRAIN),
                                jnp.int32(step), generator_params=gen)[0]

    want_loss, want_grads = jax.value_and_grad(jax_loss)(tree)
    cfg = Config(model=ModelConfig(**F16, **over), train=TrainConfig(**TRAIN))
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg.model))
    loss, _, _ = loss_and_grads(cfg, model, batch_tensors(batch, torch.device("cpu")), step,
                                None, deterministic=True, sample=False)
    assert np.isfinite(float(want_loss))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    got = flatten(grads_to_jax(model))
    want = flatten(jax.device_get(want_grads))
    assert set(got) == set(want)
    for name in sorted(want):
        w = np.asarray(want[name], np.float32)
        assert np.isfinite(w).all() and np.isfinite(got[name]).all(), name
        err = float(np.abs(got[name] - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max()), (name, err)


# --- the Translator ---

SRC = [[5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15], [4, 20], [16, 17, 18, 19, 5],
       [7, 7, 9, 21, 4, 6], [12, 11, 10]]
WORDS = [f"w{i}" for i in range(20)]


def translators(pallas_step: int):
    over = dict(F16, use_pallas=True)
    jcfg = JaxModelConfig(**over)
    tree = perturbed_jax_params(jcfg)
    kw = dict(beam_size=4, n_best=4, max_length=10, batch_size=8, pallas_step=pallas_step)
    jvocab = JaxVocab(JAX_SPECIALS + WORDS)
    jtr = JaxTranslator(jax_build_model(jcfg), tree, jvocab, jvocab, JaxDecodeConfig(**kw),
                        buckets=[8])
    cfg = ModelConfig(**over)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    vocab = Vocab(SPECIALS + WORDS)
    return jtr, Translator(model, vocab, vocab, DecodeConfig(**kw), buckets=[8], device="cpu")


def near_tie(scores, k) -> bool:
    """Whether rank k of an n-best list may trade places with a rival: its
    score lies within SCORE_TOL of a neighbouring rank's, or it is the
    last rank."""
    return k == len(scores) - 1 or any(abs(scores[k] - scores[j]) <= SCORE_TOL
                                       for j in (k - 1, k + 1) if 0 <= j < len(scores))


@pytest.mark.parametrize("pallas_step", [0, 1, 2])
def test_float16_translator_matches_jax(pallas_step):
    jtr, tr = translators(pallas_step)
    img = np.random.default_rng(3).standard_normal((len(SRC), TINY["img_feat_dim"]))
    img = img.astype(np.float32)
    want, got = jtr.translate_ids(SRC, img), tr.translate_ids(SRC, img)
    assert len(got) == len(want) == len(SRC)
    for g, w in zip(got, want):
        gs, ws = [s for s, _ in g], [s for s, _ in w]
        assert len(g) == len(w) == 4 and all(np.isfinite(gs))
        if pallas_step:
            assert [i for _, i in g] == [i for _, i in w]
            np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-4)
            continue
        assert g[0][1] == w[0][1]
        np.testing.assert_allclose(gs, ws, atol=SCORE_TOL, rtol=0)
        for k in range(1, len(g)):
            if g[k][1] != w[k][1]:
                assert near_tie(gs, k) or near_tie(ws, k), (k, g, w)


# --- the entry point: -config with a float16 file ---

@pytest.fixture(scope="module")
def cli_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("f16_corpus")
    src, tgt, feats, _, _ = synthetic.make_corpus(80, vocab_size=40, img_dim=16, seed=9,
                                                  max_len=8)
    for name, lines in [("train.src", src[:60]), ("train.tgt", tgt[:60]),
                        ("valid.src", src[60:70]), ("valid.tgt", tgt[60:70]),
                        ("test.src", src[70:]), ("test.tgt", tgt[70:])]:
        with open(d / name, "w") as f:
            f.writelines(" ".join(line) + "\n" for line in lines)
    for name, rows in (("train", feats[:60]), ("valid", feats[60:70]), ("test", feats[70:])):
        np.save(d / f"{name}.feats.npy", rows)
    jax_preprocess.main(["-train_src", f"{d}/train.src", "-train_tgt", f"{d}/train.tgt",
                         "-valid_src", f"{d}/valid.src", "-valid_tgt", f"{d}/valid.tgt",
                         "-save_data", f"{d}/demo", "-bpe_merges", "30", "-pretokenized"])
    conf = {"model": {"model_type": "vmmt_c", "emb_dim": 16, "hidden_dim": 32,
                      "enc_layers": 1, "dec_layers": 2, "latent_dim": 4, "img_feat_dim": 16,
                      "compute_dtype": "float16", **KERNEL_ROUTE},
            "train": {"batch_size": 16, "max_steps": 4, "checkpoint_every": 4,
                      "valid_every": 4},
            "data": {"buckets": [16]}}
    with open(d / "f16.json", "w") as f:
        json.dump(conf, f)
    return str(d)


def train_argv(d, save):
    return ["-data", f"{d}/demo", "-config", f"{d}/f16.json", "-save_model", save,
            "-train_img_feats", f"{d}/train.feats.npy", "-valid_img_feats",
            f"{d}/valid.feats.npy"]


def translate_argv(d, model, out):
    return ["-model", model, "-src", f"{d}/test.src", "-tgt", f"{d}/test.tgt", "-img_feats",
            f"{d}/test.feats.npy", "-bpe_codes", f"{d}/demo.bpe.codes", "-pretokenized",
            "-output", out, "-beam_size", "3", "-n_best", "1", "-batch_size", "8",
            "-max_length", "12", "-verbose"]


def test_train_cli_config_file_reaches_float16_as_jax(cli_corpus, tmp_path, capsys):
    d = cli_corpus
    trainer = cli_train.main(train_argv(d, f"{tmp_path}/port") + ["-device", "cpu"])
    assert trainer.cfg.model.compute_dtype == "float16" and trainer.final_state.step == 4
    losses = [h["loss"] for h in trainer.last_run["metrics"]]
    assert len(losses) == 4 and np.isfinite(losses).all()
    jax_train.main(train_argv(d, f"{tmp_path}/jax"))
    port_cfg = ck.read_config(ck.latest_checkpoint(f"{tmp_path}/port"))
    jax_cfg = ck.read_config(ck.latest_checkpoint(f"{tmp_path}/jax"))
    assert port_cfg.to_dict() == jax_cfg.to_dict()
    assert port_cfg.model.compute_dtype == "float16" and port_cfg.model.use_pallas

    capsys.readouterr()
    cli_translate.main(translate_argv(d, f"{tmp_path}/port", f"{tmp_path}/port.txt")
                       + ["-device", "cpu"])
    port_out = capsys.readouterr().out
    jax_translate.main(translate_argv(d, f"{tmp_path}/port", f"{tmp_path}/jax.txt"))
    jax_out = capsys.readouterr().out
    with open(f"{tmp_path}/port.txt") as f, open(f"{tmp_path}/jax.txt") as g:
        mine, theirs = f.read().splitlines(), g.read().splitlines()
    assert len(mine) == len(theirs) == 10 and mine == theirs

    def scores(text, key):
        return [float(line.split()[-1].strip("()")) for line in text.splitlines()
                if line.startswith(key[0]) and key[1] in line]

    # the top-1 and the reference, force-decoded
    for key in (("PRED SCORE:", ""), ("GOLD ", "(score ")):
        assert len(scores(port_out, key)) == len(scores(jax_out, key)) == 10
        np.testing.assert_allclose(scores(port_out, key), scores(jax_out, key), atol=SCORE_TOL,
                                   rtol=0)


@pytest.mark.parametrize("parser", ["port", "jax"])
def test_compute_dtype_flag_still_refuses_float16(parser):
    """float16 is reached by ``-config`` only, in both packages."""
    import argparse

    p = argparse.ArgumentParser()
    (cli_train if parser == "port" else jax_train).add_args(p)
    with pytest.raises(SystemExit):
        p.parse_args(["-data", "x", "-save_model", "y", "-compute_dtype", "float16"])


# --- the dtypes the kernels take ---

def test_kernels_take_exactly_three_dtypes():
    assert kernels.DTYPE_CODE == {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    assert [dt for dt in kernels.DTYPE_CODE if kernels.mma_dtype(dt)] == [torch.bfloat16,
                                                                         torch.float16]


def test_every_wrapper_refuses_float64_before_any_launch(monkeypatch):
    """Meta tensors stand in for CUDA ones; a library that is asked for
    fails the test."""
    def library(name):
        raise AssertionError(f"library {name} loaded for a float64 call")

    monkeypatch.setattr(kernels, "library", library)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    f64 = torch.float64
    meta = lambda *s, dt=f64: torch.empty(*s, device="meta", dtype=dt)  # noqa: E731
    N, T, S, H = 4, 5, 3, 8
    f32 = torch.float32
    scan = (meta(N, T, 3 * H), meta(N, T, dt=f32), meta(N, H, dt=f32), meta(H, 3 * H),
            meta(3 * H, dt=f32))
    chain = (meta(N, 3 * H), meta(N, H), meta(N, H), meta(N, H), meta(H, 3 * H),
             meta(H, 3 * H), meta(3 * H, dt=f32), meta(H, 3 * H), meta(3 * H, dt=f32),
             meta(H, 3 * H), meta(3 * H, dt=f32))
    seq = (meta(N, T, 3 * H), meta(N, T, H), meta(N, H, dt=f32), meta(N, H, dt=f32)) \
        + chain[4:] + (meta(N, S, H), meta(N, S, H), meta(H, H))
    calls = {
        "gru_layer_scan": lambda: gru_scan.gru_layer_scan(*scan),
        "gru_layer_scan_bwd": lambda: gru_scan.gru_layer_scan_bwd(
            *scan, meta(N, T, H, dt=f32), meta(N, T, H, dt=f32)),
        "gru_chain": lambda: ds.gru_chain(*chain),
        "decode_step": lambda: ds.decode_step(*chain, meta(N, S, H), meta(N, S, H),
                                              meta(H, H), meta(N, S, dt=f32)),
        "decoder_fwd": lambda: decoder.decoder_fwd(*seq, meta(N, S, dt=f32)),
        "decoder_bwd": lambda: decoder.decoder_bwd(
            *seq, meta(N, T, H), meta(N, T, H), meta(N, T, H), meta(N, T, S),
            meta(N, T, H, dt=f32), meta(N, T, S, dt=f32)),
    }
    for name, call in calls.items():
        with pytest.raises(TypeError, match="float64"):
            call()
    for plan in (lambda: gru_scan.scan_fwd_plan(N, T, H, f64, 132),
                 lambda: gru_scan.scan_bwd_plan(N, T, H, f64),
                 lambda: ds.step_cell_plan(N, H, f64),
                 lambda: decoder.decoder_fwd_plan(N, S, H, f64, 132),
                 lambda: decoder.decoder_bwd_plan(N, S, H, f64, 132)):
        with pytest.raises(TypeError, match="float64"):
            plan()
