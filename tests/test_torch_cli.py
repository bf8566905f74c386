"""PyTorch port: the preprocess, train and translate CLIs on the CPU
(``-device cpu``).

The chain: JAX's preprocess CLI -> the port's train CLI (validation,
checkpoints, resume, ``-epochs``, ``-pack``) -> the port's translate CLI,
whose output file must equal JAX's translate CLI's on the same checkpoint
(f32: n-best ids identical, so the text is too); and the port's own chain,
its preprocess CLI from raw text -> its train CLI -> its translate CLI,
with no JAX CLI in it. Then the ``-config``
merge and the optimizers' lr defaults as JAX's tests/test_cli.py pins them
(:191, :274, :317, :444), the port's tokenizer and BPE against JAX's, the
refused flags and the device rule."""

import json
import os

import numpy as np
import pytest
import torch

from variational_mmt_tpu.cli import preprocess as jax_preprocess
from variational_mmt_tpu.cli import translate as jax_translate
from variational_mmt_tpu.config import Config as JaxConfig
from variational_mmt_tpu.data import synthetic
from variational_mmt_tpu.data.bpe import BPE as JaxBPE
from variational_mmt_tpu.data.dataset import BinarizedDataset as JaxBinarizedDataset
from variational_mmt_tpu.data.tokenizer import tokenize as jax_tokenize
from variational_mmt_tpu.train import checkpoint as jax_ck
from variational_mmt_torch.cli import preprocess as cli_preprocess
from variational_mmt_torch.cli import train as cli_train
from variational_mmt_torch.cli import translate as cli_translate
from variational_mmt_torch.config import Config
from variational_mmt_torch.data.bpe import BPE
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.data.features import load_features
from variational_mmt_torch.data.packing import PackedBucketIterator
from variational_mmt_torch.data.tokenizer import tokenize
from variational_mmt_torch.data.vocab import Vocab
from variational_mmt_torch.train import checkpoint as ck

SMALL = ["-word_vec_size", "16", "-rnn_size", "32", "-enc_layers", "1", "-dec_layers", "1",
         "-z_latent_dim", "4", "-buckets", "16", "-compute_dtype", "float32", "-device", "cpu"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    src, tgt, feats, _, _ = synthetic.make_corpus(80, vocab_size=40, img_dim=16, seed=9,
                                                  max_len=8)
    for name, lines in [("train.src", src[:60]), ("train.tgt", tgt[:60]),
                        ("valid.src", src[60:70]), ("valid.tgt", tgt[60:70]),
                        ("test.src", src[70:]), ("test.tgt", tgt[70:])]:
        with open(d / name, "w") as f:
            f.writelines(" ".join(line) + "\n" for line in lines)
    np.save(d / "train.feats.npy", feats[:60])
    np.save(d / "valid.feats.npy", feats[60:70])
    np.save(d / "test.feats.npy", feats[70:])
    jax_preprocess.main([
        "-train_src", f"{d}/train.src", "-train_tgt", f"{d}/train.tgt",
        "-valid_src", f"{d}/valid.src", "-valid_tgt", f"{d}/valid.tgt",
        "-save_data", f"{d}/demo", "-bpe_merges", "30", "-pretokenized"])
    return str(d)


def vmmt_c(d, save, *extra):
    return ["-data", f"{d}/demo", "-save_model", save, "-model_type", "vmmt_c",
            "-train_img_feats", f"{d}/train.feats.npy", "-valid_img_feats",
            f"{d}/valid.feats.npy", "-img_feat_dim", "16", "-batch_size", "16", *SMALL, *extra]


def translate_args(d, model, out, *extra):
    return ["-model", model, "-src", f"{d}/test.src", "-tgt", f"{d}/test.tgt", "-img_feats",
            f"{d}/test.feats.npy", "-bpe_codes", f"{d}/demo.bpe.codes", "-pretokenized",
            "-output", out, "-beam_size", "3", "-n_best", "2", "-batch_size", "8",
            "-max_length", "12", *extra]


def test_cli_chain_output_equals_jax_translate(corpus, tmp_path, capsys):
    d = str(corpus)
    ckpt = f"{tmp_path}/ckpts"
    trainer = cli_train.main(vmmt_c(d, ckpt, "-max_steps", "6", "-report_every", "3",
                                    "-valid_every", "3", "-checkpoint_every", "3",
                                    "-metrics_log", f"{tmp_path}/metrics.jsonl",
                                    "-valid_bleu", "1"))
    assert ck.list_checkpoints(ckpt) == [3, 6] and trainer.final_state.step == 6
    with open(f"{tmp_path}/metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "train/ppl" in r] == [3, 6]
    assert [r["step"] for r in recs if "valid/bleu" in r] == [3, 6]
    out = cli_translate.main(translate_args(d, ckpt, f"{tmp_path}/pred.txt", "-device", "cpu",
                                            "-verbose"))
    port_out = capsys.readouterr().out
    jax_translate.main(translate_args(d, ckpt, f"{tmp_path}/jax_pred.txt", "-verbose"))
    jax_out = capsys.readouterr().out
    with open(f"{tmp_path}/pred.txt") as f, open(f"{tmp_path}/jax_pred.txt") as g:
        mine, theirs = f.read(), g.read()
    assert mine == theirs and len(mine.splitlines()) == 20
    assert len(out["nbest"]) == 10 and out["bleu"] is not None
    # the -verbose report: force-decoded PRED and GOLD scores within 1e-4
    for key in ("PRED SCORE:", "GOLD AVG SCORE:", "BLEU ="):
        a = [line for line in port_out.splitlines() if line.startswith(key)]
        b = [line for line in jax_out.splitlines() if line.startswith(key)]
        assert len(a) == len(b) > 0, key
        if key == "PRED SCORE:":
            np.testing.assert_allclose([float(x.split()[-1]) for x in a],
                                       [float(x.split()[-1]) for x in b], atol=1e-4)
        else:
            assert a == b


def test_cli_chain_of_the_port_alone(corpus, tmp_path, capsys):
    """Raw text -> the port's preprocess (BPE, shards) -> the port's train
    CLI reading the shards -> the port's translate CLI with the codes."""
    d = str(corpus)
    prefix = f"{tmp_path}/own"
    cli_preprocess.main(["-train_src", f"{d}/train.src", "-train_tgt", f"{d}/train.tgt",
                         "-valid_src", f"{d}/valid.src", "-valid_tgt", f"{d}/valid.tgt",
                         "-save_data", prefix, "-bpe_merges", "30", "-shard_size", "25"])
    assert "suggested -buckets" in capsys.readouterr().out
    assert BinarizedDataset.shard_paths(prefix + ".train.npz") == [
        f"{prefix}.train.{i:02d}.npz" for i in range(3)]
    ckpt = f"{tmp_path}/ckpts"
    trainer = cli_train.main(["-data", prefix, "-save_model", ckpt, "-model_type", "vmmt_c",
                              "-train_img_feats", f"{d}/train.feats.npy", "-valid_img_feats",
                              f"{d}/valid.feats.npy", "-img_feat_dim", "16", "-batch_size",
                              "16", "-max_steps", "4", "-checkpoint_every", "4",
                              "-valid_every", "2", *SMALL])
    assert trainer.final_state.step == 4 and len(trainer.history) == 2
    args = translate_args(d, ckpt, f"{tmp_path}/pred.txt", "-device", "cpu")
    args[args.index("-bpe_codes") + 1] = prefix + ".bpe.codes"
    out = cli_translate.main(args)
    with open(f"{tmp_path}/pred.txt") as f:
        assert len(f.read().splitlines()) == 20
    assert len(out["nbest"]) == 10 and out["bleu"] is not None


def test_cli_resume_continues_a_run(corpus, tmp_path):
    d = str(corpus)
    ckpt = f"{tmp_path}/run"
    cli_train.main(vmmt_c(d, ckpt, "-max_steps", "6", "-valid_every", "100",
                          "-checkpoint_every", "100", "-report_every", "100"))
    trainer = cli_train.main(vmmt_c(d, ckpt, "-train_from", ckpt, "-max_steps", "8",
                                    "-valid_every", "100", "-checkpoint_every", "100",
                                    "-report_every", "4"))
    assert trainer.last_run["steps"] == 2
    state, _, _, _, _ = ck.load_checkpoint(ck.latest_checkpoint(ckpt), device="cpu")
    assert state.step == 8
    jstate, _, _, _, _ = jax_ck.load_checkpoint(ck.latest_checkpoint(ckpt))
    assert int(jstate.step) == 8


def test_cli_resume_from_a_released_checkpoint_warns(corpus, tmp_path, capsys):
    d = str(corpus)
    ckpt = f"{tmp_path}/run"
    cli_train.main(vmmt_c(d, ckpt, "-max_steps", "2", "-valid_every", "100"))
    ck.release_checkpoint(ck.latest_checkpoint(ckpt), f"{tmp_path}/released")
    cli_train.main(vmmt_c(d, f"{tmp_path}/more", "-train_from", f"{tmp_path}/released",
                          "-max_steps", "3", "-valid_every", "100"))
    assert "RELEASED" in capsys.readouterr().out


def test_cli_epochs_flag(corpus, tmp_path):
    """60 examples in one bucket, batch 32: ceil(60/32) = 2 steps an
    epoch, 2 epochs (the final partial batch pads up and trains)."""
    d = str(corpus)
    trainer = cli_train.main(["-data", f"{d}/demo", "-save_model", f"{tmp_path}/cke",
                              "-model_type", "nmt", "-batch_size", "32", "-epochs", "2",
                              "-report_every", "2", "-valid_every", "100",
                              "-checkpoint_every", "100", *SMALL])
    assert trainer.final_state.step == 4
    assert ck.list_checkpoints(f"{tmp_path}/cke") == [4]


def test_cli_pack_with_epochs_counts_packed_batches_exactly(corpus, tmp_path):
    """-pack 1 -epochs 2: the steps are the batches of epochs 0 and 1 as
    the packer makes them, not PackedBucketIterator.__len__'s estimate;
    the checkpoint decodes through the unpacked translate path."""
    d = str(corpus)
    ckpt = f"{tmp_path}/ckpack"
    trainer = cli_train.main(vmmt_c(d, ckpt, "-pack", "1", "-pack_segments", "3",
                                    "-batch_size", "4", "-epochs", "2", "-valid_every", "3",
                                    "-checkpoint_every", "100", "-report_every", "100"))
    it = PackedBucketIterator(BinarizedDataset.load(f"{d}/demo.train.npz"), 4, [16], seed=1234,
                              max_segments=3)
    exact = sum(1 for e in range(2) for _ in it.epoch(e))
    assert trainer.final_state.step == exact == it.epoch_batches(0) + it.epoch_batches(1)
    assert exact != 2 * len(it)  # the estimate would have been wrong here
    cli_translate.main(translate_args(d, ckpt, f"{tmp_path}/pred.txt", "-device", "cpu"))
    with open(f"{tmp_path}/pred.txt") as f:
        assert len(f.read().splitlines()) == 20


def test_flag_map_covers_full_surface():
    import argparse

    p = argparse.ArgumentParser()
    cli_train.add_args(p)
    dests = {a.dest for a in p._actions if a.dest != "help"}
    assert dests == set(cli_train.FLAG2KEY) | cli_train.RUNTIME_FLAGS
    cd = Config().to_dict()
    for flag, (sect, key) in cli_train.FLAG2KEY.items():
        assert key in cd[sect], f"{flag} -> {sect}.{key} is not a Config field"
    # every flag of JAX's train CLI is here, with the same map
    from variational_mmt_tpu.cli import train as jax_train

    q = argparse.ArgumentParser()
    jax_train.add_args(q)
    assert {a.dest for a in q._actions if a.dest != "help"} == dests - {"device"}
    assert cli_train.FLAG2KEY == jax_train.FLAG2KEY


def test_config_file_with_full_cli_override(corpus, tmp_path):
    """-config as the base and every mapped flag the port trains with
    passed explicitly: each lands in the final Config (the checkpoint's)."""
    import dataclasses

    d = str(corpus)
    base = Config()
    base = dataclasses.replace(base, model=dataclasses.replace(base.model, dropout=0.5,
                                                               z_cond="init"))
    cfg_path = f"{tmp_path}/base.json"
    with open(cfg_path, "w") as f:
        f.write(base.to_json())
    overrides = {
        "data": f"{d}/demo", "buckets": "16", "model_type": "vmmt_c", "rnn_type": "gru",
        "word_vec_size": "32", "rnn_size": "32", "enc_layers": "1",
        "share_decoder_embeddings": "1", "share_embeddings": "0", "dec_layers": "1",
        "dropout": "0.11", "word_dropout": "0.07", "input_feed": "1",
        "global_attention": "general", "z_latent_dim": "4", "img_feat_dim": "16",
        "img_feat_type": "pool5", "img_pool": "mean", "use_img_predict": "1", "img_loss": "mse",
        "img_loss_weight": "0.5", "z_cond": "init+input", "compute_dtype": "float32",
        "use_pallas": "0", "fused_ce": "1", "batch_size": "16", "grad_accum": "2",
        "steps_per_call": "1", "max_steps": "1", "epochs": "0", "optim": "sgd",
        "learning_rate": "0.123", "max_grad_norm": "3.5", "adam_beta1": "0.85",
        "adam_beta2": "0.97", "learning_rate_decay": "0.7", "start_decay_at": "77",
        "label_smoothing": "0.05", "param_init": "0.08", "kl_anneal": "sigmoid",
        "kl_anneal_steps": "55", "kl_anneal_start": "5", "kl_free_bits": "0.25",
        "skip_nonfinite": "1", "ema_decay": "0.9", "ema_ramp": "0", "pack": "1",
        "pack_segments": "3", "fix_word_vecs_enc": "1", "fix_word_vecs_dec": "1", "seed": "42",
        "report_every": "9", "valid_every": "100", "checkpoint_every": "100",
        "keep_checkpoints": "2", "num_shards": "1", "tensor_parallel": "1",
    }
    argv = ["-save_model", f"{tmp_path}/ckov", "-config", cfg_path, "-train_img_feats",
            f"{d}/train.feats.npy", "-device", "cpu"]
    for k, v in overrides.items():
        argv += [f"-{k}", v]
    cli_train.main(argv)
    got = ck.read_config(ck.latest_checkpoint(f"{tmp_path}/ckov")).to_dict()
    for flag, (sect, key) in cli_train.FLAG2KEY.items():
        if flag in ("data", "buckets"):
            continue
        want, have = overrides[flag], got[sect][key]
        if isinstance(have, bool):
            assert have == bool(int(want)), flag
        elif isinstance(have, (int, float)):
            assert abs(float(have) - float(want)) < 1e-9, flag
        else:
            assert str(have) == want, flag
    assert got["data"]["buckets"] == [16] and got["data"]["save_data"] == f"{d}/demo"


def test_unmapped_passed_flag_errors():
    with pytest.raises(SystemExit, match="not mapped"):
        cli_train.passed_flags(["-totally_bogus_flag", "1"])


@pytest.mark.parametrize("optim,file_text,lr", [
    ("adagrad", None, 0.1),  # a file written for adam: the family default wins
    (None, '{"train": {"optimizer": "adadelta"}}', 1.0),  # the file sets no lr
    (None, '{"train": {"optimizer": "adadelta", "learning_rate": 0.5}}', 0.5),
], ids=["cli_adagrad_over_adam_file", "file_adadelta_no_lr", "file_adadelta_lr"])
def test_optimizer_family_lr_defaults_with_config(corpus, tmp_path, optim, file_text, lr):
    d = str(corpus)
    cfg_path = f"{tmp_path}/base.json"
    with open(cfg_path, "w") as f:
        f.write(file_text if file_text is not None else Config().to_json())
    argv = ["-data", f"{d}/demo", "-save_model", f"{tmp_path}/ck", "-config", cfg_path,
            "-model_type", "nmt", "-batch_size", "8", "-max_steps", "1",
            "-checkpoint_every", "100", "-valid_every", "100", *SMALL]
    trainer = cli_train.main(argv + (["-optim", optim] if optim else []))
    assert trainer.cfg.train.optimizer == (optim or "adadelta")
    assert abs(trainer.cfg.train.learning_rate - lr) < 1e-9


def test_optimizer_family_lr_default_without_config(corpus, tmp_path):
    d = str(corpus)
    trainer = cli_train.main(["-data", f"{d}/demo", "-save_model", f"{tmp_path}/ck",
                              "-model_type", "nmt", "-optim", "adadelta", "-batch_size", "8",
                              "-max_steps", "1", "-valid_every", "100", *SMALL])
    assert trainer.cfg.train.learning_rate == 1.0


def test_config_without_features_disables_image_machinery(corpus, tmp_path):
    from variational_mmt_torch.config import ModelConfig

    d = str(corpus)
    preset = Config(model=ModelConfig(model_type="vmmt_c", img_feat_dim=2048,
                                      use_img_predict=True))
    cfg_path = f"{tmp_path}/mm.json"
    with open(cfg_path, "w") as f:
        f.write(preset.to_json())
    trainer = cli_train.main(["-data", f"{d}/demo", "-save_model", f"{tmp_path}/ck",
                              "-config", cfg_path, "-batch_size", "8", "-max_steps", "1",
                              "-valid_every", "100", *SMALL])
    assert trainer.cfg.model.img_feat_dim == 0 and not trainer.cfg.model.use_img_predict


def test_share_embeddings_requires_shared_vocab(corpus, tmp_path):
    d = str(corpus)
    with pytest.raises(SystemExit, match="share_vocab"):
        cli_train.main(["-data", f"{d}/demo", "-save_model", f"{tmp_path}/x",
                        "-model_type", "nmt", "-share_embeddings", "1", "-batch_size", "8",
                        "-max_steps", "1", *SMALL])


def test_sharded_corpus_and_pretrained_frozen_vectors(corpus, tmp_path):
    """Shards from preprocess -shard_size train as one corpus; the
    pretrained tables, frozen, leave training as they came in."""
    d = str(corpus)
    jax_preprocess.main(["-train_src", f"{d}/train.src", "-train_tgt", f"{d}/train.tgt",
                         "-save_data", f"{tmp_path}/sh", "-no_bpe", "-pretokenized",
                         "-shard_size", "25"])
    assert len(BinarizedDataset.shard_paths(f"{tmp_path}/sh.train.npz")) == 3
    ds, jds = (cls.load(f"{tmp_path}/sh.train.npz")
               for cls in (BinarizedDataset, JaxBinarizedDataset))
    assert len(ds) == 60 and all(np.array_equal(a, b) for a, b in zip(ds.tgt, jds.tgt))
    sv = Vocab.load(f"{tmp_path}/sh.vocab.src.json")
    tv = Vocab.load(f"{tmp_path}/sh.vocab.tgt.json")
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((len(sv), 16)).astype(np.float32)
    dec = rng.standard_normal((len(tv), 16)).astype(np.float32)
    np.save(f"{tmp_path}/enc.npy", enc)
    np.save(f"{tmp_path}/dec.npy", dec)
    trainer = cli_train.main(["-data", f"{tmp_path}/sh", "-save_model", f"{tmp_path}/ck",
                              "-model_type", "nmt", "-batch_size", "16", "-max_steps", "2",
                              "-pre_word_vecs_enc", f"{tmp_path}/enc.npy",
                              "-pre_word_vecs_dec", f"{tmp_path}/dec.npy",
                              "-fix_word_vecs_enc", "1", "-fix_word_vecs_dec", "1", *SMALL])
    assert trainer.final_state.step == 2
    np.testing.assert_array_equal(trainer.model.src_embed.embedding.detach().numpy(), enc)
    np.testing.assert_array_equal(trainer.model.tgt_embed.embedding.detach().numpy(), dec)
    with pytest.raises(ValueError, match="pretrained table"):
        np.save(f"{tmp_path}/bad.npy", enc[:, :8])
        cli_train.main(["-data", f"{tmp_path}/sh", "-save_model", f"{tmp_path}/ck2",
                        "-model_type", "nmt", "-batch_size", "16", "-max_steps", "1",
                        "-pre_word_vecs_enc", f"{tmp_path}/bad.npy", *SMALL])


def test_tensorboard_and_profile_dirs(corpus, tmp_path):
    d = str(corpus)
    cli_train.main(["-data", f"{d}/demo", "-save_model", f"{tmp_path}/ck", "-model_type", "nmt",
                    "-batch_size", "16", "-max_steps", "2", "-report_every", "1",
                    "-valid_every", "100", "-tensorboard_dir", f"{tmp_path}/tb",
                    "-profile_dir", f"{tmp_path}/prof", *SMALL])
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(f"{tmp_path}/tb"))
    with open(f"{tmp_path}/prof/trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_tokenizer_and_bpe_equal_jax(corpus):
    d = str(corpus)
    lines = ["A man's dog, in the U.S., runs -- fast!", "Two \"kids\" (3.5 years) play.",
             "  It's 10:30 & they're   here/there; ok?  ", "", "Hello -world- foo's bar'"]
    for lower in (True, False):
        assert [tokenize(x, lower) for x in lines] == [jax_tokenize(x, lower) for x in lines]
    ours, theirs = BPE.load(f"{d}/demo.bpe.codes"), JaxBPE.load(f"{d}/demo.bpe.codes")
    assert ours.merges == theirs.merges and len(ours.merges) > 0
    with open(f"{d}/test.src") as f:
        words = [w for line in f for w in line.split()] + ["s1s2s3", "t", "s12s12"]
    assert [ours.segment_word(w) for w in words] == [theirs.segment_word(w) for w in words]


def test_load_features_reads_npy_npz_and_conv_maps(tmp_path):
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((3, 8)).astype(np.float32)
    nhwc = rng.standard_normal((3, 7, 7, 8)).astype(np.float32)
    np.save(f"{tmp_path}/p.npy", pool)
    np.savez(f"{tmp_path}/c.npz", train=nhwc, valid=nhwc.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(load_features(f"{tmp_path}/p.npy"), pool)
    want = nhwc.reshape(3, 49, 8)
    np.testing.assert_array_equal(load_features(f"{tmp_path}/c.npz", split="train"), want)
    np.testing.assert_array_equal(load_features(f"{tmp_path}/c.npz", split="valid"), want)
    with pytest.raises(ValueError, match="split"):
        load_features(f"{tmp_path}/p.npy", split="train")


TRANSLATE_REFUSED = [
    (["-tensor_parallel", "2"], "5.8"),
]


@pytest.mark.parametrize("flags,item", TRANSLATE_REFUSED, ids=lambda x: (
    " ".join(x) if isinstance(x, list) else x))
def test_translate_refuses_what_is_not_ported_naming_its_roadmap_item(flags, item, tmp_path):
    # item 5.8 ported decoding across ranks: outside torchrun the flag is
    # refused, naming the command and the item
    argv = ["-model", "nowhere", "-src", "nowhere.txt", "-device", "cpu", *flags]
    with pytest.raises(SystemExit, match=f"torchrun --nproc_per_node 2.*ROADMAP.md .*{item}"):
        cli_translate.main(argv)


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("run") / "ckpts")
    cli_train.main(vmmt_c(str(corpus), ckpt, "-max_steps", "3", "-checkpoint_every", "3"))
    return ckpt


@pytest.fixture(scope="module")
def trained_nmt(corpus, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("run_nmt") / "ckpts")
    cli_train.main(["-data", f"{corpus}/demo", "-save_model", ckpt, "-model_type", "nmt",
                    "-batch_size", "16", "-seed", "5", "-max_steps", "3",
                    "-checkpoint_every", "3", *SMALL])
    return ckpt


ONCE_REFUSED = {  # the translate CLI's options once refused (ROADMAP item 5.4)
    "-infer_dtype bfloat16": (["-infer_dtype", "bfloat16"], False),
    "-model a,b": (["-ensemble_mode", "prob"], True),
}


@pytest.mark.parametrize("case", ONCE_REFUSED)
def test_translate_takes_the_options_once_refused(case, corpus, trained, trained_nmt,
                                                  tmp_path, capsys):
    """Once refused naming item 5.4: ``-infer_dtype bfloat16`` and a
    comma-separated ``-model`` (vmmt_c + nmt) now translate, and write what
    JAX's translate CLI writes on the same checkpoints."""
    flags, ensemble = ONCE_REFUSED[case]
    d = str(corpus)
    model = f"{trained},{trained_nmt}" if ensemble else trained
    cli_translate.main(translate_args(d, model, f"{tmp_path}/pred.txt", "-device", "cpu",
                                      *flags))
    out = capsys.readouterr().out
    assert ("ensemble of 2 checkpoints (prob)" in out) == ensemble
    jax_translate.main(translate_args(d, model, f"{tmp_path}/jax_pred.txt", *flags))
    with open(f"{tmp_path}/pred.txt") as f, open(f"{tmp_path}/jax_pred.txt") as g:
        mine, theirs = f.read(), g.read()
    assert mine == theirs and len(mine.splitlines()) == 20


DECODE_OPTIONS = [
    ["-coverage_beta", "0.2"], ["-block_ngram_repeat", "2", "-ignore_when_blocking", "@@ ."],
    ["-replace_unk"], ["-replace_unk", "-phrase_table", "PT"], ["-dump_beam", "BEAM"],
]


@pytest.mark.parametrize("flags", DECODE_OPTIONS, ids=" ".join)
def test_translate_decode_options_equal_jax_translate(corpus, trained, flags, tmp_path):
    """Once refused (queue 1, item 4): the port's CLI writes what JAX's
    writes with the same flags (f32, n-best ids identical), and the same
    search trees with -dump_beam (scores within 1e-4)."""
    d = str(corpus)
    with open(f"{tmp_path}/pt.txt", "w") as f:
        f.write("zz\tfrom the table\nmulti word\tskipped\n")
    outs = {}
    for name, main, extra in (("port", cli_translate.main, ["-device", "cpu"]),
                              ("jax", jax_translate.main, [])):
        args = [{"PT": f"{tmp_path}/pt.txt", "BEAM": f"{tmp_path}/{name}.json"}.get(a, a)
                for a in flags]
        main(translate_args(d, trained, f"{tmp_path}/{name}.txt", *args, *extra))
        with open(f"{tmp_path}/{name}.txt") as f:
            outs[name] = f.read()
    assert outs["port"] == outs["jax"] and len(outs["port"].splitlines()) == 20
    if "BEAM" in flags:
        with open(f"{tmp_path}/port.json") as f, open(f"{tmp_path}/jax.json") as g:
            mine, theirs = json.load(f), json.load(g)
        assert sorted(mine) == sorted(theirs) and len(mine) == 10
        for i, w in theirs.items():
            assert [mine[i][k] for k in ("parents", "tokens", "order")] == \
                [w[k] for k in ("parents", "tokens", "order")]
            np.testing.assert_allclose(mine[i]["scores"], w["scores"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("flags", [["-sampling_temp", "0.7", "-sampling_topk", "5"],
                                   ["-latent_from", "sample"]], ids=" ".join)
def test_translate_sampling_flags_decode_reproducibly(corpus, trained, flags, tmp_path):
    """Once refused (queue 1, item 5.2): the draws come from -seed, so two
    runs write the same file and another seed another one (parity with
    JAX's draws: tests/test_torch_sampling.py)."""
    d = str(corpus)
    outs = []
    for seed, name in ((5, "a"), (5, "b"), (6, "c")):
        out = cli_translate.main(translate_args(
            d, trained, f"{tmp_path}/{name}.txt", "-beam_size", "1", "-n_best", "1",
            "-seed", str(seed), "-device", "cpu", *flags))
        assert len(out["nbest"]) == 10
        with open(f"{tmp_path}/{name}.txt") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] and outs[0] != outs[2]


TRAIN_REFUSED = [(["-num_shards", "2"], "5.8"), (["-tensor_parallel", "2"], "5.8")]


@pytest.mark.parametrize("flags,item", TRAIN_REFUSED, ids=lambda x: (
    " ".join(x) if isinstance(x, list) else x))
def test_train_refuses_what_is_not_ported_naming_its_roadmap_item(corpus, flags, item, tmp_path):
    # item 5.8 ported training across ranks: outside torchrun the flags are
    # refused, naming the command and the item
    d = str(corpus)
    with pytest.raises(SystemExit, match=f"torchrun --nproc_per_node 2.*ROADMAP.md .*{item}"):
        cli_train.main(["-data", f"{d}/demo", "-save_model", f"{tmp_path}/x", "-model_type",
                        "nmt", "-batch_size", "8", "-max_steps", "1", *SMALL, *flags])


@pytest.mark.parametrize("flags", [
    ["-rnn_type", "lstm"], ["-global_attention", "dot"], ["-input_feed", "0"],
    ["-img_feat_type", "conv", "-img_pool", "attn"],
], ids=" ".join)
def test_train_and_translate_the_item_5_5_options(corpus, flags, tmp_path):
    """Once refused (ROADMAP.md item 5.5): one training step with the
    option writes a checkpoint that the translate CLI decodes. Conv features
    are (4, 16) regions a line, their mean the pool5 feature."""
    d, feats = str(corpus), {}
    if "conv" in flags:
        rng = np.random.default_rng(3)
        for split in ("train", "valid", "test"):
            pool5 = np.load(f"{d}/{split}.feats.npy")
            conv = pool5[:, None, :] + 0.1 * rng.standard_normal((len(pool5), 4, 16))
            feats[split] = f"{tmp_path}/{split}.conv.npy"
            np.save(feats[split], conv.astype(np.float32))
    ckpt = f"{tmp_path}/run"
    argv = vmmt_c(d, ckpt, "-max_steps", "1", "-checkpoint_every", "1", "-valid_every", "1",
                  *flags)
    if feats:
        argv += ["-train_img_feats", feats["train"], "-valid_img_feats", feats["valid"]]
    cli_train.main(argv)
    state, cfg, _, _, _ = ck.load_checkpoint(ck.latest_checkpoint(ckpt), device="cpu")
    assert state.step == 1
    m = cfg.model
    assert (m.rnn_type, m.attn_type, m.input_feed, m.img_feat_type, m.img_pool) != (
        "gru", "general", True, "pool5", "mean")
    argv = translate_args(d, ckpt, f"{tmp_path}/pred.txt", "-device", "cpu")
    if feats:
        argv[argv.index("-img_feats") + 1] = feats["test"]
    out = cli_translate.main(argv)
    assert len(out["nbest"]) == 10 and all(len(nb) == 2 for nb in out["nbest"])


def test_train_refuses_pack_with_lstm_as_jax_does(corpus, tmp_path):
    d = str(corpus)
    with pytest.raises(SystemExit, match="-pack requires -rnn_type gru"):
        cli_train.main(vmmt_c(d, f"{tmp_path}/x", "-max_steps", "1", "-pack", "1",
                              "-rnn_type", "lstm"))
    assert not os.path.exists(f"{tmp_path}/x")


def test_train_refuses_fused_decoder_from_a_config_file(corpus, tmp_path, monkeypatch):
    """Once a refusal (``fused_decoder`` was not ported), kept under its
    name: ``cli.train`` now trains from a ``-config`` file that sets it,
    through the fused route (2 decoder layers), and the checkpoint keeps
    the option."""
    from variational_mmt_torch.models import decoder as mdec

    d = str(corpus)
    with open(f"{tmp_path}/fd.json", "w") as f:
        json.dump({"model": {"fused_decoder": True}}, f)
    calls = []
    fused = mdec.fused_input_feed_decoder
    monkeypatch.setattr(mdec, "fused_input_feed_decoder",
                        lambda *a: calls.append(1) or fused(*a))
    save = f"{tmp_path}/x"
    cli_train.main(["-data", f"{d}/demo", "-save_model", save, "-config",
                    f"{tmp_path}/fd.json", "-model_type", "nmt", "-max_steps", "2",
                    "-checkpoint_every", "2", *SMALL, "-dec_layers", "2"])
    state, cfg, _, _, _ = ck.load_checkpoint(ck.latest_checkpoint(save), device="cpu")
    assert cfg.model.fused_decoder and state.step == 2
    assert len(calls) == 2  # one forward a step


def test_clis_need_cuda_unless_cpu_is_asked(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(corpus)
    argv = ["-data", f"{d}/demo", "-save_model", f"{tmp_path}/x", "-model_type", "nmt",
            "-max_steps", "1", "-buckets", "16"]
    for extra in ([], ["-device", "cuda"]):
        with pytest.raises(SystemExit, match="CUDA.*-device cpu"):
            cli_train.main(argv + extra)
        with pytest.raises(SystemExit, match="CUDA.*-device cpu"):
            cli_translate.main(["-model", f"{tmp_path}/x", "-src", f"{d}/test.src", *extra])
    assert not os.path.exists(f"{tmp_path}/x")
