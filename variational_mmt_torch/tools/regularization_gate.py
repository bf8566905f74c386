"""Regularization gate of the port: the regime where vmmt_f can earn its
keep. Follows ``tools/regularization_gate.py`` (``build_cfg`` :37-73,
``run_one`` :76-111, its flags and defaults :114-135).

The deterministic task (data/synthetic.py ``make_corpus``: the text alone
determines the translation, the image is a noisy bag of the source's
words) at low data (``-n_train``), with optional target noise on the
training split only (``-train_noise p``: each training target token
resampled uniformly with probability p; the test references stay clean).
nmt against vmmt_f over the seeds, each (model, seed) trained
``-steps`` steps and its test BLEU (beam 4; vmmt_f decodes without the
image, z = 0 from its fixed prior) appended as one JSON line to ``-out``,
with the JAX tool's keys plus ``route``, ``device``, ``card`` and the
kernels' ``launches``. The summary prints each model's mean and the paired
delta (vmmt_f - nmt).

``-device`` and ``-route`` as ``tools/runs.py`` says: on cuda the kernel
route by default, ``-route scans`` the settings the JAX tool picks for the
TPU, ``-route plain`` (and the CPU) its CPU settings.

    python -m variational_mmt_torch.tools.regularization_gate -n_train 400 \\
        -train_noise 0.3 -steps 2000 -seeds 11
    python -m variational_mmt_torch.tools.regularization_gate -device cpu -steps 20
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List

import numpy as np
import torch

from variational_mmt_torch.config import Config, DataConfig, DecodeConfig, ModelConfig, TrainConfig
from variational_mmt_torch.convert import params_from_jax
from variational_mmt_torch.data.dataset import BucketIterator, binarize
from variational_mmt_torch.data.synthetic import corrupt_targets, make_corpus
from variational_mmt_torch.decode.translator import Translator
from variational_mmt_torch.device import resolve_device
from variational_mmt_torch.evals.bleu import corpus_bleu
from variational_mmt_torch.models.model import build_model, init_params
from variational_mmt_torch.tools.runs import (add_device_args, card_name, launches,
                                              resolve_route, route_model, route_pallas_step,
                                              sync, zero_launches)
from variational_mmt_torch.train.trainer import Trainer


def build_cfg(model_type: str, seed: int, args) -> Config:
    """JAX's ``build_cfg`` field for field: ``-route plain`` gives its CPU
    config, ``scans`` its TPU config, ``kernels`` the TPU config with the
    decoder sequence kernels on."""
    fast = args.route != "plain"
    return Config(
        model=ModelConfig(
            model_type=model_type, src_vocab_size=args.vocab_size,
            tgt_vocab_size=args.vocab_size, emb_dim=args.emb_dim, hidden_dim=args.hidden_dim,
            enc_layers=2, dec_layers=2, dropout=args.dropout,
            word_dropout=0.1 if model_type != "nmt" else 0.0, latent_dim=args.latent_dim,
            img_feat_dim=args.img_dim if model_type != "nmt" else 0,
            use_img_predict=model_type != "nmt" and not args.no_img_predict,
            img_loss="logprob", z_cond="init+input", **route_model(args.route)),
        train=TrainConfig(
            seed=seed, batch_size=args.batch_size,
            steps_per_call=8 if fast else 1,  # JAX's TPU setting; the port ignores it
            max_steps=args.steps, learning_rate=4e-4, kl_anneal="linear",
            kl_anneal_steps=max(1, args.steps // 2), report_every=max(50, args.steps // 5),
            valid_every=10 ** 9, checkpoint_every=10 ** 9),
        data=DataConfig(buckets=[16, 24]),
    )


def train_model(cfg: Config, train_iter, train_feats, device: torch.device) -> tuple:
    """(trainer, seconds): a model initialized as JAX's (``init_params``
    with the run's seed), trained ``cfg.train.max_steps`` steps."""
    model = build_model(cfg.model, device=device)
    model.load_state_dict(params_from_jax(init_params(cfg.model, seed=cfg.train.seed),
                                          cfg.model))
    trainer = Trainer(cfg, model, train_iter, device=device, train_feats=train_feats)
    sync(device)
    t0 = time.time()
    trainer.train()
    trainer.close()
    sync(device)
    return trainer, time.time() - t0


def run_one(model_type: str, seed: int, data, args, device: torch.device, card: str) -> dict:
    tr_src, tr_tgt, tr_feats, te_src, te_tgt, te_feats, sv, tv = data
    cfg = build_cfg(model_type, seed, args)
    tr_ids = binarize([sv.encode(s) for s in tr_src], [tv.encode(t) for t in tr_tgt])
    it = BucketIterator(tr_ids, cfg.train.batch_size, cfg.data.buckets, shuffle=True, seed=seed)
    zero_launches()
    trainer, train_s = train_model(cfg, it, tr_feats if model_type != "nmt" else None, device)
    dcfg = DecodeConfig(beam_size=4, max_length=32, batch_size=args.batch_size,
                        pallas_step=route_pallas_step(args.route))
    translator = Translator(trainer.model, sv, tv, dcfg, buckets=cfg.data.buckets, device=device)
    # vmmt_f decodes WITHOUT the image (fixed prior: z = 0), as JAX's gate
    out = translator.translate_ids([sv.encode(s) for s in te_src], None)
    translator.close()
    hyps = [tv.decode(nbest[0][1]) for nbest in out]
    bleu = corpus_bleu(hyps, [[r] for r in te_tgt])["bleu"]
    return {"model": model_type, "seed": seed, "test_bleu": round(bleu, 2),
            "n_train": args.n_train, "train_noise": args.train_noise,
            "no_img_predict": args.no_img_predict, "steps": args.steps,
            "train_s": round(train_s, 1), "route": args.route, "device": str(device),
            "card": card, "launches": launches()}


def parse_args(argv=None):
    p = argparse.ArgumentParser("vmmt port regularization gate")
    p.add_argument("-models", default="nmt,vmmt_f")
    p.add_argument("-seeds", default="11,12,13")
    p.add_argument("-n_train", type=int, default=800)
    p.add_argument("-n_test", type=int, default=500)
    p.add_argument("-train_noise", type=float, default=0.3,
                   help="per-token uniform resampling prob on TRAIN targets")
    p.add_argument("-steps", type=int, default=1500)
    p.add_argument("-data_seed", type=int, default=0)
    p.add_argument("-vocab_size", type=int, default=200)
    p.add_argument("-emb_dim", type=int, default=256)
    p.add_argument("-hidden_dim", type=int, default=256)
    p.add_argument("-latent_dim", type=int, default=64)
    p.add_argument("-img_dim", type=int, default=512)
    p.add_argument("-dropout", type=float, default=0.3)
    p.add_argument("-no_img_predict", type=int, default=0,
                   help="1: drop p(v|z) for vmmt_f (KL(q||N(0,I)) then anneals to ~0, so "
                        "decode-time z = 0 matches training)")
    p.add_argument("-batch_size", type=int, default=64)
    add_device_args(p)
    p.add_argument("-out", default="reg_results.jsonl")
    args = p.parse_args(argv)
    resolve_route(p, args)
    return args


def make_data(args):
    """The deterministic corpus split into train and test, the training
    targets corrupted at ``-train_noise`` (JAX :148-165)."""
    src, tgt, feats, sv, tv = make_corpus(args.n_train + args.n_test,
                                          vocab_size=args.vocab_size, img_dim=args.img_dim,
                                          max_len=16, seed=args.data_seed)
    a = args.n_train
    tr_tgt = tgt[:a]
    if args.train_noise > 0:
        # corrupt TRAINING targets only (memorization trap); test refs clean
        tr_tgt = [list(t) for t in tr_tgt]
        corrupt_targets(tr_tgt, args.train_noise, args.vocab_size, seed=args.data_seed + 1)
    return src[:a], tr_tgt, feats[:a], src[a:], tgt[a:], feats[a:], sv, tv


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    card = card_name(device)
    print(f"device: {device} ({card}), route {args.route}")
    data = make_data(args)
    results = []
    for model_type in args.models.split(","):
        for seed in [int(s) for s in args.seeds.split(",")]:
            r = run_one(model_type, seed, data, args, device, card)
            results.append(r)
            print(json.dumps(r), flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")

    print(f"\n== summary (test BLEU vs clean refs; {card}) ==")
    by_model = {}
    for m in args.models.split(","):
        xs = [r["test_bleu"] for r in results if r["model"] == m]
        by_model[m] = xs
        if xs:
            print(f"{m:8s} {np.mean(xs):6.2f} +/- {np.std(xs):4.2f}  (n={len(xs)})")
    if by_model.get("nmt") and by_model.get("vmmt_f"):
        deltas = [b - a for a, b in zip(by_model["nmt"], by_model["vmmt_f"])]
        print(f"paired delta (vmmt_f - nmt): {np.mean(deltas):+.2f} +/- {np.std(deltas):.2f}  "
              f"per-seed {deltas}")
    return results


if __name__ == "__main__":
    main()
