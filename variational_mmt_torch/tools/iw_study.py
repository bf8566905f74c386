"""IW-ELBO model-selection study of the port. Follows ``tools/iw_study.py``
(``build_cfg`` :45-88, ``iw_batches`` :91-107, ``run_one`` :110-186, its
flags and defaults :189-205).

On the stochastic corpus (data/synthetic.py ``make_stochastic_corpus``:
the image shifts the target's distribution without determining it)
held-out likelihood is the honest discriminator, and it has analytic
floors (``stochastic_nll_floors``): ln(S) extra nats per sense-revealing
sentence from the text alone, H(c_real | c_img) with the image. Per
(model, seed), after ``-steps`` steps of training:

- nmt: the exact -log p(y|x) per sentence (force-decoded, ``score_corpus``);
- vmmt_f / vmmt_c: the active units and KL of the latent
  (``latent_stats_corpus``), and the K-sample IW bound on -log p(y|x) for
  each K of ``-k_list`` (``iw_elbo_corpus``, draws seeded with seed * 1000
  + K), which must tighten in K (``iw_monotone``, 1e-3 of Monte Carlo
  jitter allowed), beside the joint bound with p(v|z);
- the test BLEU (beam 4) for contrast.

One JSON line a run goes to ``-out``, with the JAX tool's keys plus
``route``, ``device``, ``card`` and the kernels' ``launches``. ``-device``
and ``-route`` as ``tools/runs.py`` says.

    python -m variational_mmt_torch.tools.iw_study -models nmt,vmmt_f,vmmt_c -seeds 11
    python -m variational_mmt_torch.tools.iw_study -device cpu -steps 20 -n_train 200
"""

from __future__ import annotations

import argparse
import json
from typing import Iterator, List

import numpy as np
import torch

from variational_mmt_torch.config import Config, DataConfig, DecodeConfig, ModelConfig, TrainConfig
from variational_mmt_torch.data.dataset import BucketIterator, binarize, buckets_with_catchall
from variational_mmt_torch.data.prefetch import device_batches
from variational_mmt_torch.data.synthetic import make_stochastic_corpus, stochastic_nll_floors
from variational_mmt_torch.decode.diagnostics import latent_stats_corpus
from variational_mmt_torch.decode.iw_eval import iw_elbo_corpus
from variational_mmt_torch.decode.score import score_corpus
from variational_mmt_torch.decode.translator import Translator
from variational_mmt_torch.device import resolve_device
from variational_mmt_torch.evals.bleu import corpus_bleu
from variational_mmt_torch.tools.regularization_gate import train_model
from variational_mmt_torch.tools.runs import (add_device_args, card_name, launches,
                                              resolve_route, route_model, route_pallas_step,
                                              zero_launches)


def build_cfg(model_type: str, seed: int, steps: int, args) -> Config:
    """JAX's ``build_cfg`` field for field (``-route plain``: its CPU
    config; ``scans``: its TPU config; ``kernels``: that with the decoder
    sequence kernels on)."""
    fast = args.route != "plain"
    return Config(
        model=ModelConfig(
            model_type=model_type, src_vocab_size=args.vocab_size,
            tgt_vocab_size=args.vocab_size, emb_dim=args.emb_dim, hidden_dim=args.hidden_dim,
            enc_layers=2, dec_layers=2, dropout=0.3, word_dropout=0.1,
            latent_dim=args.latent_dim, img_feat_dim=args.img_dim if model_type != "nmt" else 0,
            use_img_predict=model_type != "nmt", img_loss="logprob", z_cond="init+input",
            **route_model(args.route)),
        train=TrainConfig(
            seed=seed, batch_size=args.batch_size,
            steps_per_call=8 if fast else 1,  # JAX's TPU setting; the port ignores it
            max_steps=steps, learning_rate=4e-4, kl_anneal="linear",
            kl_anneal_steps=max(1, steps // 2), kl_free_bits=args.kl_free_bits,
            report_every=max(50, steps // 5), valid_every=10 ** 9,
            checkpoint_every=10 ** 9),
        data=DataConfig(buckets=[16, 24, 32]),
    )


def iw_batches(src_ids, tgt_ids, feats, batch_size: int, buckets,
               device: torch.device) -> Iterator[dict]:
    """Device batches for ``iw_elbo_corpus`` and ``latent_stats_corpus``
    (the translate CLI's ``-iw_eval`` layout), a catch-all bucket keeping
    long pairs whole."""
    bks = buckets_with_catchall(buckets, max([1] + [len(s) for s in src_ids]
                                             + [len(t) + 1 for t in tgt_ids]))
    it = BucketIterator(binarize(src_ids, tgt_ids), batch_size, bks, img_feats=feats)
    return device_batches(it.epoch(0), device)


def run_one(model_type: str, seed: int, data, floors, args, device: torch.device,
            card: str) -> dict:
    tr_src, tr_tgt, tr_feats, te_src, te_tgt, te_feats, sv, tv = data
    cfg = build_cfg(model_type, seed, args.steps, args)
    tr_ids = binarize([sv.encode(s) for s in tr_src], [tv.encode(t) for t in tr_tgt])
    it = BucketIterator(tr_ids, cfg.train.batch_size, cfg.data.buckets, shuffle=True, seed=seed)
    zero_launches()
    trainer, train_s = train_model(cfg, it, tr_feats if model_type != "nmt" else None, device)
    model = trainer.model

    te_src_ids = [sv.encode(s) for s in te_src]
    te_tgt_ids = [tv.encode(t) for t in te_tgt]
    feats = te_feats if model_type != "nmt" else None
    rec = {"model": model_type, "seed": seed, "steps": args.steps,
           "kl_free_bits": args.kl_free_bits, "n_train": len(tr_src), "n_test": len(te_src),
           "train_s": round(train_s, 1), "floor_text_nats": round(floors[0], 3),
           "floor_img_nats": round(floors[1], 3)}

    # held-out likelihood
    if model_type == "nmt":
        logp, _ = score_corpus(model, te_src_ids, te_tgt_ids, None, buckets=cfg.data.buckets,
                               batch_size=args.batch_size)
        rec["nll_exact_per_sent"] = round(float(-logp.mean()), 3)
    else:
        # posterior-collapse instruments: active units and per-dimension KL
        diag = latent_stats_corpus(model, iw_batches(te_src_ids, te_tgt_ids, feats,
                                                     args.batch_size, cfg.data.buckets, device))
        rec["au"] = diag["au"]
        rec["kl_per_sent"] = round(diag["kl_per_sent"], 3)
        rec["kl_active_dims"] = diag["kl_active_dims"]
        for k in args.k_list:
            out = iw_elbo_corpus(model, iw_batches(te_src_ids, te_tgt_ids, feats,
                                                   args.batch_size, cfg.data.buckets, device),
                                 k, seed=seed * 1000 + k)
            rec[f"iw_text_nll_k{k}"] = round(-out["iw_text_per_sent"], 3)
            rec[f"iw_joint_k{k}"] = round(out["iw_elbo_per_sent"], 3)
        ks = sorted(args.k_list)
        rec["iw_monotone"] = all(
            rec[f"iw_text_nll_k{ks[i + 1]}"] <= rec[f"iw_text_nll_k{ks[i]}"]
            + 1e-3  # Monte Carlo jitter at small gaps
            for i in range(len(ks) - 1))

    # BLEU for contrast
    dcfg = DecodeConfig(beam_size=4, max_length=40, batch_size=args.batch_size,
                        pallas_step=route_pallas_step(args.route))
    tr = Translator(model, sv, tv, dcfg, buckets=cfg.data.buckets, device=device)
    out = tr.translate_ids(te_src_ids, feats)
    tr.close()
    hyps = [tv.decode(nb[0][1]) for nb in out]
    rec["test_bleu"] = round(corpus_bleu(hyps, [[r] for r in te_tgt])["bleu"], 2)
    rec.update(route=args.route, device=str(device), card=card, launches=launches())
    return rec


def parse_args(argv=None):
    p = argparse.ArgumentParser("vmmt port IW-ELBO study")
    p.add_argument("-models", default="nmt,vmmt_f,vmmt_c")
    p.add_argument("-seeds", default="11,12,13")
    p.add_argument("-k_list", default="1,5,25")
    p.add_argument("-n_train", type=int, default=6000)
    p.add_argument("-n_test", type=int, default=500)
    p.add_argument("-steps", type=int, default=2500)
    p.add_argument("-data_seed", type=int, default=0)
    p.add_argument("-vocab_size", type=int, default=200)
    p.add_argument("-n_senses", type=int, default=4)
    p.add_argument("-sense_flip", type=float, default=0.25)
    p.add_argument("-emb_dim", type=int, default=256)
    p.add_argument("-hidden_dim", type=int, default=256)
    p.add_argument("-latent_dim", type=int, default=64)
    p.add_argument("-img_dim", type=int, default=512)
    p.add_argument("-batch_size", type=int, default=64)
    p.add_argument("-kl_free_bits", type=float, default=0.0)
    add_device_args(p)
    p.add_argument("-out", default="iw_study.jsonl")
    args = p.parse_args(argv)
    resolve_route(p, args)
    args.k_list = [int(k) for k in args.k_list.split(",")]
    return args


def make_data(args):
    """(train/test split, the test split's analytic floors)."""
    src, tgt, feats, sv, tv, _, _, amb = make_stochastic_corpus(
        args.n_train + args.n_test, vocab_size=args.vocab_size, n_senses=args.n_senses,
        sense_flip=args.sense_flip, img_dim=args.img_dim, seed=args.data_seed)
    a = args.n_train
    floors = stochastic_nll_floors(src[a:], amb, args.n_senses, args.sense_flip,
                                   args.vocab_size)
    return (src[:a], tgt[:a], feats[:a], src[a:], tgt[a:], feats[a:], sv, tv), floors


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    card = card_name(device)
    print(f"device: {device} ({card}), route {args.route}")
    data, floors = make_data(args)
    print(f"test-split NLL floors (extra nats/sent): text-only {floors[0]:.3f}, "
          f"image-aware {floors[1]:.3f} (gap {floors[0] - floors[1]:.3f})")

    results = []
    for model_type in args.models.split(","):
        for seed in [int(s) for s in args.seeds.split(",")]:
            r = run_one(model_type, seed, data, floors, args, device, card)
            results.append(r)
            print(json.dumps(r), flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")

    kmax = max(args.k_list)
    print(f"\n== summary: held-out -log p(y|x) per sent (mean +/- sd; {card}) ==")
    print(f"   analytic floors: text-only {floors[0]:.3f} / image-aware {floors[1]:.3f}")
    for model_type in args.models.split(","):
        key = "nll_exact_per_sent" if model_type == "nmt" else f"iw_text_nll_k{kmax}"
        xs = [r[key] for r in results if r["model"] == model_type]
        bl = [r["test_bleu"] for r in results if r["model"] == model_type]
        if xs:
            tag = "exact" if model_type == "nmt" else f"IW K={kmax}"
            print(f"{model_type:8s} {np.mean(xs):7.3f} +/- {np.std(xs):5.3f} "
                  f"({tag}, n={len(xs)})  BLEU {np.mean(bl):5.2f}")
    return results


if __name__ == "__main__":
    main()
