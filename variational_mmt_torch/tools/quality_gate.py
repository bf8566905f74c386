"""Discriminative quality gate of the port. Follows ``tools/quality_gate.py``
(``build_cfg`` :44-89, ``run_one`` :131-175, its flags and defaults).

Trains nmt / vmmt_f / vmmt_c on the ambiguous synthetic task
(data/synthetic.py ``make_ambiguous_corpus``): a per-sentence latent sense
makes half the word types untranslatable from text alone (text-only
asymptote about 28 BLEU) while the image feature encodes the sense (oracle
about 67). Each (model, seed) trains ``-steps`` steps, then decodes the
test and valid splits with beam 4, and its test BLEU is appended as one
JSON line to ``-out``. Decode-time defects prove that the gate detects
them (applied after clean training, as in the JAX runner):

  kl_off      beta = 1 from step 0 (no KL annealing; a training change)
  attn_shift  attention scores read keys rolled by one source position
              while the values stay in place
  z_zero      decoding takes z = 0 instead of the prior mean
  alpha0      the beam's length penalty is off

With ``-ema_decay d`` the run also keeps an EMA of the weights
(``-ema_ramp``) and decodes the test split with them too, reporting
``test_bleu_ema`` beside ``test_bleu`` (JAX's :193-204).

The device is cuda unless ``-device cpu``; ``-route`` is as
``tools/runs.py`` says (on cuda ``kernels`` by default, ``scans`` the
route the JAX gate runs on the TPU, ``plain`` f32 without kernels).

    python -m variational_mmt_torch.tools.quality_gate -models vmmt_c -seeds 11,12,13
    python -m variational_mmt_torch.tools.quality_gate -models vmmt_c -seeds 11 \\
        -defect attn_shift
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import time
from typing import Iterator, List

import numpy as np
import torch

from variational_mmt_torch.config import Config, DecodeConfig, ModelConfig, TrainConfig
from variational_mmt_torch.convert import params_from_jax
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.data.packing import PackedBucketIterator
from variational_mmt_torch.data.synthetic import (corrupt_targets, make_ambiguous_corpus,
                                                  make_corpus, oracle_bleu_bounds)
from variational_mmt_torch.decode.translator import Translator
from variational_mmt_torch.device import resolve_device
from variational_mmt_torch.evals.bleu import corpus_bleu
from variational_mmt_torch.models import attention, model as model_mod
from variational_mmt_torch.models.model import build_model, init_params
from variational_mmt_torch.tools.runs import (COUNTERS, add_device_args, card_name, launches,
                                              resolve_route, route_model, route_pallas_step,
                                              zero_launches)
from variational_mmt_torch.train.trainer import Trainer

BUCKETS = [16, 24, 32]


def build_cfg(model_type: str, seed: int, args) -> Config:
    return Config(
        model=ModelConfig(
            model_type=model_type, src_vocab_size=args.vocab_size,
            tgt_vocab_size=args.vocab_size, emb_dim=args.emb_dim, hidden_dim=args.hidden_dim,
            enc_layers=2, dec_layers=2, dropout=0.3, word_dropout=0.1,
            latent_dim=args.latent_dim,
            img_feat_dim=args.img_dim if model_type != "nmt" else 0,
            img_feat_type="conv" if args.img_regions > 0 else "pool5", img_pool=args.img_pool,
            use_img_predict=model_type != "nmt" and not args.no_img_predict,
            img_loss="logprob", z_cond="init+input", **route_model(args.route)),
        train=TrainConfig(
            seed=seed, max_steps=args.steps, learning_rate=4e-4,
            kl_anneal="none" if args.defect == "kl_off" else "linear",
            kl_anneal_steps=max(1, args.steps // 2), kl_free_bits=args.kl_free_bits,
            ema_decay=args.ema_decay, ema_ramp=bool(args.ema_ramp),
            pack=bool(args.pack), pack_segments=args.pack_segments))


@contextlib.contextmanager
def attn_shift_defect() -> Iterator[None]:
    """Attention scores computed against keys rolled one source position
    while the values stay in place: the alignment found for source word i
    fetches word i-1's content. Every decode path reads keys from
    ``VMMTModel.project_memory`` (the plain step, the GRU chain's
    attention, and the decode-step kernel, which takes the first element of
    ``(keys, mem_v)``), so the roll happens there; the plain attention
    rolls the keys it projects itself when none are given."""
    orig_proj = model_mod.VMMTModel.project_memory
    orig_attn = attention.GlobalAttention.forward

    def project_memory(self, memory, with_values=False):
        out = orig_proj(self, memory, with_values)
        if isinstance(out, tuple):
            return (torch.roll(out[0], 1, dims=1),) + tuple(out[1:])
        return torch.roll(out, 1, dims=1)

    def forward(self, query, memory, src_mask, keys=None):
        if keys is None:
            keys = torch.roll(self.project_memory(memory), 1, dims=1)
        return orig_attn(self, query, memory, src_mask, keys)

    model_mod.VMMTModel.project_memory = project_memory
    attention.GlobalAttention.forward = forward
    try:
        yield
    finally:
        model_mod.VMMTModel.project_memory = orig_proj
        attention.GlobalAttention.forward = orig_attn


@contextlib.contextmanager
def z_zero_defect() -> Iterator[None]:
    """Latent-mean substitution returns 0 instead of the prior mean (the
    bug that would silently turn vmmt_c decoding into vmmt_f decoding)."""
    orig = model_mod.VMMTModel.prior_latent

    def prior_latent(self, src_summary, img):
        return torch.zeros_like(orig(self, src_summary, img))

    model_mod.VMMTModel.prior_latent = prior_latent
    try:
        yield
    finally:
        model_mod.VMMTModel.prior_latent = orig


DEFECTS = {"attn_shift": attn_shift_defect, "z_zero": z_zero_defect}


def run_one(model_type: str, seed: int, data, args, device: torch.device, card: str) -> dict:
    (tr_src, tr_tgt, tr_feats, va_src, va_tgt, va_feats,
     te_src, te_tgt, te_feats, sv, tv) = data
    cfg = build_cfg(model_type, seed, args)
    ids = lambda lines, v: [np.asarray(v.encode(s), np.int32) for s in lines]  # noqa: E731
    tr_ids = BinarizedDataset(ids(tr_src, sv), ids(tr_tgt, tv))
    text_only = model_type == "nmt"
    feats = None if text_only else tr_feats
    if cfg.train.pack:
        it = PackedBucketIterator(tr_ids, args.batch_size, BUCKETS, img_feats=feats, seed=seed,
                                  max_segments=cfg.train.pack_segments)
    else:
        it = BucketIterator(tr_ids, args.batch_size, BUCKETS, img_feats=feats, shuffle=True,
                            seed=seed)
    model = build_model(cfg.model, device=device)
    model.load_state_dict(params_from_jax(init_params(cfg.model, seed=seed), cfg.model))
    zero_launches()
    trainer = Trainer(cfg, model, it, device=device)
    every = max(50, args.steps // 5)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.time()
    done = 0
    while done < args.steps:
        n = min(every, args.steps - done)
        hist = trainer.train(n)
        done += n
        print(f"  {model_type} seed {seed} step {done}: loss {hist[-1]['loss']:.3f}, "
              f"{(time.time() - t0) / done * 1e3:.1f} ms/step", flush=True)
    trainer.close()
    sync()
    train_s = time.time() - t0

    dcfg = DecodeConfig(beam_size=4, max_length=40, batch_size=args.batch_size,
                        alpha=0.0 if args.defect == "alpha0" else 0.6,
                        pallas_step=route_pallas_step(args.route))
    defect = DEFECTS.get(args.defect, contextlib.nullcontext)
    with defect():  # decode-time defects act after clean training
        translator = Translator(trainer.model, sv, tv, dcfg, buckets=BUCKETS, device=device)
        t0 = time.time()
        out = translator.translate_ids([sv.encode(s) for s in te_src],
                                       None if text_only else te_feats)
        sync()
        decode_s = time.time() - t0
        bleu = corpus_bleu([tv.decode(nb[0][1]) for nb in out], [[r] for r in te_tgt])["bleu"]
        out_v = translator.translate_ids([sv.encode(s) for s in va_src],
                                         None if text_only else va_feats)
        vbleu = corpus_bleu([tv.decode(nb[0][1]) for nb in out_v],
                            [[r] for r in va_tgt])["bleu"]
        bleu_ema = None
        if args.ema_decay > 0:
            # same harness, EMA weights: the raw-vs-Polyak decode comparison
            ema_tr = Translator(ema_model(trainer), sv, tv, dcfg, buckets=BUCKETS,
                                device=device)
            out_e = ema_tr.translate_ids([sv.encode(s) for s in te_src],
                                         None if text_only else te_feats)
            bleu_ema = corpus_bleu([tv.decode(nb[0][1]) for nb in out_e],
                                   [[r] for r in te_tgt])["bleu"]
    res = {"model": model_type, "seed": seed, "defect": args.defect, "img_pool": args.img_pool,
           "img_regions": args.img_regions, "test_bleu": round(bleu, 2),
           "valid_bleu": round(vbleu, 2), "steps": args.steps, "train_s": round(train_s, 1),
           "decode_s": round(decode_s, 1), "route": args.route, "device": str(device),
           "card": card, "launches": launches()}
    if cfg.train.pack:
        res["pack"] = 1
    if bleu_ema is not None:
        res.update(ema_decay=args.ema_decay, ema_ramp=bool(args.ema_ramp),
                   test_bleu_ema=round(bleu_ema, 2))
    return res


def ema_model(trainer: Trainer) -> torch.nn.Module:
    """A copy of the trainer's model holding its EMA weights."""
    model = copy.deepcopy(trainer.model)
    with torch.no_grad():
        for p, e in zip(model.parameters(), trainer.state.ema):
            p.copy_(e)
    return model


def parse_args(argv=None):
    p = argparse.ArgumentParser("vmmt port quality gate")
    p.add_argument("-models", default="nmt,vmmt_f,vmmt_c")
    p.add_argument("-seeds", default="11,12,13")
    p.add_argument("-defect", default="none",
                   choices=["none", "kl_off", "attn_shift", "z_zero", "alpha0"])
    p.add_argument("-n_train", type=int, default=6000)
    p.add_argument("-n_valid", type=int, default=300)
    p.add_argument("-n_test", type=int, default=500)
    p.add_argument("-steps", type=int, default=2500)
    p.add_argument("-data_seed", type=int, default=0)
    p.add_argument("-vocab_size", type=int, default=200)
    p.add_argument("-emb_dim", type=int, default=256)
    p.add_argument("-hidden_dim", type=int, default=256)
    p.add_argument("-latent_dim", type=int, default=64)
    p.add_argument("-img_dim", type=int, default=512)
    p.add_argument("-img_regions", type=int, default=0,
                   help="R>0: conv-style (R, img_dim) region features, the sense signal in "
                        "one region")
    p.add_argument("-img_pool", default="mean", choices=["mean", "attn"])
    p.add_argument("-batch_size", type=int, default=64)
    p.add_argument("-kl_free_bits", type=float, default=0.0)
    p.add_argument("-ema_ramp", type=int, default=1,
                   help="0: fixed decay (no num_updates warm-in)")
    p.add_argument("-ema_decay", type=float, default=0.0,
                   help=">0: also decode with the EMA (Polyak) weights and "
                        "report test_bleu_ema next to the raw test_bleu")
    p.add_argument("-corpus", default="ambiguous", choices=["ambiguous", "plain"],
                   help="plain: the deterministic task (synthetic.make_corpus)")
    p.add_argument("-tgt_noise", type=float, default=0.0,
                   help="plain corpus only: fraction of train-split gold target tokens "
                        "replaced by random tokens")
    p.add_argument("-no_img_predict", type=int, default=0,
                   help="1: drop the p(v|z) image-prediction objective")
    p.add_argument("-pack", type=int, default=0, help="1: train with sequence packing")
    p.add_argument("-pack_segments", type=int, default=4)
    add_device_args(p)
    p.add_argument("-out", default="port_gate_results.jsonl")
    args = p.parse_args(argv)
    resolve_route(p, args)
    return args


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    card = card_name(device)
    print(f"device: {device} ({card}), route {args.route}")
    n = args.n_train + args.n_valid + args.n_test
    a, b = args.n_train, args.n_train + args.n_valid
    if args.corpus == "plain":
        src, tgt, feats, sv, tv = make_corpus(n, vocab_size=args.vocab_size,
                                              img_dim=args.img_dim, seed=args.data_seed)
        if args.tgt_noise > 0:
            # train-split gold targets only: clean-test BLEU measures how well a
            # model resists memorizing label noise
            corrupt_targets(tgt[:a], args.tgt_noise, args.vocab_size, seed=args.data_seed + 1)
        o_bleu, t_bleu = 100.0, 100.0  # deterministic task, clean test references
    else:
        src, tgt, feats, sv, tv, senses, amb = make_ambiguous_corpus(
            n, vocab_size=args.vocab_size, img_dim=args.img_dim, seed=args.data_seed,
            regions=args.img_regions)
        o_bleu, t_bleu = oracle_bleu_bounds(src[b:], tgt[b:], senses[b:], amb, args.vocab_size)
    data = (src[:a], tgt[:a], feats[:a], src[a:b], tgt[a:b], feats[a:b],
            src[b:], tgt[b:], feats[b:], sv, tv)
    print(f"test-split asymptotes: oracle {o_bleu:.2f}, text-only {t_bleu:.2f}")

    results = []
    models = args.models.split(",")
    for model_type in models:
        for seed in [int(s) for s in args.seeds.split(",")]:
            r = run_one(model_type, seed, data, args, device, card)
            r.update(oracle_bleu=round(o_bleu, 2), text_asymptote=round(t_bleu, 2),
                     corpus=args.corpus, n_train=args.n_train)
            if args.corpus == "plain":
                r["tgt_noise"] = args.tgt_noise
            if args.no_img_predict:
                r["no_img_predict"] = 1
            results.append(r)
            print(json.dumps(r), flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")

    print(f"\n== summary (test BLEU mean +/- sd; oracle {o_bleu:.2f}, text-only "
          f"{t_bleu:.2f}; {card}) ==")
    for model_type in models:
        xs = [r["test_bleu"] for r in results if r["model"] == model_type]
        if xs:
            print(f"{model_type:8s} {np.mean(xs):6.2f} +/- {np.std(xs):4.2f}  (n={len(xs)})")
    return results


if __name__ == "__main__":
    main()
