"""``translate`` CLI of the port: ``python -m variational_mmt_torch.cli.translate``.

Mirrors ``variational_mmt_tpu/cli/translate.py`` on checkpoints of either
package (a run root resolves to its latest step; several comma-separated in
``-model`` decode as an ensemble, combined by ``-ensemble_mode``): tokenize (or
``-pretokenized``), BPE with ``-bpe_codes``, beam search with latent-mean
substitution, n-best text to ``-output``; with ``-tgt`` the BLEU line, and
with ``-verbose`` each sentence's force-decoded score (PRED SCORE, and the
GOLD scores with ``-tgt``). ``-pallas_step`` 1 or 2 takes the decode-step
or GRU-chain kernel on the card; the CPU takes the plain step. It runs on
CUDA unless given ``-device cpu`` and exits with an error without CUDA.

The decode options are JAX's: ``-coverage_beta``, ``-block_ngram_repeat``
with ``-ignore_when_blocking``, ``-replace_unk`` with ``-phrase_table``,
``-dump_beam`` (the raw search tree of each sentence as JSON), sampling
(``-sampling_temp``, ``-sampling_topk``, ``-sampling_topp``),
``-latent_from sample`` and ``-mbr_samples N`` (the consensus of N
sampled decodes), drawing from ``-seed``.

The evaluations are JAX's too: ``-dump_attn`` (the force-decoded attention
of each 1-best hypothesis, an .npz); with ``-tgt``, ``-report_meteor``
(``-meteor_preset``, ``-meteor_synonyms``, ``-meteor_paraphrases``) and,
for latent models, ``-iw_eval K`` (the K-sample IW-ELBO, drawing from
``-seed``) and ``-latent_diag`` (active units and the KL spectrum).

``-infer_dtype bfloat16`` decodes with the weights cast to bfloat16,
``int8`` with int8 codes and per-column scales rebuilt as bfloat16 within
each batch; the checkpoints are then read into host memory, and the
passes defined per model (``-verbose``, ``-dump_attn``, ``-iw_eval``,
``-latent_diag``) move the model's f32 weights to the device only when
they run. An ensemble refuses those four options (as JAX's does).

Across GPUs (ROADMAP.md item 5.8), one process a GPU:

    torchrun --nproc_per_node N -m variational_mmt_torch.cli.translate ... \
        [-tensor_parallel M]

decodes on N / M data x M model ranks (parallel/mesh.py): each data rank
its rows of every batch (``-batch_size`` must divide by N / M, where JAX
would drop to one device), the vocab split over the M model ranks, and
rank 0 writes the n-best lists in corpus order and prints. The passes
defined per model run on every rank with the full model (the IW bound on
the mesh). An ensemble refuses ``-tensor_parallel``, as JAX's does.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Tuple

import numpy as np
import torch

from variational_mmt_torch.cli.loading import consumes_decode_feats, load_device, load_model_spec
from variational_mmt_torch.cli.train import cli_device, cli_mesh, quiet_unless_main
from variational_mmt_torch.config import DecodeConfig
from variational_mmt_torch.data.bpe import BPE
from variational_mmt_torch.data.dataset import BucketIterator, binarize, buckets_with_catchall
from variational_mmt_torch.data.features import load_features
from variational_mmt_torch.data.prefetch import device_batches
from variational_mmt_torch.data.tokenizer import tokenize
from variational_mmt_torch.decode.translator import Translator
from variational_mmt_torch.evals.bleu import corpus_bleu
from variational_mmt_torch.evals.meteor import meteor_score

DEFAULT_BUCKETS = [16, 24, 32, 48, 64]


def add_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-model", required=True,
                   help="checkpoint dir (or specific step dir); "
                        "comma-separate several for an ensemble decode")
    p.add_argument("-use_ema", action="store_true",
                   help="decode with the EMA (Polyak-averaged) weights "
                        "instead of the raw params (requires a checkpoint "
                        "trained with -ema_decay > 0)")
    p.add_argument("-infer_dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="decode-time weight precision: bfloat16 halves HBM "
                        "weight traffic on the bandwidth-bound decode step; "
                        "int8 (weight-only, per-channel) quarters the "
                        "persistent weight footprint for serving density")
    p.add_argument("-pallas_step", type=int, default=0, choices=[0, 1, 2],
                   help="1: the fused decode-step kernel; 2: the GRU-chain kernel "
                        "with attention outside, on the card for flagship-structure "
                        "models (2-layer GRU, general attention, input_feed); the "
                        "plain step on the CPU")
    p.add_argument("-ensemble_mode", default="prob", choices=["prob", "logprob"],
                   help="how ensemble members' next-token distributions are "
                        "combined: mean probability (prob) or mean log-prob "
                        "(logprob, geometric)")
    p.add_argument("-src", required=True, help="source text file")
    p.add_argument("-tgt", default="", help="reference target (for BLEU / IW eval)")
    p.add_argument("-img_feats", default="", help="HDF5/NPY features aligned to src lines")
    p.add_argument("-output", default="pred.txt")
    p.add_argument("-tensor_parallel", type=int, default=1,
                   help=">1: decode on a 2-D (data, model) mesh with vocab-"
                        "parallel embeddings+generator (matches train "
                        "-tensor_parallel)")
    p.add_argument("-bpe_codes", default="", help="BPE codes from preprocess (applied to src)")
    p.add_argument("-pretokenized", action="store_true")
    p.add_argument("-no_lower", action="store_true")
    p.add_argument("-beam_size", type=int, default=4)
    p.add_argument("-n_best", type=int, default=1)
    p.add_argument("-max_length", type=int, default=100)
    p.add_argument("-min_length", type=int, default=0)
    p.add_argument("-alpha", type=float, default=0.6, help="GNMT length penalty exponent")
    p.add_argument("-block_ngram_repeat", type=int, default=0,
                   help="g > 0: no hypothesis may contain a repeated g-gram "
                        "(masked before top-k, on device)")
    p.add_argument("-ignore_when_blocking", default="",
                   help="space-separated tokens exempt from ngram blocking "
                        "(g-grams containing them may repeat)")
    p.add_argument("-coverage_beta", type=float, default=0.0,
                   help="GNMT coverage penalty weight (0 = off)")
    p.add_argument("-batch_size", type=int, default=32)
    p.add_argument("-replace_unk", action="store_true",
                   help="replace <unk> outputs with the max-attention source token")
    p.add_argument("-phrase_table", default="",
                   help="src<TAB>tgt map consulted by -replace_unk before "
                        "copying the source token verbatim")
    p.add_argument("-verbose", action="store_true",
                   help="per-sentence SENT/PRED/PRED SCORE (+ GOLD with -tgt) report")
    p.add_argument("-dump_beam", default="",
                   help="JSON path: raw beam search tree per sentence "
                        "(per-step parent/token/score for every beam slot)")
    p.add_argument("-dump_attn", default="",
                   help=".npz path: attention matrices of each 1-best hypothesis "
                        "(force-decoded; exact for the deterministic beam)")
    p.add_argument("-iw_eval", type=int, default=0, help="K>0: report K-sample IW-ELBO (needs -tgt)")
    p.add_argument("-latent_diag", action="store_true",
                   help="report posterior-collapse diagnostics over the corpus "
                        "(active units + per-dim KL; latent models, needs -tgt)")
    p.add_argument("-report_bleu", action="store_true")
    p.add_argument("-report_meteor", action="store_true")
    p.add_argument("-meteor_preset", default="original", choices=["original", "1.5-en"])
    p.add_argument("-meteor_synonyms", default="", help="synonym table file (meteor hook)")
    p.add_argument("-meteor_paraphrases", default="", help="paraphrase table file (meteor hook)")
    p.add_argument("-seed", type=int, default=1234)
    p.add_argument("-sampling_temp", type=float, default=0.0,
                   help="> 0: ancestral sampling instead of search "
                        "(requires -beam_size 1; 1.0 = untempered)")
    p.add_argument("-sampling_topk", type=int, default=0,
                   help="sample from the k highest-probability tokens only")
    p.add_argument("-sampling_topp", type=float, default=0.0,
                   help="nucleus sampling: smallest token set with "
                        "cumulative probability >= p")
    p.add_argument("-mbr_samples", type=int, default=0,
                   help="N > 0: minimum-Bayes-risk decode — draw N samples "
                        "per sentence (requires -sampling_temp > 0) and "
                        "output the consensus hypothesis (max expected "
                        "sentence-BLEU against the other samples)")
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default; an error without CUDA) or cpu")
    p.add_argument("-latent_from", default="mean", choices=["mean", "sample"],
                   help="decode-time z: prior mean (reference behavior) or "
                        "a per-sentence sample z ~ p(z|x,v) seeded by -seed "
                        "(different seeds give alternative translations)")


def ensemble_refused(opt) -> list:
    """The options set that an ensemble refuses: scoring, the IW bound and
    the latent diagnostics are defined per model."""
    return [flag for flag, on in (
        ("-iw_eval", opt.iw_eval > 0), ("-latent_diag", opt.latent_diag),
        ("-verbose", opt.verbose), ("-dump_attn", bool(opt.dump_attn))) if on]


def load_phrase_table(path: str) -> Tuple[Dict[str, str], int]:
    """A ``src<TAB>tgt`` file (the first space when a line has no TAB; the
    target may hold spaces) -> ({src: tgt}, multi-word sources skipped)."""
    table, skipped = {}, 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            src_w, sep, tgt_w = line.rstrip("\n").partition("\t")
            if not sep:
                src_w, sep, tgt_w = src_w.partition(" ")
            src_w, tgt_w = src_w.strip(), tgt_w.strip()
            if not src_w or not tgt_w:
                continue
            if " " in src_w:  # a multi-word source cannot match one token
                skipped += 1
                continue
            table[src_w] = tgt_w
    return table, skipped


def main(argv=None) -> Dict[str, object]:
    """Translate as the flags say; returns {"nbest": [[(score, ids), ...]
    a sentence], "sent_per_s": ..., "bleu": ... or None} and, where they
    ran, "meteor", "iw" (with "iw_s", the IW pass's seconds) and
    "latent_diag"."""
    p = argparse.ArgumentParser("vmmt-torch translate")
    add_args(p)
    opt = p.parse_args(argv)
    if "," in opt.model and ensemble_refused(opt):
        # decidable from the flags: fail before loading any checkpoint
        raise SystemExit(f"{', '.join(ensemble_refused(opt))}: not supported with an ensemble "
                         "(force-decode scoring and the IW bound are defined per model); "
                         "pass a single -model")
    if "," in opt.model and opt.tensor_parallel > 1:
        raise SystemExit("ensemble decode does not compose with tensor parallelism; use a "
                         "data-only mesh (drop -tensor_parallel)")
    device = cli_device(opt.device)
    mesh = cli_mesh(0, opt.tensor_parallel, device)
    if mesh is not None and opt.batch_size % mesh.n_data:
        mesh.close()
        raise SystemExit(f"-batch_size {opt.batch_size} does not divide by the "
                         f"{mesh.n_data} data-parallel ranks: every rank decodes an equal "
                         f"share of each batch; pick a multiple of {mesh.n_data}")
    with quiet_unless_main(mesh):
        return translate(opt, mesh.device if mesh is not None else device, mesh)


def translate(opt, device: torch.device, mesh) -> Dict[str, object]:
    """The run of :func:`main` once its mesh is made (on every rank)."""
    main_rank = mesh is None or mesh.is_main
    lm = load_model_spec(opt.model, use_ema=opt.use_ema,
                         device=load_device(device, opt.infer_dtype))
    cfg, sv, tv = lm.cfgs[0], lm.src_vocab, lm.tgt_vocab

    def model():
        """The single model with its f32 weights on the device, for the
        passes defined per model (scoring, -dump_attn, the IW bound, the
        latent diagnostics), as JAX's; read into host memory at bfloat16 or
        int8, it moves only when such a pass runs."""
        return lm.models[0].to(device)

    lower = not opt.no_lower
    with open(opt.src, encoding="utf-8") as f:
        raw = [line.rstrip("\n") for line in f]
    if opt.pretokenized:
        src_tok = [(line.lower() if lower else line).split() for line in raw]
    else:
        src_tok = [tokenize(line, lower=lower) for line in raw]
    bpe = BPE.load(opt.bpe_codes) if opt.bpe_codes else None
    if bpe is not None:
        src_tok = [bpe.segment(t) for t in src_tok]
    feats = load_features(opt.img_feats) if opt.img_feats else None
    if feats is not None and len(feats) != len(src_tok):
        raise SystemExit(f"feature rows ({len(feats)}) must align to the {len(src_tok)} "
                         "source lines")
    needs_feats = [c.model for c in lm.cfgs if consumes_decode_feats(c.model)]
    if feats is None and needs_feats:
        raise SystemExit(
            "this checkpoint's conditional prior was trained on image features "
            f"(img_feat_dim={needs_feats[0].img_feat_dim}): pass -img_feats aligned to the "
            "source file (vmmt_f decodes without features; vmmt_c cannot)")

    if opt.mbr_samples > 0 and opt.sampling_temp <= 0.0:
        raise SystemExit(
            "-mbr_samples draws from the model: also pass -sampling_temp > 0 "
            "(e.g. 0.7; add -sampling_topk/-sampling_topp to truncate)")
    dcfg = DecodeConfig(beam_size=opt.beam_size, n_best=opt.n_best, max_length=opt.max_length,
                        min_length=opt.min_length, alpha=opt.alpha, batch_size=opt.batch_size,
                        replace_unk=opt.replace_unk, coverage_beta=opt.coverage_beta,
                        dump_beam=bool(opt.dump_beam), ensemble_mode=opt.ensemble_mode,
                        infer_dtype=opt.infer_dtype,
                        pallas_step=opt.pallas_step if device.type == "cuda" else 0,
                        sampling_temp=opt.sampling_temp, sampling_topk=opt.sampling_topk,
                        sampling_topp=opt.sampling_topp, latent_from=opt.latent_from,
                        decode_seed=opt.seed, block_ngram_repeat=opt.block_ngram_repeat,
                        ignore_when_blocking=opt.ignore_when_blocking)
    buckets = cfg.data.buckets or DEFAULT_BUCKETS
    if lm.ensemble:
        print(f"ensemble of {len(lm.models)} checkpoints ({opt.ensemble_mode})")
    if mesh is not None:  # JAX's line (:198, :203)
        print(f"decode over ({mesh.n_data} data x {mesh.n_model} model) mesh, {mesh.backend}")
    translator = Translator(lm.translator_args(), sv, tv, dcfg, buckets=buckets,
                            device=device, mesh=mesh)
    if opt.phrase_table:
        if not opt.replace_unk:
            raise SystemExit("-phrase_table is only consulted by -replace_unk; "
                             "pass both (the table maps the copied source token)")
        translator.phrase_table, skipped = load_phrase_table(opt.phrase_table)
        print(f"loaded {len(translator.phrase_table)} phrase-table entries"
              + (f" ({skipped} multi-word sources skipped)" if skipped else ""))
    src_ids = [sv.encode(t) for t in src_tok]  # encoded before the clock starts
    t0 = time.time()
    if opt.mbr_samples > 0:
        from variational_mmt_torch.decode.mbr import mbr_translate_ids

        nbest = mbr_translate_ids(translator, src_ids, feats, n_samples=opt.mbr_samples)
    else:
        nbest = translator.translate_ids(src_ids, feats)
    results = [translator.nbest_to_text(n, src_tok[i]) for i, n in enumerate(nbest)]
    dt = time.time() - t0
    rate = len(results) / max(dt, 1e-9)
    mode = (f"mbr {opt.mbr_samples} samples" if opt.mbr_samples > 0 else
            "sampling" if opt.sampling_temp > 0 else f"beam {opt.beam_size}")
    print(f"translated {len(results)} sentences in {dt:.1f}s ({rate:.1f} sent/s, {mode})")
    if main_rank:
        with open(opt.output, "w", encoding="utf-8") as f:
            for sent in results:
                for entry in sent[:opt.n_best]:
                    f.write(entry[1] + "\n")
    print(f"wrote {opt.output}")
    if opt.dump_beam and main_rank:
        with open(opt.dump_beam, "w", encoding="utf-8") as f:
            json.dump({str(i): translator.beam_traces[i]
                       for i in sorted(translator.beam_traces)}, f)
        print(f"wrote beam search trees for {len(translator.beam_traces)} "
              f"sentences -> {opt.dump_beam}")
    report: Dict[str, object] = {"nbest": nbest, "sent_per_s": rate, "bleu": None}

    if opt.verbose or opt.dump_attn:
        # force-decode each 1-best hypothesis: its true log p(y|x, z = the
        # prior mean) and, for -dump_attn, the attention the deterministic
        # beam saw
        from variational_mmt_torch.decode.score import score_corpus

        if opt.latent_from == "sample":
            print("note: force-decode scores/attention use z = prior mean, "
                  "not the sampled z the decode drew (-latent_from sample)")
        pred_lp, pred_nt, attns = score_corpus(model(), src_ids, [n[0][1] for n in nbest], feats,
                                               buckets=buckets, batch_size=opt.batch_size,
                                               return_attn=True)
        if opt.dump_attn and main_rank:
            np.savez(opt.dump_attn, **{f"attn_{i}": a for i, a in enumerate(attns)})
            print(f"wrote attention matrices for {len(attns)} sentences -> {opt.dump_attn}")
    if opt.verbose:
        for i, sent in enumerate(results):
            print(f"\nSENT {i + 1}: {' '.join(src_tok[i])}")
            for k, entry in enumerate(sent[:opt.n_best]):
                print(f"PRED {i + 1}.{k + 1}: {entry[1]}")
                print(f"PRED SCORE: {pred_lp[i]:.4f}" if k == 0 else
                      f"BEAM SCORE: {entry[0]:.4f}")

    if opt.iw_eval > 0 and not opt.tgt:
        print("note: -iw_eval skipped — the IW-ELBO needs gold targets (-tgt)")
    if opt.latent_diag and not opt.tgt:
        print("note: -latent_diag skipped — the posterior q(z|x,y,v) needs "
              "gold targets (-tgt)")
    if opt.tgt:
        with open(opt.tgt, encoding="utf-8") as f:
            if opt.pretokenized:
                refs = [(line.lower() if lower else line).rstrip("\n").split() for line in f]
            else:
                refs = [tokenize(line, lower=lower) for line in f]
        hyps = [sent[0][1].split() for sent in results]
        gold_ids = [tv.encode(bpe.segment(t) if bpe else t) for t in refs]
        # BLEU always prints with -tgt; -report_bleu is accepted and adds nothing
        res = corpus_bleu(hyps, [[r] for r in refs])
        report["bleu"] = res["bleu"]
        print(f"BLEU = {res['bleu']:.2f} (BP={res['bp']:.3f}, ratio={res['ratio']:.3f})")
        if opt.verbose:
            from variational_mmt_torch.decode.score import report_score, score_corpus

            gold_lp, gold_nt = score_corpus(model(), src_ids, gold_ids, feats, buckets=buckets,
                                            batch_size=opt.batch_size)
            print(report_score("PRED", pred_lp, pred_nt))
            print(report_score("GOLD", gold_lp, gold_nt))
            for i, r in enumerate(refs):
                print(f"GOLD {i + 1}: {' '.join(r)}  (score {gold_lp[i]:.4f})")
        if opt.report_meteor:
            from variational_mmt_torch.evals.meteor import load_table

            met = meteor_score(
                hyps, [[r] for r in refs], preset=opt.meteor_preset,
                synonyms=load_table(opt.meteor_synonyms) if opt.meteor_synonyms else None,
                paraphrases=load_table(opt.meteor_paraphrases) if opt.meteor_paraphrases else None)
            report["meteor"] = met["meteor"]
            print(f"METEOR({opt.meteor_preset}) = {met['meteor']:.2f}")
        for flag, on in (("-iw_eval", opt.iw_eval > 0), ("-latent_diag", opt.latent_diag)):
            if on and not lm.models[0].is_latent:
                print(f"note: {flag} skipped — defined for latent models "
                      f"only (checkpoint is {cfg.model.model_type})")
        if (opt.iw_eval > 0 or opt.latent_diag) and lm.models[0].is_latent:
            report.update(latent_evals(opt, model(), src_ids, gold_ids, feats, buckets, device,
                                       mesh))
    return report


def latent_evals(opt, model, src_ids, gold_ids, feats, buckets, device,
                 mesh=None) -> Dict[str, object]:
    """``-iw_eval`` and ``-latent_diag`` over the (source, gold target)
    pairs; prints JAX's lines and returns {"iw": ..., "iw_s": seconds of the
    IW pass, "latent_diag": ...} for what ran. The IW pass runs on
    ``mesh`` when given."""
    from variational_mmt_torch.decode.diagnostics import latent_stats_corpus
    from variational_mmt_torch.decode.iw_eval import iw_elbo_corpus

    # a catch-all bucket: over-long pairs are scored whole, not truncated
    iw_buckets = buckets_with_catchall(
        buckets, max([1] + [len(s) for s in src_ids] + [len(t) + 1 for t in gold_ids]))
    it = BucketIterator(binarize(src_ids, gold_ids), opt.batch_size, iw_buckets,
                        img_feats=feats)

    def batches():
        # prefetched, as JAX's IW and diagnostic passes read them (:373-392)
        return device_batches(it.epoch(0), device)

    out: Dict[str, object] = {}
    if opt.iw_eval > 0:
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.time()
        iw = iw_elbo_corpus(model, batches(), opt.iw_eval, seed=opt.seed, mesh=mesh)
        sync()
        out.update(iw=iw, iw_s=time.time() - t0)
        print(f"IW-ELBO (K={opt.iw_eval}): joint {iw['iw_elbo_per_sent']:.2f} / "
              f"text {iw['iw_text_per_sent']:.2f} per sent; IW-ppl {iw['iw_ppl']:.2f}")
    if opt.latent_diag:
        d = latent_stats_corpus(model, batches())
        out["latent_diag"] = d
        print(f"LATENT DIAG: active units {d['au']}/{d['latent_dim']} "
              f"(delta {d['au_delta']}); KL/sent {d['kl_per_sent']:.3f} "
              f"over {d['kl_active_dims']} active dims; top KL_d {d['kl_top8']}")
    return out


if __name__ == "__main__":
    main()
