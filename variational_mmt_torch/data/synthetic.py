"""Synthetic Multi30k-like corpus for tests and benchmarks.

A copy of ``variational_mmt_tpu/data/synthetic.py`` for the port, which
imports nothing of the JAX package; tests/test_torch_gate.py holds its
outputs equal to the original's.

The real Multi30k data does not ship with the repo, so tests/benches use a
deterministic synthetic task with the same *shape* as the reference's data:
parallel "sentences" over a BPE-sized vocab plus a 2048-d image-feature row
per example (SURVEY.md §4: "100-sentence synthetic corpus + random 2048-d features").

The task is learnable (so training curves/BLEU move): the target is a
token-wise affine remapping of the source with a deterministic local
reordering, and the image feature is a noisy bag-of-words embedding of the
source — so the visual modality genuinely carries information about the
sentence, exercising q(z|x,y,v) and p(v|z) meaningfully.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from variational_mmt_torch.data.vocab import SPECIALS, Vocab


def make_corpus(
    n: int,
    vocab_size: int = 200,
    min_len: int = 4,
    max_len: int = 20,
    img_dim: int = 2048,
    seed: int = 0,
    img_noise: float = 0.1,
) -> Tuple[List[List[str]], List[List[str]], np.ndarray, Vocab, Vocab]:
    """Returns (src_lines, tgt_lines, img_feats, src_vocab, tgt_vocab)."""
    rng = np.random.default_rng(seed)
    n_words = vocab_size - len(SPECIALS)
    src_words = [f"s{i}" for i in range(n_words)]
    tgt_words = [f"t{i}" for i in range(n_words)]
    # fixed random projection: word id -> img_dim embedding
    word_emb = rng.standard_normal((n_words, img_dim)).astype(np.float32)

    src_lines, tgt_lines, feats = [], [], np.zeros((n, img_dim), np.float32)
    for i in range(n):
        L = int(rng.integers(min_len, max_len + 1))
        ids = rng.integers(0, n_words, size=L)
        # target: affine id remap + swap adjacent pairs (local reordering)
        tids = (ids * 7 + 3) % n_words
        tids = tids.copy()
        for j in range(0, L - 1, 2):
            tids[j], tids[j + 1] = tids[j + 1], tids[j]
        src_lines.append([src_words[k] for k in ids])
        tgt_lines.append([tgt_words[k] for k in tids])
        bow = word_emb[ids].mean(axis=0)
        feats[i] = bow + img_noise * rng.standard_normal(img_dim).astype(np.float32)

    src_vocab = Vocab(SPECIALS + src_words)
    tgt_vocab = Vocab(SPECIALS + tgt_words)
    return src_lines, tgt_lines, feats, src_vocab, tgt_vocab


# ---------------------------------------------------------------------------
# Discriminative benchmark corpus (round-2 quality gate)
#
# The deterministic task above saturates at BLEU ~100, so it can confirm the
# pipeline learns but cannot *discriminate* — a 1-BLEU defect is invisible at
# saturation. This harder task is built so that:
#   - a per-sentence latent "sense" c makes a fraction of source word TYPES
#     genuinely ambiguous (their translation depends on c, which is NOT
#     recoverable from the source text) -> the text-only asymptote sits far
#     below the ceiling;
#   - the image feature encodes c (plus a bag-of-words summary), so a model
#     that routes decode-time image information through z (vmmt_c's
#     conditional prior) can resolve the ambiguity the text-only model can't;
#   - irreducible target-side token noise caps even the oracle below 100.
# `oracle_bleu_bounds` computes both asymptotes directly from the data so
# tests can assert the task is non-saturating by construction.
# ---------------------------------------------------------------------------

_STRIDE = 11  # sense offset in the target id space


def _sense_map(ids: np.ndarray, c: int, n_words: int, amb: np.ndarray) -> np.ndarray:
    """Per-token translation: affine remap + sense offset on ambiguous types."""
    return (ids * 7 + 3 + amb[ids] * (c * _STRIDE)) % n_words


def _local_reorder(tids: np.ndarray) -> np.ndarray:
    out = tids.copy()
    for j in range(0, len(out) - 1, 2):
        out[j], out[j + 1] = out[j + 1], out[j]
    return out


def make_ambiguous_corpus(
    n: int,
    vocab_size: int = 200,
    n_senses: int = 4,
    p_ambiguous: float = 0.5,
    tgt_noise: float = 0.15,
    min_len: int = 6,
    max_len: int = 24,
    img_dim: int = 512,
    sense_strength: float = 3.0,
    img_noise: float = 0.5,
    seed: int = 0,
    regions: int = 0,
):
    """Returns (src_lines, tgt_lines, feats, src_vocab, tgt_vocab, senses,
    amb_mask). ``senses``: (n,) int sense id per sentence; ``amb_mask``:
    (n_words,) 0/1 per source word type.

    ``regions > 0``: conv-style (n, R, img_dim) features — the sense signal
    lands in ONE random region, the other R-1 carry sense-scale distractor
    noise. Mean-pooling dilutes the signal by R and averages in the
    distractors; text-conditioned region attention (img_pool='attn') can
    learn to select the informative region. Built to DISCRIMINATE the two
    pooling modes, not just exercise their shapes."""
    rng = np.random.default_rng(seed)
    n_words = vocab_size - len(SPECIALS)
    src_words = [f"s{i}" for i in range(n_words)]
    tgt_words = [f"t{i}" for i in range(n_words)]
    amb = np.zeros(n_words, np.int64)
    amb[rng.permutation(n_words)[: int(round(p_ambiguous * n_words))]] = 1
    word_emb = rng.standard_normal((n_words, img_dim)).astype(np.float32)
    sense_emb = rng.standard_normal((n_senses, img_dim)).astype(np.float32)

    src_lines, tgt_lines = [], []
    feats = np.zeros((n, regions, img_dim) if regions > 0 else (n, img_dim),
                     np.float32)
    senses = rng.integers(0, n_senses, size=n)
    for i in range(n):
        L = int(rng.integers(min_len, max_len + 1))
        ids = rng.integers(0, n_words, size=L)
        tids = _local_reorder(_sense_map(ids, int(senses[i]), n_words, amb))
        # irreducible noise: some gold tokens are random (caps the ceiling)
        noise_pos = rng.random(L) < tgt_noise
        tids[noise_pos] = rng.integers(0, n_words, size=int(noise_pos.sum()))
        src_lines.append([src_words[k] for k in ids])
        tgt_lines.append([tgt_words[k] for k in tids])
        content = word_emb[ids].mean(axis=0)
        if regions > 0:
            r_star = int(rng.integers(regions))
            for r in range(regions):
                row = content + img_noise * rng.standard_normal(img_dim).astype(np.float32)
                if r == r_star:
                    row = row + sense_strength * sense_emb[int(senses[i])]
                else:
                    row = row + sense_strength * rng.standard_normal(img_dim).astype(np.float32)
                feats[i, r] = row
        else:
            feats[i] = (
                content
                + sense_strength * sense_emb[int(senses[i])]
                + img_noise * rng.standard_normal(img_dim).astype(np.float32)
            )
    src_vocab = Vocab(SPECIALS + src_words)
    tgt_vocab = Vocab(SPECIALS + tgt_words)
    return src_lines, tgt_lines, feats, src_vocab, tgt_vocab, senses, amb


# ---------------------------------------------------------------------------
# Stochastic corpus (round-4: the IW-ELBO model-selection instrument)
#
# The ambiguous corpus above is conditionally DETERMINISTIC: given (x, image)
# there is exactly one correct target, so held-out likelihood and BLEU rank
# models identically and the K-sample IW bound (SURVEY.md §2.4 config 5) has
# nothing to discriminate. This variant makes the target genuinely
# stochastic — the image shifts the target *distribution* without
# determining it:
#
#   c_img  ~ Uniform(S)                      (what the image depicts)
#   v      = content + strength·emb[c_img] + noise
#   c_real = c_img           with prob 1-flip
#          = Uniform(others) with prob flip   (the annotator "saw it
#                                              differently")
#   y      = sense_map(x, c_real)             (no token noise)
#
# The same (x, v) therefore has multiple valid targets; held-out NLL — not
# BLEU — is the honest discriminator, with ANALYTIC floors:
#   text-only models:  H(c_real | x)      = ln S        per ambiguous sent
#   image-aware models: H(c_real | c_img) = H(1-flip, flip/(S-1), ...)
# (sentences with no ambiguous type cost 0 extra nats for both). vmmt_c's
# conditional prior p(z|x,v) can route the image into p(y|x,v); nmt and
# vmmt_f (fixed prior: p(y|x) marginalizes z without seeing v) share the
# text-only floor.
# ---------------------------------------------------------------------------


def make_stochastic_corpus(
    n: int,
    vocab_size: int = 200,
    n_senses: int = 4,
    p_ambiguous: float = 0.5,
    sense_flip: float = 0.25,
    min_len: int = 6,
    max_len: int = 24,
    img_dim: int = 512,
    sense_strength: float = 3.0,
    img_noise: float = 0.5,
    seed: int = 0,
):
    """Returns (src_lines, tgt_lines, feats, src_vocab, tgt_vocab, c_img,
    c_real, amb_mask)."""
    rng = np.random.default_rng(seed)
    n_words = vocab_size - len(SPECIALS)
    src_words = [f"s{i}" for i in range(n_words)]
    tgt_words = [f"t{i}" for i in range(n_words)]
    amb = np.zeros(n_words, np.int64)
    amb[rng.permutation(n_words)[: int(round(p_ambiguous * n_words))]] = 1
    word_emb = rng.standard_normal((n_words, img_dim)).astype(np.float32)
    sense_emb = rng.standard_normal((n_senses, img_dim)).astype(np.float32)

    src_lines, tgt_lines = [], []
    feats = np.zeros((n, img_dim), np.float32)
    c_img = rng.integers(0, n_senses, size=n)
    flip = rng.random(n) < sense_flip
    c_real = c_img.copy()
    for i in np.flatnonzero(flip):
        others = [c for c in range(n_senses) if c != c_img[i]]
        c_real[i] = others[int(rng.integers(len(others)))]
    for i in range(n):
        L = int(rng.integers(min_len, max_len + 1))
        ids = rng.integers(0, n_words, size=L)
        tids = _local_reorder(_sense_map(ids, int(c_real[i]), n_words, amb))
        src_lines.append([src_words[k] for k in ids])
        tgt_lines.append([tgt_words[k] for k in tids])
        feats[i] = (word_emb[ids].mean(axis=0)
                    + sense_strength * sense_emb[int(c_img[i])]
                    + img_noise * rng.standard_normal(img_dim).astype(np.float32))
    src_vocab = Vocab(SPECIALS + src_words)
    tgt_vocab = Vocab(SPECIALS + tgt_words)
    return src_lines, tgt_lines, feats, src_vocab, tgt_vocab, c_img, c_real, amb


def stochastic_nll_floors(src_lines, amb, n_senses: int, sense_flip: float,
                          vocab_size: int = 200):
    """(text_floor, image_floor): analytic per-SENTENCE extra nats a perfect
    text-only / image-aware model must pay on this split (the deterministic
    part of the mapping costs 0 for a perfect model; EOS/len modeling is
    shared by both families and excluded).

    c_img is uniform and the flip is symmetric, so p(c_real | x) is uniform:
    the text-only floor is ln(S) per sense-revealing sentence. The image
    floor is H(c_real | c_img) = H(1-flip, flip/(S-1), ...).
    """
    n_words = vocab_size - len(SPECIALS)
    has_amb = np.array(
        [any(amb[int(t[1:])] for t in toks) for toks in src_lines], bool)
    frac = float(has_amb.mean())
    h_text = float(np.log(n_senses))
    p = np.full(n_senses, sense_flip / (n_senses - 1))
    p[0] = 1.0 - sense_flip
    h_img = float(-(p * np.log(p)).sum())
    return frac * h_text, frac * h_img


def ideal_hypotheses(src_lines, senses, amb, vocab_size=200, fixed_sense=None):
    """Noise-free model translations of ``src_lines``: with the TRUE sense
    (oracle / multimodal asymptote) or with a single ``fixed_sense`` (the
    consistent text-only asymptote — text alone cannot recover c)."""
    n_words = vocab_size - len(SPECIALS)
    tgt_words = [f"t{i}" for i in range(n_words)]
    out = []
    for i, toks in enumerate(src_lines):
        ids = np.asarray([int(t[1:]) for t in toks])
        c = int(senses[i]) if fixed_sense is None else int(fixed_sense)
        tids = _local_reorder(_sense_map(ids, c, n_words, amb))
        out.append([tgt_words[k] for k in tids])
    return out


def oracle_bleu_bounds(src_lines, tgt_lines, senses, amb, vocab_size=200):
    """(oracle_bleu, text_only_bleu): corpus BLEU of the true-sense and the
    best fixed-sense hypotheses against the (noisy) references. These bound
    what a perfectly-trained multimodal / text-only model can reach."""
    from variational_mmt_torch.evals.bleu import corpus_bleu

    refs = [[r] for r in tgt_lines]
    oracle = corpus_bleu(
        ideal_hypotheses(src_lines, senses, amb, vocab_size), refs
    )["bleu"]
    text = max(
        corpus_bleu(
            ideal_hypotheses(src_lines, senses, amb, vocab_size, fixed_sense=c),
            refs,
        )["bleu"]
        for c in range(int(np.max(senses)) + 1)
    )
    return oracle, text


def corrupt_targets(tgt_lines, frac, vocab_size=200, seed=0):
    """In-place label noise for the regularization-regime gate: each target
    token is replaced by a uniformly random target word with probability
    ``frac``. Applied to the TRAIN split only (callers keep valid/test
    clean), so clean-test BLEU measures resistance to memorizing noise —
    the regime where VMMT_F's latent + image-grounding losses matter
    (reference model1's headline gains are regularization-driven)."""
    rng = np.random.default_rng(seed)
    n_words = vocab_size - len(SPECIALS)
    n_flipped = 0
    for t in tgt_lines:
        for j in range(len(t)):
            if rng.random() < frac:
                t[j] = f"t{int(rng.integers(0, n_words))}"
                n_flipped += 1
    return n_flipped
