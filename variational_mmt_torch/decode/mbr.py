"""Minimum-Bayes-risk (MBR) decoding over sampled hypotheses.

The port's copy of ``variational_mmt_tpu/decode/mbr.py``: the same
selection, over the port's ``Translator.dispatch_ids`` and
``finalize_ids`` (each batch's search runs on the translator's device
thread, so pass k+1 runs on the device while pass k is finalized). With
``-pallas_step`` 1 or 2 on the card every sampling step runs the
decode-step or GRU-chain kernel.

Beyond-reference (the upstream fork decodes by beam search only, SURVEY.md
§2.1 #14/#15), but a natural extension of THIS model family: the paper's
variational decoder defines a distribution over translations, and the
round-4 sampling decode (ops/beam.py::sampling_search, -sampling_temp) plus
decode-time latent sampling (-latent_from sample) draw from it. MBR picks,
among N such draws, the hypothesis with the highest expected utility under
the model's own sample distribution:

    y* = argmax_{y in samples}  (1/N) sum_{y' in samples} BLEU(y; y')

— the consensus translation. This repairs sampling's variance (a single
sample is noisy; the consensus is competitive with search) while keeping
sampling's calibration (candidates come from the model distribution, not
from the argmax ridge the beam walks).

Device/host split: the N corpus samples are N dispatches of the same
sampling search with seeds ``seed + k * SEED_STRIDE``, two passes in
flight; the O(N^2) pairwise sentence-BLEU runs on the host over token-id
tuples (N <= ~50, microseconds per sentence).
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence, Tuple

import numpy as np

from variational_mmt_torch.evals.bleu import sentence_bleu

# seed stride between the N samples of one MBR decode: the stride keeps a
# user's -seed and -seed+1 runs from sharing any per-sample streams
SEED_STRIDE = 7919


def mbr_select(
    candidates: Sequence[Sequence[int]],
    scores: Optional[Sequence[float]] = None,
) -> Tuple[int, List[float]]:
    """Pick the consensus candidate: argmax of the Monte-Carlo expected
    utility ``u(c) = (1/N) sum_s sentence_bleu(c, s)`` over ALL samples
    (duplicates count — a hypothesis the model drew twice is evidence, so
    pairwise terms are weighted by multiplicity, including the self term).
    Ties break by model ``scores`` (if given), then by sample order.
    Returns (best index into ``candidates``, per-candidate utilities)."""
    n = len(candidates)
    if n == 0:
        raise ValueError("mbr_select: empty candidate list")
    keys = [tuple(c) for c in candidates]
    counts = Counter(keys)
    uniq = list(counts)
    # pairwise utility over UNIQUE hypotheses, weighted by multiplicity
    # (sentence_bleu is not symmetric — BP and counts follow the first
    # argument — so the full u x u' grid is computed, not a triangle)
    util_u = {
        u: sum(w * sentence_bleu(u, v) for v, w in counts.items()) / n
        for u in uniq
    }
    utils = [util_u[k] for k in keys]
    best = 0
    for i in range(1, n):
        if utils[i] > utils[best] + 1e-9:
            best = i
        elif abs(utils[i] - utils[best]) <= 1e-9 and scores is not None \
                and scores[i] > scores[best] + 1e-12:
            best = i
    return best, utils


def mbr_translate_ids(
    translator,
    src_ids: List[List[int]],
    img_feats: Optional[np.ndarray] = None,
    n_samples: int = 10,
    seed: Optional[int] = None,
) -> List[List[Tuple[float, List[int]]]]:
    """N sampled decodes of the corpus + per-sentence consensus selection.

    ``translator`` must be a sampling Translator (dcfg.sampling_temp > 0,
    so each decode returns exactly one hypothesis per sentence).  Returns
    the same n-best-list-of-1 shape as ``Translator.translate_ids`` —
    ``[(model_score, token_ids)]`` per sentence, where the score is the raw
    model log-prob of the CHOSEN sample (force-decode reproducible) — so
    the CLI's downstream reporting works unchanged."""
    if n_samples < 1:
        raise ValueError(f"mbr: n_samples must be >= 1, got {n_samples}")
    if translator.dcfg.sampling_temp <= 0.0:
        raise ValueError(
            "mbr decode samples the model: set sampling_temp > 0 "
            "(optionally with sampling_topk/topp truncation)")
    base = translator.dcfg.decode_seed if seed is None else seed
    # two corpus passes in flight: pass k finalizes on the host while pass
    # k+1's batches run on the device thread (sampling outputs are only
    # (B, L) tokens and scores)
    outs: List[list] = []
    ahead = translator.dispatch_ids(src_ids, img_feats, seed=base)
    for k in range(n_samples):
        cur = ahead
        if k + 1 < n_samples:
            ahead = translator.dispatch_ids(
                src_ids, img_feats, seed=base + (k + 1) * SEED_STRIDE)
        outs.append(translator.finalize_ids(cur))
    results = []
    for i in range(len(src_ids)):
        cands = [outs[k][i][0][1] for k in range(n_samples)]
        scores = [outs[k][i][0][0] for k in range(n_samples)]
        best, _ = mbr_select(cands, scores)
        results.append([(scores[best], cands[best])])
    return results
