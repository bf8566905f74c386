"""Corpus BLEU, multi-bleu.perl-compatible.

A copy of ``variational_mmt_tpu/evals/bleu.py`` for the port, which
imports nothing of the JAX package; tests/test_torch_gate.py holds its
scores equal to the original's.

The reference evaluates with ``tools/multi-bleu.perl`` on tokenized text
(SURVEY.md §2.1 #16). This is the same metric in pure Python: corpus-level
modified n-gram precision up to 4-grams, geometric mean, brevity penalty,
closest-reference length, no smoothing — so scores are directly comparable
to reference-reported numbers.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, Sequence, Tuple


def _ngrams(tokens: Sequence[str], n: int) -> Dict[Tuple[str, ...], int]:
    out: Dict[Tuple[str, ...], int] = collections.Counter()
    for i in range(len(tokens) - n + 1):
        out[tuple(tokens[i : i + n])] += 1
    return out


def corpus_bleu(
    hypotheses: Sequence[Sequence[str]],
    references: Sequence[Sequence[Sequence[str]]],
    max_n: int = 4,
) -> Dict[str, float]:
    """hypotheses: list of token lists; references: per-hypothesis list of
    reference token lists. Returns {'bleu', 'precisions', 'bp', ...} with
    bleu in [0, 100] like multi-bleu.perl."""
    assert len(hypotheses) == len(references)
    match = [0] * max_n
    total = [0] * max_n
    hyp_len = 0
    ref_len = 0
    for i, (hyp, refs) in enumerate(zip(hypotheses, references)):
        if not refs:
            raise ValueError(f"sentence {i}: empty reference list")
        hyp = list(hyp)
        hyp_len += len(hyp)
        # closest reference length (ties -> shorter), multi-bleu semantics
        ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            hyp_ng = _ngrams(hyp, n)
            if not hyp_ng:
                continue
            max_ref: Dict[Tuple[str, ...], int] = collections.Counter()
            for r in refs:
                for ng, c in _ngrams(list(r), n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            total[n - 1] += sum(hyp_ng.values())
            match[n - 1] += sum(min(c, max_ref.get(ng, 0)) for ng, c in hyp_ng.items())

    precisions = [(m / t if t else 0.0) for m, t in zip(match, total)]
    if min(precisions) > 0:
        log_p = sum(math.log(p) for p in precisions) / max_n
        geo = math.exp(log_p)
    else:
        geo = 0.0
    bp = 1.0 if hyp_len >= ref_len else math.exp(1.0 - ref_len / max(1, hyp_len))
    return {
        "bleu": 100.0 * geo * bp,
        "precisions": [100.0 * p for p in precisions],
        "bp": bp,
        "hyp_len": hyp_len,
        "ref_len": ref_len,
        "ratio": hyp_len / max(1, ref_len),
    }


def sentence_bleu(
    hyp: Sequence, ref: Sequence, max_n: int = 4, smooth: float = 1.0
) -> float:
    """Smoothed sentence-level BLEU in [0, 100] (add-``smooth`` on the n>1
    precision counts — Lin & Och's smoothing-1, the standard MBR utility).
    Tokens may be any hashables (strings or token ids). Corpus reporting
    stays :func:`corpus_bleu` (unsmoothed, multi-bleu semantics); this is
    for per-sentence similarity, where unsmoothed BLEU is 0 almost always."""
    hyp, ref = list(hyp), list(ref)
    if not hyp or not ref:
        return 0.0
    log_p = 0.0
    for n in range(1, max_n + 1):
        hyp_ng = _ngrams(hyp, n)
        total = sum(hyp_ng.values())
        ref_ng = _ngrams(ref, n)
        match = sum(min(c, ref_ng.get(ng, 0)) for ng, c in hyp_ng.items())
        if n == 1:
            if match == 0:
                return 0.0  # no unigram overlap: BLEU is exactly 0
            p = match / total
        elif total == 0:
            # hypothesis shorter than n: treat the missing order as a pure
            # smoothing term so short hypotheses still compare smoothly
            p = smooth / (smooth + 1.0)
        else:
            p = (match + smooth) / (total + smooth)
        log_p += math.log(p)
    bp = 1.0 if len(hyp) >= len(ref) else math.exp(1.0 - len(ref) / len(hyp))
    return 100.0 * bp * math.exp(log_p / max_n)


def bleu_from_files(hyp_path: str, ref_paths: List[str]) -> Dict[str, float]:
    with open(hyp_path, encoding="utf-8") as f:
        hyps = [line.split() for line in f]
    all_refs: List[List[List[str]]] = []
    ref_lines = []
    for p in ref_paths:
        with open(p, encoding="utf-8") as f:
            ref_lines.append([line.split() for line in f])
    for i in range(len(hyps)):
        all_refs.append([r[i] for r in ref_lines])
    return corpus_bleu(hyps, all_refs)
