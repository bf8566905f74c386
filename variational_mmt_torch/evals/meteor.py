"""METEOR with the meteor-1.5 scoring structure.

A copy of ``variational_mmt_tpu/evals/meteor.py`` for the port, which
imports nothing of the JAX package; tests/test_torch_meteor.py holds its
scores equal to the original's to the last bit.

The reference reports METEOR via the external Java meteor-1.5 jar
(SURVEY.md §2.1 #16), which this environment cannot ship (no egress).
This implements the meteor-1.5 *architecture* (Denkowski & Lavie 2014)
natively:

- matcher stages in module order: exact, Porter stem, synonym, paraphrase.
  The synonym/paraphrase stages are load-if-present hooks (``load_table``)
  — WordNet / the paraphrase tables cannot ship here, so they default to
  empty (making those stages no-ops) and activate when the user provides
  table files in meteor's one-mapping-per-line format;
- one-to-one alignment maximizing matches and then MINIMIZING CHUNKS
  (meteor's Aligner semantics) — solved EXACTLY by a budgeted bitmask DP
  (optimal on every realistic sentence; property-tested against the
  objective in tests/test_meteor_aligner.py), with meteor-style BEAM
  search as the fallback for adversarial repeated-word blowups. A greedy
  left-to-right matcher would change both the match set and the
  fragmentation penalty; the jar's beam-limited aligner is itself
  measurably suboptimal on dense-match sentences;
- weighted precision/recall with per-module weights and the
  content/function-word distinction (delta);
- Pen = gamma * (chunks / matches)^beta; score = (1 - Pen) * Fmean.

Parameter presets:
- ``"original"`` (default): alpha=0.9, beta=3.0, gamma=0.5, delta=1 —
  Lavie & Agarwal 2007, exactly verifiable by hand (tests do);
- ``"1.5-en"``: alpha=0.85, beta=0.2, gamma=0.6, delta=0.75 with module
  weights (1.0, 0.6, 0.8, 0.6) — the recalled meteor-1.5 English tuning.
  UNVERIFIED against the jar in this environment (zero egress); validate
  against meteor-1.5 output before citing scores as paper-comparable.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from variational_mmt_torch.evals.porter import stem

# a standard small English function-word list (meteor-1.5 ships a
# corpus-derived one; hook: pass your own set to MeteorScorer)
_DEFAULT_FUNCTION_WORDS = {
    "a", "an", "the", "and", "or", "but", "if", "of", "at", "by", "for",
    "with", "about", "to", "from", "in", "on", "is", "am", "are", "was",
    "were", "be", "been", "being", "it", "its", "this", "that", "these",
    "those", "as", "not", "no", "so", "than", "too", "very", "can", "will",
    "just", "do", "does", "did", "has", "have", "had", "he", "she", "they",
    "we", "you", "i", "his", "her", "their", "our", "your", "my",
}

_PRESETS = {
    # delta=0.5 weights content and function words equally (the 2007 scorer
    # has no content/function distinction; the 0.5/0.5 split cancels out)
    "original": dict(alpha=0.9, beta=3.0, gamma=0.5, delta=0.5,
                     weights=(1.0, 1.0, 1.0, 1.0)),
    "1.5-en": dict(alpha=0.85, beta=0.2, gamma=0.6, delta=0.75,
                   weights=(1.0, 0.6, 0.8, 0.6)),
}

BEAM = 40  # fallback-aligner beam width (meteor's own aligner is beam-limited)
# exact-aligner memo budget: ~60ms worst case; real sentences use a few
# hundred states, so the beam fallback only fires on adversarial
# repeated-word blowups (tests measure the beam's divergence there)
EXACT_STATE_BUDGET = 200_000


class _ExactBudgetExceeded(Exception):
    pass


def load_table(path: str) -> Dict[str, Set[str]]:
    """Load a synonym/paraphrase table: one ``word<TAB>alt1 alt2 ...`` (or
    ``word alt``) mapping per line. The hook meteor-1.5 fills from WordNet /
    its paraphrase DBs."""
    table: Dict[str, Set[str]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").replace("\t", " ").split()
            if len(parts) < 2:
                continue
            table.setdefault(parts[0], set()).update(parts[1:])
    return table


class MeteorScorer:
    def __init__(
        self,
        preset: str = "original",
        synonyms: Optional[Dict[str, Set[str]]] = None,
        paraphrases: Optional[Dict[str, Set[str]]] = None,
        function_words: Optional[Set[str]] = None,
        **overrides,
    ):
        p = dict(_PRESETS[preset])
        p.update(overrides)
        self.alpha = p["alpha"]
        self.beta = p["beta"]
        self.gamma = p["gamma"]
        self.delta = p["delta"]
        self.weights = p["weights"]
        self.syn = synonyms or {}
        self.para = paraphrases or {}
        self.fwords = (
            function_words if function_words is not None else _DEFAULT_FUNCTION_WORDS
        )

    # -- matching ------------------------------------------------------
    def _match_module(self, h: str, r: str, hs: str, rs: str) -> int:
        """Lowest matching module index for (hyp word, ref word), -1 if none.
        Module order: 0 exact, 1 stem, 2 synonym, 3 paraphrase."""
        if h == r:
            return 0
        if hs == rs:
            return 1
        if r in self.syn.get(h, ()) or h in self.syn.get(r, ()):
            return 2
        if r in self.para.get(h, ()) or h in self.para.get(r, ()):
            return 3
        return -1

    def _cands(self, hyp: List[str], ref: List[str]) -> List[List[Tuple[int, int]]]:
        """Per-hyp-position candidate (ref_idx, module) matches."""
        hst = [stem(h) for h in hyp]
        rst = [stem(r) for r in ref]
        cands: List[List[Tuple[int, int]]] = []
        for i, h in enumerate(hyp):
            row = []
            for j, r in enumerate(ref):
                mod = self._match_module(h, r, hst[i], rst[j])
                if mod >= 0:
                    row.append((j, mod))
            cands.append(row)
        return cands

    def _align(self, hyp: List[str], ref: List[str]) -> List[Tuple[int, int, int]]:
        """One-to-one alignment maximizing matches, then minimizing chunks,
        then the match-module sum (meteor's Aligner objective). Returns
        [(hyp_idx, ref_idx, module)] sorted by hyp_idx.

        Exact bitmask-DP first (optimal; the state budget covers all
        realistic sentences — tests/test_meteor_aligner.py bounds it); the
        BEAM=40 search is the fallback for adversarial repeated-word blowups.
        meteor-1.5's own aligner is beam-limited everywhere, so this is
        strictly closer to the objective than the jar."""
        matches = self._align_exact(hyp, ref, budget=EXACT_STATE_BUDGET)
        if matches is None:
            matches = self._align_beam(hyp, ref)
        return matches

    def _align_exact(
        self, hyp: List[str], ref: List[str], budget: Optional[int] = None
    ) -> Optional[List[Tuple[int, int, int]]]:
        """Exact DP over (hyp position, used-ref bitmask, ref index matched
        at the previous hyp position); None when the memo would exceed
        ``budget`` states (caller falls back to the beam)."""
        cands = self._cands(hyp, ref)
        n = len(hyp)
        memo: Dict[Tuple[int, int, int], Tuple[int, int, int]] = {}
        moves: Dict[Tuple[int, int, int], Optional[Tuple[int, int]]] = {}

        def rec(i: int, used: int, prev_j: int) -> Tuple[int, int, int]:
            """Best (-matches, chunks, mod_sum) from position i (minimized
            lexicographically — the same key the beam sorts on)."""
            if i == n:
                return (0, 0, 0)
            key = (i, used, prev_j)
            hit = memo.get(key)
            if hit is not None:
                return hit
            if budget is not None and len(memo) >= budget:
                raise _ExactBudgetExceeded
            best = rec(i + 1, used, -1)  # skip hyp[i]
            best_move: Optional[Tuple[int, int]] = None
            for j, mod in cands[i]:
                if used >> j & 1:
                    continue
                negm, ch, ms = rec(i + 1, used | (1 << j), j)
                cand = (negm - 1,
                        ch + (0 if prev_j >= 0 and j == prev_j + 1 else 1),
                        ms + mod)
                if cand < best:
                    best, best_move = cand, (j, mod)
            memo[key] = best
            moves[key] = best_move
            return best

        try:
            rec(0, 0, -1)
        except _ExactBudgetExceeded:
            return None
        out: List[Tuple[int, int, int]] = []
        i, used, prev_j = 0, 0, -1
        while i < n:
            mv = moves.get((i, used, prev_j))
            if mv is None:
                i, prev_j = i + 1, -1
            else:
                j, mod = mv
                out.append((i, j, mod))
                used |= 1 << j
                i, prev_j = i + 1, j
        return out

    def _align_beam(self, hyp: List[str], ref: List[str]) -> List[Tuple[int, int, int]]:
        """Beam search over one-to-one alignments (fallback for sentences
        whose exact-DP state space exceeds the budget)."""
        cands = self._cands(hyp, ref)

        # beam state: (-matches, chunks, mod_sum, used_ref frozenset,
        #              last (i, j) or None, matches tuple)
        beams = [(0, 0, 0, frozenset(), None, ())]
        for i in range(len(hyp)):
            nxt = []
            for (negm, ch, ms, used, last, matches) in beams:
                nxt.append((negm, ch, ms, used, last, matches))  # skip i
                for (j, mod) in cands[i]:
                    if j in used:
                        continue
                    contiguous = last is not None and i == last[0] + 1 and j == last[1] + 1
                    nch = ch if contiguous else ch + 1
                    nxt.append((
                        negm - 1, nch, ms + mod, used | {j}, (i, j),
                        matches + ((i, j, mod),),
                    ))
            nxt.sort(key=lambda s: (s[0], s[1], s[2]))
            beams = nxt[:BEAM]
        return list(beams[0][5])

    def _align_exact_key(self, hyp: List[str], ref: List[str]) -> Tuple[int, int, int]:
        """Objective value of the (unbudgeted) exact alignment — the
        optimum the tests bound the production aligner against."""
        return self._align_key(self._align_exact(hyp, ref))

    def _align_key(self, matches: List[Tuple[int, int, int]]) -> Tuple[int, int, int]:
        """The beam objective value of an alignment, comparable with
        :meth:`_align_exact_key`."""
        return (len(matches), self._chunks(matches), sum(m for _, _, m in matches))

    # -- scoring -------------------------------------------------------
    def _score_from_stats(self, st: Dict[str, float]) -> float:
        """score = (1 - gamma*(ch/m)^beta) * P*R/(alpha*P + (1-alpha)*R)."""
        if st["m"] == 0 or st["w_hyp"] == 0 or st["w_ref"] == 0:
            return 0.0
        p = st["wm_hyp"] / st["w_hyp"]
        r = st["wm_ref"] / st["w_ref"]
        if p == 0 or r == 0:
            return 0.0
        f_mean = p * r / (self.alpha * p + (1 - self.alpha) * r)
        frag = st["chunks"] / st["m"]
        return f_mean * (1.0 - self.gamma * (frag ** self.beta))

    def _best_stats(
        self, hyp: Sequence[str], refs: Sequence[Sequence[str]]
    ) -> Dict[str, float]:
        """Alignment statistics against the best-scoring reference (meteor
        scores each segment against every ref and keeps the best)."""
        zero = dict(wm_hyp=0.0, wm_ref=0.0, w_hyp=0.0, w_ref=0.0, chunks=0, m=0)
        best, best_score = zero, -1.0
        hyp = [h.lower() for h in hyp]
        d = self.delta

        def weight_of(tok: str) -> float:
            return d if tok not in self.fwords else (1.0 - d)

        for ref in refs:
            ref = [r.lower() for r in ref]
            if not ref:
                continue
            # an EMPTY hypothesis still counts its reference in the recall
            # denominator (meteor-1.5 semantics) — skipping it would inflate
            # the micro-averaged corpus score
            matches = self._align(hyp, ref) if hyp else []
            st = dict(
                wm_hyp=sum(self.weights[mod] * weight_of(hyp[i]) for i, _, mod in matches),
                wm_ref=sum(self.weights[mod] * weight_of(ref[j]) for _, j, mod in matches),
                w_hyp=sum(weight_of(t) for t in hyp),
                w_ref=sum(weight_of(t) for t in ref),
                chunks=self._chunks(matches),
                m=len(matches),
            )
            s = self._score_from_stats(st)
            if s > best_score:
                best, best_score = st, s
        return best

    def sentence(self, hyp: Sequence[str], refs: Sequence[Sequence[str]]) -> float:
        return max(0.0, self._score_from_stats(self._best_stats(hyp, refs)))

    @staticmethod
    def _chunks(matches: List[Tuple[int, int, int]]) -> int:
        if not matches:
            return 0
        ms = sorted((i, j) for i, j, _ in matches)
        chunks = 1
        for (i1, j1), (i2, j2) in zip(ms, ms[1:]):
            if not (i2 == i1 + 1 and j2 == j1 + 1):
                chunks += 1
        return chunks

    def corpus(
        self,
        hypotheses: Sequence[Sequence[str]],
        references: Sequence[Sequence[Sequence[str]]],
    ) -> Dict[str, float]:
        """System score from AGGREGATED statistics (micro-average), exactly
        as meteor-1.5 computes it — the mean of sentence scores (also
        returned, as ``meteor_macro``) is a different, non-comparable
        number."""
        if len(hypotheses) != len(references):
            # zip would silently truncate to the shorter list and publish a
            # valid-looking score over the wrong segment count
            raise ValueError(
                f"{len(hypotheses)} hypotheses vs {len(references)} "
                "reference lists")
        agg = dict(wm_hyp=0.0, wm_ref=0.0, w_hyp=0.0, w_ref=0.0, chunks=0, m=0)
        sent_scores = []
        for h, r in zip(hypotheses, references):
            st = self._best_stats(h, r)
            sent_scores.append(max(0.0, self._score_from_stats(st)))
            for k in agg:
                agg[k] += st[k]
        return {
            "meteor": 100.0 * max(0.0, self._score_from_stats(agg)),
            "meteor_macro": 100.0 * (sum(sent_scores) / max(1, len(sent_scores))),
        }


# -- module-level API (back-compat with round-1 callers) ----------------
def meteor_sentence(hyp, refs, alpha: float = 0.9, beta: float = 3.0,
                    gamma: float = 0.5) -> float:
    return MeteorScorer("original", alpha=alpha, beta=beta, gamma=gamma).sentence(hyp, refs)


def meteor_score(hypotheses, references, preset: str = "original",
                 **kw) -> Dict[str, float]:
    return MeteorScorer(preset, **kw).corpus(hypotheses, references)
