"""Byte-pair encoding: applying learned merges, and undoing them. Mirrors
``BPE`` (``load``, ``segment``) and ``remove_bpe`` of
``variational_mmt_tpu/data/bpe.py`` on its pure-Python path (the C++
segmenter ``native/bpe.cpp`` is not carried over; its output is the same).
Learning merges stays with the JAX package's preprocess CLI.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

EOW = "</w>"
SEP = "@@"
_NO_MERGE = 1 << 60


class BPE:
    """Greedy lowest-rank merges inside each word, with ``@@`` marking
    every piece but a word's last."""

    def __init__(self, merges: Sequence[Tuple[str, str]]):
        self.merges = list(merges)
        self.ranks = {pair: i for i, pair in enumerate(self.merges)}
        self._cache: Dict[str, List[str]] = {}

    def segment_word(self, word: str) -> List[str]:
        if not word:
            return []
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        symbols = list(word[:-1]) + [word[-1] + EOW]
        while len(symbols) > 1:
            rank, idx = min((self.ranks.get(pair, _NO_MERGE), i)
                            for i, pair in enumerate(zip(symbols, symbols[1:])))
            if rank >= _NO_MERGE:
                break
            symbols = symbols[:idx] + [symbols[idx] + symbols[idx + 1]] + symbols[idx + 2:]
        out: List[str] = []
        for s in symbols:
            if s.endswith(EOW):
                if s[:-len(EOW)]:
                    out.append(s[:-len(EOW)])
            else:
                out.append(s + SEP)
        self._cache[word] = out
        return out

    def segment(self, tokens: Sequence[str]) -> List[str]:
        return [piece for t in tokens for piece in self.segment_word(t)]

    @classmethod
    def load(cls, path: str) -> "BPE":
        """A codes file: one ``a b`` merge a line, after an optional
        ``#version`` header (a merge itself may start with '#')."""
        merges: List[Tuple[str, str]] = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                if line.startswith("#version"):
                    continue
                parts = line.rstrip("\n").split(" ")
                if len(parts) == 2:
                    merges.append((parts[0], parts[1]))
        return cls(merges)


def remove_bpe(tokens: Sequence[str]) -> List[str]:
    """Undo @@-segmentation (the ``sed 's/@@ //g'`` of the reference eval)."""
    out: List[str] = []
    buf = ""
    for t in tokens:
        if t.endswith(SEP):
            buf += t[: -len(SEP)]
        else:
            out.append(buf + t)
            buf = ""
    if buf:
        out.append(buf)
    return out
