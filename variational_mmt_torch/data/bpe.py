"""Byte-pair encoding: learning merges, applying them, and undoing them.
Mirrors ``learn_bpe`` (:20-76), ``BPE`` (``save``, ``load``, ``segment``)
and ``remove_bpe`` of ``variational_mmt_tpu/data/bpe.py``. ``BPE``
segments through the C++ segmenter (``native/bpe.cpp``, :83-106) when the
native library is available, else through the Python loop; both give the
same pieces. ``cli/preprocess.py`` learns the codes.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Sequence, Tuple

from variational_mmt_torch import native

EOW = "</w>"
SEP = "@@"
_NO_MERGE = 1 << 60


def learn_bpe(lines: Iterable[Sequence[str]], num_merges: int,
              min_freq: int = 2) -> List[Tuple[str, str]]:
    """Merges learned from tokenized lines: each round merges the most
    frequent adjacent symbol pair (ties to the larger pair), until
    ``num_merges`` rounds or no pair occurs ``min_freq`` times. Pair
    counts are updated only in the words that hold the merged pair."""
    word_freq: Dict[Tuple[str, ...], int] = collections.Counter()
    for toks in lines:
        for w in toks:
            word_freq[tuple(w[:-1]) + (w[-1] + EOW,)] += 1
    pair_freq: Dict[Tuple[str, str], int] = collections.Counter()
    pair_words: Dict[Tuple[str, str], set] = collections.defaultdict(set)
    words = list(word_freq.items())
    for wi, (word, freq) in enumerate(words):
        for pair in zip(word, word[1:]):
            pair_freq[pair] += freq
            pair_words[pair].add(wi)
    merges: List[Tuple[str, str]] = []
    for _ in range(num_merges):
        if not pair_freq:
            break
        pair, freq = max(pair_freq.items(), key=lambda kv: (kv[1], kv[0]))
        if freq < min_freq:
            break
        merges.append(pair)
        new_sym = pair[0] + pair[1]
        for wi in list(pair_words[pair]):
            word, wfreq = words[wi]
            merged = _merge_word(word, pair, new_sym)
            if merged == word:
                continue
            for old in zip(word, word[1:]):
                pair_freq[old] -= wfreq
                if pair_freq[old] <= 0:
                    del pair_freq[old]
                pair_words[old].discard(wi)
            for new in zip(merged, merged[1:]):
                pair_freq[new] += wfreq
                pair_words[new].add(wi)
            words[wi] = (merged, wfreq)
        pair_freq.pop(pair, None)
        pair_words.pop(pair, None)
    return merges


def _merge_word(word: Tuple[str, ...], pair: Tuple[str, str], new_sym: str) -> Tuple[str, ...]:
    """``word`` with every non-overlapping ``pair``, left to right, joined."""
    out: List[str] = []
    i = 0
    while i < len(word):
        if i < len(word) - 1 and word[i] == pair[0] and word[i + 1] == pair[1]:
            out.append(new_sym)
            i += 2
        else:
            out.append(word[i])
            i += 1
    return tuple(out)


class BPE:
    """Greedy lowest-rank merges inside each word, with ``@@`` marking
    every piece but a word's last. ``use_native``: segment in C++ when
    ``native.available()``. Segmented words are cached."""

    def __init__(self, merges: Sequence[Tuple[str, str]], use_native: bool = True):
        self.merges = list(merges)
        self.ranks = {pair: i for i, pair in enumerate(self.merges)}
        self._cache: Dict[str, List[str]] = {}
        # the pairs in rank order: a repeated pair ranks as its last copy
        # here, and would rank as its first in the C++ table
        self._native = (native.NativeBPE(sorted(self.ranks, key=self.ranks.get))
                        if use_native and native.available() else None)

    def segment_word(self, word: str) -> List[str]:
        if not word:
            return []
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        if self._native is not None:
            out = self._native.segment_word(word)
            self._cache[word] = out
            return out
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

    def save(self, path: str) -> None:
        """A codes file ``load`` (and JAX's ``BPE.load``) reads back."""
        with open(path, "w", encoding="utf-8") as f:
            f.write("#version: vmmt-tpu bpe\n")
            f.writelines(f"{a} {b}\n" for a, b in self.merges)

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
