"""Vocabulary with the reference's special-token contract.

Mirrors ``variational_mmt_tpu/data/vocab.py``: ids 0..3 are
<blank>/<unk>/<s>/</s>, so padding is id 0; ``build`` orders the types by
frequency, then lexicographically (:46-68).
"""

from __future__ import annotations

import collections
import json
from typing import Dict, Iterable, List, Sequence

from variational_mmt_torch.data.bpe import remove_bpe

PAD, UNK, BOS, EOS = 0, 1, 2, 3
PAD_TOK, UNK_TOK, BOS_TOK, EOS_TOK = "<blank>", "<unk>", "<s>", "</s>"
SPECIALS = [PAD_TOK, UNK_TOK, BOS_TOK, EOS_TOK]


class Vocab:
    def __init__(self, itos: List[str]):
        if list(itos[:4]) != SPECIALS:
            raise ValueError("specials must occupy ids 0..3")
        self.itos = list(itos)
        self.stoi: Dict[str, int] = {s: i for i, s in enumerate(self.itos)}

    def __len__(self) -> int:
        return len(self.itos)

    def __contains__(self, tok: str) -> bool:
        return tok in self.stoi

    def pad_to_multiple(self, m: int) -> None:
        """Append inert filler types ``<vpadI>`` until len(vocab) % m == 0
        (a vocab sharded over m devices; the fillers never occur in data)."""
        i = 0
        while len(self.itos) % m != 0:
            while f"<vpad{i}>" in self.stoi:
                i += 1
            tok = f"<vpad{i}>"
            self.stoi[tok] = len(self.itos)
            self.itos.append(tok)
            i += 1

    @classmethod
    def build(cls, lines: Iterable[Sequence[str]], max_size: int = 0,
              min_freq: int = 1) -> "Vocab":
        """The specials, then the types of ``lines`` seen at least
        ``min_freq`` times, most frequent first (ties lexicographic), at
        most ``max_size`` of them (0: all)."""
        counter = collections.Counter()
        for toks in lines:
            counter.update(toks)
        itos = list(SPECIALS)
        for tok, freq in sorted(counter.items(), key=lambda kv: (-kv[1], kv[0])):
            if freq < min_freq:
                continue
            if max_size and len(itos) >= max_size + len(SPECIALS):
                break
            if tok not in SPECIALS:
                itos.append(tok)
        return cls(itos)

    def encode(self, tokens: Sequence[str], bos: bool = False, eos: bool = False) -> List[int]:
        ids = [self.stoi.get(t, UNK) for t in tokens]
        return ([BOS] if bos else []) + ids + ([EOS] if eos else [])

    def decode(self, ids: Sequence[int], strip_special: bool = True) -> List[str]:
        """Ids -> tokens; ``strip_special`` stops at EOS and drops PAD and
        BOS."""
        out = []
        for i in map(int, ids):
            if strip_special:
                if i == EOS:
                    break
                if i in (PAD, BOS):
                    continue
            out.append(self.itos[i] if 0 <= i < len(self.itos) else UNK_TOK)
        return out

    def ids_to_text(self, ids: Sequence[int], debpe: bool = True) -> str:
        """Hypothesis ids -> text: vocab decode (specials kept), then
        BPE-joiner removal."""
        toks = [self.itos[i] if 0 <= i < len(self.itos) else UNK_TOK for i in map(int, ids)]
        return " ".join(remove_bpe(toks) if debpe else toks)

    def save(self, path: str) -> None:
        """The itos list as JSON (JAX vocab.py:102-104)."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.itos, f, ensure_ascii=False)

    @classmethod
    def load(cls, path: str) -> "Vocab":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    def to_list(self) -> List[str]:
        return list(self.itos)
