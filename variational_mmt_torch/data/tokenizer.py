"""Moses-style tokenization. A copy of ``tokenize`` and ``detokenize`` of
``variational_mmt_tpu/data/tokenizer.py`` (same rules, same output)."""

from __future__ import annotations

import re
from typing import List

# punctuation split off words; decimals and abbreviation dots stay attached
_RULES = [
    (re.compile(r"([\"“”„«»])"), r" \1 "),
    (re.compile(r"([,;:@#$%&!?()\[\]{}<>/\\|=+~*^])"), r" \1 "),
    (re.compile(r"(?<!\.)\.(\s|$)"), r" . \1"),
    (re.compile(r"'(s|m|d|ll|re|ve|t)\b", re.IGNORECASE), r" '\1"),
    (re.compile(r"(?<=\w)'(?=\s|$)"), r" '"),
    (re.compile(r"\s-\s"), r" - "),
]
_WS = re.compile(r"\s+")


def tokenize(line: str, lower: bool = True) -> List[str]:
    s = line.strip()
    if lower:
        s = s.lower()
    for pat, repl in _RULES:
        s = pat.sub(repl, s)
    s = _WS.sub(" ", s).strip()
    return s.split(" ") if s else []


def detokenize(tokens: List[str]) -> str:
    """Roughly the inverse of :func:`tokenize`, for human-readable output
    (BLEU is computed on tokenized text)."""
    out = " ".join(tokens)
    out = re.sub(r"\s+([,.;:!?)\]}])", r"\1", out)
    out = re.sub(r"([(\[{])\s+", r"\1", out)
    return re.sub(r"\s+'", r"'", out)
