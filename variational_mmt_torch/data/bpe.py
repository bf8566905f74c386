"""BPE post-processing. Mirrors ``remove_bpe`` of
``variational_mmt_tpu/data/bpe.py`` (learning and applying BPE are not
ported yet)."""

from __future__ import annotations

from typing import List, Sequence

SEP = "@@"


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
