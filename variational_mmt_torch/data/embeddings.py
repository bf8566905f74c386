"""Pretrained word vectors for ``-pre_word_vecs_enc`` / ``-pre_word_vecs_dec``.
Mirrors ``variational_mmt_tpu/data/embeddings.py``: ``read_text_embeddings``
(:19, GloVe or word2vec text), ``align_to_vocab`` (:55, the vocab-aligned
table a ``.npy`` holds) and ``apply_pretrained`` (:95-105: the table
replaces a model's embedding table, and a shape that differs is an error,
since the table was built against another vocab or width)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from variational_mmt_torch.models.model import VMMTModel


def read_text_embeddings(path: str) -> Dict[str, np.ndarray]:
    """{token: f32 vector} from GloVe or word2vec text (a ``<count> <dim>``
    first line is the word2vec header). Lines with another field count or
    a field that is not a number are skipped."""
    vecs: Dict[str, np.ndarray] = {}
    dim = None
    with open(path, encoding="utf-8", errors="replace") as f:
        parts = f.readline().rstrip("\n").split(" ")
        if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
            dim = int(parts[1])
        elif len(parts) >= 2:
            try:
                vecs[parts[0]] = np.asarray([float(x) for x in parts[1:]], np.float32)
                dim = len(vecs[parts[0]])
            except ValueError:
                pass
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if dim is not None and len(parts) != dim + 1:
                continue
            try:
                v = np.asarray([float(x) for x in parts[1:]], np.float32)
            except ValueError:
                continue
            if dim is None:
                dim = len(v)
            if len(v) == dim:
                vecs[parts[0]] = v
    return vecs


def align_to_vocab(vecs: Dict[str, np.ndarray], itos: Sequence[str],
                   emb_dim: Optional[int] = None, seed: int = 0,
                   init_scale: float = 0.1) -> Tuple[np.ndarray, int]:
    """(table (V, D) f32 in vocab row order, rows found in ``vecs``); the
    other rows are ``init_scale`` times standard normals from numpy
    ``seed``."""
    if not vecs and emb_dim is None:
        raise ValueError("no embeddings parsed and no emb_dim given")
    dim = emb_dim or len(next(iter(vecs.values())))
    rng = np.random.default_rng(seed)
    table = (init_scale * rng.standard_normal((len(itos), dim))).astype(np.float32)
    matched = 0
    for i, tok in enumerate(itos):
        v = vecs.get(tok)
        if v is not None and len(v) == dim:
            table[i] = v
            matched += 1
    return table, matched


def apply_pretrained(model: VMMTModel, enc: Optional[np.ndarray] = None,
                     dec: Optional[np.ndarray] = None) -> VMMTModel:
    """Copy ``enc`` into the source table and ``dec`` into the target
    table of ``model``, in place (a vocab-parallel model takes its rows of
    them); returns the model."""
    from variational_mmt_torch.parallel import tp

    tables = dict(model.named_parameters())
    for name, table in (("src_embed", enc), ("tgt_embed", dec)):
        if table is None:
            continue
        key = f"{name}.embedding"
        if key not in tables:
            raise ValueError(f"model has no '{name}' table (share_embeddings ties both "
                             "sides to 'tgt_embed': load it with -pre_word_vecs_dec)")
        cur = tables[key]
        full = (tuple(cur.shape) if model.vocab_mesh is None else
                (cur.shape[0] * model.vocab_mesh.n_model, cur.shape[1]))
        if tuple(table.shape) != full:
            raise ValueError(f"{name}: pretrained table {tuple(table.shape)} != model "
                             f"{full} (rebuild the .npy against this run's "
                             "vocab and emb_dim)")
        with torch.no_grad():
            cur.copy_(tp.shard_tensor(key, torch.from_numpy(np.asarray(table, np.float32)),
                                      model.vocab_mesh))
    return model
