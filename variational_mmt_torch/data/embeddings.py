"""Pretrained word vectors for ``-pre_word_vecs_enc`` / ``-pre_word_vecs_dec``.
Mirrors ``apply_pretrained`` of ``variational_mmt_tpu/data/embeddings.py``
(:95-105): a vocab-aligned ``.npy`` table replaces a model's embedding
table, and a shape that differs is an error (the table was built against
another vocab or width)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from variational_mmt_torch.models.model import VMMTModel


def apply_pretrained(model: VMMTModel, enc: Optional[np.ndarray] = None,
                     dec: Optional[np.ndarray] = None) -> VMMTModel:
    """Copy ``enc`` into the source table and ``dec`` into the target
    table of ``model``, in place; returns the model."""
    tables = dict(model.named_parameters())
    for name, table in (("src_embed", enc), ("tgt_embed", dec)):
        if table is None:
            continue
        key = f"{name}.embedding"
        if key not in tables:
            raise ValueError(f"model has no '{name}' table (share_embeddings ties both "
                             "sides to 'tgt_embed': load it with -pre_word_vecs_dec)")
        cur = tables[key]
        if tuple(table.shape) != tuple(cur.shape):
            raise ValueError(f"{name}: pretrained table {tuple(table.shape)} != model "
                             f"{tuple(cur.shape)} (rebuild the .npy against this run's "
                             "vocab and emb_dim)")
        with torch.no_grad():
            cur.copy_(torch.from_numpy(np.asarray(table, np.float32)))
    return model
