"""Ragged id datasets and length-bucketed, fixed-shape batching.

Mirrors the part of ``variational_mmt_tpu/data/dataset.py`` (:28-315) that
the ``Translator`` needs: ``Batch``, ``BinarizedDataset`` (in memory, source
side), ``buckets_with_catchall`` and ``BucketIterator`` on the pure-Python
batch path, in corpus order (the JAX package's C++ batcher, target side
and shuffling belong to training and are not carried over).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np

from variational_mmt_torch.data.vocab import PAD


@dataclasses.dataclass
class Batch:
    """One fixed-shape minibatch (host numpy). ``example_mask`` is 0 on rows
    that pad a partial batch up to the static batch size."""

    src: np.ndarray  # (B, Ls) int32, PAD-padded
    indices: np.ndarray  # (B,) int32 original example index
    example_mask: np.ndarray  # (B,) float32, 1 = real example
    img: Optional[np.ndarray] = None  # (B, D) or (B, R, D) float32

    @property
    def batch_size(self) -> int:
        return self.src.shape[0]


class BinarizedDataset:
    """Ragged source id sequences, one int32 array per example."""

    def __init__(self, src: List[np.ndarray]):
        self.src = src

    def __len__(self) -> int:
        return len(self.src)


def buckets_with_catchall(buckets: Sequence[int], need: int) -> List[int]:
    """Sorted ``buckets`` plus a catch-all bucket when ``need`` (the longest
    sequence, in tokens) exceeds the largest: over-long inputs are decoded
    in full, never truncated at batch assembly."""
    out = sorted(buckets)
    if need > out[-1]:
        out = out + [need]
    return out


class BucketIterator:
    """Length-bucketed batches with static shapes, in corpus order.

    Bucket of an example = smallest b in ``buckets`` with len(src) <= b;
    longer examples go to the last bucket, truncated. Within a bucket,
    batches are contiguous runs of ``batch_size`` examples."""

    def __init__(self, ds: BinarizedDataset, batch_size: int, buckets: Sequence[int],
                 img_feats: Optional[np.ndarray] = None):
        self.ds = ds
        self.batch_size = batch_size
        self.buckets = sorted(buckets)
        self.img_feats = img_feats

    def _bucketize(self) -> List[List[int]]:
        per_bucket: List[List[int]] = [[] for _ in self.buckets]
        for i in range(len(self.ds)):
            need = max(len(self.ds.src[i]), 1)
            b = next((j for j, cap in enumerate(self.buckets) if need <= cap),
                     len(self.buckets) - 1)
            per_bucket[b].append(i)
        return per_bucket

    def epoch(self) -> Iterator[Batch]:
        for b, idxs in enumerate(self._bucketize()):
            for s in range(0, len(idxs), self.batch_size):
                yield self._make_batch(self.buckets[b], idxs[s : s + self.batch_size])

    def _make_batch(self, bucket_len: int, idxs: Sequence[int]) -> Batch:
        B, L = self.batch_size, bucket_len
        src = np.full((B, L), PAD, np.int32)
        indices = np.zeros((B,), np.int32)
        mask = np.zeros((B,), np.float32)
        for row, i in enumerate(idxs):
            s = self.ds.src[i][:L]
            src[row, : len(s)] = s
            indices[row] = i
            mask[row] = 1.0
        img = None
        if self.img_feats is not None:
            img = np.asarray(self.img_feats[indices], np.float32)
            img *= mask.reshape((B,) + (1,) * (img.ndim - 1))
        return Batch(src=src, indices=indices, example_mask=mask, img=img)
