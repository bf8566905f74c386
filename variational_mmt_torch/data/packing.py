"""Sequence packing: several sentences in each fixed-shape (B, L) row.

Mirrors ``variational_mmt_tpu/data/packing.py`` (:28-231) on its pure-Python
path: ``PackedBatch`` and ``PackedBucketIterator`` (greedy first fit,
seeded per-epoch shuffling, ``epoch`` / ``__iter__`` / ``__len__``, and
``epoch_batches``, an epoch's exact batch count). Every
packed segment is encoded, latent-modelled, decoded and normalized as if it
were alone in a row (``VMMTModel.forward_packed``, ``compute_loss(tgt_seg=)``),
so packing changes what a step carries, not the math. An epoch is planned
by one call of the C++ packer (``native/packer.cpp``, ``_epoch_native``,
JAX :153-180) and each batch assembled by another when it is available
and holds ``max_segments`` (at most 16), else in Python; both give the
same arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np

from variational_mmt_torch import native
from variational_mmt_torch.data.dataset import BinarizedDataset
from variational_mmt_torch.data.vocab import BOS, EOS, PAD


@dataclasses.dataclass
class PackedBatch:
    """One fixed-shape packed minibatch (host numpy). Segment ids are -1 at
    PAD positions; the per-segment arrays are (B, K), ``seg_mask`` marking
    real segments; ``indices`` holds each segment's corpus index."""

    src: np.ndarray  # (B, L) int32
    tgt_in: np.ndarray  # (B, L) int32: [BOS y1..yn] per segment
    tgt_out: np.ndarray  # (B, L) int32: [y1..yn EOS] per segment
    src_seg: np.ndarray  # (B, L) int32 in [-1, K)
    tgt_seg: np.ndarray  # (B, L) int32 in [-1, K)
    seg_first: np.ndarray  # (B, K) int32 first src position of a segment
    seg_last: np.ndarray  # (B, K) int32 last src position (inclusive)
    indices: np.ndarray  # (B, K) int32 corpus index of a segment
    seg_mask: np.ndarray  # (B, K) float32, 1 = real segment
    img: Optional[np.ndarray] = None  # (B, K, D) or (B, K, R, D)

    @property
    def batch_size(self) -> int:
        return self.src.shape[0]

    @property
    def n_tokens(self) -> int:
        """Real target tokens (y + EOS of every segment)."""
        return int((self.tgt_seg >= 0).sum())

    @property
    def n_sentences(self) -> int:
        return int(self.seg_mask.sum())


class _Row:
    __slots__ = ("src_used", "tgt_used", "segs")

    def __init__(self, src_used: int, tgt_used: int, first: int):
        self.src_used = src_used
        self.tgt_used = tgt_used
        self.segs: List[int] = [first]  # corpus indices


class PackedBucketIterator:
    """Greedy first-fit packer of static-shape :class:`PackedBatch` es.

    One row length, the largest of ``buckets``, serves every batch. Each
    epoch visits the examples in an order shuffled from
    ``numpy.random.default_rng(seed + epoch)`` (corpus order without
    ``shuffle``) and puts each into the most recently opened row that has
    room for its source, its target plus one and a segment (``max_segments``
    a row), else opens a row; a batch is emitted when ``batch_size`` rows
    are open and a new one is needed. Every example lands in exactly one
    segment. Empty source or target lines are refused: a segment of zero
    source tokens would have no last position. ``use_native`` (None:
    whenever ``native.available()`` and ``max_segments`` <= 16) plans and
    assembles in C++."""

    def __init__(self, ds: BinarizedDataset, batch_size: int, buckets: Sequence[int],
                 img_feats: Optional[np.ndarray] = None, shuffle: bool = True, seed: int = 0,
                 infinite: bool = False, max_segments: int = 4,
                 use_native: Optional[bool] = None):
        if ds.tgt is None:
            raise ValueError("sequence packing requires a target side")
        empty = [i for i in range(len(ds)) if len(ds.src[i]) == 0 or len(ds.tgt[i]) == 0]
        if empty:
            raise ValueError(f"sequence packing: {len(empty)} empty source or target lines "
                             f"(first at index {empty[0]})")
        self.ds = ds
        self.batch_size = batch_size
        self.row_len = max(buckets)
        self.img_feats = img_feats
        self.shuffle = shuffle
        self.seed = seed
        self.infinite = infinite
        self.K = max(1, max_segments)
        if use_native is None:
            use_native = self.K <= native.MAX_SEGMENTS and native.available()
        self.use_native = bool(use_native)

    def __len__(self) -> int:
        """An estimate of the batches of an epoch (the count depends on the
        epoch's packing): the tokens over the capacity of a batch, at least
        one. Not exact: nothing may take it for the count."""
        L = self.row_len
        need = sum(max(min(len(s), L), min(len(t) + 1, L))
                   for s, t in zip(self.ds.src, self.ds.tgt))
        return max(1, -(-need // (L * self.batch_size)))

    def _order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        return rng.permutation(len(self.ds)) if self.shuffle else np.arange(len(self.ds))

    def _plan(self, epoch: int):
        """The native plan of ``epoch``: (row_off, row_examples)."""
        so, to = self.ds.src_flat()[1], self.ds.tgt_flat()[1]
        return native.pack_plan(so, to, self._order(epoch), self.batch_size, self.row_len,
                                self.K)

    def _row_groups(self, epoch: int) -> Iterator[List[_Row]]:
        """The rows of each batch of ``epoch``, in order."""
        order = self._order(epoch)
        L, K = self.row_len, self.K
        rows: List[_Row] = []
        for i in order:
            ls = min(len(self.ds.src[i]), L)
            lt = min(len(self.ds.tgt[i]) + 1, L)  # +1 for the BOS/EOS shift
            # most recently opened rows first: older rows are fuller
            row = next((r for r in reversed(rows) if len(r.segs) < K
                        and r.src_used + ls <= L and r.tgt_used + lt <= L), None)
            if row is not None:
                row.src_used += ls
                row.tgt_used += lt
                row.segs.append(int(i))
                continue
            if len(rows) == self.batch_size:
                yield rows
                rows = []
            rows.append(_Row(ls, lt, int(i)))
        if rows:
            yield rows

    def epoch(self, epoch: int = 0) -> Iterator[PackedBatch]:
        if self.use_native:
            yield from self._epoch_native(epoch)
            return
        for rows in self._row_groups(epoch):
            yield self._assemble(rows)

    def _epoch_native(self, epoch: int) -> Iterator[PackedBatch]:
        """One ``pack_plan`` call for the epoch, one ``assemble_packed`` a
        batch."""
        B, L, K = self.batch_size, self.row_len, self.K
        (sd, so), (td, to) = self.ds.src_flat(), self.ds.tgt_flat()
        row_off, row_ex = self._plan(epoch)
        n_rows = len(row_off) - 1
        for b0 in range(0, n_rows, B):
            (src, tgt_in, tgt_out, src_seg, tgt_seg, seg_first, seg_last, indices,
             seg_mask) = native.assemble_packed(sd, so, td, to, row_off, row_ex, b0,
                                                min(B, n_rows - b0), B, L, K, BOS, EOS, PAD)
            yield PackedBatch(src=src, tgt_in=tgt_in, tgt_out=tgt_out, src_seg=src_seg,
                              tgt_seg=tgt_seg, seg_first=seg_first, seg_last=seg_last,
                              indices=indices, seg_mask=seg_mask,
                              img=self._img_rows(indices, seg_mask))

    def epoch_batches(self, epoch: int = 0) -> int:
        """The exact number of batches of ``epoch`` (packing without
        assembling; natively, the rows of one ``pack_plan`` call)."""
        if self.use_native:
            return -(-(len(self._plan(epoch)[0]) - 1) // self.batch_size)
        return sum(1 for _ in self._row_groups(epoch))

    def __iter__(self) -> Iterator[PackedBatch]:
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1
            if not self.infinite:
                return

    def _img_rows(self, indices: np.ndarray, seg_mask: np.ndarray) -> Optional[np.ndarray]:
        if self.img_feats is None:
            return None
        B, K = indices.shape
        img = np.asarray(self.img_feats[indices], np.float32)
        img *= seg_mask.reshape((B, K) + (1,) * (img.ndim - 2))
        return img

    def _assemble(self, rows: List[_Row]) -> PackedBatch:
        B, L, K = self.batch_size, self.row_len, self.K
        src, tgt_in, tgt_out = (np.full((B, L), PAD, np.int32) for _ in range(3))
        src_seg, tgt_seg = (np.full((B, L), -1, np.int32) for _ in range(2))
        seg_first, seg_last, indices = (np.zeros((B, K), np.int32) for _ in range(3))
        seg_mask = np.zeros((B, K), np.float32)
        for r, row in enumerate(rows):
            sp = tp = 0
            for k, i in enumerate(row.segs):
                s = self.ds.src[i][:L]
                t = self.ds.tgt[i][: L - 1]
                ls, lt = len(s), len(t) + 1
                src[r, sp : sp + ls] = s
                src_seg[r, sp : sp + ls] = k
                seg_first[r, k] = sp
                seg_last[r, k] = sp + ls - 1
                tgt_in[r, tp] = BOS
                tgt_in[r, tp + 1 : tp + lt] = t
                tgt_out[r, tp : tp + lt - 1] = t
                tgt_out[r, tp + lt - 1] = EOS
                tgt_seg[r, tp : tp + lt] = k
                indices[r, k] = i
                seg_mask[r, k] = 1.0
                sp += ls
                tp += lt
        return PackedBatch(src=src, tgt_in=tgt_in, tgt_out=tgt_out, src_seg=src_seg,
                           tgt_seg=tgt_seg, seg_first=seg_first, seg_last=seg_last,
                           indices=indices, seg_mask=seg_mask,
                           img=self._img_rows(indices, seg_mask))
