"""Ragged id datasets and length-bucketed, fixed-shape batching.

Mirrors ``variational_mmt_tpu/data/dataset.py`` (:28-315) on its
pure-Python batch path: ``Batch`` (with the target side),
``BinarizedDataset`` and its ``.npz`` files (one file, or the sharded
``<base>.NN.npz`` form that preprocess ``-shard_size`` writes; the same
arrays as JAX's, so either package reads the other's), ``binarize``,
``buckets_with_catchall`` and ``BucketIterator`` with seeded per-epoch
shuffling. Batches are assembled by the C++ batcher (``native/``,
``_make_batch_native``, JAX :301-315) when it is available, else in
Python; both give the same arrays.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from variational_mmt_torch import native
from variational_mmt_torch.data.vocab import BOS, EOS, PAD


@dataclasses.dataclass
class Batch:
    """One fixed-shape minibatch (host numpy). ``example_mask`` is 0 on rows
    that pad a partial batch up to the static batch size."""

    src: np.ndarray  # (B, Ls) int32, PAD-padded
    indices: np.ndarray  # (B,) int32 original example index
    example_mask: np.ndarray  # (B,) float32, 1 = real example
    img: Optional[np.ndarray] = None  # (B, D) or (B, R, D) float32
    tgt_in: Optional[np.ndarray] = None  # (B, Lt) int32, BOS + y, PAD-padded
    tgt_out: Optional[np.ndarray] = None  # (B, Lt) int32, y + EOS, PAD-padded

    @property
    def batch_size(self) -> int:
        return self.src.shape[0]

    @property
    def n_tokens(self) -> int:
        """Target tokens (y + EOS) of the real rows."""
        return int(((self.tgt_out != PAD) * self.example_mask[:, None].astype(bool)).sum())


class BinarizedDataset:
    """Ragged id sequences, one int32 array per example; ``tgt`` (ids
    without BOS/EOS, added at batch time) is None for source-only data."""

    def __init__(self, src: List[np.ndarray], tgt: Optional[List[np.ndarray]] = None):
        if tgt is not None and len(tgt) != len(src):
            raise ValueError(f"{len(src)} sources but {len(tgt)} targets")
        self.src = src
        self.tgt = tgt
        self._src_flat: Optional[tuple] = None
        self._tgt_flat: Optional[tuple] = None

    def __len__(self) -> int:
        return len(self.src)

    def src_flat(self) -> tuple:
        """(data int32, offsets int64) of the sources, made once: the
        native batcher's and packer's layout (JAX :64-81)."""
        if self._src_flat is None:
            self._src_flat = _flat(self.src)
        return self._src_flat

    def tgt_flat(self) -> Optional[tuple]:
        if self.tgt is None:
            return None
        if self._tgt_flat is None:
            self._tgt_flat = _flat(self.tgt)
        return self._tgt_flat

    def save(self, path: str) -> None:
        """One ``.npz``: src_data/src_off (and tgt_data/tgt_off), the
        sequences flat in int32 with int64 offsets (JAX dataset.py:83-89)."""
        arrs = dict(zip(("src_data", "src_off"), self.src_flat()))
        if self.tgt is not None:
            arrs["tgt_data"], arrs["tgt_off"] = self.tgt_flat()
        np.savez_compressed(path, **arrs)

    @classmethod
    def load(cls, path: str) -> "BinarizedDataset":
        """``path``, or when it does not exist its shards
        ``<base>.00.npz, <base>.01.npz, ...`` concatenated in index order,
        so that example index == corpus line across shards. Both at once
        is refused: one of them is stale."""
        shards = cls.shard_paths(path)
        if os.path.exists(path) and shards:
            raise ValueError(
                f"both {path} and shards ({shards[0]} ...) exist; remove the stale layout")
        paths = [path] if os.path.exists(path) else shards
        if not paths:
            raise FileNotFoundError(f"no dataset at {path} (or shards {path[:-4]}.NN.npz)")
        src: List[np.ndarray] = []
        tgt: Optional[List[np.ndarray]] = None
        for i, p in enumerate(paths):
            z = np.load(p)
            src.extend(_unflat(z["src_data"], z["src_off"]))
            has_tgt = "tgt_data" in z
            if i == 0:
                tgt = [] if has_tgt else None
            elif has_tgt != (tgt is not None):
                raise ValueError(f"shard {p} disagrees about having targets")
            if has_tgt:
                tgt.extend(_unflat(z["tgt_data"], z["tgt_off"]))
        return cls(src, tgt)

    @staticmethod
    def shard_paths(path: str) -> List[str]:
        """Shard files of a ``<base>.npz`` path in numeric index order
        ('.100.npz' after '.99.npz'); [] if none."""
        base = path[:-4] if path.endswith(".npz") else path
        found = [p for p in glob.glob(base + ".*.npz") if p[len(base) + 1:-4].isdigit()]
        return sorted(found, key=lambda p: int(p[len(base) + 1:-4]))

    @classmethod
    def exists(cls, path: str) -> bool:
        return os.path.exists(path) or bool(cls.shard_paths(path))


def _flat(seqs: List[np.ndarray]):
    data = np.concatenate(seqs) if seqs else np.zeros(0, np.int32)
    off = np.cumsum([0] + [len(a) for a in seqs]).astype(np.int64)
    return np.ascontiguousarray(data, np.int32), off


def _unflat(data: np.ndarray, off: np.ndarray) -> List[np.ndarray]:
    data = np.ascontiguousarray(data, np.int32)
    return [data[off[i]:off[i + 1]] for i in range(len(off) - 1)]


def binarize(src_ids: Sequence[Sequence[int]], tgt_ids: Optional[Sequence[Sequence[int]]] = None,
             max_src_len: int = 0, max_tgt_len: int = 0) -> BinarizedDataset:
    """Truncate and store id sequences (without BOS/EOS, which batching
    adds)."""
    src = [np.asarray(s[:max_src_len] if max_src_len else s, np.int32) for s in src_ids]
    tgt = None
    if tgt_ids is not None:
        tgt = [np.asarray(t[:max_tgt_len] if max_tgt_len else t, np.int32) for t in tgt_ids]
    return BinarizedDataset(src, tgt)


def buckets_with_catchall(buckets: Sequence[int], need: int) -> List[int]:
    """Sorted ``buckets`` plus a catch-all bucket when ``need`` (the longest
    sequence, in tokens) exceeds the largest: over-long inputs are decoded
    in full, never truncated at batch assembly."""
    out = sorted(buckets)
    if need > out[-1]:
        out = out + [need]
    return out


class BucketIterator:
    """Length-bucketed batches with static shapes.

    Bucket of an example = smallest b in ``buckets`` with
    max(len(src), len(tgt) + 1) <= b (+1 for the BOS/EOS shift); longer
    examples go to the last bucket, truncated. Within a bucket, batches are
    contiguous runs of ``batch_size`` examples. With ``shuffle`` each epoch
    permutes the examples of every bucket and the order of the batches
    from ``numpy.random.default_rng(seed + epoch)``, as the JAX iterator
    does; without it the order is the corpus order. ``use_native`` (None:
    whenever ``native.available()``) assembles each batch in C++, the
    feature table then made contiguous f32 once."""

    def __init__(self, ds: BinarizedDataset, batch_size: int, buckets: Sequence[int],
                 img_feats: Optional[np.ndarray] = None, shuffle: bool = False,
                 seed: int = 0, use_native: Optional[bool] = None):
        self.ds = ds
        self.batch_size = batch_size
        self.buckets = sorted(buckets)
        self.shuffle = shuffle
        self.seed = seed
        self.use_native = native.available() if use_native is None else bool(use_native)
        if self.use_native and img_feats is not None:
            img_feats = np.ascontiguousarray(img_feats, np.float32)
        self.img_feats = img_feats

    def _bucketize(self) -> List[List[int]]:
        per_bucket: List[List[int]] = [[] for _ in self.buckets]
        for i in range(len(self.ds)):
            lt = len(self.ds.tgt[i]) + 1 if self.ds.tgt is not None else 0
            need = max(len(self.ds.src[i]), lt, 1)
            b = next((j for j, cap in enumerate(self.buckets) if need <= cap),
                     len(self.buckets) - 1)
            per_bucket[b].append(i)
        return per_bucket

    def __len__(self) -> int:
        """Batches an epoch: each bucket pads its own last partial batch."""
        return sum(-(-len(idxs) // self.batch_size) for idxs in self._bucketize())

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        rng = np.random.default_rng(self.seed + epoch)
        chunks = []  # (bucket id, example indices)
        for b, idxs in enumerate(self._bucketize()):
            idxs = np.asarray(idxs, np.int64)
            if self.shuffle:
                idxs = idxs[rng.permutation(len(idxs))]
            for s in range(0, len(idxs), self.batch_size):
                chunks.append((b, idxs[s : s + self.batch_size]))
        order = rng.permutation(len(chunks)) if self.shuffle else np.arange(len(chunks))
        for ci in order:
            b, chunk = chunks[ci]
            yield self._make_batch(self.buckets[b], chunk)

    def _make_batch(self, bucket_len: int, idxs: Sequence[int]) -> Batch:
        if self.use_native:
            return self._make_batch_native(bucket_len, idxs)
        B, L = self.batch_size, bucket_len
        src = np.full((B, L), PAD, np.int32)
        has_tgt = self.ds.tgt is not None
        tgt_in = np.full((B, L), PAD, np.int32) if has_tgt else None
        tgt_out = np.full((B, L), PAD, np.int32) if has_tgt else None
        indices = np.zeros((B,), np.int32)
        mask = np.zeros((B,), np.float32)
        for row, i in enumerate(idxs):
            s = self.ds.src[i][:L]
            src[row, : len(s)] = s
            if has_tgt:
                t = self.ds.tgt[i][: L - 1]
                tgt_in[row, 0] = BOS
                tgt_in[row, 1 : 1 + len(t)] = t
                tgt_out[row, : len(t)] = t
                tgt_out[row, len(t)] = EOS
            indices[row] = i
            mask[row] = 1.0
        img = None
        if self.img_feats is not None:
            img = np.asarray(self.img_feats[indices], np.float32)
            img *= mask.reshape((B,) + (1,) * (img.ndim - 1))
        return Batch(src=src, indices=indices, example_mask=mask, img=img, tgt_in=tgt_in,
                     tgt_out=tgt_out)

    def _make_batch_native(self, bucket_len: int, idxs: Sequence[int]) -> Batch:
        B, L = self.batch_size, bucket_len
        sd, so = self.ds.src_flat()
        td, to = self.ds.tgt_flat() or (None, None)
        src, tgt_in, tgt_out, indices, mask = native.assemble_batch(
            sd, so, td, to, idxs, B, L, BOS, EOS, PAD)
        if td is None:  # the Python path's contract: no target side, no arrays
            tgt_in = tgt_out = None
        img = None
        if self.img_feats is not None:
            img = native.gather_rows(self.img_feats, indices, mask)
        return Batch(src=src, indices=indices, example_mask=mask, img=img, tgt_in=tgt_in,
                     tgt_out=tgt_out)
