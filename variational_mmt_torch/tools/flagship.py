"""The flagship cells that ``chip_smoke.py`` and the profilers measure.

vmmt_c at full width from the port's ``configs/vmmt_c_multi30k.json``
(vocab 10000/10000, bf16, use_pallas, fused_ce) with random weights from
numpy seed 0 through ``convert.py``, and the synthetic traffic of its two
cells, both from numpy seed 1:

- translation requests: source lengths uniform in 8-24 tokens and 2048-d
  |N(0,1)| image features, drawn one request after another from one stream;
- training batches: sentence pairs with source and target lengths uniform
  in 8-24 and the same image features, cut into fixed batches by the port's
  batcher;
- packed training batches: pairs drawn the same way, packed up to K=4 to a
  row of 64 tokens by the port's packer (the JAX CLI's ``-pack 1``
  defaults: the largest of ``-buckets 16,24,32,48,64``, ``-pack_segments
  4``).

One module for both, so that a profile describes the cell that the smoke
run times.
"""

from __future__ import annotations

import itertools
import os
from typing import Callable, List, Tuple

import numpy as np

from variational_mmt_torch.config import Config, ModelConfig
from variational_mmt_torch.convert import params_from_jax
from variational_mmt_torch.data.dataset import Batch, BinarizedDataset, BucketIterator
from variational_mmt_torch.data.packing import PackedBatch, PackedBucketIterator
from variational_mmt_torch.models.model import init_params

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "vmmt_c_multi30k.json")


def load() -> Tuple[Config, dict]:
    """The flagship config and its random weights (numpy seed 0) as a
    state dict of the port's model."""
    with open(CONFIG) as f:
        cfg = Config.from_json(f.read())
    return cfg, params_from_jax(init_params(cfg.model, seed=0), cfg.model)


def requests(m: ModelConfig, seed: int = 1) -> Callable[[int], Tuple[List[List[int]], np.ndarray]]:
    """A function ``n -> (source id lists, image features (n, img_feat_dim))``
    that draws successive requests of n sentences from one numpy stream."""
    rng = np.random.default_rng(seed)

    def request(n: int):
        src = [rng.integers(4, m.src_vocab_size, rng.integers(8, 25)).tolist() for _ in range(n)]
        img = np.abs(rng.standard_normal((n, m.img_feat_dim))).astype(np.float32)
        return src, img

    return request


def _pairs(m: ModelConfig, n: int, seed: int) -> Tuple[BinarizedDataset, np.ndarray]:
    """n sentence pairs, source and target lengths uniform in 8-24, and a
    2048-d |N(0,1)| image row each, from one numpy stream."""
    rng = np.random.default_rng(seed)
    src = [rng.integers(4, m.src_vocab_size, rng.integers(8, 25)).astype(np.int32)
           for _ in range(n)]
    tgt = [rng.integers(4, m.tgt_vocab_size, rng.integers(8, 25)).astype(np.int32)
           for _ in range(n)]
    img = np.abs(rng.standard_normal((n, m.img_feat_dim))).astype(np.float32)
    return BinarizedDataset(src, tgt), img


def train_batches(m: ModelConfig, n_batches: int = 4, batch_size: int = 64,
                  seed: int = 1) -> List[Batch]:
    """``n_batches`` fixed batches of ``batch_size`` sentence pairs through
    the port's batcher (one bucket of 25 tokens, no shuffling)."""
    ds, img = _pairs(m, batch_size * n_batches, seed)
    return list(BucketIterator(ds, batch_size, [25], img_feats=img).epoch())


def packed_batches(m: ModelConfig, n_batches: int = 4, batch_size: int = 64,
                   row_len: int = 64, max_segments: int = 4, seed: int = 1) -> List[PackedBatch]:
    """The first ``n_batches`` packed batches of ``batch_size`` rows of
    ``row_len`` tokens, up to ``max_segments`` sentences a row, through the
    port's packer (no shuffling) over pairs drawn as :func:`train_batches`
    draws them, enough that every row of those batches is in use."""
    ds, img = _pairs(m, batch_size * (n_batches + 1) * max_segments, seed)
    it = PackedBucketIterator(ds, batch_size, [row_len], img_feats=img, shuffle=False,
                              max_segments=max_segments)
    return list(itertools.islice(it.epoch(), n_batches))
