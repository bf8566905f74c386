"""Force-decoding scorer. Mirrors ``score_corpus`` and ``report_score`` of
``variational_mmt_tpu/decode/score.py``: the teacher-forced log p(y | x,
z = the prior mean) of each sentence under the decode-time model
(deterministic), for the translate CLI's ``-verbose`` PRED and GOLD
scores."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from variational_mmt_torch.data.dataset import BucketIterator, binarize, buckets_with_catchall
from variational_mmt_torch.data.vocab import PAD
from variational_mmt_torch.models.model import VMMTModel


@torch.inference_mode()
def score_batch(model: VMMTModel, src: torch.Tensor, tgt_in: torch.Tensor,
                tgt_out: torch.Tensor, img: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log p summed over each row's tokens (B,), tokens (B,))."""
    memory, finals, src_mask, summary = model.encode(src)
    z = model.prior_latent(summary, img) if model.is_latent else None
    init_hs = model.init_decoder_state(finals, z)
    logits, _ = model.decode_train(tgt_in, memory, src_mask, init_hs, z)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_mask = (tgt_out != PAD).float()
    ll = (logp.gather(-1, tgt_out[..., None])[..., 0] * tok_mask).sum(dim=-1)
    return ll, tok_mask.sum(dim=-1)


def score_corpus(model: VMMTModel, src_ids: Sequence[Sequence[int]],
                 tgt_ids: Sequence[Sequence[int]], img_feats: Optional[np.ndarray] = None,
                 buckets: Sequence[int] = (16, 24, 32, 48, 64), batch_size: int = 32
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(log p (N,), target tokens (N,)) in corpus order, on the model's
    device; a catch-all bucket keeps long sentences whole."""
    buckets = buckets_with_catchall(
        buckets, max([1] + [len(s) for s in src_ids] + [len(t) + 1 for t in tgt_ids]))
    it = BucketIterator(binarize(src_ids, tgt_ids), batch_size, buckets, img_feats=img_feats)
    device = next(model.parameters()).device
    logp = np.zeros(len(src_ids), np.float64)
    ntok = np.zeros(len(src_ids), np.int64)
    for batch in it.epoch(0):
        t = lambda a: torch.from_numpy(np.asarray(a)).long().to(device)  # noqa: E731
        img = None if batch.img is None else torch.from_numpy(batch.img).to(device)
        ll, nt = score_batch(model, t(batch.src), t(batch.tgt_in), t(batch.tgt_out), img)
        ll, nt = ll.cpu().numpy(), nt.cpu().numpy()
        for row in np.nonzero(batch.example_mask)[0]:
            i = int(batch.indices[row])
            logp[i], ntok[i] = float(ll[row]), int(nt[row])
    return logp, ntok


def report_score(name: str, logp: np.ndarray, ntok: np.ndarray) -> str:
    """The reference's per-word average score and perplexity line."""
    per_word = float(logp.sum()) / max(int(ntok.sum()), 1)
    return f"{name} AVG SCORE: {per_word:.4f}, {name} PPL: {float(np.exp(-per_word)):.4f}"
