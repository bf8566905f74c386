"""Force-decoding scorer. Mirrors ``make_score_fn``, ``score_corpus`` and
``report_score`` of ``variational_mmt_tpu/decode/score.py``: the
teacher-forced log p(y | x, z = the prior mean) of each sentence under the
decode-time model (deterministic), for the translate CLI's ``-verbose``
PRED and GOLD scores, and with ``return_attn`` the (T, S) attention
matrices of each sentence for ``-dump_attn`` (force-decoding a hypothesis
gives the attention the deterministic beam saw). With ``use_pallas`` and
``pallas_decoder`` on the card they are the decoder sequence kernel's
probabilities."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from variational_mmt_torch.data.dataset import BucketIterator, binarize, buckets_with_catchall
from variational_mmt_torch.data.vocab import PAD
from variational_mmt_torch.models.model import VMMTModel


@torch.inference_mode()
def score_batch(model: VMMTModel, src: torch.Tensor, tgt_in: torch.Tensor,
                tgt_out: torch.Tensor, img: Optional[torch.Tensor], return_attn: bool = False
                ) -> Tuple[torch.Tensor, ...]:
    """(log p summed over each row's tokens (B,), tokens (B,)[, attention
    (B,T,S) f32])."""
    memory, finals, src_mask, summary = model.encode(src)
    z = model.prior_latent(summary, img) if model.is_latent else None
    init_hs = model.init_decoder_state(finals, z)
    logits, aligns = model.decode_train(tgt_in, memory, src_mask, init_hs, z)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_mask = (tgt_out != PAD).float()
    ll = (logp.gather(-1, tgt_out[..., None])[..., 0] * tok_mask).sum(dim=-1)
    out = (ll, tok_mask.sum(dim=-1))
    return out + (aligns.float(),) if return_attn else out


def score_corpus(model: VMMTModel, src_ids: Sequence[Sequence[int]],
                 tgt_ids: Sequence[Sequence[int]], img_feats: Optional[np.ndarray] = None,
                 buckets: Sequence[int] = (16, 24, 32, 48, 64), batch_size: int = 32,
                 return_attn: bool = False) -> Tuple:
    """(log p (N,), target tokens (N,)) in corpus order, on the model's
    device; a catch-all bucket keeps long sentences whole. With
    ``return_attn`` also the attention of each sentence: a list of
    (len(tgt_i) + 1, len(src_i)) f32 arrays, the EOS row included."""
    buckets = buckets_with_catchall(
        buckets, max([1] + [len(s) for s in src_ids] + [len(t) + 1 for t in tgt_ids]))
    it = BucketIterator(binarize(src_ids, tgt_ids), batch_size, buckets, img_feats=img_feats)
    device = next(model.parameters()).device
    logp = np.zeros(len(src_ids), np.float64)
    ntok = np.zeros(len(src_ids), np.int64)
    attns: List[Optional[np.ndarray]] = [None] * len(src_ids)
    for batch in it.epoch(0):
        t = lambda a: torch.from_numpy(np.asarray(a)).long().to(device)  # noqa: E731
        img = None if batch.img is None else torch.from_numpy(batch.img).to(device)
        out = [o.cpu().numpy() for o in score_batch(model, t(batch.src), t(batch.tgt_in),
                                                    t(batch.tgt_out), img, return_attn)]
        for row in np.nonzero(batch.example_mask)[0]:
            i = int(batch.indices[row])
            logp[i], ntok[i] = float(out[0][row]), int(out[1][row])
            if return_attn:
                attns[i] = out[2][row, :len(tgt_ids[i]) + 1, :len(src_ids[i])].copy()
    return (logp, ntok, attns) if return_attn else (logp, ntok)


def report_score(name: str, logp: np.ndarray, ntok: np.ndarray) -> str:
    """The reference's per-word average score and perplexity line."""
    per_word = float(logp.sum()) / max(int(ntok.sum()), 1)
    return f"{name} AVG SCORE: {per_word:.4f}, {name} PPL: {float(np.exp(-per_word)):.4f}"
