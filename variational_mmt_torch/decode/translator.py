"""Batch translation. Mirrors ``variational_mmt_tpu/decode/translator.py``:
``make_translate_fn`` (:121-279, a single model with latent-mean
substitution) and ``Translator`` (``translate_ids``, ``translate_tokens``,
``nbest_to_text``).

Encode, take z = the prior mean (of p(z|x,v) for vmmt_c, zero for
vmmt_f; nmt has no z), bridge into the decoder's initial state, then beam
search. ``DecodeConfig.pallas_step`` picks the decode step: 0 plain
PyTorch, 1 the fused decode-step kernel, 2 the GRU-chain kernel with
attention in PyTorch, for decoders that ``fused_step_eligible`` accepts
(the plain step otherwise). Host code maps text to ids, buckets the corpus
and regroups the n-best lists in corpus order.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from variational_mmt_torch.config import DecodeConfig
from variational_mmt_torch.data.dataset import (BinarizedDataset, BucketIterator,
                                                buckets_with_catchall)
from variational_mmt_torch.data.vocab import EOS, PAD, Vocab
from variational_mmt_torch.device import resolve_device
from variational_mmt_torch.models.decoder import fused_step_eligible
from variational_mmt_torch.models.model import VMMTModel
from variational_mmt_torch.ops.beam import beam_search, greedy_search, tree_map


def check_supported(d: DecodeConfig) -> None:
    """Raise NotImplementedError for every decode option outside the slice."""
    unsupported = [
        ("sampling (sampling_temp/topk/topp)",
         d.sampling_temp > 0.0 or d.sampling_topk > 0 or d.sampling_topp > 0.0),
        ("latent_from=sample", d.latent_from != "mean"),
        ("coverage_beta", d.coverage_beta != 0.0),
        ("block_ngram_repeat / ignore_when_blocking",
         d.block_ngram_repeat != 0 or bool(d.ignore_when_blocking)),
        ("replace_unk", d.replace_unk),
        ("dump_beam", d.dump_beam),
        (f"infer_dtype={d.infer_dtype}", d.infer_dtype not in ("", "float32")),
        (f"pallas_step={d.pallas_step}", d.pallas_step not in (0, 1, 2)),
    ]
    bad = [name for name, on in unsupported if on]
    if bad:
        raise NotImplementedError(f"decode option not ported yet: {', '.join(bad)}")


def make_translate_fn(model: VMMTModel, dcfg: DecodeConfig) -> Callable:
    """fn(src (B,S) long, img (B,D) | None) -> (tokens (B,K,L), scores (B,K))."""
    check_supported(dcfg)
    K = dcfg.beam_size
    c = model.cfg
    mode = int(dcfg.pallas_step)
    fused_step = mode > 0 and fused_step_eligible(c)

    @torch.inference_mode()
    def fn(src: torch.Tensor, img: Optional[torch.Tensor]):
        B = src.shape[0]
        memory, finals, src_mask, summary = model.encode(src)
        # nmt has no z; vmmt_f's prior mean is zero and ignores the image
        z = model.prior_latent(summary, img) if model.is_latent else None
        carry0 = model.init_decode_carry(model.init_decoder_state(finals, z))
        keys = model.project_memory(memory, fused_step and mode == 1)
        if fused_step and mode == 2:
            keys = (keys,)

        if K == 1 and dcfg.min_length == 0:
            def step1(carry, toks):
                carry, logits, _ = model.decode_step(carry, toks, memory, src_mask, z, keys)
                return carry, torch.log_softmax(logits, dim=-1)

            tokens, scores = greedy_search(step1, carry0, B, dcfg.max_length)
            return tokens[:, None, :], scores[:, None]

        # tile the read-only context across beams once per batch
        rep = lambda x: x.repeat_interleave(K, dim=0)  # noqa: E731
        mask_t, mem_t = rep(src_mask), rep(memory)
        z_t = None if z is None else rep(z)
        keys_t = tree_map(rep, keys)

        def step(carry, toks):
            carry, logits, _ = model.decode_step(carry, toks, mem_t, mask_t, z_t, keys_t)
            return carry, torch.log_softmax(logits, dim=-1)

        return beam_search(step, carry0, B, K, dcfg.max_length, dcfg.min_length,
                           dcfg.alpha, dcfg.length_penalty)

    return fn


class Translator:
    """Text -> bucketed batches -> beam search on the device -> n-best text
    in corpus order. ``device`` defaults to cuda and raises without CUDA
    unless ``device='cpu'``; the model is moved there."""

    def __init__(self, model: VMMTModel, src_vocab: Vocab, tgt_vocab: Vocab,
                 dcfg: Optional[DecodeConfig] = None,
                 buckets: Sequence[int] = (16, 24, 32, 48, 64), mesh=None, device=None):
        if isinstance(model, (list, tuple)):
            raise NotImplementedError("ensembles are not ported yet")
        if mesh is not None:
            raise NotImplementedError("mesh (multi-device decode) is not ported yet")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.src_vocab = src_vocab
        self.tgt_vocab = tgt_vocab
        self.dcfg = dcfg or DecodeConfig()
        if self.dcfg.n_best > self.dcfg.beam_size:
            raise ValueError(f"n_best ({self.dcfg.n_best}) cannot exceed beam_size "
                             f"({self.dcfg.beam_size})")
        self.buckets = list(buckets)
        self._fn = make_translate_fn(self.model, self.dcfg)

    def translate_ids(self, src_ids: List[List[int]],
                      img_feats: Optional[np.ndarray] = None
                      ) -> List[List[Tuple[float, List[int]]]]:
        """Per input sentence, the n-best list [(score, token_ids)]."""
        ds = BinarizedDataset([np.asarray(s, np.int32) for s in src_ids])
        buckets = buckets_with_catchall(self.buckets, max([1] + [len(s) for s in src_ids]))
        it = BucketIterator(ds, batch_size=self.dcfg.batch_size, buckets=buckets,
                            img_feats=img_feats)
        results: dict = {}
        for batch in it.epoch():
            src = torch.from_numpy(batch.src).long().to(self.device)
            img = None if batch.img is None else torch.from_numpy(batch.img).to(self.device)
            tokens, scores = self._fn(src, img)
            tokens, scores = tokens.cpu().numpy(), scores.cpu().numpy()
            for row in range(batch.batch_size):
                if batch.example_mask[row] == 0:
                    continue
                results[int(batch.indices[row])] = [
                    (float(scores[row, k]), _strip(tokens[row, k]))
                    for k in range(self.dcfg.n_best)]
        return [results[i] for i in range(len(src_ids))]

    def nbest_to_text(self, nbest: List[tuple], debpe: bool = True) -> List[tuple]:
        """One sentence's n-best [(score, ids)] -> [(score, text)]."""
        return [(score, self.tgt_vocab.ids_to_text(ids, debpe)) for score, ids in nbest]

    def translate_tokens(self, src_tokens: List[List[str]],
                         img_feats: Optional[np.ndarray] = None,
                         debpe: bool = True) -> List[List[Tuple[float, str]]]:
        src_ids = [self.src_vocab.encode(t) for t in src_tokens]
        return [self.nbest_to_text(nbest, debpe=debpe)
                for nbest in self.translate_ids(src_ids, img_feats)]


def _strip(ids: np.ndarray) -> List[int]:
    """Cut at EOS, drop PAD."""
    out = []
    for i in ids.tolist():
        if i == EOS:
            break
        if i != PAD:
            out.append(i)
    return out
