"""Batch translation. Mirrors ``variational_mmt_tpu/decode/translator.py``:
``make_translate_fn`` (:121-279, a single model) and ``Translator``
(:282-684: the option checks, ``dispatch_ids``/``finalize_ids`` and
``PendingTranslation``, ``translate_ids``, ``nbest_to_text`` with
``replace_unk`` and a phrase table, ``translate_tokens``).

Encode, take z (the prior mean of p(z|x,v) for vmmt_c, zero for vmmt_f, a
draw ``mu + sigma * eps`` with ``latent_from=sample``; nmt has no z),
bridge into the decoder's initial state, then beam search (with coverage,
n-gram blocking, attention tracking for ``replace_unk`` and the search
trace for ``dump_beam``), greedy search or ancestral sampling.
``DecodeConfig.pallas_step`` picks the decode step: 0 plain PyTorch, 1 the
fused decode-step kernel, 2 the GRU-chain kernel with attention in PyTorch,
for decoders that ``fused_step_eligible`` accepts (the plain step
otherwise). The random draws come from per-sentence counter-based streams
(``decode/streams.py``) keyed by the decode seed and each sentence's corpus
index or ``stream_ids`` entry.

JAX dispatches asynchronously; the port's search syncs with the host every
step, so ``dispatch_ids`` hands each batch to one device-owning thread (a
single-thread executor that sets the CUDA device and runs under
``inference_mode``) and returns at once; ``finalize_ids`` waits on its
futures. Host code maps text to ids, buckets the corpus and regroups the
n-best lists in corpus order.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from variational_mmt_torch.config import DecodeConfig
from variational_mmt_torch.data.bpe import remove_bpe
from variational_mmt_torch.data.dataset import (BinarizedDataset, BucketIterator,
                                                buckets_with_catchall)
from variational_mmt_torch.data.vocab import EOS, PAD, UNK, UNK_TOK, Vocab
from variational_mmt_torch.decode.streams import DecodeStreams
from variational_mmt_torch.device import resolve_device
from variational_mmt_torch.models.decoder import fused_step_eligible
from variational_mmt_torch.models.model import VMMTModel
from variational_mmt_torch.ops.beam import (beam_search, greedy_search, sampling_search,
                                            tree_map)


def check_supported(d: DecodeConfig) -> None:
    """Raise NotImplementedError for the decode options the port does not
    do: ``infer_dtype`` other than float32 (ROADMAP.md queue 1, item 5.4).
    Ensembles (5.4) and a device mesh (5.8) are refused by ``Translator``."""
    if d.infer_dtype not in ("", "float32"):
        raise NotImplementedError(f"decode option not ported yet: infer_dtype={d.infer_dtype} "
                                  "(ROADMAP.md queue 1, item 5.4)")
    if d.pallas_step not in (0, 1, 2):
        raise NotImplementedError(f"decode option not ported yet: pallas_step={d.pallas_step}")


def make_translate_fn(model: VMMTModel, dcfg: DecodeConfig,
                      exclusion_ids: Tuple[int, ...] = ()) -> Callable:
    """fn(src (B,S) long, img (B,D) | None, streams=None) -> (tokens
    (B,K,L), scores (B,K)[, attn argmax (B,K,L)][, trace]). ``streams``
    (a ``DecodeStreams`` or an object with its ``latent_eps`` and
    ``token_gumbel``) supplies the draws of ``latent_from=sample`` and
    sampling."""
    check_supported(dcfg)
    K = dcfg.beam_size
    c = model.cfg
    mode = int(dcfg.pallas_step)
    fused_step = mode > 0 and fused_step_eligible(c)
    track_attn = dcfg.replace_unk or dcfg.coverage_beta != 0.0
    sampling = dcfg.sampling_temp > 0.0

    @torch.inference_mode()
    def fn(src: torch.Tensor, img: Optional[torch.Tensor], streams=None):
        B = src.shape[0]
        memory, finals, src_mask, summary = model.encode(src)
        z = None
        if model.is_latent:
            if dcfg.latent_from == "sample":
                mu_p, sigma_p = model.prior_params(summary, img)
                z = mu_p + sigma_p * streams.latent_eps(0, c.latent_dim)
            else:  # vmmt_f's prior mean is zero and ignores the image
                z = model.prior_latent(summary, img)
        carry0 = model.init_decode_carry(model.init_decoder_state(finals, z))
        keys = model.project_memory(memory, fused_step and mode == 1)
        if fused_step and mode == 2:
            keys = (keys,)
        # the kernels' weights, cast (and on the card padded) once a request
        weights = model.decoder.step_weights() if fused_step else None

        # the greedy fast path honors no min_length, attention, trace or
        # blocking; sampling shares its step and handles min_length itself
        if sampling or (K == 1 and not track_attn and not dcfg.dump_beam
                        and dcfg.min_length == 0 and dcfg.block_ngram_repeat == 0):
            def step1(carry, toks):
                carry, logits, _ = model.decode_step(carry, toks, memory, src_mask, z, keys,
                                                     weights)
                return carry, torch.log_softmax(logits, dim=-1)

            if sampling:
                tokens, scores = sampling_search(
                    step1, carry0, B, dcfg.max_length, streams.token_gumbel,
                    temperature=dcfg.sampling_temp, topk=dcfg.sampling_topk,
                    topp=dcfg.sampling_topp, min_length=dcfg.min_length)
            else:
                tokens, scores = greedy_search(step1, carry0, B, dcfg.max_length)
            return tokens[:, None, :], scores[:, None]

        # tile the read-only context across beams once per batch
        rep = lambda x: x.repeat_interleave(K, dim=0)  # noqa: E731
        mask_t, mem_t = rep(src_mask), rep(memory)
        z_t = None if z is None else rep(z)
        keys_t = tree_map(rep, keys)

        def step(carry, toks):
            carry, logits, align = model.decode_step(carry, toks, mem_t, mask_t, z_t, keys_t,
                                                     weights)
            logp = torch.log_softmax(logits, dim=-1)
            if track_attn:  # full probs: argmax for replace_unk, coverage
                return carry, logp, align.float()
            return carry, logp

        return beam_search(step, carry0, B, K, dcfg.max_length, dcfg.min_length,
                           dcfg.alpha, dcfg.length_penalty, return_attn=dcfg.replace_unk,
                           coverage_beta=dcfg.coverage_beta, src_mask=src_mask,
                           return_trace=dcfg.dump_beam,
                           block_ngram_repeat=dcfg.block_ngram_repeat,
                           exclusion_tokens=tuple(exclusion_ids))

    return fn


def _to_host(out):
    """The device outputs as numpy arrays (the trace's ``n_steps`` stays an int)."""
    host = []
    for x in out:
        if isinstance(x, dict):
            host.append({k: v.cpu().numpy() if torch.is_tensor(v) else v for k, v in x.items()})
        else:
            host.append(x.cpu().numpy())
    return tuple(host)


class Translator:
    """Text -> bucketed batches -> search on the device -> n-best text in
    corpus order. ``device`` defaults to cuda and raises without CUDA
    unless ``device='cpu'``; the model is moved there. ``streams`` builds
    each batch's random draws from (seed, stream ids); a test may replace
    it with a source of the JAX package's draws."""

    streams = DecodeStreams
    # corpus path: dispatched batches in flight at once (JAX :562-569)
    MAX_INFLIGHT_BATCHES = 4

    def __init__(self, model: VMMTModel, src_vocab: Vocab, tgt_vocab: Vocab,
                 dcfg: Optional[DecodeConfig] = None,
                 buckets: Sequence[int] = (16, 24, 32, 48, 64), mesh=None, device=None):
        if isinstance(model, (list, tuple)):
            raise NotImplementedError("ensembles are not ported yet (ROADMAP.md queue 1, "
                                      "item 5.4)")
        if mesh is not None:
            raise NotImplementedError("mesh (multi-device decode) is not ported yet "
                                      "(ROADMAP.md queue 1, item 5.8)")
        self.src_vocab = src_vocab
        self.tgt_vocab = tgt_vocab
        self.dcfg = dcfg or DecodeConfig()
        d = self.dcfg
        if d.latent_from not in ("mean", "sample"):
            raise ValueError(f"latent_from must be mean | sample, got {d.latent_from!r}")
        if d.latent_from == "sample" and not model.is_latent:
            raise ValueError("-latent_from sample: this model has no latent to sample "
                             "(model_type nmt decodes deterministically)")
        if d.sampling_temp < 0.0:
            raise ValueError(f"sampling_temp must be >= 0, got {d.sampling_temp}")
        if (d.sampling_topk or d.sampling_topp) and d.sampling_temp == 0.0:
            raise ValueError("-sampling_topk/-sampling_topp imply sampling; set "
                             "-sampling_temp > 0 (1.0 = untempered)")
        if d.sampling_temp > 0.0:
            bad = [flag for flag, on in (
                ("beam_size must be 1", d.beam_size != 1),
                ("n_best must be 1", d.n_best != 1),
                ("replace_unk unsupported", d.replace_unk),
                ("dump_beam unsupported", d.dump_beam),
                ("coverage_beta unsupported", d.coverage_beta != 0.0),
                ("block_ngram_repeat unsupported", d.block_ngram_repeat > 0),
            ) if on]
            if bad:
                raise ValueError("sampling decode (-sampling_temp > 0): " + "; ".join(bad))
        if d.block_ngram_repeat < 0:
            raise ValueError(f"block_ngram_repeat must be >= 0, got {d.block_ngram_repeat}")
        if d.ignore_when_blocking and d.block_ngram_repeat == 0:
            raise ValueError("-ignore_when_blocking requires -block_ngram_repeat > 0")
        # token strings -> target ids (absent tokens map to UNK)
        self._exclusion_ids = tuple(sorted({
            tgt_vocab.stoi.get(t, UNK) for t in d.ignore_when_blocking.split()
        })) if d.ignore_when_blocking else ()
        self._needs_rng = d.latent_from == "sample" or d.sampling_temp > 0.0
        if d.n_best > d.beam_size:
            raise ValueError(f"n_best ({d.n_best}) cannot exceed beam_size ({d.beam_size}): "
                             "the beam tracks beam_size hypotheses")
        self.buckets = list(buckets)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        # src -> tgt map consulted by replace_unk before copying the source token
        self.phrase_table: dict = {}
        self._fn = make_translate_fn(self.model, d, self._exclusion_ids)
        # raw search trees by corpus index, filled when dcfg.dump_beam
        self.beam_traces: dict = {}
        self._executor: Optional[ThreadPoolExecutor] = None

    def _device_thread(self) -> ThreadPoolExecutor:
        """The one thread that runs every batch's search, in dispatch order."""
        if self._executor is None:
            init = None
            if self.device.type == "cuda":
                index = self.device.index
                if index is None:
                    index = torch.cuda.current_device()
                init = lambda: torch.cuda.set_device(index)  # noqa: E731
            self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="vmmt-device",
                                                initializer=init)
        return self._executor

    def close(self) -> None:
        """Stop the device thread once its queued batches have run."""
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def _run_batch(self, batch, seed: int, stream_ids: Optional[np.ndarray]):
        """One batch's search, on the device thread; outputs on the host."""
        with torch.inference_mode():
            src = torch.from_numpy(np.asarray(batch.src)).long().to(self.device)
            img = None if batch.img is None else torch.from_numpy(batch.img).to(self.device)
            streams = None
            if self._needs_rng:
                # padded rows reuse index 0; their output is masked out
                idx = np.asarray(batch.indices)
                if stream_ids is not None:
                    idx = stream_ids[idx]
                streams = self.streams(seed, torch.from_numpy(idx.astype(np.int64))
                                       .to(self.device))
            return _to_host(self._fn(src, img, streams))

    def dispatch_ids(self, src_ids: List[List[int]], img_feats: Optional[np.ndarray] = None,
                     seed: Optional[int] = None,
                     stream_ids: Optional[Sequence[int]] = None) -> "PendingTranslation":
        """Queue a corpus's device work without waiting for it; pass the
        handle to :meth:`finalize_ids`. ``seed`` overrides
        ``dcfg.decode_seed`` for this call; ``stream_ids`` (one int a
        sentence) replaces the corpus position as each sentence's stream
        key, so a sampled answer keyed by a caller's id does not depend on
        how the batcher grouped it. Both are ignored by deterministic
        decodes. Not pipeline-safe with ``dump_beam`` (the trace dict on
        ``self`` is keyed by per-call corpus indices)."""
        return PendingTranslation(
            list(self._dispatch_iter(src_ids, img_feats, seed, stream_ids)), len(src_ids))

    def _dispatch_iter(self, src_ids, img_feats, seed=None, stream_ids=None):
        """Yield (host Batch, future of its outputs), queueing each batch on
        the device thread as the consumer iterates."""
        if self.dcfg.dump_beam:
            self.beam_traces = {}
        streams = None
        if stream_ids is not None:
            if len(stream_ids) != len(src_ids):
                raise ValueError(f"stream_ids must have one entry per sentence: got "
                                 f"{len(stream_ids)} for {len(src_ids)} sentences")
            streams = np.asarray(stream_ids, np.int64)
        seed = self.dcfg.decode_seed if seed is None else seed
        ds = BinarizedDataset([np.asarray(s, np.int32) for s in src_ids])
        # catch-all bucket: a longer source is encoded in full, not truncated
        buckets = buckets_with_catchall(self.buckets, max([1] + [len(s) for s in src_ids]))
        it = BucketIterator(ds, batch_size=self.dcfg.batch_size, buckets=buckets,
                            img_feats=img_feats)
        device = self._device_thread()
        for batch in it.epoch(0):
            yield batch, device.submit(self._run_batch, batch, seed, streams)

    def finalize_ids(self, pending: "PendingTranslation") -> List[List[tuple]]:
        """Wait for a :meth:`dispatch_ids` handle and build each sentence's
        n-best [(score, ids)] in corpus order; with ``replace_unk`` the
        entries are (score, ids, attention positions)."""
        results: dict = {}
        for batch, out in pending.batches:
            self._finalize_batch(batch, out, results)
        return [results[i] for i in range(pending.n)]

    def _finalize_batch(self, batch, out: Future, results: dict) -> None:
        """Host postprocessing of one dispatched batch into ``results``."""
        out = out.result()
        tokens, scores = out[0], out[1]
        trace = out[-1] if self.dcfg.dump_beam else None
        attn = out[2] if self.dcfg.replace_unk else None
        for row in range(batch.batch_size):
            if batch.example_mask[row] == 0:
                continue
            i = int(batch.indices[row])
            if trace is not None:
                n = int(trace["n_steps"])
                self.beam_traces[i] = {
                    "parents": trace["parents"][row, :, :n].tolist(),
                    "tokens": trace["tokens"][row, :, :n].tolist(),
                    "scores": trace["scores"][row, :, :n].tolist(),
                    "order": trace["order"][row].tolist(),
                }
            nbest = []
            for k in range(self.dcfg.n_best):
                ids = _strip(tokens[row, k])
                if attn is not None:
                    nbest.append((float(scores[row, k]), ids, attn[row, k, :len(ids)].tolist()))
                else:
                    nbest.append((float(scores[row, k]), ids))
            results[i] = nbest

    def translate_ids(self, src_ids: List[List[int]], img_feats: Optional[np.ndarray] = None,
                      seed: Optional[int] = None,
                      stream_ids: Optional[Sequence[int]] = None) -> List[List[tuple]]:
        """Per input sentence, the n-best list [(score, token_ids)] (with
        ``replace_unk``, (score, token_ids, attention positions)). Up to
        MAX_INFLIGHT_BATCHES batches are queued ahead of the one being
        postprocessed."""
        results: dict = {}
        window: deque = deque()
        for pair in self._dispatch_iter(src_ids, img_feats, seed, stream_ids):
            window.append(pair)
            if len(window) >= self.MAX_INFLIGHT_BATCHES:
                self._finalize_batch(*window.popleft(), results)
        while window:
            self._finalize_batch(*window.popleft(), results)
        return [results[i] for i in range(len(src_ids))]

    def nbest_to_text(self, nbest: List[tuple], src_tokens: Optional[List[str]] = None,
                      debpe: bool = True, keep_ids: bool = False) -> List[tuple]:
        """One sentence's n-best [(score, ids[, attn])] -> [(score, text)]:
        vocab decode, ``replace_unk`` (the max-attention source token,
        looked up in the phrase table first), BPE removal."""
        pt = self.phrase_table
        sent = []
        for entry in nbest:
            score, ids = entry[0], entry[1]
            if len(entry) == 3 and src_tokens is not None:
                toks = self.tgt_vocab.decode(ids, strip_special=False)
                toks = [
                    pt.get(s := src_tokens[min(entry[2][j], len(src_tokens) - 1)], s)
                    if t == UNK_TOK and src_tokens else t
                    for j, t in enumerate(toks)
                ]
                text = " ".join(remove_bpe(toks) if debpe else toks)
            else:
                text = self.tgt_vocab.ids_to_text(ids, debpe)
            sent.append((score, text, ids) if keep_ids else (score, text))
        return sent

    def translate_tokens(self, src_tokens: List[List[str]],
                         img_feats: Optional[np.ndarray] = None, debpe: bool = True,
                         keep_ids: bool = False,
                         src_ids: Optional[List[List[int]]] = None) -> List[List[tuple]]:
        """``keep_ids``: entries (score, text, ids); ``src_ids``: the
        sources already encoded."""
        if src_ids is None:
            src_ids = [self.src_vocab.encode(t) for t in src_tokens]
        return [self.nbest_to_text(nbest, src_tokens[i], debpe=debpe, keep_ids=keep_ids)
                for i, nbest in enumerate(self.translate_ids(src_ids, img_feats))]


class PendingTranslation:
    """In-flight work from :meth:`Translator.dispatch_ids`: (host Batch,
    future of its outputs) pairs and the corpus size."""

    __slots__ = ("batches", "n")

    def __init__(self, batches: List[tuple], n: int):
        self.batches = batches
        self.n = n

    def ready(self) -> bool:
        """True once the device thread has finished every batch (its last
        one: it runs them in order). Never raises: a failed batch reports
        ready and its error surfaces in the blocking finalize."""
        return not self.batches or self.batches[-1][1].done()


def _strip(ids: np.ndarray) -> List[int]:
    """Cut at EOS, drop PAD."""
    out = []
    for i in ids.tolist():
        if i == EOS:
            break
        if i != PAD:
            out.append(i)
    return out
