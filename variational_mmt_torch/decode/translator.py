"""Batch translation. Mirrors ``variational_mmt_tpu/decode/translator.py``:
``_combine_logps`` (:31-46), the inference dtypes
``quantize_params_int8``, ``dequantize_params`` and
``cast_params_for_inference`` (:52-119), ``make_translate_fn`` (:121-279)
and ``Translator`` (:282-684: the option checks, ``dispatch_ids``/
``finalize_ids`` and ``PendingTranslation``, ``translate_ids``,
``nbest_to_text`` with ``replace_unk`` and a phrase table,
``translate_tokens``).

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

A checkpoint ensemble is a list of models (families and depths may differ;
the vocabs must match): each member keeps its own memory, z, attention
keys, kernel weights and carry, and the search runs on the members'
combined next-token distribution (``DecodeConfig.ensemble_mode``).
``DecodeConfig.infer_dtype`` sets the weights the translator holds:
float32 (the models' own tensors where they already lie on the device),
bfloat16 (a cast copy), or int8 codes with an f32 scale a last-axis column
for every weight of two or more dimensions (1-D leaves stay f32), rebuilt
as bfloat16 inside each call and dropped after it. Those weights reach the models' code through
``torch.func.functional_call`` over parameterless copies of the members.

JAX dispatches asynchronously; the port's search syncs with the host every
step, so ``dispatch_ids`` hands each batch to one device-owning thread (a
single-thread executor that sets the CUDA device and runs under
``inference_mode``) and returns at once; ``finalize_ids`` waits on its
futures. Host code maps text to ids, buckets the corpus and regroups the
n-best lists in corpus order.

``mesh`` (parallel/mesh.py; JAX :381-419, :492-515): every rank of it
builds the Translator from the same full weights and calls the same
methods with the same corpus. Each data rank decodes its rows of every
batch, as JAX shards the batch, and the n-best lists are gathered to
every rank, in corpus order. With several model ranks the weights are
this rank's vocab-parallel shard (int8 codes and scales sharded by the
tensors' rules, after quantizing the full tensors, as JAX does), each
step's logits are gathered to the full V before ``log_softmax``, and the
search then runs as on one device. An ensemble does not compose with
tensor parallelism (JAX's refusal).
"""

from __future__ import annotations

import math
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from variational_mmt_torch.config import DecodeConfig
from variational_mmt_torch.data.bpe import remove_bpe
from variational_mmt_torch.data.dataset import (BinarizedDataset, BucketIterator,
                                                buckets_with_catchall)
from variational_mmt_torch.data.vocab import EOS, PAD, UNK, UNK_TOK, Vocab
from variational_mmt_torch.decode.streams import DecodeStreams
from variational_mmt_torch.device import resolve_device
from variational_mmt_torch.models.decoder import fused_step_eligible
from variational_mmt_torch.models.model import VMMTModel
from variational_mmt_torch.parallel import mesh as pm, tp
from variational_mmt_torch.ops.beam import (beam_search, greedy_search, sampling_search,
                                            tree_map)

def check_supported(d: DecodeConfig) -> None:
    """Raise NotImplementedError for the decode options the port does not
    do."""
    if d.pallas_step not in (0, 1, 2):
        raise NotImplementedError(f"decode option not ported yet: pallas_step={d.pallas_step}")


def _combine_logps(logps: List[torch.Tensor], mode: str) -> torch.Tensor:
    """The members' next-token log-distributions combined: ``prob`` is the
    mean in probability space (logsumexp - log M), ``logprob`` the mean of
    the log-probabilities (a geometric mean, unnormalized). The identity
    for one member."""
    if len(logps) == 1:
        return logps[0]
    stacked = torch.stack(logps, dim=0)
    if mode == "prob":
        return torch.logsumexp(stacked, dim=0) - math.log(len(logps))
    if mode != "logprob":
        raise ValueError(f"unknown ensemble_mode: {mode!r} (expected prob | logprob)")
    return stacked.mean(dim=0)


_QKEYS = frozenset(("int8", "scale"))


def quantize_params_int8(params: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """Weight-only int8 of a state dict: every floating tensor of two or
    more dimensions becomes ``{"int8": q, "scale": s}`` with a symmetric
    scale a last-axis column (max |x| over the other axes / 127, at least
    the smallest normal f32), ``q = clip(round(x / s), -127, 127)``
    rounding half to even; other tensors are kept as they are. The port
    keeps JAX's layouts, so the column is JAX's output channel and the
    codes equal JAX's bit for bit."""
    def leaf(x: torch.Tensor):
        if x.dim() < 2 or not x.is_floating_point():
            return x
        xf = x.float()
        amax = xf.abs().amax(dim=tuple(range(x.dim() - 1)))
        # a tensor divisor: CUDA turns division by a Python number into a
        # product with its reciprocal, which rounds differently
        scale = torch.clamp(amax / torch.full_like(amax, 127.0),
                            min=torch.finfo(torch.float32).tiny)
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        return {"int8": q, "scale": scale}

    return {name: leaf(x) for name, x in params.items()}


def dequantize_params(params: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_params_int8`: each pair becomes
    ``(q * s).to(bfloat16)`` (an f32 product, then one rounding); other
    entries pass through."""
    return {name: ((v["int8"].float() * v["scale"]).to(torch.bfloat16)
                   if isinstance(v, Mapping) and set(v) == _QKEYS else v)
            for name, v in params.items()}


def cast_params_for_inference(params: Mapping[str, torch.Tensor],
                              dtype_name: str) -> Dict[str, object]:
    """A state dict for decoding at ``dtype_name``: float32 (as given),
    bfloat16 (every floating tensor cast; modules that compute in f32
    widen the rounded values on use) or int8 (:func:`quantize_params_int8`)."""
    if dtype_name in ("", "float32"):
        return dict(params)
    if dtype_name == "int8":
        return quantize_params_int8(params)
    if dtype_name != "bfloat16":
        raise ValueError(f"infer_dtype must be float32 | bfloat16 | int8, got {dtype_name!r}")
    return {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in params.items()}


def make_translate_fn(model, dcfg: DecodeConfig,
                      exclusion_ids: Tuple[int, ...] = ()) -> Callable:
    """fn(src (B,S) long, img (B,D) | None, streams=None) -> (tokens
    (B,K,L), scores (B,K)[, attn argmax (B,K,L)][, trace]). ``model`` is a
    VMMTModel or a list of them (an ensemble: the search expands on the
    members' combined distribution, ``dcfg.ensemble_mode``; with
    ``track_attn`` the attention is the member mean in f32). ``streams``
    (a ``DecodeStreams`` or an object with its ``latent_eps`` and
    ``token_gumbel``) supplies the draws of ``latent_from=sample`` (member
    j's from ``latent_eps(j, latent_dim)``) and of sampling. ``fn.routes``
    names each member's decode step: ``decode_step`` (pallas_step 1),
    ``gru_chain`` (2) or ``plain`` (0, or a decoder the step kernels do not
    compute, as in JAX)."""
    check_supported(dcfg)
    models = list(model) if isinstance(model, (list, tuple)) else [model]
    K = dcfg.beam_size
    mode = int(dcfg.pallas_step)
    # fused-step eligibility is each member's own
    fused = [mode > 0 and fused_step_eligible(m.cfg) for m in models]
    track_attn = dcfg.replace_unk or dcfg.coverage_beta != 0.0
    sampling = dcfg.sampling_temp > 0.0

    def combined_step(members, src_mask):
        """step(carries, toks) over the members (model, memory, z, keys,
        weights): their new carries, the combined log-probabilities and,
        with ``track_attn``, the member-mean attention."""
        def step(carries, toks):
            new, logps, aligns = [], [], []
            for (m, memory, z, keys, weights), c in zip(members, carries):
                c, logits, align = m.decode_step(c, toks, memory, src_mask, z, keys, weights)
                new.append(c)
                logps.append(torch.log_softmax(logits, dim=-1))
                aligns.append(align)
            logp = _combine_logps(logps, dcfg.ensemble_mode)
            if track_attn:  # full probs: argmax for replace_unk, coverage
                attn = (aligns[0].float() if len(aligns) == 1
                        else torch.stack([a.float() for a in aligns]).mean(0))
                return tuple(new), logp, attn
            return tuple(new), logp
        return step

    @torch.inference_mode()
    def fn(src: torch.Tensor, img: Optional[torch.Tensor], streams=None):
        B = src.shape[0]
        members, carry0 = [], []
        for j, (m, fused_step) in enumerate(zip(models, fused)):
            memory, finals, src_mask, summary = m.encode(src)
            z = None
            if m.is_latent:
                if dcfg.latent_from == "sample":
                    mu_p, sigma_p = m.prior_params(summary, img)
                    z = mu_p + sigma_p * streams.latent_eps(j, m.cfg.latent_dim)
                else:  # vmmt_f's prior mean is zero and ignores the image
                    z = m.prior_latent(summary, img)
            carry0.append(m.init_decode_carry(m.init_decoder_state(finals, z)))
            keys = m.project_memory(memory, fused_step and mode == 1)
            if fused_step and mode == 2:
                keys = (keys,)
            # the kernels' weights, cast (and on the card padded) once a request
            weights = m.decoder.step_weights() if fused_step else None
            members.append((m, memory, z, keys, weights))
        carry0 = tuple(carry0)

        # the greedy fast path honors no min_length, attention, trace or
        # blocking; sampling shares its step and handles min_length itself
        if sampling or (K == 1 and not track_attn and not dcfg.dump_beam
                        and dcfg.min_length == 0 and dcfg.block_ngram_repeat == 0):
            step1 = combined_step(members, src_mask)
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
        tiled = [(m, rep(memory), None if z is None else rep(z), tree_map(rep, keys), weights)
                 for m, memory, z, keys, weights in members]
        return beam_search(combined_step(tiled, rep(src_mask)), carry0, B, K,
                           dcfg.max_length, dcfg.min_length, dcfg.alpha, dcfg.length_penalty,
                           return_attn=dcfg.replace_unk, coverage_beta=dcfg.coverage_beta,
                           src_mask=src_mask, return_trace=dcfg.dump_beam,
                           block_ngram_repeat=dcfg.block_ngram_repeat,
                           exclusion_tokens=tuple(exclusion_ids))

    fn.routes = [("plain", "decode_step", "gru_chain")[mode] if f else "plain" for f in fused]
    return fn


class _Members(nn.Module):
    """The members as one module whose forward is the translate function,
    so that ``functional_call`` lends every member a call's weights."""

    def __init__(self, models: List[VMMTModel], fn: Callable):
        super().__init__()
        self.members = nn.ModuleList(models)
        self.fn = fn

    def forward(self, src, img, streams):
        return self.fn(src, img, streams)


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
    corpus order. ``model`` is a VMMTModel or a list of them (an ensemble);
    ``params``, optional, one state dict a member (a bare one for a single
    model), replaces the members' own weights. ``device`` defaults to cuda
    and raises without CUDA unless ``device='cpu'``. The translator keeps
    the weights there (``weights``, one state dict a member: at float32 the
    members' own tensors where they already lie there, else copies;
    bfloat16 tensors; or int8 codes and scales) and lends them per call to
    parameterless copies of the members; the models are left as they are
    (a model in host memory stays there). ``streams`` builds each
    batch's random draws from (seed, stream ids); a test may replace it
    with a source of the JAX package's draws. ``mesh``: decode across ranks
    (module docstring); the device is then ``mesh.device``."""

    streams = DecodeStreams
    # corpus path: dispatched batches in flight at once (JAX :562-569)
    MAX_INFLIGHT_BATCHES = 4

    def __init__(self, model, src_vocab: Vocab, tgt_vocab: Vocab,
                 dcfg: Optional[DecodeConfig] = None,
                 buckets: Sequence[int] = (16, 24, 32, 48, 64), mesh=None, device=None,
                 params=None):
        models = list(model) if isinstance(model, (list, tuple)) else [model]
        if mesh is not None:
            if not isinstance(mesh, pm.Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), got "
                                f"{type(mesh).__name__}")
            if mesh.n_model > 1 and len(models) > 1:
                raise ValueError("ensemble decode does not compose with tensor "
                                 "parallelism; use a data-only mesh")
            b = (dcfg or DecodeConfig()).batch_size
            if b % mesh.n_data:
                raise ValueError(f"decode batch_size {b} must divide by the data-parallel "
                                 f"degree {mesh.n_data}")
            for m in models:
                tp.validate_tp_divisibility(m.cfg, mesh.n_model)
            device = mesh.device if device is None else device
        self.mesh = mesh
        vm = tp.vocab_mesh(mesh)
        if isinstance(params, (list, tuple)):
            if len(params) != len(models):
                raise ValueError(f"{len(models)} ensemble members but {len(params)} "
                                 "param trees")
        elif params is not None:
            if len(models) > 1:
                raise ValueError(f"{len(models)} ensemble members need a matching sequence "
                                 "of param trees, got a single tree")
            params = [params]
        self.src_vocab = src_vocab
        self.tgt_vocab = tgt_vocab
        self.dcfg = dcfg or DecodeConfig()
        d = self.dcfg
        if d.latent_from not in ("mean", "sample"):
            raise ValueError(f"latent_from must be mean | sample, got {d.latent_from!r}")
        if d.latent_from == "sample" and not any(m.is_latent for m in models):
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
        # parameterless copies: each call lends them the translator's weights
        with torch.device("meta"):
            self.models = [VMMTModel(m.cfg, vm).eval() for m in models]
        held: Dict[int, Dict[str, object]] = {}  # a model given twice is held once
        self.weights: List[Dict[str, object]] = []
        for j, m in enumerate(models):
            state = m.state_dict() if params is None else params[j]
            if params is None and m.vocab_mesh is not None:
                state = tp.gather_params(state, m.vocab_mesh)  # a shard: the full weights
            names = set(self.models[j].state_dict())
            if set(state) != names:
                raise KeyError(f"member {j}: parameter names differ from its model's: "
                               f"missing {sorted(names - set(state))}, unexpected "
                               f"{sorted(set(state) - names)}")
            key = id(m) if params is None else id(params[j])
            if key not in held:
                held[key] = self._own_weights(state, d.infer_dtype)
            self.weights.append(held[key])
        # src -> tgt map consulted by replace_unk before copying the source token
        self.phrase_table: dict = {}
        self._fn = make_translate_fn(self.models, d, self._exclusion_ids)
        # each member's decode step: decode_step | gru_chain | plain
        self.step_routes: List[str] = self._fn.routes
        self._members = _Members(self.models, self._fn)
        # raw search trees by corpus index, filled when dcfg.dump_beam
        self.beam_traces: dict = {}
        self._executor: Optional[ThreadPoolExecutor] = None

    def _own_weights(self, state: Mapping, dtype_name: str) -> Dict[str, object]:
        """One member's weights at ``dtype_name`` on the device, cast where
        ``state`` lies (only the cast copy reaches the device; float32
        tensors already there are used as they are); under a mesh of
        several model ranks, this rank's shard of the cast weights."""
        state = {k: torch.as_tensor(v).detach() for k, v in state.items()}
        cast = tp.shard_params(cast_params_for_inference(state, dtype_name),
                               tp.vocab_mesh(self.mesh))
        return {k: ({q: t.to(self.device) for q, t in v.items()} if isinstance(v, dict)
                    else v.to(self.device))
                for k, v in cast.items()}

    def weight_bytes(self) -> int:
        """Bytes of the weights the translator holds between calls."""
        held = {id(w): w for w in self.weights}.values()
        return sum(t.numel() * t.element_size() for w in held for v in w.values()
                   for t in (v.values() if isinstance(v, dict) else (v,)))

    def _call(self, src: torch.Tensor, img: Optional[torch.Tensor], streams):
        """The translate function on one batch with the translator's
        weights (int8 rebuilt as bfloat16 for this call only)."""
        lent = {f"members.{j}.{k}": v for j, w in enumerate(self.weights)
                for k, v in dequantize_params(w).items()}
        return torch.func.functional_call(self._members, lent, (src, img, streams))

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
            return _to_host(self._call(src, img, streams))

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
            if self.mesh is not None:  # this data rank's rows
                batch = pm.shard_batch(batch, self.mesh)
            yield batch, device.submit(self._run_batch, batch, seed, streams)

    def finalize_ids(self, pending: "PendingTranslation") -> List[List[tuple]]:
        """Wait for a :meth:`dispatch_ids` handle and build each sentence's
        n-best [(score, ids)] in corpus order; with ``replace_unk`` the
        entries are (score, ids, attention positions)."""
        results: dict = {}
        for batch, out in pending.batches:
            self._finalize_batch(batch, out, results)
        results = self._gathered(results)
        return [results[i] for i in range(pending.n)]

    def _gathered(self, results: dict) -> dict:
        """Under a mesh of several data ranks, every rank's n-best lists
        (and search trees) merged, on every rank."""
        if self.mesh is None or self.mesh.n_data == 1:
            return results
        merged: dict = {}
        for part, traces in pm.gather_objects((results, self.beam_traces)):
            merged.update(part)
            self.beam_traces.update(traces)
        return merged

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
        results = self._gathered(results)
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
