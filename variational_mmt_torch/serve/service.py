"""Online translation service with dynamic batching. Mirrors
``variational_mmt_tpu/serve/service.py``.

Requests arrive one at a time; a worker thread coalesces them into the
offline path's device shapes. Every group is padded to
``DecodeConfig.batch_size`` rows (``BucketIterator`` does the padding), so
each device call has the shape the offline ``Translator`` gives the same
bucket, and answers equal the offline path's. The worker waits at most
``max_wait_ms`` after the first request for a batch to fill, then
dispatches the group through ``Translator.dispatch_ids``, which hands it
to the translator's device thread; with ``pipeline_depth`` 2 it gathers
the next group while that one runs. Tokenization and vocab encoding run on
the caller's thread at submit time.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from variational_mmt_torch.cli.loading import consumes_decode_feats
from variational_mmt_torch.config import DecodeConfig
from variational_mmt_torch.data.bpe import BPE
from variational_mmt_torch.data.tokenizer import tokenize
from variational_mmt_torch.data.vocab import Vocab
from variational_mmt_torch.decode.translator import Translator
from variational_mmt_torch.serve.errors import ClientError


@dataclass
class ServeConfig:
    """Online-serving knobs (on top of DecodeConfig's search knobs)."""

    max_wait_ms: float = 5.0  # batching window after the first queued request
    warmup: bool = True  # run every (bucket x batch) shape once at startup
    lower: bool = True  # lowercase incoming text (reference preprocessing)
    queue_capacity: int = 4096  # back-pressure: submit blocks when full
    conv_regions: int = 49  # rows per conv feature map (ResNet 7x7 grid)
    # longest accepted source in post-BPE tokens (0 = the largest bucket; a
    # larger value adds a warmed bucket of that length); anything longer is
    # rejected, or truncated with over_length="truncate", at submit time
    max_src_tokens: int = 0
    over_length: str = "reject"  # "reject" -> client error | "truncate"
    # 2 = two-deep pipelined worker (gather and dispatch group N+1 while N
    # runs on the device); 1 = collect -> dispatch -> finalize, one group
    # at a time; 0 = auto: 1 on single-core hosts, 2 otherwise (JAX's rule).
    pipeline_depth: int = 0

    def resolved_pipeline_depth(self) -> int:
        if self.pipeline_depth in (1, 2):
            return self.pipeline_depth
        return 1 if (os.cpu_count() or 1) <= 1 else 2


@dataclass
class _Request:
    ids: List[int]  # vocab-encoded source (encoded on the caller's thread)
    img: Optional[np.ndarray]
    # maps the raw n-best [(score, ids[, attn])] to the caller's payload;
    # None: the future resolves to the raw n-best (the dispatchers' wire)
    postproc: Optional[callable] = None
    # time.monotonic() past which the caller has stopped waiting; the
    # worker sheds expired requests at dispatch time
    deadline: Optional[float] = None
    # the request's random stream on a sampling service: the answer depends
    # on (seed, sample_id, source, image), not on how it was grouped
    sample_id: int = 0
    future: Future = field(default_factory=Future)


class TranslationService:
    """Queue + worker-thread dynamic batcher over a :class:`Translator`.

    Thread-safe: any number of producer threads may call :meth:`submit_text`
    / :meth:`translate_text`; one worker dispatches to the translator's
    device thread. ``model`` is a model or a list of them (an ensemble,
    whose vocabs and vmmt_c image interfaces the caller has checked);
    ``device`` is the Translator's (cuda unless 'cpu'). ``mesh`` is refused:
    serving across ranks needs every rank to follow rank 0's batches
    (ROADMAP.md queue 1, item 5.10)."""

    def __init__(self, model, src_vocab: Vocab, tgt_vocab: Vocab,
                 dcfg: Optional[DecodeConfig] = None,
                 buckets: Sequence[int] = (16, 24, 32, 48, 64),
                 scfg: Optional[ServeConfig] = None, bpe: Optional[BPE] = None, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError("serving across ranks is not ported yet: the other "
                                      "ranks would wait in rank 0's collectives "
                                      "(ROADMAP.md queue 1, item 5.10)")
        self.dcfg = dcfg or DecodeConfig()
        self.scfg = scfg or ServeConfig()
        # resolved once, so the worker and the stats report one mode
        self.pipeline_depth = self.scfg.resolved_pipeline_depth()
        self.bpe = bpe
        self.models = list(model) if isinstance(model, (list, tuple)) else [model]
        self.model = self.models[0]
        # the image's width, when decoding reads one: a vmmt_c member's (the
        # one consumer at decode) before any other member that has one
        img_members = [m for m in self.models if consumes_decode_feats(m.cfg)] or [
            m for m in self.models
            if (m.is_latent or m.cfg.use_img_predict) and m.cfg.img_feat_dim > 0]
        self._img_cfg = img_members[0].cfg if img_members else None
        self._img_dim = self._img_cfg.img_feat_dim if self._img_cfg else 0
        if self.scfg.over_length not in ("reject", "truncate"):
            raise ValueError(f"over_length must be 'reject' or 'truncate', got "
                             f"{self.scfg.over_length!r}")
        if self.scfg.max_src_tokens < 0:
            raise ValueError(f"max_src_tokens must be >= 0, got {self.scfg.max_src_tokens}")
        self._src_cap = self.scfg.max_src_tokens or max(buckets)
        if self._src_cap > max(buckets):
            buckets = list(buckets) + [self._src_cap]  # warmed like the rest
        self.translator = Translator(model, src_vocab, tgt_vocab, self.dcfg, buckets=buckets,
                                     mesh=mesh, device=device)
        self._samples = self.dcfg.sampling_temp > 0.0 or self.dcfg.latent_from == "sample"
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue(
            maxsize=self.scfg.queue_capacity)
        self.stats: Dict[str, float] = {
            "requests": 0,
            "batches": 0,
            "batched_requests": 0,  # requests that shared a device call
            "shed": 0,  # expired before dispatch (the caller's timeout passed)
            "busy_s": 0.0,
        }
        self._stats_lock = threading.Lock()
        self._stopped = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True, name="vmmt-serve")
        self._worker.start()
        if self.scfg.warmup:
            self.warmup()

    # -- producer API ----------------------------------------------------

    def _validated(self, tokens: List[str], img: Optional[np.ndarray]
                   ) -> Tuple[List[str], Optional[np.ndarray]]:
        """The over-length policy and the image default and shape check;
        raises ClientError without side effects, so a multi-sentence
        request is validated whole before any of it is enqueued."""
        if not tokens:
            # an all-PAD source decodes to confident garbage
            raise ClientError("empty source: the text contains no tokens after tokenization")
        if len(tokens) > self._src_cap:
            if self.scfg.over_length == "truncate":
                tokens = tokens[: self._src_cap]
            else:
                raise ClientError(
                    f"source has {len(tokens)} tokens but this server caps at "
                    f"{self._src_cap} (every accepted length is warmed at startup; raise "
                    "ServeConfig.max_src_tokens or set over_length='truncate')")
        if self._img_dim and img is None:
            # a request without an image gets the zero feature vector
            img = np.zeros(self._feat_shape(), np.float32)
        if img is not None:
            img = np.asarray(img, np.float32)
            want = self._feat_shape()
            if want and img.shape != want:
                raise ClientError(f"img features must have shape {want}, got {img.shape}")
        return tokens, img

    def _checked_sample_id(self, sample_id: int) -> int:
        """A nonzero sample_id means nothing on a deterministic service,
        which is a client mistake worth surfacing."""
        sample_id = int(sample_id)
        if sample_id != 0 and not self._samples:
            raise ClientError(
                "sample_id is only meaningful on a sampling service "
                "(DecodeConfig.sampling_temp > 0 or latent_from='sample'); "
                "this server decodes deterministically")
        if sample_id < 0:
            raise ClientError(f"sample_id must be >= 0, got {sample_id}")
        return sample_id

    def _checked_sample_ids(self, sample_ids, n: int) -> List[int]:
        if sample_ids is None:
            return [0] * n
        if len(sample_ids) != n:
            raise ClientError(f"sample_ids must have one entry per sentence: got "
                              f"{len(sample_ids)} for {n}")
        return [self._checked_sample_id(s) for s in sample_ids]

    def _enqueue(self, ids: List[int], img: Optional[np.ndarray], postproc=None,
                 timeout_s: Optional[float] = None, sample_id: int = 0) -> Future:
        deadline = time.monotonic() + timeout_s if timeout_s is not None else None
        req = _Request(ids=ids, img=img, postproc=postproc, deadline=deadline,
                       sample_id=sample_id)
        self._q.put(req)
        with self._stats_lock:
            self.stats["requests"] += 1
        return req.future

    def _text_postproc(self, src_tokens: List[str]):
        """Vocab decode, replace_unk and BPE removal: the offline
        ``translate_tokens`` path of one sentence."""
        def pp(nbest):
            return self.translator.nbest_to_text(nbest, src_tokens)
        return pp

    def submit_tokens(self, tokens: List[str], img: Optional[np.ndarray] = None,
                      timeout_s: Optional[float] = None, sample_id: int = 0) -> Future:
        """Enqueue one tokenized sentence; resolves to its n-best
        [(score, text), ...]. ``timeout_s``: how long the caller will wait;
        a request still queued past it is shed, not computed."""
        if self._stopped.is_set():
            raise RuntimeError("service stopped")
        sample_id = self._checked_sample_id(sample_id)
        tokens, img = self._validated(tokens, img)
        return self._enqueue(self.translator.src_vocab.encode(tokens), img,
                             self._text_postproc(tokens), timeout_s=timeout_s,
                             sample_id=sample_id)

    def submit_tokens_batch(self, tokens_list: Sequence[List[str]],
                            imgs: Optional[np.ndarray] = None,
                            timeout_s: Optional[float] = None,
                            sample_ids: Optional[Sequence[int]] = None) -> List[Future]:
        """Validate every sentence of a request, then enqueue all of them:
        a rejection costs no device work."""
        if self._stopped.is_set():
            raise RuntimeError("service stopped")
        sids = self._checked_sample_ids(sample_ids, len(tokens_list))
        pairs = [self._validated(toks, None if imgs is None else imgs[i])
                 for i, toks in enumerate(tokens_list)]
        return [self._enqueue(self.translator.src_vocab.encode(toks), img,
                              self._text_postproc(toks), timeout_s=timeout_s, sample_id=sid)
                for (toks, img), sid in zip(pairs, sids)]

    def submit_ids_batch(self, ids_list: Sequence[List[int]], imgs: Optional[np.ndarray] = None,
                         timeout_s: Optional[float] = None,
                         sample_ids: Optional[Sequence[int]] = None) -> List[Future]:
        """The id-level twin of :meth:`submit_tokens_batch` (the dispatchers'
        wire): futures resolve to the raw n-best [(score, ids), ...]."""
        if self._stopped.is_set():
            raise RuntimeError("service stopped")
        sids = self._checked_sample_ids(sample_ids, len(ids_list))
        pairs = [self._validated(list(ids), None if imgs is None else imgs[i])
                 for i, ids in enumerate(ids_list)]
        return [self._enqueue(ids, img, timeout_s=timeout_s, sample_id=sid)
                for (ids, img), sid in zip(pairs, sids)]

    def _text_to_tokens(self, text: str) -> List[str]:
        toks = tokenize(text, lower=self.scfg.lower)
        if self.bpe is not None:
            toks = self.bpe.segment(toks)
        return toks

    def submit_text(self, text: str, img: Optional[np.ndarray] = None,
                    timeout_s: Optional[float] = None, sample_id: int = 0) -> Future:
        return self.submit_tokens(self._text_to_tokens(text), img, timeout_s=timeout_s,
                                  sample_id=sample_id)

    def translate_text(self, texts: Sequence[str], imgs: Optional[np.ndarray] = None,
                       timeout: float = 120.0,
                       sample_ids: Optional[Sequence[int]] = None) -> List[List]:
        """Submit all, wait for all; ``timeout`` is also the shed deadline."""
        futs = self.submit_tokens_batch([self._text_to_tokens(t) for t in texts], imgs,
                                        timeout_s=timeout, sample_ids=sample_ids)
        return [f.result(timeout=timeout) for f in futs]

    # -- lifecycle -------------------------------------------------------

    def warmup(self) -> None:
        """Run every bucket's (bucket x batch_size) shape once before
        serving, so the kernels' first use and cuBLAS's handles are paid
        before the first request (one sentence of exactly the bucket's
        length; the batch pads to batch_size)."""
        unk = self.translator.src_vocab.encode(["warmup"])[0]
        for b in self.translator.buckets:
            feats = np.zeros((1,) + self._feat_shape(), np.float32) if self._img_dim else None
            self.translator.translate_ids([[unk] * max(1, b)], feats)

    def stop(self, timeout: float = 10.0) -> None:
        self._stopped.set()
        self._q.put(None)
        self._worker.join(timeout=timeout)
        # a submit that raced past the stopped-check may sit behind the
        # sentinel: fail it instead of leaving its caller waiting
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not None and not req.future.done():
                try:
                    req.future.set_exception(RuntimeError("service stopped"))
                except Exception:  # noqa: BLE001 — cancelled race
                    pass
        self.translator.close()

    # -- worker ----------------------------------------------------------

    def _feat_shape(self):
        if not self._img_dim:
            return ()
        if self._img_cfg.img_feat_type == "conv":
            return (self.scfg.conv_regions, self._img_dim)
        return (self._img_dim,)

    def _collect(self, group: Optional[List[_Request]] = None) -> List[_Request]:
        """One dynamic batch while the device is idle: block for the first
        request (unless ``group`` holds a partial batch to top up), then
        drain up to batch_size within max_wait_ms. Sets ``_stop_seen`` when
        the stop sentinel surfaces."""
        group = list(group or ())
        if not group:
            first = self._q.get()
            if first is None:
                self._stop_seen = True
                return []
            group = [first]
        deadline = time.monotonic() + self.scfg.max_wait_ms / 1000.0
        while len(group) < self.dcfg.batch_size:
            remain = deadline - time.monotonic()
            try:
                nxt = self._q.get(timeout=max(0.0, remain)) if remain > 0 else self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                self._stop_seen = True
                break
            group.append(nxt)
        return group

    def _collect_fill(self, in_flight_ready) -> List[_Request]:
        """The next batch while the previous one runs: drain until the batch
        is full (dispatched early: the pipeline's gain) or
        ``in_flight_ready()`` turns true (whatever has gathered returns for
        the caller to top up). An empty queue returns at once, without
        probing readiness."""
        group: List[_Request] = []
        while len(group) < self.dcfg.batch_size:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                if not group:
                    break
                if in_flight_ready():
                    break
                try:  # nap briefly, so readiness is checked again
                    nxt = self._q.get(timeout=0.002)
                except queue.Empty:
                    continue
            if nxt is None:
                self._stop_seen = True
                break
            group.append(nxt)
        return group

    def _shed_expired(self, group: List[_Request]) -> List[_Request]:
        """Fail with TimeoutError the requests whose caller's timeout passed
        while they were queued; the device never computes them."""
        now = time.monotonic()
        live: List[_Request] = []
        dead: List[_Request] = []
        for r in group:
            (dead if r.deadline is not None and r.deadline < now else live).append(r)
        if dead:
            self._fail_group(dead, TimeoutError(
                "request deadline expired before dispatch (shed under load)"))
            with self._stats_lock:
                self.stats["shed"] += len(dead)
        return live

    def _fail_group(self, group: List[_Request], e: Exception) -> None:
        for r in group:
            if not r.future.done():
                try:
                    r.future.set_exception(e)
                except Exception:  # noqa: BLE001 — cancelled race
                    pass

    def _finish(self, group: List[_Request], pending, dispatched_at: float) -> None:
        """Wait for a dispatched group, postprocess, resolve its futures and
        account it. ``busy_s`` adds the de-overlapped union of [dispatch,
        drained] windows, so it approximates the device's busy time whether
        or not the pipeline overlapped the group with host work."""
        try:
            out = self.translator.finalize_ids(pending)
            drained = time.monotonic()
            for r, nbest in zip(group, out):
                if r.future.done():
                    continue  # cancelled while queued
                try:
                    payload = r.postproc(nbest) if r.postproc is not None else nbest
                except Exception as e:  # noqa: BLE001 — one request's postproc
                    try:
                        r.future.set_exception(e)
                    except Exception:  # noqa: BLE001
                        pass
                    continue
                try:
                    r.future.set_result(payload)
                except Exception:  # noqa: BLE001 — cancelled race
                    pass
        except Exception as e:  # a device or transfer error: the whole group
            self._fail_group(group, e)
            drained = time.monotonic()
        busy = drained - max(dispatched_at, self._busy_mark)
        self._busy_mark = max(self._busy_mark, drained)
        self._account_batch(group, busy)

    def _account_batch(self, group: List[_Request], busy: float) -> None:
        with self._stats_lock:
            self.stats["batches"] += 1
            if len(group) > 1:
                self.stats["batched_requests"] += len(group)
            self.stats["busy_s"] += max(0.0, busy)

    def _run(self) -> None:
        """The worker. Depth 2: while group N runs on the device thread, the
        worker gathers group N+1 (``_collect_fill``) and dispatches it early
        only when it fills; a partial gather waits for N to finish (its
        callers can then resubmit) and tops up within max_wait_ms. Depth 1
        finalizes each group before gathering the next."""
        self._stop_seen = False
        self._busy_mark = time.monotonic()
        prev: Optional[Tuple[List[_Request], object, float]] = None
        while True:
            if self._stop_seen:
                group = []
            elif prev is None:
                group = self._collect()
            else:
                group = self._collect_fill(prev[1].ready)
                if group and len(group) < self.dcfg.batch_size and not self._stop_seen:
                    self._finish(*prev)
                    prev = None
                    group = self._collect(group)
            nxt = None
            if group:
                group = self._shed_expired(group)
            if group:
                t0 = time.monotonic()
                try:
                    imgs = np.stack([r.img for r in group]) if self._img_dim else None
                    # the stream key is the request's sample_id, not its
                    # position in this group
                    sids = [r.sample_id for r in group] if self._samples else None
                    nxt = (group, self.translator.dispatch_ids([r.ids for r in group], imgs,
                                                               stream_ids=sids), t0)
                except Exception as e:  # a bad dispatch fails this group only
                    self._fail_group(group, e)
                    self._account_batch(group, time.monotonic() - t0)
            if self.pipeline_depth <= 1 and nxt is not None:
                self._finish(*nxt)
                nxt = None
            if prev is not None:
                self._finish(*prev)
            prev = nxt
            if prev is None and self._stop_seen:
                return
