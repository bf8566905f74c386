"""Batched beam search, greedy search and ancestral sampling on the device.
Mirrors ``variational_mmt_tpu/ops/beam.py``: ``length_penalty`` (:55),
``beam_search`` (:81, with attention tracking, the coverage penalty,
n-gram blocking and the search trace), ``greedy_search`` (:318) and
``sampling_search`` (:363).

Hypotheses are flattened to (B*K, ...) for the decoder step; top-k runs over
the joint (K*V) continuation scores of each sentence; EOS is absorbing
(a finished hypothesis extends only with PAD at log-prob 0); only beam 0
is live at t=0; the GNMT penalty ((5+len)/6)^alpha applies at the end.
JAX's ``lax.while_loop`` becomes a Python loop whose early exit, when every
hypothesis has finished, costs one host sync per step; the step index is a
host integer and the rest of the search state lives on the device.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from variational_mmt_torch.data.vocab import BOS, EOS, PAD

NEG_INF = -1.0e9

# step_fn: (carry, tokens (N,)) -> (carry, log_probs (N, V)[, attn])
StepFn = Callable[[Any, torch.Tensor], Tuple[Any, ...]]
# noise_fn: (step t, vocab size V) -> Gumbel noise (B, V) float32
NoiseFn = Callable[[int, int], torch.Tensor]


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of nested tuples/lists."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, (tuple, list)):
        tree = tree[0]
    return tree


def length_penalty(lengths: torch.Tensor, alpha: float, kind: str = "gnmt") -> torch.Tensor:
    lengths = lengths.float()
    if kind == "gnmt":
        return ((5.0 + lengths) / 6.0) ** alpha
    if kind == "average":
        return torch.clamp(lengths, min=1.0)
    if kind != "none":
        raise ValueError(f"unknown length_penalty kind: {kind!r} "
                         "(expected gnmt | average | none)")
    return torch.ones_like(lengths)


def _block_ngrams(logp: torch.Tensor, hist: torch.Tensor, t: int, g: int,
                  exclusion_tokens: Tuple[int, ...], pad_id: int) -> torch.Tensor:
    """Mask (add NEG_INF to) every token that would complete a g-gram
    already in its hypothesis (JAX ops/beam.py:196-230). ``hist`` (B, K, L)
    holds the emitted tokens; an earlier g-gram at p exists iff p+g-1 <= t-1."""
    B, K, L = hist.shape
    if t < g:
        return logp
    # shifted windows: win[i][..., p] == hist[..., p+i]
    win = [torch.cat([hist[:, :, i:], hist.new_full((B, K, i), pad_id)], dim=2) if i else hist
           for i in range(g)]
    match = torch.ones((B, K, L), dtype=torch.bool, device=hist.device)
    for i in range(g - 1):  # the candidate's context: positions t-g+1 .. t-1
        match &= win[i] == hist[:, :, t - g + 1 + i, None]
    pen_mask = match & (torch.arange(L, device=hist.device) <= t - g)
    if exclusion_tokens:
        excl = torch.zeros_like(pen_mask)
        for e in exclusion_tokens:
            for i in range(g):
                excl |= win[i] == e
        pen_mask &= ~excl
    pen = torch.where(pen_mask, NEG_INF, 0.0)
    return logp.scatter_add(2, win[g - 1], pen)


def beam_search(step_fn: StepFn, init_carry: Any, batch_size: int, beam_size: int,
                max_length: int, min_length: int = 0, alpha: float = 0.6,
                penalty: str = "gnmt", eos_id: int = EOS, bos_id: int = BOS,
                pad_id: int = PAD, return_attn: bool = False, coverage_beta: float = 0.0,
                src_mask: Any = None, return_trace: bool = False,
                block_ngram_repeat: int = 0, exclusion_tokens: Tuple[int, ...] = ()):
    """Returns (tokens (B, K, max_length) best-first, penalized scores
    (B, K)), then the attention-argmax source positions (B, K, max_length)
    with ``return_attn`` and the raw search tree with ``return_trace``
    ({parents, tokens, scores (B, K, steps run), order (B, K), n_steps}),
    as JAX's. ``init_carry`` leaves are (B, ...); they are tiled to
    (B*K, ...). ``step_fn`` may return a third output: per-beam argmax
    positions (N,) or full attention probs (N, S), which ``coverage_beta``
    (GNMT coverage over ``src_mask`` (B, S)) needs. ``block_ngram_repeat``
    g > 0 masks before top-k every token that would repeat a g-gram of its
    hypothesis, except g-grams holding one of ``exclusion_tokens``."""
    B, K, L = batch_size, beam_size, max_length
    use_cov = coverage_beta != 0.0
    if use_cov and src_mask is None:
        raise ValueError("coverage_beta != 0 requires src_mask (B, S)")
    carry = tree_map(lambda x: x.repeat_interleave(K, dim=0), init_carry)
    dev = _first_leaf(init_carry).device
    tokens = torch.full((B, K, L), pad_id, dtype=torch.long, device=dev)
    scores = torch.tensor([0.0] + [NEG_INF] * (K - 1), device=dev).repeat(B, 1)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, K), dtype=torch.long, device=dev)
    last_tok = torch.full((B, K), bos_id, dtype=torch.long, device=dev)
    attn_src = torch.zeros((B, K, L), dtype=torch.long, device=dev) if return_attn else None
    coverage = None
    if use_cov:
        coverage = torch.zeros((B, K, src_mask.shape[1]), dtype=torch.float32, device=dev)
    trace_pt, trace_sc = [], []
    base = (torch.arange(B, device=dev) * K)[:, None]
    pad_row = None
    n_steps = 0
    for t in range(L):
        if bool(finished.all()):
            break
        out = step_fn(carry, last_tok.reshape(B * K))
        attn_probs = attn_arg = None
        if len(out) == 3:
            carry, logp, attn = out
            if attn.dim() == 2:  # full attention probs (N, S)
                attn_probs = attn.reshape(B, K, -1).float()
                attn_arg = attn_probs.argmax(dim=-1)
            else:
                attn_arg = attn.reshape(B, K).long()
        else:
            carry, logp = out
            if return_attn:
                raise ValueError(
                    "return_attn=True requires step_fn to return attention "
                    "(argmax positions (N,) or full probs (N, S)) as its third output")
        if use_cov and attn_probs is None:
            raise ValueError("coverage_beta != 0 requires step_fn to return full attention "
                             "probs (N, S) as its third output")
        V = logp.shape[-1]
        logp = logp.reshape(B, K, V).float().clone()
        # PAD is never a legal continuation of a live hypothesis
        logp[..., pad_id] = NEG_INF
        if t < min_length:
            logp[..., eos_id] = NEG_INF
        if 0 < block_ngram_repeat <= L:
            logp = _block_ngrams(logp, tokens, t, block_ngram_repeat, exclusion_tokens, pad_id)
        if pad_row is None:
            pad_row = torch.full((V,), NEG_INF, device=dev)
            pad_row[pad_id] = 0.0
        logp = torch.where(finished[..., None], pad_row, logp)
        cand = scores[..., None] + logp
        new_scores, idx = torch.topk(cand.reshape(B, K * V), K, dim=1)
        parents = idx // V
        toks = idx % V
        tokens = tokens.gather(1, parents[..., None].expand(B, K, L)).clone()
        tokens[:, :, t] = toks
        if return_attn:
            attn_src = attn_src.gather(1, parents[..., None].expand(B, K, L)).clone()
            attn_src[:, :, t] = attn_arg.gather(1, parents)
        was_finished = finished.gather(1, parents)
        lengths = lengths.gather(1, parents)
        lengths = torch.where(was_finished, lengths, lengths + 1)
        finished = was_finished | (toks == eos_id)
        if use_cov:
            S = coverage.shape[2]
            step_attn = attn_probs.gather(1, parents[..., None].expand(B, K, S))
            # finished beams stop accumulating
            coverage = coverage.gather(1, parents[..., None].expand(B, K, S)) \
                + step_attn * (~was_finished)[..., None]
        if return_trace:  # raw tree entries, slot-indexed, never reordered
            trace_pt.append((parents, toks))
            trace_sc.append(new_scores)
        flat = (base + parents).reshape(-1)
        carry = tree_map(lambda x: x.index_select(0, flat), carry)
        scores, last_tok = new_scores, toks
        n_steps = t + 1
    # unfinished hypotheses count as length max_length
    lengths = torch.where(finished, lengths, torch.full_like(lengths, L))
    scored = scores / length_penalty(torch.clamp(lengths, min=1), alpha, penalty)
    if use_cov:
        cov = torch.clamp(torch.clamp(coverage, max=1.0), min=1e-10)
        scored = scored + coverage_beta * (torch.log(cov) * src_mask[:, None, :].float()).sum(-1)
    order = torch.sort(scored, dim=1, descending=True, stable=True).indices
    outs = [tokens.gather(1, order[..., None].expand(B, K, L)), scored.gather(1, order)]
    if return_attn:
        outs.append(attn_src.gather(1, order[..., None].expand(B, K, L)))
    if return_trace:
        empty = torch.zeros((B, K, 0), dtype=torch.long, device=dev)
        outs.append({
            "parents": torch.stack([p for p, _ in trace_pt], 2) if trace_pt else empty,
            "tokens": torch.stack([k for _, k in trace_pt], 2) if trace_pt else empty,
            "scores": torch.stack(trace_sc, 2) if trace_sc else empty.float(),
            "order": order,
            "n_steps": n_steps,
        })
    return tuple(outs)


def greedy_search(step_fn: StepFn, init_carry: Any, batch_size: int, max_length: int,
                  eos_id: int = EOS, bos_id: int = BOS,
                  pad_id: int = PAD) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax decoding; returns (tokens (B, max_length), scores (B,) the
    summed log-prob of the emitted tokens)."""
    B, L = batch_size, max_length
    dev = _first_leaf(init_carry).device
    tokens = torch.full((B, L), pad_id, dtype=torch.long, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    score = torch.zeros((B,), device=dev)
    last = torch.full((B,), bos_id, dtype=torch.long, device=dev)
    carry = init_carry
    for t in range(L):
        if bool(finished.all()):
            break
        carry, logp = step_fn(carry, last)
        logp = logp.float().clone()
        logp[:, pad_id] = NEG_INF
        tok = logp.argmax(dim=-1)
        step_lp = logp.gather(1, tok[:, None])[:, 0]
        score = torch.where(finished, score, score + step_lp)
        tok = torch.where(finished, torch.full_like(tok, pad_id), tok)
        tokens[:, t] = tok
        finished = finished | (tok == eos_id)
        last = tok
    return tokens, score


def sampling_filter(logp: torch.Tensor, block_eos: bool, temperature: float = 1.0,
                    topk: int = 0, topp: float = 0.0, eos_id: int = EOS) -> torch.Tensor:
    """The distribution a sampling step draws from (JAX :408-431): EOS
    masked while ``block_eos``, then the temperature
    (``log_softmax(logp / T)``), then top-k (every token tied with the k-th
    kept: the threshold form) and top-p (a token is kept iff the sorted mass
    before it is below ``topp``, so the argmax always is)."""
    V = logp.shape[-1]
    filt = logp.clone()
    if block_eos:
        filt[:, eos_id] = NEG_INF
    if temperature != 1.0:
        filt = torch.log_softmax(filt / temperature, dim=-1)
    if topk and topk > 0:
        kth = torch.topk(filt, min(topk, V), dim=-1).values[:, -1]
        filt = torch.where(filt < kth[:, None], NEG_INF, filt)
        filt = torch.log_softmax(filt, dim=-1)
    if topp and topp > 0.0:
        sorted_lp = torch.sort(filt, dim=-1, descending=True).values
        probs = torch.exp(sorted_lp)
        keep = (torch.cumsum(probs, dim=-1) - probs) < topp
        thresh = torch.where(keep, sorted_lp, torch.inf).min(dim=-1).values
        filt = torch.where(filt < thresh[:, None], NEG_INF, filt)
    return filt


def sampling_search(step_fn: StepFn, init_carry: Any, batch_size: int, max_length: int,
                    noise_fn: NoiseFn, temperature: float = 1.0, topk: int = 0,
                    topp: float = 0.0, min_length: int = 0, eos_id: int = EOS,
                    bos_id: int = BOS, pad_id: int = PAD) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ancestral sampling, one hypothesis a sentence (JAX :363-452): the
    PAD exclusion, then ``sampling_filter`` (``min_length``, temperature,
    top-k, top-p); the draw is ``argmax(filtered + noise_fn(t, V))``, which is
    ``jax.random.categorical`` with the caller's Gumbel noise. Returns
    (tokens (B, max_length), scores (B,)), the scores summing the raw
    (untempered, unfiltered) log-probs of the drawn tokens."""
    B, L = batch_size, max_length
    if temperature <= 0.0:
        raise ValueError(f"sampling temperature must be > 0, got {temperature}")
    if topp < 0.0 or topp > 1.0:
        raise ValueError(f"topp must be in [0, 1], got {topp}")
    dev = _first_leaf(init_carry).device
    tokens = torch.full((B, L), pad_id, dtype=torch.long, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    score = torch.zeros((B,), device=dev)
    last = torch.full((B,), bos_id, dtype=torch.long, device=dev)
    carry = init_carry
    for t in range(L):
        if bool(finished.all()):
            break
        carry, logp = step_fn(carry, last)
        V = logp.shape[-1]
        logp = logp.float().clone()
        logp[:, pad_id] = NEG_INF
        filt = sampling_filter(logp, t < min_length, temperature, topk, topp, eos_id)
        tok = (filt + noise_fn(t, V)).argmax(dim=-1)
        step_lp = logp.gather(1, tok[:, None])[:, 0]
        score = torch.where(finished, score, score + step_lp)
        tok = torch.where(finished, torch.full_like(tok, pad_id), tok)
        tokens[:, t] = tok
        finished = finished | (tok == eos_id)
        last = tok
    return tokens, score
