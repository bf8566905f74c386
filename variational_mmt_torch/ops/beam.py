"""Batched beam search and greedy search on the device. Mirrors
``variational_mmt_tpu/ops/beam.py``: ``length_penalty`` (:55),
``beam_search`` (:81, without coverage, n-gram blocking, attention
tracking or traces) and ``greedy_search`` (:318).

Hypotheses are flattened to (B*K, ...) for the decoder step; top-k runs over
the joint (K*V) continuation scores of each sentence; EOS is absorbing
(a finished hypothesis extends only with PAD at log-prob 0); only beam 0
is live at t=0; the GNMT penalty ((5+len)/6)^alpha applies at the end.
JAX's ``lax.while_loop`` becomes a Python loop whose early exit, when every
hypothesis has finished, costs one host sync per step.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from variational_mmt_torch.data.vocab import BOS, EOS, PAD

NEG_INF = -1.0e9

# step_fn: (carry, tokens (N,)) -> (carry, log_probs (N, V))
StepFn = Callable[[Any, torch.Tensor], Tuple[Any, torch.Tensor]]


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


def beam_search(step_fn: StepFn, init_carry: Any, batch_size: int, beam_size: int,
                max_length: int, min_length: int = 0, alpha: float = 0.6,
                penalty: str = "gnmt", eos_id: int = EOS, bos_id: int = BOS,
                pad_id: int = PAD) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens (B, K, max_length) best-first, penalized scores
    (B, K)). ``init_carry`` leaves are (B, ...); they are tiled to (B*K, ...)."""
    B, K, L = batch_size, beam_size, max_length
    carry = tree_map(lambda x: x.repeat_interleave(K, dim=0), init_carry)
    dev = _first_leaf(init_carry).device
    tokens = torch.full((B, K, L), pad_id, dtype=torch.long, device=dev)
    scores = torch.tensor([0.0] + [NEG_INF] * (K - 1), device=dev).repeat(B, 1)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, K), dtype=torch.long, device=dev)
    last_tok = torch.full((B, K), bos_id, dtype=torch.long, device=dev)
    base = (torch.arange(B, device=dev) * K)[:, None]
    pad_row = None
    for t in range(L):
        if bool(finished.all()):
            break
        carry, logp = step_fn(carry, last_tok.reshape(B * K))
        V = logp.shape[-1]
        logp = logp.reshape(B, K, V).float().clone()
        # PAD is never a legal continuation of a live hypothesis
        logp[..., pad_id] = NEG_INF
        if t < min_length:
            logp[..., eos_id] = NEG_INF
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
        was_finished = finished.gather(1, parents)
        lengths = lengths.gather(1, parents)
        lengths = torch.where(was_finished, lengths, lengths + 1)
        finished = was_finished | (toks == eos_id)
        flat = (base + parents).reshape(-1)
        carry = tree_map(lambda x: x.index_select(0, flat), carry)
        scores, last_tok = new_scores, toks
    # unfinished hypotheses count as length max_length
    lengths = torch.where(finished, lengths, torch.full_like(lengths, L))
    scored = scores / length_penalty(torch.clamp(lengths, min=1), alpha, penalty)
    order = torch.sort(scored, dim=1, descending=True, stable=True).indices
    tokens = tokens.gather(1, order[..., None].expand(B, K, L))
    return tokens, scored.gather(1, order)


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
