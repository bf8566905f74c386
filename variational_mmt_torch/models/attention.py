"""Global (Luong) attention with the reference's three score types.
Mirrors ``variational_mmt_tpu/models/attention.py`` (:23-107):

- ``general``: ``q Wq . m`` (``linear_in``, no bias);
- ``dot``: ``q . m`` (no projection);
- ``mlp`` (Bahdanau): ``v . tanh(linear_query(q) + linear_context(m))``,
  ``linear_query`` with a bias, ``linear_context`` and ``v`` (H -> 1)
  without.

Masked scores become -1e9 before an f32 softmax; the probabilities are cast
to the memory dtype before the context product; the attentional hidden is
``tanh(linear_out([ctx; query]))``, ``linear_out`` with a bias for mlp only.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from variational_mmt_torch.models.layers import Dense

NEG_INF = -1e9
MLP_CHUNK = 8  # query positions a chunk of the mlp scores (JAX :62-83)


class GlobalAttention(nn.Module):
    def __init__(self, hidden: int, attn_type: str = "general",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if attn_type not in ("general", "dot", "mlp"):
            raise ValueError(f"attn_type must be general | dot | mlp, got {attn_type!r}")
        self.attn_type = attn_type
        if attn_type == "general":
            self.linear_in = Dense(hidden, hidden, use_bias=False, dtype=dtype)
        elif attn_type == "mlp":
            self.linear_query = Dense(hidden, hidden, dtype=dtype)
            self.linear_context = Dense(hidden, hidden, use_bias=False, dtype=dtype)
            self.v = Dense(hidden, 1, use_bias=False, dtype=dtype)
        self.linear_out = Dense(2 * hidden, hidden, use_bias=attn_type == "mlp", dtype=dtype)

    def project_memory(self, memory: torch.Tensor) -> torch.Tensor:
        """The loop-invariant keys, hoisted out of the decode loop: general
        ``memory @ Wq^T`` ((q Wq) . m == q . (m Wq^T)), mlp
        ``linear_context(memory)``, dot the memory itself."""
        if self.attn_type == "general":
            return memory @ self.linear_in.kernel.t().to(memory.dtype)
        if self.attn_type == "mlp":
            return self.linear_context(memory)
        return memory

    def scores(self, query: torch.Tensor, memory: torch.Tensor,
               keys: torch.Tensor = None) -> torch.Tensor:
        """query (B,T,H), memory (B,S,H) -> scores (B,T,S) in the compute
        dtype. mlp over more than 8 query positions is computed 8 positions
        at a time, as JAX chunks it, so that the (B,T,S,H) tanh tensor is
        never whole in the forward (at B=64, T=25, S=24, H=500 in bf16 it
        would be 38 MB; a sequence of 100 tokens would make it 150 MB)."""
        if self.attn_type != "mlp":
            if keys is None:
                keys = self.linear_in(query) if self.attn_type == "general" else query
                return keys @ memory.transpose(1, 2)
            return query @ keys.transpose(1, 2)
        q = self.linear_query(query)
        k = keys if keys is not None else self.linear_context(memory)
        if q.shape[1] <= MLP_CHUNK:
            return self.v(torch.tanh(q[:, :, None, :] + k[:, None, :, :]))[..., 0]
        vk = self.v.kernel.to(q.dtype)  # (H, 1)
        return torch.cat([(torch.tanh(q_c[:, :, None, :] + k[:, None, :, :]) @ vk)[..., 0]
                          for q_c in q.split(MLP_CHUNK, dim=1)], dim=1)

    def forward(self, query: torch.Tensor, memory: torch.Tensor, src_mask: torch.Tensor,
                keys: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """query (B,H) or (B,T,H); memory (B,S,H); src_mask (B,S) 1 = real,
        or (B,T,S) per query position; ``keys`` from :meth:`project_memory`
        (None: computed here). Returns (attn hidden shaped like query, align
        (.., S) in the memory dtype)."""
        single = query.dim() == 2
        if single:
            query = query[:, None, :]
        align = self.scores(query, memory, keys).float()
        mask3 = src_mask if src_mask.dim() == 3 else src_mask[:, None, :]
        align = torch.where(mask3 > 0, align, torch.full_like(align, NEG_INF))
        align = torch.softmax(align, dim=-1).to(memory.dtype)
        ctx = align @ memory
        attn_h = torch.tanh(self.linear_out(torch.cat([ctx, query], dim=-1)))
        if single:
            return attn_h[:, 0], align[:, 0]
        return attn_h, align
