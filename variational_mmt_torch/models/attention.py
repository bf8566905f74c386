"""Global (Luong) attention, "general" scores only. Mirrors
``variational_mmt_tpu/models/attention.py`` (:23-107).

Masked scores become -1e9 before an f32 softmax; the probabilities are cast
to the memory dtype before the context product; the attentional hidden is
``tanh(linear_out([ctx; query]))``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from variational_mmt_torch.models.layers import Dense

NEG_INF = -1e9


class GlobalAttention(nn.Module):
    def __init__(self, hidden: int, attn_type: str = "general",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if attn_type != "general":
            raise NotImplementedError(f"attn_type={attn_type!r} is not ported yet "
                                      "(only 'general')")
        self.linear_in = Dense(hidden, hidden, use_bias=False, dtype=dtype)
        self.linear_out = Dense(2 * hidden, hidden, use_bias=False, dtype=dtype)

    def project_memory(self, memory: torch.Tensor) -> torch.Tensor:
        """keys = memory @ Wq^T, hoisted out of the decode loop:
        (q Wq) . m == q . (m Wq^T)."""
        return memory @ self.linear_in.kernel.t().to(memory.dtype)

    def forward(self, query: torch.Tensor, memory: torch.Tensor, src_mask: torch.Tensor,
                keys: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """query (B,H) or (B,T,H); memory (B,S,H); src_mask (B,S) 1 = real.
        Returns (attn hidden shaped like query, align (.., S) in the memory
        dtype)."""
        single = query.dim() == 2
        if single:
            query = query[:, None, :]
        if keys is not None:
            scores = query @ keys.transpose(1, 2)
        else:
            scores = self.linear_in(query) @ memory.transpose(1, 2)
        align = scores.float()
        mask3 = src_mask if src_mask.dim() == 3 else src_mask[:, None, :]
        align = torch.where(mask3 > 0, align, torch.full_like(align, NEG_INF))
        align = torch.softmax(align, dim=-1).to(memory.dtype)
        ctx = align @ memory
        attn_h = torch.tanh(self.linear_out(torch.cat([ctx, query], dim=-1)))
        if single:
            return attn_h[:, 0], align[:, 0]
        return attn_h, align
