"""Dense and embedding layers with the JAX package's parameter layout and
dtype rules.

The JAX package builds on ``flax.linen.Dense`` and ``flax.linen.Embed``.
These keep their layouts (Dense ``kernel (in, out)`` and ``bias (out,)``;
Embed ``embedding (V, E)``), so converting a JAX parameter tree only
renames, and their dtype rule: with ``dtype`` set, the input, the f32
kernel and the bias are all cast to ``dtype`` before the product.
Parameters are created uninitialized; they come from
``convert.params_from_jax`` or ``models.model.init_params``.

Given a mesh of more than one model rank, ``Embed`` holds its rank's
V/n rows and looks up vocab-parallel (parallel/tp.py): ids outside the
shard read row 0, their rows are zeroed, and the sum over the model group
is each id's row.
"""

from __future__ import annotations

import torch
from torch import nn


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(out_features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Embed(nn.Module):
    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype = torch.float32,
                 mesh=None):
        super().__init__()
        self.dtype = dtype
        self.mesh = mesh  # vocab-parallel over its model group (tp.vocab_mesh)
        rows = num_embeddings // mesh.n_model if mesh is not None else num_embeddings
        self.embedding = nn.Parameter(torch.empty(rows, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # gather, then cast: the same values as casting the table first
        if self.mesh is None:
            return nn.functional.embedding(ids, self.embedding).to(self.dtype)
        from variational_mmt_torch.parallel import tp

        loc, own = tp.local_ids(ids, self.embedding.shape[0], self.mesh)
        rows = nn.functional.embedding(loc, self.embedding)
        rows = torch.where(own[..., None], rows, torch.zeros_like(rows))
        return tp.reduce_from_model(rows, self.mesh).to(self.dtype)
