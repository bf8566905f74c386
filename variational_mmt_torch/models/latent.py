"""Latent-variable networks. Mirrors ``variational_mmt_tpu/models/latent.py``
(:25-117): ``GaussianHead``, ``InferenceNetwork``, ``ConditionalPrior`` and
``ImagePredictor``.

Only the prior's forward is on the decode path; the inference network and
the image predictor hold their parameters so a JAX tree round-trips whole.
mu and sigma are computed in f32 (sigma = softplus + min_sigma) under any
compute dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from variational_mmt_torch.models.layers import Dense


class GaussianHead(nn.Module):
    """MLP trunk -> (mu, sigma) of a diagonal Gaussian."""

    def __init__(self, in_dim: int, latent_dim: int, hidden: int = 512, n_layers: int = 1,
                 min_sigma: float = 1e-3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = n_layers
        self.min_sigma = min_sigma
        for i in range(n_layers):
            self.add_module(f"mlp{i}", Dense(in_dim if i == 0 else hidden, hidden, dtype=dtype))
        self.mu = Dense(hidden, latent_dim, dtype=torch.float32)
        self.sigma = Dense(hidden, latent_dim, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x
        for i in range(self.n_layers):
            h = torch.tanh(getattr(self, f"mlp{i}")(h))
        mu = self.mu(h.float())
        sigma = nn.functional.softplus(self.sigma(h.float())) + self.min_sigma
        return mu, sigma


class InferenceNetwork(nn.Module):
    """q(z|x,y,v) over [source summary; target summary; image features]."""

    def __init__(self, hidden_in: int, img_dim: int, latent_dim: int, hidden: int = 512,
                 min_sigma: float = 1e-3, use_img: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_img = use_img
        in_dim = 2 * hidden_in + (img_dim if use_img else 0)
        self.head = GaussianHead(in_dim, latent_dim, hidden, 1, min_sigma, dtype)

    def forward(self, src_summary, tgt_summary, img):
        parts = [src_summary, tgt_summary]
        if self.use_img and img is not None:
            parts.append(img.to(src_summary.dtype))
        return self.head(torch.cat(parts, dim=-1))


class ConditionalPrior(nn.Module):
    """p(z|x,v) over [source summary; image features] (vmmt_c)."""

    def __init__(self, hidden_in: int, img_dim: int, latent_dim: int, hidden: int = 512,
                 min_sigma: float = 1e-3, use_img: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_img = use_img
        in_dim = hidden_in + (img_dim if use_img else 0)
        self.head = GaussianHead(in_dim, latent_dim, hidden, 1, min_sigma, dtype)

    def forward(self, src_summary: torch.Tensor, img: Optional[torch.Tensor]):
        parts = [src_summary]
        if self.use_img and img is not None:
            parts.append(img.to(src_summary.dtype))
        return self.head(torch.cat(parts, dim=-1))


class ImagePredictor(nn.Module):
    """p(v|z): MLP z -> image-feature vector."""

    def __init__(self, latent_dim: int, img_dim: int = 2048, hidden: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp0 = Dense(latent_dim, hidden, dtype=dtype)
        self.out = Dense(hidden, img_dim, dtype=torch.float32)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(self.mlp0(z))
        return self.out(h.float())
