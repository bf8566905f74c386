"""Latent-variable networks and distribution math. Mirrors
``variational_mmt_tpu/models/latent.py``: ``GaussianHead``,
``InferenceNetwork``, ``ConditionalPrior``, ``RegionAttentionPool``,
``ImagePredictor`` (:25-117)
and the f32 functions ``reparameterize``, ``gaussian_kl_per_dim``,
``gaussian_kl``, ``gaussian_log_prob`` and ``kl_free_bits`` (:119-153).

mu and sigma are computed in f32 (sigma = softplus + min_sigma) under any
compute dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

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


class RegionAttentionPool(nn.Module):
    """Text-conditioned attention pooling over conv-feature regions
    (``img_pool='attn'``, JAX :81-103): additive attention of a query (the
    source summary) over the R regions replaces their mean. ``key`` (D ->
    hidden) and ``query`` (H -> hidden) with biases, ``v`` (hidden -> 1)
    without; the softmax and the weighted sum run in f32 over the f32
    features."""

    def __init__(self, img_dim: int, query_dim: int, hidden: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.key = Dense(img_dim, hidden, dtype=dtype)
        self.query = Dense(query_dim, hidden, dtype=dtype)
        self.v = Dense(hidden, 1, use_bias=False, dtype=dtype)

    def forward(self, img: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
        """img (B,R,D), query (B,H) -> pooled features (B,D) f32."""
        scores = self.v(torch.tanh(self.key(img) + self.query(query)[:, None, :]))[..., 0]
        probs = torch.softmax(scores.float(), dim=-1)
        return (probs[..., None] * img.float()).sum(dim=1)


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


def reparameterize(mu: torch.Tensor, sigma: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """z = mu + sigma * eps, eps ~ N(0, I) drawn from ``generator`` unless
    given (JAX's threefry stream cannot be reproduced, so parity tests
    inject it)."""
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
    return mu + sigma * eps


def gaussian_kl_per_dim(mu_q, sigma_q, mu_p=None, sigma_p=None) -> torch.Tensor:
    """Analytic KL(q || p) per latent dimension -> (..., D); p defaults to
    N(0, I)."""
    if mu_p is None:
        return 0.5 * (sigma_q ** 2 + mu_q ** 2 - 1.0 - 2.0 * torch.log(sigma_q))
    return (torch.log(sigma_p / sigma_q)
            + (sigma_q ** 2 + (mu_q - mu_p) ** 2) / (2.0 * sigma_p ** 2) - 0.5)


def gaussian_kl(mu_q, sigma_q, mu_p=None, sigma_p=None) -> torch.Tensor:
    """KL(q || p) summed over the latent dimension -> (B,)."""
    return gaussian_kl_per_dim(mu_q, sigma_q, mu_p, sigma_p).sum(dim=-1)


def gaussian_log_prob(x: torch.Tensor, mu: torch.Tensor,
                      sigma: Union[torch.Tensor, float]) -> torch.Tensor:
    """log N(x; mu, diag sigma^2) summed over the last dimension."""
    sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
    log2pi = math.log(2.0 * math.pi)
    return (-0.5 * (((x - mu) / sigma) ** 2 + log2pi) - torch.log(sigma)).sum(dim=-1)


def kl_free_bits(kl_sum: torch.Tensor, free_bits: float, latent_dim: int) -> torch.Tensor:
    """A total free-bits floor: max(KL, free_bits * latent_dim)."""
    if free_bits <= 0:
        return kl_sum
    return torch.clamp(kl_sum, min=free_bits * latent_dim)
