"""Fused generator + cross-entropy in row chunks. Mirrors
``variational_mmt_tpu/ops/fused_ce.py``.

The (N, V) f32 logits are never kept: the forward computes each chunk's
logits, reduces them at once to the log-sum-exp, the target logit, the
argmax and, for label smoothing, the PAD logit and the logit sum; the
backward recomputes each chunk's logits and forms
``dlogits = g * (p - q)`` (q the smoothed label distribution: 1-eps on the
gold class, eps/(V-2) on every class that is neither PAD nor gold), then
``dx = dlogits W^T``, ``dW = x^T dlogits``, ``db = sum dlogits``. The JAX
package computes this outside Pallas, so the products here are cuBLAS
calls: operands in the compute dtype, upcast to f32 so that the products
accumulate in f32 as ``preferred_element_type=f32`` asks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from variational_mmt_torch.data.vocab import PAD

f32 = torch.float32


def _logits(x_c: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x_c.float() @ W.float() + b


def _nll_from_stats(lse, z_t, logit_pad, logit_sum, V: int, eps: float):
    nll_raw = lse - z_t
    if eps > 0.0:
        # smoothing term: -mean over classes != gold, != PAD of logp
        sum_logp = logit_sum - V * lse
        rest = sum_logp - (z_t - lse) - (logit_pad - lse)
        smooth = -rest / (V - 2.0)
        return (1.0 - eps) * nll_raw + eps * smooth, nll_raw
    return nll_raw, nll_raw


class _FusedGeneratorCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, W, b, targets, mask, eps, chunk):
        N = x.shape[0]
        V = W.shape[1]
        C = min(chunk, max(8, N))
        bf = b.float()
        nll_u = torch.empty((N,), dtype=f32, device=x.device)
        nll_raw_u = torch.empty_like(nll_u)
        n_correct = torch.zeros((), dtype=f32, device=x.device)
        for s in range(0, N, C):
            logits = _logits(x[s:s + C], W, bf)
            t_c = targets[s:s + C]
            m = logits.amax(dim=-1)
            lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
            z_t = logits.gather(-1, t_c[:, None])[:, 0]
            nll_u[s:s + C], nll_raw_u[s:s + C] = _nll_from_stats(
                lse, z_t, logits[:, PAD], logits.sum(dim=-1), V, eps)
            pred = logits.argmax(dim=-1)
            n_correct += ((pred == t_c).float() * mask[s:s + C].float()).sum()
        ctx.save_for_backward(x, W, b, targets, mask, nll_u, nll_raw_u)
        ctx.eps, ctx.chunk = eps, chunk
        ctx.mark_non_differentiable(n_correct)
        m = mask.float()
        return nll_u * m, nll_raw_u * m, n_correct

    @staticmethod
    def backward(ctx, g_nll, g_raw, _):
        x, W, b, targets, mask, nll_u, nll_raw_u = ctx.saved_tensors
        eps = ctx.eps
        N, H = x.shape
        V = W.shape[1]
        C = min(ctx.chunk, max(8, N))
        cdt = W.dtype  # product dtype follows the weights
        bf = b.float()
        m = mask.float()
        g = g_nll.float() * m
        gr = g_raw.float() * m
        dx = torch.empty((N, H), dtype=f32, device=x.device)
        dW = torch.zeros((H, V), dtype=f32, device=x.device)
        db = torch.zeros((V,), dtype=f32, device=x.device)
        w_t = W.float().t()
        for s in range(0, N, C):
            x_c = x[s:s + C]
            p = torch.softmax(_logits(x_c, W, bf), dim=-1)
            e_t = torch.nn.functional.one_hot(targets[s:s + C], V).float()
            if eps > 0.0:
                e_pad = torch.zeros_like(e_t)
                e_pad[:, PAD] = 1.0
                q = (1.0 - eps) * e_t + (eps / (V - 2.0)) * (1.0 - e_t - e_pad)
            else:
                q = e_t
            dlogits = g[s:s + C, None] * (p - q) + gr[s:s + C, None] * (p - e_t)
            d_c = dlogits.to(cdt).float()
            dx[s:s + C] = d_c @ w_t
            dW += x_c.to(cdt).float().t() @ d_c
            db += dlogits.sum(dim=0)
        # the outputs are nll * m and nll_raw * m: d/dm is the unmasked NLLs
        dmask = (g_nll.float() * nll_u + g_raw.float() * nll_raw_u).to(mask.dtype)
        return dx.to(x.dtype), dW.to(W.dtype), db.to(b.dtype), None, dmask, None, None


def fused_generator_ce(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                       targets: torch.Tensor, mask: torch.Tensor,
                       label_smoothing: float = 0.0, chunk: int = 1024
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (N,H) decoder outputs, W (H,V), b (V,), targets (N,) int, mask (N,)
    f32. Returns (nll (N,) masked training CE, nll_raw (N,) masked
    unsmoothed NLL, n_correct). Differentiable in x, W, b and mask."""
    return _FusedGeneratorCE.apply(x, W, b, targets.long(), mask, float(label_smoothing),
                                   int(chunk))
