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
accumulate in f32 as ``preferred_element_type=f32`` asks. Under a mesh of
several model ranks the vocabulary is split (``_VocabParallelCE``).
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


class _VocabParallelCE(torch.autograd.Function):
    """The same function with W (H, V/n) and b (V/n,) this rank's columns of
    a vocab split over ``mesh``'s model group (parallel/tp.py). Each chunk
    reduces its logits to per-row local statistics (max, sum of exps under
    that max, the gold and PAD logits where this shard owns them, the logit
    sum, the first argmax); after the loop three all-reduces make them
    global: MAX of the row maxima, SUM of the rescaled exp sums and the
    logits, MIN of the argmax candidates (ties to the lowest global index).
    Label smoothing spreads over the global V - 2. The backward recomputes
    this shard's softmax columns from the global log-sum-exp, forms its
    dW and db, and all-reduces dx with SUM."""

    @staticmethod
    def forward(ctx, x, W, b, targets, mask, eps, chunk, mesh):
        from variational_mmt_torch.parallel import mesh as pm, tp

        N = x.shape[0]
        Vl = W.shape[1]
        V = Vl * mesh.n_model
        start = tp.vocab_start(Vl, mesh)
        C = min(chunk, max(8, N))
        bf = b.float()
        lm = torch.empty((N,), dtype=f32, device=x.device)
        stats = torch.zeros((4, N), dtype=f32, device=x.device)  # sumexp, gold, PAD, sum
        am = torch.empty((N,), dtype=torch.long, device=x.device)
        loc, own = tp.local_ids(targets, Vl, mesh)
        for s in range(0, N, C):
            logits = _logits(x[s:s + C], W, bf)
            m = logits.amax(dim=-1)
            lm[s:s + C] = m
            stats[0, s:s + C] = torch.exp(logits - m[:, None]).sum(dim=-1)
            z = logits.gather(-1, loc[s:s + C, None])[:, 0]
            stats[1, s:s + C] = torch.where(own[s:s + C], z, torch.zeros_like(z))
            if start <= PAD < start + Vl:
                stats[2, s:s + C] = logits[:, PAD - start]
            stats[3, s:s + C] = logits.sum(dim=-1)
            am[s:s + C] = logits.argmax(dim=-1) + start
        gm = pm.all_reduce(lm.clone(), mesh.model_group, "max")
        stats[0] *= torch.exp(lm - gm)
        pm.all_reduce(stats, mesh.model_group)
        lse = gm + torch.log(stats[0])
        nll_u, nll_raw_u = _nll_from_stats(lse, stats[1], stats[2], stats[3], V, eps)
        pred = pm.all_reduce(torch.where(lm == gm, am, torch.full_like(am, V)),
                             mesh.model_group, "min")
        n_correct = ((pred == targets).float() * mask.float()).sum()
        ctx.save_for_backward(x, W, b, targets, mask, nll_u, nll_raw_u, lse)
        ctx.eps, ctx.chunk, ctx.mesh = eps, chunk, mesh
        ctx.mark_non_differentiable(n_correct)
        m = mask.float()
        return nll_u * m, nll_raw_u * m, n_correct

    @staticmethod
    def backward(ctx, g_nll, g_raw, _):
        from variational_mmt_torch.parallel import mesh as pm, tp

        x, W, b, targets, mask, nll_u, nll_raw_u, lse = ctx.saved_tensors
        eps, mesh = ctx.eps, ctx.mesh
        N, H = x.shape
        Vl = W.shape[1]
        V = Vl * mesh.n_model
        start = tp.vocab_start(Vl, mesh)
        C = min(ctx.chunk, max(8, N))
        cdt = W.dtype
        bf = b.float()
        m = mask.float()
        g = g_nll.float() * m
        gr = g_raw.float() * m
        dx = torch.empty((N, H), dtype=f32, device=x.device)
        dW = torch.zeros((H, Vl), dtype=f32, device=x.device)
        db = torch.zeros((Vl,), dtype=f32, device=x.device)
        w_t = W.float().t()
        loc, own = tp.local_ids(targets, Vl, mesh)
        for s in range(0, N, C):
            x_c = x[s:s + C]
            p = torch.exp(_logits(x_c, W, bf) - lse[s:s + C, None])
            e_t = torch.nn.functional.one_hot(loc[s:s + C], Vl).float() * own[s:s + C, None]
            if eps > 0.0:
                e_pad = torch.zeros_like(e_t)
                if start <= PAD < start + Vl:
                    e_pad[:, PAD - start] = 1.0
                q = (1.0 - eps) * e_t + (eps / (V - 2.0)) * (1.0 - e_t - e_pad)
            else:
                q = e_t
            dlogits = g[s:s + C, None] * (p - q) + gr[s:s + C, None] * (p - e_t)
            d_c = dlogits.to(cdt).float()
            dx[s:s + C] = d_c @ w_t
            dW += x_c.to(cdt).float().t() @ d_c
            db += dlogits.sum(dim=0)
        pm.all_reduce(dx, mesh.model_group)
        dmask = (g_nll.float() * nll_u + g_raw.float() * nll_raw_u).to(mask.dtype)
        return dx.to(x.dtype), dW.to(W.dtype), db.to(b.dtype), None, dmask, None, None, None


def fused_generator_ce(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                       targets: torch.Tensor, mask: torch.Tensor,
                       label_smoothing: float = 0.0, chunk: int = 1024, mesh=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (N,H) decoder outputs, W (H,V), b (V,), targets (N,) int, mask (N,)
    f32. Returns (nll (N,) masked training CE, nll_raw (N,) masked
    unsmoothed NLL, n_correct). Differentiable in x, W, b and mask. With
    ``mesh`` (``VMMTModel.vocab_mesh``), W and b are this rank's V/n
    columns and the result is the full vocab's, on every model rank."""
    if mesh is not None:
        return _VocabParallelCE.apply(x, W, b, targets.long(), mask, float(label_smoothing),
                                      int(chunk), mesh)
    return _FusedGeneratorCE.apply(x, W, b, targets.long(), mask, float(label_smoothing),
                                   int(chunk))
