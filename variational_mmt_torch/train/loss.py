"""Multi-task ELBO assembly. Mirrors ``variational_mmt_tpu/train/loss.py``
(:30-189), unpacked and sequence-packed batches:

    L = E_q[log p(y|x,z)] - beta * KL(q || p) + gamma * log p(v|z)

The scalar loss is the mean per-sentence negative ELBO; the metrics keep
raw sums (CE sum, token counts) as the JAX package reports them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from variational_mmt_torch.config import ModelConfig, TrainConfig
from variational_mmt_torch.data.vocab import PAD
from variational_mmt_torch.models.latent import gaussian_kl, gaussian_log_prob, kl_free_bits
from variational_mmt_torch.ops.fused_ce import fused_generator_ce


def kl_beta(step: int, cfg: TrainConfig) -> float:
    """Annealing schedule beta(step): 0 -> 1."""
    if cfg.kl_anneal == "none":
        return 1.0
    t = (step - cfg.kl_anneal_start) / max(1.0, cfg.kl_anneal_steps)
    if cfg.kl_anneal == "linear":
        return min(max(t, 0.0), 1.0)
    return 1.0 / (1.0 + math.exp(-10.0 * (t - 0.5)))


def token_ce(logits: torch.Tensor, targets: torch.Tensor, token_mask: torch.Tensor,
             label_smoothing: float = 0.0, per_token: bool = False, mesh=None):
    """(per-sentence training CE (B,), per-sentence raw NLL (B,), n_correct),
    or masked per-token (B,T) arrays with ``per_token``. Label smoothing:
    1-eps on the gold class, eps spread over the V-2 classes that are
    neither PAD nor gold; the raw NLL is unsmoothed. With ``mesh``
    (``VMMTModel.vocab_mesh``) the logits are this rank's V/n columns
    (:func:`_vocab_parallel_nll`)."""
    if mesh is not None:
        nll, nll_raw, pred = _vocab_parallel_nll(logits, targets.long(), label_smoothing, mesh)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll_raw = -logp.gather(-1, targets[..., None].long())[..., 0]
        nll = nll_raw
        if label_smoothing > 0.0:
            V = logits.shape[-1]
            rest = logp.sum(dim=-1) - (-nll_raw) - logp[..., PAD]
            nll = (1.0 - label_smoothing) * nll_raw + label_smoothing * (-rest / (V - 2.0))
        pred = logits.argmax(dim=-1)
    nll = nll * token_mask
    nll_raw = nll_raw * token_mask
    n_correct = ((pred == targets).float() * token_mask).sum()
    if per_token:
        return nll, nll_raw, n_correct
    return nll.sum(dim=-1), nll_raw.sum(dim=-1), n_correct


def _vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor, eps: float, mesh):
    """(training NLL, raw NLL, argmax) of vocab-parallel logits (B,T,V/n):
    the row maximum all-reduced with MAX (no gradient), then the exp sum,
    the gold and PAD logits and, for smoothing, the logit sum summed over
    the model group through ``tp.reduce_from_model`` (identity backward),
    so each rank's logits get their own columns' gradient."""
    from variational_mmt_torch.parallel import mesh as pm, tp

    Vl = logits.shape[-1]
    V = Vl * mesh.n_model
    start = tp.vocab_start(Vl, mesh)
    m = pm.all_reduce(logits.detach().amax(dim=-1), mesh.model_group, "max")
    lse = m + torch.log(tp.reduce_from_model(torch.exp(logits - m[..., None]).sum(dim=-1),
                                             mesh))
    loc, own = tp.local_ids(targets, Vl, mesh)
    z = logits.gather(-1, loc[..., None])[..., 0]
    z_t = tp.reduce_from_model(torch.where(own, z, torch.zeros_like(z)), mesh)
    nll_raw = lse - z_t
    nll = nll_raw
    if eps > 0.0:
        pad = (logits[..., PAD - start] if start <= PAD < start + Vl
               else torch.zeros_like(m))
        logit_pad = tp.reduce_from_model(pad, mesh)
        logit_sum = tp.reduce_from_model(logits.sum(dim=-1), mesh)
        rest = (logit_sum - V * lse) - (z_t - lse) - (logit_pad - lse)
        nll = (1.0 - eps) * nll_raw + eps * (-rest / (V - 2.0))
    return nll, nll_raw, tp.argmax(logits.detach(), mesh, m)


def image_loss(v: torch.Tensor, v_pred: torch.Tensor, kind: str) -> torch.Tensor:
    """Per-sentence image objective to minimize, (B,)."""
    v = v.float()
    if v.dim() == 3:  # conv features: pooled as the model pools its input
        v = v.mean(dim=1)
    if kind == "logprob":
        return -gaussian_log_prob(v, v_pred, 1.0)
    if kind == "mse":
        return ((v - v_pred) ** 2).sum(dim=-1)
    num = (v * v_pred).sum(dim=-1)
    den = torch.linalg.norm(v, dim=-1) * torch.linalg.norm(v_pred, dim=-1) + 1e-8
    return 1.0 - num / den


def compute_loss(out: Dict[str, torch.Tensor], tgt_out: torch.Tensor,
                 example_mask: torch.Tensor, img: Optional[torch.Tensor], mcfg: ModelConfig,
                 tcfg: TrainConfig, step: int,
                 generator_params: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 tgt_seg: Optional[torch.Tensor] = None, mesh=None,
                 n_sents: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Scalar training loss (mean per-sentence -ELBO) and metric sums.
    ``generator_params`` (kernel (H,V), bias (V,)) is required when the
    model ran with ``fused_ce`` (``out`` holds ``dec_out``). ``mesh``: the
    model's ``vocab_mesh`` (the logits or the generator are this rank's
    vocab shard). ``n_sents``: the sentence count the loss is divided by
    (data parallelism: the global batch's, all-reduced by the caller);
    default ``example_mask.sum()``.

    ``tgt_seg`` (B,T): a sequence-packed batch (``forward_packed``). A
    sentence is then a packed segment: the CE is summed per segment, and
    ``example_mask``, ``img`` and the per-sentence outputs arrive flattened
    (B*K, ...), normalized as an unpacked batch of B*K rows."""
    B, T = tgt_out.shape
    if tgt_seg is not None:
        K = example_mask.shape[0] // B
        token_mask = ((tgt_out != PAD) & (tgt_seg >= 0)).float()
        # (B,K,T) one-hot of the segments: per-token sums -> per-segment sums
        onehot = (tgt_seg[:, None, :] == torch.arange(K, device=tgt_seg.device)[None, :, None])

        def per_sent(nll_bt: torch.Tensor) -> torch.Tensor:
            return (onehot.to(nll_bt.dtype) @ nll_bt[..., None]).reshape(-1)
    else:
        token_mask = (tgt_out != PAD).float() * example_mask[:, None]

        def per_sent(nll_bt: torch.Tensor) -> torch.Tensor:
            return nll_bt.sum(dim=-1)
    if "dec_out" in out:
        H = out["dec_out"].shape[-1]
        cdt = out["dec_out"].dtype
        kernel, bias = generator_params
        nll, nll_raw, n_correct = fused_generator_ce(
            out["dec_out"].reshape(B * T, H), kernel.to(cdt), bias, tgt_out.reshape(-1),
            token_mask.reshape(-1), tcfg.label_smoothing, mesh=mesh)
        nll, nll_raw = nll.reshape(B, T), nll_raw.reshape(B, T)
    else:
        nll, nll_raw, n_correct = token_ce(out["logits"], tgt_out, token_mask,
                                           tcfg.label_smoothing, per_token=True, mesh=mesh)
    ce_per_sent, nll_per_sent = per_sent(nll), per_sent(nll_raw)
    n_sents = torch.clamp(example_mask.sum() if n_sents is None else n_sents, min=1.0)
    loss = ce_per_sent.sum() / n_sents
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    metrics = {"ce_sum": nll_per_sent.sum(), "n_tokens": token_mask.sum(),
               "n_correct": n_correct, "n_sents": example_mask.sum(), "kl_sum": zero,
               "img_loss_sum": zero, "beta": zero + 1.0}
    if "mu_q" in out:
        kl = gaussian_kl(out["mu_q"], out["sigma_q"], out.get("mu_p"), out.get("sigma_p"))
        kl = kl * example_mask
        metrics["kl_sum"] = kl.sum()
        kl = kl_free_bits(kl, tcfg.kl_free_bits, mcfg.latent_dim) * example_mask
        beta = kl_beta(step, tcfg)
        metrics["beta"] = zero + beta
        loss = loss + beta * kl.sum() / n_sents
    if "img_pred" in out and img is not None:
        # the model's own pooled conditioning vector is the target
        target = out.get("img_target", img)
        il = image_loss(target, out["img_pred"], mcfg.img_loss) * example_mask
        metrics["img_loss_sum"] = il.sum()
        loss = loss + mcfg.img_loss_weight * il.sum() / n_sents
    metrics["loss"] = loss
    return loss, metrics
