"""Latent-usage diagnostics, the posterior-collapse instruments. Mirrors
``variational_mmt_tpu/decode/diagnostics.py`` (:44-125):

- **active units**: ``AU = #{d : Var_x(E_q[z_d|x]) > delta}``, delta 0.01,
  the latent dimensions whose posterior mean moves with the input;
- **per-dimension KL**: KL(q||p) = sum_d KL_d; the sorted spectrum shows
  which dimensions carry information (for vmmt_c's conditional prior read
  the spectrum: its posterior mean follows mu_p(x,v) even when q has
  collapsed onto p; AU discriminates for vmmt_f's fixed prior).

One pass a batch returns per-dimension sums (sum mu, sum mu^2, sum KL_d,
count) on the device; the host adds the batches and thresholds once.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List

import numpy as np
import torch

from variational_mmt_torch.models.latent import gaussian_kl_per_dim
from variational_mmt_torch.models.model import VMMTModel


def make_latent_stats_fn(model: VMMTModel) -> Callable:
    """fn(batch) -> the batch's per-dimension sums masked by example_mask:
    {"sum_mu", "sum_mu2", "sum_kl"} (D,) and the scalar "n_sents". ``batch``
    has the IW-eval layout (src, tgt_out, example_mask, + img)."""
    if not model.is_latent:
        raise ValueError("latent diagnostics require a latent model (vmmt_f/vmmt_c)")

    @torch.inference_mode()
    def fn(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        ex_mask = batch["example_mask"].float()
        img = batch.get("img")
        _, _, _, summary = model.encode(batch["src"])
        mu_q, sigma_q = model.posterior(summary, batch["tgt_out"], img)
        mu_p, sigma_p = model.prior_params(summary, img)
        kl_d = gaussian_kl_per_dim(mu_q.float(), sigma_q.float(), mu_p.float(), sigma_p.float())
        m = ex_mask[:, None]
        mu32 = mu_q.float()
        return {"sum_mu": (mu32 * m).sum(dim=0), "sum_mu2": (mu32 ** 2 * m).sum(dim=0),
                "sum_kl": (kl_d * m).sum(dim=0), "n_sents": ex_mask.sum()}

    return fn


def aggregate_latent_stats(stats: List[Dict[str, np.ndarray]],
                           delta: float = 0.01) -> Dict[str, object]:
    """The host's reduction of per-batch sums (numpy): AU, the variance
    spectrum of the posterior mean and the KL spectrum."""
    if not stats:
        raise ValueError("no batches")
    n = float(sum(float(s["n_sents"]) for s in stats))
    if n <= 0:
        raise ValueError("no unmasked sentences")
    sum_mu = np.sum([np.asarray(s["sum_mu"], np.float64) for s in stats], axis=0)
    sum_mu2 = np.sum([np.asarray(s["sum_mu2"], np.float64) for s in stats], axis=0)
    sum_kl = np.sum([np.asarray(s["sum_kl"], np.float64) for s in stats], axis=0)
    mean_mu = sum_mu / n
    # population variance of the posterior mean across the corpus
    var_mu = np.maximum(sum_mu2 / n - mean_mu ** 2, 0.0)
    kl_d = sum_kl / n
    order = np.argsort(-kl_d)
    return {
        "n_sents": int(n),
        "latent_dim": int(var_mu.shape[0]),
        "au": int((var_mu > delta).sum()),
        "au_delta": float(delta),
        "kl_per_sent": float(kl_d.sum()),
        "kl_active_dims": int((kl_d > 1e-2).sum()),
        "kl_top8": [round(float(kl_d[i]), 4) for i in order[:8]],
        "var_mu_max": float(var_mu.max()),
        "var_mu_median": float(np.median(var_mu)),
    }


def latent_stats_corpus(model: VMMTModel, batches: Iterable[Dict[str, torch.Tensor]],
                        delta: float = 0.01) -> Dict[str, object]:
    """The stats pass over batches of device tensors, aggregated."""
    fn = make_latent_stats_fn(model)
    host = [{k: v.cpu().numpy() for k, v in fn(b).items()} for b in batches]
    return aggregate_latent_stats(host, delta=delta)
