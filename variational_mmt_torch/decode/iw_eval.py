"""K-sample importance-weighted ELBO. Mirrors ``make_iw_elbo_fn`` and
``iw_elbo_corpus`` of ``variational_mmt_tpu/decode/iw_eval.py`` (:23-121):

    IW_K = log (1/K) sum_k  p(y|x,z_k) * p(v|z_k) * p(z_k|x,v) / q(z_k|x,y,v)

with z_k ~ q, the paper's bound for comparing models (a tighter bound than
the 1-sample ELBO), not a decoding rule. The loop-invariant work (the
encoder, q, the prior and the image target) runs once a batch; the K
samples then run one teacher-forced decoder pass at a time, as JAX's
``lax.map`` does, so memory stays that of one pass. With ``use_pallas``
and ``pallas_decoder`` on the card each pass is one launch of the decoder
sequence kernel, and the encoder and q's target encoder run on the scan
kernel. ``logsumexp`` over the samples runs in f32.

The noise: JAX folds the batch index into its key and splits it K ways
(threefry, which cannot be reproduced); the port draws from one
``torch.Generator`` seeded from the caller's seed, or takes an injected
eps of shape (K, B, D), as the parity tests inject JAX's own.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import torch

from variational_mmt_torch.data.vocab import PAD
from variational_mmt_torch.models.latent import gaussian_log_prob
from variational_mmt_torch.models.model import VMMTModel


def make_iw_elbo_fn(model: VMMTModel, k_samples: int) -> Callable:
    """fn(batch, generator=None, eps=None) -> per-batch sums
    {iw_elbo_sum, iw_text_sum, n_sents, n_tokens} (f32 scalars on the
    model's device), as JAX's, and ``iw_per_sent`` (2, B): each sentence's
    joint and text-only bounds (0 on padding rows). ``batch`` holds src,
    tgt_in, tgt_out, example_mask (+ img for multimodal models) as tensors
    on the model's device; ``eps`` (K, B, D) replaces the draws from
    ``generator``."""
    if not model.is_latent:
        raise ValueError("IW-ELBO eval requires a latent model (vmmt_f/vmmt_c)")

    @torch.inference_mode()
    def fn(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
           eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        src, tgt_in, tgt_out = batch["src"], batch["tgt_in"], batch["tgt_out"]
        ex_mask = batch["example_mask"].float()
        img = batch.get("img")
        memory, finals, src_mask, summary = model.encode(src)
        mu_q, sigma_q = model.posterior(summary, tgt_out, img)
        mu_p, sigma_p = model.prior_params(summary, img)
        tok_mask = (tgt_out != PAD).float() * ex_mask[:, None]
        # hoisted: the image target does not depend on the sample
        v_target = None
        if model.cfg.use_img_predict and img is not None:
            v_target = model._img_in(img, summary)
        logws = []
        for k in range(k_samples):
            e = (torch.randn(mu_q.shape, generator=generator, dtype=mu_q.dtype,
                             device=mu_q.device) if eps is None else eps[k].to(mu_q))
            z = mu_q + sigma_q * e
            init_hs = model.init_decoder_state(finals, z)
            logits, _ = model.decode_train(tgt_in, memory, src_mask, init_hs, z)
            logp = torch.log_softmax(logits.float(), dim=-1)
            ll_y = (logp.gather(-1, tgt_out[..., None])[..., 0] * tok_mask).sum(dim=-1)
            # text-only weight p(y,z|x)/q(z): a bound on log p(y|x)
            logw_text = (ll_y + gaussian_log_prob(z, mu_p, sigma_p)
                         - gaussian_log_prob(z, mu_q, sigma_q))
            logw_joint = logw_text
            if v_target is not None:
                # adds p(v|z): a bound on log p(y,v|x)
                logw_joint = logw_joint + gaussian_log_prob(v_target, model.predict_img(z), 1.0)
            logws.append(torch.stack([logw_joint, logw_text]))
        iw = torch.logsumexp(torch.stack(logws).float(), dim=0) - math.log(k_samples)  # (2, B)
        iw = iw * ex_mask[None, :]
        return {"iw_elbo_sum": iw[0].sum(), "iw_text_sum": iw[1].sum(),
                "n_sents": ex_mask.sum(), "n_tokens": tok_mask.sum(), "iw_per_sent": iw}

    return fn


def iw_elbo_corpus(model: VMMTModel, batches: Iterable[Dict[str, torch.Tensor]],
                   k_samples: int, seed: int = 0,
                   eps: Optional[Callable[[int], torch.Tensor]] = None) -> Dict[str, float]:
    """The IW bound over batches of device tensors (the layout of
    :func:`make_iw_elbo_fn`): per-sentence joint and text-only bounds, the
    IW perplexity and the sentence count. The draws come from one
    ``torch.Generator`` on the model's device seeded with ``seed``;
    ``eps(i)`` (K, B, D) replaces them for batch i."""
    fn = make_iw_elbo_fn(model, k_samples)
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    tot = tot_text = n_sent = n_tok = 0.0
    for i, batch in enumerate(batches):
        out = fn(batch, gen, None if eps is None else eps(i))
        tot += float(out["iw_elbo_sum"])
        tot_text += float(out["iw_text_sum"])
        n_sent += float(out["n_sents"])
        n_tok += float(out["n_tokens"])
    return {
        "iw_elbo_per_sent": tot / max(1.0, n_sent),  # joint log p(y,v|x) bound
        "iw_text_per_sent": tot_text / max(1.0, n_sent),  # log p(y|x) bound
        "iw_ppl": math.exp(min(-tot_text / max(1.0, n_tok), 100.0)),
        "n_sents": n_sent,
    }
