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

With a mesh (JAX :85-110) each data rank evaluates its rows of every
batch, drawing the global batch's noise and keeping its rows' (so the
bound is the single process's up to the order of the sums), the model is
this rank's vocab-parallel shard when the mesh has several model ranks
(the gold log-likelihood reduced over the vocab shards,
``parallel.tp.token_log_prob``), and the corpus sums are all-reduced over
the data group once, at the end.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from variational_mmt_torch.data.vocab import PAD
from variational_mmt_torch.models.latent import gaussian_log_prob
from variational_mmt_torch.models.model import VMMTModel, shard_model
from variational_mmt_torch.parallel import mesh as pm, tp


def make_iw_elbo_fn(model: VMMTModel, k_samples: int) -> Callable:
    """fn(batch, generator=None, eps=None, rows=None) -> per-batch sums
    {iw_elbo_sum, iw_text_sum, n_sents, n_tokens} (f32 scalars on the
    model's device), as JAX's, and ``iw_per_sent`` (2, B): each sentence's
    joint and text-only bounds (0 on padding rows). ``batch`` holds src,
    tgt_in, tgt_out, example_mask (+ img for multimodal models) as tensors
    on the model's device; ``eps`` (K, B, D) replaces the draws from
    ``generator``. ``rows`` (slice, n): the batch is these rows of an
    n-row batch, and each sample draws n rows of noise and keeps these."""
    if not model.is_latent:
        raise ValueError("IW-ELBO eval requires a latent model (vmmt_f/vmmt_c)")

    @torch.inference_mode()
    def fn(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
           eps: Optional[torch.Tensor] = None,
           rows: Optional[Tuple[slice, int]] = None) -> Dict[str, torch.Tensor]:
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
            if eps is not None:
                e = eps[k].to(mu_q)
            elif rows is None:
                e = torch.randn(mu_q.shape, generator=generator, dtype=mu_q.dtype,
                                device=mu_q.device)
            else:
                e = torch.randn((rows[1],) + mu_q.shape[1:], generator=generator,
                                dtype=mu_q.dtype, device=mu_q.device)[rows[0]]
            z = mu_q + sigma_q * e
            init_hs = model.init_decoder_state(finals, z)
            logits, _ = model.decode_train(tgt_in, memory, src_mask, init_hs, z)
            if model.vocab_mesh is None:
                logp = torch.log_softmax(logits.float(), dim=-1)
                ll_tok = logp.gather(-1, tgt_out[..., None])[..., 0]
            else:
                ll_tok = tp.token_log_prob(logits, tgt_out, model.vocab_mesh)
            ll_y = (ll_tok * tok_mask).sum(dim=-1)
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
                   eps: Optional[Callable[[int], torch.Tensor]] = None,
                   mesh: Optional[pm.Mesh] = None) -> Dict[str, float]:
    """The IW bound over batches of device tensors (the layout of
    :func:`make_iw_elbo_fn`): per-sentence joint and text-only bounds, the
    IW perplexity and the sentence count. The draws come from one
    ``torch.Generator`` on the model's device seeded with ``seed``;
    ``eps(i)`` (K, B, D) replaces them for batch i. With ``mesh`` every
    rank passes the same full batches and the full model (or its shard);
    each evaluates its rows (module docstring)."""
    if mesh is not None:
        model = shard_model(model, mesh)
    fn = make_iw_elbo_fn(model, k_samples)
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    tot = tot_text = n_sent = n_tok = 0.0
    sums = []
    for i, batch in enumerate(batches):
        e = None if eps is None else eps(i)
        if mesh is None:
            out = fn(batch, gen, e)
            tot += float(out["iw_elbo_sum"])
            tot_text += float(out["iw_text_sum"])
            n_sent += float(out["n_sents"])
            n_tok += float(out["n_tokens"])
            continue
        rows = pm.data_rows(batch["src"].shape[0], mesh), batch["src"].shape[0]
        out = fn(pm.shard_batch(batch, mesh), gen, None if e is None else e[:, rows[0]], rows)
        sums.append(torch.stack([out[k].float() for k in
                                 ("iw_elbo_sum", "iw_text_sum", "n_sents", "n_tokens")]))
    if sums:  # one all-reduce of every batch's sums; added on the host in float64
        per_batch = pm.all_reduce(torch.stack(sums), mesh.data_group).cpu().double()
        tot, tot_text, n_sent, n_tok = per_batch.sum(dim=0).tolist()
    return {
        "iw_elbo_per_sent": tot / max(1.0, n_sent),  # joint log p(y,v|x) bound
        "iw_text_per_sent": tot_text / max(1.0, n_sent),  # log p(y|x) bound
        "iw_ppl": math.exp(min(-tot_text / max(1.0, n_tok), 100.0)),
        "n_sents": n_sent,
    }
