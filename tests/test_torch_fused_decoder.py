"""PyTorch port: ``fused_input_feed_decoder`` (models/fused_decoder.py, the
``fused_decoder`` option) against the JAX package's custom-VJP scan.

Tolerances: f32 forward and every input's gradient within 1e-5 of the
largest entry of JAX's tensor (summation order only). bf16: both packages
keep states and products in bf16 but round in another order (XLA fuses
elementwise chains, PyTorch rounds after each op), and two bf16
evaluations of 5 steps end up as far apart as each is from the f32 math
(up to 3.3e-2 of a tensor's largest entry, readings of 1.5e-2 to 3.3e-2
from f32 for JAX's, seeds 0 and 3). So each bf16 tensor of the port must
lie within 5e-2 of the largest entry of JAX's f32 tensor from JAX's bf16
one, and its distance from JAX's f32 result must be at most twice JAX's
bf16 distance plus 2e-3 of that largest entry (readings up to 1.4x).
At model level in f32: the loss
1e-5 relative to JAX's and each gradient 1e-4 relative plus 1e-5 of its
largest entry (tests/test_torch_train.py's tolerances), and the loss 1e-6
relative to the port's own plain loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.models.fused_decoder import fused_input_feed_decoder as jax_fused
from variational_mmt_torch.config import Config, ModelConfig, TrainConfig
from variational_mmt_torch.convert import params_from_jax
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.models.fused_decoder import fused_input_feed_decoder
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.ops import decoder as dec
from variational_mmt_torch.train.trainer import batch_tensors, loss_and_grads

from test_torch_train import (TINY, TRAIN, check_loss_and_every_gradient, corpus,
                              perturbed_jax_params)

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
NAMES = ("emb_proj", "dmid", "h00", "h01", "wfeed", "wh0", "bh0", "wmid", "bmid", "wh1", "bh1",
         "keys", "mem_v", "wc_q", "mask_bias")


def inputs(seed=0, B=3, T=5, S=4, H=8, keep=0.7):
    """The function's 15 inputs in f32 numpy: dropout scales (0 or 1/keep)
    and a padded source (row 1 holds 2 real positions, row 2 one)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    dmid = ((rng.random((B, T, H)) < keep) / keep).astype(np.float32)
    real = np.ones((B, S), np.float32)
    real[1, 2:] = 0.0
    real[2, 1:] = 0.0
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(H)).astype(np.float32)  # noqa: E731
    return [n(B, T, 3 * H), dmid, n(B, H), n(B, H), w(H, 3 * H), w(H, 3 * H), n(3 * H),
            w(H, 3 * H), n(3 * H), w(H, 3 * H), n(3 * H), n(B, S, H), n(B, S, H), w(H, H),
            (1.0 - real) * np.float32(-1e9)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_vjp_match_jax(dtype):
    """Outputs and the gradient of every input, from random cotangents of
    both outputs, against ``jax.vjp`` of JAX's function."""
    ins = inputs()
    rng = np.random.default_rng(1)
    B, T, H = ins[1].shape
    S = ins[11].shape[1]
    g_attn = rng.standard_normal((B, T, H)).astype(np.float32)
    g_probs = rng.standard_normal((B, T, S)).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jax_run(jdt):
        jins = [jnp.asarray(a, jnp.float32 if i == 14 else jdt) for i, a in enumerate(ins)]
        outs, vjp = jax.vjp(lambda *a: jax_fused(*a, 1), *jins)
        grads = vjp((jnp.asarray(g_attn, jdt), jnp.asarray(g_probs, jdt)))
        return [np.asarray(jnp.asarray(w, jnp.float32)) for w in tuple(outs) + grads[:14]]

    want = jax_run(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    exact = jax_run(jnp.float32)

    tins = [torch.tensor(a).to(torch.float32 if i == 14 else tdt).requires_grad_(i != 14)
            for i, a in enumerate(ins)]
    attn, probs = fused_input_feed_decoder(*tins)
    grads = torch.autograd.grad((attn, probs), tins[:14],
                                (torch.tensor(g_attn).to(tdt), torch.tensor(g_probs).to(tdt)))
    assert attn.dtype == probs.dtype == tdt
    for name, g, w, x in zip(("attn_hs", "probs") + NAMES, (attn, probs) + grads, want, exact):
        g = g.detach().float().numpy()
        scale = max(float(np.abs(x).max()), 1e-6)
        err = float(np.abs(g - w).max())
        assert err <= TOL[dtype] * scale, (name, err / scale)
        if dtype == "bfloat16":  # no farther from the f32 math than JAX's bf16
            ours, theirs = float(np.abs(g - x).max()), float(np.abs(w - x).max())
            assert ours <= 2.0 * theirs + 2e-3 * scale, (name, ours / scale, theirs / scale)
    assert not grads[1].any()  # dmid's gradient is zero, as JAX's


def test_probs_cotangent_alone_reaches_every_input():
    """Only the alignments feed the loss: their gradient still reaches the
    recurrence and the memory (the backward's ``d_probs`` stream)."""
    tins = [torch.tensor(a).requires_grad_(i != 14) for i, a in enumerate(inputs(seed=2))]
    _, probs = fused_input_feed_decoder(*tins)
    (probs * torch.arange(probs.shape[-1], dtype=probs.dtype)).sum().backward()
    for i in (0, 2, 3, 4, 5, 11, 13):
        assert float(tins[i].grad.abs().max()) > 0, NAMES[i]


def model_and_batch(**over):
    cfg = Config(model=ModelConfig(**{**TINY, **over}), train=TrainConfig(**TRAIN))
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(perturbed_jax_params(JaxModelConfig(**TINY)),
                                          cfg.model))
    src, tgt, img = corpus()
    batch = next(BucketIterator(BinarizedDataset(src, tgt), 6, [10], img_feats=img).epoch())
    return cfg, model, batch_tensors(batch, torch.device("cpu"))


@pytest.mark.parametrize("over", [dict(z_cond="init+input"), dict(share_embeddings=True)],
                         ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_model_fused_decoder_matches_jax(over):
    """``fused_decoder=True`` in both packages: loss and every parameter
    gradient (the shape of tests/test_models.py:250-275; the flagship's
    z_cond=init is held in tests/test_torch_train.py)."""
    check_loss_and_every_gradient(dict(fused_decoder=True, **over))


def test_fused_route_matches_the_plain_loop_and_skips_the_kernels(monkeypatch):
    """f32, the same batch and weights: the fused route against the port's
    plain loop, loss within 1e-6 relative and every gradient within 1e-4 of
    its largest entry; rows 5 and 6 (the decoder sequence kernels) are not
    called on it, even with use_pallas."""
    res = {}
    called = []
    for fn in ("decoder_fwd", "decoder_bwd"):
        orig = getattr(dec, fn)
        monkeypatch.setattr(dec, fn, lambda *a, _f=orig, **k: called.append(1) or _f(*a, **k))
    for name, over in (("fused", dict(fused_decoder=True, use_pallas=True)), ("plain", dict())):
        cfg, model, b = model_and_batch(**over)
        loss, _, grads = loss_and_grads(cfg, model, b, 7, None, deterministic=True,
                                        sample=False)
        res[name] = (float(loss.detach()), grads)
    assert not called
    (lf, gf), (lp, gp) = res["fused"], res["plain"]
    assert lf == pytest.approx(lp, rel=1e-6)
    for a, b in zip(gf, gp):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-6)


def test_fused_route_trains_with_dropout():
    """With dropout the fused route draws its one mask up front, as the
    kernel route does, and gives the kernel route's loss and gradients on
    the same generator state (f32)."""
    res = {}
    for name, over in (("fused", dict(fused_decoder=True)),
                       ("kernels", dict(use_pallas=True, pallas_decoder=True))):
        cfg, model, b = model_and_batch(**over)
        gen = torch.Generator().manual_seed(3)
        loss, _, grads = loss_and_grads(cfg, model, b, 7, gen)
        res[name] = (float(loss.detach()), grads)
        assert np.isfinite(res[name][0])
    (lf, gf), (lk, gk) = res["fused"], res["kernels"]
    assert lf == pytest.approx(lk, rel=1e-5)
    for a, b in zip(gf, gk):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-6)
