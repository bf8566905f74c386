"""PyTorch port: the decoder sequence kernels' plain versions and the
differentiable ``fused_decoder_pallas`` against the JAX package's Pallas
kernels in interpret mode (as tests/test_pallas.py:344 and :364 run them).
Inputs and dropout masks are made with numpy and fed to both sides. f32;
tolerances: forward streams 1e-5 absolute and relative; gradients 2e-4
relative and 2e-6 absolute, as the JAX package's own gradient test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variational_mmt_tpu.ops.pallas.decoder import (decoder_bwd_pallas, decoder_fwd_pallas,
                                                    fused_decoder_pallas as jax_fused_decoder)
from variational_mmt_torch.ops.decoder import (decoder_bwd, decoder_bwd_ref, decoder_fwd,
                                               decoder_fwd_ref, fused_decoder_pallas)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-6)
DIFF_IDX = [0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]  # all but dmid and mask_bias


def dec_inputs(seed=0, B=6, T=5, S=4, H=8, dropout=False):
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa: E731
    dmid = ((rng.random((B, T, H)) > 0.3).astype(np.float32) / np.float32(0.7)
            if dropout else np.ones((B, T, H), np.float32))
    mask = np.ones((B, S), np.float32)
    mask[1, 2:] = 0  # padded source tails
    mask[4, 1:] = 0
    mask_bias = ((1.0 - mask) * -1e9).astype(np.float32)
    return [r(B, T, 3 * H), dmid, r(B, H), r(B, H), r(H, 3 * H), r(H, 3 * H), r(3 * H),
            r(H, 3 * H), r(3 * H), r(H, 3 * H), r(3 * H), r(B, S, H), r(B, S, H), r(H, H),
            mask_bias]


@pytest.mark.parametrize("dropout", [False, True])
def test_decoder_fwd_ref_matches_jax_kernel(dropout):
    args = dec_inputs(dropout=dropout)
    want = decoder_fwd_pallas(*map(jnp.asarray, args), interpret=True)
    got = decoder_fwd_ref(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL)


def test_decoder_bwd_ref_matches_jax_kernel():
    """The raw backward outputs (six local-gradient streams, dh00, dh01)."""
    args = dec_inputs(seed=1, dropout=True)
    streams = decoder_fwd_pallas(*map(jnp.asarray, args), interpret=True)
    rng = np.random.default_rng(2)
    B, T, H, S = 6, 5, 8, 4
    d_attn = rng.standard_normal((B, T, H)).astype(np.float32)
    d_probs = rng.standard_normal((B, T, S)).astype(np.float32)
    want = decoder_bwd_pallas(*map(jnp.asarray, args[:14]), *streams, jnp.asarray(d_attn),
                              jnp.asarray(d_probs), interpret=True)
    got = decoder_bwd_ref(*map(torch.from_numpy, args[:14]),
                          *(torch.from_numpy(np.array(s)) for s in streams),
                          torch.from_numpy(d_attn), torch.from_numpy(d_probs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL)


def test_fused_decoder_grads_match_jax():
    """Every differentiable input's gradient against jax.grad through the
    JAX package's ``fused_decoder_pallas`` (its backward is the Pallas
    kernel plus the ``_pal_bwd`` einsums)."""
    args = dec_inputs(seed=3, dropout=True)
    B, T, H = args[0].shape[0], args[0].shape[1], args[2].shape[1]
    S = args[11].shape[1]
    rng = np.random.default_rng(4)
    ga = (rng.standard_normal((B, T, H)) * 0.1).astype(np.float32)
    gp = (rng.standard_normal((B, T, S)) * 0.1).astype(np.float32)

    def obj(*dargs):
        full = [jnp.asarray(a) for a in args]
        for i, a in zip(DIFF_IDX, dargs):
            full[i] = a
        attn, probs = jax_fused_decoder(*full, True, 0)
        return (attn * ga).sum() + (probs * gp).sum()

    want = jax.grad(obj, argnums=tuple(range(len(DIFF_IDX))))(
        *(jnp.asarray(args[i]) for i in DIFF_IDX))

    t = [torch.from_numpy(a) for a in args]
    for i in DIFF_IDX:
        t[i].requires_grad_(True)
    attn, probs = fused_decoder_pallas(*t)
    ((attn * torch.from_numpy(ga)).sum() + (probs * torch.from_numpy(gp)).sum()).backward()
    assert t[1].grad is None and t[14].grad is None
    for i, w in zip(DIFF_IDX, want):
        assert t[i].grad.dtype == torch.float32
        np.testing.assert_allclose(t[i].grad.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"gradient of argument {i}")


def test_wrappers_take_the_plain_versions_on_cpu():
    args = [torch.from_numpy(a) for a in dec_inputs(seed=5, dropout=True)]
    streams = decoder_fwd(*args)
    for g, w in zip(streams, decoder_fwd_ref(*args)):
        assert torch.equal(g, w)
    d = (torch.ones_like(streams[0]), torch.ones_like(streams[3]))
    for g, w in zip(decoder_bwd(*args[:14], *streams, *d),
                    decoder_bwd_ref(*args[:14], *streams, *d)):
        assert torch.equal(g, w)


def test_fused_decoder_grads_take_the_inputs_dtypes():
    args = [torch.from_numpy(a) for a in dec_inputs(seed=6)]
    for i in (0, 1, 4, 5, 7, 9, 11, 12, 13):  # the compute-dtype tensors
        args[i] = args[i].to(torch.bfloat16)
    for i in DIFF_IDX:
        args[i].requires_grad_(True)
    attn, probs = fused_decoder_pallas(*args)
    assert attn.dtype == probs.dtype == torch.bfloat16
    (attn.float().sum() + probs.float().sum()).backward()
    for i in DIFF_IDX:
        assert args[i].grad.dtype == args[i].dtype
