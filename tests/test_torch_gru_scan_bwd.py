"""PyTorch port: the GRU-scan backward (plain version of the CUDA kernel)
and the differentiable ``gru_layer_scan_ad`` against the JAX package's
custom VJP, whose backward is the Pallas kernel ``_gru_bwd_kernel`` run in
interpret mode (as tests/test_pallas.py runs it). Right-padded rows, both
directions, a cotangent on the outputs and on the final state. f32;
tolerance 1e-5 absolute and relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variational_mmt_tpu.ops.pallas.gru import _gru_scan_bwd_impl
from variational_mmt_tpu.ops.pallas.gru import gru_layer_scan_ad as jax_gru_layer_scan_ad
from variational_mmt_torch.ops.gru_scan import (gru_layer_scan_ad, gru_layer_scan_bwd,
                                                gru_layer_scan_bwd_ref, gru_layer_scan_ref)

TOL = dict(rtol=1e-5, atol=1e-5)


def scan_inputs(B=5, T=7, H=8, seed=0):
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((B, T, 3 * H)).astype(np.float32)
    lengths = np.array([7, 4, 7, 1, 6])[:B]  # ragged right padding
    m = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    h0 = (0.3 * rng.standard_normal((B, H))).astype(np.float32)
    wh = (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    bh = (0.1 * rng.standard_normal(3 * H)).astype(np.float32)
    g_outs = rng.standard_normal((B, T, H)).astype(np.float32)
    g_fin = rng.standard_normal((B, H)).astype(np.float32)
    return (xp, m, h0, wh, bh), g_outs, g_fin


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_scan_ad_grads_match_jax_vjp(reverse):
    args, g_outs, g_fin = scan_inputs()
    jargs = [jnp.asarray(a) for a in args]
    _, vjp = jax.vjp(lambda x, h0, wh, bh: jax_gru_layer_scan_ad(x, jargs[1], h0, wh, bh,
                                                                 reverse, True),
                     jargs[0], jargs[2], jargs[3], jargs[4])
    want = vjp((jnp.asarray(g_outs), jnp.asarray(g_fin)))

    t = [torch.from_numpy(a) for a in args]
    for i in (0, 2, 3, 4):
        t[i].requires_grad_(True)
    outs, fin = gru_layer_scan_ad(*t, reverse=reverse)
    ref_outs, ref_fin = gru_layer_scan_ref(*[a.detach() for a in t], reverse=reverse)
    assert torch.equal(outs.detach(), ref_outs) and torch.equal(fin.detach(), ref_fin)
    torch.autograd.backward((outs, fin), (torch.from_numpy(g_outs), torch.from_numpy(g_fin)))
    for got, w in zip((t[0].grad, t[2].grad, t[3].grad, t[4].grad), want):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_scan_bwd_ref_matches_jax_kernel(reverse):
    """The raw backward outputs (dx_proj, dh0, dWh, dbh) against
    ``_gru_scan_bwd_impl`` (time-major in JAX, batch-major here)."""
    args, g_outs, _ = scan_inputs(seed=1)
    xp, m, h0, wh, bh = args
    outs = np.asarray(gru_layer_scan_ref(*map(torch.from_numpy, args), reverse=reverse)[0])
    want = _gru_scan_bwd_impl(jnp.asarray(xp).swapaxes(0, 1),
                              jnp.asarray(m).swapaxes(0, 1)[:, None, :], jnp.asarray(h0),
                              jnp.asarray(wh), jnp.asarray(bh).reshape(1, -1),
                              jnp.asarray(outs).swapaxes(0, 1),
                              jnp.asarray(g_outs).swapaxes(0, 1), reverse, True)
    got = gru_layer_scan_bwd_ref(*map(torch.from_numpy, args), torch.from_numpy(outs),
                                 torch.from_numpy(g_outs), reverse)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]).swapaxes(0, 1), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **TOL)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]).reshape(-1), **TOL)


def test_gru_layer_scan_bwd_takes_the_plain_version_on_cpu():
    args, g_outs, _ = scan_inputs(seed=2)
    t = [torch.from_numpy(a) for a in args]
    outs, _ = gru_layer_scan_ref(*t)
    got = gru_layer_scan_bwd(*t, outs, torch.from_numpy(g_outs))
    want = gru_layer_scan_bwd_ref(*t, outs, torch.from_numpy(g_outs))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_gru_layer_scan_ad_grads_take_the_inputs_dtypes():
    args, g_outs, g_fin = scan_inputs(B=5, T=4, H=4, seed=3)
    x = torch.from_numpy(args[0]).to(torch.bfloat16).requires_grad_(True)
    wh = torch.from_numpy(args[3]).to(torch.bfloat16).requires_grad_(True)
    h0 = torch.from_numpy(args[2]).requires_grad_(True)
    bh = torch.from_numpy(args[4]).requires_grad_(True)
    outs, fin = gru_layer_scan_ad(x, torch.from_numpy(args[1]), h0, wh, bh)
    (outs.sum() + fin.sum()).backward()
    assert (x.grad.dtype, wh.grad.dtype, h0.grad.dtype, bh.grad.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32, torch.float32)
