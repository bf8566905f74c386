"""PyTorch port: the decode-step and GRU-chain kernels' plain versions
against the JAX Pallas kernels (interpret mode), and ``one_step`` in all
three ``keys`` modes against JAX. Tolerance: 1e-5 absolute and relative,
f32 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.models.model import VMMTModel as JaxVMMTModel
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.models.model import init_params as jax_init_params
from variational_mmt_tpu.ops.pallas.decode_step import decode_step_pallas, gru_chain_pallas
from variational_mmt_torch.config import ModelConfig
from variational_mmt_torch.convert import params_from_jax
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.ops.decode_step import (decode_step, decode_step_ref, gru_chain,
                                                   gru_chain_ref)

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(model_type="vmmt_c", src_vocab_size=24, tgt_vocab_size=24, emb_dim=16,
            hidden_dim=16, latent_dim=4, img_feat_dim=6, compute_dtype="float32",
            use_pallas=True)


def step_inputs(N=6, S=5, H=8, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    w = lambda *s: (r(*s) / np.sqrt(H)).astype(np.float32)  # noqa: E731
    chain = [r(N, 3 * H), np.tanh(r(N, H)), np.tanh(r(N, H)), np.tanh(r(N, H)),
             w(H, 3 * H), w(H, 3 * H), 0.1 * r(3 * H), w(H, 3 * H), 0.1 * r(3 * H),
             w(H, 3 * H), 0.1 * r(3 * H)]
    lengths = np.array([5, 3, 1, 4, 5, 2])[:N]
    mask_bias = np.where(np.arange(S)[None, :] < lengths[:, None], 0.0, -1e9).astype(np.float32)
    attn = [r(N, S, H), r(N, S, H), w(H, H), mask_bias]
    return chain, attn


def test_decode_step_ref_matches_jax_kernel():
    chain, attn = step_inputs()
    want = decode_step_pallas(*map(jnp.asarray, chain + attn), interpret=True)
    got = decode_step_ref(*map(torch.from_numpy, chain + attn))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_gru_chain_ref_matches_jax_kernel():
    chain, _ = step_inputs(seed=1)
    want = gru_chain_pallas(*map(jnp.asarray, chain), interpret=True)
    got = gru_chain_ref(*map(torch.from_numpy, chain))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_wrappers_take_the_plain_versions_on_cpu():
    chain, attn = step_inputs(seed=2)
    chain, attn = [torch.from_numpy(a) for a in chain], [torch.from_numpy(a) for a in attn]
    for g, w in zip(decode_step(*chain, *attn), decode_step_ref(*chain, *attn)):
        assert torch.equal(g, w)
    for g, w in zip(gru_chain(*chain), gru_chain_ref(*chain)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["plain", "fused_step", "gru_chain"])
def test_one_step_matches_jax(mode):
    """``decode_step`` (embedding, one_step, generator) from the same carry,
    with keys as a tensor, a (keys, mem_v) pair, or a (keys,) 1-tuple."""
    jcfg = JaxModelConfig(**TINY)
    jmodel = jax_build_model(jcfg)
    rng = np.random.default_rng(3)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))).astype(np.float32),
        jax.device_get(jax_init_params(jmodel, jax.random.PRNGKey(0))))
    B, S, H = 3, 6, TINY["hidden_dim"]
    memory = np.tanh(rng.standard_normal((B, S, H))).astype(np.float32)
    src_mask = np.ones((B, S), np.float32)
    src_mask[1, 4:] = 0
    src_mask[2, 2:] = 0
    hs = [np.tanh(rng.standard_normal((B, H))).astype(np.float32) for _ in range(2)]
    feed = np.tanh(rng.standard_normal((B, H))).astype(np.float32)
    z = rng.standard_normal((B, TINY["latent_dim"])).astype(np.float32)
    toks = np.array([5, 9, 2], np.int32)

    apply = lambda method, *a: jmodel.apply({"params": tree}, *a, method=method)  # noqa: E731
    keys = apply(JaxVMMTModel.project_memory, jnp.asarray(memory), mode == "fused_step")
    if mode == "gru_chain":
        keys = (keys,)
    carry = ((jnp.asarray(hs[0]), jnp.asarray(hs[1])), jnp.asarray(feed))
    (jhs, jfeed), jlogits, jalign = apply(JaxVMMTModel.decode_step, carry, jnp.asarray(toks),
                                          jnp.asarray(memory), jnp.asarray(src_mask),
                                          jnp.asarray(z), keys)

    cfg = ModelConfig(**TINY)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    t = torch.from_numpy
    with torch.no_grad():
        tkeys = model.project_memory(t(memory), mode == "fused_step")
        if mode == "gru_chain":
            tkeys = (tkeys,)
        (ths, tfeed), tlogits, talign = model.decode_step(
            ((t(hs[0]), t(hs[1])), t(feed)), t(toks).long(), t(memory), t(src_mask), t(z),
            tkeys)
    for g, w in [(ths[0], jhs[0]), (ths[1], jhs[1]), (tfeed, jfeed), (tlogits, jlogits),
                 (talign, jalign)]:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
