"""PyTorch port: the GRU-scan kernel's plain version and the encoder against
the JAX package (Pallas kernels in interpret mode, as tests/test_pallas.py
runs them). Tolerance: 1e-5 absolute and relative, f32 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.models.model import VMMTModel as JaxVMMTModel
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.models.model import init_params as jax_init_params
from variational_mmt_tpu.ops.pallas.gru import gru_layer_scan as jax_gru_layer_scan
from variational_mmt_torch.config import ModelConfig
from variational_mmt_torch.convert import params_from_jax
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.ops.gru_scan import gru_layer_scan, gru_layer_scan_ref

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(model_type="vmmt_c", src_vocab_size=24, tgt_vocab_size=24, emb_dim=16,
            hidden_dim=16, latent_dim=4, img_feat_dim=6, compute_dtype="float32")


def scan_inputs(B=5, T=7, H=8, seed=0):
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((B, T, 3 * H)).astype(np.float32)
    m = np.ones((B, T), np.float32)
    m[1, 4:] = 0  # ragged right padding
    m[3, 1:] = 0
    h0 = (0.3 * rng.standard_normal((B, H))).astype(np.float32)
    wh = (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    bh = (0.1 * rng.standard_normal(3 * H)).astype(np.float32)
    return xp, m, h0, wh, bh


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_scan_ref_matches_jax_kernel(reverse):
    args = scan_inputs()
    want = jax_gru_layer_scan(*map(jnp.asarray, args), reverse=reverse, interpret=True)
    got = gru_layer_scan_ref(*map(torch.from_numpy, args), reverse=reverse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_scan_takes_the_plain_version_on_cpu(reverse):
    args = [torch.from_numpy(a) for a in scan_inputs(seed=1)]
    got = gru_layer_scan(*args, reverse=reverse)
    want = gru_layer_scan_ref(*args, reverse=reverse)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def perturbed_jax_params(cfg, seed=0):
    """JAX init params with every leaf perturbed (no zero biases), as numpy."""
    tree = jax.device_get(jax_init_params(jax_build_model(cfg), jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_encoder_matches_jax_encode(use_pallas):
    over = dict(use_pallas=use_pallas)
    jcfg = JaxModelConfig(**{**TINY, **over})
    tree = perturbed_jax_params(jcfg)
    src = np.array([[5, 6, 7, 8, 9, 10, 11, 12], [4, 5, 6, 0, 0, 0, 0, 0],
                    [13, 14, 15, 16, 17, 0, 0, 0]], np.int32)
    memory, finals, src_mask, summary = jax_build_model(jcfg).apply(
        {"params": tree}, jnp.asarray(src), method=JaxVMMTModel.encode)

    cfg = ModelConfig(**{**TINY, **over})
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    with torch.no_grad():
        t_memory, t_finals, t_mask, t_summary = model.encode(torch.from_numpy(src).long())
    np.testing.assert_allclose(t_memory.numpy(), np.asarray(memory), **TOL)
    np.testing.assert_allclose(t_mask.numpy(), np.asarray(src_mask), **TOL)
    np.testing.assert_allclose(t_summary.numpy(), np.asarray(summary), **TOL)
    assert len(t_finals) == len(finals) == 2
    for g, w in zip(t_finals, finals):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
