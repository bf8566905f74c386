"""PyTorch port: the bf16 contract of the decoder sequence kernels (rows 5
and 6) against JAX's, along a training trajectory of the region case.

The port's ``pallas_decoder`` route in bf16 (on the CPU the kernels' plain
versions, ``decoder_fwd_ref`` / ``decoder_bwd_ref``, with the weight
gradients of ``_weight_grads``) against JAX's ``pallas_decoder=True``
route in bf16 (its Pallas kernels in interpret mode), on the quality
gate's configuration at a tiny width (``tests/torch_train_drift.py``)
with 4 region features pooled by attention (``img_feat_type=conv``,
``img_pool=attn``), the whole kernel route (``use_pallas``, ``fused_ce``)
in both packages. JAX trains 10 steps with Adam (learning rate 1e-2, so
that the parameters move) on its own bf16 gradients; at steps 0, 5 and 10
the port takes JAX's parameters (re-synced, so that bf16 drift does not
compound) and computes the loss and every gradient of the same batch,
deterministic and at the posterior mean, as JAX does.

Tolerances (bf16: both packages round the same streams but sum in other
orders): the loss within 1e-4 relative (readings up to 2e-5); each
parameter's gradient within 5e-2 relative in norm, ``||g - g_jax|| /
||g_jax||`` (readings up to 3.4e-2, biases summed from bf16 terms); the
decoder's weights as one vector within 1.5e-2 (readings up to 5e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_train_drift as drift
from variational_mmt_tpu.config import Config as JaxConfig
from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.config import TrainConfig as JaxTrainConfig
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.models.model import generator_params as jax_generator_params
from variational_mmt_tpu.train.loss import compute_loss as jax_compute_loss
from variational_mmt_tpu.train.trainer import create_train_state as jax_create_state
from variational_mmt_torch.config import Config, ModelConfig, TrainConfig
from variational_mmt_torch.convert import flatten, grads_to_jax, params_from_jax
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.train.trainer import batch_tensors, loss_and_grads

ROUTE = dict(compute_dtype="bfloat16", use_pallas=True, pallas_decoder=True, fused_ce=True,
             img_feat_type="conv", img_pool="attn")
POINTS = (0, 5, 10)
LOSS_RTOL, GRAD_RTOL, DECODER_RTOL = 1e-4, 5e-2, 1.5e-2
KEYS = ("src", "tgt_in", "tgt_out", "example_mask", "img")


def rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def trajectory():
    """[(step, JAX's parameters, batch, JAX's loss, JAX's gradients)] at
    POINTS of JAX's bf16 run."""
    mcfg = drift.gate_model(**ROUTE)
    jcfg = JaxModelConfig(**mcfg)
    tcfg = JaxTrainConfig(**drift.gate_train(100, 0))
    jmodel = jax_build_model(jcfg)
    params = jax_create_state(JaxConfig(model=jcfg, train=tcfg), jmodel).params

    def loss_fn(p, b, step):
        out = jmodel.apply({"params": p}, b["src"], b["tgt_in"], b["img"], deterministic=True,
                           sample=False, tgt_out=b["tgt_out"])
        return jax_compute_loss(out, b["tgt_out"], b["example_mask"], b["img"], jcfg, tcfg, step,
                                generator_params=jax_generator_params(p, jcfg))[0]

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    points = []
    for i, b in enumerate(drift.gate_batches(POINTS[-1] + 1, 0, regions=4)):
        loss, grads = value_and_grad(params, {k: jnp.asarray(getattr(b, k)) for k in KEYS},
                                     jnp.int32(i))
        if i in POINTS:
            points.append((i, jax.device_get(params), b, float(loss), jax.device_get(grads)))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return mcfg, points


@pytest.mark.parametrize("point", range(len(POINTS)), ids=[f"step{s}" for s in POINTS])
def test_port_pallas_decoder_route_holds_jax_in_bf16(trajectory, point):
    mcfg, points = trajectory
    step, params, batch, want_loss, want_grads = points[point]
    cfg = Config(model=ModelConfig(**mcfg), train=TrainConfig(**drift.gate_train(100, 0)))
    assert cfg.model.pallas_decoder and cfg.model.compute_dtype == "bfloat16"
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg.model))
    loss, _, _ = loss_and_grads(cfg, model, batch_tensors(batch, torch.device("cpu")), step,
                                None, deterministic=True, sample=False)
    assert np.isfinite(want_loss)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=LOSS_RTOL)
    got = flatten(grads_to_jax(model))
    want = {k: np.asarray(v, np.float32) for k, v in flatten(want_grads).items()}
    assert set(got) == set(want)
    far = {n: rel(got[n], want[n]) for n in want if not rel(got[n], want[n]) <= GRAD_RTOL}
    assert not far, far
    dec = sorted(n for n in want if n.startswith("decoder."))
    assert len(dec) >= 10  # ih_emb, the step's recurrent, feed, mid and attention weights
    d = rel(np.concatenate([got[n].ravel() for n in dec]),
            np.concatenate([want[n].ravel() for n in dec]))
    assert d <= DECODER_RTOL, d
