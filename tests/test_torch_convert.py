"""PyTorch port: the parameter bridge between the JAX package and the port
(variational_mmt_torch/convert.py) and the port's numpy initializer."""

import jax
import numpy as np
import pytest

from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.models.model import init_params as jax_init_params
from variational_mmt_torch.config import ModelConfig
from variational_mmt_torch.convert import flatten, params_from_jax, params_to_jax
from variational_mmt_torch.models.model import build_model, init_params

TINY = dict(model_type="vmmt_c", src_vocab_size=24, tgt_vocab_size=24, emb_dim=16,
            hidden_dim=16, latent_dim=4, img_feat_dim=6, compute_dtype="float32",
            use_pallas=True)


def jax_tree(**over):
    model = jax_build_model(JaxModelConfig(**{**TINY, **over}))
    return jax.device_get(jax_init_params(model, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("tied", [False, True])
def test_vmmt_c_tree_round_trips_every_leaf(tied):
    over = dict(share_decoder_embeddings=tied)
    tree = jax_tree(**over)
    cfg = ModelConfig(**{**TINY, **over})
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))  # strict: every key
    want, got = flatten(tree), flatten(params_to_jax(model.state_dict()))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_port_init_params_has_the_jax_layout_and_is_seeded():
    want = {k: np.shape(v) for k, v in flatten(jax_tree()).items()}
    ours = flatten(init_params(ModelConfig(**TINY), seed=0))
    assert {k: v.shape for k, v in ours.items()} == want
    again = flatten(init_params(ModelConfig(**TINY), seed=0))
    other = flatten(init_params(ModelConfig(**TINY), seed=1))
    k = "decoder.step.hh_kernel0"
    np.testing.assert_array_equal(ours[k], again[k])
    assert not np.array_equal(ours[k], other[k])


def test_params_from_jax_rejects_missing_extra_and_misshaped_leaves():
    cfg = ModelConfig(**TINY)
    tree = jax_tree()
    flat = flatten(tree)
    missing = dict(flat)
    missing.pop("generator.bias")
    with pytest.raises(KeyError, match="generator.bias"):
        params_from_jax(missing, cfg)
    with pytest.raises(KeyError, match="stray"):
        params_from_jax({**flat, "stray.kernel": np.zeros(2)}, cfg)
    bad = dict(flat)
    bad["generator.bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="generator.bias"):
        params_from_jax(bad, cfg)
