"""PyTorch port: the combinations of model options that JAX's
tests/test_options_matrix.py builds (cells x attention x input feed, and
conv features under either pool), each one not already held by
tests/test_torch_options_model.py's single options: the deterministic
forward's logits, alignments, latent means and image target against the
JAX package at 1e-5, f32, on the port's kernel route (the kernels' plain
versions on the CPU), a tiny vmmt_c with JAX weights plus noise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.train.trainer import batch_tensors
from test_torch_options_model import TINY, corpus, jax_tree, port_model

# the single options (GRU, general, input feed, pool5 but one) are held by
# tests/test_torch_options_model.py, the base by tests/test_torch_families.py
SINGLE = ({"rnn_type": "gru", "attn_type": "general", "input_feed": True},
          {"rnn_type": "gru", "attn_type": "dot", "input_feed": True},
          {"rnn_type": "gru", "attn_type": "mlp", "input_feed": True},
          {"rnn_type": "gru", "attn_type": "general", "input_feed": False},
          {"rnn_type": "lstm", "attn_type": "general", "input_feed": True})
MATRIX = [m for m in (dict(rnn_type=r, attn_type=a, input_feed=f) for r in ("gru", "lstm")
                      for a in ("general", "dot", "mlp") for f in (True, False))
          if m not in SINGLE] + [
    dict(img_feat_type="conv", img_pool="mean"),
    dict(img_feat_type="conv", img_pool="mean", rnn_type="lstm"),
    dict(img_feat_type="conv", img_pool="attn", rnn_type="lstm")]


@pytest.mark.parametrize("over", MATRIX, ids=lambda d: ",".join(map(str, d.values())))
def test_option_matrix_forward_matches_jax(over):
    """Every combination of JAX's tests/test_options_matrix.py (cells x
    attention x input feed, and conv features under either pool): the
    deterministic forward's logits, alignments and latent means at 1e-5,
    on the port's kernel route (the kernels' plain versions on the CPU)."""
    kw = {**TINY, **over, "enc_layers": 1}
    tree = jax_tree(kw, seed=3)
    src, tgt, img = corpus(kw, n=4, seed=3)
    batch = next(BucketIterator(BinarizedDataset(src, tgt), 4, [10], img_feats=img).epoch())
    want = jax_build_model(JaxModelConfig(**kw)).apply(
        {"params": tree}, jnp.asarray(batch.src), jnp.asarray(batch.tgt_in),
        jnp.asarray(batch.img), deterministic=True, sample=False,
        tgt_out=jnp.asarray(batch.tgt_out))
    model = port_model({**kw, "use_pallas": True, "pallas_decoder": True}, tree)
    t = batch_tensors(batch, torch.device("cpu"))
    with torch.no_grad():
        got = model(t["src"], t["tgt_in"], t["img"], sample=False, tgt_out=t["tgt_out"])
    for key in ("logits", "aligns", "mu_q", "mu_p", "img_target"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
