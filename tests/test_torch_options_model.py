"""PyTorch port: training the whole model under each option of ROADMAP.md
item 5.5 against the JAX package, on a tiny vmmt_c with
``z_cond='init+input'`` (JAX weights through ``convert.py`` plus noise),
f32 (decoding and the parameter trees: tests/test_torch_options_decode.py):

- one training step's loss and every parameter gradient against
  ``jax.grad`` of JAX's plain route, on the port's kernel route
  (use_pallas, pallas_decoder, fused_ce; the kernels' plain versions on the
  CPU) and its plain route: loss 1e-5 relative, each gradient 1e-4
  relative plus 1e-5 of its largest entry (tests/test_torch_train.py);
- the ``input_feed=False`` model with ``use_pallas`` on both sides (JAX's
  Pallas scans in interpret mode): the same, and the bridge's gradient is
  nonzero;
- the sequence-packed forward with ``input_feed=False`` (``packed_seq``
  with resets and per-segment init states) at the same tolerances;
- with conv features and ``img_pool='attn'``, the image target is a
  constant while the region pool learns through q and the prior.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.config import TrainConfig as JaxTrainConfig
from variational_mmt_tpu.models.model import VMMTModel as JaxVMMTModel
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.models.model import init_params as jax_init_params
from variational_mmt_tpu.train.loss import compute_loss as jax_compute_loss
from variational_mmt_torch.config import Config, ModelConfig, TrainConfig
from variational_mmt_torch.convert import flatten, grads_to_jax, params_from_jax
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.data.packing import PackedBucketIterator
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.train.trainer import batch_tensors, loss_and_grads

TINY = dict(model_type="vmmt_c", z_cond="init+input", src_vocab_size=24, tgt_vocab_size=24,
            emb_dim=16, hidden_dim=16, latent_dim=4, img_feat_dim=6, compute_dtype="float32",
            dropout=0.3, word_dropout=0.1)
OPTIONS = {
    "lstm": dict(rnn_type="lstm"),
    "dot": dict(attn_type="dot"),
    "mlp": dict(attn_type="mlp"),
    "no_input_feed": dict(input_feed=False),
    "conv_attn": dict(img_feat_type="conv", img_pool="attn"),
}
KERNEL_ROUTE = dict(use_pallas=True, pallas_decoder=True, fused_ce=True)
ROUTES = {"kernels": KERNEL_ROUTE, "plain": {}}
TRAIN = dict(label_smoothing=0.1, kl_anneal_steps=10)
STEP = 7  # KL beta 0.7
REGIONS = 3


def config(option, route="plain"):
    return {**TINY, **OPTIONS[option], **ROUTES[route]}


def images(kw, n, rng):
    shape = (n, REGIONS, 6) if kw.get("img_feat_type") == "conv" else (n, 6)
    return rng.standard_normal(shape).astype(np.float32)


def corpus(kw, n=9, seed=0, lo=2, hi=9):
    rng = np.random.default_rng(seed)
    src = [rng.integers(4, 24, rng.integers(lo, hi)).astype(np.int32) for _ in range(n)]
    tgt = [rng.integers(4, 24, rng.integers(lo, hi)).astype(np.int32) for _ in range(n)]
    return src, tgt, images(kw, n, rng)


def jax_tree(kw, seed=0, noise=0.1):
    tree = jax.device_get(jax_init_params(jax_build_model(JaxModelConfig(**kw)),
                                          jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + noise * rng.standard_normal(np.shape(a)))
                        .astype(np.float32), tree)


def port_model(kw, tree):
    cfg = ModelConfig(**kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    return model


def assert_loss_and_grads_match(kw, tree, want_loss, want_grads, batch, pack=False):
    cfg = Config(model=ModelConfig(**kw), train=TrainConfig(**TRAIN, pack=pack))
    model = port_model(kw, tree)
    loss, _, _ = loss_and_grads(cfg, model, batch_tensors(batch, torch.device("cpu")), STEP,
                                None, deterministic=True, sample=False)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = flatten(grads_to_jax(model))
    want = flatten(jax.device_get(want_grads))
    assert set(got) == set(want)
    for name in sorted(want):
        w = np.asarray(want[name])
        np.testing.assert_allclose(got[name], w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=name)
    return got


@functools.lru_cache(maxsize=None)
def jax_unpacked(option, use_pallas=False):
    """(tree, batch, loss, gradients) of JAX on one batch."""
    kw = {**config(option), "use_pallas": use_pallas}
    jcfg = JaxModelConfig(**kw)
    tree = jax_tree(kw)
    src, tgt, img = corpus(kw)
    batch = next(BucketIterator(BinarizedDataset(src, tgt), 6, [10], img_feats=img).epoch())
    jmodel = jax_build_model(jcfg)

    def jax_loss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(batch.src), jnp.asarray(batch.tgt_in),
                           jnp.asarray(batch.img), deterministic=True, sample=False,
                           tgt_out=jnp.asarray(batch.tgt_out))
        return jax_compute_loss(out, jnp.asarray(batch.tgt_out), jnp.asarray(batch.example_mask),
                                jnp.asarray(batch.img), jcfg, JaxTrainConfig(**TRAIN),
                                jnp.int32(STEP))[0]

    return (tree, batch) + tuple(jax.value_and_grad(jax_loss)(tree))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("option", OPTIONS)
def test_loss_and_every_gradient_match_jax(option, route):
    tree, batch, want_loss, want_grads = jax_unpacked(option)
    assert_loss_and_grads_match(config(option, route), tree, want_loss, want_grads, batch)


def test_no_input_feed_scan_kernels_and_bridge_gradient_match_jax_interpret():
    """Both sides on the scan kernels (JAX's Pallas in interpret mode, the
    port's plain versions): dh0 of every decoder layer reaches the bridge."""
    tree, batch, want_loss, want_grads = jax_unpacked("no_input_feed", use_pallas=True)
    kw = {**config("no_input_feed"), "use_pallas": True}
    got = assert_loss_and_grads_match(kw, tree, want_loss, want_grads, batch)
    for l in range(2):
        assert float(np.abs(got[f"bridge{l}.kernel"]).max()) > 0.0


@functools.lru_cache(maxsize=None)
def jax_packed_no_input_feed():
    kw = config("no_input_feed")
    jcfg = JaxModelConfig(**kw)
    tree = jax_tree(kw, seed=1)
    src, tgt, img = corpus(kw, seed=1)
    pb = next(iter(PackedBucketIterator(BinarizedDataset(src, tgt), 3, [16], img_feats=img,
                                        shuffle=False, max_segments=3).epoch()))
    assert pb.seg_mask.sum(1).max() >= 2
    B, K = pb.seg_mask.shape
    a = {f: jnp.asarray(getattr(pb, f)) for f in
         ("src", "tgt_in", "tgt_out", "src_seg", "tgt_seg", "seg_first", "seg_last", "seg_mask")}
    img_j = jnp.asarray(pb.img)
    jmodel = jax_build_model(jcfg)

    def jax_loss(params):
        out = jmodel.apply({"params": params}, a["src"], a["tgt_in"], a["src_seg"], a["tgt_seg"],
                           a["seg_first"], a["seg_last"], img_j, deterministic=True,
                           sample=False, tgt_out=a["tgt_out"],
                           method=JaxVMMTModel.forward_packed)
        return jax_compute_loss(out, a["tgt_out"], a["seg_mask"].reshape(-1),
                                img_j.reshape(B * K, -1), jcfg, JaxTrainConfig(**TRAIN),
                                jnp.int32(STEP), tgt_seg=a["tgt_seg"])[0]

    return (tree, pb) + tuple(jax.value_and_grad(jax_loss)(tree))


@pytest.mark.parametrize("route", ROUTES)
def test_packed_no_input_feed_matches_jax(route):
    tree, pb, want_loss, want_grads = jax_packed_no_input_feed()
    assert_loss_and_grads_match(config("no_input_feed", route), tree, want_loss, want_grads,
                                pb, pack=True)


def test_region_pool_target_is_constant_and_the_pool_learns_through_q_and_prior():
    kw = config("conv_attn")
    model = port_model(kw, jax_tree(kw))
    src, tgt, img = corpus(kw)
    batch = batch_tensors(next(BucketIterator(BinarizedDataset(src, tgt), 6, [10],
                                              img_feats=img).epoch()), torch.device("cpu"))
    out = model(batch["src"], batch["tgt_in"], batch["img"], sample=False,
                tgt_out=batch["tgt_out"])
    assert out["img_target"].shape == (6, 6) and not out["img_target"].requires_grad
    # the pooled target differs from the mean of the regions
    assert not torch.allclose(out["img_target"], batch["img"].mean(dim=1))
    assert out["img_target"].grad_fn is None
    for name in ("mu_q", "mu_p"):
        model.zero_grad()
        out[name].sum().backward(retain_graph=True)
        assert float(model.region_pool.key.kernel.grad.abs().max()) > 0.0, name
