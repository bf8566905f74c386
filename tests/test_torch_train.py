"""PyTorch port: the training path against the JAX package on a tiny
vmmt_c (Pallas kernels in interpret mode): loss and every parameter
gradient, the fused generator CE, the KL schedule, the optimizer against
optax, batching of the target side, and the Trainer's device rule.
f32 throughout. Tolerances: loss 1e-5 relative; each gradient 1e-4
relative plus 1e-5 of its largest entry (sums over the batch and time in
another order); fused CE and optimizer 1e-5 relative and 1e-6 absolute."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from variational_mmt_tpu.config import Config as JaxConfig
from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.config import TrainConfig as JaxTrainConfig
from variational_mmt_tpu.data.dataset import BinarizedDataset as JaxBinarizedDataset
from variational_mmt_tpu.data.dataset import BucketIterator as JaxBucketIterator
from variational_mmt_tpu.models import latent as jax_latent
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.models.model import generator_params as jax_generator_params
from variational_mmt_tpu.models.model import init_params as jax_init_params
from variational_mmt_tpu.ops.fused_ce import fused_generator_ce as jax_fused_ce
from variational_mmt_tpu.train.loss import compute_loss as jax_compute_loss
from variational_mmt_tpu.train.loss import kl_beta as jax_kl_beta
from variational_mmt_tpu.train.optim import PlateauScheduler as JaxPlateauScheduler
from variational_mmt_tpu.train.optim import make_optimizer as jax_make_optimizer
from variational_mmt_torch.config import Config, ModelConfig, TrainConfig
from variational_mmt_torch.convert import flatten, grads_to_jax, params_from_jax
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.models import latent
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.ops.fused_ce import fused_generator_ce
from variational_mmt_torch.train.loss import kl_beta
from variational_mmt_torch.train.optim import Optimizer, PlateauScheduler
from variational_mmt_torch.train.trainer import Trainer, batch_tensors, loss_and_grads

TINY = dict(model_type="vmmt_c", src_vocab_size=24, tgt_vocab_size=24, emb_dim=16,
            hidden_dim=16, latent_dim=4, img_feat_dim=6, compute_dtype="float32",
            dropout=0.3, word_dropout=0.1)
KERNEL_ROUTE = dict(use_pallas=True, pallas_decoder=True, fused_ce=True)
TRAIN = dict(label_smoothing=0.1, kl_anneal_steps=10)


def corpus(n=8, seed=0):
    rng = np.random.default_rng(seed)
    src = [rng.integers(4, 24, rng.integers(2, 9)).astype(np.int32) for _ in range(n)]
    tgt = [rng.integers(4, 24, rng.integers(2, 8)).astype(np.int32) for _ in range(n)]
    img = rng.standard_normal((n, TINY["img_feat_dim"])).astype(np.float32)
    return src, tgt, img


def perturbed_jax_params(cfg, seed=0):
    tree = jax.device_get(jax_init_params(jax_build_model(cfg), jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


@pytest.mark.parametrize("route", ["kernels", "plain"])
def test_training_loss_and_every_gradient_match_jax(route):
    check_loss_and_every_gradient(KERNEL_ROUTE if route == "kernels" else {})


@pytest.mark.parametrize("dec_layers", [1, 3])
def test_kernel_route_takes_the_plain_loop_for_other_decoder_depths(dec_layers):
    """The decoder sequence kernels compute a 2-layer decoder only: at any
    other depth the kernel route runs the plain loop, as JAX's ``eligible``
    test sends it to its plain scan, and loss and gradients still match."""
    check_loss_and_every_gradient(dict(KERNEL_ROUTE, dec_layers=dec_layers))


def check_loss_and_every_gradient(over):
    jcfg = JaxModelConfig(**TINY, **over)
    tree = perturbed_jax_params(jcfg)
    src, tgt, img = corpus()
    batch = next(BucketIterator(BinarizedDataset(src, tgt), 6, [10], img_feats=img).epoch())
    step = 7

    jmodel = jax_build_model(jcfg)
    jtcfg = JaxTrainConfig(**TRAIN)

    def jax_loss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(batch.src), jnp.asarray(batch.tgt_in),
                           jnp.asarray(batch.img), deterministic=True, sample=False,
                           tgt_out=jnp.asarray(batch.tgt_out))
        gen = jax_generator_params(params, jcfg) if jcfg.fused_ce else None
        return jax_compute_loss(out, jnp.asarray(batch.tgt_out), jnp.asarray(batch.example_mask),
                                jnp.asarray(batch.img), jcfg, jtcfg, jnp.int32(step),
                                generator_params=gen)[0]

    want_loss, want_grads = jax.value_and_grad(jax_loss)(tree)

    cfg = Config(model=ModelConfig(**TINY, **over), train=TrainConfig(**TRAIN))
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg.model))
    loss, metrics, _ = loss_and_grads(cfg, model, batch_tensors(batch, torch.device("cpu")),
                                      step, None, deterministic=True, sample=False)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    assert float(metrics["beta"]) == pytest.approx(0.7)
    got = flatten(grads_to_jax(model))
    want = flatten(jax.device_get(want_grads))
    assert set(got) == set(want)
    for name in sorted(want):
        w = np.asarray(want[name])
        np.testing.assert_allclose(got[name], w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_fused_generator_ce_matches_jax(eps):
    rng = np.random.default_rng(1)
    N, H, V = 11, 6, 9
    x = rng.standard_normal((N, H)).astype(np.float32)
    W = rng.standard_normal((H, V)).astype(np.float32)
    b = (0.1 * rng.standard_normal(V)).astype(np.float32)
    tgt = rng.integers(0, V, N).astype(np.int32)
    mask = (rng.random(N) > 0.2).astype(np.float32)
    g1, g2 = rng.standard_normal(N).astype(np.float32), rng.standard_normal(N).astype(np.float32)

    def jfn(x_, W_, b_, m_):
        nll, raw, nc = jax_fused_ce(x_, W_, b_, jnp.asarray(tgt), m_, eps, 4)
        return (nll * g1).sum() + (raw * g2).sum(), (nll, raw, nc)

    (_, (nll, raw, nc)), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x), jnp.asarray(W), jnp.asarray(b), jnp.asarray(mask))

    t = [torch.from_numpy(a).requires_grad_(True) for a in (x, W, b, mask)]
    t_nll, t_raw, t_nc = fused_generator_ce(t[0], t[1], t[2], torch.from_numpy(tgt), t[3], eps,
                                            chunk=4)
    ((t_nll * torch.from_numpy(g1)).sum() + (t_raw * torch.from_numpy(g2)).sum()).backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_nll.detach().numpy(), np.asarray(nll), **tol)
    np.testing.assert_allclose(t_raw.detach().numpy(), np.asarray(raw), **tol)
    assert float(t_nc) == float(nc)
    for g, w in zip(t, jgrads):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("free_bits", [0.0, 2.0])
def test_latent_math_matches_jax(free_bits):
    """KL with and without a prior, the free-bits floor, the Gaussian
    log-density and the reparameterization with injected noise."""
    rng = np.random.default_rng(6)
    mu_q, mu_p, x, eps = (rng.standard_normal((5, 4)).astype(np.float32) for _ in range(4))
    sq, sp = (np.exp(0.5 * rng.standard_normal((5, 4))).astype(np.float32) for _ in range(2))
    t = {k: torch.from_numpy(v) for k, v in dict(mu_q=mu_q, mu_p=mu_p, x=x, sq=sq, sp=sp).items()}
    tol = dict(rtol=1e-6, atol=1e-6)
    for args in ((), ("mu_p", "sp")):
        want = jax_latent.kl_free_bits(
            jax_latent.gaussian_kl(mu_q, sq, *(dict(mu_p=mu_p, sp=sp)[a] for a in args)),
            free_bits, 4)
        got = latent.kl_free_bits(latent.gaussian_kl(t["mu_q"], t["sq"], *(t[a] for a in args)),
                                  free_bits, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(latent.gaussian_log_prob(t["x"], t["mu_q"], t["sq"]).numpy(),
                               np.asarray(jax_latent.gaussian_log_prob(x, mu_q, sq)), **tol)
    z = latent.reparameterize(t["mu_q"], t["sq"], eps=torch.from_numpy(eps))
    np.testing.assert_allclose(z.numpy(), mu_q + sq * eps, **tol)


@pytest.mark.parametrize("kind", ["linear", "sigmoid", "none"])
def test_kl_beta_matches_jax(kind):
    over = dict(kl_anneal=kind, kl_anneal_steps=10, kl_anneal_start=2)
    for step in (0, 2, 5, 7, 12, 30):
        want = float(jax_kl_beta(jnp.int32(step), JaxTrainConfig(**over)))
        assert kl_beta(step, TrainConfig(**over)) == pytest.approx(want, rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("optimizer", ["adam", "sgd", "adadelta", "adagrad"])
def test_optimizer_matches_optax_over_three_steps(optimizer):
    """Clipping (the second step's gradients exceed max_grad_norm) and the
    update rule, with the lr applied outside, as the JAX train step does."""
    over = dict(optimizer=optimizer, max_grad_norm=5.0, learning_rate=0.01)
    rng = np.random.default_rng(2)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    grads = [[(scale * rng.standard_normal(p.shape)).astype(np.float32) for p in params]
             for scale in (0.5, 4.0, 1.0)]
    tx = jax_make_optimizer(JaxTrainConfig(**over))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    opt = Optimizer(TrainConfig(**over))
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = opt.init(tp)
    for g in grads:
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = [p - jnp.float32(0.01) * u for p, u in zip(jp, updates)]
        tupdates, tstate = opt.update([torch.from_numpy(a) for a in g], tstate)
        tp = [p - 0.01 * u for p, u in zip(tp, tupdates)]
    for g, w in zip(tp, jp):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("start_decay_at", [0, 3])
def test_plateau_scheduler_matches_jax(start_decay_at):
    over = dict(start_decay_at=start_decay_at, lr_decay=0.5)
    ours, theirs = PlateauScheduler(TrainConfig(**over)), JaxPlateauScheduler(JaxTrainConfig(**over))
    lr = want = 1.0
    for step, ppl in enumerate([9.0, 8.0, 8.5, 7.0, 7.5, 6.0], start=1):
        lr, want = ours.update(ppl, step, lr), theirs.update(ppl, step, want)
        assert lr == want


@pytest.mark.parametrize("shuffle", [False, True])
def test_bucket_iterator_matches_jax(shuffle):
    src, tgt, img = corpus(n=11, seed=3)
    kw = dict(batch_size=4, buckets=[5, 10], img_feats=img, shuffle=shuffle, seed=3)
    jit = JaxBucketIterator(JaxBinarizedDataset(src, tgt), use_native=False, **kw)
    it = BucketIterator(BinarizedDataset(src, tgt), **kw)
    for epoch in (0, 1):
        want = list(jit.epoch(epoch))
        got = list(it.epoch(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for field in ("src", "tgt_in", "tgt_out", "indices", "example_mask", "img"):
                np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
            assert g.n_tokens == w.n_tokens


def tiny_trainer(device="cpu", **train_over):
    src, tgt, img = corpus(n=8, seed=4)
    cfg = Config(model=ModelConfig(**TINY, **KERNEL_ROUTE),
                 train=TrainConfig(**{**TRAIN, "seed": 5, **train_over}))
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(
        perturbed_jax_params(JaxModelConfig(**TINY, **KERNEL_ROUTE)), cfg.model))
    it = BucketIterator(BinarizedDataset(src, tgt), 4, [10], img_feats=img, shuffle=True)
    return Trainer(cfg, model, it, device=device)


def test_trainer_takes_finite_steps_on_the_cpu():
    trainer = tiny_trainer()
    before = [p.detach().clone() for p in trainer.model.parameters()]
    hist = trainer.train(3)
    assert len(hist) == 3 and trainer.state.step == 3
    for h in hist:
        assert all(np.isfinite(v) for v in h.values())
        assert h["grad_norm"] > 0
    moved = [not torch.equal(a, b) for a, b in zip(before, trainer.model.parameters())]
    assert all(moved)


def test_trainer_needs_cuda_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tiny_trainer(device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tiny_trainer(device="cuda")


@pytest.mark.parametrize("over", [dict(num_model_shards=2)],
                         ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_unsupported_train_options_raise(over):
    """Model sharding, once refused, now needs a mesh of that many model
    ranks (tests/test_torch_parallel.py): without one the Trainer raises.
    The other options are held step by step against JAX in
    tests/test_torch_train_options.py."""
    with pytest.raises(ValueError, match="need a mesh"):
        tiny_trainer(**over)


def test_fused_decoder_raises():
    """Once a refusal (``fused_decoder`` was not ported), kept under its
    name: the fused route now matches JAX's ``fused_decoder=True`` in the
    loss and every gradient, and a Trainer takes finite steps on it with
    dropout (tests/test_torch_fused_decoder.py holds the function itself
    to JAX's custom VJP)."""
    check_loss_and_every_gradient(dict(fused_decoder=True))
    src, tgt, img = corpus(n=8, seed=4)
    cfg = Config(model=ModelConfig(**TINY, fused_decoder=True), train=TrainConfig(**TRAIN))
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(perturbed_jax_params(JaxModelConfig(**TINY)),
                                          cfg.model))
    it = BucketIterator(BinarizedDataset(src, tgt), 4, [10], img_feats=img, shuffle=True)
    hist = Trainer(cfg, model, it, device="cpu").train(2)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)


def test_config_reads_the_train_section():
    path = "variational_mmt_torch/configs/vmmt_c_multi30k.json"
    with open(path) as f:
        text = f.read()
    got = Config.from_json(text).train
    want = dataclasses.asdict(JaxConfig.from_json(text).train)
    # every field of JAX's train section, the loop's and the mesh's too,
    # reads as in JAX
    assert dataclasses.asdict(got) == want
    assert (got.batch_size, got.valid_every, got.checkpoint_every) == (64, 500, 1000)
    assert json.loads(text)["train"]["steps_per_call"] == got.steps_per_call == 8
    got.check_supported()  # steps_per_call is ignored, not refused
