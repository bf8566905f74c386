"""PyTorch port: the training options against the JAX package, step by step.

Each option runs a few optimizer steps through JAX's ``make_train_step``
and the port's on a tiny ``nmt`` model with dropout and word dropout 0,
where JAX's step draws no noise, from the same parameters and batches:
loss, every parameter, the optimizer state (in the checkpoint layout,
train/checkpoint.py) and the EMA must agree after each step. Then
``param_init`` by range and distribution, and ``Trainer.validate`` against
JAX's on vmmt_c. f32 throughout. Tolerances: loss 1e-5 relative; params,
EMA and optimizer state 2e-5 relative plus 1e-6 + 1e-4 x lr absolute. The
two frameworks sum gradients in another order, and the optimizers divide a
gradient by its own scale: where a gradient is near 0, adagrad's
1/sqrt(g^2 + 1e-7) multiplies its rounding error by up to 3e3 (one such
entry moved 4.3e-6 at lr 0.1), which the lr term covers. Adagrad runs at
lr 0.01: at its CLI default of 0.1 every step moves this 16-wide model so
far that the gap grows threefold a step (4.3e-6, 1.5e-5, 4.3e-5), while at
0.01 it stays at 4.3e-7. Validation metrics 1e-5 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from variational_mmt_tpu.config import Config as JaxConfig
from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.config import TrainConfig as JaxTrainConfig
from variational_mmt_tpu.data.dataset import BinarizedDataset as JaxBinarizedDataset
from variational_mmt_tpu.data.dataset import BucketIterator as JaxBucketIterator
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.parallel.mesh import make_mesh
from variational_mmt_tpu.train.trainer import Trainer as JaxTrainer
from variational_mmt_tpu.train.trainer import create_train_state as jax_create_train_state
from variational_mmt_tpu.train.trainer import make_train_step as jax_make_train_step
from variational_mmt_torch.config import Config, ModelConfig, TrainConfig
from variational_mmt_torch.convert import flatten, params_from_jax
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.train.checkpoint import state_tree
from variational_mmt_torch.train.trainer import (Trainer, batch_tensors, create_train_state,
                                                 make_train_step)

NMT = dict(model_type="nmt", src_vocab_size=24, tgt_vocab_size=24, emb_dim=16, hidden_dim=16,
           compute_dtype="float32", dropout=0.0, word_dropout=0.0, img_feat_dim=0,
           use_img_predict=False)
STEPS = 3
RTOL = 2e-5


def dataset(n, seed=0):
    rng = np.random.default_rng(seed)
    src = [rng.integers(4, 24, rng.integers(2, 9)).astype(np.int32) for _ in range(n)]
    tgt = [rng.integers(4, 24, rng.integers(2, 8)).astype(np.int32) for _ in range(n)]
    return BinarizedDataset(src, tgt)


def batches(n=STEPS, batch_size=4):
    return list(BucketIterator(dataset(batch_size * n), batch_size, [10]).epoch())


def jax_batch(b, poison=False):
    mask = np.asarray(b.example_mask, np.float32).copy()
    if poison:
        mask[0] = np.inf  # the loss, and every gradient, become non-finite
    return {"src": jnp.asarray(b.src), "tgt_in": jnp.asarray(b.tgt_in),
            "tgt_out": jnp.asarray(b.tgt_out), "example_mask": jnp.asarray(mask)}


def torch_batch(b, poison=False):
    out = batch_tensors(b, torch.device("cpu"))
    if poison:
        out["example_mask"][0] = float("inf")
    return out


def tree_of(x):
    return flatten(jax.tree.map(np.asarray, x))


def assert_trees_close(got, want, what, lr):
    got, want = flatten(got), flatten(want)
    assert set(got) == set(want), what
    for name in sorted(want):
        np.testing.assert_allclose(np.asarray(got[name], np.float64),
                                   np.asarray(want[name], np.float64), rtol=RTOL,
                                   atol=1e-6 + 1e-4 * lr, err_msg=f"{what}: {name}")


def run_both(model_over=None, train_over=None, poison_step=None):
    """STEPS steps of both packages from JAX's initial parameters; asserts
    agreement after each. Returns the two final states."""
    model_over, train_over = model_over or {}, train_over or {}
    jcfg = JaxConfig(model=JaxModelConfig(**{**NMT, **model_over}),
                     train=JaxTrainConfig(**train_over))
    jmodel = jax_build_model(jcfg.model)
    jstate = jax_create_train_state(jcfg, jmodel)
    jstep = jax_make_train_step(jcfg, jmodel)
    cfg = Config(model=ModelConfig(**{**NMT, **model_over}), train=TrainConfig(**train_over))
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(jstate.params), cfg.model))
    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    for i, b in enumerate(batches()):
        bad = i == poison_step
        jstate, jm = jstep(jstate, jax_batch(b, bad))
        state, m = step(state, torch_batch(b, bad), state.generator)
        assert float(m["skipped_sum"]) == float(jm["skipped_sum"])
        if not bad:
            np.testing.assert_allclose(float(m["loss"].detach()), float(jm["loss"]), rtol=1e-5)
        assert state.step == int(jstate.step)
        tree = state_tree(state, cfg)
        lr = cfg.train.learning_rate
        assert_trees_close(tree["params"], tree_of(jstate.params), f"params after step {i}", lr)
        assert_trees_close(tree["opt_state"],
                           tree_of(serialization.to_state_dict(jstate.opt_state)),
                           f"opt_state after step {i}", lr)
        assert ("ema_params" in tree) == (jstate.ema_params is not None)
        if "ema_params" in tree:
            assert_trees_close(tree["ema_params"], tree_of(jstate.ema_params),
                               f"EMA after step {i}", lr)
    return jstate, state


@pytest.mark.parametrize("over", [
    dict(grad_accum=2), dict(ema_decay=0.9), dict(ema_decay=0.9, ema_ramp=False),
    dict(optimizer="adadelta", learning_rate=1.0), dict(optimizer="adagrad", learning_rate=0.01),
    dict(optimizer="adam", max_grad_norm=0.0), dict(optimizer="sgd", learning_rate=0.1),
], ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_training_option_matches_jax_step_by_step(over):
    run_both(train_over=over)


@pytest.mark.parametrize("model_over,train_over,frozen", [
    ({}, dict(fix_word_vecs_enc=True), ["src_embed.embedding"]),
    ({}, dict(fix_word_vecs_dec=True), ["tgt_embed.embedding"]),
    (dict(share_embeddings=True), {}, []),
    (dict(share_embeddings=True), dict(fix_word_vecs_enc=True), ["tgt_embed.embedding"]),
], ids=["fix_enc", "fix_dec", "shared", "shared_fix_enc"])
def test_frozen_and_shared_tables_match_jax(model_over, train_over, frozen):
    """Frozen tables keep their values through every step (gradients and
    final updates zeroed); one shared table freezes with either flag."""
    jstate0 = jax_create_train_state(
        JaxConfig(model=JaxModelConfig(**{**NMT, **model_over})),
        jax_build_model(JaxModelConfig(**{**NMT, **model_over})))
    _, state = run_both(model_over, train_over)
    start = tree_of(jstate0.params)
    for name, p in state.model.named_parameters():
        if name in frozen:
            np.testing.assert_array_equal(p.detach().numpy(), start[name])
        else:
            assert not np.array_equal(p.detach().numpy(), start[name]), name
    assert hasattr(state.model, "src_embed") != bool(model_over.get("share_embeddings"))


@pytest.mark.parametrize("ema_decay", [0.0, 0.9])
def test_skip_nonfinite_matches_jax_on_a_poisoned_batch(ema_decay):
    """The second of three batches is non-finite: both packages keep
    params, optimizer state and EMA, count the skip and go on."""
    run_both(train_over=dict(skip_nonfinite=True, ema_decay=ema_decay), poison_step=1)


def test_without_skip_nonfinite_a_poisoned_batch_poisons_the_params():
    cfg = Config(model=ModelConfig(**NMT))
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(jax_create_train_state(
        JaxConfig(model=JaxModelConfig(**NMT)), jax_build_model(JaxModelConfig(**NMT))).params),
        cfg.model))
    state = create_train_state(cfg, model)
    state, m = make_train_step(cfg)(state, torch_batch(batches()[0], True), state.generator)
    assert float(m["skipped_sum"]) == 0.0
    assert not all(torch.isfinite(p).all() for p in state.model.parameters())


def test_grad_accum_needs_a_divisible_batch():
    cfg = Config(model=ModelConfig(**NMT), train=TrainConfig(grad_accum=3, batch_size=4))
    with pytest.raises(ValueError, match="grad_accum"):
        Trainer(cfg, build_model(cfg.model, device="cpu"), batches(), device="cpu")
    cfg = Config(model=ModelConfig(**NMT), train=TrainConfig(grad_accum=3, batch_size=6))
    model = build_model(cfg.model, device="cpu")
    state = create_train_state(cfg, model)
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(cfg)(state, torch_batch(batches()[0]), state.generator)


@pytest.mark.parametrize("r", [0.1, 0.05])
def test_param_init_draws_every_tensor_uniform_in_range(r):
    """By range and distribution (the draws are the port's own): every
    tensor inside [-r, r], the pooled values' quantiles those of U(-r, r)
    within 0.02 r, as JAX's own draws are."""
    over = dict(NMT, emb_dim=32, hidden_dim=32)
    cfg = Config(model=ModelConfig(**over), train=TrainConfig(param_init=r))
    model = build_model(cfg.model, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(7.0)
    create_train_state(cfg, model)
    jstate = jax_create_train_state(JaxConfig(model=JaxModelConfig(**over),
                                              train=JaxTrainConfig(param_init=r)),
                                    jax_build_model(JaxModelConfig(**over)))
    q = np.linspace(0.05, 0.95, 19)
    for values in ([p.detach().numpy().ravel() for p in model.parameters()],
                   [np.asarray(x).ravel() for x in jax.tree.leaves(jstate.params)]):
        assert all(np.abs(v).max() <= r and len(np.unique(v)) > 1 for v in values)
        pooled = np.concatenate(values)
        np.testing.assert_allclose(np.quantile(pooled, q), -r + 2 * r * q, atol=0.02 * r)
    # a second stream, not the training generator's: the same seed gives the
    # same draws, and the training stream starts where it would without it
    again = build_model(cfg.model, device="cpu")
    state = create_train_state(cfg, again)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    plain = torch.Generator().manual_seed(cfg.train.seed)
    assert torch.equal(state.generator.get_state(), plain.get_state())


VMMT = dict(model_type="vmmt_c", src_vocab_size=24, tgt_vocab_size=24, emb_dim=16,
            hidden_dim=16, latent_dim=4, img_feat_dim=6, compute_dtype="float32")


@pytest.mark.parametrize("feats_on_device", [False, True])
def test_validate_matches_jax(feats_on_device):
    """Trainer.validate (deterministic, z = the posterior mean) against
    JAX's on vmmt_c, with the image rows in the batches or gathered from
    the validation table on the device."""
    rng = np.random.default_rng(3)
    n = 21
    src = [rng.integers(4, 24, rng.integers(2, 9)).astype(np.int32) for _ in range(n)]
    tgt = [rng.integers(4, 24, rng.integers(2, 8)).astype(np.int32) for _ in range(n)]
    img = rng.standard_normal((n, 6)).astype(np.float32)
    jcfg = JaxConfig(model=JaxModelConfig(**VMMT), train=JaxTrainConfig(batch_size=8))
    jmodel = jax_build_model(jcfg.model)
    jvalid = JaxBucketIterator(JaxBinarizedDataset(src, tgt), 8, [5, 10], img_feats=img,
                               shuffle=False, use_native=False)
    jtrainer = JaxTrainer(jcfg, jmodel, jvalid, jvalid, mesh=make_mesh())
    jstate = jax_create_train_state(jcfg, jmodel)
    want = jtrainer.validate(jstate)

    cfg = Config(model=ModelConfig(**VMMT), train=TrainConfig(batch_size=8))
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(jstate.params), cfg.model))
    valid = BucketIterator(BinarizedDataset(src, tgt), 8, [5, 10],
                           img_feats=None if feats_on_device else img)
    trainer = Trainer(cfg, model, valid, valid, device="cpu",
                      valid_feats=img if feats_on_device else None)
    got = trainer.validate()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_train_from_runs_triggers_on_crossings_and_reads_metrics_at_reports(capsys):
    """Report, validation (plateau decay) and checkpoint triggers fire when
    the step count crosses their interval, from a resumed step too."""
    cfg = Config(model=ModelConfig(**NMT),
                 train=TrainConfig(report_every=2, valid_every=3, checkpoint_every=4,
                                   start_decay_at=1, lr_decay=0.5))
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(jax_create_train_state(
        JaxConfig(model=JaxModelConfig(**NMT)), jax_build_model(JaxModelConfig(**NMT))).params),
        cfg.model))
    saved = []
    it = BucketIterator(dataset(6), 2, [10])
    trainer = Trainer(cfg, model, it, it, device="cpu",
                      checkpoint_fn=lambda st, step, _: saved.append(step))
    trainer.state.step = 1  # as if resumed at step 1
    trainer.train_from(max_steps=9)
    assert saved == [4, 8]
    assert [h["step"] for h in trainer.history] == [3, 6, 9]
    # start_decay_at=1: every validation halves the lr (kept in float32)
    assert trainer.final_state.lr == float(np.float32(np.float32(4e-4) * 0.125))
    out = capsys.readouterr().out
    assert [line.split(";")[0] for line in out.splitlines() if line.startswith("step ")] == [
        "step 2/9", "step 4/9", "step 6/9", "step 8/9"]
    assert trainer.last_run["steps"] == 8 and len(trainer.last_run["metrics"]) == 8
