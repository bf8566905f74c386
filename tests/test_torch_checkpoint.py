"""PyTorch port: checkpoints that both packages read.

- The msgpack codec (train/msgpack_io.py) against
  ``flax.serialization.msgpack_serialize`` and ``msgpack_restore``: the
  same bytes for the same tree, and the same tree back (hypothesis over
  f32, bf16, int32 and uint32 arrays, numpy scalars and chunked arrays).
- A port checkpoint loaded by JAX's ``load_checkpoint`` and translated by
  JAX's ``Translator``, and a JAX checkpoint loaded by the port, for every
  optimizer-state layout: params, optimizer state, EMA, step and lr equal
  bit for bit; n-best ids identical and scores within 1e-4 (f32 sums of
  up to ten log-probs, each within 1e-5).
- A loaded checkpoint equals the saved state bit for bit (generator state
  too), and one step from it equals one step from the live state, bit for
  bit on the CPU.
- Released checkpoints (optimizer stripped, bf16 params, EMA promoted) in
  both directions; retention; ``-use_ema``.
"""

import dataclasses
import os

import hypothesis.extra.numpy as hnp
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from variational_mmt_tpu.config import Config as JaxConfig
from variational_mmt_tpu.config import DecodeConfig as JaxDecodeConfig
from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.config import TrainConfig as JaxTrainConfig
from variational_mmt_tpu.data.vocab import SPECIALS as JAX_SPECIALS
from variational_mmt_tpu.data.vocab import Vocab as JaxVocab
from variational_mmt_tpu.decode.translator import Translator as JaxTranslator
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.train import checkpoint as jax_ck
from variational_mmt_tpu.train.trainer import create_train_state as jax_create_train_state
from variational_mmt_tpu.train.trainer import make_train_step as jax_make_train_step
from variational_mmt_torch.cli.loading import load_model_spec
from variational_mmt_torch.config import Config, DecodeConfig, ModelConfig, TrainConfig
from variational_mmt_torch.convert import flatten, params_from_jax
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.data.vocab import SPECIALS, Vocab
from variational_mmt_torch.decode.translator import Translator
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.train import checkpoint as ck
from variational_mmt_torch.train import msgpack_io
from variational_mmt_torch.train.trainer import Trainer, batch_tensors, make_train_step

TINY = dict(model_type="vmmt_c", src_vocab_size=24, tgt_vocab_size=24, emb_dim=16,
            hidden_dim=16, latent_dim=4, img_feat_dim=6, compute_dtype="float32",
            dropout=0.2, word_dropout=0.1)
WORDS = [f"w{i}" for i in range(20)]
SRC = [[5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15], [4, 20], [16, 17, 18, 19, 5]]
DECODE = dict(beam_size=3, n_best=3, max_length=10, batch_size=4)


# -- the codec -------------------------------------------------------------

def bf16_pair(bits: np.ndarray):
    """The same bf16 values as ml_dtypes (for flax) and torch (for the port)."""
    return (bits.view(ml_dtypes.bfloat16),
            torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16))


shapes = hnp.array_shapes(min_dims=0, max_dims=3, max_side=5)
leaf_kinds = st.sampled_from(["f32", "bf16", "i32", "u32", "sf32", "si32", "su32", "int",
                              "float", "str"])


@st.composite
def leaves(draw):
    kind = draw(leaf_kinds)
    if kind in ("f32", "i32", "u32"):
        dtype = {"f32": np.float32, "i32": np.int32, "u32": np.uint32}[kind]
        a = draw(hnp.arrays(dtype, shapes, elements=hnp.from_dtype(
            np.dtype(dtype), allow_nan=False) if kind == "f32" else None))
        return a, a
    if kind == "bf16":
        return bf16_pair(draw(hnp.arrays(np.uint16, shapes)))
    if kind in ("sf32", "si32", "su32"):
        dtype = {"sf32": np.float32, "si32": np.int32, "su32": np.uint32}[kind]
        a = draw(hnp.arrays(dtype, (), elements=hnp.from_dtype(
            np.dtype(dtype), allow_nan=False) if kind == "sf32" else None))[()]
        return a, a
    v = draw({"int": st.integers(-2**63, 2**64 - 1),
              "float": st.floats(allow_nan=False),
              "str": st.text(max_size=300)}[kind])
    return v, v


keys = st.text(min_size=1, max_size=12)


@st.composite
def trees(draw, depth=2):
    n = draw(st.integers(0, 18))
    flax_tree, ours = {}, {}
    for k in draw(st.lists(keys, min_size=n, max_size=n, unique=True)):
        if depth > 0 and draw(st.booleans()):
            a, b = draw(trees(depth=depth - 1))
        else:
            a, b = draw(leaves())
        flax_tree[k], ours[k] = a, b
    return flax_tree, ours


def assert_same_tree(got, want):
    assert type(got) is dict and set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_same_tree(g, w)
        elif isinstance(w, np.ndarray) and w.dtype == ml_dtypes.bfloat16:
            assert isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16
            assert tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
        elif isinstance(w, (np.ndarray, np.generic)):
            assert type(g) is type(w) and g.dtype == w.dtype and np.shape(g) == np.shape(w)
            np.testing.assert_array_equal(g, w)
        else:
            assert type(g) is type(w) and g == w


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(trees())
def test_codec_writes_and_reads_what_flax_does(pair):
    flax_tree, ours = pair
    blob = serialization.msgpack_serialize(flax_tree)
    assert msgpack_io.packb(ours) == blob
    assert_same_tree(msgpack_io.unpackb(blob), serialization.msgpack_restore(blob))


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 40), st.sampled_from(["f32", "bf16", "u32"]), st.integers(0, 2**16))
def test_codec_chunks_large_arrays_as_flax_does(n, kind, seed):
    """Arrays over MAX_CHUNK_SIZE bytes (shrunk here to 24) split into
    flax's ``__msgpack_chunked_array__`` form, at the top level and in
    dicts, and join back."""
    rng = np.random.default_rng(seed)
    if kind == "bf16":
        flax_arr, ours_arr = bf16_pair(rng.integers(0, 2**16, (n, 3)).astype(np.uint16))
    else:
        flax_arr = ours_arr = rng.integers(0, 2**32, (n, 3)).astype(
            np.uint32) if kind == "u32" else rng.standard_normal((n, 3)).astype(np.float32)
    saved = serialization.MAX_CHUNK_SIZE, msgpack_io.MAX_CHUNK_SIZE
    serialization.MAX_CHUNK_SIZE = msgpack_io.MAX_CHUNK_SIZE = 24
    try:
        for flax_tree, ours in (({"a": {"w": flax_arr}, "s": 1}, {"a": {"w": ours_arr}, "s": 1}),
                                (flax_arr, ours_arr)):
            blob = serialization.msgpack_serialize(flax_tree)
            assert msgpack_io.packb(ours) == blob
            got, want = msgpack_io.unpackb(blob), serialization.msgpack_restore(blob)
            if isinstance(want, dict):
                assert_same_tree(got, want)
            else:
                assert_same_tree({"x": got}, {"x": want})
    finally:
        serialization.MAX_CHUNK_SIZE, msgpack_io.MAX_CHUNK_SIZE = saved


def test_codec_refuses_what_flax_cannot_write():
    with pytest.raises(TypeError):
        msgpack_io.packb({"t": (1, 2)})
    with pytest.raises(ValueError):
        msgpack_io.unpackb(msgpack_io.packb({"a": 1}) + b"\x00")


# -- checkpoints across the packages ----------------------------------------

def corpus(n=8, seed=0):
    rng = np.random.default_rng(seed)
    src = [rng.integers(4, 24, rng.integers(2, 9)).astype(np.int32) for _ in range(n)]
    tgt = [rng.integers(4, 24, rng.integers(2, 8)).astype(np.int32) for _ in range(n)]
    img = rng.standard_normal((n, TINY["img_feat_dim"])).astype(np.float32)
    return src, tgt, img


def port_trainer(model_over=None, train_over=None, steps=2):
    """A port Trainer on the tiny vmmt_c after ``steps`` steps."""
    src, tgt, img = corpus()
    cfg = Config(model=ModelConfig(**{**TINY, **(model_over or {})}),
                 train=TrainConfig(**{"ema_decay": 0.9, "report_every": 0, **(train_over or {})}))
    jstate = jax_create_train_state(JaxConfig(model=JaxModelConfig(**dataclasses.asdict(
        cfg.model))), jax_build_model(JaxModelConfig(**dataclasses.asdict(cfg.model))))
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(jstate.params), cfg.model))
    it = BucketIterator(BinarizedDataset(src, tgt), 4, [10], img_feats=img, shuffle=True)
    trainer = Trainer(cfg, model, it, device="cpu")
    trainer.train(steps)
    return trainer


def vocab():
    return Vocab(SPECIALS + WORDS)


def tree(x):
    return flatten(jax.tree.map(np.asarray, x))


def assert_bitwise(got: dict, want: dict, what: str):
    got, want = flatten(got), flatten(want)
    assert set(got) == set(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: {k}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")


def port_nbest(model, img, **over):
    tr = Translator(model, vocab(), vocab(), DecodeConfig(**{**DECODE, **over}), buckets=[8],
                    device="cpu")
    return tr.translate_ids(SRC, img)


def jax_nbest(jmodel, params, img):
    v = JaxVocab(JAX_SPECIALS + WORDS)
    return JaxTranslator(jmodel, params, v, v, JaxDecodeConfig(**DECODE),
                         buckets=[8]).translate_ids(SRC, img)


def assert_same_nbest(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [ids for _, ids in g] == [ids for _, ids in w]
        np.testing.assert_allclose([s for s, _ in g], [s for s, _ in w], rtol=1e-4, atol=1e-4)


LAYOUTS = [("adam", 5.0), ("adam", 0.0), ("sgd", 5.0), ("sgd", 0.0), ("adadelta", 5.0),
           ("adagrad", 5.0)]


@pytest.mark.parametrize("optimizer,max_grad_norm", LAYOUTS)
def test_port_checkpoint_loads_in_jax(tmp_path, optimizer, max_grad_norm):
    trainer = port_trainer(train_over=dict(optimizer=optimizer, max_grad_norm=max_grad_norm))
    path = ck.save_checkpoint(str(tmp_path), trainer.state, trainer.cfg, vocab(), vocab())
    jstate, jcfg, jmodel, sv, tv = jax_ck.load_checkpoint(path)
    want = ck.state_tree(trainer.state, trainer.cfg)
    assert_bitwise(tree(jstate.params), want["params"], "params")
    assert_bitwise(tree(serialization.to_state_dict(jstate.opt_state)), want["opt_state"],
                   "opt_state")
    assert_bitwise(tree(jstate.ema_params), want["ema_params"], "ema")
    assert int(jstate.step) == trainer.state.step == 2
    assert np.float32(jstate.lr) == np.float32(trainer.state.lr)
    np.testing.assert_array_equal(np.asarray(jstate.rng), np.asarray(jax.random.PRNGKey(1234)))
    assert jcfg.to_dict() == trainer.cfg.to_dict() and sv.itos == vocab().itos
    # and a JAX step from it runs
    src, tgt, img = corpus()
    b = next(BucketIterator(BinarizedDataset(src, tgt), 4, [10], img_feats=img).epoch())
    jstate, m = jax_make_train_step(jcfg, jmodel)(jstate, {
        "src": jnp.asarray(b.src), "tgt_in": jnp.asarray(b.tgt_in),
        "tgt_out": jnp.asarray(b.tgt_out), "example_mask": jnp.asarray(b.example_mask),
        "img": jnp.asarray(b.img)})
    assert int(jstate.step) == 3 and np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("optimizer,max_grad_norm", LAYOUTS)
def test_jax_checkpoint_loads_in_the_port(tmp_path, optimizer, max_grad_norm):
    jcfg = JaxConfig(model=JaxModelConfig(**TINY),
                     train=JaxTrainConfig(optimizer=optimizer, max_grad_norm=max_grad_norm,
                                          ema_decay=0.9))
    jmodel = jax_build_model(jcfg.model)
    jstate = jax_create_train_state(jcfg, jmodel)
    src, tgt, img = corpus()
    b = next(BucketIterator(BinarizedDataset(src, tgt), 4, [10], img_feats=img).epoch())
    jstate, _ = jax_make_train_step(jcfg, jmodel)(jstate, {
        "src": jnp.asarray(b.src), "tgt_in": jnp.asarray(b.tgt_in),
        "tgt_out": jnp.asarray(b.tgt_out), "example_mask": jnp.asarray(b.example_mask),
        "img": jnp.asarray(b.img)})
    v = JaxVocab(JAX_SPECIALS + WORDS)
    path = jax_ck.save_checkpoint(str(tmp_path), jstate, jcfg, v, v)
    state, cfg, model, sv, tv = ck.load_checkpoint(path, device="cpu")
    got = ck.state_tree(state, cfg)
    assert_bitwise(got["params"], tree(jstate.params), "params")
    assert_bitwise(got["opt_state"], tree(serialization.to_state_dict(jstate.opt_state)),
                   "opt_state")
    assert_bitwise(got["ema_params"], tree(jstate.ema_params), "ema")
    assert state.step == 1 and np.float32(state.lr) == np.float32(jstate.lr)
    # no generator state in a JAX checkpoint: the port seeds one from train.seed
    assert torch.equal(state.generator.get_state(),
                       torch.Generator().manual_seed(cfg.train.seed).get_state())
    # and it trains on in the port
    step = make_train_step(cfg)
    state, m = step(state, batch_tensors(b, torch.device("cpu")), state.generator)
    assert state.step == 2 and np.isfinite(float(m["loss"].detach()))


def test_checkpoints_translate_the_same_in_both_packages(tmp_path):
    """A port checkpoint decoded by JAX's Translator and a JAX checkpoint
    decoded by the port's: identical n-best ids, scores within 1e-4."""
    trainer = port_trainer(steps=3)
    _, _, img = corpus(n=len(SRC), seed=7)
    path = ck.save_checkpoint(str(tmp_path / "port"), trainer.state, trainer.cfg, vocab(),
                              vocab())
    jstate, _, jmodel, _, _ = jax_ck.load_checkpoint(path)
    want = port_nbest(trainer.model, img)
    assert_same_nbest(want, jax_nbest(jmodel, jstate.params, img))
    # JAX saves what it loaded; the port loads that
    v = JaxVocab(JAX_SPECIALS + WORDS)
    jpath = jax_ck.save_checkpoint(str(tmp_path / "jax"), jstate,
                                   JaxConfig.from_json(open(os.path.join(path, "config.json"))
                                                       .read()), v, v)
    _, _, model, _, _ = ck.load_checkpoint(jpath, device="cpu")
    assert_same_nbest(port_nbest(model, img), jax_nbest(jmodel, jstate.params, img))
    assert [[ids for _, ids in n] for n in port_nbest(model, img)] == [
        [ids for _, ids in n] for n in want]


def test_loaded_state_equals_the_saved_one_and_steps_the_same(tmp_path):
    """Bit for bit: params, Adam state, EMA, step, lr and the generator;
    then one step (dropout, word dropout and z noise drawn from the
    generator) from each, on the same batch, equal bit for bit."""
    trainer = port_trainer(steps=3)
    live = trainer.state
    path = ck.save_checkpoint(str(tmp_path), live, trainer.cfg, vocab(), vocab())
    loaded, cfg, _, _, _ = ck.load_checkpoint(path, device="cpu")
    a, b = ck.state_tree(live, trainer.cfg), ck.state_tree(loaded, cfg)
    assert_bitwise(b, a, "state")  # params, opt_state, ema, step, lr, rng, generator
    assert loaded.step == live.step and loaded.lr == live.lr
    src, tgt, img = corpus(seed=3)
    batch = batch_tensors(next(BucketIterator(BinarizedDataset(src, tgt), 4, [10],
                                              img_feats=img).epoch()), torch.device("cpu"))
    step = make_train_step(cfg)
    live, m_live = step(live, batch, live.generator)
    loaded, m_loaded = step(loaded, batch, loaded.generator)
    assert float(m_live["loss"].detach()) == float(m_loaded["loss"].detach())
    assert_bitwise(ck.state_tree(loaded, cfg), ck.state_tree(live, trainer.cfg), "after a step")


def test_released_checkpoints_load_in_both_packages(tmp_path):
    """JAX's release (bf16 params, EMA promoted, optimizer stripped) loads
    in the port with the bf16 values and a fresh optimizer; the port's
    release loads in JAX the same way."""
    trainer = port_trainer(steps=2)
    path = ck.save_checkpoint(str(tmp_path / "run"), trainer.state, trainer.cfg, vocab(),
                              vocab())
    for release, name in ((jax_ck.release_checkpoint, "jax"), (ck.release_checkpoint, "port")):
        dst = str(tmp_path / f"released_{name}")
        sizes = release(path, dst, dtype="bfloat16", ema=True)
        assert sizes["dst_bytes"] < sizes["src_bytes"] / 4
        assert ck.is_released(dst) and jax_ck.is_released(dst)
        state, cfg, model, _, _ = ck.load_checkpoint(dst, device="cpu")
        ema_bf16 = [e.to(torch.bfloat16).float() for e in trainer.state.ema]
        for p, e in zip(model.parameters(), ema_bf16):
            assert torch.equal(p, e)
        assert all(not torch.any(m) for m in state.opt_state["mu"])
        assert int(state.opt_state["count"]) == 0
        jstate, _, _, _, _ = jax_ck.load_checkpoint(dst)
        for (n, p) in model.named_parameters():
            np.testing.assert_array_equal(
                np.asarray(tree(jstate.params)[n], np.float32), p.detach().numpy())
    plain = port_trainer(train_over=dict(ema_decay=0.0), steps=1)
    no_ema = ck.save_checkpoint(str(tmp_path / "noema"), plain.state, plain.cfg, vocab(),
                                vocab())
    with pytest.raises(ValueError, match="EMA"):
        ck.release_checkpoint(no_ema, str(tmp_path / "x"), ema=True)


def test_retention_listing_and_use_ema(tmp_path):
    trainer = port_trainer(steps=1)
    for _ in range(4):
        trainer.train(1)
        ck.save_checkpoint(str(tmp_path), trainer.state, trainer.cfg, vocab(), vocab(), keep=2)
    assert ck.list_checkpoints(str(tmp_path)) == [4, 5]
    assert ck.latest_checkpoint(str(tmp_path)).endswith("step_00000005")
    assert jax_ck.list_checkpoints(str(tmp_path)) == [4, 5]
    raw = load_model_spec(str(tmp_path), device="cpu")
    ema = load_model_spec(str(tmp_path), use_ema=True, device="cpu")
    assert raw.steps == ema.steps == [5]
    for p, q, e in zip(raw.models[0].parameters(), ema.models[0].parameters(),
                       trainer.state.ema):
        assert torch.equal(q, e) and not torch.equal(p, q)
    _, _, img = corpus(n=len(SRC), seed=7)
    jstate, _, jmodel, _, _ = jax_ck.load_checkpoint(ck.latest_checkpoint(str(tmp_path)))
    assert_same_nbest(port_nbest(ema.models[0], img), jax_nbest(jmodel, jstate.ema_params, img))
    # a comma-separated -model is an ensemble (once refused, ROADMAP item 5.4)
    both = load_model_spec(f"{tmp_path},{tmp_path}", use_ema=True, device="cpu")
    assert both.ensemble and both.steps == [5, 5] and len(both.translator_args()) == 2
    for m in both.models:
        assert all(torch.equal(p, e) for p, e in zip(m.parameters(), trainer.state.ema))
    with pytest.raises(SystemExit, match="no checkpoint"):
        load_model_spec(str(tmp_path / "nowhere"), device="cpu")
