"""PyTorch port: data and vocab-parallel training (parallel/, ROADMAP.md
item 5.8) on a CPU gloo mesh of 4 ranks against the JAX package on its
virtual CPU mesh of 4 devices.

The ranks run once for the module (tests/torch_parallel_worker.py, group
``train``: a 2 data x 2 model mesh and a 4 x 1 one, each rank a process,
with a timeout); every test compares one case's results with JAX's
function on ``make_mesh_2d(2, 2)`` or ``make_mesh(4)`` over the same
numpy-seeded inputs from JAX's initial parameters (``params_from_jax``).
The cases mirror tests/test_tp.py (the rules :53, training with the fused
CE on and off :82, tied :113, eval :130, packed :147, the divisibility
error :203, the Trainer :210) and the data-parallel cases of
tests/test_train.py (:87, :176, :201). JAX's training step samples z with
its own noise, which the port cannot draw, so the multi-step cases train
``nmt`` (no noise at dropout 0) and ``vmmt_c`` is held by its loss and
every gradient at z = the posterior mean, as tests/test_torch_train.py
holds the single process. f32 throughout. Tolerances (JAX's own,
tests/test_tp.py:103-112): loss 1e-5 relative; parameters 2e-3 relative
and 1e-4 absolute after 3 steps (1e-3 and 2e-5 after 1 DP step, test_train
:102); gradients 1e-4 relative plus 1e-5 of the tensor's largest entry
(tests/test_torch_train.py); validation 1e-5 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_tp import V, tp_batch, tp_cfg
from torch_parallel_worker import spawn
from variational_mmt_tpu.data.dataset import BinarizedDataset as JaxBinarizedDataset
from variational_mmt_tpu.data.dataset import BucketIterator as JaxBucketIterator
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.models.model import generator_params as jax_generator_params
from variational_mmt_tpu.parallel.mesh import batch_sharding, make_mesh as jax_make_mesh
from variational_mmt_tpu.parallel.tp import make_mesh_2d
from variational_mmt_tpu.train.loss import compute_loss as jax_compute_loss
from variational_mmt_tpu.train.trainer import create_train_state as jax_create_train_state
from variational_mmt_tpu.train.trainer import make_eval_step as jax_make_eval_step
from variational_mmt_tpu.train.trainer import make_train_step as jax_make_train_step
from variational_mmt_torch.config import Config, ModelConfig, TrainConfig
from variational_mmt_torch.convert import flatten
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.data.packing import PackedBucketIterator
from variational_mmt_torch.models.model import build_model, param_shapes
from variational_mmt_torch.parallel import mesh as pm, tp
from variational_mmt_torch.train.trainer import Trainer, create_train_state

TIMEOUT_S = 150  # the 4 ranks of the module's cases, with their start-up
PACKED = dict(pack=True, pack_segments=3)


def smoothed(jcfg):
    """``jcfg`` with label smoothing 0.1 (the PAD column and the global
    V - 2 of the vocab-parallel CE)."""
    return dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train,
                                                               label_smoothing=0.1))


def cfg_dict(jcfg) -> dict:
    return {"model": dataclasses.asdict(jcfg.model), "train": dataclasses.asdict(jcfg.train)}


def np_tree(tree) -> dict:
    return jax.tree.map(lambda a: np.asarray(a, np.float32), jax.device_get(tree))


def np_batch(batch) -> dict:
    return {k: np.asarray(v) for k, v in batch.items()}


def jax_steps(jcfg, batch, mesh, steps):
    """(losses, n_sents, final flat params, initial params) of ``steps``
    JAX train steps on ``mesh`` over one batch."""
    model = jax_build_model(jcfg.model)
    state = jax_create_train_state(jcfg, model)
    init = np_tree(state.params)
    step = jax_make_train_step(jcfg, model, mesh)
    b = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, batch_sharding(mesh))
    losses = []
    for _ in range(steps):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses, float(m["n_sents"]), flatten(np_tree(state.params)), init


def packed_batch(n=48, seed=7):
    """tests/test_tp.py:147's packed batch, from the port's packer."""
    rng = np.random.default_rng(seed)
    src = [rng.integers(4, V, rng.integers(3, 12)).astype(np.int32) for _ in range(n)]
    tgt = [rng.integers(4, V, rng.integers(3, 12)).astype(np.int32) for _ in range(n)]
    feats = rng.standard_normal((n, 16)).astype(np.float32)
    it = PackedBucketIterator(BinarizedDataset(src, tgt), batch_size=8, buckets=[16],
                              img_feats=feats, seed=2, max_segments=3)
    pb = next(it.epoch(0))
    return {k: getattr(pb, k) for k in ("src", "tgt_in", "tgt_out", "src_seg", "tgt_seg",
                                        "seg_first", "seg_last", "seg_mask", "img")}


def corpus(n=48, seed=0, lo=4, hi=8):
    rng = np.random.default_rng(seed)
    src = [rng.integers(4, V, rng.integers(lo, hi)).astype(np.int32) for _ in range(n)]
    tgt = [rng.integers(4, V, rng.integers(lo, hi)).astype(np.int32) for _ in range(n)]
    return src, tgt, rng.standard_normal((n, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX side of every case and the ranks' results."""
    jax_side, inp = {}, {}
    batch = np_batch(tp_batch())

    cfgs, trees = {}, {}
    for fused in (True, False):
        jcfg = tp_cfg("nmt", fused_ce=fused)
        jax_side[("tp_train", fused)] = jax_steps(jcfg, batch, make_mesh_2d(2, 2), 3)
        cfgs[fused], trees[fused] = cfg_dict(jcfg), jax_side[("tp_train", fused)][3]
    # both routes start from the same parameters (the same seed)
    inp["tp_train"] = {"cfgs": cfgs, "tree": trees[True], "batch": batch}

    grads_cfgs = {f: cfg_dict(smoothed(tp_cfg("vmmt_c", fused_ce=f))) for f in (True, False)}
    jcfg = tp_cfg("vmmt_c")
    tree = np_tree(jax_create_train_state(jcfg, jax_build_model(jcfg.model)).params)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
                        tree)
    inp["tp_grads"] = {"cfgs": grads_cfgs, "tree": tree, "batch": batch, "step": 7}
    for fused in (True, False):
        jax_side[("tp_grads", fused)] = jax_loss_and_grads(
            smoothed(tp_cfg("vmmt_c", fused_ce=fused)), tree, batch, 7)

    jcfg = tp_cfg("nmt", share_embeddings=True, share_decoder_embeddings=True, emb_dim=32)
    jax_side["tied"] = jax_steps(jcfg, batch, make_mesh_2d(2, 2), 1)
    inp["tied"] = {"cfg": cfg_dict(jcfg), "tree": jax_side["tied"][3], "batch": batch}

    jcfg = tp_cfg("nmt")
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, **PACKED))
    pb = packed_batch()
    jax_side["packed"] = jax_steps(jcfg, pb, make_mesh_2d(2, 2), 2)
    inp["packed"] = {"cfg": cfg_dict(jcfg), "tree": jax_side["packed"][3], "batch": pb}

    jcfg = tp_cfg("nmt")
    jax_side["dp4"] = jax_steps(jcfg, batch, jax_make_mesh(4), 1)
    inp["dp4"] = {"cfg": cfg_dict(jcfg), "tree": jax_side["dp4"][3], "batch": batch}

    jcfg = tp_cfg("vmmt_c")
    src, tgt, img = corpus(n=20, seed=4)
    ev = {"cfg": cfg_dict(jcfg), "tree": tree, "src": src, "tgt": tgt, "img": img,
          "batch_size": 8, "buckets": [8, 12]}
    inp["eval"] = ev
    jax_side["eval"] = jax_validate(jcfg, tree, ev)

    jcfg = tp_cfg("vmmt_c", dropout=0.1, word_dropout=0.1)
    src, tgt, img = corpus()
    inp["trainer"] = {"cfg": {"model": dataclasses.asdict(jcfg.model),
                              "train": {**dataclasses.asdict(jcfg.train), "batch_size": 6}},
                      "tree": tree, "src": src, "tgt": tgt, "img": img, "batch_size": 6,
                      "buckets": [8, 12]}
    src, tgt, img = corpus(n=16, seed=0, lo=6, hi=7)
    inp["valid_iw"] = {"cfg": {"model": dataclasses.asdict(jcfg.model),
                               "train": {**dataclasses.asdict(jcfg.train), "max_steps": 2,
                                         "valid_every": 2, "report_every": 10,
                                         "checkpoint_every": 10**9}},
                       "tree": tree, "src": src, "tgt": tgt, "img": img, "batch_size": 8,
                       "buckets": [8]}
    jcfg = tp_cfg("vmmt_c")
    inp["param_init"] = {"cfg": {"model": dataclasses.asdict(jcfg.model),
                                 "train": {**dataclasses.asdict(jcfg.train), "param_init": 0.1}},
                         "tree": tree}
    ranks = spawn("train", 4, str(tmp_path_factory.mktemp("tp_train")), inp, TIMEOUT_S)
    return jax_side, ranks


def jax_loss_and_grads(jcfg, tree, batch, step):
    """JAX's loss and gradients, deterministic with z = the posterior mean."""
    jmodel = jax_build_model(jcfg.model)

    def loss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(batch["src"]),
                           jnp.asarray(batch["tgt_in"]), jnp.asarray(batch["img"]),
                           deterministic=True, sample=False, tgt_out=jnp.asarray(batch["tgt_out"]))
        gen = jax_generator_params(params, jcfg.model) if jcfg.model.fused_ce else None
        return jax_compute_loss(out, jnp.asarray(batch["tgt_out"]),
                                jnp.asarray(batch["example_mask"]), jnp.asarray(batch["img"]),
                                jcfg.model, jcfg.train, jnp.int32(step), generator_params=gen)[0]

    value, grads = jax.value_and_grad(loss)(tree)
    return float(value), flatten(np_tree(grads))


def jax_validate(jcfg, tree, ev):
    """ce_sum, n_tokens and n_sents of JAX's eval step on the 2x2 mesh over
    the same batches."""
    model = jax_build_model(jcfg.model)
    mesh = make_mesh_2d(2, 2)
    step = jax_make_eval_step(jcfg, model, mesh)
    state = jax_create_train_state(jcfg, model).replace(params=tree)
    it = JaxBucketIterator(JaxBinarizedDataset(ev["src"], ev["tgt"]), ev["batch_size"],
                           ev["buckets"], img_feats=ev["img"], shuffle=False, use_native=False)
    agg = {"ce_sum": 0.0, "n_tokens": 0.0, "n_sents": 0.0, "kl_sum": 0.0}
    for b in it.epoch(0):
        batch = {k: jnp.asarray(getattr(b, k)) for k in
                 ("src", "tgt_in", "tgt_out", "example_mask", "img")}
        m = step(state, jax.device_put(batch, batch_sharding(mesh)))
        for k in agg:
            agg[k] += float(m[k])
    return agg


def assert_params(got: dict, want: dict, rtol=2e-3, atol=1e-4):
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol, err_msg=name)


def test_tp_rules_place_vocab_shards(run):
    """The rules on the port's names, the local shapes on the 2x2 mesh, and
    the Adam moments riding the same layout (tests/test_tp.py:53)."""
    assert tp.spec_for("generator.kernel", 2) == (None, "model")
    assert tp.spec_for("tgt_embed.embedding", 2) == ("model", None)
    assert tp.spec_for("src_embed.embedding", 2) == ("model", None)
    assert tp.spec_for("generator.bias", 1) == ("model",)
    assert tp.spec_for("gen_bias", 1) == ("model",)
    assert tp.spec_for("encoder.layers.0.fwd.hh_kernel", 2) == ()
    assert tp.spec_for("pre_generator.kernel", 2) == ()
    # int8: the codes take the tensor's spec, a scale its last component
    assert tp.spec_for("generator.kernel.int8", 2) == (None, "model")
    assert tp.spec_for("generator.kernel.scale", 1) == ("model",)
    assert tp.spec_for("tgt_embed.embedding.scale", 1) == (None,)
    _, ranks = run
    for fused in (True, False):
        full = param_shapes(ModelConfig(**tp_cfg("nmt", fused_ce=fused).model.__dict__))
        for r in ranks:
            got = r["case_tp_train"][fused]
            for name, shape in full.items():
                axis = tp.shard_axis(name, len(shape))
                want = list(shape)
                if axis is not None:
                    want[axis] //= 2
                assert got["shapes"][name] == tuple(want), name
                assert got["mu"][name] == tuple(want), name


@pytest.mark.parametrize("fused_ce", [True, False])
def test_tp_train_matches_jax(run, fused_ce):
    """3 steps on 2 data x 2 model ranks == JAX's 3 steps on its 2x2 mesh:
    the vocab-parallel CE (fused or over the logits), the data group's
    gradient sum and the global norm's clipping (tests/test_tp.py:82)."""
    jax_side, ranks = run
    want_losses, _, want_params, _ = jax_side[("tp_train", fused_ce)]
    for r in ranks:
        got = r["case_tp_train"][fused_ce]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
        assert_params(got["params"], want_params)


@pytest.mark.parametrize("fused_ce", [True, False])
def test_tp_loss_and_every_gradient_match_jax(run, fused_ce):
    """vmmt_c on the 2x2 mesh, z = the posterior mean: the global loss and
    every gradient (sharded ones gathered) against ``jax.value_and_grad``."""
    jax_side, ranks = run
    want_loss, want = jax_side[("tp_grads", fused_ce)]
    for r in ranks:
        got = r["case_tp_grads"][fused_ce]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
        assert set(got["grads"]) == set(want)
        for name in sorted(want):
            w = want[name]
            np.testing.assert_allclose(got["grads"][name], w, rtol=1e-4,
                                       atol=1e-5 * max(1.0, float(np.abs(w).max())),
                                       err_msg=name)


def test_tp_tied_generator_matches_jax(run):
    """Three-way tying on the 2x2 mesh: the tied generator reads the
    vocab-sharded tgt_embed transposed (tests/test_tp.py:113)."""
    jax_side, ranks = run
    for r in ranks:
        np.testing.assert_allclose(r["case_tied"]["loss"], jax_side["tied"][0][0], rtol=1e-5)


def test_tp_eval_matches_jax(run):
    """Trainer.validate on the 2x2 mesh == JAX's eval step on its mesh
    (tests/test_tp.py:130): the batch sums all-reduced over the data group."""
    jax_side, ranks = run
    want = jax_side["eval"]
    for r in ranks:
        got = r["case_eval"]
        np.testing.assert_allclose(got["xent"], want["ce_sum"] / want["n_tokens"], rtol=1e-5)
        np.testing.assert_allclose(got["kl"], want["kl_sum"] / want["n_sents"], rtol=1e-5)
        np.testing.assert_allclose(got["elbo"], -(want["ce_sum"] + want["kl_sum"])
                                   / want["n_sents"], rtol=1e-5)


def test_tp_packed_train_matches_jax(run):
    """Sequence packing on the 2x2 mesh == JAX's packed steps on its mesh
    (tests/test_tp.py:147)."""
    jax_side, ranks = run
    want_losses, want_sents, want_params, _ = jax_side["packed"]
    for r in ranks:
        got = r["case_packed"]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
        assert got["n_sents"] == want_sents > 8
        assert_params(got["params"], want_params)


def test_dp_matches_jax(run):
    """One step on 4 data ranks == JAX's step on make_mesh(4)
    (tests/test_train.py:87)."""
    jax_side, ranks = run
    want_losses, _, want_params, _ = jax_side["dp4"]
    for r in ranks:
        np.testing.assert_allclose(r["case_dp4"]["loss"], want_losses[0], rtol=1e-5)
        assert_params(r["case_dp4"]["params"], want_params, rtol=1e-3, atol=2e-5)


def test_trainer_accepts_tp_mesh_and_reports_valid_iw(run):
    """The Trainer on the 2x2 mesh with batch 6, divisible by the 2 data
    shards and not by the 4 ranks (tests/test_tp.py:210); ``valid_iw`` on
    4 data ranks (tests/test_train.py:201)."""
    _, ranks = run
    for r in ranks:
        got = r["case_trainer"]
        assert got["finite"] and len(got["losses"]) == 4 and np.isfinite(got["lr"])
        h = got["history"][-1]
        assert "iw_elbo" in h and np.isfinite(h["iw_elbo"]) and h["iw_elbo"] < h["elbo"]
    # every rank reports the same global numbers
    assert len({tuple(r["case_trainer"]["losses"]) for r in ranks}) == 1


def test_param_init_and_generators_across_ranks(run):
    """``param_init`` on the 2x2 mesh gives every rank its shard of the
    single process's draw (vocab-sharded tensors drawn at their full
    shape); the training generator is seeded by the data rank: the ranks of
    one model group draw alike, data rank 0 as the single process."""
    _, ranks = run
    d = {"model": tp_cfg("vmmt_c").model.__dict__,
         "train": {**dataclasses.asdict(tp_cfg("vmmt_c").train), "param_init": 0.1}}
    cfg = Config(model=ModelConfig(**d["model"]), train=TrainConfig(**d["train"]))
    model = build_model(cfg.model, device="cpu")
    state = create_train_state(cfg, model)
    want = {n: p.detach().numpy() for n, p in model.named_parameters()}
    draw = torch.rand(4, generator=state.generator).tolist()
    for r in ranks:
        got = r["case_param_init"]["params"]
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    draws = [r["case_param_init"]["draw"] for r in ranks]  # rank = 2 * data rank + model rank
    assert draws[0] == draws[1] == draw and draws[2] == draws[3] != draw


def test_guards_cover_the_parallel_package():
    """tests/test_torch_guards.py's import scan reads parallel/ too."""
    from test_torch_guards import PORT_FILES

    names = {p.name for p in PORT_FILES if p.parent.name == "parallel"}
    assert names == {"__init__.py", "mesh.py", "tp.py"}


def test_tp_vocab_divisibility_error():
    cfg = tp_cfg()
    cfg.model.src_vocab_size = 30  # not divisible by 4
    with pytest.raises(ValueError, match="divisible by the tensor-parallel"):
        tp.validate_tp_divisibility(cfg.model, 4)


def no_group_mesh(n_data, n_model):
    """A mesh object for the checks made before any collective."""
    return pm.Mesh(n_data=n_data, n_model=n_model, rank=0, device=torch.device("cpu"))


def test_batch_size_mesh_divisibility_error():
    """JAX's errors (tests/test_train.py:176): the batch, and each
    micro-batch, must divide over the data shards; the vocab over the
    model shards."""
    src, tgt, _ = corpus(n=10)
    it = BucketIterator(BinarizedDataset(src, tgt), 30, [8])

    def trainer(mesh, **train):
        cfg = Config(model=ModelConfig(**tp_cfg().model.__dict__),
                     train=TrainConfig(batch_size=30, **train))
        return Trainer(cfg, build_model(cfg.model, device="cpu"), it, device="cpu", mesh=mesh)

    with pytest.raises(ValueError, match="divisible by the number of data-parallel"):
        trainer(no_group_mesh(8, 1))
    with pytest.raises(ValueError, match="micro-batch"):
        trainer(no_group_mesh(2, 1), grad_accum=2)
    with pytest.raises(ValueError, match="divisible by the tensor-parallel"):
        trainer(no_group_mesh(1, 3))


def test_make_mesh_refuses_what_would_hang_or_not_run():
    """More shards than ranks raises JAX's error; fewer would leave a rank
    idle in the first collective; several ranks need torchrun's group."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        pm.make_mesh(2, 1, device="cpu", backend="gloo")
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        pm.make_mesh(2, 2, device="cpu", backend="gloo")
    with pytest.raises(ValueError, match="requested 4 data shards but only 2"):
        pm.make_mesh(4, 1, device="cpu", backend="gloo", rank=0, world_size=2)
    with pytest.raises(ValueError, match="every rank must belong"):
        pm.make_mesh(1, 1, device="cpu", backend="gloo", rank=0, world_size=2)
    with pytest.raises(ValueError, match="nccl backend needs a CUDA device"):
        pm.make_mesh(1, 1, device="cpu", backend="nccl", rank=0, world_size=1)


def test_serving_across_ranks_is_refused():
    """The service answers on one rank; across ranks the others would wait
    in its collectives: refused, naming ROADMAP.md item 5.10."""
    from variational_mmt_torch.data.vocab import SPECIALS, Vocab
    from variational_mmt_torch.serve import TranslationService

    model = build_model(ModelConfig(**tp_cfg().model.__dict__), device="cpu")
    vocab = Vocab(SPECIALS + [f"w{i}" for i in range(V - 4)])
    with pytest.raises(NotImplementedError, match="item 5.10"):
        TranslationService(model, vocab, vocab, mesh=no_group_mesh(1, 2), device="cpu")


def test_shard_batch_slices_every_leaf():
    """Rows [d*B/n, (d+1)*B/n) of every leaf: packed and image leaves too."""
    pb = PackedBucketIterator(BinarizedDataset(*corpus(n=24)[:2]), batch_size=8,
                              buckets=[16], seed=2, max_segments=3)
    batch = next(pb.epoch(0))
    mesh = pm.Mesh(n_data=4, n_model=2, rank=5, device=torch.device("cpu"))  # data rank 2
    got = pm.shard_batch(batch, mesh)
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(getattr(got, f.name), v[4:6])
    d = pm.shard_batch({"a": torch.arange(8)}, mesh)
    assert d["a"].tolist() == [4, 5]
    with pytest.raises(ValueError, match="not divisible"):
        pm.shard_batch({"a": torch.arange(6)}, mesh)
