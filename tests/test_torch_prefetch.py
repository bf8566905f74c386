"""PyTorch port: the prefetcher (data/prefetch.py) and the Trainer's data
stream through it. On the CPU the worker thread assembles the batches
without pinning or streams; the losses of a prefetched run must equal, to
the bit, those of the same steps taken over ``batch_tensors`` on the
consumer's thread. The CUDA copy stream is checked on the card only."""

import itertools
import threading

import numpy as np
import pytest
import torch

from variational_mmt_torch.config import Config, ModelConfig, TrainConfig
from variational_mmt_torch.convert import params_from_jax
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.data.packing import PackedBucketIterator
from variational_mmt_torch.data.prefetch import THREAD_NAME, device_batches, prefetch
from variational_mmt_torch.models.model import build_model, init_params
from variational_mmt_torch.train.trainer import (Trainer, batch_tensors, create_train_state,
                                                 make_train_step)

TINY = dict(model_type="vmmt_c", src_vocab_size=24, tgt_vocab_size=24, emb_dim=16,
            hidden_dim=16, latent_dim=4, img_feat_dim=6, compute_dtype="float32",
            dropout=0.3, word_dropout=0.1, use_pallas=True, pallas_decoder=True)


def prefetch_threads():
    return {t for t in threading.enumerate() if t.name == THREAD_NAME}


def corpus(n=10, seed=0):
    rng = np.random.default_rng(seed)
    src = [rng.integers(4, 24, rng.integers(2, 9)).astype(np.int32) for _ in range(n)]
    tgt = [rng.integers(4, 24, rng.integers(2, 8)).astype(np.int32) for _ in range(n)]
    img = rng.standard_normal((n, TINY["img_feat_dim"])).astype(np.float32)
    return src, tgt, img


def test_order_and_contents_are_the_source_iterators():
    assert list(prefetch(iter(range(100)), size=3)) == list(range(100))
    assert list(prefetch(iter("abc"), transform=str.upper)) == ["A", "B", "C"]


@pytest.mark.parametrize("kind", ["bucket", "bucket_table", "packed"])
def test_device_batches_equal_batch_tensors(kind):
    """The prefetched tensors of every batch of an epoch equal
    ``batch_tensors`` of the same batch, the table's gather included."""
    src, tgt, img = corpus(n=23)
    ds = BinarizedDataset(src, tgt)
    table = torch.from_numpy(img) if kind == "bucket_table" else None
    if kind == "packed":
        it = PackedBucketIterator(ds, 4, [16], img_feats=img, seed=1, max_segments=3)
    else:
        it = BucketIterator(ds, 4, [6, 10], img_feats=None if table is not None else img,
                            shuffle=True, seed=1)
    cpu = torch.device("cpu")
    want = [batch_tensors(b, cpu, table) for b in it.epoch(1)]
    got = list(device_batches(it.epoch(1), cpu, table))
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


def test_a_worker_exception_is_raised_on_the_consumer():
    class Broken(RuntimeError):
        pass

    def source():
        yield 1
        yield 2
        raise Broken("bad batch")

    got = []
    with pytest.raises(Broken, match="bad batch"):
        for x in prefetch(source()):
            got.append(x)
    assert got == [1, 2]
    with pytest.raises(ValueError, match="tgt_in and tgt_out"):
        src, _, _ = corpus()
        next(device_batches(BucketIterator(BinarizedDataset(src), 2, [10]).epoch(0),
                            torch.device("cpu")))


def test_a_consumer_break_releases_the_worker():
    before = prefetch_threads()
    for x in prefetch(itertools.count(), size=2):
        if x == 3:
            break
    workers = prefetch_threads() - before
    for t in workers:
        t.join(1.0)
        assert not t.is_alive()


def trainer_and_loop(**train_over):
    """A Trainer on a shuffled 3-batch epoch, and the same start for a
    direct loop: (trainer, cfg, model copy, iterator)."""
    src, tgt, img = corpus()
    cfg = Config(model=ModelConfig(**TINY), train=TrainConfig(seed=5, **train_over))
    models = []
    for _ in range(2):
        m = build_model(cfg.model, device="cpu")
        m.load_state_dict(params_from_jax(init_params(cfg.model, seed=0), cfg.model))
        models.append(m)
    it = BucketIterator(BinarizedDataset(src, tgt), 4, [10], img_feats=img, shuffle=True, seed=2)
    return Trainer(cfg, models[0], it, device="cpu"), cfg, models[1], it


def direct_losses(cfg, model, batches):
    """The parent's loop: ``train_step`` over ``batch_tensors`` of host
    batches assembled on this thread."""
    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    losses = []
    for b in batches:
        state, m = step(state, batch_tensors(b, torch.device("cpu")), state.generator)
        losses.append(float(m["loss"].detach()))
    return losses


def epochs(it, *ids):
    return [b for e in ids for b in it.epoch(e)]


def test_split_runs_equal_one_run_and_the_direct_loop():
    """``train(3); train(4)`` gives the losses of ``train(7)`` to the bit,
    across an epoch boundary (3 batches an epoch), and those of the direct
    loop over ``batch_tensors``: the worker and the batches in flight
    persist across calls, and the prefetcher draws nothing from the
    generator."""
    split, cfg, model, it = trainer_and_loop()
    whole = trainer_and_loop()[0]
    got = [h["loss"] for h in split.train(3) + split.train(4)]
    assert got == [h["loss"] for h in whole.train(7)]
    assert got == direct_losses(cfg, model, epochs(it, 0, 1, 2)[:7])
    assert torch.equal(split.state.generator.get_state(), whole.state.generator.get_state())
    split.close()
    whole.close()


def test_train_from_restarts_at_epoch_0_and_ends_the_old_worker():
    trainer, cfg, model, it = trainer_and_loop()
    before = prefetch_threads()
    first = [h["loss"] for h in trainer.train(2)]
    old = prefetch_threads() - before
    assert len(old) == 1
    trainer.train_from(max_steps=4)  # steps 3 and 4 on epoch 0's first two batches
    for t in old:
        t.join(1.0)
        assert not t.is_alive()
    rest = [h["loss"] for h in trainer.last_run["metrics"]]
    batches = epochs(it, 0)
    assert first + rest == direct_losses(cfg, model, batches[:2] + batches[:2])
    trainer.close()


def test_validation_reads_through_the_prefetcher():
    trainer, cfg, model, it = trainer_and_loop()
    trainer.valid_iter = it
    before = prefetch_threads()
    val = trainer.validate()
    assert np.isfinite(val["ppl"])
    for t in prefetch_threads() - before:  # the validation's worker ends with its epoch
        t.join(1.0)
        assert not t.is_alive()


@pytest.mark.cuda
def test_device_batches_on_the_card_equal_batch_tensors():
    """The copy stream, pinned memory and the event: every prefetched
    tensor equals ``batch_tensors``' on the card, the table's gather too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, tgt, img = corpus(n=23)
    it = BucketIterator(BinarizedDataset(src, tgt), 4, [6, 10], shuffle=True, seed=1)
    dev = torch.device("cuda")
    table = torch.from_numpy(img).to(dev)
    want = [batch_tensors(b, dev, table) for b in it.epoch(0)]
    for g, w in zip(device_batches(it.epoch(0), dev, table), want):
        for k in w:
            assert g[k].device.type == "cuda" and torch.equal(g[k], w[k]), k
