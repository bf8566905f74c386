"""Training loop. Mirrors ``variational_mmt_tpu/train/trainer.py``.

One optimizer step (``make_train_step``, JAX :98-264) is forward (encoder,
q, prior, z, decoder, generator), ELBO, backward, global-norm clipping and
the optimizer's update with the lr as a separate scalar, and around it:

- ``grad_accum``: micro-batches in sequence, gradients averaged, metric
  sums added, ``beta`` and ``loss`` averaged;
- ``fix_word_vecs_enc`` / ``fix_word_vecs_dec``: the frozen tables'
  gradients and final updates are zero (one shared table with
  ``share_embeddings``: freezing either side freezes it);
- ``skip_nonfinite``: params and optimizer state stay when the global
  gradient norm is not finite, and ``skipped_sum`` counts it, decided on
  the device;
- ``ema_decay``: an EMA of the params blended in f32, decay
  ``min(d, (1+n)/(10+n))`` over the step count n with ``ema_ramp``, and
  unchanged on a skipped step.

With ``train.pack`` the batches are sequence-packed (data/packing.py) and
the step runs ``VMMTModel.forward_packed`` (:121-144). ``Trainer`` is the
loop (:388-691): ``train_from`` with the report, validation (plateau decay,
``bleu_fn``) and checkpoint triggers, which fire when the step count
crosses a multiple of their interval; ``validate`` (deterministic, z = the
posterior mean); image features held on the device and gathered by
``batch.indices``. Metrics stay on the device until a report, a validation,
a checkpoint or the end of a run reads them, in one transfer.

Training and validation batches come through the prefetcher
(``data/prefetch.py``), as JAX's ``_device_batches`` (:479-541) feeds them
with stack 1: a background thread assembles each batch (natively by
default, data/dataset.py and data/packing.py) and copies it to the card on
a copy stream while the step before it runs. The training stream and its
worker persist across ``train`` calls, so ``train(a); train(b)`` sees the
batches of ``train(a + b)``; ``train_from`` starts the data again at epoch
0 and ``close`` ends the worker. JAX's ``jit``/``lax.scan`` dispatch has
no counterpart: the step runs eagerly, the kernels of ``use_pallas`` /
``pallas_decoder`` doing the recurrences. Randomness comes from one
``torch.Generator`` on the device (``TrainState.generator``), seeded from
``train.seed``; ``param_init`` draws from a second one.

With a ``mesh`` (parallel/mesh.py; JAX :84-95, :284-340, :405-432) each
rank runs the step on its data shard's rows of every batch, sliced on the
host before the copy. The loss is divided by the global sentence count
(the local count all-reduced over the data group before the backward
pass), so that the SUM of the ranks' gradients, all-reduced over the data
group after the backward pass in flat buckets, is the global batch's
gradient. Not DDP: DDP averages, hooks into the module's backward and
would reduce the vocab-sharded leaves with the replicated ones; a bucketed
all-reduce of the gradient list the step already holds keeps one code path
for gloo and NCCL and leaves the single-process step untouched. With
several model ranks the model is this rank's vocab-parallel shard
(parallel/tp.py), the global gradient norm counts each replicated leaf
once and the sharded leaves' squares summed over the model group.
Metrics stay on the device and are all-reduced once a read. The training
generator is seeded by the data rank (``train_seed``): no two data ranks
draw the same dropout masks or z noise, and the ranks of one model group,
which compute the replicated parts redundantly, draw the same. Only rank 0
prints and logs.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from variational_mmt_torch.config import Config
from variational_mmt_torch.data.dataset import Batch
from variational_mmt_torch.data.packing import PackedBatch
from variational_mmt_torch.data.prefetch import device_batches, gather_features, host_tensors
from variational_mmt_torch.device import resolve_device
from variational_mmt_torch.models.model import VMMTModel, shard_model
from variational_mmt_torch.parallel import mesh as pm, tp
from variational_mmt_torch.train.loss import compute_loss
from variational_mmt_torch.train.optim import Optimizer, PlateauScheduler, global_norm
from variational_mmt_torch.utils.logging import Statistics

# param_init's generator seed is train.seed plus this: far from the
# training stream's seed (JAX folds a sentinel far outside the step range)
PARAM_INIT_STREAM = 2**31 - 13
# the training generator of data rank d is seeded train.seed + d * this
DATA_RANK_STREAM = 1_000_003
METRIC_KEYS = ("loss", "ce_sum", "n_tokens", "n_correct", "n_sents", "kl_sum",
               "img_loss_sum", "beta", "grad_norm", "skipped_sum")
VALID_KEYS = ("ce_sum", "n_tokens", "n_correct", "n_sents", "kl_sum", "img_loss_sum")
# the metrics that are sums over the batch (all-reduced over the data group)
SUMMED_KEYS = ("loss", "ce_sum", "n_tokens", "n_correct", "n_sents", "kl_sum", "img_loss_sum")


@dataclasses.dataclass
class TrainState:
    model: VMMTModel  # holds the parameters
    opt_state: Dict[str, object]
    step: int
    lr: float  # a float32 value
    ema: Optional[List[torch.Tensor]] = None  # one tensor a parameter (ema_decay > 0)
    generator: Optional[torch.Generator] = None  # dropout, word dropout, z noise


def f32(x: float) -> float:
    """``x`` rounded to float32, as JAX keeps the lr."""
    return float(np.float32(x))


def train_seed(seed: int, mesh: Optional[pm.Mesh] = None) -> int:
    """The training generator's seed on this rank: ``seed`` on data rank 0
    (and without a mesh), one of its own on every other data rank."""
    return seed + (mesh.data_rank * DATA_RANK_STREAM if mesh is not None else 0)


def create_train_state(cfg: Config, model: VMMTModel,
                       mesh: Optional[pm.Mesh] = None) -> TrainState:
    """The state of a run that starts at ``model``'s parameters: with
    ``param_init > 0`` every tensor is redrawn uniform(-r, r) first (a
    vocab-sharded one drawn at its full shape and sliced, so that every
    rank holds its shard of the single-process draw)."""
    named = list(model.named_parameters())
    params = [p for _, p in named]
    device = params[0].device
    if cfg.train.param_init > 0:
        r = cfg.train.param_init
        g = torch.Generator(device=device).manual_seed(cfg.train.seed + PARAM_INIT_STREAM)
        with torch.no_grad():
            for name, p in named:
                vm = model.vocab_mesh
                axis = None if vm is None else tp.shard_axis(name, p.dim())
                if axis is None:
                    p.uniform_(-r, r, generator=g)
                    continue
                full = list(p.shape)
                full[axis] *= vm.n_model
                p.copy_(tp.shard_tensor(name, torch.empty(full, device=device)
                                        .uniform_(-r, r, generator=g), vm))
    return TrainState(
        model=model, opt_state=Optimizer(cfg.train).init(params), step=0,
        lr=f32(cfg.train.learning_rate),
        ema=[p.detach().clone() for p in params] if cfg.train.ema_decay > 0 else None,
        generator=torch.Generator(device=device).manual_seed(train_seed(cfg.train.seed, mesh)))



def batch_tensors(batch: Union[Batch, PackedBatch], device: torch.device,
                  table: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (ids and positions int64, masks
    and image features f32; ``data/prefetch.py`` ``host_tensors``), copied
    on this thread. With ``table`` (image features on the device), img is
    its rows at ``batch.indices``, zero on padding rows or segments. The
    ``Trainer`` gets the same tensors through the prefetcher."""
    out = host_tensors(batch, with_indices=table is not None)
    return gather_features({k: v.to(device, non_blocking=True) for k, v in out.items()}, table)


def host_batches(train_iter: Iterable, epoch: int = 0) -> Iterator[Union[Batch, PackedBatch]]:
    """The training stream from ``epoch`` on: a BucketIterator or
    PackedBucketIterator epoch after epoch, anything else re-iterated when
    exhausted. Holds no reference to a Trainer, so a dropped Trainer's
    prefetch worker ends."""
    epochs = getattr(train_iter, "epoch", None)
    while True:
        n = 0
        for n, batch in enumerate(epochs(epoch) if epochs else train_iter, 1):
            yield batch
        if n == 0:
            raise ValueError("the training data gave no batch")
        epoch += 1


def loss_and_grads(cfg: Config, model: VMMTModel, batch: Dict[str, torch.Tensor], step: int,
                   generator: Optional[torch.Generator], deterministic: bool = False,
                   sample: bool = True, mesh: Optional[pm.Mesh] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List[torch.Tensor]]:
    """Forward, loss and backward of one batch: (loss, metrics, one f32
    gradient per ``model.parameters()`` entry, zeros where none flowed).
    With ``train.pack`` the batch is a packed one and every per-sentence
    tensor flows flattened (B*K, ...), one row a segment. With ``mesh`` the
    batch is this data rank's rows and the loss is divided by the
    sentence count of all of them (the gradients are this rank's part of
    the global batch's sum; metrics local)."""
    packed = "seg_mask" in batch
    if packed != cfg.train.pack:
        raise ValueError(f"train.pack={cfg.train.pack} but the batch is "
                         f"{'' if packed else 'not '}packed")
    model.zero_grad(set_to_none=True)
    img = batch.get("img")
    gen = model.generator_params() if cfg.model.fused_ce else None
    vm = model.vocab_mesh
    n_sents = None
    if mesh is not None:
        n_sents = pm.all_reduce(batch["seg_mask" if packed else "example_mask"].sum().float(),
                                mesh.data_group)
    if packed:
        out = model.forward_packed(
            batch["src"], batch["tgt_in"], batch["src_seg"], batch["tgt_seg"],
            batch["seg_first"], batch["seg_last"], img, deterministic=deterministic,
            sample=sample, tgt_out=batch["tgt_out"], generator=generator)
        n = batch["seg_mask"].numel()
        loss, metrics = compute_loss(
            out, batch["tgt_out"], batch["seg_mask"].reshape(-1),
            None if img is None else img.reshape((n,) + img.shape[2:]), cfg.model, cfg.train,
            step, generator_params=gen, tgt_seg=batch["tgt_seg"], mesh=vm, n_sents=n_sents)
    else:
        out = model(batch["src"], batch["tgt_in"], img, deterministic=deterministic,
                    sample=sample, tgt_out=batch["tgt_out"], generator=generator)
        loss, metrics = compute_loss(out, batch["tgt_out"], batch["example_mask"], img,
                                     cfg.model, cfg.train, step, generator_params=gen, mesh=vm,
                                     n_sents=n_sents)
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in model.parameters()]
    return loss, metrics, grads


def frozen_tables(cfg: Config, names: Sequence[str]) -> List[int]:
    """Indices in ``names`` of the embedding tables that
    ``fix_word_vecs_enc`` / ``fix_word_vecs_dec`` freeze (JAX :196-203)."""
    t = cfg.train
    if cfg.model.share_embeddings:
        frozen = ["tgt_embed.embedding"] if (t.fix_word_vecs_enc or t.fix_word_vecs_dec) else []
    else:
        frozen = (["src_embed.embedding"] if t.fix_word_vecs_enc else []) + (
            ["tgt_embed.embedding"] if t.fix_word_vecs_dec else [])
    return [i for i, n in enumerate(names) if n in frozen]


def _where_tree(ok: torch.Tensor, new: Dict[str, object], old: Dict[str, object]):
    return {k: ([torch.where(ok, a, b) for a, b in zip(v, old[k])] if isinstance(v, list)
                else torch.where(ok, v, old[k])) for k, v in new.items()}


def make_train_step(cfg: Config, deterministic: bool = False, sample: bool = True,
                    mesh: Optional[pm.Mesh] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor], Optional[torch.Generator]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """One optimizer step: (state, batch tensors, generator) -> (state,
    metrics on the device). ``deterministic`` / ``sample`` as in
    ``VMMTModel.forward`` (training uses the defaults; checks use
    deterministic=True, sample=False). With ``mesh`` the batch is this
    data rank's rows and ``state.model`` its shard (module docstring); the
    metrics are this rank's sums."""
    tc = cfg.train
    opt = Optimizer(tc)
    accum = max(1, tc.grad_accum)

    def grads_of(state, batch, generator):
        run = lambda b: loss_and_grads(cfg, state.model, b, state.step, generator,  # noqa: E731
                                       deterministic, sample, mesh)[1:]
        if accum == 1:
            return run(batch)
        B = batch["src"].shape[0]
        if B % accum:
            raise ValueError(f"batch of {B} rows is not divisible by grad_accum ({accum})")
        m = B // accum
        grads, parts = None, []
        for i in range(accum):
            metrics, g = run({k: v[i * m:(i + 1) * m] for k, v in batch.items()})
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            parts.append(metrics)
        metrics = dict(parts[0])
        for part in parts[1:]:
            metrics = {k: v + part[k] for k, v in metrics.items()}
        for k in ("beta", "loss"):
            metrics[k] = metrics[k] / accum
        return metrics, [g / accum for g in grads]

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator]):
        named = list(state.model.named_parameters())
        params = [p for _, p in named]
        frozen = frozen_tables(cfg, [n for n, _ in named])
        metrics, grads = grads_of(state, batch, generator)
        if mesh is not None:
            grads = pm.all_reduce_list(grads, mesh.data_group)
        for i in frozen:
            grads[i] = torch.zeros_like(grads[i])
        if state.model.vocab_mesh is not None:
            gnorm = tp.global_norm(grads, [n for n, _ in named], state.model.vocab_mesh)
        else:
            gnorm = global_norm(grads)
        updates, new_opt = opt.update(grads, state.opt_state, gnorm)
        for i in frozen:
            updates[i] = torch.zeros_like(updates[i])
        ok = torch.isfinite(gnorm) if tc.skip_nonfinite else None
        with torch.no_grad():
            for p, u in zip(params, updates):
                new = p - state.lr * u.to(p.dtype)
                p.copy_(new if ok is None else torch.where(ok, new, p))
            state.opt_state = new_opt if ok is None else _where_tree(ok, new_opt,
                                                                      state.opt_state)
            if tc.ema_decay > 0:
                d = np.float32(tc.ema_decay)
                if tc.ema_ramp:
                    n = np.float32(state.step + 1)
                    d = min(d, (np.float32(1.0) + n) / (np.float32(10.0) + n))
                if ok is None:
                    d_eff, one_minus = float(d), float(np.float32(1.0) - d)
                else:
                    d_eff = torch.where(ok, torch.tensor(d, device=gnorm.device),
                                        torch.ones((), device=gnorm.device))
                    one_minus = 1.0 - d_eff
                state.ema = [(d_eff * e.float() + one_minus * p.float()).to(e.dtype)
                             for e, p in zip(state.ema, params)]
        state.step += 1
        metrics["skipped_sum"] = ((~ok).float() if ok is not None
                                  else torch.zeros((), device=gnorm.device))
        metrics["grad_norm"] = gnorm
        return state, metrics

    return train_step


@torch.no_grad()
def eval_metrics(cfg: Config, model: VMMTModel, batch: Dict[str, torch.Tensor],
                 step: int) -> Dict[str, torch.Tensor]:
    """Validation forward of one unpacked batch (JAX :343-366):
    deterministic, z = the posterior mean; the loss's metric sums."""
    img = batch.get("img")
    out = model(batch["src"], batch["tgt_in"], img, deterministic=True, sample=False,
                tgt_out=batch["tgt_out"])
    gen = model.generator_params() if cfg.model.fused_ce else None
    return compute_loss(out, batch["tgt_out"], batch["example_mask"], img, cfg.model,
                        cfg.train, step, generator_params=gen, mesh=model.vocab_mesh)[1]


def check_mesh(cfg: Config, mesh: pm.Mesh) -> None:
    """JAX's checks of a mesh against the config (:405-432): the batch and
    each micro-batch divide over the data shards, the vocab over the model
    shards, and the config's shard counts (0: any) match the mesh."""
    n_dev = mesh.n_data
    if cfg.train.batch_size % n_dev != 0:
        raise ValueError(
            f"batch_size ({cfg.train.batch_size}) must be divisible by the "
            f"number of data-parallel devices ({n_dev}); pick e.g. "
            f"{(cfg.train.batch_size // n_dev + 1) * n_dev}")
    accum = max(1, cfg.train.grad_accum)
    if (cfg.train.batch_size // accum) % n_dev != 0:
        raise ValueError(
            f"each micro-batch (batch_size // grad_accum = "
            f"{cfg.train.batch_size // accum}) must be divisible by the "
            f"number of data-parallel devices ({n_dev})")
    tp.validate_tp_divisibility(cfg.model, mesh.n_model)
    for what, want, got in (("num_data_shards", cfg.train.num_data_shards, mesh.n_data),
                            ("num_model_shards", cfg.train.num_model_shards, mesh.n_model)):
        if want > 1 and want != got:
            raise ValueError(f"train.{what}={want} but the mesh has {got}")


def crossed(prev: int, cur: int, interval: int) -> bool:
    """True once whenever the step count crosses a multiple of
    ``interval`` (any resumed offset)."""
    return interval > 0 and cur // interval > prev // interval


class Trainer:
    """The training loop on ``device`` (cuda unless ``device='cpu'``,
    raising without CUDA).

    ``train_iter`` is an iterable of Batch, or of PackedBatch with
    ``train.pack``; a BucketIterator or PackedBucketIterator runs epoch
    after epoch, anything else is re-iterated when exhausted.
    ``valid_iter`` (unpacked batches), ``checkpoint_fn(state, step, {})``,
    ``metrics_logger`` (utils/metrics_log.py) and ``bleu_fn(state) -> BLEU``
    are optional, as in JAX. ``train_feats`` / ``valid_feats``: the image
    features of the two corpora, held on the device; the iterators then
    carry none and each batch gathers its rows by ``batch.indices``.
    ``valid_iw`` K > 0: validation also reports the K-sample IW-ELBO bound
    ``iw_elbo`` (latent models; decode/iw_eval.py).

    ``mesh`` (parallel/mesh.py): every rank of it runs a Trainer over the
    same iterators, each taking its data shard's rows of every batch, on
    ``mesh.device``. ``model`` holds the full parameters (the same on every
    rank) or this rank's shard; ``self.model`` is the shard.
    ``checkpoint_fn`` runs on every rank (the checkpoint's gather is a
    collective: ``save_checkpoint(..., mesh=)``); ``metrics_logger`` and
    the prints are rank 0's."""

    def __init__(self, cfg: Config, model: VMMTModel, train_iter: Iterable,
                 valid_iter: Optional[Iterable] = None, device=None,
                 checkpoint_fn: Optional[Callable[[TrainState, int, Dict], None]] = None,
                 metrics_logger=None, bleu_fn: Optional[Callable[[TrainState], float]] = None,
                 train_feats: Optional[np.ndarray] = None,
                 valid_feats: Optional[np.ndarray] = None, valid_iw: int = 0,
                 mesh: Optional[pm.Mesh] = None):
        cfg.train.check_supported()
        accum = max(1, cfg.train.grad_accum)
        if cfg.train.batch_size % accum:
            raise ValueError(f"batch_size ({cfg.train.batch_size}) must be divisible by "
                             f"grad_accum ({accum})")
        if mesh is None:
            if cfg.train.num_data_shards > 1 or cfg.train.num_model_shards > 1:
                raise ValueError(
                    f"train.num_data_shards={cfg.train.num_data_shards}, num_model_shards="
                    f"{cfg.train.num_model_shards} need a mesh: pass "
                    "mesh=parallel.make_mesh(...) on every rank (torchrun)")
        else:
            check_mesh(cfg, mesh)
            device = mesh.device if device is None else device
        self.cfg = cfg
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.device = resolve_device(device)
        self.model = shard_model(model.to(self.device), mesh) if mesh is not None else \
            model.to(self.device)
        self.train_iter = train_iter
        self.valid_iter = valid_iter
        self.checkpoint_fn = checkpoint_fn
        self.metrics_logger = metrics_logger
        self.bleu_fn = bleu_fn
        table = lambda f: None if f is None else torch.as_tensor(  # noqa: E731
            np.asarray(f, np.float32)).to(self.device)
        self._train_table, self._valid_table = table(train_feats), table(valid_feats)
        self.state = create_train_state(cfg, self.model, mesh)
        self.train_step = make_train_step(cfg, mesh=mesh)
        self.scheduler = PlateauScheduler(cfg.train)
        self.valid_iw = valid_iw
        self._iw_fn = None
        if valid_iw > 0 and model.is_latent:
            from variational_mmt_torch.decode.iw_eval import make_iw_elbo_fn

            self._iw_fn = make_iw_elbo_fn(self.model, valid_iw)
        self.history: List[Dict[str, float]] = []  # one record a validation
        self.final_state: Optional[TrainState] = None
        # the last run's steps, metrics and seconds: in all, and in validation
        # and checkpoints
        self.last_run: Dict[str, object] = {}
        self._batches: Optional[Iterator[Dict[str, torch.Tensor]]] = None

    def _next_batch(self) -> Dict[str, torch.Tensor]:
        """The next training batch on the device, from the prefetcher
        (started at epoch 0 on first use)."""
        if self._batches is None:
            self._batches = device_batches(host_batches(self.train_iter), self.device,
                                           self._train_table, mesh=self.mesh)
        return next(self._batches)

    def close(self) -> None:
        """End the training stream's prefetch worker (the next step starts
        the data again at epoch 0)."""
        if self._batches is not None:
            self._batches.close()
            self._batches = None

    def train(self, max_steps: Optional[int] = None) -> List[Dict[str, float]]:
        """Take ``max_steps`` more steps (default ``train.max_steps``) from
        the current state, the data going on where it stopped; returns each
        step's metrics as floats, read from the device once, at the end
        (and at any report, validation or checkpoint on the way)."""
        n = self.cfg.train.max_steps if max_steps is None else max_steps
        return self._run(self.state.step + n)[1]

    def train_from(self, state: Optional[TrainState] = None,
                   max_steps: Optional[int] = None) -> Statistics:
        """Run until the step count reaches ``max_steps`` (default
        ``train.max_steps``) from ``state`` (default: this trainer's; a
        loaded one for ``-train_from``, whose model must be this
        trainer's), the data starting again at epoch 0 (JAX :546-661).
        The EMA follows this run's config: seeded from the params, or
        dropped."""
        state = self.state if state is None else state
        if state.model is not self.model:
            raise ValueError("train_from: the state's model is not this trainer's")
        if self.cfg.train.ema_decay > 0 and state.ema is None:
            state.ema = [p.detach().clone() for p in self.model.parameters()]
        elif self.cfg.train.ema_decay <= 0:
            state.ema = None
        if state.generator is None:
            state.generator = torch.Generator(device=self.device).manual_seed(
                train_seed(self.cfg.train.seed, self.mesh))
        self.state = state
        self.close()
        return self._run(max_steps or self.cfg.train.max_steps)[0]

    def _run(self, max_steps: int) -> Tuple[Statistics, List[Dict[str, float]]]:
        cfg = self.cfg.train
        stats = Statistics()
        pending: List[Dict[str, torch.Tensor]] = []
        done: List[Dict[str, float]] = []
        skipped = 0
        last: Dict[str, float] = {}

        def flush():
            # one transfer for every step since the last read
            nonlocal skipped, last
            if not pending:
                return
            rows = torch.stack([torch.stack([m[k].detach().float() for k in METRIC_KEYS])
                                for m in pending])
            if self.mesh is not None:  # the sums over every data rank's rows
                cols = [METRIC_KEYS.index(k) for k in SUMMED_KEYS]
                rows[:, cols] = pm.all_reduce(rows[:, cols].contiguous(), self.mesh.data_group)
            rows = rows.cpu().tolist()
            pending.clear()
            for row in rows:
                m = dict(zip(METRIC_KEYS, row))
                skipped += int(m["skipped_sum"])
                stats.update(loss=m["ce_sum"], n_words=int(m["n_tokens"]),
                             n_correct=int(m["n_correct"]), n_sents=int(m["n_sents"]),
                             kl=m["kl_sum"], img_loss=m["img_loss_sum"])
                done.append(m)
            last = done[-1]

        step = first = self.state.step
        t0 = time.perf_counter()
        side = {"validation": 0.0, "checkpoint": 0.0}
        while step < max_steps:
            batch = self._next_batch()
            self.state, metrics = self.train_step(self.state, batch, self.state.generator)
            prev, step = step, self.state.step
            pending.append(metrics)
            if len(pending) >= 512:  # bound device memory between reads
                flush()
            if crossed(prev, step, cfg.report_every):
                flush()
                if self.is_main:
                    stats.output(step, max_steps, beta=last["beta"], lr=self.state.lr)
                if skipped and self.is_main:
                    print(f"  ({skipped} non-finite update(s) skipped so far)")
                if self.metrics_logger is not None and self.is_main:
                    self.metrics_logger.log(
                        step, {**stats.scalars(), "beta": last["beta"], "lr": self.state.lr,
                               "grad_norm": last["grad_norm"], "skipped_updates": skipped},
                        prefix="train")
            if self.valid_iter is not None and crossed(prev, step, cfg.valid_every):
                flush()
                t1 = time.perf_counter()
                self._validation(step)
                side["validation"] += time.perf_counter() - t1
            if self.checkpoint_fn is not None and crossed(prev, step, cfg.checkpoint_every):
                flush()
                t1 = time.perf_counter()
                self.checkpoint_fn(self.state, step, {})
                side["checkpoint"] += time.perf_counter() - t1
        flush()
        self.final_state = self.state
        self.last_run = {"steps": step - first, "metrics": done,
                         "seconds": time.perf_counter() - t0,
                         "validation_seconds": side["validation"],
                         "checkpoint_seconds": side["checkpoint"]}
        return stats, done

    def _validation(self, step: int) -> None:
        val = self.validate(self.state)
        if self.bleu_fn is not None:
            val["bleu"] = self.bleu_fn(self.state)
            if self.is_main:
                print(f"validation greedy BLEU: {val['bleu']:.2f}")
        new_lr = f32(self.scheduler.update(val["ppl"], step, self.state.lr))
        if new_lr != self.state.lr:
            if self.is_main:
                print(f"validation ppl {val['ppl']:.3f} plateau -> lr {new_lr:.2e}")
            self.state.lr = new_lr
        self.history.append({"step": step, **val})
        if self.metrics_logger is not None and self.is_main:
            self.metrics_logger.log(step, val, prefix="valid")

    def validate(self, state: Optional[TrainState] = None) -> Dict[str, float]:
        """ppl, xent, accuracy, kl, img_loss and elbo over ``valid_iter``'s
        epoch 0 and, with ``valid_iw``, ``iw_elbo`` (JAX :663-691; the IW
        draws come from a generator seeded with ``train.seed``, the same at
        every validation, as JAX folds the batch index into its base key).
        With a mesh each rank evaluates its rows and the batch sums are
        all-reduced over the data group (the IW draws are the global
        batch's, each rank taking its rows')."""
        state = self.state if state is None else state
        keys = VALID_KEYS + (("iw_elbo_sum",) if self._iw_fn is not None else ())
        gen = None
        if self._iw_fn is not None:
            gen = torch.Generator(device=self.device).manual_seed(self.cfg.train.seed)
        rows = []
        for bt in device_batches(self.valid_iter.epoch(0), self.device, self._valid_table,
                                 mesh=self.mesh):
            m = eval_metrics(self.cfg, state.model, bt, state.step)
            if self._iw_fn is not None:
                mine = None
                if self.mesh is not None:  # this rank's rows of the global batch
                    n = bt["src"].shape[0] * self.mesh.n_data
                    mine = (pm.data_rows(n, self.mesh), n)
                m["iw_elbo_sum"] = self._iw_fn(bt, gen, rows=mine)["iw_elbo_sum"]
            rows.append(torch.stack([m[k].float() for k in keys]))
        rows = torch.stack(rows) if rows else None
        if rows is not None and self.mesh is not None:
            pm.all_reduce(rows, self.mesh.data_group)
        # one transfer; batch sums added on the host, in float64, as JAX does
        agg = dict.fromkeys(keys, 0.0)
        for row in (rows.cpu().tolist() if rows is not None else []):
            for k, v in zip(keys, row):
                agg[k] += v
        xent = agg["ce_sum"] / max(1.0, agg["n_tokens"])
        n_sents = max(1.0, agg["n_sents"])
        out = {"ppl": math.exp(min(xent, 100.0)), "xent": xent,
               "accuracy": 100.0 * agg["n_correct"] / max(1.0, agg["n_tokens"]),
               "kl": agg["kl_sum"] / n_sents, "img_loss": agg["img_loss_sum"] / n_sents,
               "elbo": -(agg["ce_sum"] + agg["kl_sum"]) / n_sents}
        if self._iw_fn is not None:
            out["iw_elbo"] = agg["iw_elbo_sum"] / n_sents
        return out
