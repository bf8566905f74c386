"""Training loop. Mirrors ``variational_mmt_tpu/train/trainer.py``: one
optimizer step is forward (encoder, q, prior, z, decoder, generator), ELBO,
backward, global-norm clipping and the Adam update with the lr as a
separate scalar (:114-264), without gradient accumulation, EMA or the
non-finite skip (they raise, TrainConfig.check_supported). With
``train.pack`` the batches are sequence-packed (data/packing.py) and the
step runs ``VMMTModel.forward_packed`` (:121-144). JAX's
``jit``/``lax.scan`` dispatch, the mesh and the prefetcher have no
counterpart: the step runs eagerly on one device, the kernels of
``use_pallas`` / ``pallas_decoder`` doing the recurrences. Randomness comes
from one ``torch.Generator`` on the device, seeded from ``train.seed``.
Validation, checkpoints and the CLI are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from variational_mmt_torch.config import Config
from variational_mmt_torch.data.dataset import Batch
from variational_mmt_torch.data.packing import PackedBatch
from variational_mmt_torch.device import resolve_device
from variational_mmt_torch.models.model import VMMTModel
from variational_mmt_torch.train.loss import compute_loss
from variational_mmt_torch.train.optim import Optimizer, global_norm


@dataclasses.dataclass
class TrainState:
    model: VMMTModel  # holds the parameters
    opt_state: Dict[str, object]
    step: int
    lr: float


def create_train_state(cfg: Config, model: VMMTModel) -> TrainState:
    opt = Optimizer(cfg.train)
    return TrainState(model=model, opt_state=opt.init(list(model.parameters())), step=0,
                      lr=cfg.train.learning_rate)


PACKED_IDS = ("src", "tgt_in", "tgt_out", "src_seg", "tgt_seg", "seg_first", "seg_last")


def batch_tensors(batch: Union[Batch, PackedBatch],
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (ids and positions int64, masks
    and image features f32). A PackedBatch gives src, tgt_in, tgt_out,
    src_seg, tgt_seg, seg_first, seg_last, seg_mask and img (B,K,D)."""
    if batch.tgt_in is None or batch.tgt_out is None:
        raise ValueError("a training batch needs tgt_in and tgt_out")
    if isinstance(batch, PackedBatch):
        out = {k: torch.from_numpy(np.asarray(getattr(batch, k))).long() for k in PACKED_IDS}
        out["seg_mask"] = torch.from_numpy(np.asarray(batch.seg_mask, np.float32))
    else:
        out = {"src": torch.from_numpy(np.asarray(batch.src)).long(),
               "tgt_in": torch.from_numpy(np.asarray(batch.tgt_in)).long(),
               "tgt_out": torch.from_numpy(np.asarray(batch.tgt_out)).long(),
               "example_mask": torch.from_numpy(np.asarray(batch.example_mask, np.float32))}
    if batch.img is not None:
        out["img"] = torch.from_numpy(np.asarray(batch.img, np.float32))
    return {k: v.to(device, non_blocking=True) for k, v in out.items()}


def loss_and_grads(cfg: Config, model: VMMTModel, batch: Dict[str, torch.Tensor], step: int,
                   generator: Optional[torch.Generator], deterministic: bool = False,
                   sample: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List[torch.Tensor]]:
    """Forward, loss and backward of one batch: (loss, metrics, one f32
    gradient per ``model.parameters()`` entry, zeros where none flowed).
    With ``train.pack`` the batch is a packed one and every per-sentence
    tensor flows flattened (B*K, ...), one row a segment."""
    packed = "seg_mask" in batch
    if packed != cfg.train.pack:
        raise ValueError(f"train.pack={cfg.train.pack} but the batch is "
                         f"{'' if packed else 'not '}packed")
    model.zero_grad(set_to_none=True)
    img = batch.get("img")
    gen = model.generator_params() if cfg.model.fused_ce else None
    if packed:
        out = model.forward_packed(
            batch["src"], batch["tgt_in"], batch["src_seg"], batch["tgt_seg"],
            batch["seg_first"], batch["seg_last"], img, deterministic=deterministic,
            sample=sample, tgt_out=batch["tgt_out"], generator=generator)
        n = batch["seg_mask"].numel()
        loss, metrics = compute_loss(
            out, batch["tgt_out"], batch["seg_mask"].reshape(-1),
            None if img is None else img.reshape((n,) + img.shape[2:]), cfg.model, cfg.train,
            step, generator_params=gen, tgt_seg=batch["tgt_seg"])
    else:
        out = model(batch["src"], batch["tgt_in"], img, deterministic=deterministic,
                    sample=sample, tgt_out=batch["tgt_out"], generator=generator)
        loss, metrics = compute_loss(out, batch["tgt_out"], batch["example_mask"], img,
                                     cfg.model, cfg.train, step, generator_params=gen)
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in model.parameters()]
    return loss, metrics, grads


def make_train_step(cfg: Config, deterministic: bool = False, sample: bool = True
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor], Optional[torch.Generator]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """One optimizer step: (state, batch tensors, generator) -> (state,
    metrics). ``deterministic`` / ``sample`` as in ``VMMTModel.forward``
    (training uses the defaults; checks use deterministic=True,
    sample=False)."""
    opt = Optimizer(cfg.train)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator]):
        params = list(state.model.parameters())
        _, metrics, grads = loss_and_grads(cfg, state.model, batch, state.step, generator,
                                           deterministic, sample)
        gnorm = global_norm(grads)
        updates, state.opt_state = opt.update(grads, state.opt_state, gnorm)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.sub_(state.lr * u.to(p.dtype))
        state.step += 1
        metrics["grad_norm"] = gnorm
        return state, metrics

    return train_step


class Trainer:
    """``train(max_steps)`` takes optimizer steps over ``train_iter`` (an
    iterable of Batch, or of PackedBatch with ``train.pack``, re-iterated
    when exhausted; a BucketIterator or PackedBucketIterator runs epoch
    after epoch) on ``device``: cuda unless ``device='cpu'``, raising
    without CUDA."""

    def __init__(self, cfg: Config, model: VMMTModel, train_iter: Iterable,
                 device=None):
        cfg.train.check_supported()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.train_iter = train_iter
        self.state = create_train_state(cfg, self.model)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        self.train_step = make_train_step(cfg)
        self.history: List[Dict[str, float]] = []
        self._epoch = 0
        self._it = None

    def _next_batch(self) -> Union[Batch, PackedBatch]:
        while True:
            if self._it is None:
                epoch = getattr(self.train_iter, "epoch", None)
                self._it = iter(epoch(self._epoch) if epoch else self.train_iter)
                self._epoch += 1
            batch = next(self._it, None)
            if batch is not None:
                return batch
            self._it = None

    def train(self, max_steps: Optional[int] = None) -> List[Dict[str, float]]:
        """Take ``max_steps`` steps (default ``train.max_steps``); returns
        their metrics as floats (one host sync per step)."""
        n = self.cfg.train.max_steps if max_steps is None else max_steps
        done = []
        for _ in range(n):
            batch = batch_tensors(self._next_batch(), self.device)
            self.state, metrics = self.train_step(self.state, batch, self.generator)
            done.append({k: float(v.detach()) for k, v in metrics.items()})
        self.history.extend(done)
        return done
