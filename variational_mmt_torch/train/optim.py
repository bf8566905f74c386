"""Optimizer. Mirrors ``variational_mmt_tpu/train/optim.py``: the update
rule of optax ``clip_by_global_norm`` followed by ``scale_by_adam`` (or
the raw clipped gradient for sgd), a direction only; the caller applies
``-lr * update`` with the lr kept as a separate scalar (trainer.py:236-240),
so plateau decay rewrites one number. Not ``torch.nn.utils.clip_grad_norm_``
(it adds 1e-6 to the norm) and not ``torch.optim.Adam`` (it folds the lr
into the update): the optax arithmetic, step for step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from variational_mmt_torch.config import TrainConfig


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


class Optimizer:
    """Direction-only transform over a list of tensors: ``init(params)``
    gives the state, ``update(grads, state)`` gives (updates, new state)."""

    def __init__(self, cfg: TrainConfig):
        if cfg.optimizer not in ("adam", "sgd"):
            raise NotImplementedError(f"optimizer={cfg.optimizer} is not ported yet "
                                      "(adam and sgd are)")
        self.cfg = cfg
        self.eps = 1e-8

    def init(self, params: List[torch.Tensor]) -> Dict[str, object]:
        if self.cfg.optimizer == "sgd":
            return {}
        return {"count": 0, "mu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
                "nu": [torch.zeros_like(p, dtype=torch.float32) for p in params]}

    def update(self, grads: List[torch.Tensor], state: Dict[str, object],
               g_norm: Optional[torch.Tensor] = None
               ) -> Tuple[List[torch.Tensor], Dict[str, object]]:
        cfg = self.cfg
        if cfg.max_grad_norm > 0:
            # optax clip_by_global_norm: t, or t / norm * max_norm when
            # norm >= max_norm
            norm = global_norm(grads) if g_norm is None else g_norm
            keep = norm < cfg.max_grad_norm
            grads = [torch.where(keep, g, g / norm * cfg.max_grad_norm) for g in grads]
        if cfg.optimizer == "sgd":
            return grads, state
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        count = state["count"] + 1
        c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        mu = [(1.0 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
        nu = [(1.0 - b2) * g * g + b2 * v for g, v in zip(grads, state["nu"])]
        updates = [(m / c1) / (torch.sqrt(v / c2) + self.eps) for m, v in zip(mu, nu)]
        return updates, {"count": count, "mu": mu, "nu": nu}


class PlateauScheduler:
    """Host-side plateau logic (the reference's Optim.update_learning_rate):
    decay latches on when the validation metric worsens against the
    previous validation, or once past ``start_decay_at``; after latching,
    every validation decays."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.last: Optional[float] = None
        self.start_decay = False

    def update(self, val_metric: float, step: int, lr: float) -> float:
        if self.cfg.start_decay_at > 0 and step >= self.cfg.start_decay_at:
            self.start_decay = True
        if self.last is not None and val_metric > self.last:
            self.start_decay = True
        self.last = val_metric
        return lr * self.cfg.lr_decay if self.start_decay else lr
