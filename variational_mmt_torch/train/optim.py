"""Optimizer. Mirrors ``variational_mmt_tpu/train/optim.py``: the update
rule of optax ``clip_by_global_norm`` (when ``max_grad_norm > 0``)
followed by ``scale_by_adam``, ``scale_by_adadelta`` (rho 0.9, eps 1e-6),
``scale_by_rss`` with the accumulator starting at 0 (adagrad, eps 1e-7),
or nothing (sgd): a direction only. The caller applies ``-lr * update``
with the lr kept as a separate scalar (trainer.py:236-240), so plateau
decay rewrites one number. Not ``torch.nn.utils.clip_grad_norm_`` (it adds
1e-6 to the norm) and not ``torch.optim`` (it folds the lr into the
update): the optax arithmetic, step for step. Adam's step count is an
int32 tensor on the device, so that a skipped step (``skip_nonfinite``)
can keep it without a host sync; its bias corrections are computed there
in f32, as optax computes them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from variational_mmt_torch.config import TrainConfig

# each optimizer's optax state fields, in order (checkpoint.py lays them out)
STATE_FIELDS = {"adam": ("count", "mu", "nu"), "adadelta": ("e_g", "e_x"),
                "adagrad": ("sum_of_squares",), "sgd": ()}
ADADELTA_RHO, ADADELTA_EPS, ADAGRAD_EPS, ADAM_EPS = 0.9, 1e-6, 1e-7, 1e-8


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


class Optimizer:
    """Direction-only transform over a list of tensors: ``init(params)``
    gives the state, ``update(grads, state)`` gives (updates, new state).
    The state holds the fields of ``STATE_FIELDS[optimizer]``: a count
    tensor, or one f32 tensor a parameter."""

    def __init__(self, cfg: TrainConfig):
        if cfg.optimizer not in STATE_FIELDS:
            raise ValueError(f"unknown optimizer: {cfg.optimizer}")
        self.cfg = cfg

    def init(self, params: List[torch.Tensor]) -> Dict[str, object]:
        state: Dict[str, object] = {}
        for name in STATE_FIELDS[self.cfg.optimizer]:
            if name == "count":
                state[name] = torch.zeros((), dtype=torch.int32, device=params[0].device)
            else:
                state[name] = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return state

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
        if cfg.optimizer == "adam":
            b1, b2 = cfg.adam_beta1, cfg.adam_beta2
            count = state["count"] + 1
            cf = count.float()
            c1 = 1.0 - torch.full_like(cf, b1) ** cf
            c2 = 1.0 - torch.full_like(cf, b2) ** cf
            mu = [(1.0 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
            nu = [(1.0 - b2) * g * g + b2 * v for g, v in zip(grads, state["nu"])]
            updates = [(m / c1) / (torch.sqrt(v / c2) + ADAM_EPS) for m, v in zip(mu, nu)]
            return updates, {"count": count, "mu": mu, "nu": nu}
        if cfg.optimizer == "adadelta":
            rho, eps = ADADELTA_RHO, ADADELTA_EPS
            e_g = [(1.0 - rho) * (g * g) + rho * e for g, e in zip(grads, state["e_g"])]
            updates = [torch.sqrt(x + eps) / torch.sqrt(e + eps) * g
                       for g, e, x in zip(grads, e_g, state["e_x"])]
            e_x = [(1.0 - rho) * (u * u) + rho * x for u, x in zip(updates, state["e_x"])]
            return updates, {"e_g": e_g, "e_x": e_x}
        if cfg.optimizer == "adagrad":
            sos = [g * g + s for g, s in zip(grads, state["sum_of_squares"])]
            updates = [torch.where(s > 0, torch.rsqrt(s + ADAGRAD_EPS), 0.0) * g
                       for g, s in zip(grads, sos)]
            return updates, {"sum_of_squares": sos}
        return grads, state  # sgd: the (clipped) gradient


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
