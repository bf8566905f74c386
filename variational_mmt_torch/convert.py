"""Parameters across frameworks.

``params_from_jax`` turns a JAX parameter tree (nested dicts of arrays, as
``variational_mmt_tpu.models.model.init_params`` or a checkpoint's params
give it) into the port's ``state_dict``; ``params_to_jax`` is its inverse
and ``grads_to_jax`` lays the parameters' gradients out the same way.
The port keeps the JAX layouts (Dense kernels ``(in, out)``, ``[r|z|n]``
GRU and ``[i|f|g|o]`` LSTM gate blocks, ``hh_kernel (H, 3H)`` or ``(H,
4H)``), so the conversion only renames: the tree path
``decoder/step/attn/linear_in/kernel`` is the parameter
``decoder.step.attn.linear_in.kernel``. The parameters a configuration has
(mlp attention's four Dense layers, dot's missing ``linear_in``, no
``ih_feed`` without input feed, ``region_pool`` under ``img_pool='attn'``,
an LSTM bridge of ``(2H + Z, H)``) follow from the model, so every leaf
must map to a parameter of the same shape and every parameter must have a
leaf.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from variational_mmt_torch.config import ModelConfig
from variational_mmt_torch.models.model import param_shapes


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """Nested dicts -> {dotted path: leaf}."""
    flat: Dict[str, object] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten(v, path + "."))
        else:
            flat[path] = v
    return flat


def unflatten(flat: Mapping[str, object]) -> dict:
    """{dotted path: leaf} -> nested dicts."""
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def params_from_jax(tree: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX parameter tree -> the port's state_dict (f32 CPU tensors)."""
    flat = flatten(tree)
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing}, unexpected {extra}")
    out = {}
    for name, shape in want.items():
        arr = np.array(flat[name], dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape} != {shape}")
        out[name] = torch.from_numpy(arr)
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's state_dict -> a JAX-layout tree of numpy f32 arrays."""
    return unflatten({k: v.detach().float().cpu().numpy() for k, v in state_dict.items()})


def grads_to_jax(model: nn.Module) -> dict:
    """Every parameter's ``.grad`` as a JAX-layout tree of numpy f32 arrays
    (zeros where no gradient flowed), comparable leaf by leaf with
    ``jax.grad`` of the JAX model."""
    return unflatten({k: (torch.zeros_like(p) if p.grad is None else p.grad)
                      .detach().float().cpu().numpy()
                      for k, p in model.named_parameters()})
