"""Checkpoints in the JAX package's layout (``variational_mmt_tpu/train/
checkpoint.py``), so that either package loads the other's:

    <dir>/step_00000123/
        config.json      the full Config
        vocab.src.json   source vocab itos
        vocab.tgt.json   target vocab itos
        state.msgpack    {params, opt_state, step, lr, rng[, ema_params]}

written to ``step_NNNNNNNN.tmp`` and renamed, so that a partial write never
looks valid; the newest ``keep`` are kept. ``state.msgpack`` holds the
bytes ``flax.serialization.msgpack_serialize`` writes (train/msgpack_io.py):

- ``params`` and ``ema_params``: the JAX parameter tree (convert.py);
- ``opt_state``: optax's ``to_state_dict`` of the JAX optimizer's state,
  ``{"0": {}, "1": {count, mu, nu}}`` for clipping then Adam (no ``"0"``
  entry without clipping; the core state's fields are
  ``optim.STATE_FIELDS``);
- ``step`` int32, ``lr`` float32, ``rng`` JAX's base PRNG key of the seed
  (uint32[2]), all 0-d or 1-d arrays;
- ``torch_generator``, the port's ``torch.Generator`` state, so that a
  resume draws what the straight run would have. JAX's loader reads its
  keys by name and ignores this one; a JAX checkpoint has none, and the
  port then seeds the generator from ``train.seed``.

A released checkpoint (``release_checkpoint``) has no optimizer state and
loads with a fresh one.

Under a mesh (parallel/mesh.py) the file is the same, with full tensors,
so JAX and a single-process run read it: every rank joins the gather of
the vocab-sharded leaves (parameters, optimizer moments, EMA) over its
model group, rank 0 writes, and a barrier follows. ``torch_generators``
adds every data rank's generator state (one row a data rank;
``torch_generator`` is data rank 0's). Loading reads the file on every
rank and keeps its shard; a run that resumes with as many data ranks as
the checkpoint's takes its own generator state, any other reseeds each
data rank (``trainer.train_seed``) and says so.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from variational_mmt_torch.config import Config
from variational_mmt_torch.convert import flatten, params_from_jax, unflatten
from variational_mmt_torch.data.vocab import Vocab
from variational_mmt_torch.device import resolve_device
from variational_mmt_torch.models.model import VMMTModel, build_model
from variational_mmt_torch.parallel import mesh as pm, tp
from variational_mmt_torch.train import msgpack_io
from variational_mmt_torch.train.optim import STATE_FIELDS, Optimizer
from variational_mmt_torch.train.trainer import TrainState, f32, train_seed

_STEP_RE = re.compile(r"^step_(\d+)$")
GENERATOR_KEY = "torch_generator"
GENERATORS_KEY = "torch_generators"


def base_key(seed: int) -> np.ndarray:
    """JAX's ``PRNGKey(seed)`` (threefry): [seed >> 32, seed & 0xffffffff]."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _tree(names: List[str], tensors: List[torch.Tensor]) -> dict:
    return unflatten({n: t.detach().cpu().numpy() for n, t in zip(names, tensors)})


def _opt_core_index(cfg: Config) -> str:
    return "1" if cfg.train.max_grad_norm > 0 else "0"


def state_tree(state: TrainState, cfg: Config, mesh: Optional[pm.Mesh] = None) -> dict:
    """The tree that ``state.msgpack`` holds (module docstring); with
    ``mesh``, a collective that every rank must join."""
    names = [n for n, _ in state.model.named_parameters()]
    vm = state.model.vocab_mesh

    def full(tensors):
        return tp.gather_list(names, tensors, vm)

    core = {}
    for field in STATE_FIELDS[cfg.train.optimizer]:
        v = state.opt_state[field]
        core[field] = (np.asarray(int(v), np.int32) if field == "count"
                       else _tree(names, full(v)))
    parts = ([{}] if cfg.train.max_grad_norm > 0 else []) + (
        [core] if cfg.train.optimizer != "sgd" else [])
    raw = {"params": _tree(names, full([p for _, p in state.model.named_parameters()])),
           "opt_state": {str(i): p for i, p in enumerate(parts)},
           "step": np.asarray(state.step, np.int32), "lr": np.asarray(state.lr, np.float32),
           "rng": base_key(cfg.train.seed)}
    if state.ema is not None:
        raw["ema_params"] = _tree(names, full(state.ema))
    if state.generator is not None:
        raw[GENERATOR_KEY] = state.generator.get_state().numpy()
    if mesh is not None:
        # every data rank's state, model rank 0's of each (one model group
        # draws the same)
        ranks = pm.gather_objects((mesh.data_rank, mesh.model_rank, raw.get(GENERATOR_KEY)))
        states = [g for _, m, g in sorted(ranks, key=lambda r: r[:2]) if m == 0]
        if all(g is not None for g in states):
            raw[GENERATORS_KEY] = np.stack(states)
            raw[GENERATOR_KEY] = states[0]
    return raw


def save_checkpoint(ckpt_dir: str, state: TrainState, cfg: Config, src_vocab: Vocab,
                    tgt_vocab: Vocab, keep: int = 3, mesh: Optional[pm.Mesh] = None) -> str:
    """Write ``state`` as ``<ckpt_dir>/step_<step>`` and return the path.
    With ``mesh`` every rank must call it: the sharded leaves are gathered,
    rank 0 writes, and every rank waits for the write."""
    raw = state_tree(state, cfg, mesh)
    path = os.path.join(ckpt_dir, f"step_{state.step:08d}")
    if mesh is not None and not mesh.is_main:
        pm.barrier(mesh)
        return path
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "config.json"), "w") as f:
        f.write(cfg.to_json())
    src_vocab.save(os.path.join(tmp, "vocab.src.json"))
    tgt_vocab.save(os.path.join(tmp, "vocab.tgt.json"))
    with open(os.path.join(tmp, "state.msgpack"), "wb") as f:
        f.write(msgpack_io.packb(raw))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    _prune(ckpt_dir, keep)
    if mesh is not None:
        pm.barrier(mesh)
    return path


def _prune(ckpt_dir: str, keep: int) -> None:
    if keep <= 0:
        return
    for s in list_checkpoints(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def list_checkpoints(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_RE.match, os.listdir(ckpt_dir)) if m)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    steps = list_checkpoints(ckpt_dir)
    return os.path.join(ckpt_dir, f"step_{steps[-1]:08d}") if steps else None


def read_config(path: str) -> Config:
    with open(os.path.join(path, "config.json")) as f:
        return Config.from_json(f.read())


def read_state(path: str) -> dict:
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        return msgpack_io.unpackb(f.read())


def _f32(leaf) -> np.ndarray:
    """A float leaf as f32 numpy (bf16 leaves come as torch tensors)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.float().numpy()
    return np.asarray(leaf, np.float32)


def _tensors(tree: dict, names: List[str], device: torch.device,
             mesh: Optional[pm.Mesh] = None) -> List[torch.Tensor]:
    flat = flatten(tree)
    missing = sorted(set(names) - set(flat))
    if missing:
        raise KeyError(f"checkpoint tree lacks {missing}")
    return [tp.shard_tensor(n, torch.from_numpy(_f32(flat[n]).copy()), mesh).to(device)
            for n in names]


def load_state(path: str, model: VMMTModel, cfg: Config,
               mesh: Optional[pm.Mesh] = None) -> TrainState:
    """The TrainState of checkpoint ``path`` for ``model`` (whose parameters
    it overwrites): ``cfg``, the checkpoint's config, decides the optimizer
    state's layout and whether an EMA is kept. With ``mesh`` every rank
    reads the file; ``model`` is this rank's shard (``Trainer.model``) and
    the state holds this rank's shard of every tensor."""
    raw = read_state(path)
    device = next(model.parameters()).device
    vm = model.vocab_mesh
    model.load_state_dict(tp.shard_params(
        params_from_jax(_map_leaves(raw["params"], _f32), model.cfg), vm))
    named = list(model.named_parameters())
    names = [n for n, _ in named]
    params = [p for _, p in named]
    opt_state = Optimizer(cfg.train).init(params)
    if "opt_state" in raw:  # a released checkpoint has none: the optimizer restarts
        core = raw["opt_state"].get(_opt_core_index(cfg), {})
        for field in STATE_FIELDS[cfg.train.optimizer]:
            opt_state[field] = (torch.tensor(int(core[field]), dtype=torch.int32, device=device)
                                if field == "count" else _tensors(core[field], names, device, vm))
    ema = None
    if cfg.train.ema_decay > 0:
        ema = (_tensors(raw["ema_params"], names, device, vm) if "ema_params" in raw
               else [p.detach().clone() for p in params])
    generator = torch.Generator(device=device)
    states = raw.get(GENERATORS_KEY)
    if states is None and raw.get(GENERATOR_KEY) is not None:
        states = [raw[GENERATOR_KEY]]  # a single process's
    n_data = 1 if mesh is None else mesh.n_data
    mine = None
    if states is not None and len(states) != n_data:
        # resumed at another data-parallel degree: every data rank reseeds
        if mesh is None or mesh.is_main:
            print(f"resuming a checkpoint of {len(states)} data rank(s) on {n_data}: the "
                  "training generators are reseeded from train.seed")
    elif states is not None:
        mine = states[0 if mesh is None else mesh.data_rank]
    if mine is not None and mine.size == generator.get_state().numel():
        generator.set_state(torch.from_numpy(np.array(mine, np.uint8)))
    else:  # reseeded, a JAX checkpoint, or one saved on another kind of device
        generator.manual_seed(train_seed(cfg.train.seed, mesh))
    return TrainState(model=model, opt_state=opt_state, step=int(raw["step"]),
                      lr=f32(float(raw["lr"])), ema=ema, generator=generator)


def _map_leaves(tree: dict, fn) -> dict:
    return {k: (_map_leaves(v, fn) if isinstance(v, dict) else fn(v)) for k, v in tree.items()}


def load_checkpoint(path: str, device=None
                    ) -> Tuple[TrainState, Config, VMMTModel, Vocab, Vocab]:
    """Rebuild the model and its state from the checkpoint alone (the
    saved config defines the architecture), on ``device`` (cuda unless
    ``device='cpu'``)."""
    cfg = read_config(path)
    src_vocab = Vocab.load(os.path.join(path, "vocab.src.json"))
    tgt_vocab = Vocab.load(os.path.join(path, "vocab.tgt.json"))
    model = build_model(cfg.model, device=resolve_device(device))
    return load_state(path, model, cfg), cfg, model, src_vocab, tgt_vocab


def is_released(path: str) -> bool:
    """True if ``release_checkpoint`` stripped this checkpoint's optimizer
    state (resuming from it restarts the optimizer)."""
    return os.path.exists(os.path.join(path, "RELEASED"))


def release_checkpoint(src: str, dst: str, dtype: str = "keep", ema: bool = False) -> Dict[str, int]:
    """A deployment copy of ``src`` at ``dst`` without the optimizer state
    (JAX checkpoint.py:157-208): with ``dtype="bfloat16"`` the float
    parameters are cast in the file; ``ema=True`` ships the EMA weights as
    the params. Returns {"src_bytes", "dst_bytes"} of state.msgpack."""
    if dtype not in ("keep", "bfloat16"):
        raise ValueError(f"dtype must be keep | bfloat16, got {dtype!r}")
    state_path = os.path.join(src, "state.msgpack")
    raw = read_state(src)
    raw.pop("opt_state", None)
    if ema:
        if "ema_params" not in raw:
            raise ValueError(f"{src}: no EMA state in checkpoint (trained with "
                             "ema_decay=0); cannot release with ema=True")
        raw["params"] = raw["ema_params"]
    raw.pop("ema_params", None)
    if dtype == "bfloat16":
        def cast(x):
            if isinstance(x, torch.Tensor):
                return x.to(torch.bfloat16) if x.is_floating_point() else x
            x = np.asarray(x)
            return (torch.from_numpy(x.copy()).to(torch.bfloat16)
                    if np.issubdtype(x.dtype, np.floating) else x)

        raw["params"] = _map_leaves(raw["params"], cast)
    tmp = dst + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    for name in ("config.json", "vocab.src.json", "vocab.tgt.json"):
        shutil.copyfile(os.path.join(src, name), os.path.join(tmp, name))
    with open(os.path.join(tmp, "state.msgpack"), "wb") as f:
        f.write(msgpack_io.packb(raw))
    with open(os.path.join(tmp, "RELEASED"), "w") as f:
        f.write("optimizer state stripped by release_checkpoint\n")
    if os.path.exists(dst):
        shutil.rmtree(dst)
    os.rename(tmp, dst)
    return {"src_bytes": os.path.getsize(state_path),
            "dst_bytes": os.path.getsize(os.path.join(dst, "state.msgpack"))}
