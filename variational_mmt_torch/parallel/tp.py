"""Vocab-parallel tensor parallelism. Mirrors
``variational_mmt_tpu/parallel/tp.py`` (:41-119).

The rules are JAX's, on the port's parameter names: the embedding tables
``(V, E)`` are row-sharded on V over the mesh's model axis, the
generator's kernel ``(H, V)`` column-sharded, its bias and the tied
generator's ``gen_bias`` sharded; everything else, the recurrent cells
among them, is replicated. Weight-only int8 replaces a tensor by
``{int8, scale}``: the codes take the tensor's spec, the per-column scale
the last component of it (:70-93).

JAX annotates these layouts and GSPMD writes the collectives. Here the
model holds only its shard (``VMMTModel(cfg, mesh=...)``) and computes
the vocab-parallel parts itself (Megatron's scheme):

- the embedding lookup masks the ids outside the shard, gathers locally,
  zeroes the masked rows and all-reduces SUM over the model group; its
  backward is the identity (:class:`ReduceFromModel`);
- the generator computes its V/n columns from an input whose gradient is
  all-reduced SUM in the backward pass (:class:`CopyToModel`);
- the cross entropy and its argmax reduce over the shards
  (ops/fused_ce.py, train/loss.py, :func:`token_log_prob`); decoding
  gathers each step's logits to the full V (:func:`gather_vocab`).

:func:`shard_params` and :func:`gather_params` move a state dict between
its full form (a checkpoint's, or ``convert.params_from_jax`` of a JAX
tree) and this rank's shard.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from variational_mmt_torch.parallel import mesh as pm

MODEL_AXIS = "model"

# (parameter-name suffix, spec) -- first match wins; anything unmatched is
# replicated
TP_RULES = (
    ("src_embed.embedding", (MODEL_AXIS, None)),
    ("tgt_embed.embedding", (MODEL_AXIS, None)),
    ("generator.kernel", (None, MODEL_AXIS)),
    ("generator.bias", (MODEL_AXIS,)),
    # tied generator (share_decoder_embeddings): the standalone (V,) bias
    # shards like generator.bias
    ("gen_bias", (MODEL_AXIS,)),
)


def spec_for(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The spec of parameter ``name`` of ``ndim`` dimensions: one entry an
    axis, ``"model"`` where it is sharded; ``()`` replicated. ``name.int8``
    and ``name.scale`` (int8 weights) follow ``name``'s rule as JAX's
    ``spec_for`` does."""
    base, quant = name, None
    if name.endswith((".int8", ".scale")):
        base, quant = name.rsplit(".", 1)
    for suffix, spec in TP_RULES:
        # component-boundary match: "generator.kernel" must not claim a
        # hypothetical "pre_generator.kernel"
        if base == suffix or base.endswith("." + suffix):
            if quant == "scale":
                return (spec[-1],) if spec else ()
            if ndim < len(spec):
                break  # rank mismatch -> replicate
            return spec
    return ()


def shard_axis(name: str, ndim: int) -> Optional[int]:
    """The axis of ``name`` that the model axis splits, or None."""
    spec = spec_for(name, ndim)
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def validate_tp_divisibility(cfg_model, n_model: int) -> None:
    """Vocab dims must split evenly across the model axis (a padded
    generator would change the CE normalizer). JAX's message."""
    if n_model <= 1:
        return
    for name, v in (("src_vocab_size", cfg_model.src_vocab_size),
                    ("tgt_vocab_size", cfg_model.tgt_vocab_size)):
        if v % n_model != 0:
            raise ValueError(
                f"model.{name} ({v}) must be divisible by the tensor-"
                f"parallel degree ({n_model}); pad the vocab to "
                f"{((v + n_model - 1) // n_model) * n_model} "
                f"(preprocess -vocab_pad_multiple {n_model})")


def vocab_mesh(mesh: Optional[pm.Mesh]) -> Optional[pm.Mesh]:
    """``mesh`` if it shards the vocab (more than one model rank), else None."""
    return mesh if mesh is not None and mesh.n_model > 1 else None


def shard_tensor(name: str, t: torch.Tensor, mesh: Optional[pm.Mesh]) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` of parameter ``name``
    (``t`` itself when replicated or on one model rank)."""
    axis = shard_axis(name, t.dim())
    if axis is None or vocab_mesh(mesh) is None:
        return t
    n = t.shape[axis]
    if n % mesh.n_model:
        raise ValueError(f"{name}: axis {axis} of {n} does not divide by the "
                         f"tensor-parallel degree {mesh.n_model}")
    per = n // mesh.n_model
    return t.narrow(axis, mesh.model_rank * per, per).clone(
        memory_format=torch.contiguous_format)


def gather_tensor(name: str, t: torch.Tensor, mesh: Optional[pm.Mesh]) -> torch.Tensor:
    """The full tensor of parameter ``name`` from every model rank's shard
    ``t`` (a collective over the model group: every rank must call it)."""
    axis = shard_axis(name, t.dim())
    if axis is None or vocab_mesh(mesh) is None:
        return t
    return pm.all_gather(t.contiguous(), mesh.model_group, mesh.model_rank, mesh.n_model, axis)


def _map(state: Mapping[str, object], fn) -> Dict[str, object]:
    """``fn(name, tensor)`` over a state dict whose int8 entries are
    ``{int8, scale}`` dicts (named ``name.int8``, ``name.scale``)."""
    return {k: ({q: fn(f"{k}.{q}", t) for q, t in v.items()} if isinstance(v, Mapping)
                else fn(k, v)) for k, v in state.items()}


def shard_params(full: Mapping[str, object], mesh: Optional[pm.Mesh]) -> Dict[str, object]:
    """A full state dict (int8 pairs too) -> this rank's shard of it."""
    return _map(full, lambda k, t: shard_tensor(k, t, mesh))


def gather_params(local: Mapping[str, object], mesh: Optional[pm.Mesh]) -> Dict[str, object]:
    """This rank's shard of a state dict -> the full one (collective)."""
    return _map(local, lambda k, t: gather_tensor(k, t, mesh))


def gather_list(names: Sequence[str], tensors: List[torch.Tensor],
                mesh: Optional[pm.Mesh]) -> List[torch.Tensor]:
    """:func:`gather_tensor` over parallel lists of names and tensors
    (optimizer moments and the EMA follow their parameter's layout)."""
    return [gather_tensor(n, t, mesh) for n, t in zip(names, tensors)]


def global_norm(grads: List[torch.Tensor], names: Sequence[str],
                mesh: Optional[pm.Mesh]) -> torch.Tensor:
    """The global gradient norm of a sharded model: each replicated leaf
    counted once, the sharded leaves' sum of squares all-reduced over the
    model group (so clipping and ``skip_nonfinite`` agree on every rank)."""
    rep = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    sharded = torch.zeros_like(rep)
    for n, g in zip(names, grads):
        sq = torch.sum(torch.square(g.float()))
        if shard_axis(n, g.dim()) is None:
            rep = rep + sq
        else:
            sharded = sharded + sq
    return torch.sqrt(rep + pm.all_reduce(sharded, mesh.model_group))


# ------------------------------------------------------------ autograd pieces

class ReduceFromModel(torch.autograd.Function):
    """All-reduce SUM over the model group; backward the identity (every
    rank computes the same loss from the reduced value)."""

    @staticmethod
    def forward(ctx, x, group):
        return pm.all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class CopyToModel(torch.autograd.Function):
    """The identity; backward all-reduces SUM over the model group (each
    rank's generator shard contributes a part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return pm.all_reduce(g.contiguous().clone(), ctx.group), None


def reduce_from_model(x: torch.Tensor, mesh: pm.Mesh) -> torch.Tensor:
    return ReduceFromModel.apply(x, mesh.model_group)


def copy_to_model(x: torch.Tensor, mesh: pm.Mesh) -> torch.Tensor:
    return CopyToModel.apply(x, mesh.model_group)


def vocab_start(n_local: int, mesh: pm.Mesh) -> int:
    """The global id of this rank's first vocab entry."""
    return mesh.model_rank * n_local


def local_ids(ids: torch.Tensor, n_local: int, mesh: pm.Mesh):
    """(ids shifted into the shard and clamped, mask of the ids it owns)."""
    loc = ids - vocab_start(n_local, mesh)
    own = (loc >= 0) & (loc < n_local)
    return torch.where(own, loc, torch.zeros_like(loc)), own


def gather_vocab(logits: torch.Tensor, mesh: pm.Mesh) -> torch.Tensor:
    """Each rank's (..., V/n) logits -> the full (..., V) on every rank."""
    return pm.all_gather(logits.contiguous(), mesh.model_group, mesh.model_rank,
                         mesh.n_model, logits.dim() - 1)


def argmax(logits: torch.Tensor, mesh: pm.Mesh,
           row_max: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The global argmax over the vocab shards, ties to the lowest global
    index (as ``argmax`` over the full row): each shard's first maximum,
    then the least index among the shards that hold the global maximum.
    ``row_max``: the global row maximum, when already reduced."""
    n_local = logits.shape[-1]
    m_loc, i_loc = logits.max(dim=-1)
    if row_max is None:
        row_max = pm.all_reduce(m_loc.clone(), mesh.model_group, "max")
    big = torch.full_like(i_loc, n_local * mesh.n_model)
    cand = torch.where(m_loc == row_max, i_loc + vocab_start(n_local, mesh), big)
    return pm.all_reduce(cand, mesh.model_group, "min")


def token_log_prob(logits: torch.Tensor, targets: torch.Tensor, mesh: pm.Mesh) -> torch.Tensor:
    """log softmax(logits)[target] over the vocab shards (no gradient):
    the log-likelihood of each gold token."""
    n_local = logits.shape[-1]
    logits = logits.float()
    m = pm.all_reduce(logits.amax(dim=-1), mesh.model_group, "max")
    se = pm.all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1), mesh.model_group)
    loc, own = local_ids(targets.long(), n_local, mesh)
    z = torch.where(own, logits.gather(-1, loc[..., None])[..., 0], torch.zeros_like(m))
    z = pm.all_reduce(z, mesh.model_group)
    return z - (m + torch.log(se))
