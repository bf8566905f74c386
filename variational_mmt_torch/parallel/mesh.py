"""The (data x model) mesh of ranks and its collectives. Mirrors
``variational_mmt_tpu/parallel/mesh.py`` (:26-53) and the 2-D mesh of
``parallel/tp.py`` (``make_mesh_2d``).

JAX drives every device of a host from one controller and lets GSPMD insert
the collectives. The port runs one process a GPU, started by ``torchrun``
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), and writes each collective
itself. A :class:`Mesh` holds ``n_data x n_model`` ranks; global rank
``d * n_model + m`` has data index d and model index m. Its
``data_group`` joins the ranks of its model index (the gradients' and the
metrics' all-reduce), its ``model_group`` the ranks of its data index (the
vocab-parallel reductions of parallel/tp.py). Every rank must belong to the
mesh: an idle rank would wait forever in the first collective, so the port
refuses ``num_shards * tensor_parallel != WORLD_SIZE`` where JAX leaves the
spare devices idle.

The backend is the caller's choice: ``nccl`` for CUDA, ``gloo`` for the
CPU (or for two ranks that share one card, which NCCL refuses). Every
collective of the port is here (every rank builds the same initial
parameters from the seed, so none is broadcast). gloo may lack ``all_gather`` on CUDA
tensors, so :func:`all_gather` is an all-reduce SUM of a zero-filled
buffer into which each rank writes its shard: adding zeros is exact, and
one code path serves both backends, at n times the bytes of a gather on
the wire.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from variational_mmt_torch.device import resolve_device

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in an ``n_data x n_model`` mesh (module
    docstring). ``device`` is the rank's device."""

    n_data: int
    n_model: int
    rank: int
    device: torch.device
    backend: str = "gloo"
    data_group: Any = None
    model_group: Any = None
    owns_process_group: bool = False  # make_mesh started it: close() ends it

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def close(self) -> None:
        """End the process group if :func:`make_mesh` started it."""
        if self.owns_process_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_process_group = False


def backend_for(device: Union[str, torch.device]) -> str:
    """The backend the CLIs pick: ``nccl`` on CUDA, ``gloo`` on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def make_mesh(num_shards: int = 0, tensor_parallel: int = 1, device=None,
              backend: Optional[str] = None, init_method: Optional[str] = None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              timeout: Optional[float] = None) -> Mesh:
    """The mesh of ``num_shards`` data shards (0: ``WORLD_SIZE //
    tensor_parallel``, as JAX's 0 means every device) by
    ``tensor_parallel`` model shards over the process group, which this
    call starts when none is running: ``rank`` and ``world_size`` default
    to ``RANK`` and ``WORLD_SIZE`` (torchrun's), ``init_method`` to
    ``env://``. ``device`` defaults to ``cuda:LOCAL_RANK``; ``backend``
    (``nccl`` | ``gloo``) defaults to :func:`backend_for` the device, and
    ``nccl`` on a build without it is an error, never a switch to gloo.
    ``timeout`` (seconds) bounds every collective of the process group and
    of the mesh's groups (None: PyTorch's default for the backend).
    Every rank must call this, with the same arguments, in the same order
    as its other ``make_mesh`` calls."""
    if tensor_parallel < 1 or num_shards < 0:
        raise ValueError(f"num_shards ({num_shards}) must be >= 0 and tensor_parallel "
                         f"({tensor_parallel}) >= 1")
    started = False
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world = world_size if world_size is not None else _env_int("WORLD_SIZE")
        rank = rank if rank is not None else _env_int("RANK")
        if world is None:
            need = max(num_shards, 1) * tensor_parallel
            if need > 1:
                raise ValueError(
                    f"{need} ranks requested (num_shards {num_shards} x tensor_parallel "
                    f"{tensor_parallel}) but this process is not one of a group: start one "
                    f"process a rank, e.g. torchrun --nproc_per_node {need} ...")
            world, rank = 1, 0
        if rank is None:
            raise ValueError("WORLD_SIZE is set but RANK is not: start the ranks with torchrun")
    n_model = tensor_parallel
    n_data = num_shards or world // n_model
    if n_data * n_model > world or n_data == 0:
        if tensor_parallel > 1:
            raise ValueError(f"requested {max(n_data, 1)}x{n_model} mesh but only {world} "
                             f"ranks are available")
        raise ValueError(f"requested {n_data} data shards but only {world} ranks are "
                         "available")
    if n_data * n_model != world:
        raise ValueError(
            f"the mesh of {n_data} data x {n_model} model shards covers {n_data * n_model} "
            f"of the {world} ranks: every rank must belong to it (an idle rank would wait "
            "forever in the first collective); set -num_shards x -tensor_parallel = "
            "WORLD_SIZE, or -num_shards 0")
    if device is None:
        device = f"cuda:{_env_int('LOCAL_RANK') or 0}"
    dev = resolve_device(device)
    backend = backend or backend_for(dev)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch build has no NCCL: pass backend='gloo' "
                               "explicitly to reduce through the host")
    elif backend != "gloo":
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    limit = None if timeout is None else datetime.timedelta(seconds=timeout)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world, timeout=limit)
        started = True
    # every rank creates every group, in the same order
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)], timeout=limit)
        if m == rank % n_model:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)], timeout=limit)
        if d == rank // n_model:
            model_group = g
    return Mesh(n_data=n_data, n_model=n_model, rank=rank, device=dev, backend=backend,
                data_group=data_group, model_group=model_group, owns_process_group=started)


# ---------------------------------------------------------------- collectives

def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced in place over ``group`` (SUM, MAX or MIN); returns it."""
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, group, index: int, size: int, dim: int = 0) -> torch.Tensor:
    """The ``size`` equal shards of ``group`` concatenated on ``dim``, this
    rank's (``index``) among them: an all-reduce SUM of a zero-filled buffer
    (module docstring)."""
    if size == 1:
        return t
    shape = list(t.shape)
    n = shape[dim]
    shape[dim] = n * size
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    out.narrow(dim, index * n, n).copy_(t)
    return all_reduce(out, group)


def all_reduce_list(tensors: List[torch.Tensor], group,
                    bucket_bytes: int = 64 << 20) -> List[torch.Tensor]:
    """SUM of every tensor over ``group``, in buckets of at most
    ``bucket_bytes`` (one flat f32 buffer a bucket: a few collectives for a
    model's gradients instead of one a parameter); returns new tensors."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    bucket: List[int] = []
    size = 0

    def flush():
        nonlocal bucket, size
        if not bucket:
            return
        flat = torch.cat([tensors[i].reshape(-1).float() for i in bucket])
        all_reduce(flat, group)
        off = 0
        for i in bucket:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape).to(tensors[i].dtype)
            off += n
        bucket, size = [], 0

    for i, t in enumerate(tensors):
        bucket.append(i)
        size += t.numel() * 4
        if size >= bucket_bytes:
            flush()
    flush()
    return out


def gather_objects(obj: Any) -> List[Any]:
    """``obj`` of every rank of the world, in rank order (pickled; small
    host objects such as n-best lists and generator states)."""
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (an all-reduce of one number over the world)."""
    all_reduce(torch.zeros((), device=mesh.device), None)


# ---------------------------------------------------------------- batches

def data_rows(n: int, mesh: Mesh) -> slice:
    """Rows ``[d*n/D, (d+1)*n/D)`` of an ``n``-row batch: this rank's."""
    if n % mesh.n_data:
        raise ValueError(f"a batch of {n} rows is not divisible by the {mesh.n_data} "
                         "data-parallel ranks")
    per = n // mesh.n_data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of a batch: a dict of arrays or tensors, or a
    Batch / PackedBatch, every leaf sliced on its leading axis (the stacked
    and packed leaves too: all lead with the batch), as JAX's
    ``batch_sharding`` lays them out. The identity on one data shard."""
    if mesh.n_data == 1:
        return batch
    if isinstance(batch, dict):
        n = next(iter(batch.values())).shape[0]
        rows = data_rows(n, mesh)
        return {k: v[rows] for k, v in batch.items()}
    fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
    n = batch.src.shape[0]
    rows = data_rows(n, mesh)
    return dataclasses.replace(batch, **{k: v[rows] for k, v in fields.items()
                                         if isinstance(v, (np.ndarray, torch.Tensor))})
