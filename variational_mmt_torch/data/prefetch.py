"""Host→device prefetch on a background thread. Mirrors
``variational_mmt_tpu/data/prefetch.py``: ``prefetch`` (:37-84) runs the
source iterator and a transform on a thread, keeping ``size`` results in
flight, and raises a worker's exception on the consumer.

On CUDA the transform (:func:`stage`) turns a host batch into tensors in
pinned memory and copies them with ``non_blocking=True`` on a copy stream
of its own, recording an event; the consumer (:func:`land`) makes its
current stream wait on that event and ``record_stream``s every tensor, so
the caching allocator does not hand the memory back to the copy stream
while the step still reads it. The image-feature gather from a table on
the device runs after the wait, on the consumer's stream. On the CPU the
same thread assembles the batch, without pinning or streams.
:func:`device_batches` joins the three.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from variational_mmt_torch.data.dataset import Batch
from variational_mmt_torch.data.packing import PackedBatch

THREAD_NAME = "vmmt-prefetch"
JOIN_S = 10.0  # the longest a close waits for the worker's batch in hand
PACKED_IDS = ("src", "tgt_in", "tgt_out", "src_seg", "tgt_seg", "seg_first", "seg_last")
Staged = Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]


def prefetch(it: Iterator, size: int = 2,
             transform: Optional[Callable[[Any], Any]] = None) -> Iterator:
    """Iterate ``transform(b)`` for each ``b`` of ``it`` (identity without
    one), produced on a background thread, at most ``size`` waiting. A
    worker's exception is raised on the consumer; closing the generator
    (or a ``break`` out of it) releases the worker and waits for it to
    end."""
    xform = transform or (lambda b: b)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []
    closed = threading.Event()

    def put(item) -> bool:
        # bounded put that gives up once the consumer is gone, or the thread
        # would block on a full queue for the life of the process
        while not closed.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            for b in it:
                if not put(xform(b)):
                    return
        except Exception as e:  # raised on the consumer
            err.append(e)
        finally:
            put(sentinel)

    thread = threading.Thread(target=worker, name=THREAD_NAME, daemon=True)
    thread.start()
    # bound now: a generator finalized at interpreter exit finds no module globals
    current_thread = threading.current_thread
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        # release the worker and wait for it (it finishes the batch in hand),
        # so that no copy is in flight when the caller goes on or exits
        closed.set()
        if thread is not current_thread():
            thread.join(JOIN_S)


def host_tensors(batch: Union[Batch, PackedBatch],
                 with_indices: bool = False) -> Dict[str, torch.Tensor]:
    """A host batch as CPU tensors: ids and positions int64, masks and image
    features f32. A PackedBatch gives src, tgt_in, tgt_out, src_seg,
    tgt_seg, seg_first, seg_last, seg_mask and img (B,K,D). With
    ``with_indices`` the batch carries ``indices`` for a gather from a
    feature table on the device (:func:`gather_features`) instead of img."""
    if batch.tgt_in is None or batch.tgt_out is None:
        raise ValueError("a training batch needs tgt_in and tgt_out")
    if isinstance(batch, PackedBatch):
        out = {k: torch.from_numpy(np.asarray(getattr(batch, k))).long() for k in PACKED_IDS}
        mask_key = "seg_mask"
    else:
        out = {k: torch.from_numpy(np.asarray(getattr(batch, k))).long()
               for k in ("src", "tgt_in", "tgt_out")}
        mask_key = "example_mask"
    out[mask_key] = torch.from_numpy(np.asarray(getattr(batch, mask_key), np.float32))
    if with_indices:
        out["indices"] = torch.from_numpy(np.asarray(batch.indices)).long()
    elif batch.img is not None:
        out["img"] = torch.from_numpy(np.asarray(batch.img, np.float32))
    return out


def gather_features(out: Dict[str, torch.Tensor],
                    table: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """With ``table``, replaces ``out['indices']`` by img, the table's rows
    at those indices, zero on padding rows or segments."""
    if table is not None:
        mask = out["seg_mask" if "seg_mask" in out else "example_mask"]
        out["img"] = table[out.pop("indices")] * mask.reshape(
            mask.shape + (1,) * (table.dim() - 1))
    return out


def stage(batch: Union[Batch, PackedBatch], device: torch.device,
          stream: Optional[torch.cuda.Stream], with_indices: bool = False) -> Staged:
    """The worker's part: the batch's tensors on their way to ``device``.
    On CUDA they are pinned and copied on ``stream``, and the event marks
    the copies' end; on the CPU they are the host tensors (event None)."""
    host = host_tensors(batch, with_indices)
    if device.type != "cuda":
        return host, None
    with torch.cuda.stream(stream):
        out = {k: v.pin_memory().to(device, non_blocking=True) for k, v in host.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def land(staged: Staged, table: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The consumer's part: wait for the copies on the current stream, tie
    every tensor to that stream, then gather the features."""
    out, event = staged
    if event is not None:
        current = torch.cuda.current_stream()
        current.wait_event(event)
        for t in out.values():
            t.record_stream(current)
    return gather_features(out, table)


def device_batches(it: Iterator, device: torch.device, table: Optional[torch.Tensor] = None,
                   size: int = 2, mesh=None) -> Iterator[Dict[str, torch.Tensor]]:
    """The batches of ``it`` as tensors on ``device``, prefetched ``size``
    ahead (``trainer.batch_tensors`` of each, gathered from ``table`` when
    given). With ``mesh`` (parallel/mesh.py) each host batch is cut to this
    data rank's rows before its copy (``shard_batch``, as JAX's
    ``_device_batches`` shards it, trainer.py:479-541), so a rank copies,
    and gathers features for, its own rows only. Closing this generator
    releases the worker."""
    if mesh is not None:
        from variational_mmt_torch.parallel.mesh import shard_batch

        it = (shard_batch(b, mesh) for b in it)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    with_indices = table is not None
    staged = prefetch(it, size, transform=lambda b: stage(b, device, stream, with_indices))
    try:
        for s in staged:
            yield land(s, table)
    finally:
        staged.close()
