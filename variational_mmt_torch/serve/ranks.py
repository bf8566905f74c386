"""The control channel of a service across ranks (``TranslationService(mesh=)``).

JAX serves a mesh from one controller. The port runs one process a rank
(``torchrun``), so rank 0 owns the queue, the batcher and the HTTP front end,
and every other rank follows: it replays rank 0's device calls (each
``Translator.dispatch_ids`` with its payload, each ``finalize_ids``, the
stop) in rank 0's order, so that the collectives inside them (the TP gather
of each step's logits, the n-best gather of the data ranks) meet.

The operations travel through the process group's key-value store, not a
collective: a follower waiting for the next request in a collective would
hit the group's timeout (gloo 30 min, NCCL 10 min) on an idle server. Rank
0 writes operation ``n`` under ``op/n`` and its idle worker adds to a
``beat`` counter every ``poll_s``; a follower waits for the next key in
bounded waits of ``poll_s``, and between them reads ``failed`` (set by the
rank that raised) and ``beat``. A rank that raises writes ``failed``, so
the others end too: the service never hangs on a dead rank. Each key is
deleted by the last follower to read it. Each service of a process keeps
its keys under a prefix of its own, numbered in the order the services are
built (the same on every rank).
"""

from __future__ import annotations

import datetime
import itertools
import pickle
import time
from typing import Optional

import torch.distributed as dist


class RankFailed(RuntimeError):
    """Another rank of the service failed or stopped answering."""


_services = itertools.count()


def _group_store():
    """The default process group's store (every rank of the mesh reaches
    it), under the next service's prefix."""
    if not dist.is_initialized():
        raise RuntimeError("serving across ranks needs the mesh's process group")
    return dist.PrefixStore(f"vmmt-serve/{next(_services)}/",
                            dist.distributed_c10d._get_default_store())


class RankChannel:
    """Rank 0 publishes operations; the followers take them in order."""

    poll_s = 0.5  # rank 0's idle beat, and a follower's bounded wait
    dead_s = 60.0  # a follower ends the service after this long without a beat

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world
        self.store = _group_store()
        self.seq = 0  # operations published (rank 0) or taken (followers)
        self._beat_seen, self._beat_at = -1, time.monotonic()

    def publish(self, op: tuple) -> None:
        self.store.set(f"op/{self.seq}", pickle.dumps(op))
        self.seq += 1

    def beat(self) -> None:
        self.store.add("beat", 1)

    def fail(self, why: str) -> None:
        """Tell every rank that this one failed (the first reason stays)."""
        if not self.store.check(["failed"]):
            self.store.set("failed", f"rank {self.rank}: {why}")

    def failed(self) -> Optional[str]:
        return self.store.get("failed").decode() if self.store.check(["failed"]) else None

    def take(self) -> tuple:
        """The next operation (followers). Raises RankFailed when a rank
        reported a failure or rank 0's beat stopped for ``dead_s``."""
        key = f"op/{self.seq}"
        while True:
            try:
                self.store.wait([key], datetime.timedelta(seconds=self.poll_s))
                break
            except RuntimeError as e:
                if "timeout" not in str(e).lower():
                    raise RankFailed(f"the service's store failed: {e}") from e
            why = self.failed()
            if why is not None:
                raise RankFailed(why)
            beat = self.store.add("beat", 0)
            now = time.monotonic()
            if beat != self._beat_seen:
                self._beat_seen, self._beat_at = beat, now
            elif now - self._beat_at > self.dead_s:
                raise RankFailed(f"rank 0 sent nothing for {self.dead_s:.0f} s")
        op = pickle.loads(self.store.get(key))
        if self.store.add(f"ack/{self.seq}", 1) == self.world - 1:
            self.store.delete_key(key)
            self.store.delete_key(f"ack/{self.seq}")
        self.seq += 1
        return op
