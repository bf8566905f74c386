"""HTTP servers over :class:`TranslationService`. Mirrors
``variational_mmt_tpu/serve/http_server.py``; both serve the endpoints of
``serve/frontend.py``.

- :class:`ServingServer`: one ``ThreadingHTTPServer`` in the service's
  process; every handler thread shares its interpreter lock with
  tokenization, the worker and the device thread's beam loop.
- :class:`MPServingServer`: N dispatcher processes sharing one port
  through ``SO_REUSEPORT``; each parses HTTP and tokenizes in its own
  interpreter and forwards over a unix-socket RPC (``serve/rpc.py``) to the
  device-owning process. The dispatchers import no torch.
"""

from __future__ import annotations

import os
import socket
import tempfile
import threading
from typing import List, Optional

import numpy as np

from variational_mmt_torch.serve.frontend import Backend, HTTPServer, make_http_handler
from variational_mmt_torch.serve.service import TranslationService


class _ServiceBackend(Backend):
    """In-process adapter: handler threads call the service directly."""

    def __init__(self, service: TranslationService, info: dict):
        self.service = service
        self.info = info

    def translate(self, texts: List[str], imgs: Optional[np.ndarray], timeout: float,
                  sample_ids=None):
        return self.service.translate_text(texts, imgs, timeout=timeout, sample_ids=sample_ids)

    def healthz(self) -> dict:
        return {"ok": True, **self.info}

    def stats(self) -> dict:
        with self.service._stats_lock:
            return dict(self.service.stats)


class ServingServer:
    """Owns the ThreadingHTTPServer; ``start()`` returns at once (the serve
    loop runs on a daemon thread) so tests and embedding apps can drive it."""

    def __init__(self, service: TranslationService, host: str = "127.0.0.1",
                 port: int = 8080, info: Optional[dict] = None):
        self.service = service
        self.httpd = HTTPServer((host, port),
                                make_http_handler(_ServiceBackend(service, info or {})))
        self._thread: Optional[threading.Thread] = None
        self._serving = False

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        self._serving = True
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                                        name="vmmt-http")
        self._thread.start()

    def serve_forever(self) -> None:
        self._serving = True
        self.httpd.serve_forever()

    def stop(self) -> None:
        # shutdown() waits for serve_forever(): never call it on a server
        # that was not started
        if self._serving:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.service.stop()


class MPServingServer:
    """``procs`` dispatcher processes accept on one shared port, each
    forwarding over a unix-socket RPC to this (device-owning) process.

    The parent holds a bound, non-listening socket on the port for its whole
    life: with ``port=0`` it picks the port every dispatcher then binds, and
    keeps the number reserved (a non-listening member of a reuseport group
    receives no connections)."""

    def __init__(self, service: TranslationService, host: str = "127.0.0.1", port: int = 0,
                 procs: int = 4, info: Optional[dict] = None):
        import multiprocessing as mp

        from variational_mmt_torch.serve.frontend import run_dispatcher
        from variational_mmt_torch.serve.rpc import RPCServer

        self.service = service
        self._rpc_path = os.path.join(tempfile.mkdtemp(prefix="vmmt-rpc-"), "rpc.sock")
        # ship the vocab tables so the dispatchers take the id-level wire,
        # unless replace_unk needs the token-level op
        vocabs = None
        if not service.dcfg.replace_unk:
            vocabs = (service.translator.src_vocab.itos, service.translator.tgt_vocab.itos)
        self.rpc = RPCServer(service, {**(info or {}), "ids_wire": vocabs is not None},
                             self._rpc_path)
        self._reserve = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._reserve.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        self._reserve.bind((host, port))
        self.port = self._reserve.getsockname()[1]

        # spawn, not fork: a forked child would inherit this process's
        # threads and CUDA context
        ctx = mp.get_context("spawn")
        merges = service.bpe.merges if service.bpe is not None else None
        self._procs = []
        self._ready = []
        for _ in range(max(1, procs)):
            rd, wr = ctx.Pipe(duplex=False)
            p = ctx.Process(target=run_dispatcher,
                            args=(host, self.port, self._rpc_path, merges, service.scfg.lower,
                                  wr, vocabs),
                            daemon=True)
            p.start()
            wr.close()
            self._procs.append(p)
            self._ready.append(rd)

    def start(self, timeout: float = 60.0) -> None:
        """Block until every dispatcher accepts connections."""
        for p, rd in zip(self._procs, self._ready):
            if not rd.poll(timeout):
                raise RuntimeError(f"dispatcher pid={p.pid} not ready after {timeout}s")
            if rd.recv() != self.port:
                raise RuntimeError(f"dispatcher pid={p.pid} bound another port")
            rd.close()

    def stop(self) -> None:
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            p.join(timeout=5)
        self.rpc.stop()
        try:
            self._reserve.close()
        except OSError:
            pass
        try:
            os.unlink(self._rpc_path)
            os.rmdir(os.path.dirname(self._rpc_path))
        except OSError:
            pass
        self.service.stop()
