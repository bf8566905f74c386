"""Unix-socket RPC between the HTTP dispatcher processes and the service's
process. Mirrors ``variational_mmt_tpu/serve/rpc.py``.

The dispatchers parse HTTP, decode bodies and tokenize in their own
interpreters; what crosses this socket is already tokenized (or
vocab-encoded) and binary-packed, so the device-owning process spends its
interpreter lock only on queue hops.

Wire format: a 4-byte little-endian length, then one msgpack map, written
and read by the port's torch-free codec (``utils/msgpack_codec.py``).

Ops:
- ``{"op": "healthz"}``                      -> ``{"ok": true, ...info}``
- ``{"op": "stats"}``                        -> service counters
- ``{"op": "translate_tokens", "tokens": [[tok,...],...],
     "imgs": {"shape": [n,d...], "data": <f32-LE bytes>} | None,
     "timeout": 60, "sample_ids": [...] | None}``
                                             -> ``{"results": [[[score, text],...],...]}``
- ``{"op": "translate_ids", "ids": [[int,...],...], "imgs": ..., "timeout": 60}``
                                             -> ``{"results": [[[score, [id,...]],...],...]}``
  The id-level op keeps all text work in the dispatchers; they use it
  whenever the server ships them the vocab tables (healthz advertises
  ``ids_wire``).

The client side imports no torch; the server side only duck-types the
service object.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
from typing import Optional

import numpy as np

from variational_mmt_torch.serve.errors import ClientError
from variational_mmt_torch.utils.msgpack_codec import packb, unpackb

_LEN = struct.Struct("<I")
MAX_MSG = 256 * 1024 * 1024  # corrupt-length guard


def send_msg(sock: socket.socket, obj) -> None:
    data = packb(obj)
    sock.sendall(_LEN.pack(len(data)) + data)


def recv_msg(sock: socket.socket):
    """One framed message; None on a clean EOF at a frame boundary."""
    head = _recv_exact(sock, _LEN.size, eof_ok=True)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > MAX_MSG:
        raise ValueError(f"rpc frame too large: {n}")
    return unpackb(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int, eof_ok: bool = False):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if eof_ok and not buf:
                return None
            raise ConnectionError("rpc peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def imgs_from_wire(wire) -> Optional[np.ndarray]:
    """``{"shape", "data": f32-LE bytes}`` -> a float32 array (or None)."""
    if wire is None:
        return None
    return np.frombuffer(wire["data"], dtype="<f4").reshape(wire["shape"])


def imgs_to_wire(imgs) -> Optional[dict]:
    if imgs is None:
        return None
    a = np.ascontiguousarray(imgs, dtype="<f4")
    return {"shape": list(a.shape), "data": a.tobytes()}


class RPCClient:
    """Thread-local connections: each dispatcher handler thread has its own
    socket (request and reply are strictly sequential on one)."""

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()

    def call(self, obj, timeout: float):
        sock = getattr(self._local, "sock", None)
        try:
            if sock is None:
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.connect(self.path)
                self._local.sock = sock
            # a margin over the application timeout: the service enforces
            # its own deadline and replies with an error
            sock.settimeout(timeout + 30.0)
            send_msg(sock, obj)
            resp = recv_msg(sock)
            if resp is None:
                raise ConnectionError("rpc server closed connection")
            return resp
        except Exception:
            # drop the (possibly desynced) connection; the next call reconnects
            if getattr(self._local, "sock", None) is not None:
                try:
                    self._local.sock.close()
                except OSError:
                    pass
                self._local.sock = None
            raise


class RPCServer:
    """Runs in the service's process: one daemon thread per dispatcher
    connection, each doing recv -> submit -> await the futures -> reply."""

    def __init__(self, service, info: dict, path: str):
        self.service = service
        self.info = info
        self.path = path
        if os.path.exists(path):
            os.unlink(path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(256)
        self._stopped = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True,
                                               name="vmmt-rpc-accept")
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed by stop()
            threading.Thread(target=self._conn_loop, args=(conn,), daemon=True,
                             name="vmmt-rpc-conn").start()

    def _conn_loop(self, conn: socket.socket) -> None:
        try:
            while True:
                req = recv_msg(conn)
                if req is None:
                    return
                try:
                    resp = self._dispatch(req)
                except Exception as e:  # noqa: BLE001 — surface to the dispatcher
                    resp = {"error": f"{type(e).__name__}: {e}"}
                send_msg(conn, resp)
        except (ConnectionError, OSError, ValueError):
            pass  # the dispatcher went away or sent a broken frame
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, req: dict):
        op = req.get("op")
        if op == "healthz":
            return {"ok": True, **self.info}
        if op == "stats":
            with self.service._stats_lock:
                return dict(self.service.stats)
        if op in ("translate_tokens", "translate_ids"):
            rows = req["ids"] if op == "translate_ids" else req["tokens"]
            imgs = imgs_from_wire(req.get("imgs"))
            if imgs is not None and len(imgs) != len(rows):
                raise ClientError("'imgs' must align to 'texts'")
            timeout = float(req.get("timeout", 60.0))
            sample_ids = req.get("sample_ids")  # validated by the service
            # batch submit: the whole request is validated before anything
            # is enqueued, so a rejected sentence costs no device work
            if op == "translate_ids":
                if self.service.dcfg.replace_unk:
                    # replace_unk needs attention positions and source
                    # tokens, which the id-level wire does not carry
                    raise ValueError("translate_ids op unavailable: replace_unk needs the "
                                     "token-level op")
                futs = self.service.submit_ids_batch(rows, imgs, timeout_s=timeout,
                                                     sample_ids=sample_ids)
                return {"results": [[[float(s), [int(i) for i in ids]]
                                     for s, ids in f.result(timeout=timeout)] for f in futs]}
            futs = self.service.submit_tokens_batch(rows, imgs, timeout_s=timeout,
                                                    sample_ids=sample_ids)
            return {"results": [[[float(s), t] for s, t in f.result(timeout=timeout)]
                                for f in futs]}
        raise ValueError(f"unknown rpc op: {op!r}")

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if os.path.exists(self.path):
            try:
                os.unlink(self.path)
            except OSError:
                pass
