"""HTTP front-end pieces, shared by the in-process server and the
multi-process dispatchers. Mirrors ``variational_mmt_tpu/serve/frontend.py``.

This module imports no torch: dispatcher processes import it
(``run_dispatcher`` is their ``multiprocessing`` spawn target) and must
never load the model stack or touch the card.

Endpoints (the same on both servers):

- ``GET /healthz``  -> ``{"ok": true, "model_type": ..., "step": ...}``
- ``GET /stats``    -> service counters (requests, batches, busy_s, ...)
- ``POST /translate`` with a JSON body::

      {"texts": ["a sentence", ...],           # required
       "imgs": [[...2048 floats...], ...],     # optional, aligned to texts
       "sample_ids": [0, 1, ...],              # optional, aligned to texts
       "timeout": 60}                           # optional, seconds

  ``sample_ids`` (sampling services only) keys each sentence's random
  stream: repeating a (text, sample_id) pair repeats the sampled answer
  whatever the batching; deterministic services answer 400.

  -> ``{"results": [[{"score": s, "text": t}, ...n-best...], ...]}``

  ``timeout`` is both the result wait and the shed deadline: a request
  still queued past it fails with 503 "overloaded" instead of being
  computed.

- ``POST /translate`` with ``Content-Type: application/x-msgpack``: the
  same map, but ``imgs`` is ``{"shape": [n, d], "data": <raw float32
  little-endian bytes>}`` and the response is msgpack too (the port's
  codec, ``utils/msgpack_codec.py``; JSON-encoding 2048 floats a sentence
  would dominate the request's cost).
"""

from __future__ import annotations

import json
import os
import socket
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

import numpy as np

from variational_mmt_torch.serve.errors import ClientError
from variational_mmt_torch.serve.rpc import RPCClient, imgs_from_wire, imgs_to_wire
from variational_mmt_torch.utils.msgpack_codec import packb, unpackb


class Backend:
    """What a handler needs from the world behind it (duck-typed)."""

    def translate(self, texts: List[str], imgs: Optional[np.ndarray], timeout: float,
                  sample_ids: Optional[List[int]] = None) -> List[List[Tuple[float, str]]]:
        raise NotImplementedError

    def healthz(self) -> dict:
        raise NotImplementedError

    def stats(self) -> dict:
        raise NotImplementedError


def make_http_handler(backend: Backend):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # the largest accepted body: without a cap each handler thread would
        # buffer a client's Content-Length in full
        MAX_BODY = int(os.environ.get("VMMT_SERVE_MAX_BODY", 64 * 1024 * 1024))

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, payload: dict) -> None:
            self._send(code, json.dumps(payload).encode("utf-8"), "application/json")

        def _msgpack(self, code: int, payload: dict) -> None:
            self._send(code, packb(payload), "application/x-msgpack")

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, backend.healthz())
            elif self.path == "/stats":
                self._json(200, backend.stats())
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            binary = "msgpack" in (self.headers.get("Content-Type") or "")
            try:
                n_body = int(self.headers.get("Content-Length", 0))
            except ValueError:
                n_body = -1
            if n_body < 0 or n_body > self.MAX_BODY:
                # too large to drain for keep-alive: close the connection
                self.close_connection = True
                self._json(413, {"error": f"request body exceeds {self.MAX_BODY} bytes"})
                return
            reply = self._msgpack if binary else self._json
            raw = self.rfile.read(n_body)  # drained even when refused (keep-alive)
            if self.path != "/translate":
                reply(404, {"error": "not found"})
                return
            try:
                req = unpackb(raw or b"\x80") if binary else json.loads(raw or b"{}")
                texts = req["texts"]
                if not isinstance(texts, list) or not all(isinstance(t, str) for t in texts):
                    raise ValueError("'texts' must be a list of strings")
                imgs = req.get("imgs")
                if imgs is not None:
                    if binary:  # {"shape": [n, d...], "data": raw f32 LE bytes}
                        imgs = imgs_from_wire(imgs)
                    else:
                        imgs = np.asarray(imgs, np.float32)
                    if len(imgs) != len(texts):
                        raise ValueError("'imgs' must align to 'texts'")
                sample_ids = req.get("sample_ids")
                if sample_ids is not None:
                    if (not isinstance(sample_ids, list)
                            or not all(isinstance(s, int) for s in sample_ids)):
                        raise ValueError("'sample_ids' must be a list of ints")
                    if len(sample_ids) != len(texts):
                        raise ValueError("'sample_ids' must align to 'texts'")
                timeout = float(req.get("timeout", 60.0))
            except (KeyError, ValueError, TypeError) as e:
                reply(400, {"error": str(e)})
                return
            try:
                out = backend.translate(texts, imgs, timeout, sample_ids=sample_ids)
            except ClientError as e:  # the client's mistake (e.g. an over-length source)
                reply(400, {"error": str(e)})
                return
            except TimeoutError as e:  # shed or expired under load: retryable
                reply(503, {"error": f"overloaded: {e}"})
                return
            except Exception as e:  # noqa: BLE001 — surface to the client
                reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            reply(200, {"results": [[{"score": s, "text": t} for s, t in nbest]
                                    for nbest in out]})

    return Handler


class HTTPServer(ThreadingHTTPServer):
    """A threaded HTTP server whose listen backlog holds a burst of
    connections: the device thread's beam loop holds the interpreter lock
    for most of a request, so the accept loop can fall behind, and
    socketserver's default backlog of 5 then resets connections of 32
    concurrent clients."""

    request_queue_size = 256


class ReuseportHTTPServer(HTTPServer):
    """Binds with SO_REUSEPORT so N dispatcher processes share one port and
    the kernel balances accepted connections across them."""

    def server_bind(self):
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()


class _DispatcherBackend(Backend):
    """Runs in a dispatcher process: tokenizes and segments locally, in its
    own interpreter, and forwards over the RPC. With the server's vocab
    tables (``vocabs``) it takes the id-level wire: it encodes sources and
    decodes the returned ids itself, so the device-owning process touches
    no text."""

    def __init__(self, rpc_client, bpe_merges, lower: bool, vocabs=None):
        from variational_mmt_torch.data.tokenizer import tokenize

        self._rpc = rpc_client
        self._tokenize = tokenize
        self._lower = lower
        self._bpe = None
        if bpe_merges is not None:
            from variational_mmt_torch.data.bpe import BPE

            self._bpe = BPE([tuple(m) for m in bpe_merges])
        self._src_vocab = self._tgt_vocab = None
        if vocabs is not None:
            from variational_mmt_torch.data.vocab import Vocab

            self._src_vocab = Vocab(vocabs[0])
            self._tgt_vocab = Vocab(vocabs[1])

    def _call(self, payload, timeout):
        resp = self._rpc.call(payload, timeout)
        if "error" in resp:
            if resp["error"].startswith("ClientError:"):
                # a 400 as in the in-process backend; a server-side
                # ValueError does not match and stays a 500
                raise ClientError(resp["error"].split(": ", 1)[1])
            if resp["error"].startswith("TimeoutError:"):
                raise TimeoutError(resp["error"].split(": ", 1)[1])  # shed -> 503
            raise RuntimeError(resp["error"])
        return resp

    def translate(self, texts, imgs, timeout, sample_ids=None):
        tokens = []
        for t in texts:
            toks = self._tokenize(t, lower=self._lower)
            if self._bpe is not None:
                toks = self._bpe.segment(toks)
            tokens.append(toks)
        wire = imgs_to_wire(imgs)
        if self._src_vocab is not None:
            ids = [self._src_vocab.encode(toks) for toks in tokens]
            resp = self._call({"op": "translate_ids", "ids": ids, "imgs": wire,
                               "timeout": timeout, "sample_ids": sample_ids}, timeout)
            # Vocab.ids_to_text is Translator.nbest_to_text's detok (the
            # server refuses this op under replace_unk)
            return [[(s, self._tgt_vocab.ids_to_text(out_ids)) for s, out_ids in nbest]
                    for nbest in resp["results"]]
        resp = self._call({"op": "translate_tokens", "tokens": tokens, "imgs": wire,
                           "timeout": timeout, "sample_ids": sample_ids}, timeout)
        return [[(s, t) for s, t in nbest] for nbest in resp["results"]]

    def healthz(self):
        return self._rpc.call({"op": "healthz"}, 10.0)

    def stats(self):
        return self._rpc.call({"op": "stats"}, 10.0)


def run_dispatcher(host: str, port: int, rpc_path: str, bpe_merges, lower: bool, ready,
                   vocabs=None) -> None:
    """The spawn target of one HTTP dispatcher process: reports the bound
    port through the ``ready`` pipe end, then serves until terminated.
    ``vocabs``: optional (src_itos, tgt_itos) tables for the id-level wire."""
    backend = _DispatcherBackend(RPCClient(rpc_path), bpe_merges, lower, vocabs=vocabs)
    httpd = ReuseportHTTPServer((host, port), make_http_handler(backend))
    try:
        ready.send(httpd.server_address[1])
        ready.close()
    except (BrokenPipeError, OSError):
        pass  # the parent gave up; serve anyway
    httpd.serve_forever()
