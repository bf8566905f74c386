"""PyTorch port: online serving (``variational_mmt_torch/serve/``,
``cli/serve.py``) on the CPU. The counterpart of each test of
tests/test_serve.py except those about tensor parallelism and ensembles
(ensembles: tests/test_torch_ensemble.py),
and besides: the service's answers equal the port's offline Translator
and JAX's TranslationService on the same parameters (f32: ids identical,
scores within 1e-4), the JSON and msgpack wires (the port's codec) agree,
the ``-procs 2`` server equals the in-process one, the dispatcher's import
pulls in no torch, depth 1 equals depth 2, and the serve CLI's flags and
refusals. Every wait has its own timeout."""

import argparse
import functools
import http.client
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from variational_mmt_tpu.config import DecodeConfig as JaxDecodeConfig
from variational_mmt_tpu.config import ModelConfig as JaxModelConfig
from variational_mmt_tpu.data.vocab import SPECIALS as JAX_SPECIALS
from variational_mmt_tpu.data.vocab import Vocab as JaxVocab
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.models.model import init_params as jax_init_params
from variational_mmt_tpu.serve import ServeConfig as JaxServeConfig
from variational_mmt_tpu.serve import TranslationService as JaxTranslationService
from variational_mmt_torch.cli import serve as cli_serve
from variational_mmt_torch.config import DecodeConfig, ModelConfig
from variational_mmt_torch.convert import params_from_jax
from variational_mmt_torch.data.vocab import SPECIALS, Vocab
from variational_mmt_torch.decode.translator import Translator
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.serve import (ClientError, MPServingServer, ServeConfig,
                                         ServingServer, TranslationService)
from variational_mmt_torch.serve.service import _Request
from variational_mmt_torch.utils.msgpack_codec import packb, unpackb

WAIT = 60  # seconds, every future, socket and child process
WORDS = [f"w{i}" for i in range(20)]
MODEL = dict(src_vocab_size=24, tgt_vocab_size=24, emb_dim=16, hidden_dim=32, enc_layers=1,
             dec_layers=2, latent_dim=4, img_feat_dim=8, dropout=0.0, compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def jax_tree(model_type="vmmt_c"):
    """JAX's model and parameters (init + noise; built once a model type,
    never mutated)."""
    jmodel = jax_build_model(JaxModelConfig(model_type=model_type, **MODEL))
    rng = np.random.default_rng(7)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))).astype(np.float32),
        jax.device_get(jax_init_params(jmodel, jax.random.PRNGKey(7))))
    return jmodel, tree


def port_model(tree, model_type="vmmt_c"):
    cfg = ModelConfig(model_type=model_type, **MODEL)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    return model


def small_service(model_type="vmmt_c", max_wait_ms=50.0, batch_size=4, warmup=False,
                  dec=None, **scfg_kw):
    _, tree = jax_tree(model_type)
    model = port_model(tree, model_type)
    dcfg = DecodeConfig(**{"beam_size": 4, "max_length": 12, "batch_size": batch_size,
                           **(dec or {})})
    vocab = Vocab(SPECIALS + WORDS)
    svc = TranslationService(model, vocab, vocab, dcfg, buckets=[8], device="cpu",
                             scfg=ServeConfig(max_wait_ms=max_wait_ms, warmup=warmup,
                                              **scfg_kw))
    return dcfg, model, vocab, svc


def sampling_service(latent=False, **scfg_kw):
    return small_service(dec=dict(beam_size=1, sampling_temp=1.2,
                                  latent_from="sample" if latent else "mean"),
                         max_wait_ms=30.0, **scfg_kw)


def post(base, payload, timeout=WAIT):
    req = urllib.request.Request(base + "/translate", data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def post_msgpack(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request("POST", "/translate", body=packb(payload),
                     headers={"Content-Type": "application/x-msgpack"})
        resp = conn.getresponse()
        return resp.status, unpackb(resp.read())
    finally:
        conn.close()


def http_error(base, body: bytes, timeout=WAIT):
    req = urllib.request.Request(base + "/translate", data=body, method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=timeout)
    return ei.value.code, ei.value.read()


def test_service_matches_offline_and_jax_service():
    """Online answers equal the port's offline Translator and JAX's
    TranslationService on the same parameters (ids identical, f32)."""
    dcfg, model, vocab, svc = small_service()
    jmodel, tree = jax_tree()
    jsvc = JaxTranslationService(
        jmodel, tree, JaxVocab(JAX_SPECIALS + WORDS), JaxVocab(JAX_SPECIALS + WORDS),
        JaxDecodeConfig(beam_size=4, max_length=12, batch_size=4), buckets=[8],
        scfg=JaxServeConfig(max_wait_ms=50.0, warmup=False))
    try:
        texts = ["w1 w2 w3", "w4 w5", "w6 w7 w8 w9"]
        imgs = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
        online = svc.translate_text(texts, imgs, timeout=WAIT)
        tr = Translator(model, vocab, vocab, dcfg, buckets=[8], device="cpu")
        offline = tr.translate_tokens([t.split() for t in texts], imgs)
        assert [nb[0][1] for nb in online] == [nb[0][1] for nb in offline]
        assert [nb[0][0] for nb in online] == pytest.approx([nb[0][0] for nb in offline])
        ids = [vocab.encode(t.split()) for t in texts]
        raw = [f.result(WAIT) for f in svc.submit_ids_batch(ids, imgs)]
        jraw = [f.result(WAIT) for f in jsvc.submit_ids_batch(ids, imgs)]
        assert [[i for _, i in nb] for nb in raw] == [[i for _, i in nb] for nb in jraw]
        np.testing.assert_allclose([s for nb in raw for s, _ in nb],
                                   [s for nb in jraw for s, _ in nb], atol=1e-4)
        jtext = jsvc.translate_text(texts, imgs)
        assert [[t for _, t in nb] for nb in online] == [[t for _, t in nb] for nb in jtext]
    finally:
        svc.stop()
        jsvc.stop()


def test_over_length_request_rejected_not_compiled():
    _, _, _, svc = small_service()  # buckets=[8]
    try:
        with pytest.raises(ValueError, match="caps at 8"):
            svc.translate_text([" ".join(f"w{i % 20}" for i in range(9))])
        assert svc.translate_text(["w1 w2"], np.zeros((1, 8), np.float32), timeout=WAIT)
    finally:
        svc.stop()


def test_over_length_truncate_matches_offline_prefix():
    dcfg, model, vocab, svc = small_service(over_length="truncate")
    try:
        toks = [f"w{i % 20}" for i in range(11)]
        img = np.zeros((1, 8), np.float32)
        online = svc.translate_text([" ".join(toks)], img, timeout=WAIT)
        tr = Translator(model, vocab, vocab, dcfg, buckets=[8], device="cpu")
        assert online[0][0][1] == tr.translate_tokens([toks[:8]], img)[0][0][1]
    finally:
        svc.stop()


def test_max_src_tokens_extends_warmed_buckets():
    _, _, _, svc = small_service(max_src_tokens=12)
    try:
        assert 12 in svc.translator.buckets
        ok = svc.translate_text([" ".join(f"w{i % 20}" for i in range(12))],
                                np.zeros((1, 8), np.float32), timeout=WAIT)
        assert ok and ok[0]
        with pytest.raises(ValueError, match="caps at 12"):
            svc.translate_text([" ".join(f"w{i % 20}" for i in range(13))])
    finally:
        svc.stop()


def test_batch_rejection_is_atomic():
    _, _, _, svc = small_service()
    try:
        before = svc.stats["requests"]
        with pytest.raises(ClientError, match="caps at 8"):
            svc.translate_text(["w1 w2", "w3 w4", " ".join(f"w{i % 20}" for i in range(9))])
        assert svc.stats["requests"] == before
    finally:
        svc.stop()


def test_negative_max_src_tokens_rejected_at_construction():
    with pytest.raises(ValueError, match="max_src_tokens"):
        small_service(max_src_tokens=-5)


def test_dispatcher_maps_only_client_errors_to_400():
    from variational_mmt_torch.serve.frontend import _DispatcherBackend

    class FakeRPC:
        def __init__(self, resp):
            self.resp = resp

        def call(self, obj, timeout):
            return self.resp

    be = _DispatcherBackend(FakeRPC({"error": "ClientError: too long"}), None, lower=True)
    with pytest.raises(ClientError, match="too long"):
        be.translate(["x"], None, 5.0)
    be = _DispatcherBackend(FakeRPC({"error": "ValueError: server bug"}), None, lower=True)
    with pytest.raises(RuntimeError, match="server bug"):
        be.translate(["x"], None, 5.0)


def test_dynamic_batching_coalesces():
    _, _, _, svc = small_service(max_wait_ms=200.0, batch_size=4)
    try:
        img = np.zeros((8,), np.float32)
        futs = [svc.submit_text(f"w{1 + i % 5} w2", img) for i in range(8)]
        for f in futs:
            f.result(timeout=WAIT)
        assert svc.stats["requests"] == 8
        assert svc.stats["batches"] <= 6
    finally:
        svc.stop()


def test_missing_img_zero_filled():
    """A text-only request gets the zero feature vector: its answer equals
    the offline translation with zero features."""
    dcfg, model, vocab, svc = small_service()
    try:
        out = svc.translate_text(["w1 w2"], timeout=WAIT)
        tr = Translator(model, vocab, vocab, dcfg, buckets=[8], device="cpu")
        assert out[0] == tr.translate_tokens([["w1", "w2"]], np.zeros((1, 8), np.float32))[0]
    finally:
        svc.stop()


def test_img_shape_validated():
    _, _, _, svc = small_service()
    try:
        with pytest.raises(ClientError):
            svc.submit_text("w1", np.zeros((5,), np.float32))
    finally:
        svc.stop()


def test_http_roundtrip():
    _, _, _, svc = small_service()
    server = ServingServer(svc, port=0, info={"model_type": "vmmt_c", "step": 0})
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=WAIT) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["model_type"] == "vmmt_c"
        out = post(base, {"texts": ["w1 w2 w3", "w4"]})
        assert len(out["results"]) == 2
        assert all({"score", "text"} <= set(nbest[0]) for nbest in out["results"])
        assert http_error(base, b'{"texts": "nope"}')[0] == 400
        code, body = http_error(base, json.dumps(
            {"texts": [" ".join(f"w{i % 20}" for i in range(9))]}).encode())
        assert code == 400 and b"caps at 8" in body
        with urllib.request.urlopen(base + "/stats", timeout=WAIT) as r:
            assert json.loads(r.read())["requests"] >= 2
    finally:
        server.stop()


def test_http_concurrent_clients_batch_together():
    _, _, _, svc = small_service(max_wait_ms=300.0)
    server = ServingServer(svc, port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    results = {}

    def client(i):
        results[i] = post(base, {"texts": [f"w{i + 1} w2"]})

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == 4
        assert svc.stats["batched_requests"] >= 2
    finally:
        server.stop()


def test_serve_cli_args_parse():
    p = argparse.ArgumentParser()
    cli_serve.add_args(p)
    opt = p.parse_args(["-model", "x", "-port", "0", "-max_wait_ms", "2.5", "-max_src_tokens",
                        "96", "-over_length", "truncate", "-ensemble_mode", "logprob",
                        "-infer_dtype", "bfloat16", "-pipeline_depth", "2", "-procs", "2",
                        "-sampling_temp", "1.0", "-sampling_topk", "10", "-latent_from",
                        "sample", "-seed", "3", "-coverage_beta", "0.2",
                        "-block_ngram_repeat", "2", "-ignore_when_blocking", ". ,"])
    assert opt.port == 0 and opt.max_wait_ms == 2.5
    assert opt.max_src_tokens == 96 and opt.over_length == "truncate"
    assert opt.ensemble_mode == "logprob" and opt.infer_dtype == "bfloat16"
    assert (opt.pipeline_depth, opt.procs, opt.sampling_topk, opt.seed) == (2, 2, 10, 3)
    assert opt.device == "cuda"  # the card unless -device cpu


@pytest.mark.parametrize("flags,item", [
    (["-tensor_parallel", "2"], "5.8"),
], ids=lambda x: " ".join(x) if isinstance(x, list) else x)
def test_serve_cli_refuses_what_is_not_ported_naming_its_roadmap_item(flags, item):
    argv = ["-model", "nowhere", "-device", "cpu", *flags]
    with pytest.raises(SystemExit, match=f"not ported yet: .*ROADMAP.md .*{item}"):
        cli_serve.main(argv)


@pytest.mark.parametrize("flags", [["-model", "ENSEMBLE"], ["-infer_dtype", "bfloat16"],
                                   ["-infer_dtype", "int8"]],
                         ids=lambda x: " ".join(x))
def test_serve_cli_takes_the_options_once_refused(flags, tmp_path, monkeypatch):
    """Once refused naming item 5.4: the serve CLI over a comma-separated
    ``-model`` (vmmt_c + nmt checkpoints) and at ``-infer_dtype`` bfloat16
    and int8 answers HTTP requests as the offline Translator does with the
    same options, and its info record names the members."""
    from variational_mmt_torch.config import Config
    from variational_mmt_torch.serve import http_server
    from variational_mmt_torch.train import checkpoint as ck
    from variational_mmt_torch.train.trainer import create_train_state

    vocab = Vocab(SPECIALS + WORDS)
    runs, models = [], []
    for model_type in ("vmmt_c", "nmt"):
        cfg = Config(model=ModelConfig(model_type=model_type, **MODEL))
        model = port_model(jax_tree(model_type)[1], model_type)
        runs.append(ck.save_checkpoint(str(tmp_path / model_type),
                                       create_train_state(cfg, model), cfg, vocab, vocab))
        models.append(model)
    ensemble = flags[1] == "ENSEMBLE"
    model_flag = ",".join(runs) if ensemble else runs[0]
    texts = ["w1 w2 w3", "w4 w5", "w6 w7 w8 w9"]
    imgs = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
    seen = {}

    def answer(server):
        """In place of serve_forever: one health check and one request."""
        server.start()
        url = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(url + "/healthz", timeout=WAIT) as r:
            seen["info"] = json.loads(r.read())
        body = json.dumps({"texts": texts, "imgs": imgs.tolist()}).encode()
        req = urllib.request.Request(url + "/translate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            seen["out"] = json.loads(r.read())

    monkeypatch.setattr(http_server.ServingServer, "serve_forever", answer)
    extra = [] if ensemble else flags
    cli_serve.main(["-model", model_flag, "-port", "0", "-device", "cpu", "-no_warmup",
                    "-batch_size", "4", "-max_length", "12", *extra])
    dcfg = DecodeConfig(beam_size=4, max_length=12, batch_size=4,
                        infer_dtype="float32" if ensemble else flags[1])
    want = Translator(models if ensemble else models[0], vocab, vocab, dcfg,
                      buckets=[16, 24, 32, 48, 64], device="cpu"
                      ).translate_tokens([t.split() for t in texts], imgs)
    got = seen["out"]["results"]
    assert [[(e["score"], e["text"]) for e in g] for g in got] == [
        [(float(sc), t) for sc, t in w] for w in want]
    info = seen["info"]
    assert info["ensemble"] == (2 if ensemble else 0)
    assert info["model_type"] == ("vmmt_c,nmt" if ensemble else "vmmt_c")
    if ensemble:
        assert info["model_types"] == ["vmmt_c", "nmt"] and info["steps"] == [0, 0]


def test_serve_cli_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["-device", "cuda"]):
        with pytest.raises(SystemExit, match="CUDA.*-device cpu"):
            cli_serve.main(["-model", "nowhere", *extra])


def test_http_msgpack_binary_wire_matches_json():
    """The msgpack endpoint (raw float32 image bytes, through the port's
    codec) returns what the JSON endpoint returns."""
    _, _, _, svc = small_service()
    server = ServingServer(svc, port=0)
    server.start()
    try:
        texts = ["w1 w2 w3", "w4"]
        imgs = np.random.default_rng(3).standard_normal((2, 8)).astype(np.float32)
        out_json = post(f"http://127.0.0.1:{server.port}",
                        {"texts": texts, "imgs": imgs.tolist()})
        status, out_mp = post_msgpack(server.port, {
            "texts": texts, "imgs": {"shape": list(imgs.shape), "data": imgs.tobytes()}})
        assert status == 200
        assert out_mp["results"] == out_json["results"]
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=WAIT)
        conn.request("POST", "/translate", body=b"\x81\xa5texts\xa4nope",
                     headers={"Content-Type": "application/x-msgpack"})
        resp = conn.getresponse()
        assert resp.status == 400 and "error" in unpackb(resp.read())
        conn.request("POST", "/translate", body=b"\x82\xa5te",  # truncated
                     headers={"Content-Type": "application/x-msgpack"})
        resp = conn.getresponse()
        assert resp.status == 400
        resp.read()
        conn.close()
    finally:
        server.stop()


def test_cancelled_future_does_not_poison_batch():
    _, _, _, svc = small_service(max_wait_ms=400.0)
    try:
        f1, f2, f3 = svc.submit_text("w1 w2"), svc.submit_text("w3 w4"), svc.submit_text("w5")
        assert f2.cancel()
        assert isinstance(f1.result(timeout=WAIT)[0][1], str)
        assert isinstance(f3.result(timeout=WAIT)[0][1], str)
        assert f2.cancelled()
    finally:
        svc.stop()


def test_stop_drains_racing_submissions():
    _, _, _, svc = small_service()
    svc.stop()
    req = _Request(ids=[5], img=None)
    svc._q.put(req)  # the submit-vs-stop race, lost
    svc.stop()
    with pytest.raises(RuntimeError, match="service stopped"):
        req.future.result(timeout=5)


def test_mp_server_roundtrip_matches_in_process():
    """``-procs 2``: the dispatchers (spawned, torch-free) tokenize and
    take the id-level wire; JSON and msgpack through them equal the
    in-process service."""
    _, _, _, svc = small_service()
    server = MPServingServer(svc, port=0, procs=2, info={"model_type": "vmmt_c", "step": 0})
    try:
        server.start(timeout=WAIT)
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/healthz", timeout=WAIT) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["model_type"] == "vmmt_c" and health["ids_wire"] is True
        texts = ["w1 w2 w3", "w4", "w5 w6"]
        imgs = np.random.default_rng(3).standard_normal((3, 8)).astype(np.float32)
        out_http = post(base, {"texts": texts, "imgs": imgs.tolist()})
        status, out_mp = post_msgpack(server.port, {
            "texts": texts, "imgs": {"shape": list(imgs.shape), "data": imgs.tobytes()}})
        assert status == 200
        direct = svc.translate_text(texts, imgs, timeout=WAIT)
        want = [[{"score": s, "text": t} for s, t in nb] for nb in direct]
        assert out_http["results"] == want and out_mp["results"] == want
        assert http_error(base, b'{"texts": "nope"}')[0] == 400
        code, body = http_error(base, json.dumps(
            {"texts": [" ".join(f"w{i % 20}" for i in range(9))]}).encode())
        assert code == 400 and b"caps at 8" in body
        with urllib.request.urlopen(base + "/stats", timeout=WAIT) as r:
            assert json.loads(r.read())["requests"] >= 6
    finally:
        server.stop()
    assert not any(p.is_alive() for p in server._procs)


def test_mp_server_concurrent_clients():
    _, _, _, svc = small_service(max_wait_ms=300.0)
    server = MPServingServer(svc, port=0, procs=2)
    results = {}
    try:
        server.start(timeout=WAIT)
        base = f"http://127.0.0.1:{server.port}"

        def client(i):
            results[i] = post(base, {"texts": [f"w{i + 1} w2"]})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == 4
        assert svc.stats["batched_requests"] >= 2
    finally:
        server.stop()


def test_empty_source_rejected():
    _, _, _, svc = small_service()
    try:
        with pytest.raises(ClientError, match="empty source"):
            svc.translate_text(["w1 w2", ""])
        assert svc.stats["requests"] == 0
    finally:
        svc.stop()


def test_stop_without_start_does_not_hang():
    _, _, _, svc = small_service()
    server = ServingServer(svc, port=0)
    t0 = time.time()
    server.stop()
    assert time.time() - t0 < 5.0


def test_oversized_body_rejected():
    import socket

    _, _, _, svc = small_service()
    server = ServingServer(svc, port=0)
    server.start()
    try:
        s = socket.create_connection(("127.0.0.1", server.port), timeout=WAIT)
        s.sendall(b"POST /translate HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                  b"Content-Length: 10737418240\r\n\r\n")
        s.settimeout(WAIT)
        assert " 413 " in s.recv(4096).decode("utf-8", "replace").splitlines()[0]
        s.close()
    finally:
        server.stop()


def test_dispatcher_import_stays_torch_free():
    """What a dispatcher process imports (the frontend, the RPC, the codec,
    the tokenizer, BPE and vocab) loads neither torch nor msgpack nor the
    model stack."""
    code = (
        "import sys\n"
        "import variational_mmt_torch.serve.frontend as f\n"
        "import variational_mmt_torch.serve.rpc\n"
        "import variational_mmt_torch.serve\n"
        "f._DispatcherBackend(None, [('a', 'b')], True, vocabs=(['<blank>', '<unk>', '<s>', "
        "'</s>'],) * 2)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'msgpack', 'jax')\n"
        "       or (m.startswith('variational_mmt_torch') and any(\n"
        "           k in m for k in ('service', 'translator', 'models', 'dataset')))]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=WAIT)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_submit_ids_batch_matches_tokens_path():
    _, _, vocab, svc = small_service()
    try:
        texts = ["w1 w2 w3", "w4 w5", "w6 w7 w8 w9"]
        imgs = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
        ids = [vocab.encode(t.split()) for t in texts]
        raw = [f.result(timeout=WAIT) for f in svc.submit_ids_batch(ids, imgs)]
        text_out = svc.translate_text(texts, imgs, timeout=WAIT)
        for nbest_ids, nbest_text in zip(raw, text_out):
            assert [s for s, _ in nbest_ids] == pytest.approx([s for s, _ in nbest_text])
            assert [vocab.ids_to_text(i) for _, i in nbest_ids] == [t for _, t in nbest_text]
    finally:
        svc.stop()


def test_pipelined_worker_many_groups_in_order():
    dcfg, model, vocab, svc = small_service(max_wait_ms=1.0, batch_size=2)
    try:
        texts = [f"w{1 + (i % 19)} w{1 + ((i * 7) % 19)}" for i in range(24)]
        futs = [svc.submit_text(t) for t in texts]
        got = [f.result(timeout=WAIT)[0][1] for f in futs]
        tr = Translator(model, vocab, vocab, dcfg, buckets=[8], device="cpu")
        want = [nb[0][1] for nb in tr.translate_tokens(
            [t.split() for t in texts], np.zeros((len(texts), 8), np.float32))]
        assert got == want
        assert svc.stats["batches"] >= 12
    finally:
        svc.stop()


def test_rpc_translate_ids_refused_with_replace_unk():
    from variational_mmt_torch.serve.rpc import RPCServer

    _, _, _, svc = small_service(model_type="nmt", dec=dict(beam_size=2, max_length=8,
                                                            replace_unk=True),
                                 batch_size=2, max_wait_ms=1.0)
    try:
        srv = RPCServer.__new__(RPCServer)  # no socket: _dispatch only
        srv.service, srv.info = svc, {}
        with pytest.raises(ValueError, match="replace_unk"):
            srv._dispatch({"op": "translate_ids", "ids": [[5, 6]]})
    finally:
        svc.stop()


def test_pipeline_depth1_matches_depth2():
    texts = [f"w{1 + (i % 19)} w{1 + ((i * 5) % 19)} w{1 + ((i * 11) % 19)}"
             for i in range(17)]
    outs = {}
    for depth in (1, 2):
        _, _, _, svc = small_service(max_wait_ms=1.0, batch_size=4, pipeline_depth=depth)
        try:
            assert svc.pipeline_depth == depth
            futs = [svc.submit_text(t) for t in texts]
            outs[depth] = [f.result(timeout=WAIT) for f in futs]
            assert svc.stats["batches"] >= 2
        finally:
            svc.stop()
    assert outs[1] == outs[2]


def test_pipeline_depth_auto_resolves_from_host_cores(monkeypatch):
    import variational_mmt_torch.serve.service as service_mod

    monkeypatch.setattr(service_mod.os, "cpu_count", lambda: 1)
    assert ServeConfig().resolved_pipeline_depth() == 1
    assert ServeConfig(pipeline_depth=2).resolved_pipeline_depth() == 2
    monkeypatch.setattr(service_mod.os, "cpu_count", lambda: 4)
    assert ServeConfig().resolved_pipeline_depth() == 2
    assert ServeConfig(pipeline_depth=1).resolved_pipeline_depth() == 1
    monkeypatch.setattr(service_mod.os, "cpu_count", lambda: None)
    assert ServeConfig().resolved_pipeline_depth() == 1
    monkeypatch.setattr(service_mod.os, "cpu_count", lambda: 1)
    _, _, _, svc = small_service(max_wait_ms=1.0, batch_size=4)
    try:
        assert svc.pipeline_depth == 1
        assert svc.submit_text("w1 w2").result(timeout=WAIT)
    finally:
        svc.stop()


def test_collect_fill_contract():
    _, _, _, svc = small_service(batch_size=3)
    svc.stop()
    svc._stop_seen = False
    probes = []

    def never_ready():
        probes.append(1)
        return False

    assert svc._collect_fill(never_ready) == []
    assert not probes
    for _ in range(3):
        svc._q.put(_Request(ids=[5], img=None))
    assert len(svc._collect_fill(never_ready)) == 3
    assert not probes
    svc._q.put(_Request(ids=[5], img=None))
    calls = []

    def ready_on_second():
        calls.append(1)
        return len(calls) >= 2

    assert len(svc._collect_fill(ready_on_second)) == 1
    assert svc._stop_seen is False


def test_pending_translation_ready_follows_the_device_thread():
    """dispatch_ids returns before the search ends: ``ready()`` is the last
    batch's future's ``done()`` and never raises."""
    from variational_mmt_torch.decode.translator import PendingTranslation

    gate = threading.Event()
    f = Future()
    pending = PendingTranslation([(None, f)], 1)
    assert not pending.ready()
    f.set_exception(RuntimeError("device error"))
    assert pending.ready()
    assert PendingTranslation([], 0).ready()
    dcfg, model, vocab, svc = small_service()
    svc.stop()
    tr = svc.translator
    tr._device_thread().submit(gate.wait, WAIT)  # hold the device thread
    p = tr.dispatch_ids([[5, 6], [7]], np.zeros((2, 8), np.float32))
    assert not p.ready()
    gate.set()
    out = tr.finalize_ids(p)
    assert p.ready() and len(out) == 2
    tr.close()


def test_expired_requests_shed_not_computed():
    _, _, _, svc = small_service(max_wait_ms=20.0, batch_size=4)
    try:
        dead = svc.submit_text("w1 w2", timeout_s=-1.0)
        live = svc.submit_text("w3 w4")
        assert isinstance(live.result(timeout=WAIT)[0][1], str)
        with pytest.raises(TimeoutError, match="shed"):
            dead.result(timeout=WAIT)
        assert svc.stats["shed"] == 1
    finally:
        svc.stop()


def test_http_maps_shed_to_503():
    import socketserver

    from variational_mmt_torch.serve.frontend import Backend, make_http_handler

    class SheddingBackend(Backend):
        def translate(self, texts, imgs, timeout, sample_ids=None):
            raise TimeoutError("request deadline expired (shed under load)")

    httpd = socketserver.TCPServer(("127.0.0.1", 0), make_http_handler(SheddingBackend()))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        code, body = http_error(f"http://127.0.0.1:{httpd.server_address[1]}",
                                json.dumps({"texts": ["hi"]}).encode())
        assert code == 503 and "overloaded" in json.loads(body)["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=WAIT)


def test_sampled_serving_reproducible_and_group_invariant():
    """A sampled answer is keyed by (seed, sample_id, source, image), not
    by where the batcher placed the request."""
    _, _, _, svc = sampling_service(latent=True)
    try:
        img = np.random.default_rng(0).standard_normal(8).astype(np.float32)
        alone = svc.submit_tokens(["w3", "w4"], img, sample_id=5).result(WAIT)
        futs = [svc.submit_tokens(["w9", "w8", "w7"], img, sample_id=1),
                svc.submit_tokens(["w3", "w4"], img, sample_id=5),
                svc.submit_tokens(["w1"], img, sample_id=2)]
        assert futs[1].result(WAIT) == alone
        outs = {tuple(svc.submit_tokens(["w3", "w4"], img, sample_id=s).result(WAIT)[0][1]
                      .split()) for s in range(6)}
        assert len(outs) > 1
    finally:
        svc.stop()


def test_sample_id_rejected_on_deterministic_service():
    _, _, _, svc = small_service()
    try:
        with pytest.raises(ClientError, match="sampling service"):
            svc.submit_tokens(["w1"], None, sample_id=3)
        assert svc.submit_tokens(["w1"], None, sample_id=0).result(WAIT)
    finally:
        svc.stop()


def test_negative_sample_id_rejected():
    _, _, _, svc = sampling_service()
    try:
        with pytest.raises(ClientError, match=">= 0"):
            svc.submit_tokens(["w1"], None, sample_id=-1)
    finally:
        svc.stop()


def test_sampled_serving_http_sample_ids():
    _, _, _, svc = sampling_service()
    server = ServingServer(svc, port=0, info={"model_type": "vmmt_c", "step": 0})
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        out = post(base, {"texts": ["w3 w4", "w3 w4"], "sample_ids": [4, 4]})
        assert out["results"][0] == out["results"][1]
        code, _ = http_error(base, json.dumps({"texts": ["w1"], "sample_ids": [1, 2]}).encode())
        assert code == 400
    finally:
        server.stop()


def test_http_sample_ids_rejected_by_beam_server():
    _, _, _, svc = small_service()
    server = ServingServer(svc, port=0, info={"model_type": "vmmt_c", "step": 0})
    server.start()
    try:
        code, body = http_error(f"http://127.0.0.1:{server.port}",
                                json.dumps({"texts": ["w1"], "sample_ids": [1]}).encode())
        assert code == 400 and b"sampling service" in body
    finally:
        server.stop()


def test_wire_codec_round_trips_plain_values():
    """The wire's codec (torch-free) reads back maps, lists, strings, ints,
    floats and bytes, and refuses a truncated frame with ValueError."""
    msg = {"op": "translate_ids", "ids": [[5, 6], [70000, -3]], "timeout": 60.5,
           "imgs": {"shape": [2, 3], "data": np.arange(6, dtype="<f4").tobytes()},
           "sample_ids": None, "flag": True, "text": "ä" * 40}
    assert unpackb(packb(msg)) == msg
    with pytest.raises(ValueError):
        unpackb(packb(msg)[:-3])
