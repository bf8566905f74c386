"""PyTorch port: serving across ranks (``TranslationService(mesh=)``,
``cli.serve -tensor_parallel``; ROADMAP.md item 5.10) on a CPU gloo mesh of
2 ranks, each a process (tests/torch_parallel_worker.py, groups ``serve``
and ``serve_fail``, each spawned once with a timeout; the groups'
collectives time out after ``GROUP_TIMEOUT_S``).

- TP-2 (1 x 2) and DP-2 (2 x 1), each at pipeline depth 1 and 2: rank 0
  serves 16 single-sentence requests submitted from 4 threads while rank 1
  follows. The answers equal the port's offline ``Translator`` on the same
  mesh, and JAX's ``TranslationService`` on a (1, 2) and a (2, 1) mesh of
  its virtual CPU devices (token ids equal, scores within 1e-4, f32, as
  tests/test_torch_parallel_decode.py holds decoding).
- A sampling service keyed by ``sample_ids`` on TP-2 answers as one
  process does.
- A shed request is shed on rank 0 (its followers never see it) and the
  next request is answered; an idle wait of 3 group timeouts is survived.
- ``stop()`` ends every rank with exit code 0; a failure raised on rank 1
  ends both ranks, rank 0's request failing, well inside the timeout.
- ``cli.serve -tensor_parallel 2 -device cpu`` under ``torchrun`` answers a
  POST /translate as the single-process path does, and stops, every rank
  with exit code 0, on SIGTERM to rank 0. The CLI's refusals.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from test_torch_parallel import cfg_dict, np_tree
from test_tp import V, tp_cfg
from torch_parallel_worker import ROOT, spawn
from variational_mmt_tpu.config import DecodeConfig as JaxDecodeConfig
from variational_mmt_tpu.data.vocab import SPECIALS as JAX_SPECIALS
from variational_mmt_tpu.data.vocab import Vocab as JaxVocab
from variational_mmt_tpu.models.model import build_model as jax_build_model
from variational_mmt_tpu.parallel.tp import make_mesh_2d
from variational_mmt_tpu.serve import ServeConfig as JaxServeConfig
from variational_mmt_tpu.serve import TranslationService as JaxTranslationService
from variational_mmt_tpu.train.trainer import create_train_state as jax_create_train_state
from variational_mmt_torch.config import DecodeConfig
from variational_mmt_torch.serve import ServeConfig, TranslationService

TIMEOUT_S = 150  # the 2 ranks of the module's cases, with their start-up
FAIL_TIMEOUT_S = 60
GROUP_TIMEOUT_S = 2.0  # every collective of the ranks' groups
CLI_TIMEOUT_S = 90
DCFG = dict(beam_size=3, max_length=8, batch_size=4)
SAMPLE_DCFG = dict(beam_size=1, max_length=8, batch_size=4, sampling_temp=1.2)
N_SENT = 16


def serve_inputs():
    jcfg = tp_cfg()
    tree = np_tree(jax_create_train_state(jcfg, jax_build_model(jcfg.model)).params)
    rng = np.random.default_rng(11)
    src = [list(map(int, rng.integers(4, V, rng.integers(3, 7)))) for _ in range(N_SENT)]
    img = rng.standard_normal((N_SENT, 16)).astype(np.float32)
    return jcfg, tree, {"cfg": cfg_dict(jcfg), "tree": tree, "dcfg": DCFG, "src": src,
                        "img": img, "sample_dcfg": SAMPLE_DCFG,
                        "sample_ids": [i % 5 for i in range(N_SENT)]}


def jax_served(jcfg, tree, d, mesh):
    vocab = JaxVocab(JAX_SPECIALS + [f"w{i}" for i in range(V - 4)])
    svc = JaxTranslationService(jax_build_model(jcfg.model), tree, vocab, vocab,
                                JaxDecodeConfig(**DCFG), buckets=[8],
                                scfg=JaxServeConfig(warmup=False, max_wait_ms=20.0), mesh=mesh)
    try:
        return [f.result(timeout=120) for f in svc.submit_ids_batch(d["src"], d["img"])]
    finally:
        svc.stop()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg, tree, d = serve_inputs()
    ranks = spawn("serve", 2, str(tmp_path_factory.mktemp("serve_ranks")),
                  {"serve": d, "timeout": GROUP_TIMEOUT_S}, TIMEOUT_S)
    jax_side = {name: jax_served(jcfg, tree, d, make_mesh_2d(*shape))
                for name, shape in (("1x2", (1, 2)), ("2x1", (2, 1)))}
    return d, ranks[0]["case_serve"], jax_side


def assert_nbest(got, want, rtol=1e-4, atol=1e-4):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert [list(ids) for _, ids in a] == [list(ids) for _, ids in b], (a, b)
        np.testing.assert_allclose([s for s, _ in a], [s for s, _ in b], rtol=rtol, atol=atol)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_served_answers_match_the_offline_mesh_and_jax(run, mesh, depth):
    d, got, jax_side = run
    served = got[(mesh, depth)]["served"]
    assert served == got[(mesh, "offline")]
    assert_nbest(served, jax_side[mesh])
    assert got[(mesh, depth)]["stats"]["requests"] >= N_SENT


def test_sampling_across_ranks_matches_one_process(run):
    """TP-2 sampling keyed by sample_ids: the answers of one process's
    service for the same ids (the draws depend on the id, not the batch)."""
    d, got, _ = run
    from torch_parallel_worker import _cfg, _model, _vocab

    cfg = _cfg(d["cfg"])
    svc = TranslationService(_model(cfg, d["tree"]), _vocab(cfg), _vocab(cfg),
                             DecodeConfig(**SAMPLE_DCFG), buckets=[8], device="cpu",
                             scfg=ServeConfig(warmup=False, max_wait_ms=20.0))
    try:
        want = [f.result(timeout=60) for f in svc.submit_ids_batch(d["src"], d["img"],
                                                                   sample_ids=d["sample_ids"])]
    finally:
        svc.stop()
    assert_nbest(got["sampled"], want)
    assert len({tuple(n[0][1]) for n in got["sampled"]}) > 1


def test_a_shed_request_and_an_idle_server(run):
    """The expired request is shed on rank 0, the next one answered; after
    3 group timeouts without a request the DP-2 service still answers."""
    d, got, _ = run
    tp2 = got[("1x2", 2)]
    assert "shed" in tp2["shed"] and tp2["stats"]["shed"] == 1
    assert tp2["after_shed"] == got[("1x2", "offline")][1]
    assert got[("2x1", 1)]["after_idle"] == got[("2x1", "offline")][2]


def test_a_failing_rank_ends_the_service(tmp_path):
    """Rank 1 raises in its first dispatch: rank 0's request fails and both
    ranks exit non-zero (rank 0 with 3, its case's code for a failed
    service) well inside the timeout."""
    _, _, d = serve_inputs()
    t0 = time.monotonic()
    codes = spawn("serve_fail", 2, str(tmp_path), {"serve": d, "timeout": GROUP_TIMEOUT_S},
                  FAIL_TIMEOUT_S, check=False)
    secs = time.monotonic() - t0
    log0 = (tmp_path / "log_0.txt").read_text()
    log1 = (tmp_path / "log_1.txt").read_text()
    assert codes[0] == 3, log0
    assert codes[1] not in (0, -9), log1
    assert "injected failure on rank 1" in log1 and "rank 0's request failed" in log0
    assert secs < FAIL_TIMEOUT_S - 10


def test_a_batch_the_data_ranks_cannot_share_is_refused():
    from test_torch_parallel import no_group_mesh
    from torch_parallel_worker import _cfg, _model, _vocab

    _, _, d = serve_inputs()
    cfg = _cfg(d["cfg"])
    with pytest.raises(ValueError, match="divide by the data-parallel degree 2"):
        TranslationService(_model(cfg, d["tree"]), _vocab(cfg), _vocab(cfg),
                           DecodeConfig(**dict(DCFG, batch_size=3)), buckets=[8],
                           mesh=no_group_mesh(2, 1), device="cpu",
                           scfg=ServeConfig(warmup=False))


def test_serve_cli_under_torchrun_needs_tensor_parallel(monkeypatch):
    from variational_mmt_torch.cli import serve as cli_serve

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="-tensor_parallel 1 would leave ranks idle"):
        cli_serve.main(["-model", "nowhere", "-device", "cpu"])


def read_until(proc, pattern, deadline, seen):
    """Lines of ``proc``'s stdout until one matches ``pattern``."""
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        seen.append(line)
        m = re.search(pattern, line)
        if m:
            return m
    raise AssertionError(f"no line matching {pattern!r}:\n" + "".join(seen)[-4000:])


def test_serve_cli_under_torchrun_answers_and_stops_on_sigterm(tmp_path):
    from torch_parallel_worker import _cfg, _model, _vocab
    from variational_mmt_torch.cli.serve import DEFAULT_BUCKETS
    from variational_mmt_torch.decode.translator import Translator
    from variational_mmt_torch.train import checkpoint as ck
    from variational_mmt_torch.train.trainer import create_train_state

    _, _, d = serve_inputs()
    cfg = _cfg(d["cfg"])
    model, vocab = _model(cfg, d["tree"]), _vocab(cfg)
    run_dir = ck.save_checkpoint(str(tmp_path / "run"), create_train_state(cfg, model), cfg,
                                 vocab, vocab)
    texts = ["w1 w2 w3", "w4 w5", "w6 w7 w8 w9"]
    imgs = d["img"][:3]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "variational_mmt_torch.cli.serve", "-model", run_dir, "-port", "0",
           "-device", "cpu", "-tensor_parallel", "2", "-batch_size", "4", "-max_length", "8"]
    proc = subprocess.Popen(cmd, cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    seen = []
    try:
        deadline = time.monotonic() + CLI_TIMEOUT_S
        pid = int(read_until(proc, r"rank 0 is pid (\d+)", deadline, seen).group(1))
        port = int(read_until(proc, r"serving on http://[\d.]+:(\d+)", deadline, seen).group(1))
        body = json.dumps({"texts": texts, "imgs": imgs.tolist()}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/translate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())["results"]
        drain = threading.Thread(target=lambda: seen.extend(proc.stdout), daemon=True)
        drain.start()
        os.kill(pid, signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 0, "".join(seen)[-4000:]
    want = Translator(model, vocab, vocab, DecodeConfig(beam_size=4, max_length=8, batch_size=4),
                      buckets=DEFAULT_BUCKETS, device="cpu"
                      ).translate_tokens([t.split() for t in texts], imgs)
    assert [[e["text"] for e in g] for g in got] == [[t for _, t in w] for w in want]
    np.testing.assert_allclose([[e["score"] for e in g] for g in got],
                               [[s for s, _ in w] for w in want], rtol=1e-4, atol=1e-4)
