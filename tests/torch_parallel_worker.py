"""Rank processes for the port's parallel tests
(tests/test_torch_parallel.py, tests/test_torch_parallel_decode.py,
tests/test_torch_serve_ranks.py).

    python tests/torch_parallel_worker.py GROUP RANK WORLD DIR

runs the cases of GROUP as one rank of a gloo process group on the CPU
(rendezvous through the file DIR/store, so that test workers running at
once never race for a port), reading the test's inputs from
DIR/inputs.pkl and writing {case: result} to DIR/out_RANK.pkl. It
imports torch and the port, never JAX: the test compares the results with
the JAX package in its own process. :func:`spawn` starts the ranks of a
group and waits for them with a timeout. A test's inputs may set
``timeout``: the seconds that bound the groups' collectives.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spawn(group: str, world: int, workdir: str, inputs: dict, timeout: float = 150.0,
          check: bool = True) -> list:
    """Run GROUP on ``world`` ranks; returns each rank's {case: result}.
    Kills every rank and raises when one fails or the time runs out; with
    ``check`` False returns each rank's exit code instead (-9: killed at
    the timeout)."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = []
    for r in range(world):
        log = open(os.path.join(workdir, f"log_{r}.txt"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), group,
                                        str(r), str(world), workdir],
                                       stdout=log, stderr=subprocess.STDOUT, env=env), log))
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if not check:
        return [p.returncode for p, _ in procs]
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        logs = "\n".join(f"--- rank {r} (exit {procs[r][0].returncode}):\n"
                         + open(os.path.join(workdir, f"log_{r}.txt")).read()[-6000:]
                         for r in bad)
        raise RuntimeError(f"{group}: rank(s) {bad} failed or timed out after {timeout} s\n"
                           + logs)
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"out_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ------------------------------------------------------------------- helpers

def _cfg(c: dict):
    from variational_mmt_torch.config import Config, ModelConfig, TrainConfig

    return Config(model=ModelConfig(**c["model"]), train=TrainConfig(**c.get("train", {})))


def _model(cfg, tree, mesh=None):
    """The full model from a JAX tree, sharded for ``mesh`` when given."""
    from variational_mmt_torch.convert import params_from_jax
    from variational_mmt_torch.models.model import build_model, shard_model

    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg.model))
    return shard_model(model, mesh) if mesh is not None else model


def _tensors(batch: dict):
    import numpy as np
    import torch

    return {k: torch.from_numpy(np.asarray(v)).long() if np.asarray(v).dtype.kind in "iu"
            else torch.from_numpy(np.asarray(v, np.float32)) for k, v in batch.items()}


def _full(model, mesh):
    """The full parameters, as numpy, from every rank's shard."""
    from variational_mmt_torch.parallel import tp

    return {k: v.detach().numpy().copy()
            for k, v in tp.gather_params(model.state_dict(), model.vocab_mesh).items()}


def _global(x, mesh):
    """A per-rank metric summed over the data group."""
    from variational_mmt_torch.parallel import mesh as pm

    return float(pm.all_reduce(x.detach().float().clone(), mesh.data_group))


def train_steps(inp: dict, mesh, steps: int, deterministic: bool = False,
                sample: bool = True, batch_key: str = "batch"):
    """``steps`` optimizer steps of ``make_train_step`` on ``mesh`` over the
    same batch: (global losses, n_sents of the last step, full params,
    the trained state)."""
    from variational_mmt_torch.parallel import mesh as pm
    from variational_mmt_torch.train.trainer import create_train_state, make_train_step

    cfg = _cfg(inp["cfg"])
    model = _model(cfg, inp["tree"], mesh)
    state = create_train_state(cfg, model, mesh)
    step = make_train_step(cfg, deterministic, sample, mesh)
    batch = pm.shard_batch(_tensors(inp[batch_key]), mesh)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch, state.generator)
        losses.append(_global(m["loss"], mesh))
    return losses, _global(m["n_sents"], mesh), _full(state.model, mesh), state, cfg


# --------------------------------------------------------------------- cases

def case_tp_train(inp, meshes):
    """3 steps of nmt on the 2x2 mesh, fused CE on and off; the local
    shapes of the sharded parameters and Adam moments."""
    out = {}
    for fused in (True, False):
        sub = dict(inp["tp_train"], cfg=inp["tp_train"]["cfgs"][fused])
        losses, _, params, state, _ = train_steps(sub, meshes["2x2"], 3)
        names = [n for n, _ in state.model.named_parameters()]
        shapes = {n: tuple(p.shape) for n, p in state.model.named_parameters()}
        mu = {n: tuple(t.shape) for n, t in zip(names, state.opt_state["mu"])}
        out[fused] = {"losses": losses, "params": params, "shapes": shapes, "mu": mu}
    return out


def case_tp_grads(inp, meshes):
    """vmmt_c loss and every gradient (deterministic, z = the posterior
    mean) on the 2x2 mesh, fused CE on and off: the global loss and the
    full gradients (summed over the data group, gathered over the model
    group)."""
    from variational_mmt_torch.parallel import mesh as pm, tp
    from variational_mmt_torch.train.trainer import loss_and_grads

    mesh = meshes["2x2"]
    out = {}
    for fused in (True, False):
        cfg = _cfg(inp["tp_grads"]["cfgs"][fused])
        model = _model(cfg, inp["tp_grads"]["tree"], mesh)
        batch = pm.shard_batch(_tensors(inp["tp_grads"]["batch"]), mesh)
        loss, _, grads = loss_and_grads(cfg, model, batch, inp["tp_grads"]["step"], None,
                                        deterministic=True, sample=False, mesh=mesh)
        grads = pm.all_reduce_list(grads, mesh.data_group)
        names = [n for n, _ in model.named_parameters()]
        full = tp.gather_list(names, grads, model.vocab_mesh)
        out[fused] = {"loss": _global(loss, mesh),
                      "grads": {n: g.numpy().copy() for n, g in zip(names, full)}}
    return out


def case_tied(inp, meshes):
    losses, *_ = train_steps(inp["tied"], meshes["2x2"], 1)
    return {"loss": losses[0]}


def case_packed(inp, meshes):
    losses, n_sents, params, *_ = train_steps(inp["packed"], meshes["2x2"], 2)
    return {"losses": losses, "n_sents": n_sents, "params": params}


def case_dp4(inp, meshes):
    losses, _, params, *_ = train_steps(inp["dp4"], meshes["4x1"], 1)
    return {"loss": losses[0], "params": params}


def case_param_init(inp, meshes):
    """``param_init`` on the 2x2 mesh: the full parameters after the draw,
    and the first draws of the rank's training generator."""
    import torch

    from variational_mmt_torch.train.trainer import create_train_state

    d, mesh = inp["param_init"], meshes["2x2"]
    cfg = _cfg(d["cfg"])
    state = create_train_state(cfg, _model(cfg, d["tree"], mesh), mesh)
    return {"params": _full(state.model, mesh),
            "draw": torch.rand(4, generator=state.generator).tolist()}


def _iterator(d: dict, **kw):
    import numpy as np

    from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator

    src = [np.asarray(s, np.int32) for s in d["src"]]
    tgt = [np.asarray(t, np.int32) for t in d["tgt"]]
    return BucketIterator(BinarizedDataset(src, tgt), d["batch_size"], d["buckets"],
                          img_feats=d.get("img"), **kw)


def case_eval(inp, meshes):
    """``Trainer.validate`` on the 2x2 mesh (vmmt_c)."""
    from variational_mmt_torch.train.trainer import Trainer

    d = inp["eval"]
    cfg = _cfg(d["cfg"])
    tr = Trainer(cfg, _model(cfg, d["tree"]), _iterator(d), _iterator(d, shuffle=False),
                 device="cpu", mesh=meshes["2x2"])
    return tr.validate()


def case_trainer(inp, meshes):
    """The Trainer end to end on the 2x2 mesh (batch 6: 3 rows a data
    rank), and ``valid_iw`` on the 4x1 mesh."""
    import numpy as np

    from variational_mmt_torch.train.trainer import Trainer

    d = inp["trainer"]
    cfg = _cfg(d["cfg"])
    tr = Trainer(cfg, _model(cfg, d["tree"]), _iterator(d, seed=1), device="cpu",
                 mesh=meshes["2x2"])
    hist = tr.train(4)
    tr.close()
    d = inp["valid_iw"]
    cfg = _cfg(d["cfg"])
    tr2 = Trainer(cfg, _model(cfg, d["tree"]), _iterator(d, seed=0),
                  _iterator(d, shuffle=False), device="cpu", mesh=meshes["4x1"], valid_iw=3)
    tr2.train()
    tr2.close()
    return {"losses": [h["loss"] for h in hist], "lr": tr.state.lr,
            "finite": bool(np.isfinite([v for h in hist for v in h.values()]).all()),
            "history": tr2.history}


def _translator(d: dict, mesh, infer_dtype: str = "float32"):
    from variational_mmt_torch.config import DecodeConfig
    from variational_mmt_torch.data.vocab import SPECIALS, Vocab
    from variational_mmt_torch.decode.translator import Translator

    cfg = _cfg(d["cfg"])
    vocab = Vocab(SPECIALS + [f"w{i}" for i in range(cfg.model.tgt_vocab_size - len(SPECIALS))])
    return Translator(_model(cfg, d["tree"]), vocab, vocab,
                      DecodeConfig(**d["dcfg"], infer_dtype=infer_dtype), buckets=[8],
                      device="cpu", mesh=mesh)


def case_decode(inp, meshes):
    """Beam decoding, f32 and int8, on TP-2 and DP-2."""
    d = inp["decode"]
    out = {}
    for name in ("1x2", "2x1"):
        for dt in ("float32", "int8"):
            tr = _translator(d, meshes[name], dt)
            out[(name, dt)] = tr.translate_ids(d["src"], d["img"])
            if dt == "int8" and name == "1x2":
                w = tr.weights[0]["generator.kernel"]
                out["int8_shapes"] = (tuple(w["int8"].shape), tuple(w["scale"].shape))
            tr.close()
    return out


def case_iw(inp, meshes):
    import torch

    from variational_mmt_torch.decode.iw_eval import iw_elbo_corpus

    d = inp["iw"]
    cfg = _cfg(d["cfg"])
    batches = [_tensors(b) for b in d["batches"]]
    eps = [torch.from_numpy(e) for e in d["eps"]]
    return {name: iw_elbo_corpus(_model(cfg, d["tree"]), batches, d["k"],
                                 eps=lambda i: eps[i], mesh=meshes[name])
            for name in ("1x2", "2x1")}


def case_checkpoint(inp, meshes):
    """2 steps on TP-2, a checkpoint gathered and written by rank 0, then
    resumed on DP-2 (another degree: the generators reseed)."""
    import contextlib
    import io

    from variational_mmt_torch.data.vocab import SPECIALS, Vocab
    from variational_mmt_torch.train import checkpoint as ck
    from variational_mmt_torch.train.trainer import Trainer

    d = inp["ckpt"]
    losses, _, params, state, cfg = train_steps(d, meshes["1x2"], 2)
    vocab = Vocab(SPECIALS + [f"w{i}" for i in range(cfg.model.tgt_vocab_size - len(SPECIALS))])
    path = ck.save_checkpoint(d["dir"], state, cfg, vocab, vocab, mesh=meshes["1x2"])
    tr = Trainer(cfg, _model(cfg, d["tree"]), [], device="cpu", mesh=meshes["2x1"])
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        resumed = ck.load_state(path, tr.model, cfg, mesh=meshes["2x1"])
    return {"path": path, "losses": losses, "params": params, "said": said.getvalue(),
            "resumed": {n: p.detach().numpy().copy() for n, p in resumed.model.named_parameters()},
            "step": resumed.step, "generator": resumed.generator.get_state().numpy().copy()}


def case_dp2(inp, meshes):
    """3 deterministic f32 steps of vmmt_c on DP-2 (the single process runs
    in the test)."""
    losses, _, params, *_ = train_steps(inp["dp2"], meshes["2x1"], 3, deterministic=True,
                                        sample=False)
    return {"losses": losses}


def _vocab(cfg):
    from variational_mmt_torch.data.vocab import SPECIALS, Vocab

    return Vocab(SPECIALS + [f"w{i}" for i in range(cfg.model.tgt_vocab_size - len(SPECIALS))])


def _service(d: dict, mesh, depth: int = 2, dcfg: dict = None):
    """A TranslationService on ``mesh`` (warm-up on: every rank replays it)."""
    from variational_mmt_torch.config import DecodeConfig
    from variational_mmt_torch.serve import ServeConfig, TranslationService

    cfg = _cfg(d["cfg"])
    return TranslationService(_model(cfg, d["tree"]), _vocab(cfg), _vocab(cfg),
                              DecodeConfig(**(dcfg or d["dcfg"])), buckets=[8],
                              scfg=ServeConfig(max_wait_ms=20.0, pipeline_depth=depth),
                              mesh=mesh, device="cpu")


def _served(svc, d: dict, sample_ids=None) -> list:
    """Rank 0: each sentence of ``d`` a request, from 4 threads; the raw
    n-best lists in order."""
    from concurrent.futures import ThreadPoolExecutor

    def one(i):
        sid = None if sample_ids is None else [sample_ids[i]]
        return svc.submit_ids_batch([d["src"][i]], d["img"][i:i + 1],
                                    sample_ids=sid)[0].result(timeout=60)

    with ThreadPoolExecutor(4) as ex:
        return list(ex.map(one, range(len(d["src"]))))


def case_serve(inp, meshes):
    """TP-2 and DP-2 at pipeline depth 1 and 2: rank 0 serves 16 requests
    from 4 threads, rank 1 follows; then the offline Translator on the same
    mesh. On TP-2 at depth 2 a shed request, on DP-2 at depth 1 an idle
    wait of 3 group timeouts before one more request; last, a sampling
    service keyed by sample_ids on TP-2."""
    import time

    d = inp["serve"]
    out = {}
    for name in ("1x2", "2x1"):
        mesh = meshes[name]
        for depth in (1, 2):
            svc = _service(d, mesh, depth)
            if not mesh.is_main:
                svc.follow()
                continue
            rec = {"served": _served(svc, d)}
            if (name, depth) == ("1x2", 2):
                dead = svc.submit_ids_batch([d["src"][0]], d["img"][:1], timeout_s=-1.0)[0]
                live = svc.submit_ids_batch([d["src"][1]], d["img"][1:2])[0]
                rec["after_shed"] = live.result(timeout=60)
                try:
                    dead.result(timeout=60)
                    rec["shed"] = None
                except TimeoutError as e:
                    rec["shed"] = str(e)
            if (name, depth) == ("2x1", 1):
                time.sleep(3 * inp["timeout"])
                rec["after_idle"] = svc.submit_ids_batch([d["src"][2]],
                                                         d["img"][2:3])[0].result(timeout=60)
            svc.stop()
            rec["stats"] = dict(svc.stats)
            out[(name, depth)] = rec
        tr = _translator(d, mesh)
        out[(name, "offline")] = tr.translate_ids(d["src"], d["img"])
        tr.close()
    svc = _service(d, meshes["1x2"], 2, d["sample_dcfg"])
    if meshes["1x2"].is_main:
        out["sampled"] = _served(svc, d, d["sample_ids"])
        svc.stop()
    else:
        svc.follow()
    return out


def case_serve_fail(inp, meshes):
    """Rank 1 raises in its first dispatch after the warm-up: rank 0's
    request fails, and rank 0 exits 3 (rank 1 exits with the error)."""
    d = inp["serve"]
    mesh = meshes["1x2"]
    svc = _service(d, mesh, 2)
    if not mesh.is_main:
        warm = svc.translator.dispatch_ids
        calls = []

        def broken(*a, **k):
            calls.append(1)
            if len(calls) > len(svc.translator.buckets):  # past the warm-up's
                raise RuntimeError("injected failure on rank 1")
            return warm(*a, **k)

        svc.translator.dispatch_ids = broken
        svc.follow()
        return {}
    fut = svc.submit_ids_batch([d["src"][0]], d["img"][:1])[0]
    try:
        fut.result(timeout=60)
    except Exception as e:  # noqa: BLE001 — the failure this case expects
        print(f"rank 0's request failed: {e!r}", flush=True)
    svc.stop()
    print(f"rank 0's service failure: {svc.failure!r}", flush=True)
    os._exit(3 if svc.failure is not None else 0)


GROUPS = {
    # world 4: the training cases on a 2x2 mesh and on DP-4
    "train": (("2x2", (2, 2)), ("4x1", (4, 1))),
    # world 2: decoding, IW, checkpoints (TP-2 and DP-2)
    "decode": (("1x2", (1, 2)), ("2x1", (2, 1))),
    # world 2: serving across ranks (TP-2 and DP-2), and a failing rank
    "serve": (("1x2", (1, 2)), ("2x1", (2, 1))),
    "serve_fail": (("1x2", (1, 2)),),
}
CASES = {
    "train": (case_tp_train, case_tp_grads, case_tied, case_packed, case_dp4, case_eval,
              case_trainer, case_param_init),
    "decode": (case_decode, case_iw, case_checkpoint, case_dp2),
    "serve": (case_serve,),
    "serve_fail": (case_serve_fail,),
}


def main(argv) -> int:
    group, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    sys.path.insert(0, ROOT)
    import torch

    from variational_mmt_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    meshes = {}
    for name, (n_data, n_model) in GROUPS[group]:
        meshes[name] = make_mesh(n_data, n_model, device="cpu", backend="gloo",
                                 init_method=f"file://{workdir}/store", rank=rank,
                                 world_size=world, timeout=inp.get("timeout"))
    out = {}
    for case in CASES[group]:
        t0 = time.time()
        try:
            out[case.__name__] = case(inp, meshes)
        except Exception:
            traceback.print_exc()
            raise
        print(f"{case.__name__}: {time.time() - t0:.1f} s", flush=True)
    with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    meshes[GROUPS[group][0][0]].close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
