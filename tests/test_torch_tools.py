"""PyTorch port: the checkpoint and corpus tools of
``variational_mmt_torch/tools/`` against the root ``tools/`` scripts they
copy, which run in subprocesses with ``JAX_PLATFORMS=cpu``:
``average_checkpoints`` and ``release_checkpoint`` on the same port
checkpoints (parameters equal to the bit), ``export_gate_corpus`` (the same
files: byte-equal, the ``.npz`` archives by their arrays, since a zip entry
carries its write time), and ``import_torch_checkpoint`` on synthetic
upstream OpenNMT-py checkpoints built as ``tests/test_torch_import.py``
builds them (every mapped leaf equal, leaves left at fresh init equal as
names, the port model's float32 logits within 1e-5 of the torch reference
computation, each refusal); and each tool's flags equal to its root
counterpart's."""

import argparse
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_import import B, S, T, V, _onmt_state_dict, _torch_forward
from variational_mmt_torch.config import Config, ModelConfig, TrainConfig
from variational_mmt_torch.convert import flatten, params_from_jax
from variational_mmt_torch.data.vocab import SPECIALS, Vocab
from variational_mmt_torch.models.model import build_model, init_params
from variational_mmt_torch.tools import (average_checkpoints, export_gate_corpus,
                                         import_torch_checkpoint, release_checkpoint)
from variational_mmt_torch.train import checkpoint as ck
from variational_mmt_torch.train.trainer import create_train_state

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(model_type="vmmt_c", src_vocab_size=20, tgt_vocab_size=20, emb_dim=8,
            hidden_dim=8, latent_dim=4, img_feat_dim=6, compute_dtype="float32")
ITOS = SPECIALS + [f"w{i}" for i in range(V - len(SPECIALS))]


def run_root(tool: str, *argvs) -> str:
    """The root tool's ``main`` on each argv in turn, in one subprocess
    (one JAX start-up); returns what it printed."""
    script = ("import runpy, sys\n"
              f"main = runpy.run_path({str(ROOT / 'tools' / f'{tool}.py')!r})['main']\n"
              f"for argv in {[[str(a) for a in argv] for argv in argvs]!r}:\n"
              f"    sys.argv = [{tool!r}] + argv\n"
              "    main()\n")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, cwd=ROOT,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def leaves(path) -> dict:
    """{dotted name: float32 numpy} of a checkpoint's params (and EMA)."""
    raw = ck.read_state(str(path))
    out = {}
    for part in ("params", "ema_params"):
        for k, v in flatten(raw.get(part, {})).items():
            out[f"{part}.{k}"] = v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def same_leaves(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def port_checkpoint(root, seed: int, step: int) -> str:
    """A port checkpoint with seed-``seed`` parameters, Adam moments and EMA
    that differ from the parameters, at ``step``."""
    cfg = Config(model=ModelConfig(**TINY), train=TrainConfig(ema_decay=0.99))
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(init_params(cfg.model, seed), cfg.model))
    state = create_train_state(cfg, model)
    g = torch.Generator().manual_seed(seed)
    params = list(model.parameters())
    state.opt_state["mu"] = [torch.randn(p.shape, generator=g) for p in params]
    state.opt_state["nu"] = [torch.rand(p.shape, generator=g) for p in params]
    state.opt_state["count"] = torch.tensor(step, dtype=torch.int32)
    state.ema = [p.detach() + 0.01 * torch.randn(p.shape, generator=g) for p in params]
    state.step = step
    vocab = Vocab(SPECIALS + [f"v{i}" for i in range(16)])
    return ck.save_checkpoint(str(root), state, cfg, vocab, vocab, keep=0)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("run")
    return root, [port_checkpoint(root, seed, step) for seed, step in ((1, 10), (2, 20), (3, 30))]


AVERAGES = {"ckpts": lambda root, paths: ["-ckpts", *paths[1:]],
            "ckpt_root": lambda root, paths: ["-ckpt_root", root, "-last", "2"]}
RELEASES = {"keep": [], "bfloat16": ["-dtype", "bfloat16"], "ema": ["-ema"],
            "bfloat16_ema": ["-dtype", "bfloat16", "-ema"]}


@pytest.fixture(scope="module")
def root_outputs(run, tmp_path_factory):
    """The root tools' averages and releases of ``run``: {name: directory}."""
    root, paths = run
    out = tmp_path_factory.mktemp("root_tool")
    run_root("average_checkpoints", *[args(root, paths) + ["-output", out / name]
                                      for name, args in AVERAGES.items()])
    run_root("release_checkpoint", *[["-model", root, "-output", out / name, *flags]
                                     for name, flags in RELEASES.items()])
    return out


@pytest.mark.parametrize("how", sorted(AVERAGES))
def test_average_checkpoints_equals_root_tool(run, root_outputs, tmp_path, how):
    root, paths = run
    args = AVERAGES[how](root, paths)
    out = average_checkpoints.main([*map(str, args), "-output", str(tmp_path / "port")])
    assert os.path.basename(out) == "step_00000030"
    got, want = leaves(out), leaves(ck.latest_checkpoint(str(root_outputs / how)))
    same_leaves({k: v for k, v in got.items() if k.startswith("params.")},
                {k: v for k, v in want.items() if k.startswith("params.")})
    # float64 mean of the two, cast to float32
    a, b = leaves(paths[1]), leaves(paths[2])
    for k in got:
        if k.startswith("params."):
            np.testing.assert_array_equal(
                got[k], ((a[k].astype(np.float64) + b[k]) / 2).astype(np.float32))
    # the newest is the base: its step, lr, optimizer moments and EMA
    raw, newest = ck.read_state(out), ck.read_state(paths[2])
    assert int(raw["step"]) == 30 and float(raw["lr"]) == float(newest["lr"])
    for part in ("opt_state", "ema_params"):
        x, y = flatten(raw[part]), flatten(newest[part])
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


def test_average_checkpoints_refusals(run, tmp_path):
    with pytest.raises(SystemExit, match="no checkpoints"):
        average_checkpoints.main(["-output", str(tmp_path / "o")])
    cfg = ck.read_config(run[1][0])
    cfg.model.hidden_dim = 16
    other = tmp_path / "other"
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(init_params(cfg.model, 0), cfg.model))
    vocab = Vocab.load(os.path.join(run[1][0], "vocab.src.json"))
    path = ck.save_checkpoint(str(other), create_train_state(cfg, model), cfg, vocab, vocab)
    with pytest.raises(SystemExit, match="architecture mismatch"):
        average_checkpoints.main(["-ckpts", path, run[1][0], "-output", str(tmp_path / "o")])


@pytest.mark.parametrize("name", sorted(RELEASES))
def test_release_checkpoint_equals_root_tool(run, root_outputs, tmp_path, name):
    root, paths = run
    flags = RELEASES[name]
    out_root, out_port = root_outputs / name, tmp_path / "port"
    info = release_checkpoint.main(["-model", str(root), "-output", str(out_port), *flags])
    assert info["dst_bytes"] < info["src_bytes"]
    got, want = leaves(out_port), leaves(out_root)
    same_leaves(got, want)
    src = leaves(paths[-1])  # the newest step was released
    part = "ema_params" if "-ema" in flags else "params"
    for k, v in got.items():
        ref = src[k.replace("params.", f"{part}.", 1)]
        if "bfloat16" in flags:
            ref = torch.from_numpy(ref.copy()).bfloat16().float().numpy()
        np.testing.assert_array_equal(v, ref)
    for name in ("config.json", "vocab.src.json", "vocab.tgt.json", "RELEASED"):
        assert (out_port / name).read_bytes() == (out_root / name).read_bytes()
    raw = ck.read_state(str(out_port))
    assert "opt_state" not in raw and "ema_params" not in raw and int(raw["step"]) == 30


def test_release_checkpoint_refusals(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint under"):
        release_checkpoint.main(["-model", str(tmp_path), "-output", str(tmp_path / "o")])


def test_export_gate_corpus_equals_root_tool(tmp_path, capsys):
    flags = ["-n_train", "60", "-n_valid", "10", "-n_test", "20", "-data_seed", "3",
             "-vocab_size", "40", "-img_dim", "16", "-img_regions", "2"]
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    printed = run_root("export_gate_corpus", ["-out", tmp_path / "a" / "gate", *flags])
    meta = export_gate_corpus.main(["-out", str(tmp_path / "b" / "gate"), *flags])
    assert capsys.readouterr().out == printed == json.dumps(meta) + "\n"
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(os.listdir(tmp_path / "b")) and len(names) == 11
    for name in names:
        a, b = tmp_path / "a" / name, tmp_path / "b" / name
        if name.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype
                np.testing.assert_array_equal(za[k], zb[k])
        else:
            assert a.read_bytes() == b.read_bytes(), name


def upstream_pt(d, rnn_type: str, seed: int, bridge: bool = True):
    mods, sd = _onmt_state_dict(rnn_type, seed=seed)
    if not bridge:
        sd = {k: v for k, v in sd.items() if "bridge" not in k}
    gen = {k[len("generator."):]: v for k, v in sd.items() if k.startswith("generator.")}
    path = d / f"{rnn_type}{'' if bridge else '_bridgeless'}.pt"
    torch.save({"model": {k: v for k, v in sd.items() if not k.startswith("generator.")},
                "generator": gen, "vocab": {"src": ITOS, "tgt": ITOS}}, path)
    return mods, path


@pytest.fixture(scope="module")
def upstream(tmp_path_factory):
    """Upstream checkpoints ({name: (torch modules, .pt path, root tool's
    import)}): GRU and LSTM with a bridge, and GRU without one."""
    d = tmp_path_factory.mktemp("upstream")
    out = {"gru": upstream_pt(d, "gru", seed=5), "lstm": upstream_pt(d, "lstm", seed=5),
           "bridgeless": upstream_pt(d, "gru", seed=3, bridge=False)}
    run_root("import_torch_checkpoint",
             *[["-ckpt", pt, "-out", d / f"root_{name}",
                "-allow_partial" if name == "bridgeless" else "-strict"]
               for name, (_, pt) in out.items()])
    return {name: (mods, pt, ck.latest_checkpoint(str(d / f"root_{name}")))
            for name, (mods, pt) in out.items()}


@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_import_equals_root_tool_and_torch(upstream, tmp_path, rnn_type):
    mods, pt, root_ckpt = upstream[rnn_type]
    path = import_torch_checkpoint.main(["-ckpt", str(pt), "-out", str(tmp_path / "port"),
                                         "-strict"])
    same_leaves(leaves(path), leaves(root_ckpt))
    state, cfg, model, sv, tv = ck.load_checkpoint(path, device="cpu")
    assert cfg.model.model_type == "nmt" and cfg.model.rnn_type == rnn_type
    assert cfg.model.compute_dtype == "float32" and sv.itos == tv.itos == ITOS
    assert state.step == 0 and ck.read_config(path).train.param_init == 0.0
    rng = np.random.RandomState(3)
    src = rng.randint(4, V, size=(B, S)).astype(np.int64)
    tgt_in = rng.randint(4, V, size=(B, T)).astype(np.int64)
    tgt_in[:, 0] = 2  # BOS
    want = _torch_forward(mods, src, tgt_in, rnn_type)
    with torch.no_grad():
        got = model(torch.from_numpy(src), torch.from_numpy(tgt_in), deterministic=True,
                    sample=False)["logits"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_import_bridgeless_refused_unless_partial(upstream, tmp_path, capsys):
    """Without bridge tensors the import refuses; with -allow_partial the
    mapped leaves equal the root tool's and the bridge leaves, left at each
    package's own fresh init, are the same names."""
    _, pt, root_ckpt = upstream["bridgeless"]
    argv = ["-ckpt", str(pt), "-out", str(tmp_path / "port")]
    with pytest.raises(SystemExit) as e:
        import_torch_checkpoint.main(argv)
    assert "bridge" in str(e.value) and "-allow_partial" in str(e.value)
    assert not (tmp_path / "port").exists()
    capsys.readouterr()
    path = import_torch_checkpoint.main(argv + ["-allow_partial"])
    assert "fresh init" in capsys.readouterr().out
    got, want = leaves(path), leaves(root_ckpt)
    assert sorted(got) == sorted(want)
    fresh = sorted(k for k in got if k.startswith("params.bridge"))
    assert fresh
    same_leaves({k: v for k, v in got.items() if k not in fresh},
                {k: v for k, v in want.items() if k not in fresh})


def test_import_refusals(tmp_path, capsys):
    _, sd = _onmt_state_dict("gru", seed=9)
    sd = dict(sd, **{"inf_net.weird.weight": torch.zeros(3, 3)})
    pt = tmp_path / "up.pt"
    torch.save({"model": sd, "vocab": {"src": ITOS, "tgt": ITOS}}, pt)
    out = tmp_path / "o"
    with pytest.raises(SystemExit, match="-strict"):
        import_torch_checkpoint.main(["-ckpt", str(pt), "-out", str(out), "-strict"])
    assert "inf_net.weird.weight" in capsys.readouterr().out
    rules = tmp_path / "map.json"
    rules.write_text(json.dumps([["inf_net\\.weird\\.weight", "generator/kernel", "raw"]]))
    with pytest.raises(SystemExit, match="shape mismatches"):
        import_torch_checkpoint.main(["-ckpt", str(pt), "-out", str(out), "-map", str(rules)])
    assert "generator/kernel: ours" in capsys.readouterr().out
    assert not out.exists()
    import_torch_checkpoint.main(["-ckpt", str(pt), "-out", str(out)])  # loud, not strict
    assert "UNCONSUMED" in capsys.readouterr().out and ck.latest_checkpoint(str(out))


class Parsed(Exception):
    pass


def flags_of(main, monkeypatch) -> dict:
    """{dest: the flag's definition} of the parser ``main`` builds."""
    def grab(self, args=None, namespace=None):
        raise Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Parsed) as e:
            main()
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.nargs,
                     a.required, a.const, type(a).__name__)
            for a in e.value.args[0]._actions}


@pytest.mark.parametrize("name", ["average_checkpoints", "release_checkpoint",
                                  "export_gate_corpus", "import_torch_checkpoint"])
def test_flags_equal_root_tool(name, monkeypatch):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / "tools" / f"{name}.py")
    root_tool = importlib.util.module_from_spec(spec)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    spec.loader.exec_module(root_tool)
    port_tool = {"average_checkpoints": average_checkpoints,
                 "release_checkpoint": release_checkpoint,
                 "export_gate_corpus": export_gate_corpus,
                 "import_torch_checkpoint": import_torch_checkpoint}[name]
    port, want = flags_of(port_tool.main, monkeypatch), flags_of(root_tool.main, monkeypatch)
    assert port == want and len(port) > 2
