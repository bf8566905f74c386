"""PyTorch port: the study tools ``variational_mmt_torch/tools/
regularization_gate.py``, ``iw_study.py`` and ``sweep.py`` against the root
``tools/`` scripts they follow (loaded by path, JAX on the CPU):

- each tool's flags are the root tool's, with the same names and defaults,
  plus ``-device`` and ``-route`` (the sweep's ``-device`` is the train
  CLI's);
- for the same flags the port builds the same config dataclasses, field
  for field: ``-route plain`` the root tool's CPU config, ``-route scans``
  its TPU config (``kernels`` that with ``pallas_decoder`` on); the sweep's
  config of each grid point, overrides included;
- ``parse_sweep`` gives the same grid, ``stochastic_nll_floors`` the same
  floors on the same split;
- a CPU run of each at a tiny width and a few steps writes one record a
  run with the root tool's keys plus ``route`` (plain), ``device``,
  ``card`` and ``launches`` (0 on the CPU: the wrappers take their plain
  versions), and finite numbers; the IW study's bound tightens in K.
"""

import argparse
import dataclasses
import importlib.util
import json
import math
import pathlib

import numpy as np
import pytest

from variational_mmt_torch.config import ModelConfig
from variational_mmt_torch.data.dataset import BinarizedDataset
from variational_mmt_torch.data.synthetic import make_corpus
from variational_mmt_torch.tools import iw_study, regularization_gate, runs, sweep

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOOLS = {"regularization_gate": regularization_gate, "iw_study": iw_study, "sweep": sweep}
TINY = ["-vocab_size", "30", "-emb_dim", "16", "-hidden_dim", "16", "-latent_dim", "4",
        "-img_dim", "8", "-batch_size", "8"]


def root_tool(name, monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Parsed(Exception):
    pass


def flags_of(main, monkeypatch) -> dict:
    """{dest: (option strings, default, type, choices)} of the parser
    ``main`` builds."""
    def grab(self, args=None, namespace=None):
        raise Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Parsed) as e:
            main()
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices)
            for a in e.value.args[0]._actions}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_flags_are_the_root_tools_plus_device_and_route(name, monkeypatch):
    port = flags_of(TOOLS[name].main, monkeypatch)
    want = flags_of(root_tool(name, monkeypatch).main, monkeypatch)
    assert port.pop("route")[1:] == (None, None, runs.ROUTES)
    assert port.pop("device")[1:] == ("cuda", None, ["cuda", "cpu"])
    assert port == want and len(port) > 5


def same_config(port, want):
    """Every field of the root tool's config equal in the port's; the
    port's own fields (none a root config has) at their defaults."""
    got, jd = port.to_dict(), want.to_dict()
    for sect, fields in jd.items():
        assert {k: got[sect][k] for k in fields} == fields, sect
        own = {k for k in got[sect]} - set(fields)
        defaults = type(getattr(port, sect))()
        assert {k: got[sect][k] for k in own} == {k: getattr(defaults, k) for k in own}, sect


@pytest.mark.parametrize("route,platform", [("plain", "cpu"), ("scans", "tpu"),
                                            ("kernels", "tpu")])
@pytest.mark.parametrize("model_type", ["nmt", "vmmt_f", "vmmt_c"])
@pytest.mark.parametrize("name", ["regularization_gate", "iw_study"])
def test_configs_equal_the_root_tools(name, model_type, route, platform, monkeypatch):
    root = root_tool(name, monkeypatch)
    extra = {"regularization_gate": ["-no_img_predict", "1", "-dropout", "0.2"],
             "iw_study": ["-kl_free_bits", "0.5", "-k_list", "1,5"]}[name]
    args = TOOLS[name].parse_args(["-route", route, "-steps", "300", *TINY, *extra])
    if name == "iw_study":
        port = iw_study.build_cfg(model_type, 12, args.steps, args)
        want = root.build_cfg(model_type, 12, args.steps, platform, args)
    else:
        port = regularization_gate.build_cfg(model_type, 12, args)
        want = root.build_cfg(model_type, 12, args, platform)
    if route == "kernels":  # the TPU config with the decoder sequence kernels on
        assert port.model.pallas_decoder
        port.model = dataclasses.replace(port.model, pallas_decoder=False)
    same_config(port, want)


SPEC = "model.latent_dim=4,8 train.learning_rate=2e-4,4e-4 model.z_cond=init,init+input"


def test_parse_sweep_gives_the_same_grid(monkeypatch):
    root = root_tool("sweep", monkeypatch)
    assert sweep.parse_sweep(SPEC) == root.parse_sweep(SPEC)
    assert len(sweep.parse_sweep(SPEC)) == 8


def test_sweep_configs_equal_the_root_tools(monkeypatch):
    """The root sweep's config of each grid point (its train flags, steps,
    validation once at the end, the overrides) is the port's on the plain
    route for the same flags, with the root flags' f32 compute dtype."""
    from variational_mmt_tpu.cli.train import add_args as jax_add_args
    from variational_mmt_tpu.cli.train import build_config as jax_build_config
    from variational_mmt_tpu.config import update_config as jax_update_config

    flags = ["-data", "d", "-save_model", "unused", "-rnn_size", "16", "-word_vec_size", "8",
             "-compute_dtype", "float32", "-model_type", "vmmt_c", "-seed", "5"]
    opt = sweep.parse_args([*flags, "-device", "cpu", "-sweep", SPEC, "-sweep_steps", "30"])
    p = argparse.ArgumentParser()
    jax_add_args(p)
    jopt = p.parse_args(flags)
    for overrides in sweep.parse_sweep(SPEC):
        want = jax_build_config(jopt, 30, 40)
        want.train.max_steps = want.train.valid_every = 30
        jax_update_config(want, overrides)
        same_config(sweep.sweep_config(opt, overrides, 30, 40), want)


def test_stochastic_floors_equal_the_root_tools(monkeypatch):
    from variational_mmt_tpu.data.synthetic import make_stochastic_corpus as jax_corpus
    from variational_mmt_tpu.data.synthetic import stochastic_nll_floors as jax_floors

    args = iw_study.parse_args(["-device", "cpu", "-n_train", "60", "-n_test", "40",
                                "-sense_flip", "0.2", "-n_senses", "3"])
    _, floors = iw_study.make_data(args)
    src, _, _, _, _, _, _, amb = jax_corpus(100, vocab_size=200, n_senses=3, sense_flip=0.2,
                                            img_dim=512, seed=0)
    want = jax_floors(src[60:], amb, 3, 0.2, 200)
    np.testing.assert_allclose(floors, want, rtol=0, atol=0)
    assert floors[0] > floors[1] > 0


def finite(rec: dict) -> bool:
    nums = [v for v in rec.values() if isinstance(v, (int, float)) and not isinstance(v, bool)]
    return all(math.isfinite(v) for v in nums)


def read(path) -> list:
    return [json.loads(line) for line in pathlib.Path(path).read_text().splitlines()]


PORT_KEYS = {"route", "device", "card", "launches"}


def check_record(r: dict, keys: set) -> None:
    assert set(r) == keys | PORT_KEYS
    assert (r["route"], r["device"], r["card"]) == ("plain", "cpu", "cpu")
    assert r["launches"] == dict.fromkeys(runs.COUNTERS, 0)
    assert finite(r)


def test_regularization_gate_runs_on_the_cpu(tmp_path):
    out = tmp_path / "reg.jsonl"
    res = regularization_gate.main(["-device", "cpu", "-models", "nmt,vmmt_f", "-seeds", "11",
                                    "-steps", "3", "-n_train", "40", "-n_test", "8", *TINY,
                                    "-out", str(out)])
    recs = read(out)
    assert recs == res and [r["model"] for r in recs] == ["nmt", "vmmt_f"]
    keys = {"model", "seed", "test_bleu", "n_train", "train_noise", "no_img_predict", "steps",
            "train_s"}
    for r in recs:
        check_record(r, keys)
        assert 0.0 <= r["test_bleu"] <= 100.0 and r["steps"] == 3


def test_iw_study_runs_on_the_cpu(tmp_path):
    out = tmp_path / "iw.jsonl"
    iw_study.main(["-device", "cpu", "-models", "nmt,vmmt_c", "-seeds", "11", "-steps", "3",
                   "-n_train", "40", "-n_test", "8", "-k_list", "1,4", *TINY, "-out", str(out)])
    nmt, vmmt_c = read(out)
    base = {"model", "seed", "steps", "kl_free_bits", "n_train", "n_test", "train_s",
            "floor_text_nats", "floor_img_nats", "test_bleu"}
    check_record(nmt, base | {"nll_exact_per_sent"})
    check_record(vmmt_c, base | {"au", "kl_per_sent", "kl_active_dims", "iw_text_nll_k1",
                                 "iw_joint_k1", "iw_text_nll_k4", "iw_joint_k4",
                                 "iw_monotone"})
    assert nmt["nll_exact_per_sent"] > 0
    assert vmmt_c["iw_monotone"] is True
    assert vmmt_c["iw_text_nll_k4"] <= vmmt_c["iw_text_nll_k1"] + 1e-3


def test_sweep_runs_on_the_cpu(tmp_path):
    src, tgt, feats, sv, tv = make_corpus(48, vocab_size=30, img_dim=8, max_len=10, seed=3)
    ids = lambda lines, v: [np.asarray(v.encode(s), np.int32) for s in lines]  # noqa: E731
    prefix = str(tmp_path / "demo")
    BinarizedDataset(ids(src[:40], sv), ids(tgt[:40], tv)).save(prefix + ".train.npz")
    BinarizedDataset(ids(src[40:], sv), ids(tgt[40:], tv)).save(prefix + ".valid.npz")
    sv.save(prefix + ".vocab.src.json")
    tv.save(prefix + ".vocab.tgt.json")
    np.save(tmp_path / "train.npy", feats[:40])
    np.save(tmp_path / "valid.npy", feats[40:])
    out = tmp_path / "sweep.jsonl"
    res = sweep.main(["-data", prefix, "-save_model", str(tmp_path / "unused"),
                      "-train_img_feats", str(tmp_path / "train.npy"),
                      "-valid_img_feats", str(tmp_path / "valid.npy"), "-model_type", "vmmt_c",
                      "-rnn_size", "16", "-word_vec_size", "16", "-z_latent_dim", "4",
                      "-img_feat_dim", "8", "-batch_size", "8", "-buckets", "12",
                      "-device", "cpu", "-sweep", "model.latent_dim=4,8", "-sweep_steps", "2",
                      "-sweep_bleu", "1", "-out", str(out)])
    recs = read(out)
    assert len(recs) == len(res) == 2
    assert [r["overrides"] for r in recs] == [{"model.latent_dim": "4"}, {"model.latent_dim": "8"}]
    for r in recs:
        check_record({k: v for k, v in r.items() if k != "overrides"},
                     {"val_ppl", "val_elbo", "val_kl", "seconds", "valid_bleu"})
        assert r["val_ppl"] > 1.0


def test_routes_set_the_model_as_the_gate_does():
    """The shared route settings are the quality gate's (compute dtype, the
    scan kernels, the decoder sequence kernels, the fused CE)."""
    for route in runs.ROUTES:
        m = ModelConfig(**runs.route_model(route))
        assert (m.compute_dtype == "float32") is (route == "plain")
        assert m.use_pallas is m.fused_ce is (route != "plain")
        assert m.pallas_decoder is (route == "kernels")
    assert [runs.route_pallas_step(r) for r in runs.ROUTES] == [1, 0, 0]
