"""PyTorch port: the plumbing of the decoder gradient trace
(``variational_mmt_torch/tools/grad_trace.py`` and
``docs/experiments/decoder_grad_trace.py``) at a tiny width on the CPU,
where routes (ii)-(iv) run and the kernel route (i), the card's, is left
out.

- The routes take identical parameters, batch and random draws: with the
  model in f32 (dropout and word dropout on, z sampled), the decoder
  kernels' plain versions, the plain loop and the plain route compute the
  same function, so their losses agree within 1e-5 relative and every
  gradient within 1e-4 of its largest entry; in bf16 the first route's
  loss equals, to the bit, the loss of the training step then taken from
  the same generator, which the trace leaves where it was.
- The decoder kernels' inputs and cotangents are captured from the
  kernel route's step, and the checks of rows 5 and 6 on them read 0 on
  the CPU, where the wrappers run the plain versions.
- The noise tape replays draws in order and refuses another shape, kind
  or count.
- The distances and cosines are those stated, against numpy.
- The script's lines: traced at step 0, every ``-every`` steps, after the
  last step and after a departure of the losses, with the groups, the
  tensors and both routes' losses, and a last line with the test BLEU.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from variational_mmt_torch.tools import grad_trace as gt
from variational_mmt_torch.tools import quality_gate as qg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["-n_train", "120", "-n_valid", "10", "-n_test", "10", "-vocab_size", "60",
        "-emb_dim", "16", "-hidden_dim", "16", "-latent_dim", "8", "-img_dim", "16",
        "-batch_size", "16"]


def tiny_run(dtype: str = "bfloat16") -> gt.GateRun:
    args = qg.parse_args(TINY + ["-img_regions", "4", "-img_pool", "attn", "-device", "cpu"])
    run = gt.gate_run(args, "kernels", 12, device=torch.device("cpu"))
    if dtype != "bfloat16":  # the kernel route's model, in f32
        run.cfg = dataclasses.replace(run.cfg, model=dataclasses.replace(
            run.cfg.model, compute_dtype=dtype))
        model = gt.build_model(run.cfg.model, device="cpu")
        model.load_state_dict(run.model.state_dict())
        run.model = model
    return run


def test_routes_take_the_same_parameters_batch_and_noise():
    run = tiny_run("float32")
    assert run.cfg.model.dropout > 0 and run.cfg.model.word_dropout > 0
    batch = run.next_batch()
    g = gt.four_gradients(run.cfg, run.model, batch, 3, run.state.generator)
    run.close()
    assert list(g) == ["kernel_plain", "loop", "loop_f32"]  # no kernel route on the CPU
    want = g["loop_f32"]
    for route in ("kernel_plain", "loop"):
        assert g[route]["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert g[route]["kl"] == pytest.approx(want["kl"], rel=1e-5)
        assert set(g[route]["grads"]) == set(want["grads"])
        for name, w in want["grads"].items():
            err = float((g[route]["grads"][name] - w).abs().max())
            assert err <= 1e-4 * max(1.0, float(w.abs().max())), (route, name, err)
    d = gt.compare(g)
    assert d["decoder"]["loop"]["rel"] < 1e-4 and d["all"]["kernel_plain"]["cos"] > 1 - 1e-8


def test_first_route_draws_what_the_training_step_draws():
    run = tiny_run()
    batch = run.next_batch()
    state = run.state.generator.get_state()
    g = gt.four_gradients(run.cfg, run.model, batch, run.state.step, run.state.generator)
    assert torch.equal(run.state.generator.get_state(), state)  # not advanced
    m = run.step(batch)
    run.close()
    assert g["kernel_plain"]["loss"] == m["loss"]
    assert g["kernel_plain"]["kl"] == m["kl_sum"]
    assert g["loop"]["kl"] == m["kl_sum"]  # the encoders and the latent: the same draws
    assert g["loop_f32"]["loss"] == pytest.approx(m["loss"], rel=1e-2)


def test_decoder_call_is_captured_with_its_cotangents():
    """The decoder kernels' 15 inputs and the loss's cotangents, as the
    kernel route's training step gives them; the forward of the captured
    inputs is the one the step ran (the same draws)."""
    run = tiny_run()
    batch = run.next_batch()
    args, (d_attn, d_probs) = gt.capture_decoder_call(run.cfg, run.model, batch,
                                                      run.state.step, run.state.generator)
    run.close()
    B, T = batch["tgt_in"].shape
    S, H = batch["src"].shape[1], 16
    assert [tuple(a.shape) for a in args] == [
        (B, T, 3 * H), (B, T, H), (B, H), (B, H), (H, 3 * H), (H, 3 * H), (3 * H,),
        (H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,), (B, S, H), (B, S, H), (H, H), (B, S)]
    keep = float(torch.tensor(1 / 0.7).to(torch.bfloat16))  # dmid: dropout 0.3 in bf16
    assert args[0].dtype == torch.bfloat16 and set(args[1].unique().tolist()) == {0.0, keep}
    assert d_attn.shape == (B, T, H) and float(d_attn.abs().max()) > 0
    assert d_probs.shape == (B, T, S) and d_probs.dtype == torch.float32
    assert all(p.grad is None for p in run.model.parameters())


def test_noise_tape_replays_in_order_and_refuses_another_draw():
    gen = torch.Generator().manual_seed(0)
    tape = gt.NoiseTape()
    with tape.pass_(replay=False):
        a = torch.rand((2, 3), generator=gen)
        b = torch.randn((4,), generator=gen, dtype=torch.bfloat16)
        free = torch.rand(5)  # no generator: not taped
    assert len(tape.draws) == 2 and free.shape == (5,)
    with tape.pass_(replay=True):
        assert torch.equal(torch.rand((2, 3), generator=gen), a)
        b32 = torch.randn((4,), generator=gen, dtype=torch.float32)
    assert b32.dtype == torch.float32 and torch.equal(b32, b.float())
    with pytest.raises(RuntimeError, match="the tape has"):
        with tape.pass_(replay=True):
            torch.rand((3, 2), generator=gen)
    with pytest.raises(RuntimeError, match="the tape has"):
        with tape.pass_(replay=True):
            torch.randn((2, 3), generator=gen)
    with pytest.raises(RuntimeError, match="took 1 of 2"):
        with tape.pass_(replay=True):
            torch.rand((2, 3), generator=gen)
    assert torch.rand is not None and torch.rand(2).shape == (2,)  # restored


def test_distances_and_cosines_are_as_stated():
    rng = np.random.default_rng(0)
    a = [rng.standard_normal((3, 4)), rng.standard_normal(5)]
    b = [x + 0.1 * rng.standard_normal(x.shape) for x in a]
    va, vb = np.concatenate([x.ravel() for x in a]), np.concatenate([x.ravel() for x in b])
    ta, tb = [torch.from_numpy(x) for x in a], [torch.from_numpy(x) for x in b]
    assert gt.rel_distance(ta, tb) == pytest.approx(np.linalg.norm(va - vb) / np.linalg.norm(vb))
    assert gt.cosine(ta, tb) == pytest.approx(va @ vb / np.linalg.norm(va) / np.linalg.norm(vb))
    zero = [torch.zeros(3)]
    assert gt.rel_distance(zero, zero) == 0.0 and gt.cosine(zero, zero) == 1.0
    names = ["encoder.w", "decoder.step.hh_kernel0", "decoder.ih_emb.kernel", "memory"]
    grp = gt.groups(names)
    assert grp["decoder"] == ["decoder.step.hh_kernel0", "decoder.ih_emb.kernel", "memory"]
    assert grp["all"] == names[:3] and grp["memory"] == ["memory"]
    same = [a[0], a[1], a[1], a[0]]
    grads = {r: {"grads": {n: torch.from_numpy(x) for n, x in zip(names, same)}}
             for r in gt.ROUTES}
    grads["kernel"]["grads"]["decoder.ih_emb.kernel"] = torch.from_numpy(b[1])
    d = gt.compare(grads)
    assert d["decoder.ih_emb.kernel"]["kernel_vs_plain"] == pytest.approx(
        np.linalg.norm(b[1] - a[1]) / np.linalg.norm(a[1]))
    assert d["encoder.w"]["kernel_vs_plain"] == 0.0 and d["all"]["loop"]["rel"] == 0.0
    leaves = gt.kernel_leaves_plain(d)
    assert set(leaves) == {"decoder.ih_emb.kernel", "decoder"}


def test_trace_script_lines(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "decoder_grad_trace", os.path.join(REPO, "docs", "experiments", "decoder_grad_trace.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = tmp_path / "trace.jsonl"
    rows = script.main(["-device", "cpu", "-steps", "5", "-every", "4", "-depart", "0",
                        "-out", str(out)] + TINY)
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines == json.loads(json.dumps(rows))
    # step 0's losses depart at once (-depart 0): its onset is traced at step 1
    assert [(r["step"], r["trigger"]) for r in lines[:-1]] == [
        (0, "start"), (1, "departure"), (4, "every"), (5, "end")]
    for r in lines[:-1]:
        assert set(r["groups"]) == {"decoder", "all"} and "memory" in r["tensors"]
        assert set(r["groups"]["decoder"]) == {"kernel_plain", "loop"}
        assert set(r["route_losses"]) == {"kernel_plain", "loop", "loop_f32"}
        assert r["card"] == "cpu" and r["kernel_leaves_plain"] == {}
        checks = r["kernel_checks"]  # on the CPU the wrappers run the plain versions
        for name in ("fwd", "bwd"):
            assert checks[name]["whole"] == checks[name]["f32_whole"] == 0.0
            assert 0 < checks[name]["kernel_vs_f32"] == checks[name]["plain_vs_f32"] < 5e-2
        assert 0 < checks["mean_max_prob"] <= 1
    assert "loss_scans" in lines[0] and "loss_scans" not in lines[-2]
    end = lines[-1]
    assert end["summary"] and end["traced"] == 4 and end["departure_onsets"][0] == 0
    assert set(end["test_bleu"]) == {"kernels", "scans"}
