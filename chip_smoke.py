#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for the numbers
in PERF.md).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the port's CUDA kernels from csrc/ (set-up time).
3. Kernel phases: holds each kernel (GRU scan, decode step, GRU chain)
   against its plain PyTorch version at the flagship shapes, in float32
   (tolerance 1e-4 absolute: summation order only) and in bfloat16
   (tolerance 2e-2 absolute on outputs in [-1, 1]: bf16 rounding of the
   outputs and of products the kernel keeps in f32), and times kernel,
   plain version and, for the scan, cuDNN's nn.GRU as a yardstick.
4. Slice phase: vmmt_c at full width (the port's configs/vmmt_c_multi30k.json,
   vocab 10000/10000, bf16, use_pallas) with random weights from numpy seed 0
   through convert.py; Translator(device="cuda") answers three request
   batches of 256 sentences (beam 4, max_length 60) with pallas_step=1 and
   three with pallas_step=2, and every kernel's launch count must rise;
   outputs must be well formed; sent/s is measured twice for each of
   pallas_step 0, 1 and 2, in turns (1 2 0 0 2 1); in float32, 32 sentences
   through the kernel path and the all-plain path must agree on at least
   31 top-1 hypotheses.
5. Prints one JSON line of per-kernel numbers, then the last line
   {"ok": true, "device": {...}}.

Exits non-zero, with no result line, when CUDA is unavailable, when the
port's package is not beside this script, or when any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (NVIDIA data sheet, SXM)
H100_F32_FLOPS = 67e12  # non-tensor-core float32 peak
H100_BYTES_PER_S = 3.35e12
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SCAN_SHAPE = dict(B=256, T=24, H=250)
STEP_SHAPE = dict(N=1024, S=24, H=500)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float, dtype: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    FLOPs over the peak rate of the dtype."""
    peak = H100_BF16_FLOPS if dtype == "bfloat16" else H100_F32_FLOPS
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def check_close(name: str, dtype: str, err: float) -> None:
    ok = math.isfinite(err) and err <= TOL[dtype]
    print(f"  {name} {dtype}: max_abs_err {err:.3e} (tolerance {TOL[dtype]:.0e}) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} kernel disagrees with its plain version in {dtype}")


def scan_phase(gru_scan):
    """GRU scan at B=256, T=24, H=250, both directions."""
    B, T, H = SCAN_SHAPE["B"], SCAN_SHAPE["T"], SCAN_SHAPE["H"]
    g = torch.Generator(device="cuda").manual_seed(1)
    lengths = torch.randint(8, T + 1, (B,), generator=g, device="cuda")
    mask = (torch.arange(T, device="cuda")[None, :] < lengths[:, None]).float()
    rec = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        x = torch.randn(B, T, 3 * H, generator=g, device="cuda").to(dt)
        h0 = 0.1 * torch.randn(B, H, generator=g, device="cuda")
        wh = (torch.randn(H, 3 * H, generator=g, device="cuda") / math.sqrt(H)).to(dt)
        bh = 0.1 * torch.randn(3 * H, generator=g, device="cuda")
        errs = []
        for reverse in (False, True):
            got = gru_scan.gru_layer_scan(x, mask, h0, wh, bh, reverse)
            want = gru_scan.gru_layer_scan_ref(x, mask, h0, wh, bh, reverse)
            torch.cuda.synchronize()
            errs.append(max_err(got, want))
        check_close("gru_scan", dt_name, max(errs))
        rec[f"err_{dt_name}"] = max(errs)
    # times at the main path's dtype (bf16)
    rec["ms"] = cuda_ms(lambda: gru_scan.gru_layer_scan(x, mask, h0, wh, bh, True))
    rec["plain_ms"] = cuda_ms(lambda: gru_scan.gru_layer_scan_ref(x, mask, h0, wh, bh, True),
                              iters=5)
    gru = torch.nn.GRU(2 * H, H, batch_first=True, device="cuda", dtype=torch.bfloat16)
    xin = torch.randn(B, T, 2 * H, generator=g, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        rec["library_ms"] = cuda_ms(lambda: gru(xin))
    n_bytes = B * T * 3 * H * 2 + B * T * 4 + B * H * 4 + H * 3 * H * 2 + 3 * H * 4 \
        + B * T * H * 4 + B * H * 4
    rec["bound_ms"], rec["bound_by"] = bound(n_bytes, 2.0 * B * T * H * 3 * H, "bfloat16")
    return rec


def step_inputs(g, dt, N, S, H):
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    lengths = torch.randint(8, S + 1, (N,), generator=g, device="cuda")
    mask_bias = (torch.arange(S, device="cuda")[None, :] >= lengths[:, None]).float() * -1e9
    w = lambda *s: (r(*s) / math.sqrt(H)).to(dt)  # noqa: E731
    chain = (r(N, 3 * H).to(dt), torch.tanh(r(N, H)).to(dt), torch.tanh(r(N, H)).to(dt),
             torch.tanh(r(N, H)).to(dt), w(H, 3 * H), w(H, 3 * H), 0.1 * r(3 * H),
             w(H, 3 * H), 0.1 * r(3 * H), w(H, 3 * H), 0.1 * r(3 * H))
    attn = ((0.5 * r(N, S, H)).to(dt), (0.5 * r(N, S, H)).to(dt), w(H, H), mask_bias)
    return chain, attn


def step_phase(ds):
    """Decode step and GRU chain at N=1024, S=24, H=500."""
    N, S, H = STEP_SHAPE["N"], STEP_SHAPE["S"], STEP_SHAPE["H"]
    g = torch.Generator(device="cuda").manual_seed(2)
    step_rec, chain_rec = {}, {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        chain, attn = step_inputs(g, dt, N, S, H)
        got = ds.decode_step(*chain, *attn)
        want = ds.decode_step_ref(*chain, *attn)
        got_c = ds.gru_chain(*chain)
        want_c = ds.gru_chain_ref(*chain)
        torch.cuda.synchronize()
        step_rec[f"err_{dt_name}"] = max_err(got, want)
        chain_rec[f"err_{dt_name}"] = max_err(got_c, want_c)
        check_close("decode_step", dt_name, step_rec[f"err_{dt_name}"])
        check_close("gru_chain", dt_name, chain_rec[f"err_{dt_name}"])
    step_rec["ms"] = cuda_ms(lambda: ds.decode_step(*chain, *attn))
    step_rec["plain_ms"] = cuda_ms(lambda: ds.decode_step_ref(*chain, *attn))
    chain_rec["ms"] = cuda_ms(lambda: ds.gru_chain(*chain))
    chain_rec["plain_ms"] = cuda_ms(lambda: ds.gru_chain_ref(*chain))
    b = 2  # bf16 bytes
    chain_bytes = N * 3 * H * b + 3 * N * H * b + 4 * H * 3 * H * b + 3 * 3 * H * 4 + 2 * N * H * b
    chain_flops = 2.0 * N * H * 3 * H * 4
    step_bytes = chain_bytes + H * H * b + 2 * N * S * H * b + N * S * 4 + N * H * b + N * S * b
    step_flops = chain_flops + 2.0 * N * H * H + 4.0 * N * S * H
    chain_rec["bound_ms"], chain_rec["bound_by"] = bound(chain_bytes, chain_flops, "bfloat16")
    step_rec["bound_ms"], step_rec["bound_by"] = bound(step_bytes, step_flops, "bfloat16")
    step_rec["library_ms"] = chain_rec["library_ms"] = None
    return step_rec, chain_rec


def well_formed(out, n_sent: int, vocab_size: int, max_length: int) -> None:
    if len(out) != n_sent:
        fail(f"{len(out)} results for {n_sent} sentences")
    for nbest in out:
        score, ids = nbest[0]
        if not math.isfinite(score):
            fail(f"non-finite score {score}")
        if len(ids) > max_length or any(not (0 < i < vocab_size) for i in ids):
            fail(f"malformed hypothesis {ids[:10]}...")


def slice_phase(card: str):
    from variational_mmt_torch.config import Config, DecodeConfig
    from variational_mmt_torch.convert import params_from_jax
    from variational_mmt_torch.data.vocab import SPECIALS, Vocab
    from variational_mmt_torch.decode.translator import Translator
    from variational_mmt_torch.models.model import build_model, init_params
    from variational_mmt_torch.ops import decode_step as ds, gru_scan

    with open(os.path.join(HERE, "variational_mmt_torch", "configs", "vmmt_c_multi30k.json")) as f:
        cfg = Config.from_json(f.read()).model
    V = cfg.tgt_vocab_size
    print(f"slice: vmmt_c emb {cfg.emb_dim} hidden {cfg.hidden_dim} layers "
          f"{cfg.enc_layers}+{cfg.dec_layers} latent {cfg.latent_dim} img {cfg.img_feat_dim} "
          f"vocab {cfg.src_vocab_size}/{V} {cfg.compute_dtype} use_pallas={cfg.use_pallas}")
    t0 = time.time()
    tree = init_params(cfg, seed=0)
    state = params_from_jax(tree, cfg)
    model = build_model(cfg, device="cuda")
    model.load_state_dict(state)
    vocab = Vocab(SPECIALS + [f"w{i}" for i in range(V - len(SPECIALS))])
    print(f"slice: weights from numpy seed 0 in {time.time() - t0:.1f} s")

    rng = np.random.default_rng(1)

    def request(n):
        src = [rng.integers(4, cfg.src_vocab_size, rng.integers(8, 25)).tolist() for _ in range(n)]
        img = np.abs(rng.standard_normal((n, cfg.img_feat_dim))).astype(np.float32)
        return src, img

    requests = [request(256) for _ in range(3)]
    translators = {m: Translator(model, vocab, vocab,
                                 DecodeConfig(beam_size=4, max_length=60, batch_size=256,
                                              pallas_step=m), device="cuda")
                   for m in (0, 1, 2)}
    for m, tr in translators.items():  # warm-up: library load, cuBLAS handles
        tr.translate_ids(*request(8))

    top1_lengths = []

    def serve(mode):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for src, img in requests:
            out = translators[mode].translate_ids(src, img)
            well_formed(out, len(src), V, 60)
            top1_lengths.extend(len(nbest[0][1]) for nbest in out)
        torch.cuda.synchronize()
        return sum(len(s) for s, _ in requests) / (time.perf_counter() - t)

    counters = (gru_scan.gru_layer_scan, ds.decode_step, ds.gru_chain)
    for fn in counters:
        fn.launches = 0
    runs = {1: [serve(1)], 2: [serve(2)], 0: []}
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"slice: launches on the main path {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    for m in (0, 0, 2, 1):  # in turns: 1 2 0 0 2 1
        runs[m].append(serve(m))
    rate = {m: sum(r) / len(r) for m, r in runs.items()}
    print(f"slice: mean top-1 hypothesis length {np.mean(top1_lengths):.2f} tokens "
          f"(max_length 60)")
    for m in (0, 1, 2):
        print(f"slice: beam-4 sent/s pallas_step={m}: {rate[m]:.1f} (runs "
              f"{', '.join(f'{r:.1f}' for r in runs[m])}; batch 256, max_length 60, {card})")

    # f32: kernel path against the all-plain path on 32 sentences
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    plain_cfg = dataclasses.replace(cfg32, use_pallas=False)
    src, img = request(32)
    outs = []
    for c, mode in ((cfg32, 1), (plain_cfg, 0)):
        m = build_model(c, device="cuda")
        m.load_state_dict(state)
        tr = Translator(m, vocab, vocab, DecodeConfig(beam_size=4, max_length=60,
                                                      batch_size=32, pallas_step=mode),
                        device="cuda")
        outs.append(tr.translate_ids(src, img))
    same = sum(a[0][1] == b[0][1] for a, b in zip(*outs))
    dscore = max((abs(a[0][0] - b[0][0]) for a, b in zip(*outs) if a[0][1] == b[0][1]),
                 default=float("nan"))
    print(f"slice: f32 kernel path vs all-plain path: {same}/32 identical top-1 "
          f"hypotheses, max score difference {dscore:.2e}")
    if same < 31:
        fail("kernel path and plain path disagree on more than 1 of 32 sentences")
    return launches, rate


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    if not os.path.isdir(os.path.join(HERE, "variational_mmt_torch")):
        fail("variational_mmt_torch/ is not beside chip_smoke.py: run it from a checkout")
    sys.path.insert(0, HERE)
    from variational_mmt_torch import kernels
    from variational_mmt_torch.ops import decode_step as ds, gru_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.time()
    logs = kernels.build()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"  nvcc {name}: {line.strip()}")
    print(f"build: {time.time() - t0:.1f} s")

    scan = scan_phase(gru_scan)
    step, chain = step_phase(ds)
    launches, rate = slice_phase(card)

    entries = []
    for name, rec, src, replaces in (
        ("gru_layer_scan", scan, "variational_mmt_torch/csrc/gru_scan.cu",
         "variational_mmt_tpu/ops/pallas/gru.py:165"),
        ("decode_step", step, "variational_mmt_torch/csrc/decode_step.cu",
         "variational_mmt_tpu/ops/pallas/decode_step.py:176"),
        ("gru_chain", chain, "variational_mmt_torch/csrc/decode_step.cu",
         "variational_mmt_tpu/ops/pallas/decode_step.py:118"),
    ):
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec["err_bfloat16"],
            "max_abs_err_f32": rec["err_float32"], "dtype": "bfloat16",
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    print(json.dumps({"kernels": entries, "sent_per_s": rate, "card": card}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
