"""Where the time of the decoder's persistent kernels (rows 5 and 6 of
PERF.md's table) goes, phase by phase.

    python -m variational_mmt_torch.tools.phase_times [--calls N]

At the training cell's decoder shape (B=64, T=25, S=24, H=500, bf16, the
init-scale weights and attention memory of std 0.1 that ``chip_smoke.py``
checks), runs the forward and the backward N times each (default 20) with
a probe: thread 0 of CTA 0 writes ``%globaltimer`` at the kernel's start,
after its prologue and as it arrives at and leaves each grid barrier.
Prints one JSON line with the card's name and power limit and, for each
kernel, the mean over calls of: the prologue, each phase's time a step
(from leaving one barrier to leaving the next: the slowest CTA's work and
the barrier), CTA 0's own work in it and its wait at the barrier, all in
microseconds, over steps 1..T-1 (step 0 also carries what the first step
does once; its total is given apart), and the whole kernel.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import numpy as np
import torch

from variational_mmt_torch.ops import decoder as dec

SHAPE = dict(B=64, T=25, S=24, H=500)
PHASES = {
    "decoder_fwd": ("feed product, GRU0", "mid product, GRU1",
                    "h1' products, attention", "tanh, h0' product"),
    "decoder_bwd": ("attention backward", "Wc_q^T product, GRU1 backward",
                    "Wh1^T and Wmid^T products, GRU0 backward",
                    "Wh0^T and Wfeed^T products"),
}


def inputs(g: torch.Generator, B: int, T: int, S: int, H: int):
    """The forward's inputs in bf16 (weights std 1/sqrt(H), memory std 0.1,
    dropout mask at p=0.3, source lengths 8..S) and cotangents."""
    dt = torch.bfloat16
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    w = lambda *s: (r(*s) / math.sqrt(H)).to(dt)  # noqa: E731
    dmid = ((torch.rand(B, T, H, generator=g, device="cuda") > 0.3).float() / 0.7).to(dt)
    lengths = torch.randint(8, S + 1, (B,), generator=g, device="cuda")
    mask_bias = (torch.arange(S, device="cuda")[None, :] >= lengths[:, None]).float() * -1e9
    args = (r(B, T, 3 * H).to(dt), dmid, torch.tanh(r(B, H)), torch.tanh(r(B, H)),
            w(H, 3 * H), w(H, 3 * H), 0.1 * r(3 * H), w(H, 3 * H), 0.1 * r(3 * H),
            w(H, 3 * H), 0.1 * r(3 * H), (0.1 * r(B, S, H)).to(dt), (0.1 * r(B, S, H)).to(dt),
            w(H, H), mask_bias)
    return args, (r(B, T, H), r(B, T, S))


def split(stamps: np.ndarray, T: int) -> dict:
    """Phase times in us from the stamps of ``calls`` probed launches
    (calls, probe_len(T)) in ns."""
    P = dec.DEC_PHASES
    us = stamps.astype(np.float64) / 1e3
    arrive = us[:, 2::2].reshape(-1, T, P)
    leave = us[:, 3::2].reshape(-1, T, P)
    prev = np.concatenate([us[:, 1:2], leave.reshape(-1, T * P)[:, :-1]], axis=1)
    prev = prev.reshape(-1, T, P)
    phase, work, wait = leave - prev, arrive - prev, leave - arrive
    steady = slice(1, T) if T > 1 else slice(0, T)
    return {
        "prologue_us": float(np.mean(us[:, 1] - us[:, 0])),
        "phase_us": [float(v) for v in phase[:, steady].mean(axis=(0, 1))],
        "cta0_work_us": [float(v) for v in work[:, steady].mean(axis=(0, 1))],
        "cta0_wait_us": [float(v) for v in wait[:, steady].mean(axis=(0, 1))],
        "step_us": float(phase[:, steady].sum(axis=2).mean()),
        "first_step_us": float(phase[:, 0].sum(axis=1).mean()),
        "kernel_us": float(np.mean(us[:, -1] - us[:, 0])),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("phase_times: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    B, T, S, H = (SHAPE[k] for k in ("B", "T", "S", "H"))
    g = torch.Generator(device="cuda").manual_seed(6)
    fwd_args, d = inputs(g, B, T, S, H)
    streams = dec.decoder_fwd(*fwd_args)
    calls = {
        "decoder_fwd": lambda probe: dec.decoder_fwd(*fwd_args, probe=probe),
        "decoder_bwd": lambda probe: dec.decoder_bwd(*fwd_args[:14], *streams, *d, probe=probe),
    }
    out = {"card": card, "shape": dict(SHAPE, dtype="bfloat16"), "calls": args.calls}
    for name, call in calls.items():
        probes = torch.zeros(args.calls, dec.probe_len(T), dtype=torch.int64, device="cuda")
        call(probes[0])  # warm-up: library load, first launch
        for i in range(args.calls):
            call(probes[i])
        torch.cuda.synchronize()
        out[name] = dict(split(probes.cpu().numpy(), T), phases=PHASES[name],
                         plan=getattr(dec, name).plan)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
