"""Times of the six kernels (rows 1-6 of PERF.md's table) at the main
paths' shapes, for comparing two trees of the port on one card.

    PYTHONPATH=<tree> python <this file> [-dtype bfloat16|float16|float32]

imports ``variational_mmt_torch`` from ``<tree>`` (so one copy of this
script times an older tree too: it calls only the wrappers' public
signatures) and prints one JSON line: for the GRU-scan forward at B=256
(serving) and B=64 (training), T=24, H=250, its backward at B=64 (both
without a reset stream), the decode step and GRU chain at N=1024,
S=24, H=500, and the decoder sequence forward and backward at the training
shape (B=64, T=25, S=24, H=500, attention memory std 0.1), all in
``-dtype`` (bfloat16 by default; a tree older than
the float16 kernels refuses float16), the time of one call by CUDA
events over 50 calls after 5 (``ms``: what ``chip_smoke.py`` reports, the
host's launch work included when it is the slower side) and the device
time of one call under ``torch.profiler`` (``device_ms``: the kernels'
own time, summed over the CUDA kernels of 10 calls), with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from variational_mmt_torch.ops import decode_step as ds
from variational_mmt_torch.ops import decoder as dec
from variational_mmt_torch.ops import gru_scan


def event_ms(fn, iters: int = 50, warmup: int = 5) -> float:
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


def device_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and "Memset" not in e.name)
    return us / iters / 1e3


def main(argv=None) -> None:
    p = argparse.ArgumentParser("kernel_times")
    p.add_argument("-dtype", default="bfloat16", choices=["bfloat16", "float16", "float32"])
    opt = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(5)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    bf = getattr(torch, opt.dtype)
    calls = {}
    H = 250
    for B in (256, 64):
        lengths = torch.randint(8, 25, (B,), generator=g, device="cuda")
        mask = (torch.arange(24, device="cuda")[None] < lengths[:, None]).float()
        args = (r(B, 24, 3 * H).to(bf), mask, 0.1 * r(B, H),
                (r(H, 3 * H) / math.sqrt(H)).to(bf), 0.1 * r(3 * H))
        calls[f"gru_layer_scan B={B}"] = lambda a=args: gru_scan.gru_layer_scan(*a, True)
    outs, _ = gru_scan.gru_layer_scan_ref(*args, True)
    g_outs = r(64, 24, H)
    calls["gru_layer_scan_bwd B=64"] = lambda: gru_scan.gru_layer_scan_bwd(*args, outs, g_outs,
                                                                            True)
    N, S, H = 1024, 24, 500
    w = lambda *s: (r(*s) / math.sqrt(H)).to(bf)  # noqa: E731
    chain = (r(N, 3 * H).to(bf), torch.tanh(r(N, H)).to(bf), torch.tanh(r(N, H)).to(bf),
             torch.tanh(r(N, H)).to(bf), w(H, 3 * H), w(H, 3 * H), 0.1 * r(3 * H),
             w(H, 3 * H), 0.1 * r(3 * H), w(H, 3 * H), 0.1 * r(3 * H))
    lengths = torch.randint(8, S + 1, (N,), generator=g, device="cuda")
    mask_bias = (torch.arange(S, device="cuda")[None] >= lengths[:, None]).float() * -1e9
    attn = ((0.5 * r(N, S, H)).to(bf), (0.5 * r(N, S, H)).to(bf), w(H, H), mask_bias)
    calls["decode_step"] = lambda: ds.decode_step(*chain, *attn)
    calls["gru_chain"] = lambda: ds.gru_chain(*chain)
    B, T = 64, 25
    dmid = ((torch.rand(B, T, H, generator=g, device="cuda") > 0.3).float() / 0.7).to(bf)
    lengths = torch.randint(8, S + 1, (B,), generator=g, device="cuda")
    mask_bias = (torch.arange(S, device="cuda")[None] >= lengths[:, None]).float() * -1e9
    seq = (r(B, T, 3 * H).to(bf), dmid, torch.tanh(r(B, H)), torch.tanh(r(B, H)),
           w(H, 3 * H), w(H, 3 * H), 0.1 * r(3 * H), w(H, 3 * H), 0.1 * r(3 * H),
           w(H, 3 * H), 0.1 * r(3 * H), (0.1 * r(B, S, H)).to(bf), (0.1 * r(B, S, H)).to(bf),
           w(H, H))
    streams = dec.decoder_fwd_ref(*seq, mask_bias)
    grads = (r(B, T, H), r(B, T, S))
    calls["decoder_fwd"] = lambda: dec.decoder_fwd(*seq, mask_bias)
    calls["decoder_bwd"] = lambda: dec.decoder_bwd(*seq, *streams, *grads)
    out = {name: {"ms": event_ms(fn), "device_ms": device_ms(fn)} for name, fn in calls.items()}
    print(json.dumps({"kernel_times": out, "dtype": opt.dtype, "card": card}))


if __name__ == "__main__":
    main()
