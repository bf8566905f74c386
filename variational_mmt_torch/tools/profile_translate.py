"""Where the time of a beam-4 translation goes on the card.

    python -m variational_mmt_torch.tools.profile_translate [--out DIR]

Builds the serving cell of ``chip_smoke.py`` (``tools/flagship.py``:
vmmt_c at full width with random weights from numpy seed 0, bf16,
use_pallas), warms up, then for each decode step (``pallas_step`` 0, 1, 2)
translates the cell's first request of 256 sentences (lengths 8-24, beam
4, max_length 60) under ``torch.profiler``. Prints, per mode, the host wall time, the device's busy
time and idle share, and the device time by layer (encoder scan, decode
step kernels, cuBLAS GEMMs, softmax, top-k, the rest) and by kernel; the
per-kernel tables also go to DIR (default build/profile).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from variational_mmt_torch.config import DecodeConfig
from variational_mmt_torch.data.vocab import SPECIALS, Vocab
from variational_mmt_torch.decode.translator import Translator
from variational_mmt_torch.models.model import build_model
from variational_mmt_torch.tools import flagship

LAYERS = (  # (layer, substrings of kernel names), first match wins
    ("encoder GRU scan kernel", ("gru_scan_fwd_kernel",)),
    ("decode step kernels", ("cell_mma_kernel", "stepqw", "step_attn_kernel")),
    ("top-k / sort", ("topk", "radix", "sort", "select")),
    ("softmax", ("softmax",)),
    ("cuBLAS GEMM", ("gemm", "sm90", "cutlass", "xmma", "gemv")),
)


def layer_of(name: str) -> str:
    low = name.lower()
    for layer, keys in LAYERS:
        if any(k in low for k in keys):
            return layer
    return "elementwise, gather, copy"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_translate: needs a CUDA card")
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    full, state = flagship.load()
    cfg = full.model
    model = build_model(cfg, device="cuda")
    model.load_state_dict(state)
    vocab = Vocab(SPECIALS + [f"w{i}" for i in range(cfg.tgt_vocab_size - len(SPECIALS))])
    src, img = flagship.requests(cfg)(256)

    for mode in (0, 1, 2):
        tr = Translator(model, vocab, vocab, DecodeConfig(beam_size=4, max_length=60,
                                                          batch_size=256, pallas_step=mode))
        tr.translate_ids(src[:16], img[:16])  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.translate_ids(src, img)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_kernel = defaultdict(lambda: [0.0, 0])
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                rec = by_kernel[e.name]
                rec[0] += e.time_range.elapsed_us()
                rec[1] += 1
        busy = sum(t for t, _ in by_kernel.values())
        by_layer = defaultdict(float)
        for name, (t, _) in by_kernel.items():
            by_layer[layer_of(name)] += t
        print(f"\npallas_step={mode}: 256 sentences, wall {wall_us / 1e3:.1f} ms, device busy "
              f"{busy / 1e3:.1f} ms, idle share {1 - busy / wall_us:.3f} ({card})")
        for layer, t in sorted(by_layer.items(), key=lambda kv: -kv[1]):
            print(f"  {layer:28s} {t / 1e3:9.2f} ms  {t / busy:6.1%} of device time")
        lines = [f"{t / 1e3:10.3f} ms {n:7d}x  {name}"
                 for name, (t, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])]
        with open(os.path.join(args.out, f"kernels_pallas_step{mode}.txt"), "w") as f:
            f.write(f"{card}\npallas_step={mode} wall {wall_us / 1e3:.3f} ms\n")
            f.write("\n".join(lines) + "\n")
        print("  top kernels:")
        for line in lines[:8]:
            print("   ", line[:150])


if __name__ == "__main__":
    main()
