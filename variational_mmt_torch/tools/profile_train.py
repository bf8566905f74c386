"""Where the time of a training step goes on the card.

    python -m variational_mmt_torch.tools.profile_train [--out DIR] [--steps N]
                                                       [--fast H | --gate]

Builds the training cells of ``chip_smoke.py`` (``tools/flagship.py``:
vmmt_c at full width with random weights from numpy seed 0, bf16,
use_pallas, fused_ce; 4 fixed batches of 64 sentence pairs from numpy
seed 1, and 4 packed batches of 64 rows of 64 tokens), then for
``pallas_decoder`` 1 and 0 and for the packed cell (``train.pack``) warms
up with 3 Trainer steps and takes N more (default 3) under
``torch.profiler``. With ``--fast H``, one cell instead: the fast config
(``input_feed`` off, ``use_pallas``, ``pallas_decoder`` off) at hidden
width H, random weights from numpy seed 0, on the same batches. With
``--gate``, one cell instead: the quality gate's vmmt_c
(``tools/quality_gate.py``'s defaults: hidden 256, so B = 64 and H = 128 a
direction in the encoder, buckets of 16, 24 and 32 tokens, seed 11) on its
ambiguous corpus, batches as the gate draws them.
Prints, per setting, the host wall time per step (also of N steps before,
without the profiler), the device's busy time
and idle share, and the device time by layer (GRU-scan kernels, decoder
sequence kernels, cuBLAS GEMMs, softmax, reductions, the rest) and by
kernel; the per-kernel tables also go to DIR (default build/profile).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from variational_mmt_torch.convert import params_from_jax
from variational_mmt_torch.models.model import build_model, init_params
from variational_mmt_torch.tools import flagship
from variational_mmt_torch.train.trainer import Trainer

OWN = "(anonymous namespace)::"  # the port's kernels live in anonymous namespaces
LAYERS = (  # (layer, names of the port's kernels or substrings of library ones)
    ("GRU-scan kernels (rows 1, 2)", ("gru_scan_fwd_kernel", "gru_scan_bwd_kernel",
                                      "gru_tiled_fwd_kernel", "gru_tiled_bwd_kernel",
                                      "gru_wide_fwd_kernel",  # an older tree's wide forward
                                      "ScanHoist", "ScanDWh",
                                      # row 2's products on the wgmma engine
                                      "scan_hs_kernel", "scan_dp_kernel",
                                      "wgmma_gemm_kernel")),
    ("decoder sequence kernels (rows 5, 6)", ("decoder_fwd_kernel", "DecHoist",
                                              "decoder_bwd_kernel")),
    ("cuBLAS GEMM", ("gemm", "sm90", "cutlass", "xmma", "gemv")),
    ("softmax", ("softmax",)),
    ("reductions", ("reduce",)),
)


def layer_of(name: str) -> str:
    own = name.split(OWN, 1)[1].split("<", 1)[0] if OWN in name else None
    if own == "tile_gemm_kernel":  # named by its operation, the second template argument
        own = name.split(OWN)[2].split("<", 1)[0]
    low = name.lower()
    for layer, keys in LAYERS:
        if own is not None and own in keys:
            return layer
        if own is None and any(k in low for k in keys):
            return layer
    return "elementwise, gather, copy"


def profiled(run: Callable[[], object]) -> Tuple[float, Dict[str, List[float]]]:
    """(host wall µs, {kernel: [device µs, launches]}) of ``run()`` under
    ``torch.profiler``, synchronized before and after; the device's busy
    time is the sum of the kernels' times."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            rec = by_kernel[e.name]
            rec[0] += e.time_range.elapsed_us()
            rec[1] += 1
    return wall_us, by_kernel


def gate_cell():
    """(config, weights, batches) of the quality gate's vmmt_c run at seed
    11, as ``tools/quality_gate.py``'s ``run_one`` builds them."""
    import numpy as np

    from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
    from variational_mmt_torch.data.synthetic import make_ambiguous_corpus
    from variational_mmt_torch.tools import quality_gate as qg

    opt = qg.parse_args(["-models", "vmmt_c", "-seeds", "11"])
    src, tgt, feats, sv, tv, _, _ = make_ambiguous_corpus(
        opt.n_train, vocab_size=opt.vocab_size, img_dim=opt.img_dim, seed=opt.data_seed,
        regions=opt.img_regions)
    ids = lambda lines, v: [np.asarray(v.encode(x), np.int32) for x in lines]  # noqa: E731
    batches = BucketIterator(BinarizedDataset(ids(src, sv), ids(tgt, tv)), opt.batch_size,
                             qg.BUCKETS, img_feats=feats, shuffle=True, seed=11)
    cfg = qg.build_cfg("vmmt_c", 11, opt)
    return cfg, params_from_jax(init_params(cfg.model, seed=11), cfg.model), batches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--fast", type=int, default=None, metavar="H",
                    help="time the fast config at hidden width H instead")
    ap.add_argument("--gate", action="store_true",
                    help="time the quality gate's vmmt_c training cell instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA card")
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    cfg, state = flagship.load()
    m = cfg.model
    packed = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, pack=True))
    cells = [(f"pallas_decoder={int(p)}",
              dataclasses.replace(cfg, model=dataclasses.replace(m, pallas_decoder=p)),
              flagship.train_batches(m)) for p in (True, False)]
    cells.append(("packed", packed, flagship.packed_batches(m)))
    if args.fast is not None:
        fast = dataclasses.replace(m, hidden_dim=args.fast, input_feed=False, use_pallas=True,
                                   pallas_decoder=False)
        state = params_from_jax(init_params(fast, seed=0), fast)
        cells = [(f"fast hidden_dim={args.fast}", dataclasses.replace(cfg, model=fast),
                  flagship.train_batches(fast))]
    if args.gate:
        cfg, state, batches = gate_cell()
        cells = [("quality gate vmmt_c", cfg, batches)]

    for cell, c, batches in cells:
        model = build_model(c.model, device="cuda")
        model.load_state_dict(state)
        trainer = Trainer(c, model, batches, device="cuda")
        trainer.train(3)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(args.steps)
        torch.cuda.synchronize()
        untraced_us = (time.perf_counter() - t0) * 1e6
        wall_us, by_kernel = profiled(lambda: trainer.train(args.steps))
        busy = sum(t for t, _ in by_kernel.values())
        by_layer = defaultdict(float)
        for name, (t, _) in by_kernel.items():
            by_layer[layer_of(name)] += t
        n = args.steps
        print(f"\n{cell}: {n} steps of batch 64, wall "
              f"{wall_us / 1e3 / n:.2f} ms/step ({untraced_us / 1e3 / n:.2f} without the "
              f"profiler), device busy {busy / 1e3 / n:.2f} ms/step, "
              f"idle share {1 - busy / wall_us:.3f} ({card})")
        for layer, t in sorted(by_layer.items(), key=lambda kv: -kv[1]):
            print(f"  {layer:38s} {t / 1e3 / n:9.3f} ms/step  {t / busy:6.1%} of device time")
        lines = [f"{t / 1e3 / n:10.4f} ms/step {n_k // n:7d}x/step  {name}"
                 for name, (t, n_k) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])]
        with open(os.path.join(args.out, f"kernels_train_{cell.replace('=', '')}.txt"),
                  "w") as f:
            f.write(f"{card}\n{cell} wall {wall_us / 1e3 / n:.3f} ms/step\n")
            f.write("\n".join(lines) + "\n")
        print("  top kernels:")
        for line in lines[:10]:
            print("   ", line[:150])
        trainer.close()
        del trainer, model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
