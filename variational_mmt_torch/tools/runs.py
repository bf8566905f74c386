"""What the port's study tools (``quality_gate``, ``regularization_gate``,
``iw_study``, ``sweep``) share: the ``-device`` and ``-route`` flags, the
model settings of each route, the card's name for the records, and the
kernels' launch counters read per run.

The device is cuda unless ``-device cpu``. The route follows from it: on
cuda ``kernels``, the port's production route (bf16, ``use_pallas``,
``pallas_decoder``, ``fused_ce`` and decode ``pallas_step`` 1); on the
CPU ``plain``, f32 without kernels. On cuda ``-route`` picks another one
for a witness run that separates a kernel's share in a result: ``plain``,
or ``scans``, the route the JAX tools run on the TPU (bf16, the scan
kernels and ``fused_ce``; the decoder's sequence and decode step plain).
"""

from __future__ import annotations

import argparse
import subprocess
from typing import Dict

import torch

from variational_mmt_torch.ops import decode_step, decoder, gru_scan

ROUTES = ("kernels", "scans", "plain")
# every kernel wrapper's launch counter, read per run
COUNTERS = {"gru_layer_scan": gru_scan.gru_layer_scan,
            "gru_layer_scan_bwd": gru_scan.gru_layer_scan_bwd,
            "decode_step": decode_step.decode_step, "gru_chain": decode_step.gru_chain,
            "decoder_fwd": decoder.decoder_fwd, "decoder_bwd": decoder.decoder_bwd,
            # row 2's operand pass and products on the wgmma engine, two of
            # each a bf16 backward call
            "scan_bwd_operands": gru_scan.scan_bwd_operands, "wgmma_gemm": gru_scan.wgmma_gemm}


def add_route_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("-route", default=None, choices=ROUTES,
                   help="cuda only (default kernels: bf16 and every CUDA kernel); scans: "
                        "bf16, the scan kernels only; plain: f32, no kernels. The CPU "
                        "runs plain")


def add_device_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"])
    add_route_arg(p)


def resolve_route(p: argparse.ArgumentParser, args) -> None:
    """Set ``args.route`` from ``-device`` where it was not given; refuse a
    kernel route on the CPU."""
    if args.route is None:
        args.route = "kernels" if args.device == "cuda" else "plain"
    elif args.device == "cpu" and args.route != "plain":
        p.error(f"-route {args.route} needs -device cuda (the CPU runs the plain route)")


def route_model(route: str) -> Dict[str, object]:
    """The ModelConfig fields a route sets."""
    bf16 = route != "plain"
    return dict(compute_dtype="bfloat16" if bf16 else "float32", use_pallas=bf16,
                pallas_decoder=route == "kernels", fused_ce=bf16)


def route_pallas_step(route: str) -> int:
    """The decode step a route decodes with."""
    return 1 if route == "kernels" else 0


def zero_launches() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    return {k: fn.launches for k, fn in COUNTERS.items()}


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or 'cpu'."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
