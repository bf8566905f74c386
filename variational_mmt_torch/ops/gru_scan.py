"""Fused GRU layer scan: the CUDA kernel's wrapper and its plain version.

Mirrors ``variational_mmt_tpu/ops/pallas/gru.py`` (``gru_layer_scan``,
forward only; the backward kernel comes with the training slice).

Source note. Replaces the Pallas kernel ``_gru_fwd_kernel``
(ops/pallas/gru.py:54, ``pallas_call`` at :165) with
``csrc/gru_scan.cu``. On the H100 the scan is bound by the latency of T
dependent steps: its bytes (about 15 MB at B=256, T=24, H=250 in bf16) and
FLOPs (2.3 GFLOP) bound it at a few microseconds, while each step must
wait for the whole previous state. The simple design keeps each block's
rows of the state in shared memory for the whole sequence and loops over
time inside the block; Wh (375 KB in bf16) does not fit one SM's shared
memory, so every step streams it from L2. The TPU's row chunking
(``_max_rows``, a VMEM budget) is not carried over: the grid covers B.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from variational_mmt_torch import kernels
from variational_mmt_torch.models.gru import gru_gates


def gru_layer_scan_ref(x_proj: torch.Tensor, mask: torch.Tensor, h0: torch.Tensor,
                       Wh: torch.Tensor, bh: torch.Tensor,
                       reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, step by step as the Pallas body
    computes it: f32 state, ``h`` rounded to Wh's dtype for the product with
    f32 accumulation, f32 bias and gate math. Returns (outs (B,T,H) f32,
    final (B,H) f32)."""
    B, T, H3 = x_proj.shape
    h = h0.float()
    w = Wh.float()
    b = bh.float()
    m = mask.float()
    outs = torch.empty((B, T, H3 // 3), dtype=torch.float32, device=x_proj.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h_proj = h.to(Wh.dtype).float() @ w + b
        h_new = gru_gates(x_proj[:, t].float(), h_proj, h)
        h = torch.where(m[:, t, None] > 0, h_new, h)
        outs[:, t] = h
    return outs, h


def gru_layer_scan(x_proj: torch.Tensor, mask: torch.Tensor, h0: torch.Tensor,
                   Wh: torch.Tensor, bh: torch.Tensor, reverse: bool = False,
                   reset: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GRU layer over the sequence. x_proj (B,T,3H) and Wh (H,3H) in
    one dtype (float32 or bfloat16); mask (B,T), h0 (B,H) and bh (3H,) are
    taken as f32. Returns (outs (B,T,H) f32, final (B,H) f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if reset is not None:
        raise NotImplementedError(
            "gru_layer_scan: reset (sequence packing) is not ported yet")
    if x_proj.device.type == "cpu":
        return gru_layer_scan_ref(x_proj, mask, h0, Wh, bh, reverse)
    B, T, H3 = x_proj.shape
    H = H3 // 3
    dt = Wh.dtype
    if dt not in kernels.DTYPE_CODE or x_proj.dtype != dt:
        raise TypeError(f"gru_layer_scan kernel: x_proj {x_proj.dtype} and Wh {dt} "
                        "must both be float32 or both bfloat16")
    if tuple(Wh.shape) != (H, H3) or tuple(mask.shape) != (B, T) or tuple(h0.shape) != (B, H) \
            or tuple(bh.shape) != (H3,):
        raise ValueError("gru_layer_scan kernel: shapes do not match x_proj (B,T,3H)")
    if not 1 <= H <= 1024:
        raise NotImplementedError(f"gru_layer_scan kernel: hidden {H} > 1024")
    x = x_proj.contiguous()
    m = mask.to(torch.float32).contiguous()
    h = h0.to(torch.float32).contiguous()
    w = Wh.contiguous()
    b = bh.to(torch.float32).contiguous()
    kernels.require_cuda("gru_layer_scan", x.device, mask=m, h0=h, Wh=w, bh=b)
    outs = torch.empty((B, T, H), dtype=torch.float32, device=x.device)
    final = torch.empty((B, H), dtype=torch.float32, device=x.device)
    lib = kernels.library("gru_scan")
    err = lib.vmmt_gru_scan(kernels.DTYPE_CODE[dt], x.data_ptr(), m.data_ptr(), h.data_ptr(),
                            w.data_ptr(), b.data_ptr(), outs.data_ptr(), final.data_ptr(),
                            B, T, H, int(reverse), kernels.stream_of(x))
    kernels.check(lib, err, "gru_layer_scan")
    gru_layer_scan.launches += 1
    return outs, final


gru_layer_scan.launches = 0
