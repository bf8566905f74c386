"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

At first use each source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library under ``build/vmmt_torch_kernels/`` at the repo root.
The file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a library is rebuilt only when one of
them changes; all missing libraries are compiled
in parallel, one ``nvcc`` per source. The libraries have a plain C
interface and are loaded with ``ctypes``: every pointer and the stream go
as ``c_void_p``, sizes and flags as ``c_int``, and each entry point returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

Nothing here runs at import time: the CPU tests import every module of the
port, and this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "vmmt_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# library name -> {C entry point: argtypes}
SIGNATURES: Dict[str, Dict[str, list]] = {
    "gru_scan": {
        # dtype, x_proj, mask, reset (null: none), h0, wh, bh, outs, final,
        # B, T, H, reverse, cluster, units, rows, stream
        "vmmt_gru_scan": [_I] + [_P] * 8 + [_I] * 7 + [_P],
        # dtype, H, cluster, rows, out: max active clusters (0: the card
        # cannot hold a cluster of that size), smem bytes
        "vmmt_gru_scan_occupancy": [_I] * 4 + [_P] * 2,
        # dtype, x_proj, mask, reset (null: none), h0, wh, bh, outs, g, dx,
        # dh0, dwh, dbh, hp and dhn scratch, dWh partials and counters, B, T,
        # H, reverse, cluster, units, rows, dWh splits, stream
        "vmmt_gru_scan_bwd": [_I] + [_P] * 16 + [_I] * 8 + [_P],
        # dtype, H, cluster, units, rows, out: max active clusters, smem bytes
        "vmmt_gru_scan_bwd_occupancy": [_I] * 5 + [_P] * 2,
        # the wide plan (H > 512): dtype, x_proj, mask, reset, h0, wh, bh,
        # outs, final, exchange scratch, B, T, H, reverse, units, rows,
        # row_tiles, stream
        "vmmt_gru_wide": [_I] + [_P] * 9 + [_I] * 7 + [_P],
        # dtype, the backward's 16 pointers, exchange scratch, B, T, H,
        # reverse, units, rows, row_tiles, dWh splits, stream
        "vmmt_gru_wide_bwd": [_I] + [_P] * 17 + [_I] * 8 + [_P],
        # dtype, pass (0 forward, 1 backward), H, units, rows, out: max
        # co-resident CTAs, smem bytes
        "vmmt_gru_wide_occupancy": [_I] * 5 + [_P] * 2,
    },
    "decoder": {
        # dtype, emb_proj, dmid, h00, h01, wfeed, wh0, bh0, wmid, bmid, wh1,
        # bh1, keys, mem_v, wc_q, mask_bias, attn_hs, h0s, h1s, probs,
        # compute-dtype and f32 scratch, probe, B, T, S, H, units, rows,
        # grid, stream
        "vmmt_decoder_fwd": [_I] + [_P] * 22 + [_I] * 7 + [_P],
        # dtype, rows, S, H, units, out: max co-resident CTAs, smem bytes
        "vmmt_decoder_fwd_occupancy": [_I] * 5 + [_P] * 2,
        # dtype, the 14 forward inputs but mask_bias, attn_hs, h0s, h1s,
        # probs, d_attn, d_probs, dx0, dhp0, dx1, dhp1, pre, dscores, dh00,
        # dh01, gates, f32 and compute-dtype scratch, probe, B, T, S, H,
        # units, rows, grid, stream
        "vmmt_decoder_bwd": [_I] + [_P] * 32 + [_I] * 7 + [_P],
        # dtype, rows, S, H, units, out: max co-resident CTAs, smem bytes
        "vmmt_decoder_bwd_occupancy": [_I] * 5 + [_P] * 2,
    },
    "decode_step": {
        # dtype, emb_proj, h0, h1, feed, wfeed, wh0, bh0, wmid, bmid, wh1,
        # bh1, h0n, h1n, N, H, stream
        "vmmt_gru_chain": [_I] + [_P] * 13 + [_I] * 2 + [_P],
        # dtype, the 11 chain inputs, keys, mem_v, wc_q, mask_bias, h0n,
        # h1n, attn, probs, qw scratch, N, S, H, stream
        "vmmt_decode_step": [_I] + [_P] * 20 + [_I] * 3 + [_P],
        # dtype, out: CTAs of the GRU cell kernel an SM holds, smem bytes
        "vmmt_step_cell_occupancy": [_I] + [_P] * 2,
    },
}

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMEM_PER_BLOCK = 232_448  # dynamic shared memory one block may use on an H100 (227 KB)


def align16(n: int) -> int:
    return (n + 15) & ~15


def pad32(k: int) -> int:
    return (k + 31) & ~31


def frag_ld(k: int, bf16: bool) -> int:
    """Row stride of a weight slice that ``block_product`` reads from
    shared memory (``frag_ld`` of csrc/block_product.cuh): K padded to 32
    and, in bf16, to an odd multiple of 64 bytes for conflict-free 16-byte
    reads."""
    k = pad32(k)
    return k + (96 - k % 64) % 64 if bf16 else k


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))  # shared headers
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build() -> Dict[str, str]:
    """Compile every library that is missing, in parallel. Returns
    {name: nvcc's output (ptxas register and shared-memory report)}; an
    empty string for a library that was already built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SIGNATURES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {name: "" for name in SIGNATURES}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with argtypes
    and restype declared for every entry point."""
    path = _lib_path(name)
    if not path.exists():
        build()
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.vmmt_error_string.argtypes = [ctypes.c_int]
    lib.vmmt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.vmmt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


@functools.cache
def occupancy(device: int, name: str, fn: str, *args: int) -> Tuple[int, int]:
    """(how many CTAs or clusters the card holds at once, shared memory of
    one CTA in bytes): the C occupancy query ``fn`` of library ``name``, run
    on the current device (``device``, its index, keys the cache), with its
    int arguments ``args`` and two int outputs."""
    lib = library(name)
    count, smem = ctypes.c_int(0), ctypes.c_int(0)
    err = getattr(lib, fn)(*args, ctypes.addressof(count), ctypes.addressof(smem))
    check(lib, err, fn)
    return count.value, smem.value


@functools.cache
def sm_count(device: int) -> int:
    """The number of SMs of CUDA device ``device`` (its index)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels' vector
    loads need it); a view that starts elsewhere is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(what: str, device: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on ``device`` (a CUDA device)."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
