"""Fused beam-decode step and GRU chain: the CUDA kernels' wrappers and
their plain versions.

Mirrors ``variational_mmt_tpu/ops/pallas/decode_step.py``
(``decode_step_pallas`` and ``gru_chain_pallas``, same argument order).

Source note. Replaces the Pallas kernels ``_step_kernel``
(decode_step.py:49, ``pallas_call`` at :176) and ``_chain_kernel``
(:85, ``pallas_call`` at :118) with ``csrc/decode_step.cu``. On the H100 a
step at N=1024 rows, S=24, H=500 in bf16 moves about 65 MB, mostly keys
and mem_v, and does 7.2 GFLOP: bytes bound it at about 19 us. The chain
needs every column of h0' before GRU1 and all of h1' before attention,
which a block-parallel grid cannot give without a grid-wide sync, so one
call launches a short sequence of kernels on the stream: the GRU0 cell and
the GRU1 cell (one tensor-core kernel: a CTA owns 64 rows x 32 hidden
units and forms both of the cell's products for the three gate column
blocks of its units, operands staged by cp.async and double-buffered along
K, gates in the epilogue; FMAs, never TF32, in f32),
then ``h1' @ Wc_q`` (the same kernel with one product) and one attention
block per row reading keys as 16-byte vectors. What is left bounding it is
the cells' L2 traffic and one pass over keys and mem_v. The chain (row 4)
is the first two of those launches. :func:`step_cell_plan` gives the
cells' tile grid and shared memory; the TPU's row chunking
(``_rows_per_chunk``, a VMEM budget) is not carried over.

Widths. The kernels copy 4 values at a time, so they compute a width H
that is a multiple of 4; the wrappers take any H and zero-pad it up to
:func:`padded_width` (the weights' hidden rows and gate columns, the
biases, the states, keys and mem_v), then slice the outputs back. This is
exact: a padded unit starts at 0, and with zero weights and biases its
gates are r = z = 1/2 and n = tanh(0) = 0, so h' = z * h = 0 at every
step; zero key and value columns leave every score and context as they
were. Weights, keys and mem_v that come padded already (``GRUDecoder``
pads them once a request, :func:`pad_step_weights`) are taken as they are.
"""

from __future__ import annotations

from typing import Tuple

import torch

from variational_mmt_torch import kernels
from variational_mmt_torch.models.gru import gru_gates

f32 = torch.float32


def rounded_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to w's dtype, product accumulated in f32 (the Pallas
    ``jnp.dot(a.astype(cdt), w, preferred_element_type=f32)``)."""
    return a.to(w.dtype).float() @ w.float()


def _chain_f32(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1):
    """GRU0 -> GRU1 with f32 state; returns (h0n, h1n) in f32."""
    h0f, h1f = h0.float(), h1.float()
    x0 = emb_proj.float() + rounded_dot(feed.float(), Wfeed)
    h0n = gru_gates(x0, rounded_dot(h0f, Wh0) + bh0.float(), h0f)
    x1 = rounded_dot(h0n, Wmid) + bmid.float()
    h1n = gru_gates(x1, rounded_dot(h1f, Wh1) + bh1.float(), h1f)
    return h0n, h1n


def gru_chain_ref(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1):
    """Plain version of the GRU chain. Returns (h0n, h1n) in the carry dtypes."""
    h0n, h1n = _chain_f32(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1)
    return h0n.to(h0.dtype), h1n.to(h1.dtype)


def decode_step_ref(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1,
                    keys, mem_v, Wc_q, mask_bias):
    """Plain version of the fused step, as the Pallas body computes it.
    Returns (h0n, h1n, attn, probs): carries in their input dtypes, probs in
    keys.dtype."""
    cdt = Wfeed.dtype
    h0n_f, h1n_f = _chain_f32(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1)
    h0n, h1n = h0n_f.to(h0.dtype), h1n_f.to(h1.dtype)
    scores = (h1n_f[:, None, :].to(cdt) * keys).sum(-1, dtype=f32)
    scores = scores + mask_bias.float()
    scores = scores - scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores)
    probs = e / e.sum(dim=-1, keepdim=True)
    ctx = (probs[:, :, None].to(cdt) * mem_v).sum(1, dtype=f32)
    attn = torch.tanh(ctx + rounded_dot(h1n_f, Wc_q))
    return h0n, h1n, attn.to(feed.dtype), probs.to(keys.dtype)


CELL_ROWS = 64  # rows of a cell CTA's tile (kCellRows of csrc/decode_step.cu)
CELL_UNITS = 32  # hidden units of a cell CTA's tile (kCellUnits)
CELL_BK = 32  # reduction chunk (kCellBK)
CELL_VEC = 4  # values per cp.async copy (kCellVec): the kernels' H is a multiple
CELL_THREADS = 256


def padded_width(H: int) -> int:
    """H rounded up to a multiple of 4, the width the step, chain and
    decoder sequence kernels compute (their copies are 4 values wide)."""
    return -(-H // CELL_VEC) * CELL_VEC


def pad_units(t: torch.Tensor, H: int, Hp: int, dim: int = -1, gates: int = 1) -> torch.Tensor:
    """``t`` with its ``dim`` (``gates`` blocks of H, [r|z|n] for 3)
    zero-padded to ``gates`` blocks of Hp, each block padded at its end."""
    if Hp == H:
        return t
    dim %= t.dim()
    blocks = t.unflatten(dim, (gates, H))
    zeros = blocks.new_zeros(blocks.shape[:dim + 1] + (Hp - H,) + blocks.shape[dim + 2:])
    return torch.cat([blocks, zeros], dim=dim + 1).flatten(dim, dim + 1)


def unpad_units(t: torch.Tensor, H: int, Hp: int, dim: int = -1, gates: int = 1) -> torch.Tensor:
    """The inverse of :func:`pad_units`: each block of Hp cut back to H."""
    if Hp == H:
        return t
    dim %= t.dim()
    return t.unflatten(dim, (gates, Hp)).narrow(dim + 1, 0, H).flatten(dim, dim + 1)


def pad_step_weights(Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1, Wc_q=None) -> tuple:
    """The decoder's (H,3H) weights, (3H,) biases and (H,H) ``Wc_q``
    zero-padded to :func:`padded_width` (hidden rows, gate columns); the
    same tensors where H is a multiple of 4."""
    H = Wfeed.shape[0]
    Hp = padded_width(H)
    w = lambda t: pad_units(pad_units(t, H, Hp, 0), H, Hp, -1, 3)  # noqa: E731
    b = lambda t: pad_units(t, H, Hp, -1, 3)  # noqa: E731
    out = (w(Wfeed), w(Wh0), b(bh0), w(Wmid), b(bmid), w(Wh1), b(bh1))
    if Wc_q is not None:
        out += (pad_units(pad_units(Wc_q, H, Hp, 0), H, Hp, -1),)
    return out


def _pad_chain(chain) -> tuple:
    """The chain inputs (emb_proj, h0, h1, feed and the seven weights) at
    the kernels' width; the weights as given where they come padded."""
    emb_proj, h0, h1, feed, *w = chain
    H = h0.shape[-1]
    Hp = padded_width(H)
    if Hp == H:
        return tuple(chain)
    if w[0].shape[0] != Hp:
        w = pad_step_weights(*w)
    return (pad_units(emb_proj, H, Hp, -1, 3), pad_units(h0, H, Hp), pad_units(h1, H, Hp),
            pad_units(feed, H, Hp), *w)


def step_cell_plan(N: int, H: int, dtype: torch.dtype) -> dict:
    """Launch plan of the GRU cell kernel that the decode step and the chain
    launch twice (and the step once more for ``h1' @ Wc_q``), for N rows
    and H units, planned at the padded width ``padded`` (the wrappers pad H
    to a multiple of 4): a grid of ``grid`` (unit tiles, row tiles) CTAs of
    64 rows x 32 units, with ``smem`` bytes of dynamic shared memory per CTA
    (mirrors ``CellSmem`` of csrc/decode_step.cu: two stages of K chunks of
    the two row operands (64, 32) and the two weights' (32, 96) column
    blocks, rows padded to 40 and 104 halves in bf16 and f16, 36 and 100
    floats in f32; then the epilogue's tile of xbase (64, 96) and h (64, 32) and two
    bias rows of 96 floats). Raises NotImplementedError for H < 1."""
    kernels.dtype_code("decode_step", dtype)
    if H < 1:
        raise NotImplementedError(f"decode_step kernel: hidden {H}")
    H = padded_width(H)
    mma = kernels.mma_dtype(dtype)
    rows = CELL_ROWS
    lda, ldw = (CELL_BK + 8, 3 * CELL_UNITS + 8) if mma else (CELL_BK + 4, 3 * CELL_UNITS + 4)
    stages, tsize, cols = 2, dtype.itemsize, 3 * CELL_UNITS
    smem = (stages * (2 * rows * lda + 2 * CELL_BK * ldw) * tsize
            + rows * (cols + CELL_UNITS) * tsize + 2 * cols * 4)
    grid = (-(-H // CELL_UNITS), -(-N // rows))
    return dict(rows=rows, units=CELL_UNITS, padded=H, grid=grid, ctas=grid[0] * grid[1],
                threads=CELL_THREADS, stages=stages, smem=smem, k_chunks=-(-H // CELL_BK))


def _checked_plan(N: int, H: int, dt: torch.dtype, device: int) -> dict:
    """The cells' plan, checked against the kernel's own shared-memory
    count, with the card's count of co-resident CTAs."""
    plan = step_cell_plan(N, H, dt)
    per_sm, smem = kernels.occupancy(device, "decode_step", "vmmt_step_cell_occupancy",
                                     kernels.DTYPE_CODE[dt])
    if smem != plan["smem"]:
        raise RuntimeError(f"decode_step kernel: plan of {plan['smem']} bytes of shared "
                           f"memory, the kernel takes {smem}")
    if per_sm < 1:
        raise NotImplementedError(f"decode_step kernel: a CTA with {smem} bytes of shared "
                                  "memory does not fit an SM")
    return dict(plan, ctas_per_sm=per_sm,
                one_wave=per_sm * kernels.sm_count(device) >= plan["ctas"])


_CHAIN_NAMES = ("emb_proj", "h0", "h1", "feed", "Wfeed", "Wh0", "bh0", "Wmid", "bmid", "Wh1",
                "bh1")


def _chain_args(what, *chain):
    """Validate the chain inputs (emb_proj, h0, h1, feed, Wfeed, Wh0, bh0,
    Wmid, bmid, Wh1, bh1) for the kernel; returns them contiguous and
    16-byte aligned, biases as f32, with N, H and the compute dtype."""
    emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1 = chain
    N, H3 = emb_proj.shape
    H = H3 // 3
    dt = Wfeed.dtype
    kernels.dtype_code(what, dt)
    for i in (0, 1, 2, 3, 5, 7, 9):
        if chain[i].dtype != dt:
            raise TypeError(f"{what} kernel: {_CHAIN_NAMES[i]} is {chain[i].dtype}; every "
                            f"tensor but the biases must be {dt}")
    w, b = (H, H3), (H3,)
    for name, t, want in zip(_CHAIN_NAMES, chain,
                             ((N, H3), (N, H), (N, H), (N, H), w, w, b, w, b, w, b)):
        if t.shape != want:
            raise ValueError(f"{what} kernel: {name} {tuple(t.shape)} != {want}")
    step_cell_plan(N, H, dt)  # refuses a shape before anything is touched
    dev = emb_proj.device
    for name, t in zip(_CHAIN_NAMES[1:], chain[1:]):
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {dev}")
    args = [kernels.aligned(t) if i not in (6, 8, 10) else t.to(f32).contiguous()
            for i, t in enumerate(chain)]
    return args, N, H, dt


def gru_chain(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused 2-layer input-feed GRU chain for one decode step (attention
    outside). Returns (h0n, h1n). CPU tensors take the plain version; CUDA
    tensors launch the kernel at the padded width (the weights may come
    padded, :func:`pad_step_weights`; the cells' plan of the last launch is
    kept in ``gru_chain.plan``)."""
    if emb_proj.device.type == "cpu":
        return gru_chain_ref(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1)
    H0 = h0.shape[-1]
    args, N, H, dt = _chain_args("gru_chain", *_pad_chain(
        (emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1)))
    lib = kernels.library("decode_step")
    gru_chain.plan = _checked_plan(N, H, dt, emb_proj.device.index)
    h0n = torch.empty_like(args[1])
    h1n = torch.empty_like(args[2])
    err = lib.vmmt_gru_chain(kernels.DTYPE_CODE[dt], *(a.data_ptr() for a in args),
                             h0n.data_ptr(), h1n.data_ptr(), N, H,
                             kernels.stream_of(h0n))
    kernels.check(lib, err, "gru_chain")
    gru_chain.launches += 1
    return unpad_units(h0n, H0, H), unpad_units(h1n, H0, H)


def decode_step(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1,
                keys, mem_v, Wc_q, mask_bias):
    """One fused decode step over N rows: emb_proj (N,3H); h0, h1, feed
    (N,H); four (H,3H) weights; keys, mem_v (N,S,H); Wc_q (H,H); mask_bias
    (N,S) (0 real, -1e9 pad). Returns (h0n, h1n, attn, probs). CPU tensors
    take the plain version; CUDA tensors launch the kernels at the padded
    width (weights, keys and mem_v may come padded; the cells' plan of the
    last launch is kept in ``decode_step.plan``)."""
    if emb_proj.device.type == "cpu":
        return decode_step_ref(emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1,
                               bh1, keys, mem_v, Wc_q, mask_bias)
    H0 = h0.shape[-1]
    Hp = padded_width(H0)
    args, N, H, dt = _chain_args("decode_step", *_pad_chain(
        (emb_proj, h0, h1, feed, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1)))
    if keys.shape[-1] != Hp:
        keys, mem_v = pad_units(keys, H0, Hp), pad_units(mem_v, H0, Hp)
    if Wc_q.shape[0] != Hp:
        Wc_q = pad_units(pad_units(Wc_q, H0, Hp, 0), H0, Hp)
    S = keys.shape[1]
    for name, t in dict(keys=keys, mem_v=mem_v, Wc_q=Wc_q).items():
        if t.dtype != dt:
            raise TypeError(f"decode_step kernel: {name} is {t.dtype}, expected {dt}")
    if tuple(keys.shape) != (N, S, H) or tuple(mem_v.shape) != (N, S, H) \
            or tuple(Wc_q.shape) != (H, H) or tuple(mask_bias.shape) != (N, S):
        raise ValueError("decode_step kernel: keys/mem_v (N,S,H), Wc_q (H,H) and "
                         "mask_bias (N,S) do not match")
    kernels.require_cuda("decode_step", emb_proj.device, keys=keys, mem_v=mem_v, Wc_q=Wc_q,
                         mask_bias=mask_bias)
    lib = kernels.library("decode_step")
    decode_step.plan = _checked_plan(N, H, dt, emb_proj.device.index)
    extra = [kernels.aligned(keys), kernels.aligned(mem_v), kernels.aligned(Wc_q),
             mask_bias.to(f32).contiguous()]
    h0n = torch.empty_like(args[1])
    h1n = torch.empty_like(args[2])
    attn = torch.empty_like(args[3])
    probs = torch.empty((N, S), dtype=dt, device=h0n.device)
    qw = torch.empty((N, H), dtype=f32, device=h0n.device)
    err = lib.vmmt_decode_step(kernels.DTYPE_CODE[dt], *(a.data_ptr() for a in args + extra),
                               h0n.data_ptr(), h1n.data_ptr(), attn.data_ptr(),
                               probs.data_ptr(), qw.data_ptr(), N, S, H,
                               kernels.stream_of(h0n))
    kernels.check(lib, err, "decode_step")
    decode_step.launches += 1
    return (unpad_units(h0n, H0, H), unpad_units(h1n, H0, H), unpad_units(attn, H0, H),
            probs)


gru_chain.launches = 0
decode_step.launches = 0
gru_chain.plan = None
decode_step.plan = None
