"""PyTorch port: the decoder sequence kernels (rows 5 and 6) at every batch
and every width, on the CPU.

- The plans both wrappers take (``decoder_launches``) at H = 500 to 4096
  (1002 padded to 1004), B = 1 to 4096, in the three dtypes, for 132 and
  114 SMs: the launches tile [0, B) in order, every (row, unit) is owned
  exactly once by the kernels' walk over the tiles, each CTA's shared
  memory fits, each grid is within the co-resident estimate; the
  flagship's shape keeps its resident plan; the streamed plan takes the
  widths the resident plan cannot.
- ``decoder_row_chunks`` (fault 3.5: JAX's wrappers split a batch into row
  chunks): the largest multiple of 16 rows that holds, in order; at H =
  500, S = 50 in bf16, B = 1024 the forward takes two chunks of 512 and
  the backward one launch.
- The wrappers' chunk loop (``in_row_chunks``) with the plain versions as
  the per-chunk call, against ``decoder_fwd_pallas`` and
  ``decoder_bwd_pallas`` with ``row_chunk=8`` in interpret mode, and the
  weight gradients of ``fused_decoder_pallas`` against JAX's
  ``fused_decoder_pallas(..., True, 8)``: f32, B = 24, tolerances of
  tests/test_torch_decoder.py.
- The streamed weights as the wrapper lays them out (``_stream_weights``)
  against the index formula of the kernels' slices.
- The wrappers launch once a chunk with each chunk's plan, and the streamed
  entry points' occupancy query for a streamed plan (meta tensors stand in
  for CUDA ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_decoder import DIFF_IDX, FWD_TOL, GRAD_TOL, dec_inputs
from variational_mmt_tpu.ops.pallas.decoder import (decoder_bwd_pallas, decoder_fwd_pallas,
                                                    fused_decoder_pallas as jax_fused_decoder)
from variational_mmt_torch import kernels
from variational_mmt_torch.ops import decoder
from variational_mmt_torch.ops.decode_step import padded_width

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
PASSES = ("decoder_fwd", "decoder_bwd")
WIDTHS = [500, 532, 600, 868, 1002, 1024, 2048, 4096]
BATCHES = [1, 61, 64, 256, 1024, 4096]
S = 24


def owned_once(B: int, H: int, launches) -> bool:
    """Whether the kernels' walk over each launch's tiles (CTA b takes tiles
    b, b + grid, ...; tile i owns units (i % unit_tiles) * units and rows
    (i // unit_tiles) * rows of its chunk) owns every (row, unit) of the
    batch at the padded width exactly once."""
    count = np.zeros((B, H), np.uint8)
    for b0, b1, plan in launches:
        units, rows, ut = plan["units"], plan["rows"], plan["unit_tiles"]
        tiles = ut * -(-(b1 - b0) // rows)
        for cta in range(plan["grid"]):
            for tile in range(cta, tiles, plan["grid"]):
                u0, r0 = (tile % ut) * units, b0 + (tile // ut) * rows
                count[r0:min(r0 + rows, b1), u0:min(u0 + units, H)] += 1
    return bool((count == 1).all())


def stream_smem(what: str, rows: int, H: int, dtype: torch.dtype) -> int:
    """A streamed CTA's shared memory counted by hand: the product buffer
    (4 n-tiles of 8 floats forward, 1 backward; 16-bit rows at least 128
    for the warps' K-split sums) and the attention row."""
    prod_rows = max(128, rows) if dtype != torch.float32 else rows
    if what == "decoder_fwd":
        return prod_rows * 4 * 8 * 4 + kernels.align16((3 * H + S) * 4)
    return prod_rows * 8 * 4 + kernels.align16((H + 2 * S) * 4)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("H", WIDTHS)
def test_every_batch_and_width_has_a_plan(H, B, dt, sms):
    Hp = padded_width(H)
    for what in PASSES:
        launches = decoder.decoder_launches(what, B, S, H, dt, sms)
        assert [b0 for b0, _, _ in launches] == [0] + [b1 for _, b1, _ in launches[:-1]]
        assert launches[-1][1] == B
        for b0, b1, plan in launches:
            assert plan["padded"] == Hp and plan["units"] == decoder.DEC_UNITS[dt]
            assert plan["rows"] % 16 == 0
            assert 0 < plan["smem"] <= kernels.SMEM_PER_BLOCK
            assert plan["grid"] <= decoder.co_resident_estimate(plan["smem"], sms)
            tiles = plan["unit_tiles"] * -(-(b1 - b0) // plan["rows"])
            if plan["layout"] == "resident":
                assert plan["grid"] >= tiles  # a CTA a tile
                assert plan == decoder._resident(what, b1 - b0, S, H, dt, sms)
            else:
                assert len(launches) == 1 and plan["tiles"] == tiles
                assert plan["rows"] <= decoder.DEC_STREAM_MAX_ROWS
                assert plan["grid"] <= decoder.DEC_STREAM_PER_SM * sms
                assert plan["smem"] == stream_smem(what, plan["rows"], Hp, dt)
        assert owned_once(B, Hp, launches), (what, [p for _, _, p in launches])


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_the_flagship_shape_keeps_its_resident_plan(dt):
    """B=64, S=24, H=500 on 132 SMs: one launch, today's plans (126 CTAs of
    32 rows in bf16 and f16, 125 of 64 in f32)."""
    grid, rows = (125, 64) if dt == torch.float32 else (126, 32)
    for what, plan_of in (("decoder_fwd", decoder.decoder_fwd_plan),
                          ("decoder_bwd", decoder.decoder_bwd_plan)):
        (b0, b1, plan), = decoder.decoder_launches(what, 64, 24, 500, dt, 132)
        assert (b0, b1) == (0, 64)
        assert plan == plan_of(64, 24, 500, dt, 132)
        assert (plan["layout"], plan["grid"], plan["rows"]) == ("resident", grid, rows)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_wide_decoders_take_the_streamed_plan(dt):
    """bf16 and f16 at H = 2048 stream both passes; f32's forward streams
    from H = 532, where its 133 unit tiles outgrow one CTA an SM."""
    for what in PASSES:
        (_, _, plan), = decoder.decoder_launches(what, 64, 24, 2048, dt, 132)
        assert plan["layout"] == "streamed"
    (_, _, plan), = decoder.decoder_launches("decoder_fwd", 64, 24, 532, torch.float32, 132)
    assert plan["layout"] == "streamed" and plan["unit_tiles"] == 133
    (_, _, plan), = decoder.decoder_launches("decoder_fwd", 64, 24, 528, torch.float32, 132)
    assert plan["layout"] == "resident"


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("what", PASSES)
@pytest.mark.parametrize("B,S_,H", [(1024, 50, 500), (4096, 24, 500), (4096, 50, 500),
                                    (256, 50, 600), (64, 24, 868), (1000, 32, 256),
                                    (3000, 24, 500)])
def test_row_chunks_tile_the_batch(what, B, S_, H, dt):
    """The chunks tile [0, B) in order; each holds the resident plan; all but
    the last take the largest multiple of 16 rows that holds (16 more do
    not), or the whole batch in one launch. Where not even 16 rows hold (f32's
    forward from H = 532: more unit tiles than one CTA an SM), it refuses,
    and the call takes the streamed plan."""
    if decoder._resident_plan(what, 16, S_, H, dt, 132) is None:
        with pytest.raises(NotImplementedError):
            decoder.decoder_row_chunks(what, B, S_, H, dt, 132)
        (_, _, plan), = decoder.decoder_launches(what, B, S_, H, dt, 132)
        assert plan["layout"] == "streamed"
        return
    chunks = decoder.decoder_row_chunks(what, B, S_, H, dt, 132)
    assert chunks[0].start == 0 and chunks[-1].stop == B
    assert all(a.stop == b.start for a, b in zip(chunks, chunks[1:]))
    rows = chunks[0].stop
    assert all(c.stop - c.start == rows for c in chunks[:-1])
    for c in chunks:
        assert decoder._resident_plan(what, c.stop - c.start, S_, H, dt, 132) is not None
    if len(chunks) > 1:
        assert rows % 16 == 0
        assert decoder._resident_plan(what, rows + 16, S_, H, dt, 132) is None


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16], ids=str)
def test_row_chunks_at_the_flagship_width_and_batch_1024(dt):
    """H = 500, S = 50: the forward holds 512 rows a launch (two chunks), the
    backward the whole batch."""
    assert decoder.decoder_row_chunks("decoder_fwd", 1024, 50, 500, dt, 132) == \
        [slice(0, 512), slice(512, 1024)]
    assert decoder.decoder_row_chunks("decoder_bwd", 1024, 50, 500, dt, 132) == [slice(0, 1024)]
    assert len(decoder.decoder_launches("decoder_fwd", 1024, 50, 500, dt, 132)) == 2


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_what_no_plan_holds_is_refused(dt):
    with pytest.raises(NotImplementedError):
        decoder.decoder_row_chunks("decoder_fwd", 64, 24, 2048, dt, 132)
    for what in PASSES:
        for B, S_, H in ((0, 24, 500), (64, 24, 0), (64, 60000, 2048)):
            with pytest.raises(NotImplementedError):
                decoder.decoder_launches(what, B, S_, H, dt, 132)


CHUNKS8 = [(0, 8, None), (8, 16, None), (16, 24, None)]  # JAX's row_chunk=8 at B=24


def chunked_fwd(*args):
    """The forward through the wrappers' chunk loop, 8 rows a chunk, the
    plain version as each chunk's call."""
    B, T, H3 = args[0].shape
    outs = [torch.empty(B, T, H3 // 3) for _ in range(3)] + \
        [torch.empty(B, T, args[11].shape[1])]

    def launch(plan, part, out):
        for o, r in zip(out, decoder.decoder_fwd_ref(*part)):
            o.copy_(r)

    decoder.in_row_chunks(launch, CHUNKS8, list(args), decoder.FWD_BATCHED, outs)
    return tuple(outs)


def chunked_bwd(*args):
    """The backward through the chunk loop, 8 rows a chunk, plain calls."""
    B, T, H3 = args[0].shape
    H, S_ = H3 // 3, args[11].shape[1]
    outs = [torch.empty(B, T, H3) for _ in range(4)] + [torch.empty(B, T, H),
                                                        torch.empty(B, T, S_),
                                                        torch.empty(B, H), torch.empty(B, H)]

    def launch(plan, part, out):
        for o, r in zip(out, decoder.decoder_bwd_ref(*part)):
            o.copy_(r)

    decoder.in_row_chunks(launch, CHUNKS8, list(args), decoder.BWD_BATCHED, outs)
    return tuple(outs)


def test_chunk_loop_forward_matches_jax_row_chunks():
    args = dec_inputs(seed=7, B=24, dropout=True)
    want = decoder_fwd_pallas(*map(jnp.asarray, args), interpret=True, row_chunk=8)
    got = chunked_fwd(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL)


def test_chunk_loop_backward_matches_jax_row_chunks():
    args = dec_inputs(seed=8, B=24, dropout=True)
    streams = decoder_fwd_pallas(*map(jnp.asarray, args), interpret=True, row_chunk=8)
    rng = np.random.default_rng(9)
    B, T, H, S_ = 24, 5, 8, 4
    d_attn = rng.standard_normal((B, T, H)).astype(np.float32)
    d_probs = rng.standard_normal((B, T, S_)).astype(np.float32)
    want = decoder_bwd_pallas(*map(jnp.asarray, args[:14]), *streams, jnp.asarray(d_attn),
                              jnp.asarray(d_probs), interpret=True, row_chunk=8)
    got = chunked_bwd(*map(torch.from_numpy, args[:14]),
                      *(torch.from_numpy(np.array(s)) for s in streams),
                      torch.from_numpy(d_attn), torch.from_numpy(d_probs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL)


def test_chunked_weight_gradients_match_jax(monkeypatch):
    """``fused_decoder_pallas`` with both passes run in chunks of 8 rows:
    every gradient (the weights' summed over the whole batch after the
    chunked backward) against jax.grad through JAX's chunked custom VJP."""
    monkeypatch.setattr(decoder, "decoder_fwd", chunked_fwd)
    monkeypatch.setattr(decoder, "decoder_bwd", chunked_bwd)
    args = dec_inputs(seed=10, B=24, dropout=True)
    B, T, H, S_ = 24, 5, 8, 4
    rng = np.random.default_rng(11)
    ga = (rng.standard_normal((B, T, H)) * 0.1).astype(np.float32)
    gp = (rng.standard_normal((B, T, S_)) * 0.1).astype(np.float32)

    def obj(*dargs):
        full = [jnp.asarray(a) for a in args]
        for i, a in zip(DIFF_IDX, dargs):
            full[i] = a
        attn, probs = jax_fused_decoder(*full, True, 8)
        return (attn * ga).sum() + (probs * gp).sum()

    want = jax.grad(obj, argnums=tuple(range(len(DIFF_IDX))))(
        *(jnp.asarray(args[i]) for i in DIFF_IDX))
    t = [torch.from_numpy(a) for a in args]
    for i in DIFF_IDX:
        t[i].requires_grad_(True)
    attn, probs = decoder.fused_decoder_pallas(*t)
    ((attn * torch.from_numpy(ga)).sum() + (probs * torch.from_numpy(gp)).sum()).backward()
    for i, w in zip(DIFF_IDX, want):
        np.testing.assert_allclose(t[i].grad.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"gradient of argument {i}")


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("H", [12, 20])
def test_stream_weights_follow_the_slice_formula(H, dt):
    g = torch.Generator().manual_seed(H)
    W = [torch.randn(H, 3 * H, generator=g).to(dt) for _ in range(4)]  # Wfeed Wh0 Wmid Wh1
    Wc_q = torch.randn(H, H, generator=g).to(dt)
    mma = kernels.mma_dtype(dt)
    units = decoder.DEC_UNITS[dt]
    ut = -(-H // units)
    plan = dict(units=units, unit_tiles=ut)
    fwd = decoder._stream_weights("decoder_fwd", *W[:4], Wc_q, plan)
    ld = kernels.frag_ld(H, mma)
    assert fwd.shape == (ut, 13, units, ld) and fwd.dtype == dt
    want = torch.zeros(ut, 13, units, ld, dtype=dt)
    for tile in range(ut):
        for u in range(units):
            j = tile * units + u
            if j >= H:
                continue
            for w in range(4):
                for gate in range(3):
                    want[tile, 3 * w + gate, u, :H] = W[w][:, gate * H + j]
            want[tile, 12, u, :H] = Wc_q[:, j]
    assert torch.equal(fwd, want)
    bwd = decoder._stream_weights("decoder_bwd", *W[:4], Wc_q, plan)
    ld1, ld3 = kernels.frag_ld(H, mma), kernels.frag_ld(3 * H, mma)
    assert bwd.shape == (ut, units * (ld1 + 4 * ld3))
    want = torch.zeros(ut, units * (ld1 + 4 * ld3), dtype=dt)
    for tile in range(ut):
        for u in range(units):
            j = tile * units + u
            if j >= H:
                continue
            want[tile, u * ld1:u * ld1 + H] = Wc_q[j]
            for k, w in enumerate((3, 2, 1, 0)):  # Wh1, Wmid, Wh0, Wfeed
                at = units * ld1 + k * units * ld3 + u * ld3
                want[tile, at:at + 3 * H] = W[w][j]
    assert torch.equal(bwd, want)


def meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


def seq_args(B, T, S_, H, dt):
    c = lambda *shape: meta(*shape, dtype=dt)  # noqa: E731
    w = c(H, 3 * H)
    return (c(B, T, 3 * H), c(B, T, H), meta(B, H), meta(B, H), w, w, meta(3 * H), w,
            meta(3 * H), w, meta(3 * H), c(B, S_, H), c(B, S_, H), c(H, H))


@pytest.fixture
def card(monkeypatch):
    """A card of 132 SMs that holds what the plans estimate; the entry points
    record their calls: (fn, B, units, rows, grid), and the occupancy
    queries asked."""
    calls, queried = [], []

    class Lib:
        def __getattr__(self, fn):
            return lambda *a: calls.append((fn, a[-8], *a[-4:-1])) or 0

    def occupancy(device, lib, fn, code, rows, S_, H, units):
        queried.append(fn)
        dt = [d for d, c in kernels.DTYPE_CODE.items() if c == code][0]
        what = "decoder_" + fn.split("_")[2]  # vmmt_decoder_{fwd,bwd}[_stream]_occupancy
        smem = decoder._SMEM[what](rows, S_, H, dt, streamed="stream" in fn)
        return decoder.co_resident_estimate(smem, 132), smem

    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "occupancy", occupancy)
    return calls, queried


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16], ids=str)
def test_wrappers_launch_once_a_chunk(card, dt):
    """B = 1024, S = 50, H = 500: the forward launches twice, 512 rows each
    with the chunk's plan, and keeps the chunk count and both plans; the
    backward launches once; every launch is counted."""
    calls, _ = card
    args = seq_args(1024, 25, 50, 500, dt)
    before = decoder.decoder_fwd.launches, decoder.decoder_bwd.launches
    decoder.decoder_fwd(*args, meta(1024, 50))
    plan = decoder.decoder_fwd_plan(512, 50, 500, dt, 132)
    assert calls == [("vmmt_decoder_fwd", 512, plan["units"], plan["rows"], plan["grid"])] * 2
    kept = decoder.decoder_fwd.plan
    assert kept["chunks"] == 2 and len(kept["launch_plans"]) == 2
    assert all(p["layout"] == "resident" and p["rows"] == plan["rows"]
               for p in kept["launch_plans"])
    calls.clear()
    decoder.decoder_bwd(*args, meta(1024, 25, 500, dtype=dt), meta(1024, 25, 500, dtype=dt),
                        meta(1024, 25, 500, dtype=dt), meta(1024, 25, 50, dtype=dt),
                        meta(1024, 25, 500), meta(1024, 25, 50))
    assert [c[:2] for c in calls] == [("vmmt_decoder_bwd", 1024)]
    assert decoder.decoder_bwd.plan["chunks"] == 1
    assert (decoder.decoder_fwd.launches, decoder.decoder_bwd.launches) == \
        (before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_wrappers_take_the_streamed_plan_at_2048(card, dt):
    calls, queried = card
    args = seq_args(64, 25, 24, 2048, dt)
    decoder.decoder_fwd(*args, meta(64, 24))
    decoder.decoder_bwd(*args, meta(64, 25, 2048, dtype=dt), meta(64, 25, 2048, dtype=dt),
                        meta(64, 25, 2048, dtype=dt), meta(64, 25, 24, dtype=dt),
                        meta(64, 25, 2048), meta(64, 25, 24))
    assert queried == ["vmmt_decoder_fwd_stream_occupancy", "vmmt_decoder_bwd_stream_occupancy"]
    for fn, plan in (("vmmt_decoder_fwd", decoder.decoder_fwd.plan),
                     ("vmmt_decoder_bwd", decoder.decoder_bwd.plan)):
        assert plan["layout"] == "streamed"
        assert (fn, 64, plan["units"], plan["rows"], plan["grid"]) in calls
