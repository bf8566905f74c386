"""PyTorch port: each CUDA kernel against its plain version on the card, at
small ragged shapes (hidden sizes and row counts that do not fill a tile,
more source positions than a warp). Marked ``cuda``; skipped without a
card. On a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: forward outputs in [-1, 1], float32 1e-4 absolute (summation
order only), bfloat16 2e-2 absolute (rounding to bf16), float16 held to
bfloat16's 2e-2. Gradients are not bounded, so the backward kernels are
held to max|kernel - plain| / max|plain| per tensor: 1e-4 in float32, 2e-2
in bfloat16 and float16. An unknown dtype code returns an error from every
C entry point."""

import math

import pytest
import torch

from variational_mmt_torch import kernels
from variational_mmt_torch.ops import decode_step as ds
from variational_mmt_torch.ops import decoder, gru_scan

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def close(got, want, dt):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert float((g.float() - w.float()).abs().max()) <= TOL[dt]


def scan_args(g, dt, B, T, H):
    """Inputs of the scan with ragged lengths, row 2 all padding."""
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    lengths = torch.randint(1, T + 1, (B,), generator=g, device="cuda")
    lengths[min(2, B - 1)] = 0
    mask = (torch.arange(T, device="cuda")[None] < lengths[:, None]).float()
    return (r(B, T, 3 * H).to(dt), mask, 0.1 * r(B, H), (r(H, 3 * H) / math.sqrt(H)).to(dt),
            0.1 * r(3 * H))


# B=61 fills no group of 4 rows (one row all padding); T=1 is a single
# step; B=140 takes clusters of 8 rows, more than one wave of 4-row
# clusters; H=250 is the encoder's width (8 CTAs a cluster); B=64, T=32,
# H=128 is the quality gate's encoder (hidden 256, 4 CTAs a cluster)
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,T,H", [(9, 7, 40), (61, 7, 250), (9, 1, 40), (140, 5, 250),
                                   (5, 24, 96), (64, 32, 128)],
                         ids=["small", "ragged", "T1", "B140", "H96", "gate"])
def test_gru_scan_kernel(cuda, dt, reverse, B, T, H):
    args = scan_args(cuda, dt, B, T, H)
    close(gru_scan.gru_layer_scan(*args, reverse), gru_scan.gru_layer_scan_ref(*args, reverse), dt)
    plan = gru_scan.gru_layer_scan.plan
    want = gru_scan.scan_fwd_plan(B, T, H, dt, kernels.sm_count(0))
    if want["layout"] == "tiled":  # the cluster plan would run in waves (f32 at B = 61, 140)
        assert plan == dict(want, max_co_resident=plan["max_co_resident"])
        return
    # the rule takes the cluster plan where the card holds its clusters at once
    assert plan == dict(want, max_active_clusters=plan["max_active_clusters"], one_wave=True)
    assert plan["max_active_clusters"] >= plan["clusters"]


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_gru_scan_kernel_is_deterministic(cuda, dt):
    args = scan_args(cuda, dt, 61, 7, 250)
    first = gru_scan.gru_layer_scan(*args, True)
    second = gru_scan.gru_layer_scan(*args, True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def close_rel(got, want, dt):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = max(float(w.float().abs().max()), 1e-30)
        assert float((g.float() - w.float()).abs().max()) / scale <= TOL[dt]


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_bwd_kernel(cuda, dt, reverse):
    B, T, H = 9, 7, 40
    r = lambda *s: torch.randn(*s, generator=cuda, device="cuda")  # noqa: E731
    lengths = torch.tensor([7, 1, 3, 7, 5, 2, 6, 4, 7], device="cuda")
    mask = (torch.arange(T, device="cuda")[None] < lengths[:, None]).float()
    args = (r(B, T, 3 * H).to(dt), mask, 0.1 * r(B, H), (r(H, 3 * H) / math.sqrt(H)).to(dt),
            0.1 * r(3 * H))
    outs, _ = gru_scan.gru_layer_scan_ref(*args, reverse)
    g = r(B, T, H)
    close_rel(gru_scan.gru_layer_scan_bwd(*args, outs, g, reverse),
              gru_scan.gru_layer_scan_bwd_ref(*args, outs, g, reverse), dt)


# B=61 fills no group of 4 rows or tile of 16; T=1 is a single step; H=250
# is the encoder's width (8 CTAs a cluster); the quality gate's encoder
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,T,H", [(61, 7, 40), (9, 1, 40), (6, 5, 250), (64, 32, 128)],
                         ids=["ragged", "T1", "H250", "gate"])
def test_gru_scan_bwd_kernel_shapes(cuda, dt, reverse, B, T, H):
    args = scan_args(cuda, dt, B, T, H)
    outs, _ = gru_scan.gru_layer_scan_ref(*args, reverse)
    g = torch.randn(B, T, H, generator=cuda, device="cuda")
    close_rel(gru_scan.gru_layer_scan_bwd(*args, outs, g, reverse),
              gru_scan.gru_layer_scan_bwd_ref(*args, outs, g, reverse), dt)


def reset_stream(g, mask):
    """Resets at every row's t=0, at a random step of each row and on a
    masked step of the last row (sequence packing's segment starts)."""
    B, T = mask.shape
    reset = torch.zeros(B, T, device="cuda")
    reset[:, 0] = 1.0
    reset[torch.arange(B, device="cuda"),
          torch.randint(0, T, (B,), generator=g, device="cuda")] = 1.0
    reset[-1, -1] = 1.0
    mask[-1, -1] = 0.0
    return reset


# the reset stream of both kernels (sequence packing) against the plain
# versions, at the shapes of the reset-free tests above
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,T,H", [(9, 7, 40), (61, 7, 250), (9, 1, 40), (140, 5, 250)],
                         ids=["small", "ragged", "T1", "B140"])
def test_gru_scan_kernels_with_reset(cuda, dt, reverse, B, T, H):
    args = scan_args(cuda, dt, B, T, H)
    reset = reset_stream(cuda, args[1])
    fwd = gru_scan.gru_layer_scan.reset_launches, gru_scan.gru_layer_scan_bwd.reset_launches
    close(gru_scan.gru_layer_scan(*args, reverse, reset),
          gru_scan.gru_layer_scan_ref(*args, reverse, reset), dt)
    outs, _ = gru_scan.gru_layer_scan_ref(*args, reverse, reset)
    g = torch.randn(B, T, H, generator=cuda, device="cuda")
    close_rel(gru_scan.gru_layer_scan_bwd(*args, outs, g, reverse, reset),
              gru_scan.gru_layer_scan_bwd_ref(*args, outs, g, reverse, reset), dt)
    assert (gru_scan.gru_layer_scan.reset_launches,
            gru_scan.gru_layer_scan_bwd.reset_launches) == (fwd[0] + 1, fwd[1] + 1)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_gru_scan_kernels_with_reset_are_deterministic(cuda, dt):
    args = scan_args(cuda, dt, 61, 7, 250)
    reset = reset_stream(cuda, args[1])
    first = gru_scan.gru_layer_scan(*args, True, reset)
    second = gru_scan.gru_layer_scan(*args, True, reset)
    g = torch.randn(61, 7, 250, generator=cuda, device="cuda")
    first_b = gru_scan.gru_layer_scan_bwd(*args, first[0], g, True, reset)
    assert gru_scan.gru_layer_scan_bwd.plan["engine"] == \
        ("tile" if dt == torch.float32 else "wgmma")
    second_b = gru_scan.gru_layer_scan_bwd(*args, first[0], g, True, reset)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first + first_b, second + second_b))


def decoder_args(g, dt, B=9, T=6, S=40, H=72, mem_std=0.5):
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    w = lambda *s: (r(*s) / math.sqrt(H)).to(dt)  # noqa: E731
    dmid = ((torch.rand(B, T, H, generator=g, device="cuda") > 0.3).float() / 0.7).to(dt)
    lengths = torch.randint(1, S + 1, (B,), generator=g, device="cuda")
    mask_bias = (torch.arange(S, device="cuda")[None] >= lengths[:, None]).float() * -1e9
    return (r(B, T, 3 * H).to(dt), dmid, torch.tanh(r(B, H)), torch.tanh(r(B, H)),
            w(H, 3 * H), w(H, 3 * H), 0.1 * r(3 * H), w(H, 3 * H), 0.1 * r(3 * H),
            w(H, 3 * H), 0.1 * r(3 * H), (mem_std * r(B, S, H)).to(dt),
            (mem_std * r(B, S, H)).to(dt), w(H, H), mask_bias)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_decoder_fwd_kernel(cuda, dt):
    args = decoder_args(cuda, dt)
    close(decoder.decoder_fwd(*args), decoder.decoder_fwd_ref(*args), dt)


# B=61 fills no row tile of 16; S=13 is not a multiple of 8 (nor of the
# 4 values a lane loads); T=1 is a single step; B=140 gives some CTAs two
# attention rows; row 2's source has one real position
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B,T,S", [(61, 6, 13), (9, 1, 40), (140, 3, 40)],
                         ids=["ragged", "T1", "B140"])
def test_decoder_fwd_kernel_shapes(cuda, dt, B, T, S):
    args = decoder_args(cuda, dt, B=B, T=T, S=S)
    args[14][2, 1:] = -1e9
    close(decoder.decoder_fwd(*args), decoder.decoder_fwd_ref(*args), dt)
    plan = decoder.decoder_fwd.plan
    assert plan["grid"] == max(plan["unit_tiles"] * plan["row_tiles"], min(B, plan["sms"]))


# the quality gate's decoder: hidden 256, targets of 33 (bucket 32 + 1),
# sources of 32; attention memory std 0.1, as chip_smoke.py holds 2e-2 over
# a long sequence (bf16 evaluations of a peaked softmax drift apart)
@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_decoder_kernels_at_the_gate_shape(cuda, dt):
    args = decoder_args(cuda, dt, B=64, T=33, S=32, H=256, mem_std=0.1)
    close(decoder.decoder_fwd(*args), decoder.decoder_fwd_ref(*args), dt)
    streams = decoder.decoder_fwd_ref(*args)
    d_attn = torch.randn(streams[0].shape, generator=cuda, device="cuda")
    d_probs = torch.randn(streams[3].shape, generator=cuda, device="cuda")
    close_rel(decoder.decoder_bwd(*args[:14], *streams, d_attn, d_probs),
              decoder.decoder_bwd_ref(*args[:14], *streams, d_attn, d_probs), dt)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_decoder_fwd_kernel_is_deterministic(cuda, dt):
    args = decoder_args(cuda, dt, B=61, T=6)
    first, second = decoder.decoder_fwd(*args), decoder.decoder_fwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_decoder_fwd_takes_unaligned_views(cuda):
    """Keys and mem_v that start off a 16-byte boundary (views one element
    into their storage) give the same result as aligned copies."""
    args = list(decoder_args(cuda, torch.bfloat16, B=9, T=4))

    def shifted(t):
        flat = t.flatten()
        v = torch.cat([flat[:1], flat])[1:].view(t.shape)
        assert v.data_ptr() % 16 != 0 and torch.equal(v, t)
        return v

    want = decoder.decoder_fwd(*args)
    args[11], args[12] = shifted(args[11]), shifted(args[12])
    got = decoder.decoder_fwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_decoder_probes_stamp_every_phase(cuda):
    """Both persistent kernels fill their probe with non-decreasing
    %globaltimer stamps, and a probed launch computes what an unprobed one
    does."""
    T = 4
    args = decoder_args(cuda, torch.bfloat16, B=9, T=T)
    streams = decoder.decoder_fwd(*args)
    d = (torch.randn(streams[0].shape, generator=cuda, device="cuda"),
         torch.randn(streams[3].shape, generator=cuda, device="cuda"))
    grads = decoder.decoder_bwd(*args[:14], *streams, *d)
    probes = [torch.zeros(decoder.probe_len(T), dtype=torch.int64, device="cuda")
              for _ in range(2)]
    assert all(torch.equal(a, b)
               for a, b in zip(decoder.decoder_fwd(*args, probe=probes[0]), streams))
    assert all(torch.equal(a, b)
               for a, b in zip(decoder.decoder_bwd(*args[:14], *streams, *d, probe=probes[1]),
                               grads))
    for probe in probes:
        stamps = probe.tolist()
        assert stamps[0] > 0 and all(b >= a for a, b in zip(stamps, stamps[1:]))


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_decoder_bwd_kernel(cuda, dt):
    args = decoder_args(cuda, dt)
    streams = decoder.decoder_fwd_ref(*args)
    d_attn = torch.randn(streams[0].shape, generator=cuda, device="cuda")
    d_probs = torch.randn(streams[3].shape, generator=cuda, device="cuda")
    close_rel(decoder.decoder_bwd(*args[:14], *streams, d_attn, d_probs),
              decoder.decoder_bwd_ref(*args[:14], *streams, d_attn, d_probs), dt)


# B=140: more rows than an H100 has SMs, so the attention phase gives some
# CTAs two rows
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B,T", [(61, 6), (9, 1), (140, 3)], ids=["ragged", "T1", "B140"])
def test_decoder_bwd_kernel_shapes(cuda, dt, B, T):
    args = decoder_args(cuda, dt, B=B, T=T)
    streams = decoder.decoder_fwd_ref(*args)
    d_attn = torch.randn(streams[0].shape, generator=cuda, device="cuda")
    d_probs = torch.randn(streams[3].shape, generator=cuda, device="cuda")
    close_rel(decoder.decoder_bwd(*args[:14], *streams, d_attn, d_probs),
              decoder.decoder_bwd_ref(*args[:14], *streams, d_attn, d_probs), dt)
    plan = decoder.decoder_bwd.plan
    assert plan["grid"] == max(plan["unit_tiles"] * plan["row_tiles"], min(B, plan["sms"]))


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_backward_kernels_are_deterministic(cuda, dt):
    """Two launches on the same inputs agree bit for bit: a missing cluster
    or grid barrier shows here even where it stays inside a tolerance."""
    args = scan_args(cuda, dt, 61, 7, 250)
    outs, _ = gru_scan.gru_layer_scan_ref(*args, True)
    g = torch.randn(outs.shape, generator=cuda, device="cuda")
    first = gru_scan.gru_layer_scan_bwd(*args, outs, g, True)
    second = gru_scan.gru_layer_scan_bwd(*args, outs, g, True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    args = decoder_args(cuda, dt, B=61, T=6)
    streams = decoder.decoder_fwd_ref(*args)
    d = (torch.randn(streams[0].shape, generator=cuda, device="cuda"),
         torch.randn(streams[3].shape, generator=cuda, device="cuda"))
    first = decoder.decoder_bwd(*args[:14], *streams, *d)
    second = decoder.decoder_bwd(*args[:14], *streams, *d)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def step_args(g, dt, N=37, S=40, H=72):
    """Inputs of the decode step; the source of row min(2, N-1) is all
    padding."""
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    w = lambda *s: (r(*s) / math.sqrt(H)).to(dt)  # noqa: E731
    chain = (r(N, 3 * H).to(dt), torch.tanh(r(N, H)).to(dt), torch.tanh(r(N, H)).to(dt),
             torch.tanh(r(N, H)).to(dt), w(H, 3 * H), w(H, 3 * H), 0.1 * r(3 * H),
             w(H, 3 * H), 0.1 * r(3 * H), w(H, 3 * H), 0.1 * r(3 * H))
    lengths = torch.randint(1, S + 1, (N,), generator=g, device="cuda")
    lengths[min(2, N - 1)] = 0
    mask_bias = (torch.arange(S, device="cuda")[None] >= lengths[:, None]).float() * -1e9
    return chain, ((0.5 * r(N, S, H)).to(dt), (0.5 * r(N, S, H)).to(dt), w(H, H), mask_bias)


# N=1000 fills no 64-row tile; N=3 is less than one; H=72 and H=40 fill
# no 32-unit tile and no 32-value chunk of K; H=500 is the decoder's width;
# N=256, S=32, H=256 is the quality gate's beam-4 batch of 64
STEP_SHAPES = [(37, 40, 72), (1000, 24, 500), (3, 5, 500), (37, 40, 40), (256, 32, 256)]
STEP_IDS = ["small", "N1000", "N3", "H40", "gate"]


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("N,S,H", STEP_SHAPES, ids=STEP_IDS)
def test_decode_step_kernel(cuda, dt, N, S, H):
    chain, attn = step_args(cuda, dt, N, S, H)
    close(ds.decode_step(*chain, *attn), ds.decode_step_ref(*chain, *attn), dt)
    assert ds.decode_step.plan["grid"] == ds.step_cell_plan(N, H, dt)["grid"]


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("N,S,H", STEP_SHAPES, ids=STEP_IDS)
def test_gru_chain_kernel(cuda, dt, N, S, H):
    chain, _ = step_args(cuda, dt, N, S, H)
    close(ds.gru_chain(*chain), ds.gru_chain_ref(*chain), dt)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_step_kernels_are_deterministic(cuda, dt):
    chain, attn = step_args(cuda, dt, 1000, 24, 500)
    for fn, args in ((ds.decode_step, chain + attn), (ds.gru_chain, chain)):
        first, second = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_step_kernels_take_unaligned_views(cuda):
    """Inputs that start off a 16-byte boundary (views one element into
    their storage) give the same result as aligned copies."""
    chain, attn = step_args(cuda, torch.bfloat16, 37, 40, 40)

    def shifted(t):
        flat = t.flatten()
        v = torch.cat([flat[:1], flat])[1:].view(t.shape)
        assert v.data_ptr() % 16 != 0 and torch.equal(v, t)
        return v

    want = ds.decode_step(*chain, *attn)
    got = ds.decode_step(*map(shifted, chain), *map(shifted, attn))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_kernel_counts_launches(cuda):
    chain, attn = step_args(cuda, torch.float32, N=4, S=3, H=8)
    before = (ds.decode_step.launches, ds.gru_chain.launches)
    ds.decode_step(*chain, *attn)
    ds.gru_chain(*chain)
    assert (ds.decode_step.launches, ds.gru_chain.launches) == (before[0] + 1, before[1] + 1)
    args = decoder_args(cuda, torch.float32, B=3, T=2, S=3, H=8)
    counters = (decoder.decoder_fwd, decoder.decoder_bwd)
    before = [f.launches for f in counters]
    streams = decoder.decoder_fwd(*args)
    decoder.decoder_bwd(*args[:14], *streams, torch.ones_like(streams[0]).float(),
                        torch.ones_like(streams[3]).float())
    assert [f.launches for f in counters] == [n + 1 for n in before]


# widths: rows 1 and 2 up to H=512 (clusters of up to 16 CTAs; f32 at 512
# with 4 row slots forward and 2 rows backward) and above (both passes'
# tiled plans: phase 13's eleven shapes of chip_smoke.py, both directions,
# with and without a reset stream), rows 3-6 at widths that are not a
# multiple of 4 (zero-padded by the wrappers)
WIDE_SCANS = [(64, 25, 520), (256, 24, 520), (64, 25, 1000), (256, 24, 1000), (64, 25, 1024),
              (256, 24, 1024), (64, 25, 1040), (64, 25, 1536), (64, 25, 2048), (256, 24, 2048),
              (64, 25, 2500)]


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B,T,H", [(64, 24, 512), (256, 6, 512), (61, 7, 300), (9, 5, 257)]
                         + WIDE_SCANS,
                         ids=["H512", "H512B256", "H300", "H257"]
                         + [f"B{B}H{H}" for B, _, H in WIDE_SCANS])
def test_gru_scan_kernels_at_wide_widths(cuda, dt, B, T, H):
    args = scan_args(cuda, dt, B, T, H)
    close(gru_scan.gru_layer_scan(*args, True), gru_scan.gru_layer_scan_ref(*args, True), dt)
    if H <= 512:  # the forward's plan by its rule: clusters where they run in one wave
        want = gru_scan.scan_fwd_plan(B, T, H, dt, kernels.sm_count(0))
        assert gru_scan.gru_layer_scan.plan["layout"] == want["layout"]
        if want["layout"] == "cluster":
            assert gru_scan.gru_layer_scan.plan["cluster"] == -(-H // 32)
    g = torch.randn(B, T, H, generator=cuda, device="cuda")
    resets = (None,) if H <= 512 else (None, reset_stream(cuda, args[1]))
    for reverse in (False, True) if H > 512 else (False,):
        for reset in resets:
            if H > 512:
                close(gru_scan.gru_layer_scan(*args, reverse, reset),
                      gru_scan.gru_layer_scan_ref(*args, reverse, reset), dt)
                assert gru_scan.gru_layer_scan.plan["layout"] == "tiled"
            outs, _ = gru_scan.gru_layer_scan_ref(*args, reverse, reset)
            close_rel(gru_scan.gru_layer_scan_bwd(*args, outs, g, reverse, reset),
                      gru_scan.gru_layer_scan_bwd_ref(*args, outs, g, reverse, reset), dt)
            if H > 512:
                assert gru_scan.gru_layer_scan_bwd.plan["layout"] == "tiled"


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_tiled_scan_bwd_is_deterministic(cuda, dt):
    """The tiled backward where a cluster of CTAs splits K (B = 64, H =
    1024): the partial products are added in rank order, so repeats are
    bit-identical."""
    args = scan_args(cuda, dt, 64, 6, 1024)
    outs, _ = gru_scan.gru_layer_scan_ref(*args, True)
    g = torch.randn(64, 6, 1024, generator=cuda, device="cuda")
    first = gru_scan.gru_layer_scan_bwd(*args, outs, g, True)
    assert gru_scan.gru_layer_scan_bwd.plan["cluster"] > 1
    assert gru_scan.gru_layer_scan_bwd.plan["engine"] == \
        ("tile" if dt == torch.float32 else "wgmma")
    second = gru_scan.gru_layer_scan_bwd(*args, outs, g, True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B,H", [(64, 448), (64, 512), (256, 448), (256, 500), (256, 512)])
def test_tiled_scan_fwd_below_513_units(cuda, dt, B, H, monkeypatch):
    """The forward's tiled plan below 513 units (forced, whatever the rule
    picks there; H = 500 reads Wh's padded copy in 16 bits) against the
    plain version, both directions, with and without a reset stream; two
    launches bit-identical."""
    args = scan_args(cuda, dt, B, 5, H)
    plan = gru_scan.tiled_fwd_plan(B, H, dt, kernels.sm_count(0))
    monkeypatch.setattr(gru_scan, "scan_fwd_plan", lambda *a, **k: dict(plan))
    reset = reset_stream(cuda, args[1])
    for reverse in (False, True):
        for rs in (None, reset):
            close(gru_scan.gru_layer_scan(*args, reverse, rs),
                  gru_scan.gru_layer_scan_ref(*args, reverse, rs), dt)
            assert gru_scan.gru_layer_scan.plan["layout"] == "tiled"
    first = gru_scan.gru_layer_scan(*args, True, reset)
    second = gru_scan.gru_layer_scan(*args, True, reset)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


BWD_BELOW_513_TOL = {torch.float32: 4.0e-6, torch.bfloat16: 2e-2, torch.float16: 2e-2}


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B,H", [(64, 448), (64, 500), (64, 512), (256, 448), (256, 500),
                                 (256, 512)])
def test_tiled_scan_bwd_below_513_units(cuda, dt, B, H, monkeypatch):
    """The backward's tiled plan below 513 units (forced, whatever the rule
    picks there; H = 500 reads Wh's padded rows in 16 bits) against the
    plain version, both directions, with and without a reset stream,
    max|kernel - plain| / max|plain| within 4.0e-6 in f32 (PERF.md §6), 2e-2
    in bf16 and f16; two launches bit-identical on a narrow tile without a
    cluster (its gates add the K groups in group order)."""
    args = scan_args(cuda, dt, B, 5, H)
    sms = kernels.sm_count(0)
    plan = gru_scan.tiled_bwd_plan(B, 5, H, dt, sms)
    g = torch.randn(B, 5, H, generator=cuda, device="cuda")
    reset = reset_stream(cuda, args[1])
    monkeypatch.setattr(gru_scan, "scan_bwd_plan", lambda *a, **k: dict(plan))
    for reverse in (False, True):
        for rs in (None, reset):
            outs, _ = gru_scan.gru_layer_scan_ref(*args, reverse, rs)
            got = gru_scan.gru_layer_scan_bwd(*args, outs, g, reverse, rs)
            want = gru_scan.gru_layer_scan_bwd_ref(*args, outs, g, reverse, rs)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                scale = max(float(b.abs().max()), 1e-30)
                assert float((a - b).abs().max()) / scale <= BWD_BELOW_513_TOL[dt]
            assert gru_scan.gru_layer_scan_bwd.plan["layout"] == "tiled"
    narrow = dict(plan, **gru_scan.tiled_plan_for(B, H, dt, sms, 32, 8, 1))
    monkeypatch.setattr(gru_scan, "scan_bwd_plan", lambda *a, **k: dict(narrow))
    outs, _ = gru_scan.gru_layer_scan_ref(*args, True, reset)
    first = gru_scan.gru_layer_scan_bwd(*args, outs, g, True, reset)
    assert (gru_scan.gru_layer_scan_bwd.plan["units"], gru_scan.gru_layer_scan_bwd.plan["cluster"]) \
        == (8, 1)
    second = gru_scan.gru_layer_scan_bwd(*args, outs, g, True, reset)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_tiled_scan_fwd_is_deterministic(cuda, dt, monkeypatch):
    """The tiled forward at B = 64, H = 1024 on its plan, and where a
    cluster of CTAs splits K (32 x 32 tiles, clusters of 2, the plan
    forced): the partial products are added in rank order, so repeats are
    bit-identical, with and without a reset stream."""
    args = scan_args(cuda, dt, 64, 6, 1024)
    split = gru_scan.tiled_fwd_plan_for(64, 1024, dt, kernels.sm_count(0), 32, 32, 2)
    for forced in (None, split):
        if forced is not None:
            monkeypatch.setattr(gru_scan, "scan_fwd_plan", lambda *a, **k: dict(forced))
        for reset in (None, reset_stream(cuda, args[1])):
            first = gru_scan.gru_layer_scan(*args, True, reset)
            assert gru_scan.gru_layer_scan.plan["layout"] == "tiled"
            assert forced is None or gru_scan.gru_layer_scan.plan["cluster"] == 2
            second = gru_scan.gru_layer_scan(*args, True, reset)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("N,S,H", [(128, 24, 250), (32, 24, 250), (37, 5, 6)],
                         ids=["N128", "N32", "H6"])
def test_step_kernels_at_a_width_not_a_multiple_of_4(cuda, dt, N, S, H):
    chain, attn = step_args(cuda, dt, N, S, H)
    close(ds.decode_step(*chain, *attn), ds.decode_step_ref(*chain, *attn), dt)
    close(ds.gru_chain(*chain), ds.gru_chain_ref(*chain), dt)
    assert ds.decode_step.plan["padded"] == ds.padded_width(H)
    w = ds.pad_step_weights(*chain[4:], attn[2])  # padded once, as a request does
    keys, mem_v = (ds.pad_units(t, H, ds.padded_width(H)) for t in attn[:2])
    close(ds.decode_step(*chain[:4], *w[:7], keys, mem_v, w[7], attn[3]),
          ds.decode_step_ref(*chain, *attn), dt)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B,T,S,H", [(64, 25, 24, 250), (9, 6, 13, 6)], ids=["H250", "H6"])
def test_decoder_kernels_at_a_width_not_a_multiple_of_4(cuda, dt, B, T, S, H):
    args = decoder_args(cuda, dt, B=B, T=T, S=S, H=H, mem_std=0.1)
    streams = decoder.decoder_fwd_ref(*args)
    close(decoder.decoder_fwd(*args), streams, dt)
    d_attn = torch.randn(streams[0].shape, generator=cuda, device="cuda")
    d_probs = torch.randn(streams[3].shape, generator=cuda, device="cuda")
    close_rel(decoder.decoder_bwd(*args[:14], *streams, d_attn, d_probs),
              decoder.decoder_bwd_ref(*args[:14], *streams, d_attn, d_probs), dt)
    assert decoder.decoder_bwd.plan["padded"] == ds.padded_width(H)


def decoder_both(cuda, dt, args):
    """Both decoder kernels against their plain versions on ``args``."""
    streams = decoder.decoder_fwd_ref(*args)
    close(decoder.decoder_fwd(*args), streams, dt)
    d_attn = torch.randn(streams[0].shape, generator=cuda, device="cuda")
    d_probs = torch.randn(streams[3].shape, generator=cuda, device="cuda")
    close_rel(decoder.decoder_bwd(*args[:14], *streams, d_attn, d_probs),
              decoder.decoder_bwd_ref(*args[:14], *streams, d_attn, d_probs), dt)


# the streamed plan: the forward streams from H = 1002 (padded to 1004) in
# every dtype, the backward at 2048 (and in f32 from 1002); memory std 0.1,
# as chip_smoke.py holds the whole sequence
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B", [9, 64])
@pytest.mark.parametrize("H", [1002, 1024, 2048])
def test_decoder_kernels_on_the_streamed_plan(cuda, dt, B, H):
    decoder_both(cuda, dt, decoder_args(cuda, dt, B=B, T=6, S=40, H=H, mem_std=0.1))
    assert decoder.decoder_fwd.plan["layout"] == "streamed"
    assert decoder.decoder_fwd.plan["padded"] == ds.padded_width(H)
    if H == 2048 or dt == torch.float32:
        assert decoder.decoder_bwd.plan["layout"] == "streamed"


# fault 3.5: a batch of 1024 at the flagship's width runs the forward in row
# chunks (two in bf16 and f16, three in f32 at S = 40)
@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_decoder_kernels_in_row_chunks(cuda, dt):
    before = decoder.decoder_fwd.launches
    decoder_both(cuda, dt, decoder_args(cuda, dt, B=1024, T=6, S=40, H=500, mem_std=0.1))
    plan = decoder.decoder_fwd.plan
    assert plan["layout"] == "resident" and plan["chunks"] >= 2
    assert decoder.decoder_fwd.launches == before + plan["chunks"]


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_streamed_decoder_kernels_are_deterministic(cuda, dt):
    args = decoder_args(cuda, dt, B=64, T=6, S=40, H=2048, mem_std=0.1)
    streams = decoder.decoder_fwd_ref(*args)
    d = (torch.randn(streams[0].shape, generator=cuda, device="cuda"),
         torch.randn(streams[3].shape, generator=cuda, device="cuda"))
    first = decoder.decoder_fwd(*args) + decoder.decoder_bwd(*args[:14], *streams, *d)
    second = decoder.decoder_fwd(*args) + decoder.decoder_bwd(*args[:14], *streams, *d)
    torch.cuda.synchronize()
    assert decoder.decoder_bwd.plan["layout"] == "streamed"
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# Row 2's hoisted products on the wgmma engine (csrc/wgmma_gemm.cuh)
# against their plain version: the same rounded operands summed in f32 in
# another order, held to 1e-4 of each output's largest entry (readings at
# most 1e-5). Ragged M = B*T, N = 3H and K (no multiple of a tile's 128 or
# 256, nor of the 64-deep slice), H = 250 and 500 with Wh's copy (3H not a
# whole number of 16-byte pieces), dWh split where its tiles are few.
PRODUCT_TOL = 1e-4
PRODUCT_SHAPES = [(9, 7, 40), (61, 7, 250), (37, 5, 500), (64, 24, 512), (13, 11, 1024),
                  (5, 25, 2048), (256, 24, 1024)]


@pytest.mark.parametrize("dt", [torch.float16, torch.bfloat16], ids=str)
@pytest.mark.parametrize("B,T,H", PRODUCT_SHAPES,
                         ids=[f"B{B}T{T}H{H}" for B, T, H in PRODUCT_SHAPES])
def test_wgmma_products_kernel(cuda, dt, B, T, H):
    args = scan_args(cuda, dt, B, T, H)
    x, mask, h0, wh, bh = args
    reset = reset_stream(cuda, mask)
    r = lambda *s: torch.randn(*s, generator=cuda, device="cuda")  # noqa: E731
    for reverse, rs in ((False, None), (True, reset)):
        outs, _ = gru_scan.gru_layer_scan_ref(*args, reverse, rs)
        dx, dhn = r(B, T, 3 * H), r(B, T, H)
        got = gru_scan.scan_bwd_products(h0, outs, wh, bh, dx, dhn, reverse, rs)
        want = gru_scan.scan_bwd_products_ref(h0, outs, wh, bh, dx, dhn, reverse, rs)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == torch.float32
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g - w).abs().max()) / scale <= PRODUCT_TOL
    plan = gru_scan.scan_bwd_products.plan
    assert plan["engine"] == "wgmma" and plan["wh_copy"] == (3 * H % 8 != 0)


# the whole backward, the wgmma engine required: the flagship's B = 64,
# T = 24, H = 250 (dWh split 6 ways) and phase 13's eleven shapes
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("B,T,H", [(64, 24, 250)] + WIDE_SCANS,
                         ids=["flagship"] + [f"B{B}H{H}" for B, _, H in WIDE_SCANS])
def test_gru_scan_bwd_on_the_wgmma_engine(cuda, dt, B, T, H):
    args = scan_args(cuda, dt, B, T, H)
    g = torch.randn(B, T, H, generator=cuda, device="cuda")
    for reverse, reset in ((False, None), (True, reset_stream(cuda, args[1]))):
        outs, _ = gru_scan.gru_layer_scan_ref(*args, reverse, reset)
        close_rel(gru_scan.gru_layer_scan_bwd(*args, outs, g, reverse, reset),
                  gru_scan.gru_layer_scan_bwd_ref(*args, outs, g, reverse, reset), dt)
        plan = gru_scan.gru_layer_scan_bwd.plan
        assert plan["engine"] == "wgmma" and plan["gemm_per_sm"] >= 1
        assert plan["layout"] == ("cluster" if H <= 512 else "tiled")


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("B,T,H", [(64, 24, 250), (256, 24, 512)], ids=["flagship", "H512"])
def test_wgmma_products_split_is_deterministic(cuda, dt, B, T, H):
    """dWh's K split over CTAs a tile (6 at the flagship, 5 at H = 512): the
    last CTA adds the partials in split order, so repeats are
    bit-identical, the products alone and the whole backward; each wgmma
    call counts two launches of the operand pass and two of the product."""
    args = scan_args(cuda, dt, B, T, H)
    reset = reset_stream(cuda, args[1])
    outs, _ = gru_scan.gru_layer_scan_ref(*args, True, reset)
    g = torch.randn(B, T, H, generator=cuda, device="cuda")
    counts = (gru_scan.scan_bwd_operands.launches, gru_scan.wgmma_gemm.launches)
    first = gru_scan.gru_layer_scan_bwd(*args, outs, g, True, reset)
    assert gru_scan.gru_layer_scan_bwd.plan["dwh_splits"] > 1
    second = gru_scan.gru_layer_scan_bwd(*args, outs, g, True, reset)
    dx, dhn = first[0], torch.randn(B, T, H, generator=cuda, device="cuda")
    once = gru_scan.scan_bwd_products(args[2], outs, args[3], args[4], dx, dhn, True, reset)
    again = gru_scan.scan_bwd_products(args[2], outs, args[3], args[4], dx, dhn, True, reset)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first + once, second + again))
    assert (gru_scan.scan_bwd_operands.launches, gru_scan.wgmma_gemm.launches) == \
        (counts[0] + 8, counts[1] + 8)


def test_every_entry_point_refuses_an_unknown_dtype_code(cuda):
    """Code 3 names no compute dtype: every C entry point and occupancy
    query returns cudaErrorInvalidValue before touching its (null)
    pointers, where it once ran the float32 instantiation, and the
    wrappers' check raises with the library's error string."""
    for name, entries in kernels.SIGNATURES.items():
        lib = kernels.library(name)
        for fn, argtypes in entries.items():
            args = [3] + [1 if t is kernels._I else None for t in argtypes[1:]]
            err = getattr(lib, fn)(*args)
            assert err == 1, (fn, err)  # cudaErrorInvalidValue
            with pytest.raises(RuntimeError, match="invalid argument"):
                kernels.check(lib, err, fn)
    assert torch.cuda.synchronize() is None
