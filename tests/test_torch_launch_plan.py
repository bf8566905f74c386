"""PyTorch port: the launch plans of the cluster and persistent kernels
(``scan_fwd_plan``, ``scan_bwd_plan``, ``step_cell_plan``,
``decoder_fwd_plan`` and ``decoder_bwd_plan``), pure Python, on the CPU. The widths the repo's
configs use (H=250 a direction for the scan, H=500 for the decoder and the
decode step) are accepted in the three dtypes, and so is every scan width
(clusters of up to 16 CTAs to 512; above, both passes' tiled plans:
tests/test_torch_wide_scan.py and tests/test_torch_wider_scan.py) and any
decoder
width (padded to a
multiple of 4); shapes the designs cannot hold raise NotImplementedError,
and so do the wrappers on a non-CPU tensor before anything is launched
(meta tensors stand in for CUDA ones). ``UniGRU`` sends every
``use_pallas`` GRU layer to the scan kernels."""

import logging

import pytest
import torch

from variational_mmt_torch import kernels
from variational_mmt_torch.models import gru as gru_mod
from variational_mmt_torch.ops import decode_step as ds
from variational_mmt_torch.ops import decoder, gru_scan

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
H100_SMS = 132  # SMs of an H100 SXM; an H100 PCIe has 114
SMEM_PER_SM = 233_472  # shared memory of an H100 SM (228 KB), 1 KB of it reserved per CTA


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B,T", [(64, 24), (61, 24), (64, 1), (1, 5)])
def test_scan_plan_accepts_the_encoder_width(dt, B, T):
    """H = 250: clusters of 8 CTAs of 32 units, where they run in one wave
    on an H100 (:func:`gru_scan.bwd_cluster_waves`), as in bf16 and f16 at
    the flagship's B = 64; else the tiled plan, whose grid the card holds at
    once."""
    H = 250
    plan = gru_scan.scan_bwd_plan(B, T, H, dt)
    if plan["layout"] == "tiled":
        assert dt == torch.float32 and B > 1 and plan["chunks"] == 1
        plan = dict(gru_scan._cluster_bwd_plan(B, H, dt, H100_SMS),
                    **gru_scan.products_plan(B, T, H, dt, H100_SMS, False))
        assert gru_scan.bwd_cluster_waves(plan, H100_SMS) > 1
    assert plan["cluster"] <= gru_scan.SCAN_BWD_MAX_CLUSTER
    assert plan["units"] <= gru_scan.SCAN_BWD_UNITS
    assert plan["cluster"] * plan["units"] >= H > (plan["cluster"] - 1) * plan["units"]
    assert plan["clusters"] * plan["rows"] >= B > (plan["clusters"] - 1) * plan["rows"]
    assert plan["ctas"] == plan["clusters"] * plan["cluster"]
    assert 0 < plan["smem"] <= kernels.SMEM_PER_BLOCK
    assert 1 <= plan["dwh_splits"] <= 8


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("T", [24, 1])
@pytest.mark.parametrize("B", [256, 64, 61, 1])
def test_scan_fwd_plan_accepts_the_encoder_width(dt, B, T):
    """H = 250: clusters of 8 CTAs, in one wave on an H100 in bf16 and f16
    (3 CTAs an SM, 45 clusters at once); in f32 (one CTA an SM, 15 at once)
    the 16 clusters of B = 61 and 64 and the 32 of B = 256 would run in
    waves, so those take the tiled plan (PERF.md, the crossover sweep)."""
    H = 250
    plan = gru_scan.scan_fwd_plan(B, T, H, dt, H100_SMS)
    if dt == torch.float32 and B > 1:
        assert plan["layout"] == "tiled" and plan["chunks"] == 1
        plan = gru_scan._cluster_fwd_plan(B, H, dt, H100_SMS)
        assert gru_scan.fwd_cluster_waves(plan, H100_SMS) == -(-plan["clusters"] // 15) > 1
    assert (plan["cluster"], plan["units"]) == (8, 32)
    assert plan["rows"] in (4, 8)
    assert plan["clusters"] * plan["rows"] >= B > (plan["clusters"] - 1) * plan["rows"]
    assert plan["ctas"] == plan["clusters"] * plan["cluster"]
    assert plan["threads"] == 3 * 32 * gru_scan.SCAN_FWD_PARTS
    assert 0 < plan["smem"] <= kernels.SMEM_PER_BLOCK


def test_scan_fwd_plan_at_the_main_path_shapes():
    """Training's B=64: 16 clusters of 4 rows, 128 CTAs, one an SM; serving's
    B=256: 32 clusters of 8 rows (the mma's columns), 256 CTAs, which fit
    one wave only where two bf16 CTAs share an SM. The forward takes these
    cluster plans in bf16 and f16; in f32 (one CTA an SM) the tiled one."""
    for dt in DTYPES:  # the cluster plans (f32 takes the tiled one at both)
        train = gru_scan._cluster_fwd_plan(64, 250, dt, H100_SMS)
        serve = gru_scan._cluster_fwd_plan(256, 250, dt, H100_SMS)
        assert (train["rows"], train["clusters"], train["ctas"]) == (4, 16, 128)
        assert (serve["rows"], serve["clusters"], serve["ctas"]) == (8, 32, 256)
        for B, plan in ((64, train), (256, serve)):
            assert gru_scan.scan_fwd_plan(B, 24, 250, dt, H100_SMS) == plan \
                or dt == torch.float32
    bf16 = gru_scan.scan_fwd_plan(256, 24, 250, torch.bfloat16, H100_SMS)
    assert 2 * (bf16["smem"] + 1024) <= SMEM_PER_SM


def test_scan_fwd_plan_mirrors_the_kernels_layout():
    """bf16: 96 columns of Wh and two 8-slot state buffers at the mma stride
    (264 halves at H=250), the f32 partial products; f32: the same unpadded."""
    parts = 4 * 96 * 8 * 4
    assert gru_scan.scan_fwd_plan(64, 24, 250, torch.bfloat16, H100_SMS)["smem"] == \
        96 * 264 * 2 + 2 * 8 * 264 * 2 + parts
    assert gru_scan._cluster_fwd_plan(64, 250, torch.float32, H100_SMS)["smem"] == \
        96 * 250 * 4 + 2 * 8 * 250 * 4 + parts


def assert_streamed(plan, H, dt, B):
    """A tiled forward plan: the units covering H, the rows of its launches
    covering B, the grid within what 132 SMs hold at once in its clusters
    (one CTA an SM) and shared memory within the card's."""
    assert plan["layout"] == "tiled" and (plan["rows"], plan["units"]) in gru_scan.TILED_FWD_TILES
    assert plan["unit_tiles"] * plan["units"] >= H > (plan["unit_tiles"] - 1) * plan["units"]
    assert plan["chunks"] * plan["rows"] * plan["row_tiles"] >= B
    assert plan["grid"] == plan["tiles"] * plan["cluster"] \
        <= gru_scan.tiled_co_resident(plan["cluster"], H100_SMS)
    assert plan["tiles"] == plan["unit_tiles"] * plan["row_tiles"]
    assert 0 < plan["smem"] <= kernels.SMEM_PER_BLOCK
    assert plan["smem"] + 1024 <= SMEM_PER_SM


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("H", [0, 1025, 2048])
def test_scan_fwd_plan_refuses_what_a_cluster_cannot_hold(dt, H):
    """H = 0 is refused; 1025 and 2048, wider than a cluster holds, take
    the tiled plan at every batch."""
    if H == 0:
        with pytest.raises(NotImplementedError):
            gru_scan.scan_fwd_plan(64, 24, H, dt, H100_SMS)
        return
    for B in (1, 61, 64, 256, 300):
        assert_streamed(gru_scan.scan_fwd_plan(B, 24, H, dt, H100_SMS), H, dt, B)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("N", [1024, 1000, 4, 1])
def test_step_cell_plan_accepts_the_decoder_width(dt, N):
    H = 500
    plan = ds.step_cell_plan(N, H, dt)
    units, rows = plan["grid"]
    assert (units - 1) * plan["units"] < H <= units * plan["units"]
    assert (rows - 1) * plan["rows"] < N <= rows * plan["rows"]
    assert plan["ctas"] == units * rows
    assert plan["k_chunks"] * 32 >= H
    assert 0 < plan["smem"] <= kernels.SMEM_PER_BLOCK


def test_step_cell_plan_at_the_serving_shape():
    """N=1024 rows (256 sentences x beam 4), H=500: 16 x 16 tiles of 64 rows
    x 32 units, 256 CTAs; two bf16 CTAs fit an SM by shared memory, so the
    grid is one wave on 128 SMs or more."""
    for dt in DTYPES:
        plan = ds.step_cell_plan(1024, 500, dt)
        assert (plan["rows"], plan["grid"], plan["ctas"]) == (64, (16, 16), 256)
    epilogue = lambda size: 64 * (96 + 32) * size + 2 * 96 * 4  # noqa: E731
    bf16 = ds.step_cell_plan(1024, 500, torch.bfloat16)
    assert bf16["smem"] == 2 * (2 * 64 * 40 + 2 * 32 * 104) * 2 + epilogue(2)
    assert ds.step_cell_plan(1024, 500, torch.float32)["smem"] == \
        2 * (2 * 64 * 36 + 2 * 32 * 100) * 4 + epilogue(4)
    assert 2 * (bf16["smem"] + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("H", [0, 250, 501])
def test_step_cell_plan_refuses_what_the_copies_cannot_hold(dt, H):
    """The copies are 4 values wide: H=0 is refused, and any other width is
    planned at its padding to a multiple of 4, which the copies hold."""
    if H == 0:
        with pytest.raises(NotImplementedError):
            ds.step_cell_plan(1024, H, dt)
        return
    plan = ds.step_cell_plan(1024, H, dt)
    assert plan["padded"] % ds.CELL_VEC == 0 and 0 <= plan["padded"] - H < ds.CELL_VEC
    assert plan == ds.step_cell_plan(1024, plan["padded"], dt)


def test_scan_plan_at_the_training_shape():
    """B=64, T=24: 16 clusters of 8 CTAs of 32 units, in one wave on an
    H100 in bf16 and f16, so the flagship's training shape keeps them."""
    for dt in DTYPES:
        plan = gru_scan._cluster_bwd_plan(64, 250, dt, H100_SMS)
        assert (plan["cluster"], plan["units"], plan["clusters"], plan["ctas"]) == (8, 32, 16, 128)
        if dt != torch.float32:
            assert gru_scan.bwd_cluster_waves(plan, H100_SMS) == 1
            assert gru_scan.scan_bwd_plan(64, 24, 250, dt)["layout"] == "cluster"


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("H", [0, 1025, 2048])
def test_scan_plan_refuses_what_a_cluster_cannot_hold(dt, H):
    """H = 0 refused, 1025 and 2048 on the tiled plan: tiles covering H and
    B, the grid within what 132 SMs hold at once."""
    if H == 0:
        with pytest.raises(NotImplementedError):
            gru_scan.scan_bwd_plan(64, 24, H, dt)
        return
    for B in (1, 61, 64, 256, 300):
        plan = gru_scan.scan_bwd_plan(B, 24, H, dt)
        assert plan["layout"] == "tiled" and plan["dwh_splits"] == 1
        assert plan["unit_tiles"] * plan["units"] >= H
        assert plan["chunks"] * plan["rows"] * plan["row_tiles"] >= B
        assert plan["grid"] <= gru_scan.tiled_co_resident(plan["cluster"], H100_SMS)
        assert 0 < plan["smem"] <= kernels.SMEM_PER_BLOCK


@pytest.mark.parametrize("sms", [H100_SMS, 114])
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B,S", [(64, 24), (61, 24), (1, 24), (64, 80), (256, 24)])
def test_decoder_plan_accepts_the_decoder_width(dt, B, S, sms):
    H = 500
    plan = decoder.decoder_bwd_plan(B, S, H, dt, sms)
    assert plan["units"] == decoder.DEC_UNITS[dt]
    assert plan["unit_tiles"] * plan["units"] >= H
    assert plan["rows"] % 16 == 0 and plan["row_tiles"] * plan["rows"] >= B
    assert plan["grid"] >= plan["unit_tiles"] * plan["row_tiles"]
    assert plan["grid"] <= max(sms, plan["unit_tiles"])
    assert 0 < plan["smem"] <= kernels.SMEM_PER_BLOCK


def test_decoder_plan_at_the_training_shape():
    """B=64, S=24 on an H100 SXM: bf16 CTAs of 8 units and 32 rows (126
    CTAs), f32 CTAs of 4 units and 64 rows (125); two CTAs fit an SM, so
    the grid is co-resident on any card of 63 SMs or more."""
    bf16 = decoder.decoder_bwd_plan(64, 24, 500, torch.bfloat16, H100_SMS)
    f32 = decoder.decoder_bwd_plan(64, 24, 500, torch.float32, H100_SMS)
    assert (bf16["units"], bf16["rows"], bf16["grid"]) == (8, 32, 126)
    assert (f32["units"], f32["rows"], f32["grid"]) == (4, 64, 125)
    for plan in (bf16, f32):
        assert 2 * (plan["smem"] + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B,S,H", [(64, 24, 2000), (4096, 24, 500), (0, 24, 500)])
def test_decoder_plan_refuses_what_shared_memory_cannot_hold(dt, B, S, H):
    with pytest.raises(NotImplementedError):
        decoder.decoder_bwd_plan(B, S, H, dt, H100_SMS)


@pytest.mark.parametrize("sms", [H100_SMS, 114])
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("S", [24, 40])
@pytest.mark.parametrize("B", [1, 61, 64, 256])
def test_decoder_fwd_plan_accepts_the_decoder_width(dt, B, S, sms):
    H = 500
    plan = decoder.decoder_fwd_plan(B, S, H, dt, sms)
    assert plan["units"] == decoder.DEC_UNITS[dt]
    assert (plan["unit_tiles"] - 1) * plan["units"] < H <= plan["unit_tiles"] * plan["units"]
    assert plan["rows"] % 16 == 0
    assert (plan["row_tiles"] - 1) * plan["rows"] < B <= plan["row_tiles"] * plan["rows"]
    assert plan["grid"] == max(plan["unit_tiles"] * plan["row_tiles"], min(B, sms))
    assert 0 < plan["smem"] <= kernels.SMEM_PER_BLOCK


def test_decoder_fwd_plan_at_the_training_shape():
    """B=64, S=24 on an H100 SXM: bf16 CTAs of 8 units and 32 rows (126
    CTAs), f32 CTAs of 4 units and 64 rows (125). A CTA takes more than half
    an SM's shared memory, so the grid runs one CTA an SM: co-resident on
    any card of 126 SMs or more (an H100 PCIe's 114 SMs take bf16 CTAs of 64
    rows, 64 of them)."""
    bf16 = decoder.decoder_fwd_plan(64, 24, 500, torch.bfloat16, H100_SMS)
    f32 = decoder.decoder_fwd_plan(64, 24, 500, torch.float32, H100_SMS)
    assert (bf16["units"], bf16["rows"], bf16["grid"]) == (8, 32, 126)
    assert (f32["units"], f32["rows"], f32["grid"]) == (4, 64, 125)
    for plan in (bf16, f32):
        assert SMEM_PER_SM < 2 * (plan["smem"] + 1024) and plan["smem"] + 1024 <= SMEM_PER_SM
    pcie = decoder.decoder_fwd_plan(64, 24, 500, torch.bfloat16, 114)
    assert (pcie["rows"], pcie["grid"]) == (64, 64)


def test_decoder_fwd_plan_mirrors_the_kernels_layout():
    """bf16 at B=64: four (24, 544) weight slices and one (8, 544) (K=500
    padded to 544), the product buffer of 128 rows x 4 n-tiles of 8 floats,
    three (32, 8) f32 carries, two (32, 8, 3) hidden products, the attention
    row of 3H + S floats; f32 at B=64: (12, 512) and (4, 512) slices, 64
    product rows, (64, 4) carries."""
    assert decoder.decoder_fwd_plan(64, 24, 500, torch.bfloat16, H100_SMS)["smem"] == \
        4 * 24 * 544 * 2 + 8 * 544 * 2 + 128 * 32 * 4 + 3 * 32 * 8 * 4 + 2 * 32 * 8 * 12 \
        + (1500 + 24) * 4
    assert decoder.decoder_fwd_plan(64, 24, 500, torch.float32, H100_SMS)["smem"] == \
        4 * 12 * 512 * 4 + 4 * 512 * 4 + 64 * 32 * 4 + 3 * 64 * 4 * 4 + 2 * 64 * 4 * 12 \
        + (1500 + 24) * 4


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("B,S,H", [(64, 24, 2000), (4096, 24, 500), (0, 24, 500),
                                   (64, 24, 1002)])
def test_decoder_fwd_plan_refuses_what_shared_memory_cannot_hold(dt, B, S, H):
    """Also H=1002, padded to 1004: its weight slices exceed a CTA's
    shared memory in every dtype."""
    with pytest.raises(NotImplementedError):
        decoder.decoder_fwd_plan(B, S, H, dt, H100_SMS)


def meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


def scan_args(B, T, H):
    return (meta(B, T, 3 * H), meta(B, T), meta(B, H), meta(H, 3 * H), meta(3 * H),
            meta(B, T, H), meta(B, T, H))


def decoder_args(B, T, S, H, dt=torch.float32):
    c = lambda *shape: meta(*shape, dtype=dt)  # noqa: E731
    w = c(H, 3 * H)
    return (c(B, T, 3 * H), c(B, T, H), meta(B, H), meta(B, H), w, w, meta(3 * H), w,
            meta(3 * H), w, meta(3 * H), c(B, S, H), c(B, S, H), c(H, H),
            c(B, T, H), c(B, T, H), c(B, T, H), c(B, T, S), meta(B, T, H), meta(B, T, S))


class Launched(RuntimeError):
    pass


@pytest.fixture
def no_launch(monkeypatch):
    """A library whose every entry point fails the test if it is called."""
    class Lib:
        def __getattr__(self, name):
            raise Launched(name)

    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    monkeypatch.setattr(kernels, "sm_count", lambda device: H100_SMS)
    return monkeypatch


def step_args(N, S, H, dt=torch.float32):
    c = lambda *shape: meta(*shape, dtype=dt)  # noqa: E731
    w = c(H, 3 * H)
    return (c(N, 3 * H), c(N, H), c(N, H), c(N, H), w, w, meta(3 * H), w, meta(3 * H), w,
            meta(3 * H))


def test_wrappers_refuse_a_shape_before_launching(no_launch):
    # the scans hold every H >= 1 (H = 1100 is on the tiled plans): H = 0
    # is what they refuse
    with pytest.raises(NotImplementedError):
        gru_scan.gru_layer_scan(*scan_args(4, 5, 0)[:5])
    with pytest.raises(NotImplementedError):
        gru_scan.gru_layer_scan_bwd(*scan_args(4, 5, 0))
    for dt in DTYPES:
        chain = step_args(4, 3, 0, dt)
        with pytest.raises(NotImplementedError):
            ds.gru_chain(*chain)
        with pytest.raises(NotImplementedError):
            ds.decode_step(*chain, meta(4, 3, 0, dtype=dt), meta(4, 3, 0, dtype=dt),
                           meta(0, 0, dtype=dt), meta(4, 3))
    # the decoder kernels hold every H >= 1 too (H = 2000 is on the streamed
    # plan): H = 0 is what they refuse
    with pytest.raises(NotImplementedError):
        decoder.decoder_bwd(*decoder_args(4, 5, 3, 0))


def test_wrappers_refuse_what_the_card_cannot_hold_at_once(no_launch):
    """No cluster fits, or the cooperative grid is not co-resident: the
    wrapper raises; it never runs anything else in the kernels' place."""
    plan = gru_scan.scan_bwd_plan(4, 5, 8, torch.float32)
    no_launch.setattr(kernels, "occupancy", lambda *a: (0, plan["smem"]))
    with pytest.raises(NotImplementedError, match="does not fit"):
        gru_scan.gru_layer_scan_bwd(*scan_args(4, 5, 8))
    plan = gru_scan.scan_fwd_plan(4, 5, 8, torch.float32, H100_SMS)
    no_launch.setattr(kernels, "occupancy", lambda *a: (0, plan["smem"]))
    with pytest.raises(NotImplementedError, match="does not fit"):
        gru_scan.gru_layer_scan(*scan_args(4, 5, 8)[:5])
    plan = ds.step_cell_plan(4, 8, torch.float32)
    no_launch.setattr(kernels, "occupancy", lambda *a: (0, plan["smem"]))
    with pytest.raises(NotImplementedError, match="does not fit"):
        ds.gru_chain(*step_args(4, 3, 8))
    plan = decoder.decoder_bwd_plan(4, 3, 8, torch.float32, H100_SMS)
    no_launch.setattr(kernels, "occupancy", lambda *a: (plan["grid"] - 1, plan["smem"]))
    with pytest.raises(NotImplementedError, match="at once"):
        decoder.decoder_bwd(*decoder_args(4, 5, 3, 8))


def test_wrappers_check_the_plan_against_the_kernels_count(no_launch):
    no_launch.setattr(kernels, "occupancy", lambda *a: (1000, 1))
    with pytest.raises(RuntimeError, match="shared"):
        gru_scan.gru_layer_scan_bwd(*scan_args(4, 5, 8))
    with pytest.raises(RuntimeError, match="shared"):
        gru_scan.gru_layer_scan(*scan_args(4, 5, 8)[:5])
    with pytest.raises(RuntimeError, match="shared"):
        ds.decode_step(*step_args(4, 3, 8), meta(4, 3, 8), meta(4, 3, 8), meta(8, 8), meta(4, 3))
    with pytest.raises(RuntimeError, match="shared"):
        decoder.decoder_bwd(*decoder_args(4, 5, 3, 8))


@pytest.mark.parametrize("dt,per_sm", [(torch.bfloat16, 1), (torch.float16, 1),
                                         (torch.float32, 2)], ids=str)
def test_decoder_grid_follows_the_cards_sm_count(monkeypatch, dt, per_sm):
    """On a card of 114 SMs (an H100 PCIe) that holds ``per_sm`` CTAs an SM
    the flagship's backward launches with a co-resident grid: the plan
    spreads its tiles over the SMs the card has."""
    grids = []

    class Lib:
        def vmmt_decoder_bwd(self, *args):
            grids.append(args[-2])  # ..., units, rows, grid, stream
            return 0

    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    monkeypatch.setattr(kernels, "sm_count", lambda device: 114)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    smem = decoder.decoder_bwd_plan(64, 24, 500, dt, 114)["smem"]
    monkeypatch.setattr(kernels, "occupancy", lambda *a: (114 * per_sm, smem))
    decoder.decoder_bwd(*decoder_args(64, 25, 24, 500, dt))
    assert len(grids) == 1 and grids[0] <= 114 * per_sm
    assert decoder.decoder_bwd.plan["grid"] == grids[0]


def test_decoder_refuses_a_grid_the_card_cannot_hold(no_launch):
    """f32 needs a CTA for each of its 125 unit tiles: one CTA an SM on 114
    SMs is too few, and the wrapper says so before launching."""
    no_launch.setattr(kernels, "sm_count", lambda device: 114)
    smem = decoder.decoder_bwd_plan(64, 24, 500, torch.float32, 114)["smem"]
    no_launch.setattr(kernels, "occupancy", lambda *a: (114, smem))
    with pytest.raises(NotImplementedError, match="at once"):
        decoder.decoder_bwd(*decoder_args(64, 25, 24, 500))


@pytest.mark.parametrize("B,rows", [(64, 4), (256, 8)])
def test_scan_wrapper_launches_with_the_plan(monkeypatch, B, rows):
    """The forward wrapper passes the plan's cluster, units and rows to the
    kernel and keeps the plan, with whether the grid is one wave."""
    calls = []

    class Lib:
        def vmmt_gru_scan(self, *args):
            calls.append(args[-4:-1])  # ..., cluster, units, rows, stream
            return 0

    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda device: H100_SMS)
    smem = gru_scan.scan_fwd_plan(B, 24, 250, torch.bfloat16, H100_SMS)["smem"]
    monkeypatch.setattr(kernels, "occupancy", lambda *a: (40, smem))
    x = meta(B, 24, 750, dtype=torch.bfloat16)
    gru_scan.gru_layer_scan(x, meta(B, 24), meta(B, 250), meta(250, 750, dtype=torch.bfloat16),
                            meta(750))
    assert calls == [(8, 32, rows)]
    plan = gru_scan.gru_layer_scan.plan
    assert plan["rows"] == rows and plan["one_wave"] == (40 >= plan["clusters"])


@pytest.mark.parametrize("sms,rows", [(H100_SMS, 4), (114, 8)])
def test_scan_fwd_plan_follows_the_cards_sm_count(monkeypatch, sms, rows):
    """At B=64, H=250, 16 clusters of 4 rows (128 CTAs) fit one CTA an SM of
    a 132-SM card; a 114-SM card takes 8 rows a cluster (64 CTAs). The
    wrapper asks the card it launches on."""
    assert gru_scan.scan_fwd_plan(64, 24, 250, torch.bfloat16, sms)["rows"] == rows
    calls = []

    class Lib:
        def vmmt_gru_scan(self, *args):
            calls.append(args[-2])  # rows
            return 0

    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda device: sms)
    smem = gru_scan.scan_fwd_plan(64, 24, 250, torch.bfloat16, sms)["smem"]
    monkeypatch.setattr(kernels, "occupancy", lambda *a: (40, smem))
    gru_scan.gru_layer_scan(meta(64, 24, 750, dtype=torch.bfloat16), meta(64, 24), meta(64, 250),
                            meta(250, 750, dtype=torch.bfloat16), meta(750))
    assert calls == [rows]


def test_scan_wrappers_pass_the_reset_stream(no_launch):
    """The reset stream goes to both kernels as the pointer after the mask,
    null without one; launches with it are counted apart."""
    calls = []

    class Lib:
        def vmmt_gru_scan(self, *args):
            calls.append(args[3])
            return 0

        def vmmt_gru_scan_bwd(self, *args):
            # f32: the products on tile_gemm.cuh (tile N and stages 0, then
            # the stream), no Hs, dP or Wh's copy
            assert len(args) == len(kernels.SIGNATURES["gru_scan"]["vmmt_gru_scan_bwd"])
            assert args[-3:-1] == (0, 0) and args[17:20] == (None, None, None)
            calls.append(args[3])
            return 0

    no_launch.setattr(kernels, "library", lambda name: Lib())
    no_launch.setattr(kernels, "stream_of", lambda t: 0)
    smem = {"vmmt_gru_scan_occupancy": gru_scan.scan_fwd_plan(4, 5, 8, torch.float32,
                                                              H100_SMS)["smem"],
            "vmmt_gru_scan_bwd_occupancy": gru_scan.scan_bwd_plan(4, 5, 8, torch.float32)["smem"]}
    no_launch.setattr(kernels, "occupancy", lambda dev, lib, fn, *a: (8, smem[fn]))
    args = scan_args(4, 5, 8)
    fns = (gru_scan.gru_layer_scan, gru_scan.gru_layer_scan_bwd)
    before = [(f.launches, f.reset_launches) for f in fns]
    gru_scan.gru_layer_scan(*args[:5])
    gru_scan.gru_layer_scan(*args[:5], reset=meta(4, 5))
    gru_scan.gru_layer_scan_bwd(*args)
    gru_scan.gru_layer_scan_bwd(*args, reset=meta(4, 5))
    assert calls[0] is None and calls[1] is not None
    assert calls[2] is None and calls[3] is not None
    assert [(f.launches, f.reset_launches) for f in fns] == [(n + 2, r + 1) for n, r in before]
    with pytest.raises(ValueError):
        gru_scan.gru_layer_scan(*args[:5], reset=meta(4, 6))


def fwd_args(B, T, S, H, dt=torch.float32):
    return decoder_args(B, T, S, H, dt)[:14] + (meta(B, S),)


def test_decoder_fwd_refuses_a_shape_before_launching(no_launch):
    # every H >= 1 has a plan (H = 2000 the streamed one): H = 0 has none
    for dt in DTYPES:
        with pytest.raises(NotImplementedError):
            decoder.decoder_fwd(*fwd_args(4, 5, 3, 0, dt))


def test_decoder_fwd_refuses_what_the_card_cannot_hold_at_once(no_launch):
    """The forward's cooperative grid is not co-resident: the wrapper raises
    before launching; it never runs anything else in the kernel's place."""
    plan = decoder.decoder_fwd_plan(4, 3, 8, torch.float32, H100_SMS)
    no_launch.setattr(kernels, "occupancy", lambda *a: (plan["grid"] - 1, plan["smem"]))
    with pytest.raises(NotImplementedError, match="at once"):
        decoder.decoder_fwd(*fwd_args(4, 5, 3, 8))
    no_launch.setattr(kernels, "sm_count", lambda device: 114)
    smem = decoder.decoder_fwd_plan(64, 24, 500, torch.float32, 114)["smem"]
    no_launch.setattr(kernels, "occupancy", lambda *a: (114, smem))
    with pytest.raises(NotImplementedError, match="at once"):
        decoder.decoder_fwd(*fwd_args(64, 25, 24, 500))


def test_decoder_fwd_checks_the_plan_against_the_kernels_count(no_launch):
    no_launch.setattr(kernels, "occupancy", lambda *a: (1000, 1))
    with pytest.raises(RuntimeError, match="shared"):
        decoder.decoder_fwd(*fwd_args(4, 5, 3, 8))


@pytest.mark.parametrize("dt,sms,grid", [(torch.bfloat16, H100_SMS, 126),
                                         (torch.bfloat16, 114, 64),
                                         (torch.float16, H100_SMS, 126),
                                         (torch.float16, 114, 64),
                                         (torch.float32, H100_SMS, 125)], ids=str)
def test_decoder_fwd_launches_once_with_the_plan(monkeypatch, dt, sms, grid):
    """One launch a call, with the plan's units, rows and grid (the card's
    SM count decides the rows), and the plan kept in decoder_fwd.plan."""
    calls = []

    class Lib:
        def vmmt_decoder_fwd(self, *args):
            calls.append(args[-4:-1])  # ..., units, rows, grid, stream
            return 0

    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    monkeypatch.setattr(kernels, "sm_count", lambda device: sms)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    plan = decoder.decoder_fwd_plan(64, 24, 500, dt, sms)
    monkeypatch.setattr(kernels, "occupancy", lambda *a: (sms, plan["smem"]))
    before = decoder.decoder_fwd.launches
    decoder.decoder_fwd(*fwd_args(64, 25, 24, 500, dt))
    assert calls == [(plan["units"], plan["rows"], grid)]
    assert decoder.decoder_fwd.launches == before + 1
    assert decoder.decoder_fwd.plan == dict(plan, sms=sms, max_co_resident=sms)


def test_decoder_probe_must_hold_every_stamp(no_launch):
    plan = decoder.decoder_fwd_plan(4, 3, 8, torch.float32, H100_SMS)
    no_launch.setattr(kernels, "occupancy", lambda *a: (1000, plan["smem"]))
    assert decoder.probe_len(5) == 2 + 2 * decoder.DEC_PHASES * 5
    for bad in (meta(decoder.probe_len(5) - 1, dtype=torch.int64), meta(decoder.probe_len(5))):
        with pytest.raises(ValueError, match="probe"):
            decoder.decoder_fwd(*fwd_args(4, 5, 3, 8), probe=bad)
        with pytest.raises(ValueError, match="probe"):
            decoder.decoder_bwd(*decoder_args(4, 5, 3, 8), probe=bad)


# --- widths: the scans up to 1024 units, the decoder kernels at any width ---

SCAN_WIDTHS = [257, 300, 384, 448, 512]


# the forward's rule on an H100 (PERF.md, the crossover sweep): its cluster
# plan where the card holds the clusters at once, else the tiled plan
FWD_RULE = {  # (B, H) -> bf16 and f16's layout, f32's
    (1, 257): ("cluster", "cluster"), (61, 257): ("cluster", "cluster"),
    (64, 257): ("cluster", "cluster"), (256, 257): ("tiled", "tiled"),
    (1, 300): ("cluster", "cluster"), (61, 300): ("cluster", "tiled"),
    (64, 300): ("cluster", "tiled"), (256, 300): ("tiled", "tiled"),
    (1, 384): ("cluster", "cluster"), (61, 384): ("cluster", "tiled"),
    (64, 384): ("cluster", "tiled"), (256, 384): ("tiled", "tiled"),
    (1, 448): ("cluster", "cluster"), (61, 448): ("cluster", "tiled"),
    (64, 448): ("cluster", "tiled"), (256, 448): ("tiled", "tiled"),
    (1, 512): ("cluster", "cluster"), (61, 512): ("tiled", "tiled"),
    (64, 512): ("tiled", "tiled"), (256, 512): ("tiled", "tiled")}


# the backward's rule on an H100 (PERF.md, the card's clusters at once):
# its cluster plan where the card holds the clusters at once (4-row
# clusters: 16 at B = 61 and 64, 64 at B = 256), else the tiled plan
BWD_RULE = {  # (B, H) -> bf16 and f16's layout, f32's
    **{(1, H): ("cluster", "cluster") for H in SCAN_WIDTHS},
    **{(256, H): ("tiled", "tiled") for H in SCAN_WIDTHS},
    **{(B, H): ("cluster" if H <= 384 else "tiled", "cluster" if H == 257 else "tiled")
       for B in (61, 64) for H in SCAN_WIDTHS}}


@pytest.mark.parametrize("B", [1, 61, 64, 256])
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("H", SCAN_WIDTHS)
def test_scan_plans_hold_the_wide_widths(H, dt, B):
    """Both scans plan every width up to 512 in bf16, f16 and f32. The
    backward's cluster plan on clusters of ceil(H / 32) CTAs (up to 16,
    non-portable), shared memory within a CTA's (f32 at 512 with 2 rows),
    taken where its clusters run in one wave (BWD_RULE). The forward on
    clusters where they run in one wave on an H100 (16 CTAs: 7 at once, so
    B = 61 and 64 at 449-512 units take the tiled plan; 9-14 CTAs hold 2 an
    SM, 14-23 clusters at once, so B = 256's 32 clusters take it from 257
    units); in f32, whose CTAs take one an SM from 225 units, clusters at B
    = 1 and, 9 clusters of 9 CTAs fitting at once, at 257 units."""
    fwd = gru_scan.scan_fwd_plan(B, 24, H, dt, H100_SMS)
    bwd = gru_scan._cluster_bwd_plan(B, H, dt, H100_SMS)
    want = FWD_RULE[(B, H)][dt == torch.float32]
    assert fwd["layout"] == want
    assert gru_scan.scan_bwd_plan(B, 24, H, dt)["layout"] == BWD_RULE[(B, H)][dt == torch.float32]
    plans = (fwd, bwd) if want == "cluster" else (bwd,)
    for plan in plans:
        assert plan["cluster"] == -(-H // 32) <= gru_scan.SCAN_BWD_MAX_CLUSTER == 16
        assert plan["cluster"] * plan["units"] >= H > (plan["cluster"] - 1) * plan["units"]
        assert plan["clusters"] * plan["rows"] >= B > (plan["clusters"] - 1) * plan["rows"]
        assert 0 < plan["smem"] <= kernels.SMEM_PER_BLOCK
    if want == "cluster":
        assert gru_scan.fwd_cluster_waves(fwd, H100_SMS) == 1
    else:  # the cluster plan it passed over runs in waves; the tiled grid in one
        assert gru_scan.fwd_cluster_waves(gru_scan._cluster_fwd_plan(B, H, dt, H100_SMS),
                                          H100_SMS) > 1
        assert fwd["grid"] <= gru_scan.tiled_co_resident(fwd["cluster"], H100_SMS)
        assert fwd["chunks"] == 1
    assert gru_scan.scan_kernel_holds(H, dt)
    if dt == torch.float32 and H > 448:
        assert gru_scan._cluster_fwd_plan(B, H, dt, H100_SMS)["rows"] == 4 and bwd["rows"] == 2


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("H", [448, 480, 500, 512])
@pytest.mark.parametrize("B", [64, 256])
def test_scan_bwd_plan_takes_the_tiled_plan_in_waves(B, H, dt):
    """From 449 units the backward's cluster plan runs 16-CTA clusters (15
    at 449-480), fewer of which an H100 holds at once than B = 64 or 256
    needs (``bwd_cluster_waves`` on the card's counts): the plan takes the
    tiled one there, a grid the card holds at once in one launch, as a
    cached copy; where one wave holds the clusters it keeps them."""
    cluster = gru_scan._cluster_bwd_plan(B, H, dt, H100_SMS)
    assert cluster["cluster"] == -(-H // 32) and cluster["clusters"] == -(-B // cluster["rows"])
    waves = gru_scan.bwd_cluster_waves(cluster, H100_SMS)
    plan = gru_scan.scan_bwd_plan(B, 24, H, dt, H100_SMS)
    assert plan["layout"] == ("tiled" if waves > 1 else "cluster")
    assert waves > 1  # on an H100 none of these holds its clusters in one wave
    assert plan["grid"] <= gru_scan.tiled_co_resident(plan["cluster"], H100_SMS)
    assert plan == gru_scan.tiled_bwd_plan(B, 24, H, dt, H100_SMS)
    plan["layout"] = "changed"
    assert gru_scan.scan_bwd_plan(B, 24, H, dt, H100_SMS)["layout"] == "tiled"
    # B = 32 at 449-512 units: 8 clusters, held at once only where two CTAs
    # fit an SM
    few = gru_scan._cluster_bwd_plan(32, H, dt, H100_SMS)
    assert gru_scan.scan_bwd_plan(32, 24, H, dt, H100_SMS)["layout"] == \
        ("cluster" if gru_scan.bwd_cluster_waves(few, H100_SMS) == 1 else "tiled")


def test_scan_plans_mirror_the_kernels_layout_at_512():
    """H=512: the forward's cluster plan (which B = 64 passes over for the
    tiled one on an H100) in bf16 96 columns of Wh and two 8-slot buffers
    at the mma stride 520 plus the partial products; in f32 with 4 slots;
    bf16 backward 32 rows of Wh at stride 1544 and 4 rows of dh_proj, f32
    backward 32 rows of 1536 floats and 2 rows."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert gru_scan._cluster_fwd_plan(64, 512, bf16, H100_SMS)["smem"] == \
        96 * 520 * 2 + 2 * 8 * 520 * 2 + 4 * 96 * 8 * 4 == 128768
    assert gru_scan._cluster_fwd_plan(64, 512, f32, H100_SMS)["smem"] == \
        96 * 512 * 4 + 2 * 4 * 512 * 4 + 4 * 96 * 4 * 4 == 219136
    assert gru_scan._cluster_bwd_plan(64, 512, bf16, H100_SMS)["smem"] == \
        32 * 1544 * 2 + 2 * 4 * 1544 * 2 + 2 * 4 * 32 * 4 + 4 * 32 * 4 * 4 == 126592
    assert gru_scan._cluster_bwd_plan(64, 512, f32, H100_SMS)["smem"] == \
        32 * 1536 * 4 + 2 * 2 * 1536 * 4 + 2 * 2 * 32 * 4 == 221696


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("H,holds", [(1, True), (448, True), (449, True), (512, True),
                                     (513, True), (1024, True), (1025, True), (2048, True),
                                     (0, False)])
def test_scan_kernel_holds_ends_at_1024(dt, H, holds):
    """The backward on clusters to 512 units, the tiled plan above; the
    forward at B = 64 on clusters to 448 units in bf16 and f16, where 8
    clusters of 14 CTAs fit an H100 at once, and tiled from 449, where
    clusters of 15 and 16 run in two waves; in f32, whose clusters of 8 and
    more take an SM each, on clusters to 32 units (2 of 4 rows' CTAs an SM)
    here at H = 1 only; both tiled above 512. Only H = 0 is not held."""
    assert gru_scan.scan_kernel_holds(H, dt) is holds
    if holds:
        fwd = "cluster" if H <= 448 and dt != torch.float32 or H == 1 else "tiled"
        assert gru_scan.scan_fwd_plan(64, 24, H, dt, H100_SMS)["layout"] == fwd
        # the backward's 16 clusters at B = 64 fit at once to 384 units
        # (12 CTAs, 2 an SM: 16 at once) in bf16 and f16
        assert gru_scan.scan_bwd_plan(64, 24, H, dt)["layout"] == \
            ("cluster" if H == 1 else "tiled")


@pytest.mark.parametrize("plan_of", [gru_scan.scan_fwd_plan, gru_scan.scan_bwd_plan])
@pytest.mark.parametrize("H", [250, 512, 1024])
def test_scan_plans_are_cached_copies(plan_of, H):
    """The plans are cached by their arguments, and each call returns a copy
    that a caller may change without changing the next call's plan."""
    first = plan_of(64, 24, H, torch.bfloat16, H100_SMS)
    want = dict(first)
    first["layout"] = "changed"
    again = plan_of(64, 24, H, torch.bfloat16, H100_SMS)
    assert again == want and again is not first
    if plan_of is gru_scan.scan_bwd_plan and want["layout"] == "cluster":  # dWh's split: B * T
        assert plan_of(64, 1, H, torch.bfloat16, H100_SMS)["dwh_splits"] < want["dwh_splits"]


@pytest.mark.parametrize("H,kernel", [(512, True), (513, True), (1024, True), (1025, True)])
def test_unigru_routes_a_wide_layer_to_the_plain_scan(monkeypatch, caplog, H, kernel):
    """``use_pallas`` sends a GRU layer of any width to the scan kernels:
    none takes ``cell_layer_scan``, and nothing is logged."""
    import variational_mmt_torch.ops.gru_scan as ops_scan

    calls = []
    monkeypatch.setattr(ops_scan, "gru_layer_scan_ad",
                        lambda *a, **k: calls.append("kernel") or (a[0][..., :H], a[2]))
    monkeypatch.setattr(gru_mod, "cell_layer_scan",
                        lambda x, h0, *a, **k: calls.append("plain") or (x[..., :H], h0))
    layer = gru_mod.UniGRU(3, H, use_pallas=True)
    torch.nn.init.zeros_(layer.hh_kernel)
    torch.nn.init.zeros_(layer.hh_bias)
    x, mask = torch.zeros(2, 4, 3), torch.ones(2, 4)
    with caplog.at_level(logging.WARNING, logger=gru_mod.__name__):
        layer(x, mask)
        layer(x, mask)
    assert calls == (["kernel", "kernel"] if kernel else ["plain", "plain"])
    assert caplog.records == []


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("H,Hp", [(250, 252), (6, 8), (2, 4)])
def test_decoder_kernel_plans_pad_the_width(dt, H, Hp):
    """Rows 3-6 plan a width that is not a multiple of 4 at its padding."""
    cell = ds.step_cell_plan(128, H, dt)
    fwd = decoder.decoder_fwd_plan(64, 24, H, dt, H100_SMS)
    bwd = decoder.decoder_bwd_plan(64, 24, H, dt, H100_SMS)
    assert cell["padded"] == fwd["padded"] == bwd["padded"] == ds.padded_width(H) == Hp
    assert cell == ds.step_cell_plan(128, Hp, dt)
    assert fwd == decoder.decoder_fwd_plan(64, 24, Hp, dt, H100_SMS)
    assert bwd == decoder.decoder_bwd_plan(64, 24, Hp, dt, H100_SMS)
    assert fwd["unit_tiles"] * fwd["units"] >= Hp


@pytest.mark.parametrize("H", [250, 6])
def test_decoder_wrappers_launch_at_the_padded_width(monkeypatch, H):
    """The step, chain and both decoder kernels get H padded to a multiple
    of 4 and hand back outputs of width H."""
    Hp = ds.padded_width(H)
    seen = []

    class Lib:
        def vmmt_gru_chain(self, *args):
            seen.append(("chain", args[-2]))
            return 0

        def vmmt_decode_step(self, *args):
            seen.append(("step", args[-2]))
            return 0

        def vmmt_decoder_fwd(self, *args):
            seen.append(("fwd", args[-5]))
            return 0

        def vmmt_decoder_bwd(self, *args):
            seen.append(("bwd", args[-5]))
            return 0

    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    monkeypatch.setattr(kernels, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "aligned", lambda t: t.contiguous())
    smem = {"vmmt_step_cell_occupancy": ds.step_cell_plan(4, Hp, torch.float32)["smem"],
            "vmmt_decoder_fwd_occupancy":
                decoder.decoder_fwd_plan(4, 3, Hp, torch.float32, H100_SMS)["smem"],
            "vmmt_decoder_bwd_occupancy":
                decoder.decoder_bwd_plan(4, 3, Hp, torch.float32, H100_SMS)["smem"]}
    monkeypatch.setattr(kernels, "occupancy", lambda dev, lib, fn, *a: (1000, smem[fn]))
    chain = step_args(4, 3, H)
    h0n, h1n = ds.gru_chain(*chain)
    outs = ds.decode_step(*chain, meta(4, 3, H), meta(4, 3, H), meta(H, H), meta(4, 3))
    fwd = decoder.decoder_fwd(*fwd_args(4, 5, 3, H))
    bwd = decoder.decoder_bwd(*decoder_args(4, 5, 3, H))
    assert seen == [("chain", Hp), ("step", Hp), ("fwd", Hp), ("bwd", Hp)]
    assert [tuple(t.shape) for t in (h0n, h1n) + outs] == [(4, H)] * 5 + [(4, 3)]
    assert [tuple(t.shape) for t in fwd] == [(4, 5, H)] * 3 + [(4, 5, 3)]
    assert [tuple(t.shape) for t in bwd] == [(4, 5, 3 * H)] * 4 + [(4, 5, H), (4, 5, 3),
                                                                   (4, H), (4, H)]


@pytest.mark.parametrize("B", [1, 61, 64, 256, 1000])
@pytest.mark.parametrize("H", [6, 250, 500, 512, 513, 1000, 1024, 1025, 2048])
def test_float16_plans_equal_bf16s(H, B):
    """float16 runs bf16's tensor-core tiling in every kernel (``is_mma`` of
    csrc/tile_gemm.cuh): every launch plan, cluster and tiled for the
    scans, the decode step's cells and both decoder kernels, is the
    bf16 plan, and differs from f32's where f32 tiles for FMAs."""
    f16, bf16 = torch.float16, torch.bfloat16
    for sms in (H100_SMS, 114):
        assert gru_scan.scan_fwd_plan(B, 24, H, f16, sms) == \
            gru_scan.scan_fwd_plan(B, 24, H, bf16, sms)
        assert gru_scan.scan_bwd_plan(B, 24, H, f16, sms) == \
            gru_scan.scan_bwd_plan(B, 24, H, bf16, sms)
    assert gru_scan.scan_kernel_holds(H, f16) == gru_scan.scan_kernel_holds(H, bf16)
    assert ds.step_cell_plan(4 * B, H, f16) == ds.step_cell_plan(4 * B, H, bf16)
    for plan in (decoder.decoder_fwd_plan, decoder.decoder_bwd_plan):
        for sms in (H100_SMS, 114):
            try:
                want = plan(B, 24, H, bf16, sms)
            except NotImplementedError:
                with pytest.raises(NotImplementedError):
                    plan(B, 24, H, f16, sms)
                continue
            assert plan(B, 24, H, f16, sms) == want
    assert kernels.mma_dtype(f16) and kernels.mma_dtype(bf16)
    assert not kernels.mma_dtype(torch.float32)
    assert ds.step_cell_plan(4 * B, H, f16) != ds.step_cell_plan(4 * B, H, torch.float32)
