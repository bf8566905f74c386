"""PyTorch port: the decoder kernels' width padding, on the CPU. The
decode-step, GRU-chain and decoder sequence kernels compute a width that is
a multiple of 4; their wrappers zero-pad H up to one (weights' hidden rows
and gate columns, biases, states, dmid, keys, mem_v and, backward, the
saved streams and d_attn) and slice the outputs back. Here each kernel's
plain version, run on the padded inputs and sliced, equals the plain
version on the unpadded inputs in f32, forward and backward, and the padded
units stay exactly 0, and so do their cotangents. The real units agree to
f32 rounding, not to the bit: the CPU's products and sums over H block a
reduction of 250 values and one of 252 (and the 3H and 3Hp output columns)
differently, which moves the last bits (a few 1e-8 here; the tolerance is
stated at each check)."""

import numpy as np
import pytest
import torch

from variational_mmt_torch.ops import decode_step as ds
from variational_mmt_torch.ops import decoder

f32 = torch.float32


def arrays(seed, *shapes, scale=0.5):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)) for s in shapes]


def lecun(t, H):
    """Weights at the flagship initializer's scale (variance 1/fan_in)."""
    return t * (2.0 / H ** 0.5) if t.dim() == 2 and t.shape[0] == H else t


def chain_inputs(N, H, seed):
    w, b = (H, 3 * H), (3 * H,)
    return [lecun(t, H) for t in
            arrays(seed, (N, 3 * H), (N, H), (N, H), (N, H), w, w, b, w, b, w, b)]


def attn_inputs(N, S, H, seed):
    keys, mem_v, wc_q = arrays(seed + 1, (N, S, H), (N, S, H), (H, H))
    wc_q = lecun(wc_q, H)
    mask_bias = torch.zeros(N, S)
    mask_bias[0, S - 1] = -1e9
    return [keys, mem_v, wc_q, mask_bias]


def pad_chain(chain, H, Hp):
    emb_proj, h0, h1, feed, *w = chain
    return [ds.pad_units(emb_proj, H, Hp, -1, 3), ds.pad_units(h0, H, Hp),
            ds.pad_units(h1, H, Hp), ds.pad_units(feed, H, Hp), *ds.pad_step_weights(*w)]


def pad_attn(attn, H, Hp):
    keys, mem_v, wc_q, mask_bias = attn
    return [ds.pad_units(keys, H, Hp), ds.pad_units(mem_v, H, Hp),
            ds.pad_units(ds.pad_units(wc_q, H, Hp, 0), H, Hp), mask_bias]


def assert_bits(got, want, atol=0.0):
    """Equal bit for bit (atol 0), or within f32 rounding ``atol``."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if atol == 0.0:
            assert torch.equal(g, w), (g - w).abs().max()
        else:
            torch.testing.assert_close(g, w, rtol=0.0, atol=atol)


@pytest.mark.parametrize("H", [250, 6, 2])
def test_padding_is_exact_for_the_step_and_the_chain(H):
    """Rows 3 and 4: the padded plain versions, sliced, are the unpadded
    ones to 1e-6;
    the padded units come out exactly 0."""
    Hp = ds.padded_width(H)
    N, S = 5, 7
    chain, attn = chain_inputs(N, H, 3), attn_inputs(N, S, H, 3)
    pchain, pattn = pad_chain(chain, H, Hp), pad_attn(attn, H, Hp)
    want = ds.decode_step_ref(*chain, *attn)
    got = ds.decode_step_ref(*pchain, *pattn)
    for t in got[:3]:
        assert torch.equal(t[:, H:], torch.zeros_like(t[:, H:]))
    assert_bits([ds.unpad_units(t, H, Hp) for t in got[:3]] + [got[3]], want, atol=1e-6)
    want = ds.gru_chain_ref(*chain)
    got = ds.gru_chain_ref(*pchain)
    assert_bits([ds.unpad_units(t, H, Hp) for t in got], want, atol=1e-6)


def seq_inputs(B, T, S, H, seed):
    emb_proj, h00, h01, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1 = (lecun(t, H) for t in arrays(
        seed, (B, T, 3 * H), (B, H), (B, H), (H, 3 * H), (H, 3 * H), (3 * H,), (H, 3 * H),
        (3 * H,), (H, 3 * H), (3 * H,)))
    keys, mem_v, Wc_q, mask_bias = attn_inputs(B, S, H, seed)
    dmid = (torch.rand(B, T, H, generator=torch.Generator().manual_seed(seed)) < 0.8).float() / 0.8
    return [emb_proj, dmid, h00, h01, Wfeed, Wh0, bh0, Wmid, bmid, Wh1, bh1, keys, mem_v,
            Wc_q], mask_bias


def pad_seq(args, H, Hp):
    emb_proj, dmid, h00, h01, *rest = args
    w = ds.pad_step_weights(*rest[:7], rest[9])
    return [ds.pad_units(emb_proj, H, Hp, -1, 3), ds.pad_units(dmid, H, Hp),
            ds.pad_units(h00, H, Hp), ds.pad_units(h01, H, Hp), *w[:7],
            ds.pad_units(rest[7], H, Hp), ds.pad_units(rest[8], H, Hp), w[7]]


@pytest.mark.parametrize("H", [250, 6, 2])
def test_padding_is_exact_for_the_decoder_sequence(H):
    """Rows 5 and 6: forward streams and every backward output of the padded
    plain versions, sliced, are the unpadded ones to 1e-6 (their sums over
    H); the padded units' streams and cotangents are exactly 0."""
    Hp = ds.padded_width(H)
    B, T, S = 3, 4, 5
    args, mask_bias = seq_inputs(B, T, S, H, 7)
    pargs = pad_seq(args, H, Hp)
    want = decoder.decoder_fwd_ref(*args, mask_bias)
    got = decoder.decoder_fwd_ref(*pargs, mask_bias)
    for t in got[:3]:
        assert torch.equal(t[..., H:], torch.zeros_like(t[..., H:]))
    assert_bits([ds.unpad_units(t, H, Hp) for t in got[:3]] + [got[3]], want, atol=1e-6)
    d_attn, d_probs = arrays(11, (B, T, H), (B, T, S))
    want_b = decoder.decoder_bwd_ref(*args, *want, d_attn, d_probs)
    streams = [ds.pad_units(t, H, Hp) for t in want[:3]] + [want[3]]
    got_b = decoder.decoder_bwd_ref(*pargs, *streams, ds.pad_units(d_attn, H, Hp), d_probs)
    for t, gates in zip(got_b[:4], (3, 3, 3, 3)):
        pads = t.unflatten(-1, (gates, Hp))[..., H:]
        assert torch.equal(pads, torch.zeros_like(pads))
    sliced = ([ds.unpad_units(t, H, Hp, -1, 3) for t in got_b[:4]]
              + [ds.unpad_units(got_b[4], H, Hp), got_b[5]]
              + [ds.unpad_units(t, H, Hp) for t in got_b[6:]])
    assert_bits(sliced, want_b, atol=1e-6)


def test_pad_units_round_trips_gate_blocks():
    t = torch.arange(2 * 3 * 5, dtype=f32).reshape(2, 15)
    p = ds.pad_units(t, 5, 8, -1, 3)
    assert p.shape == (2, 24)
    assert torch.equal(p.reshape(2, 3, 8)[..., :5], t.reshape(2, 3, 5))
    assert torch.equal(p.reshape(2, 3, 8)[..., 5:], torch.zeros(2, 3, 3))
    assert torch.equal(ds.unpad_units(p, 5, 8, -1, 3), t)
    assert ds.pad_units(t, 5, 5, -1, 3) is t
