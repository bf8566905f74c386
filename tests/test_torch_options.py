"""PyTorch port: the model options' modules against the JAX package on tiny
shapes, f32, inputs from numpy seeds:

- ``lstm_gates`` and ``cell_layer_scan`` with LSTM cells, with
  ``init_seq`` (a reset replaces the carry by a given state), and both,
  forward and reverse: 1e-5 absolute and relative;
- ``GlobalAttention`` with dot and mlp scores, one step and a sequence of
  11 query positions (JAX's chunked mlp branch, more than 8), and the
  region pool ``RegionAttentionPool``: outputs and the gradients of every
  input and parameter at 1e-5;
- the ``input_feed=False`` decoder with ``use_pallas``: each layer goes
  through ``gru_layer_scan_ad`` (the plain versions of the GRU-scan
  kernels on the CPU) from its nonzero init state, against JAX's decoder
  with its Pallas kernel in interpret mode: the attentional hiddens, the
  alignments and the gradients of ``ih_emb``, ``ih_mid0``, every
  ``hh_kernel``/``hh_bias``, the attention and the init states (what
  reaches the bridge) at 1e-5;
- ``tools/embeddings_to_npy.py`` of the port writes the same ``.npy`` as
  the root tool, byte for byte;
- a decoder layer too wide for the scan kernels is logged naming its role.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variational_mmt_tpu.models import gru as jax_gru
from variational_mmt_tpu.models.attention import GlobalAttention as JaxAttention
from variational_mmt_tpu.models.decoder import GRUDecoder as JaxDecoder
from variational_mmt_tpu.models.latent import RegionAttentionPool as JaxRegionPool
from variational_mmt_torch.convert import flatten
from variational_mmt_torch.models import gru as gru_mod
from variational_mmt_torch.models.attention import GlobalAttention
from variational_mmt_torch.models.decoder import GRUDecoder
from variational_mmt_torch.models.gru import cell_layer_scan, lstm_gates
from variational_mmt_torch.models.latent import RegionAttentionPool
from variational_mmt_torch.ops import gru_scan

TOL = dict(rtol=1e-5, atol=1e-5)


def close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), err_msg=name, **TOL)


def load(module: torch.nn.Module, tree) -> torch.nn.Module:
    """The JAX tree's leaves into ``module`` (strict: the same key set)."""
    flat = flatten(jax.device_get(tree))
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in flat.items()})
    return module


def noisy(tree, seed, scale=0.1):
    """JAX's initial parameters plus noise, so that zero biases are not."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a)))
                        .astype(np.float32), tree)


def grads_match(module: torch.nn.Module, jax_grads):
    want = flatten(jax.device_get(jax_grads))
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for k in sorted(want):
        close(got[k], want[k], k)


def test_lstm_gates_match_jax():
    rng = np.random.default_rng(0)
    H = 6
    xp, hp = (rng.standard_normal((3, 4 * H)).astype(np.float32) for _ in range(2))
    c = rng.standard_normal((3, H)).astype(np.float32)
    want = jax_gru.lstm_gates(jnp.asarray(xp), jnp.asarray(hp), jnp.asarray(c))
    got = lstm_gates(*map(torch.from_numpy, (xp, hp, c)))
    for g, w in zip(got, want):
        close(g, w)


def scan_inputs(cell, seed, B=4, T=7, H=8):
    rng = np.random.default_rng(seed)
    G = 4 if cell == "lstm" else 3
    C = 2 * H if cell == "lstm" else H
    xp = rng.standard_normal((B, T, G * H)).astype(np.float32)
    carry0 = (0.5 * rng.standard_normal((B, C))).astype(np.float32)
    wh = (rng.standard_normal((H, G * H)) / np.sqrt(H)).astype(np.float32)
    bh = (0.1 * rng.standard_normal(G * H)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 5:] = 0.0
    mask[3, 2:] = 0.0
    reset = np.zeros((B, T), np.float32)
    reset[:, 0] = 1.0
    reset[0, 3] = reset[2, 4] = reset[1, 6] = 1.0  # the last on a masked step
    init_seq = rng.standard_normal((B, T, H)).astype(np.float32)
    return xp, carry0, wh, bh, mask, reset, init_seq


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("cell,extras", [
    ("lstm", ()), ("lstm", ("mask",)), ("lstm", ("reset",)), ("lstm", ("mask", "reset")),
    ("lstm", ("reset", "init_seq")), ("gru", ("reset", "init_seq")),
    ("lstm", ("mask", "reset", "init_seq")),
], ids=lambda x: x if isinstance(x, str) else "+".join(x) or "plain")
def test_cell_layer_scan_matches_jax(cell, extras, reverse):
    xp, carry0, wh, bh, mask, reset, init_seq = scan_inputs(cell, seed=1)
    kw = {k: v for k, v in (("mask", mask), ("reset", reset), ("init_seq", init_seq))
          if k in extras}
    want = jax_gru.cell_layer_scan(*map(jnp.asarray, (xp, carry0, wh, bh)), cell,
                                   reverse=reverse, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = cell_layer_scan(*map(torch.from_numpy, (xp, carry0, wh, bh)), reverse=reverse,
                          cell_type=cell, **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got[1].shape == carry0.shape
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("T", [1, 11], ids=["step", "seq11"])
@pytest.mark.parametrize("attn_type", ["dot", "mlp"])
def test_attention_matches_jax_with_gradients(attn_type, T):
    B, S, H = 3, 5, 8
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, H) if T == 1 else (B, T, H)).astype(np.float32)
    mem = rng.standard_normal((B, S, H)).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    mask[1, 3:] = mask[2, 1:] = 0.0
    w_out = rng.standard_normal(q.shape).astype(np.float32)
    w_align = rng.standard_normal(q.shape[:-1] + (S,)).astype(np.float32)
    jmod = JaxAttention(H, attn_type)
    tree = noisy(jmod.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(mem),
                           jnp.asarray(mask))["params"], seed=3)

    def jloss(p, q_, m_):
        h, a = jmod.apply({"params": p}, q_, m_, jnp.asarray(mask))
        return (h * w_out).sum() + (a * w_align).sum(), (h, a)

    (_, (want_h, want_a)), (gp, gq, gm) = jax.value_and_grad(jloss, (0, 1, 2), has_aux=True)(
        tree, jnp.asarray(q), jnp.asarray(mem))
    mod = load(GlobalAttention(H, attn_type), tree)
    assert hasattr(mod, "linear_in") is False
    tq, tm = (torch.from_numpy(a).requires_grad_() for a in (q, mem))
    h, a = mod(tq, tm, torch.from_numpy(mask))
    ((h * torch.from_numpy(w_out)).sum() + (a * torch.from_numpy(w_align)).sum()).backward()
    close(h, want_h)
    close(a, want_a)
    close(tq.grad, gq)
    close(tm.grad, gm)
    grads_match(mod, gp)
    # hoisted keys give the step's scores as the decode loop uses them
    with torch.no_grad():
        h2, _ = mod(tq, tm, torch.from_numpy(mask), keys=mod.project_memory(tm))
    close(h2, want_h)


def test_region_attention_pool_matches_jax_with_gradients():
    B, R, D, H, A = 3, 5, 6, 8, 4
    rng = np.random.default_rng(4)
    img = rng.standard_normal((B, R, D)).astype(np.float32)
    query = rng.standard_normal((B, H)).astype(np.float32)
    w = rng.standard_normal((B, D)).astype(np.float32)
    jmod = JaxRegionPool(A)
    tree = noisy(jmod.init(jax.random.PRNGKey(1), jnp.asarray(img), jnp.asarray(query))
                 ["params"], seed=5)

    def jloss(p, i_, q_):
        out = jmod.apply({"params": p}, i_, q_)
        return (out * w).sum(), out

    (_, want), (gp, gi, gq) = jax.value_and_grad(jloss, (0, 1, 2), has_aux=True)(
        tree, jnp.asarray(img), jnp.asarray(query))
    mod = load(RegionAttentionPool(D, H, A), tree)
    ti, tq = (torch.from_numpy(a).requires_grad_() for a in (img, query))
    out = mod(ti, tq)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.dtype == torch.float32 and out.shape == (B, D)
    close(out, want)
    close(ti.grad, gi)
    close(tq.grad, gq)
    grads_match(mod, gp)


def test_no_input_feed_decoder_on_the_scan_kernels_matches_jax_interpret(monkeypatch):
    """JAX runs each layer through its Pallas GRU scan (interpret mode on
    the CPU); the port through ``gru_layer_scan_ad`` (the kernels' plain
    versions here), from the bridge's nonzero states."""
    B, T, S, E, H, L = 3, 6, 5, 8, 16, 2
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((B, T, E)).astype(np.float32)
    mem = rng.standard_normal((B, S, H)).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    mask[2, 3:] = 0.0
    init = [np.tanh(rng.standard_normal((B, H))).astype(np.float32) for _ in range(L)]
    w_out = rng.standard_normal((B, T, H)).astype(np.float32)
    w_align = rng.standard_normal((B, T, S)).astype(np.float32)
    jmod = JaxDecoder(H, L, 0.0, "general", False, jnp.float32, use_pallas=True)
    tree = noisy(jmod.init(jax.random.PRNGKey(2), jnp.asarray(emb), jnp.asarray(mem),
                           jnp.asarray(mask), [jnp.asarray(i) for i in init])["params"], seed=7)
    assert "ih_feed" not in tree["step"]

    def jloss(p, hs):
        h, a = jmod.apply({"params": p}, jnp.asarray(emb), jnp.asarray(mem), jnp.asarray(mask),
                          list(hs))
        return (h * w_out).sum() + (a * w_align).sum(), (h, a)

    (_, (want_h, want_a)), (gp, ghs) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        tree, tuple(jnp.asarray(i) for i in init))
    calls = []
    real = gru_scan.gru_layer_scan_ad
    monkeypatch.setattr(gru_scan, "gru_layer_scan_ad",
                        lambda *a, **k: calls.append(a[2].shape) or real(*a, **k))
    mod = load(GRUDecoder(E, H, L, input_feed=False, use_pallas=True), tree)
    ths = [torch.from_numpy(i).requires_grad_() for i in init]
    h, a = mod(torch.from_numpy(emb), torch.from_numpy(mem), torch.from_numpy(mask), ths)
    ((h * torch.from_numpy(w_out)).sum() + (a * torch.from_numpy(w_align)).sum()).backward()
    assert calls == [(B, H)] * L  # one kernel scan a layer, from its init state
    close(h, want_h)
    close(a, want_a)
    grads_match(mod, gp)
    for l in range(L):
        assert float(ths[l].grad.abs().max()) > 0.0
        close(ths[l].grad, ghs[l], f"dh0 of layer {l}")


def test_embeddings_to_npy_writes_the_root_tools_file(tmp_path):
    import importlib

    from variational_mmt_torch.data.vocab import SPECIALS, Vocab
    from variational_mmt_torch.tools import embeddings_to_npy

    root_tool = importlib.import_module("tools.embeddings_to_npy")
    Vocab(SPECIALS + ["alpha", "beta", "gamma", "delta"]).save(str(tmp_path / "v.json"))
    (tmp_path / "glove.txt").write_text("alpha 1 0.5 -2\ngamma 9 9 9\nbad x y z\n"
                                        "beta 0.25 0.125 3\nshort 1\n")
    (tmp_path / "w2v.txt").write_text("2 3\ndelta 1 2 3\nalpha 4 5 6\n")
    for emb, extra in (("glove.txt", []), ("w2v.txt", ["-seed", "3"]),
                       ("glove.txt", ["-emb_dim", "3", "-seed", "7"])):
        outs = []
        for name, tool in (("root", root_tool), ("port", embeddings_to_npy)):
            out = tmp_path / f"{name}.npy"
            tool.main(["-emb_file", str(tmp_path / emb), "-vocab", str(tmp_path / "v.json"),
                       "-output", str(out), *extra])
            outs.append(out.read_bytes())
        assert outs[0] == outs[1], (emb, extra)


def test_a_wide_decoder_layer_is_logged_naming_the_decoder(monkeypatch, caplog):
    monkeypatch.setattr(gru_mod, "_wide_logged", set())
    with caplog.at_level(logging.WARNING, logger=gru_mod.__name__):
        for role in ("decoder", "encoder", "decoder"):
            assert gru_mod.scan_route(1025, torch.float32, role) is False
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 2
    assert msgs[0].startswith("decoder GRU layer of 1025 units")
    assert msgs[1].startswith("encoder GRU layer of 1025 units")
