"""Analytic matmul-FLOP model of the VMMT family, for MFU. Mirrors
``variational_mmt_tpu/utils/flops.py`` (:20-70) over the port's
``ModelConfig``.

Counts only GEMM and contraction FLOPs (2 * M * N * K a product): the
elementwise gate math, softmaxes and reductions are bound by memory, not
by FLOPs. A training step counts as forward + 2x backward (the standard
dense-layer accounting). So this is a lower bound on executed FLOPs, and
the MFU derived from it is conservative.
"""

from __future__ import annotations

from variational_mmt_torch.config import ModelConfig
from variational_mmt_torch.models.gru import n_gates

# NVIDIA's published dense (no sparsity) bf16 tensor-core peak of one H100
# SXM at its 700 W limit, from the data sheet; not a measurement
H100_SXM_BF16_DENSE_PEAK = 989e12


def forward_flops(c: ModelConfig, B: int, L_src: int, L_tgt: int) -> float:
    """Matmul FLOPs of one forward pass over a batch of B pairs padded to
    L_src source and L_tgt target tokens."""
    H, E, V, Z = c.hidden_dim, c.emb_dim, c.tgt_vocab_size, c.latent_dim
    G = n_gates(c.rnn_type)  # 3 (GRU) or 4 (LSTM) gate blocks
    mm = lambda m, n, k: 2.0 * m * n * k
    total = 0.0

    # --- bi-GRU encoder stack: per dir, input proj + hidden proj ---
    for l in range(c.enc_layers):
        d_in = E if l == 0 else 2 * H  # layer l>0 consumes concat(fwd, bwd)
        total += 2 * (mm(B * L_src, G * H, d_in) + mm(B * L_src, G * H, H))

    is_latent = c.model_type in ("vmmt_f", "vmmt_c")
    if is_latent:
        # target encoder (1 bi layer) feeds q(z|x,y,v)
        total += 2 * (mm(B * L_tgt, G * H, E) + mm(B * L_tgt, G * H, H))
        # inference / prior / image heads (MLP trunk + mu/sigma)
        d_img = c.img_feat_dim if c.img_feat_dim > 0 else 0
        total += mm(B, H, 2 * 2 * H + d_img) + 2 * mm(B, Z, H)  # q
        if c.model_type == "vmmt_c":
            total += mm(B, H, 2 * H + d_img) + 2 * mm(B, Z, H)  # p(z|x,v)
        if c.use_img_predict and d_img:
            total += mm(B, H, Z) + mm(B, d_img, H)  # p(v|z)
        if c.z_cond == "init+input":
            total += mm(B, G * H, Z)

    # bridge: enc finals (+z) -> per-layer decoder inits
    zin = Z if is_latent else 0
    total += c.dec_layers * mm(B, H, 2 * H + zin)

    # --- input-feed decoder ---
    total += mm(B * L_tgt, G * H, E)  # hoisted embedding projection
    if c.input_feed:
        total += mm(B * L_tgt, G * H, H)  # feed projection (per step)
    for l in range(c.dec_layers):
        total += mm(B * L_tgt, G * H, H)  # hidden-to-hidden
        if l > 0:
            total += mm(B * L_tgt, G * H, H)  # mid input projection
    # general attention: key projection (per seq) + scores + context + out
    total += mm(B * L_src, H, H)  # keys = mem @ Wq^T
    total += 2 * mm(B * L_tgt, L_src, H)  # scores + context
    total += mm(B * L_tgt, H, 2 * H)  # output projection [ctx; q]

    # generator
    total += mm(B * L_tgt, V, H)
    return total


def train_step_flops(c: ModelConfig, B: int, L_src: int, L_tgt: int) -> float:
    """fwd + bwd ~= 3x forward matmul FLOPs."""
    return 3.0 * forward_flops(c, B, L_src, L_tgt)
