"""The VMMT model: decode-side methods and the training forward. Mirrors
``variational_mmt_tpu/models/model.py``.

The port covers the three model types:

- ``nmt``: text only; no latent modules, the bridge reads the encoder
  finals alone;
- ``vmmt_f``: latent z with the fixed prior N(0, I) and the inference
  network q(z|x,y,v);
- ``vmmt_c``: the conditional prior p(z|x,v) as well;

with GRU or LSTM cells (``rnn_type``; an LSTM state is ``[h | c]``, the
bridge reads the encoder's ``[h | c]`` finals and starts the cell half at
zero), general, dot or mlp attention (``attn_type``), with or without
input feed, and pool5 or conv image features, conv regions pooled by their
mean or by attention with the source summary as the query (``img_pool``,
``region_pool``).

With ``share_embeddings`` one table, ``tgt_embed``, serves both sides.
z conditions the decoder through the bridge and, with
``z_cond='init+input'``, also through ``z_input_proj``, added to every
step's input projection. The parameters of a JAX tree of any of these
configurations exist here under the same dotted paths, so a tree
round-trips whole through ``convert.py``.

Randomness (dropout, word dropout, the reparameterization noise) comes from
an explicit ``torch.Generator`` passed to ``forward``; JAX's named rng
streams cannot be reproduced, so parity tests run deterministic, with
``sample=False``.

``VMMTModel(cfg, mesh=...)`` with more than one model rank is this rank's
vocab-parallel shard (parallel/tp.py): the embedding tables hold V/n rows,
the generator V/n columns (``tgt_embed``'s rows when tied), and
``vocab_mesh`` is the mesh; the training forward's logits (or, with
``fused_ce``, the loss) are the shard's, and ``decode_step`` gathers each
step's logits to the full V. The rest of the model is replicated.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from variational_mmt_torch.config import ModelConfig
from variational_mmt_torch.data.vocab import PAD, UNK
from variational_mmt_torch.device import resolve_device
from variational_mmt_torch.models.decoder import GRUDecoder, fused_step_eligible
from variational_mmt_torch.models.gru import BiGRUEncoder, masked_mean, n_gates, segment_mean
from variational_mmt_torch.models.latent import (ConditionalPrior, ImagePredictor,
                                                 InferenceNetwork, RegionAttentionPool,
                                                 reparameterize)
from variational_mmt_torch.models.layers import Dense, Embed

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def check_supported(c: ModelConfig) -> None:
    """Validate ``c``: every compute dtype of the JAX package (``DTYPES``)
    runs on the port."""
    c.validate()


class VMMTModel(nn.Module):
    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        check_supported(cfg)
        c = self.cfg = cfg
        dt = self.dt = DTYPES[c.compute_dtype]
        H, E = c.hidden_dim, c.emb_dim
        vm = self.vocab_mesh = mesh if mesh is not None and mesh.n_model > 1 else None
        Vl = c.tgt_vocab_size // vm.n_model if vm is not None else c.tgt_vocab_size
        self.tgt_embed = Embed(c.tgt_vocab_size, E, dt, vm)
        if not c.share_embeddings:  # shared: source ids look up tgt_embed
            self.src_embed = Embed(c.src_vocab_size, E, dt, vm)
        self.encoder = BiGRUEncoder(E, H, c.enc_layers, dt, c.use_pallas, c.dropout,
                                    c.rnn_type)
        self.decoder = GRUDecoder(E, H, c.dec_layers, c.attn_type, dt, c.dropout,
                                  c.use_pallas, c.pallas_decoder, c.fused_decoder,
                                  c.input_feed, c.rnn_type)
        if c.share_decoder_embeddings:
            self.gen_bias = nn.Parameter(torch.empty(Vl))
        else:
            self.generator = Dense(H, Vl, dtype=dt)
        # the bridge reads [final; z] for latent models, the final alone for
        # nmt; an LSTM final is [h | c], (B, 2H)
        final_dim = 2 * H if c.rnn_type == "lstm" else H
        z_dim = c.latent_dim if self.is_latent else 0
        for l in range(c.dec_layers):
            self.add_module(f"bridge{l}", Dense(final_dim + z_dim, H, dtype=dt))
        if self.is_latent:
            use_img = c.img_feat_dim > 0
            self.tgt_encoder = BiGRUEncoder(E, H, 1, dt, c.use_pallas, c.dropout, c.rnn_type)
            self.infnet = InferenceNetwork(H, c.img_feat_dim, c.latent_dim, H, c.min_sigma,
                                           use_img, dt)
            if c.model_type == "vmmt_c":
                self.prior = ConditionalPrior(H, c.img_feat_dim, c.latent_dim, H,
                                              c.min_sigma, use_img, dt)
            if c.use_img_predict:
                self.img_pred = ImagePredictor(c.latent_dim, c.img_feat_dim, H, dt)
            if c.img_pool == "attn":
                self.region_pool = RegionAttentionPool(c.img_feat_dim, H, min(256, H), dt)
            if c.z_cond == "init+input":
                self.z_input_proj = Dense(c.latent_dim, n_gates(c.rnn_type) * H,
                                          use_bias=False, dtype=dt)

    @property
    def is_latent(self) -> bool:
        return self.cfg.model_type in ("vmmt_f", "vmmt_c")

    def embed_src(self, src: torch.Tensor) -> torch.Tensor:
        return (self.tgt_embed if self.cfg.share_embeddings else self.src_embed)(src)

    def encode(self, src: torch.Tensor, generator: Optional[torch.Generator] = None):
        """src (B,S) -> (memory (B,S,H), finals [L x (B,H)], src_mask (B,S),
        src_summary (B,H)). Dropout between layers draws from ``generator``
        (None: deterministic)."""
        src_mask = (src != PAD).float()
        memory, finals = self.encoder(self.embed_src(src), src_mask, generator)
        return memory, finals, src_mask, masked_mean(memory, src_mask)

    def posterior(self, src_summary: torch.Tensor, tgt: torch.Tensor,
                  img: Optional[torch.Tensor], generator: Optional[torch.Generator] = None):
        """q(z|x,y,v) parameters (f32). tgt: gold target ids (B,T), PAD-masked."""
        tgt_mask = (tgt != PAD).float()
        tgt_enc, _ = self.tgt_encoder(self.tgt_embed(tgt), tgt_mask, generator)
        return self.infnet(src_summary, masked_mean(tgt_enc, tgt_mask),
                           self._img_in(img, src_summary))

    def _img_in(self, img: Optional[torch.Tensor],
                query: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """Conv features (B,R,D) pooled to (B,D): by ``region_pool`` with
        ``query`` (the source summary) under ``img_pool='attn'``, else by
        their mean; pool5 features (B,D) as they are."""
        if img is not None and img.dim() == 3:
            if self.cfg.img_pool == "attn" and query is not None:
                return self.region_pool(img, query)
            img = img.mean(dim=1)
        return img

    def prior_params(self, src_summary: torch.Tensor, img: Optional[torch.Tensor]):
        """(mu_p, sigma_p) in f32: the conditional prior p(z|x,v) for
        vmmt_c, N(0, I) for vmmt_f."""
        if self.cfg.model_type == "vmmt_c":
            return self.prior(src_summary, self._img_in(img, src_summary))
        shape = (src_summary.shape[0], self.cfg.latent_dim)
        return (torch.zeros(shape, dtype=torch.float32, device=src_summary.device),
                torch.ones(shape, dtype=torch.float32, device=src_summary.device))

    def prior_latent(self, src_summary: torch.Tensor, img: Optional[torch.Tensor]):
        """Decode-time latent-mean substitution: z = E_p[z]."""
        return self.prior_params(src_summary, img)[0]

    def init_decoder_state(self, finals: List[torch.Tensor], z: Optional[torch.Tensor]):
        """Bridge: encoder finals (+ z) -> per-layer decoder init states;
        for LSTM the bridge sets the hidden half and the cell half starts at
        zero (JAX :163-177)."""
        init_hs = []
        for l in range(self.cfg.dec_layers):
            f = finals[min(l, len(finals) - 1)]
            if z is not None:
                f = torch.cat([f, z.to(f.dtype)], dim=-1)
            h = torch.tanh(getattr(self, f"bridge{l}")(f))
            if self.cfg.rnn_type == "lstm":
                h = torch.cat([h, torch.zeros_like(h)], dim=-1)
            init_hs.append(h)
        return init_hs

    def _gen(self, h: torch.Tensor) -> torch.Tensor:
        """Generator logits in f32 (tied or free kernel): the GEMM in the
        compute dtype, then a cast. Vocab-parallel: this rank's V/n
        columns, the input's gradient summed over the model group."""
        if self.vocab_mesh is not None:
            from variational_mmt_torch.parallel import tp

            h = tp.copy_to_model(h, self.vocab_mesh)
        if self.cfg.share_decoder_embeddings:
            w = self.tgt_embed.embedding.to(self.dt)
            return (h @ w.t()).float() + self.gen_bias
        return self.generator(h).float()

    def z_extra_proj(self, z: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """z's share of every step's input projection (``init+input``),
        else None."""
        if z is not None and self.cfg.z_cond == "init+input":
            return self.z_input_proj(z.to(self.dt))
        return None

    def decode_step(self, carry, tok: torch.Tensor, memory, src_mask, z, keys=None,
                    weights=None):
        """One inference step: tok (N,) -> (carry, logits (N,V) f32, align).
        ``weights``: the decode-step kernels' weights, prepared once a
        request (``GRUDecoder.step_weights``)."""
        carry, (attn_h, align) = self.decoder.one_step(
            carry, self.tgt_embed(tok), memory, src_mask,
            extra_input_proj=self.z_extra_proj(z), keys=keys, weights=weights)
        logits = self._gen(attn_h)
        if self.vocab_mesh is not None:  # the full V: the search runs as on one device
            from variational_mmt_torch.parallel import tp

            logits = tp.gather_vocab(logits, self.vocab_mesh)
        return carry, logits, align

    def project_memory(self, memory: torch.Tensor, with_values: bool = False):
        """The decoder's attention keys; ``with_values`` also ``mem_v``, for
        the fused decode step, which computes only the decoders that
        ``fused_step_eligible`` accepts."""
        c = self.cfg
        if with_values and not fused_step_eligible(c):
            raise ValueError(
                "project_memory(with_values=True) (fused decode step) requires 2-layer GRU + "
                f"general attention + input_feed; got layers={c.dec_layers} "
                f"attn={c.attn_type} cell={c.rnn_type} input_feed={c.input_feed}")
        return self.decoder.project_memory(memory, with_values)

    def init_decode_carry(self, init_hs):
        return self.decoder.init_carry(init_hs)

    def predict_img(self, z: torch.Tensor) -> torch.Tensor:
        """The image prediction of z (the ``img_pred`` head, JAX's
        ``predict_img``, models/model.py:225)."""
        return self.img_pred(z)

    def decode_train(self, tgt_in: torch.Tensor, memory, src_mask, init_hs, z,
                     generator: Optional[torch.Generator] = None,
                     return_pre_gen: bool = False):
        """Teacher-forced decode: (logits (B,T,V) f32 or, with
        ``return_pre_gen`` (fused CE), the decoder outputs (B,T,H); aligns)."""
        outs, aligns = self.decoder(self.tgt_embed(tgt_in), memory, src_mask, init_hs,
                                    generator, extra_input_proj=self.z_extra_proj(z))
        return (outs if return_pre_gen else self._gen(outs)), aligns

    def generator_params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(kernel (H,V), bias (V,)) of the generator, for the fused CE."""
        if self.cfg.share_decoder_embeddings:
            return self.tgt_embed.embedding.t(), self.gen_bias
        return self.generator.kernel, self.generator.bias

    def _latent(self, out: Dict[str, torch.Tensor], src_summary: torch.Tensor,
                mu_q: torch.Tensor, sigma_q: torch.Tensor, v_in: Optional[torch.Tensor],
                sample: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The prior, z (a sample of q or its mean) and the image
        prediction, recorded in ``out``; returns z."""
        mu_p, sigma_p = self.prior_params(src_summary, v_in)
        z = reparameterize(mu_q, sigma_q, generator) if sample else mu_q
        out.update(mu_q=mu_q, sigma_q=sigma_q, mu_p=mu_p, sigma_p=sigma_p, z=z)
        if self.cfg.use_img_predict:
            out["img_pred"] = self.img_pred(z)
            if v_in is not None:
                # the image objective's target is a constant (stop_gradient)
                out["img_target"] = v_in.detach()
        return z

    def forward(self, src: torch.Tensor, tgt_in: torch.Tensor,
                img: Optional[torch.Tensor] = None, deterministic: bool = True,
                sample: bool = True, tgt_out: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Training forward (model.py:231-302): logits (or, with
        ``fused_ce``, the pre-generator ``dec_out``), aligns and, for latent
        models, the latent parameters and the image prediction (nmt emits
        neither); the ELBO is assembled in train/loss.py. ``generator``
        feeds dropout and word dropout (unless ``deterministic``) and the
        noise of ``sample``. ``tgt_out`` is the gold target q conditions on;
        without it tgt_in shifted left stands in."""
        c = self.cfg
        if (not deterministic or sample) and generator is None:
            raise ValueError("forward: dropout and sampling need a torch.Generator")
        drop_gen = None if deterministic else generator
        memory, finals, src_mask, src_summary = self.encode(src, drop_gen)
        out: Dict[str, torch.Tensor] = {}
        z = None
        if self.is_latent:
            # pooled once, with the source summary as the query, and the same
            # vector feeds q, the prior and the image target (JAX :242)
            v_in = self._img_in(img, src_summary)
            gold = tgt_out if tgt_out is not None else torch.cat(
                [tgt_in[:, 1:], torch.zeros_like(tgt_in[:, :1])], dim=1)
            mu_q, sigma_q = self.posterior(src_summary, gold, v_in, drop_gen)
            z = self._latent(out, src_summary, mu_q, sigma_q, v_in, sample, generator)
        if not deterministic and c.word_dropout > 0.0:
            keep = torch.rand(tgt_in.shape, generator=generator, device=tgt_in.device) \
                < 1.0 - c.word_dropout
            drop = ~keep & (tgt_in != PAD)
            drop[:, 0] = False  # never BOS
            tgt_in = torch.where(drop, torch.full_like(tgt_in, UNK), tgt_in)
        init_hs = self.init_decoder_state(finals, z)
        dec, aligns = self.decode_train(tgt_in, memory, src_mask, init_hs, z, drop_gen,
                                        return_pre_gen=c.fused_ce)
        out["dec_out" if c.fused_ce else "logits"] = dec
        out["aligns"] = aligns
        return out

    def forward_packed(self, src: torch.Tensor, tgt_in: torch.Tensor, src_seg: torch.Tensor,
                       tgt_seg: torch.Tensor, seg_first: torch.Tensor, seg_last: torch.Tensor,
                       img: Optional[torch.Tensor] = None, deterministic: bool = True,
                       sample: bool = True, tgt_out: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Training forward over a sequence-packed batch (model.py:308-397):
        rows (B,L) holding up to K sentences each, segment ids src_seg and
        tgt_seg (B,L) (-1 at pads), each segment's first and last source
        position seg_first, seg_last (B,K), image features (B,K,D). The
        per-sentence outputs (latent parameters, z, image prediction) come
        out flattened (B*K, ...), so that the ELBO treats each segment as an
        unpacked row; the token-level ones keep (B,L,...). Per segment the
        math is the unpacked forward's. ``tgt_out`` (the gold target q
        conditions on) is required for latent models; ``generator`` as in
        :meth:`forward`."""
        c = self.cfg
        if (not deterministic or sample) and generator is None:
            raise ValueError("forward_packed: dropout and sampling need a torch.Generator")
        drop_gen = None if deterministic else generator
        B, K = seg_first.shape
        memory, finals = self.encoder(self.embed_src(src), (src_seg >= 0).float(), drop_gen,
                                      seg=src_seg, seg_bounds=(seg_first, seg_last))
        src_summary = segment_mean(memory, src_seg, K).reshape(B * K, -1)
        out: Dict[str, torch.Tensor] = {}
        z = None
        if self.is_latent:
            if tgt_out is None:
                raise ValueError("forward_packed requires tgt_out (the gold target the "
                                 "posterior conditions on)")
            v_in = None if img is None else self._img_in(img.reshape((B * K,) + img.shape[2:]),
                                                         src_summary)
            # q over the packed gold target: a segment-reset encoder, a summary a segment
            tgt_enc, _ = self.tgt_encoder(self.tgt_embed(tgt_out), (tgt_seg >= 0).float(),
                                          drop_gen, seg=tgt_seg)
            tgt_summary = segment_mean(tgt_enc, tgt_seg, K).reshape(B * K, -1)
            mu_q, sigma_q = self.infnet(src_summary, tgt_summary, v_in)
            z = self._latent(out, src_summary, mu_q, sigma_q, v_in, sample, generator)
        if not deterministic and c.word_dropout > 0.0:
            keep = torch.rand(tgt_in.shape, generator=generator, device=tgt_in.device) \
                < 1.0 - c.word_dropout
            # never PAD, never a segment's BOS (a packed row has one a segment)
            edge = torch.full_like(tgt_seg[:, :1], -2)
            start = (tgt_seg >= 0) & (tgt_seg != torch.cat([edge, tgt_seg[:, :-1]], dim=1))
            drop = ~keep & (tgt_in != PAD) & ~start
            tgt_in = torch.where(drop, torch.full_like(tgt_in, UNK), tgt_in)
        init_seg = [h.reshape(B, K, -1) for h in
                    self.init_decoder_state([f.reshape(B * K, -1) for f in finals], z)]
        zp = self.z_extra_proj(z)
        dec, aligns = self.decoder.packed_seq(self.tgt_embed(tgt_in), memory, src_seg, tgt_seg,
                                              init_seg, drop_gen,
                                              None if zp is None else zp.reshape(B, K, -1))
        out["dec_out" if c.fused_ce else "logits"] = dec if c.fused_ce else self._gen(dec)
        out["aligns"] = aligns
        return out


def build_model(cfg: ModelConfig, device=None, mesh=None) -> VMMTModel:
    """The model on ``device`` (default cuda; raises without CUDA unless
    ``device='cpu'``), parameters uninitialized: load them with
    ``load_state_dict(convert.params_from_jax(tree, cfg))`` (through
    ``parallel.tp.shard_params`` for a ``mesh`` of several model ranks)."""
    dev = resolve_device(device)
    return VMMTModel(cfg, mesh).to(dev)


def shard_model(model: VMMTModel, mesh) -> VMMTModel:
    """``model`` itself when ``mesh`` shards nothing (one model rank) or it
    is sharded already, else a new model on ``mesh.device`` holding this
    rank's shard of ``model``'s parameters (parallel/tp.py)."""
    from variational_mmt_torch.parallel import tp

    if tp.vocab_mesh(mesh) is None or model.vocab_mesh is not None:
        return model
    tp.validate_tp_divisibility(model.cfg, mesh.n_model)
    out = VMMTModel(model.cfg, mesh).to(mesh.device)
    out.load_state_dict(tp.shard_params(model.state_dict(), mesh))
    return out


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """{dotted parameter path: shape} of the model, allocated nowhere."""
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in VMMTModel(cfg).state_dict().items()}


def init_params(cfg: ModelConfig, seed: int = 0) -> dict:
    """Random parameters as a JAX-layout tree of numpy f32 arrays, from a
    numpy seed, drawn from the distributions of the flax initializers (not
    the same numbers): Dense and recurrent kernels lecun-normal, a standard
    normal truncated to [-2, 2] and scaled to variance 1/fan_in;
    embeddings normal with std 1/sqrt(E); biases zero."""
    from variational_mmt_torch.convert import unflatten

    rng = np.random.default_rng(seed)
    flat = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        if len(shape) == 1:
            flat[name] = np.zeros(shape, np.float32)
        elif name.endswith("embedding"):
            flat[name] = (rng.standard_normal(shape) / np.sqrt(shape[1])).astype(np.float32)
        else:
            flat[name] = (truncated_normal(rng, shape) / np.sqrt(shape[0])
                          / TRUNC_STD).astype(np.float32)
    return unflatten(flat)


# std of a standard normal truncated to [-2, 2]: the divisor that gives
# flax's truncated lecun-normal its variance 1/fan_in
TRUNC_STD = 0.87962566103423978


def truncated_normal(rng: np.random.Generator, shape: Tuple[int, ...]) -> np.ndarray:
    """Standard normal draws truncated to [-2, 2] (redrawn until inside)."""
    x = rng.standard_normal(shape)
    out = np.abs(x) > 2.0
    while out.any():
        x[out] = rng.standard_normal(int(out.sum()))
        out = np.abs(x) > 2.0
    return x
