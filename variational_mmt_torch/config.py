"""Model and decode configuration of the PyTorch port.

Mirrors ``variational_mmt_tpu/config.py``: ``ModelConfig`` (:30-109) and
``DecodeConfig`` (:213-268) keep the JAX field names and defaults, so a JSON
config or a checkpoint's config reads the same in both packages. ``Config``
holds only these two sections; the ``train`` and ``data`` sections of a JSON
file are ignored here (training is not ported yet).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class ModelConfig:
    """Architecture hyperparameters (same fields and defaults as JAX)."""

    model_type: str = "vmmt_f"  # nmt | vmmt_f | vmmt_c
    rnn_type: str = "gru"  # gru | lstm
    src_vocab_size: int = 10000
    tgt_vocab_size: int = 10000
    emb_dim: int = 500
    hidden_dim: int = 500
    enc_layers: int = 2
    dec_layers: int = 2
    dropout: float = 0.3
    word_dropout: float = 0.0
    input_feed: bool = True
    attn_type: str = "general"  # general | dot | mlp

    latent_dim: int = 128
    img_feat_dim: int = 2048  # ResNet-50 pool5
    img_feat_type: str = "pool5"  # pool5 | conv
    img_pool: str = "mean"  # mean | attn
    use_img_predict: bool = True
    img_loss: str = "logprob"  # logprob | mse | cosine
    img_loss_weight: float = 1.0
    z_cond: str = "init"  # init | init+input
    min_sigma: float = 1e-3
    share_decoder_embeddings: bool = False
    share_embeddings: bool = False

    compute_dtype: str = "bfloat16"
    use_pallas: bool = False  # hand-written GRU-scan kernel for the encoder
    pallas_decoder: bool = False
    scan_unroll: int = 1
    fused_ce: bool = False
    fused_decoder: bool = False

    def validate(self) -> None:
        for name, allowed in (
            ("model_type", ("nmt", "vmmt_f", "vmmt_c")),
            ("rnn_type", ("gru", "lstm")),
            ("attn_type", ("general", "dot", "mlp")),
            ("img_loss", ("logprob", "mse", "cosine")),
            ("z_cond", ("init", "init+input")),
            ("img_feat_type", ("pool5", "conv")),
            ("img_pool", ("mean", "attn")),
        ):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r}: expected one of {allowed}")
        if self.share_decoder_embeddings and self.emb_dim != self.hidden_dim:
            raise ValueError(
                "share_decoder_embeddings requires emb_dim == hidden_dim "
                f"(got {self.emb_dim} vs {self.hidden_dim})")
        if self.share_embeddings and self.src_vocab_size != self.tgt_vocab_size:
            raise ValueError(
                "share_embeddings requires a shared vocab: src "
                f"{self.src_vocab_size} != tgt {self.tgt_vocab_size}")


@dataclass
class DecodeConfig:
    """Translate-time options (same fields and defaults as JAX)."""

    beam_size: int = 4
    n_best: int = 1
    max_length: int = 100
    min_length: int = 0
    length_penalty: str = "gnmt"  # gnmt | none | average
    alpha: float = 0.6
    coverage_beta: float = 0.0
    batch_size: int = 32
    block_ngram_repeat: int = 0
    ignore_when_blocking: str = ""
    replace_unk: bool = False
    dump_beam: bool = False
    iw_samples: int = 10
    ensemble_mode: str = "prob"
    infer_dtype: str = "float32"
    # decode step: 0 = plain PyTorch step; 1 = the fused decode-step kernel
    # (GRU0 -> GRU1 -> attention); 2 = the GRU-chain kernel with attention
    # in plain PyTorch. Applies to 2-layer GRU + general attention +
    # input_feed models.
    pallas_step: int = 0
    sampling_temp: float = 0.0
    sampling_topk: int = 0
    sampling_topp: float = 0.0
    latent_from: str = "mean"
    decode_seed: int = 1234


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        return cls(model=_from_dict(ModelConfig, d.get("model", {})),
                   decode=_from_dict(DecodeConfig, d.get("decode", {})))

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))


def _from_dict(klass, d: Dict[str, Any]):
    names = {f.name for f in dataclasses.fields(klass)}
    return klass(**{k: v for k, v in d.items() if k in names})
