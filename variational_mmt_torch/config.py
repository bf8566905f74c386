"""Configuration of the PyTorch port.

Mirrors ``variational_mmt_tpu/config.py``: ``ModelConfig`` (:30-109),
``TrainConfig`` (:110-186), ``DataConfig`` (:189-210), ``DecodeConfig``
(:213-268), ``Config.to_dict`` / ``to_json`` / ``from_json`` and
``update_config`` keep the JAX field names, defaults and JSON form, so a
JSON config or a checkpoint's ``config.json`` reads and writes the same in
both packages.

Every ``TrainConfig`` field is read by the port's trainer and CLI. The
mesh's, ``num_data_shards`` (0: every rank) and ``num_model_shards``,
shape the ``torchrun`` ranks' mesh (parallel/mesh.py, cli/train.py).
``steps_per_call`` is a TPU dispatch knob (optimizer steps per jit call)
and is accepted and ignored: each ``Trainer`` step is one optimizer step.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List


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
    use_pallas: bool = False  # hand-written GRU-scan kernels (forward, backward)
    pallas_decoder: bool = False  # with use_pallas: the decoder sequence kernels
    # for the teacher-forced decoder. Default as in JAX; whether the H100
    # wants it on is open (PERF.md, section 7)
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
class TrainConfig:
    """Optimization and loop hyperparameters (same fields and defaults as
    JAX)."""

    seed: int = 1234
    batch_size: int = 64  # sentences a batch
    max_steps: int = 20000
    epochs: int = 0  # > 0: max_steps = epochs x batches an epoch (the CLI)
    optimizer: str = "adam"  # adam | sgd | adadelta | adagrad
    learning_rate: float = 4e-4
    param_init: float = 0.0  # > 0: every tensor uniform(-r, r) at the start
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    max_grad_norm: float = 5.0
    lr_decay: float = 0.5  # on a validation plateau
    start_decay_at: int = 0
    label_smoothing: float = 0.0
    kl_anneal: str = "linear"  # linear | sigmoid | none
    kl_anneal_steps: int = 10000
    kl_anneal_start: int = 0
    kl_free_bits: float = 0.0
    fix_word_vecs_enc: bool = False  # freeze the source embedding table
    fix_word_vecs_dec: bool = False  # freeze the target embedding table
    skip_nonfinite: bool = False  # keep params and optimizer state on a step
    # whose global gradient norm is not finite
    ema_decay: float = 0.0  # > 0: an f32-blended EMA of the params
    ema_ramp: bool = True  # decay min(d, (1+n)/(10+n)) over update count n
    pack: bool = False  # sequence packing: PackedBatch streams (data/packing.py)
    pack_segments: int = 4  # most sentences a packed row holds
    grad_accum: int = 1  # micro-batches a step, gradients averaged
    steps_per_call: int = 1  # TPU dispatch knob; ignored by the port
    report_every: int = 50
    valid_every: int = 500
    checkpoint_every: int = 1000
    keep_checkpoints: int = 3
    data_axis: str = "data"
    num_data_shards: int = 0  # data-parallel ranks (0: WORLD_SIZE // num_model_shards)
    num_model_shards: int = 1  # vocab-parallel ranks (parallel/tp.py)

    def check_supported(self) -> None:
        """Raise ValueError for shard counts no mesh can have."""
        if self.num_data_shards < 0 or self.num_model_shards < 1:
            raise ValueError(f"num_data_shards ({self.num_data_shards}) must be >= 0 and "
                             f"num_model_shards ({self.num_model_shards}) >= 1")


@dataclass
class DataConfig:
    """Paths and batching (same fields and defaults as JAX); the port reads
    ``save_data`` and ``buckets``."""

    train_src: str = ""
    train_tgt: str = ""
    valid_src: str = ""
    valid_tgt: str = ""
    train_img_feats: str = ""
    valid_img_feats: str = ""
    save_data: str = ""  # binarized dataset prefix
    src_vocab_size: int = 10000
    tgt_vocab_size: int = 10000
    src_words_min_frequency: int = 1
    tgt_words_min_frequency: int = 1
    src_seq_len: int = 64
    tgt_seq_len: int = 64
    bpe_merges: int = 10000
    lower: bool = True
    share_vocab: bool = False
    buckets: List[int] = field(default_factory=lambda: [16, 24, 32, 48, 64])


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
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        return cls(model=_from_dict(ModelConfig, d.get("model", {})),
                   train=_from_dict(TrainConfig, d.get("train", {})),
                   data=_from_dict(DataConfig, d.get("data", {})),
                   decode=_from_dict(DecodeConfig, d.get("decode", {})))

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))


def _from_dict(klass, d: Dict[str, Any]):
    names = {f.name for f in dataclasses.fields(klass)}
    return klass(**{k: v for k, v in d.items() if k in names})


def update_config(cfg, dotted: Dict[str, Any]):
    """Apply ``{'model.latent_dim': 64, ...}`` overrides (JAX config.py:
    293-308): a string sets a bool by its spelling, other values take the
    current field's type."""
    for key, value in dotted.items():
        *parents, name = key.split(".")
        obj = cfg
        for p in parents:
            obj = getattr(obj, p)
        if not hasattr(obj, name):
            raise KeyError(f"unknown config key: {key}")
        current = getattr(obj, name)
        if isinstance(current, bool) and isinstance(value, str):
            value = value.strip().lower() in ("1", "true", "yes", "on")
        elif current is not None and not isinstance(current, (list, dict)):
            value = value if isinstance(value, type(current)) else type(current)(value)
        setattr(obj, name, value)
    return cfg
