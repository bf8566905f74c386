"""``train`` CLI of the port: ``python -m variational_mmt_torch.cli.train``.

Mirrors ``variational_mmt_tpu/cli/train.py``: the same flags (plus
``-device``), ``FLAG2KEY`` / ``passed_flags`` and the ``-config`` merge in
which every flag passed on the command line overrides the file; the
adadelta and adagrad learning-rate defaults (1.0 and 0.1) when no lr is
given for them. It loads a preprocessed corpus (``<data>.train.npz``,
``.valid.npz``, ``.vocab.src.json``, ``.vocab.tgt.json``, as
``cli/preprocess.py`` of either package writes them) and image
features, builds the model with random weights from ``-seed``, and trains
with validation, plateau decay and checkpoints in the JAX package's layout;
``-train_from`` resumes from a checkpoint of either package (a run root
resolves to its latest step). ``-valid_iw K`` adds the K-sample IW-ELBO
bound to each validation of a latent model. It runs on CUDA unless given
``-device cpu`` and exits with an error without CUDA.

Every model option of the JAX CLI trains: ``-rnn_type gru|lstm``,
``-global_attention general|dot|mlp``, ``-input_feed 0|1`` and conv
features pooled by ``-img_pool mean|attn``, and ``fused_decoder`` from a
``-config`` file. Batches are assembled by the native batcher or packer
and prefetched (``Trainer``). ``-pack`` with LSTM cells is refused as JAX
refuses it (the segment-reset recurrences are GRU only).

Across GPUs, one process a GPU (ROADMAP.md item 5.8):

    torchrun --nproc_per_node N -m variational_mmt_torch.cli.train ... \
        [-num_shards D] [-tensor_parallel M]

trains on a mesh of D data x M model ranks (parallel/mesh.py; D 0, the
default, is ``WORLD_SIZE // M``, and D x M must be ``WORLD_SIZE``): each
data rank takes its rows of every batch, the vocab is split over the M
model ranks (parallel/tp.py), NCCL reduces on CUDA and gloo on the CPU
(``-device cpu``). Rank 0 prints, logs and writes the checkpoints, which
hold the full tensors. ``-num_shards`` or ``-tensor_parallel`` above 1
without torchrun is an error naming the command.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
from typing import Callable, Optional

import numpy as np
import torch

from variational_mmt_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from variational_mmt_torch.convert import params_from_jax
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.data.features import load_features
from variational_mmt_torch.data.vocab import Vocab
from variational_mmt_torch.device import resolve_device
from variational_mmt_torch.models.model import build_model, init_params
from variational_mmt_torch.parallel import mesh as pm
from variational_mmt_torch.train import checkpoint
from variational_mmt_torch.train.trainer import Trainer, TrainState


def add_args(p: argparse.ArgumentParser) -> None:
    # data
    p.add_argument("-data", required=True, help="preprocess save_data prefix")
    p.add_argument("-save_model", required=True, help="checkpoint directory")
    p.add_argument("-train_img_feats", default="", help="HDF5/NPY train features")
    p.add_argument("-valid_img_feats", default="")
    p.add_argument("-train_from", default="", help="checkpoint dir/path to resume")
    # model
    p.add_argument("-model_type", default="vmmt_f", choices=["nmt", "vmmt_f", "vmmt_c"])
    p.add_argument("-rnn_type", default="gru", choices=["gru", "lstm"],
                   help="recurrent cell (the paper's models are GRU; LSTM is "
                        "the upstream baseline option)")
    p.add_argument("-word_vec_size", type=int, default=500)
    p.add_argument("-rnn_size", type=int, default=500)
    p.add_argument("-enc_layers", type=int, default=2)
    p.add_argument("-dec_layers", type=int, default=2)
    p.add_argument("-dropout", type=float, default=0.3)
    p.add_argument("-word_dropout", type=float, default=0.0)
    p.add_argument("-input_feed", type=int, default=1)
    p.add_argument("-global_attention", default="general", choices=["general", "dot", "mlp"])
    p.add_argument("-z_latent_dim", type=int, default=128)
    p.add_argument("-img_feat_dim", type=int, default=2048)
    p.add_argument("-img_feat_type", default="pool5", choices=["pool5", "conv"])
    p.add_argument("-img_pool", default="mean", choices=["mean", "attn"],
                   help="conv-region pooling: mean | text-conditioned attention")
    p.add_argument("-use_img_predict", type=int, default=1)
    p.add_argument("-img_loss", default="logprob", choices=["logprob", "mse", "cosine"])
    p.add_argument("-img_loss_weight", type=float, default=1.0)
    p.add_argument("-z_cond", default="init", choices=["init", "init+input"])
    p.add_argument("-share_embeddings", type=int, default=0,
                   help="one embedding table for source and target "
                        "(requires preprocess -share_vocab)")
    p.add_argument("-share_decoder_embeddings", type=int, default=0,
                   help="tie generator weights to the target embedding table "
                        "(requires -word_vec_size == -rnn_size)")
    p.add_argument("-pre_word_vecs_enc", default="",
                   help="vocab-aligned .npy embedding table for the encoder "
                        "(tools/embeddings_to_npy.py)")
    p.add_argument("-pre_word_vecs_dec", default="",
                   help="vocab-aligned .npy embedding table for the decoder")
    p.add_argument("-fix_word_vecs_enc", type=int, default=0,
                   help="freeze the encoder embedding table")
    p.add_argument("-fix_word_vecs_dec", type=int, default=0,
                   help="freeze the decoder embedding table")
    p.add_argument("-compute_dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("-use_pallas", type=int, default=0,
                   help="the hand-written GRU-scan kernels for the encoder scans")
    p.add_argument("-fused_ce", type=int, default=0,
                   help="fuse generator GEMM + CE (never materializes (B*T,V) logits)")
    p.add_argument("-config", default="",
                   help="JSON Config file; explicit CLI flags override it")
    # optimization
    p.add_argument("-batch_size", type=int, default=64)
    p.add_argument("-grad_accum", type=int, default=1,
                   help="micro-batches per optimizer step (activation-memory scaling)")
    p.add_argument("-steps_per_call", type=int, default=1,
                   help="accepted and ignored (a TPU dispatch knob)")
    p.add_argument("-skip_nonfinite", type=int, default=0,
                   help="skip optimizer updates with NaN/Inf gradients (bf16 hygiene)")
    p.add_argument("-max_steps", type=int, default=20000)
    p.add_argument("-epochs", type=int, default=0)
    p.add_argument("-optim", default="adam",
                   choices=["adam", "sgd", "adadelta", "adagrad"])
    p.add_argument("-learning_rate", type=float, default=4e-4)
    p.add_argument("-adam_beta1", type=float, default=0.9)
    p.add_argument("-adam_beta2", type=float, default=0.999)
    p.add_argument("-param_init", type=float, default=0.0,
                   help=">0: uniform(-r,r) re-init of all params (reference "
                        "default 0.1; 0 keeps per-layer framework init)")
    p.add_argument("-max_grad_norm", type=float, default=5.0)
    p.add_argument("-learning_rate_decay", type=float, default=0.5)
    p.add_argument("-start_decay_at", type=int, default=0)
    p.add_argument("-label_smoothing", type=float, default=0.0)
    p.add_argument("-kl_anneal", default="linear", choices=["linear", "sigmoid", "none"])
    p.add_argument("-kl_anneal_steps", type=int, default=10000)
    p.add_argument("-kl_anneal_start", type=int, default=0)
    p.add_argument("-kl_free_bits", type=float, default=0.0)
    p.add_argument("-ema_decay", type=float, default=0.0,
                   help=">0: maintain an EMA (Polyak average) of the params "
                        "; decode it with translate -use_ema")
    p.add_argument("-ema_ramp", type=int, default=1,
                   help="1: warm the EMA decay in as min(d,(1+n)/(10+n)) "
                        "over update count n (recommended; fixed decay "
                        "anchors short runs to the init point)")
    p.add_argument("-seed", type=int, default=1234)
    # loop
    p.add_argument("-report_every", type=int, default=50)
    p.add_argument("-valid_every", type=int, default=500)
    p.add_argument("-checkpoint_every", type=int, default=1000)
    p.add_argument("-keep_checkpoints", type=int, default=3)
    p.add_argument("-buckets", default="16,24,32,48,64")
    p.add_argument("-pack", type=int, default=0,
                   help="1: sequence packing — multiple sentences per row "
                        "(segment-reset recurrences, segment-masked "
                        "attention, per-segment latents). Identical "
                        "per-sentence math, ~25-35%% more real tokens per "
                        "step at Multi30k lengths. GRU models only; the row "
                        "length is the largest -buckets value")
    p.add_argument("-pack_segments", type=int, default=4,
                   help="max sentences packed into one row (static shape)")
    p.add_argument("-num_shards", type=int, default=0,
                   help="data-parallel ranks under torchrun (0: WORLD_SIZE // "
                        "-tensor_parallel)")
    p.add_argument("-tensor_parallel", type=int, default=1,
                   help=">1: vocab-parallel embeddings, generator and CE over this "
                        "many ranks (torchrun; the vocab sizes must divide by it)")
    p.add_argument("-metrics_log", default="", help="JSONL scalar log path (ELBO decomposition)")
    p.add_argument("-tensorboard_dir", default="",
                   help="TensorBoard scalar event dir (native writer, no TF dependency)")
    p.add_argument("-profile_dir", default="", help="torch.profiler trace directory")
    p.add_argument("-valid_bleu", type=int, default=0,
                   help="1: also report greedy BLEU on the validation set at each validation")
    p.add_argument("-valid_iw", type=int, default=0,
                   help="K>0: also report the K-sample IW-ELBO bound at each validation")
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default; an error without CUDA) or cpu")


# Complete flag -> Config field map (every add_args flag that lands in
# Config). -config override resolution and tests iterate this, so adding a
# flag without extending it is an error the CLI raises at parse time.
FLAG2KEY = {
    "data": ("data", "save_data"),
    "buckets": ("data", "buckets"),
    "model_type": ("model", "model_type"),
    "rnn_type": ("model", "rnn_type"),
    "word_vec_size": ("model", "emb_dim"),
    "rnn_size": ("model", "hidden_dim"),
    "enc_layers": ("model", "enc_layers"),
    "dec_layers": ("model", "dec_layers"),
    "dropout": ("model", "dropout"),
    "word_dropout": ("model", "word_dropout"),
    "input_feed": ("model", "input_feed"),
    "global_attention": ("model", "attn_type"),
    "z_latent_dim": ("model", "latent_dim"),
    "img_feat_dim": ("model", "img_feat_dim"),
    "img_feat_type": ("model", "img_feat_type"),
    "img_pool": ("model", "img_pool"),
    "use_img_predict": ("model", "use_img_predict"),
    "img_loss": ("model", "img_loss"),
    "img_loss_weight": ("model", "img_loss_weight"),
    "z_cond": ("model", "z_cond"),
    "share_decoder_embeddings": ("model", "share_decoder_embeddings"),
    "share_embeddings": ("model", "share_embeddings"),
    "compute_dtype": ("model", "compute_dtype"),
    "use_pallas": ("model", "use_pallas"),
    "fused_ce": ("model", "fused_ce"),
    "batch_size": ("train", "batch_size"),
    "grad_accum": ("train", "grad_accum"),
    "steps_per_call": ("train", "steps_per_call"),
    "skip_nonfinite": ("train", "skip_nonfinite"),
    "fix_word_vecs_enc": ("train", "fix_word_vecs_enc"),
    "fix_word_vecs_dec": ("train", "fix_word_vecs_dec"),
    "max_steps": ("train", "max_steps"),
    "epochs": ("train", "epochs"),
    "optim": ("train", "optimizer"),
    "learning_rate": ("train", "learning_rate"),
    "adam_beta1": ("train", "adam_beta1"),
    "adam_beta2": ("train", "adam_beta2"),
    "param_init": ("train", "param_init"),
    "max_grad_norm": ("train", "max_grad_norm"),
    "learning_rate_decay": ("train", "lr_decay"),
    "start_decay_at": ("train", "start_decay_at"),
    "label_smoothing": ("train", "label_smoothing"),
    "kl_anneal": ("train", "kl_anneal"),
    "kl_anneal_steps": ("train", "kl_anneal_steps"),
    "kl_anneal_start": ("train", "kl_anneal_start"),
    "kl_free_bits": ("train", "kl_free_bits"),
    "ema_decay": ("train", "ema_decay"),
    "ema_ramp": ("train", "ema_ramp"),
    "seed": ("train", "seed"),
    "report_every": ("train", "report_every"),
    "valid_every": ("train", "valid_every"),
    "checkpoint_every": ("train", "checkpoint_every"),
    "keep_checkpoints": ("train", "keep_checkpoints"),
    "pack": ("train", "pack"),
    "pack_segments": ("train", "pack_segments"),
    "num_shards": ("train", "num_data_shards"),
    "tensor_parallel": ("train", "num_model_shards"),
}

# flags that configure the run but have no Config field
RUNTIME_FLAGS = {
    "save_model", "train_img_feats", "valid_img_feats", "train_from",
    "pre_word_vecs_enc", "pre_word_vecs_dec",
    "config", "metrics_log", "tensorboard_dir", "profile_dir", "valid_bleu",
    "valid_iw", "device",
}


def passed_flags(argv) -> set:
    """Names of flags explicitly present on the command line, resolved
    through the same unambiguous-prefix matching argparse applies. Raises
    SystemExit for a flag that is neither mapped (FLAG2KEY) nor a known
    runtime flag — a passed flag must never be silently discarded."""
    known = set(FLAG2KEY) | RUNTIME_FLAGS
    out = set()
    for a in argv:
        if not (a.startswith("-") and len(a) > 1 and not a[1].isdigit()):
            continue
        tok = a.lstrip("-").split("=")[0]
        if tok in known:
            out.add(tok)
            continue
        cands = [k for k in known if k.startswith(tok)]
        if len(cands) == 1:
            out.add(cands[0])
        elif not cands:
            raise SystemExit(
                f"flag -{tok} is not mapped to a Config field; extend "
                "FLAG2KEY/RUNTIME_FLAGS in variational_mmt_torch/cli/train.py"
            )
        # ambiguous prefixes are argparse's error to raise
    return out


def build_config(opt, src_vocab_size: int, tgt_vocab_size: int) -> Config:
    return Config(
        model=ModelConfig(
            model_type=opt.model_type,
            rnn_type=opt.rnn_type,
            src_vocab_size=src_vocab_size,
            tgt_vocab_size=tgt_vocab_size,
            emb_dim=opt.word_vec_size,
            hidden_dim=opt.rnn_size,
            enc_layers=opt.enc_layers,
            dec_layers=opt.dec_layers,
            dropout=opt.dropout,
            word_dropout=opt.word_dropout,
            input_feed=bool(opt.input_feed),
            attn_type=opt.global_attention,
            latent_dim=opt.z_latent_dim,
            img_feat_dim=opt.img_feat_dim if opt.train_img_feats else 0,
            img_feat_type=opt.img_feat_type,
            img_pool=opt.img_pool,
            use_img_predict=bool(opt.use_img_predict) and bool(opt.train_img_feats),
            img_loss=opt.img_loss,
            img_loss_weight=opt.img_loss_weight,
            z_cond=opt.z_cond,
            share_decoder_embeddings=bool(opt.share_decoder_embeddings),
            share_embeddings=bool(opt.share_embeddings),
            compute_dtype=opt.compute_dtype,
            use_pallas=bool(opt.use_pallas),
            fused_ce=bool(opt.fused_ce),
        ),
        train=TrainConfig(
            seed=opt.seed,
            batch_size=opt.batch_size,
            grad_accum=opt.grad_accum,
            steps_per_call=opt.steps_per_call,
            skip_nonfinite=bool(opt.skip_nonfinite),
            fix_word_vecs_enc=bool(opt.fix_word_vecs_enc),
            fix_word_vecs_dec=bool(opt.fix_word_vecs_dec),
            max_steps=opt.max_steps,
            epochs=opt.epochs,
            optimizer=opt.optim,
            learning_rate=opt.learning_rate,
            adam_beta1=opt.adam_beta1,
            adam_beta2=opt.adam_beta2,
            param_init=opt.param_init,
            max_grad_norm=opt.max_grad_norm,
            lr_decay=opt.learning_rate_decay,
            start_decay_at=opt.start_decay_at,
            label_smoothing=opt.label_smoothing,
            kl_anneal=opt.kl_anneal,
            kl_anneal_steps=opt.kl_anneal_steps,
            kl_anneal_start=opt.kl_anneal_start,
            kl_free_bits=opt.kl_free_bits,
            ema_decay=opt.ema_decay,
            ema_ramp=bool(opt.ema_ramp),
            pack=bool(opt.pack),
            pack_segments=opt.pack_segments,
            report_every=opt.report_every,
            valid_every=opt.valid_every,
            checkpoint_every=opt.checkpoint_every,
            keep_checkpoints=opt.keep_checkpoints,
            num_data_shards=opt.num_shards,
            num_model_shards=opt.tensor_parallel,
        ),
        data=DataConfig(save_data=opt.data, buckets=[int(b) for b in opt.buckets.split(",")]),
    )


def cli_device(name: str) -> torch.device:
    """``-device``: an error naming the flag when CUDA is asked for and
    absent."""
    try:
        return resolve_device(name)
    except RuntimeError as e:
        raise SystemExit(f"{e} (pass -device cpu to run on the CPU)") from None


def cli_mesh(num_shards: int, tensor_parallel: int, device: torch.device):
    """The mesh of a run under torchrun (``WORLD_SIZE`` > 1) or with shard
    flags above 1, else None; the backend follows ``-device``. Errors exit
    naming what to run."""
    world = int(os.environ.get("WORLD_SIZE") or 1)
    if world <= 1 and num_shards <= 1 and tensor_parallel <= 1:
        return None
    try:
        return pm.make_mesh(num_shards, tensor_parallel,
                            device=None if device.type == "cuda" else device,
                            backend=pm.backend_for(device))
    except ValueError as e:
        raise SystemExit(f'{e} (README.md, "Across GPUs")') from None


def quiet_unless_main(mesh) -> contextlib.ExitStack:
    """A context in which ranks other than 0 print nothing, and which ends
    the mesh's process group on exit."""
    stack = contextlib.ExitStack()
    if mesh is not None:
        stack.callback(mesh.close)
        if not mesh.is_main:
            stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
    return stack


def family_lr(optimizer: str) -> float:
    """The reference Optim's lr for adadelta (1.0) and adagrad (0.1)."""
    return 1.0 if optimizer == "adadelta" else 0.1


def merge_config(opt, passed: set, cfg: Config, src_vocab: Vocab, tgt_vocab: Vocab) -> Config:
    """``-config`` as the base; every flag passed explicitly overrides it
    (JAX cli/train.py:352-385)."""
    with open(opt.config) as f:
        raw_text = f.read()
    base = Config.from_json(raw_text)
    file_train_keys = set(json.loads(raw_text).get("train", {}))
    file_cfg, cli_cfg = base.to_dict(), cfg.to_dict()
    for flag in passed:
        if flag in FLAG2KEY:
            sect, key = FLAG2KEY[flag]
            file_cfg[sect][key] = cli_cfg[sect][key]
    file_cfg["model"]["src_vocab_size"] = len(src_vocab)
    file_cfg["model"]["tgt_vocab_size"] = len(tgt_vocab)
    if not opt.train_img_feats:
        # a multimodal preset must not expect features this run lacks
        file_cfg["model"]["img_feat_dim"] = 0
        file_cfg["model"]["use_img_predict"] = False
    out = Config.from_dict(file_cfg)
    if ("learning_rate" not in passed and out.train.optimizer in ("adadelta", "adagrad")
            and (base.train.optimizer != out.train.optimizer
                 or "learning_rate" not in file_train_keys)):
        # the file's lr was written for another optimizer, or not at all
        out.train.learning_rate = family_lr(out.train.optimizer)
    return out


def main(argv=None, on_checkpoint: Optional[Callable[[TrainState, str], None]] = None
         ) -> Trainer:
    """Train as the flags say; returns the Trainer. ``on_checkpoint(state,
    path)`` is called after each checkpoint is written."""
    p = argparse.ArgumentParser("vmmt-torch train")
    add_args(p)
    opt = p.parse_args(argv)
    passed = passed_flags(list(argv) if argv is not None else sys.argv[1:])
    if "learning_rate" not in passed and opt.optim in ("adadelta", "adagrad"):
        opt.learning_rate = family_lr(opt.optim)
    device = cli_device(opt.device)

    sv = Vocab.load(opt.data + ".vocab.src.json")
    tv = Vocab.load(opt.data + ".vocab.tgt.json")
    train_ds = BinarizedDataset.load(opt.data + ".train.npz")
    valid_ds = (BinarizedDataset.load(opt.data + ".valid.npz")
                if BinarizedDataset.exists(opt.data + ".valid.npz") else None)
    train_feats = load_features(opt.train_img_feats) if opt.train_img_feats else None
    valid_feats = load_features(opt.valid_img_feats) if opt.valid_img_feats else None
    if train_feats is not None and len(train_feats) != len(train_ds):
        raise SystemExit(f"feature rows ({len(train_feats)}) != corpus lines ({len(train_ds)}): "
                         "features must be aligned to corpus line order")
    if valid_feats is not None and valid_ds is not None and len(valid_feats) != len(valid_ds):
        raise SystemExit(f"valid feature rows ({len(valid_feats)}) != valid corpus lines "
                         f"({len(valid_ds)}): features must be aligned to corpus line order")

    cfg = build_config(opt, len(sv), len(tv))
    if opt.config:
        cfg = merge_config(opt, passed, cfg, sv, tv)
    mesh = cli_mesh(cfg.train.num_data_shards, cfg.train.num_model_shards, device)
    with quiet_unless_main(mesh):
        return train(opt, cfg, sv, tv, train_ds, valid_ds, train_feats, valid_feats,
                     mesh.device if mesh is not None else device, mesh, on_checkpoint)


def train(opt, cfg: Config, sv: Vocab, tv: Vocab, train_ds: BinarizedDataset,
          valid_ds: Optional[BinarizedDataset], train_feats, valid_feats, device: torch.device,
          mesh: Optional[pm.Mesh], on_checkpoint) -> Trainer:
    """The run of :func:`main` once its inputs are read (on every rank of
    ``mesh``)."""
    if cfg.model.share_embeddings and sv.itos != tv.itos:
        raise SystemExit("share_embeddings requires identical source/target vocabs: "
                         "re-run preprocess with -share_vocab")
    buckets = cfg.data.buckets
    if cfg.train.pack:
        if cfg.model.rnn_type != "gru":
            raise SystemExit("-pack requires -rnn_type gru (segment-reset "
                             "recurrences are GRU-only)")
        from variational_mmt_torch.data.packing import PackedBucketIterator

        train_iter = PackedBucketIterator(train_ds, cfg.train.batch_size, buckets,
                                          seed=cfg.train.seed,
                                          max_segments=cfg.train.pack_segments)
    else:
        train_iter = BucketIterator(train_ds, cfg.train.batch_size, buckets, shuffle=True,
                                    seed=cfg.train.seed)
    valid_iter = (BucketIterator(valid_ds, cfg.train.batch_size, buckets)
                  if valid_ds is not None else None)
    if cfg.train.epochs > 0:
        # exact: each bucket pads its own last partial batch; packed epochs
        # are counted by packing them (the packer's __len__ is an estimate)
        cfg.train.max_steps = max(1, sum(train_iter.epoch_batches(e)
                                         for e in range(cfg.train.epochs))
                                  if cfg.train.pack else cfg.train.epochs * len(train_iter))
    model = build_model(cfg.model, device=device)
    model.load_state_dict(params_from_jax(init_params(cfg.model, seed=cfg.train.seed),
                                          cfg.model))
    name = f"{device}" + (f" ({torch.cuda.get_device_name(device)})"
                          if device.type == "cuda" else "")
    if mesh is None:
        print(f"device: {name}")
    else:  # every rank's, as JAX prints its mesh's devices (:438)
        print(f"devices: {pm.gather_objects(name)} ({mesh.n_data} data x {mesh.n_model} "
              f"model, {mesh.backend})")
    print(f"model: {cfg.model.model_type}; steps: {cfg.train.max_steps}")
    os.makedirs(opt.save_model, exist_ok=True)

    def ckpt_fn(state, step, _):
        path = checkpoint.save_checkpoint(opt.save_model, state, cfg, sv, tv,
                                          keep=cfg.train.keep_checkpoints, mesh=mesh)
        print(f"saved checkpoint {path}")
        if on_checkpoint is not None:
            on_checkpoint(state, path)

    from variational_mmt_torch.utils.metrics_log import MetricsLogger
    from variational_mmt_torch.utils.profiling import trace

    logger = (MetricsLogger(opt.metrics_log, opt.tensorboard_dir)
              if (opt.metrics_log or opt.tensorboard_dir) and (mesh is None or mesh.is_main)
              else None)
    bleu_fn = None
    if opt.valid_bleu and valid_ds is not None:
        bleu_fn = greedy_bleu_fn(model, sv, tv, valid_ds, valid_feats, buckets,
                                 cfg.train.batch_size, device, mesh)
    trainer = Trainer(cfg, model, train_iter, valid_iter, device=device, checkpoint_fn=ckpt_fn,
                      metrics_logger=logger, bleu_fn=bleu_fn, train_feats=train_feats,
                      valid_feats=valid_feats, valid_iw=opt.valid_iw, mesh=mesh)
    with trace(opt.profile_dir, cuda=device.type == "cuda"):
        if opt.train_from:
            path = opt.train_from
            if not os.path.exists(os.path.join(path, "state.msgpack")):
                path = checkpoint.latest_checkpoint(path) or path
            state = checkpoint.load_state(path, trainer.model, checkpoint.read_config(path),
                                          mesh=mesh)
            if checkpoint.is_released(path):
                print("WARNING: resuming from a RELEASED checkpoint (its optimizer state was "
                      "stripped): the optimizer restarts from zero")
            print(f"resuming from {path} at step {state.step}")
            trainer.train_from(state)
        else:
            if opt.pre_word_vecs_enc or opt.pre_word_vecs_dec:
                from variational_mmt_torch.data.embeddings import apply_pretrained

                apply_pretrained(
                    trainer.model,
                    enc=np.load(opt.pre_word_vecs_enc) if opt.pre_word_vecs_enc else None,
                    dec=np.load(opt.pre_word_vecs_dec) if opt.pre_word_vecs_dec else None)
                print("loaded pretrained word vectors "
                      f"(enc={bool(opt.pre_word_vecs_enc)}, dec={bool(opt.pre_word_vecs_dec)})")
            trainer.train_from()
    trainer.close()
    if logger is not None:
        logger.close()
    ckpt_fn(trainer.final_state, trainer.final_state.step, {})
    print("training done")
    return trainer


def greedy_bleu_fn(model, sv: Vocab, tv: Vocab, valid_ds: BinarizedDataset, valid_feats,
                   buckets, batch_size: int, device: torch.device, mesh=None):
    """``-valid_bleu``: greedy decoding of the validation sources with the
    live weights, BLEU against their targets. Under a mesh every rank
    decodes its rows with the state's model (its shard: the translator
    gathers the full weights once a validation)."""
    from variational_mmt_torch.config import DecodeConfig
    from variational_mmt_torch.decode.translator import Translator
    from variational_mmt_torch.evals.bleu import corpus_bleu

    dcfg = DecodeConfig(beam_size=1, max_length=max(buckets), batch_size=batch_size)
    translator = (Translator(model, sv, tv, dcfg, buckets=buckets, device=device)
                  if mesh is None else None)
    src = [list(map(int, s)) for s in valid_ds.src]
    refs = [[tv.decode(t)] for t in valid_ds.tgt]

    def bleu_fn(state) -> float:
        tr = translator or Translator(state.model, sv, tv, dcfg, buckets=buckets,
                                      device=device, mesh=mesh)
        out = tr.translate_ids(src, valid_feats)
        if tr is not translator:
            tr.close()
        return corpus_bleu([tv.decode(nbest[0][1]) for nbest in out], refs)["bleu"]

    return bleu_fn


if __name__ == "__main__":
    main()
