"""The port's train step against JAX's over many steps on the quality
gate's synthetic corpus: does a long run drift?

Both packages train one tiny vmmt_c (the gate's configuration: 2+2 GRU
layers, ``z_cond=init+input``, the image-prediction objective, Adam at
4e-4, a linear KL anneal over half the steps, global-norm clipping) from
the same parameters on the same batches of the gate's ambiguous corpus,
f32 on the CPU, dropout and word dropout off. JAX's step draws its
reparameterization noise from its own stream; a debug callback hands each
step's eps to the host, and the port's step takes that eps. After each
step the script records both losses and both KL sums. With ``regions`` R
> 0 the corpus carries conv-style (R, 16) region features (the sense in
one region) and both models pool them with region attention
(``img_feat_type=conv``, ``img_pool=attn``), the gate's ``-img_regions R
-img_pool attn``.

Used by ``tests/test_torch_train_drift.py`` (100 steps) and, once, as a
script:

    JAX_PLATFORMS=cpu python tests/torch_train_drift.py -steps 500

which prints one JSON line a step and a summary line (the largest
relative gap of the loss and of the KL over the run, and where); add
``-regions 4`` for the region-attention model.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import variational_mmt_torch.models.model as torch_model_mod  # noqa: E402
import variational_mmt_tpu.models.model as jax_model_mod  # noqa: E402
from variational_mmt_torch.config import Config, ModelConfig, TrainConfig  # noqa: E402
from variational_mmt_torch.convert import params_from_jax  # noqa: E402
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator  # noqa: E402
from variational_mmt_torch.data.synthetic import make_ambiguous_corpus  # noqa: E402
from variational_mmt_torch.models.model import build_model  # noqa: E402
from variational_mmt_torch.train.trainer import (batch_tensors, create_train_state,  # noqa: E402
                                                 make_train_step)
from variational_mmt_tpu.config import Config as JaxConfig  # noqa: E402
from variational_mmt_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from variational_mmt_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from variational_mmt_tpu.models.model import build_model as jax_build_model  # noqa: E402
from variational_mmt_tpu.train.trainer import create_train_state as jax_create_state  # noqa: E402
from variational_mmt_tpu.train.trainer import make_train_step as jax_make_step  # noqa: E402

VOCAB, IMG_DIM, BATCH = 200, 16, 16


def gate_model(**over) -> dict:
    """The gate's model section (tools/quality_gate.py ``build_cfg``) at a
    tiny width, f32, no dropout; ``over`` replaces any of it."""
    return {**dict(model_type="vmmt_c", src_vocab_size=VOCAB, tgt_vocab_size=VOCAB, emb_dim=16,
                   hidden_dim=16, enc_layers=2, dec_layers=2, dropout=0.0, word_dropout=0.0,
                   latent_dim=8, img_feat_dim=IMG_DIM, use_img_predict=True,
                   img_loss="logprob", z_cond="init+input", compute_dtype="float32"), **over}


def gate_train(steps: int, seed: int) -> dict:
    return dict(seed=seed, max_steps=steps, learning_rate=4e-4, kl_anneal="linear",
                kl_anneal_steps=max(1, steps // 2))


def gate_batches(steps: int, seed: int, regions: int = 0):
    """``steps`` batches of the gate's ambiguous corpus (vocab 200, image
    features 16 wide, ``regions`` of them a sentence where > 0, sentences
    of 6-12 tokens where the gate's run to 24), shuffled epoch after epoch
    as the gate's iterator; one bucket of 16, so that JAX compiles its step
    once."""
    src, tgt, feats, sv, tv, _, _ = make_ambiguous_corpus(400, vocab_size=VOCAB, max_len=12,
                                                          img_dim=IMG_DIM, seed=seed,
                                                          regions=regions)
    ids = lambda lines, v: [np.asarray(v.encode(s), np.int32) for s in lines]  # noqa: E731
    it = BucketIterator(BinarizedDataset(ids(src, sv), ids(tgt, tv)), BATCH, [16],
                        img_feats=feats, shuffle=True, seed=seed)
    out, epoch = [], 0
    while len(out) < steps:
        out.extend(it.epoch(epoch))
        epoch += 1
    return out[:steps]


class NoiseTap:
    """Patches both packages' ``reparameterize``: JAX's draws as always and
    passes its eps to the host; the port's takes the last eps JAX drew."""

    def __init__(self):
        self.eps = None

    def __enter__(self):
        self.jax_orig = jax_model_mod.reparameterize
        self.torch_orig = torch_model_mod.reparameterize

        def jax_reparameterize(rng, mu, sigma):
            eps = jax.random.normal(rng, mu.shape, dtype=mu.dtype)
            jax.debug.callback(self.take, eps)
            return mu + sigma * eps

        def torch_reparameterize(mu, sigma, generator=None, eps=None):
            return mu + sigma * torch.from_numpy(self.eps).to(mu.dtype)

        jax_model_mod.reparameterize = jax_reparameterize
        torch_model_mod.reparameterize = torch_reparameterize
        return self

    def take(self, eps):
        self.eps = np.array(eps)

    def __exit__(self, *exc):
        jax_model_mod.reparameterize = self.jax_orig
        torch_model_mod.reparameterize = self.torch_orig


def run(steps: int, seed: int = 0, model_over=None, regions: int = 0):
    """Train both packages ``steps`` steps; yields per step {step, loss and
    KL sum of each package}. ``regions`` > 0: region features pooled by
    attention."""
    model_over = dict(model_over or {})
    if regions:
        model_over.update(img_feat_type="conv", img_pool="attn")
    jcfg = JaxConfig(model=JaxModelConfig(**gate_model(**model_over)),
                     train=JaxTrainConfig(**gate_train(steps, seed)))
    cfg = Config(model=ModelConfig(**gate_model(**model_over)),
                 train=TrainConfig(**gate_train(steps, seed)))
    batches = gate_batches(steps, seed, regions)
    with NoiseTap() as tap:
        jmodel = jax_build_model(jcfg.model)
        jstate = jax_create_state(jcfg, jmodel)
        jstep = jax.jit(jax_make_step(jcfg, jmodel))
        model = build_model(cfg.model, device="cpu")
        model.load_state_dict(params_from_jax(jax.device_get(jstate.params), cfg.model))
        state = create_train_state(cfg, model)
        step = make_train_step(cfg)
        for i, b in enumerate(batches):
            jb = {k: jax.numpy.asarray(getattr(b, k))
                  for k in ("src", "tgt_in", "tgt_out", "example_mask", "img")}
            jstate, jm = jstep(jstate, jb)
            jax.block_until_ready(jm["loss"])
            state, m = step(state, batch_tensors(b, torch.device("cpu")), state.generator)
            yield {"step": i + 1, "loss_jax": float(jm["loss"]),
                   "loss_port": float(m["loss"].detach()), "kl_jax": float(jm["kl_sum"]),
                   "kl_port": float(m["kl_sum"].detach())}


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("port-vs-JAX training drift on the gate's corpus")
    p.add_argument("-steps", type=int, default=500)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-regions", type=int, default=0,
                   help="R > 0: (R, 16) region features pooled by attention")
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    worst = {"loss": (0.0, 0), "kl": (0.0, 0)}
    for row in run(args.steps, args.seed, regions=args.regions):
        print(json.dumps(row), flush=True)
        for k in worst:
            gap = rel(row[f"{k}_port"], row[f"{k}_jax"])
            if gap > worst[k][0]:
                worst[k] = (gap, row["step"])
    summary = {"steps": args.steps, "seed": args.seed, "regions": args.regions,
               "max_rel_gap_loss": worst["loss"][0], "at_step_loss": worst["loss"][1],
               "max_rel_gap_kl": worst["kl"][0], "at_step_kl": worst["kl"][1]}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
