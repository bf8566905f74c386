"""Hyperparameter sweep of the port over a binarized corpus. Follows
``tools/sweep.py`` (``parse_sweep`` :36-41, ``main`` :44-119): the train
CLI's flags plus ``-sweep``, ``-sweep_steps``, ``-sweep_bleu``,
``-sweep_beam`` and ``-out``.

Runs the cartesian product of dotted config overrides, each a short train
(``-sweep_steps`` steps, validated once at the end) and, with
``-sweep_bleu 1``, a beam decode of the valid set ranked by its BLEU;
prints a ranked table and appends one JSON line a config to ``-out``, with
the JAX tool's keys plus ``route``, ``device``, ``card`` and the kernels'
``launches``. ``-device`` (the train CLI's) and ``-route`` as
``tools/runs.py`` says; the route sets the model's compute dtype and
kernels over the train flags, and a ``-sweep`` override of them comes
last.

    python -m variational_mmt_torch.tools.sweep -data D/demo -train_img_feats f.npy \\
        -valid_img_feats v.npy -sweep "model.latent_dim=32,128 train.learning_rate=2e-4,4e-4"
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time
from typing import Dict, List

from variational_mmt_torch.cli.train import add_args, build_config, cli_device, cli_mesh
from variational_mmt_torch.config import Config, DecodeConfig, update_config
from variational_mmt_torch.convert import params_from_jax
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.data.features import load_features
from variational_mmt_torch.data.vocab import Vocab
from variational_mmt_torch.decode.translator import Translator
from variational_mmt_torch.evals.bleu import corpus_bleu
from variational_mmt_torch.models.model import build_model, init_params
from variational_mmt_torch.tools.runs import (add_route_arg, card_name, launches, resolve_route,
                                              route_model, route_pallas_step, sync,
                                              zero_launches)
from variational_mmt_torch.train.trainer import Trainer


def parse_sweep(spec: str) -> List[Dict[str, str]]:
    axes = []
    for part in spec.split():
        key, vals = part.split("=", 1)
        axes.append([(key, v) for v in vals.split(",")])
    return [dict(combo) for combo in itertools.product(*axes)]


def parse_args(argv=None):
    p = argparse.ArgumentParser("vmmt port sweep")
    add_args(p)
    p.add_argument("-sweep", required=True,
                   help='e.g. "model.latent_dim=32,128 train.learning_rate=2e-4,4e-4"')
    p.add_argument("-sweep_steps", type=int, default=2000)
    p.add_argument("-sweep_bleu", type=int, default=0,
                   help="1: beam-decode the valid set after each config and record valid_bleu")
    p.add_argument("-sweep_beam", type=int, default=4)
    add_route_arg(p)
    p.add_argument("-out", default="sweep_results.jsonl")
    opt = p.parse_args(argv)
    resolve_route(p, opt)
    return opt


def sweep_config(opt, overrides: Dict[str, str], n_src: int, n_tgt: int) -> Config:
    """JAX's config of one sweep point: the train flags, the route's model
    settings, ``-sweep_steps`` steps validated once at the end, then the
    overrides."""
    cfg = build_config(opt, n_src, n_tgt)
    cfg.model = dataclasses.replace(cfg.model, **route_model(opt.route))
    cfg.train.max_steps = opt.sweep_steps
    cfg.train.valid_every = opt.sweep_steps  # validate once at the end
    update_config(cfg, overrides)
    return cfg


def main(argv=None) -> List[dict]:
    opt = parse_args(argv)
    device = cli_device(opt.device)
    card = card_name(device)
    sv = Vocab.load(opt.data + ".vocab.src.json")
    tv = Vocab.load(opt.data + ".vocab.tgt.json")
    train_ds = BinarizedDataset.load(opt.data + ".train.npz")
    valid_ds = BinarizedDataset.load(opt.data + ".valid.npz")
    train_feats = load_features(opt.train_img_feats) if opt.train_img_feats else None
    valid_feats = load_features(opt.valid_img_feats) if opt.valid_img_feats else None
    mesh = cli_mesh(opt.num_shards, opt.tensor_parallel, device)

    combos = parse_sweep(opt.sweep)
    print(f"sweeping {len(combos)} configs x {opt.sweep_steps} steps on {device} ({card}), "
          f"route {opt.route}")
    results = []
    for i, overrides in enumerate(combos):
        cfg = sweep_config(opt, overrides, len(sv), len(tv))
        buckets = cfg.data.buckets
        ti = BucketIterator(train_ds, cfg.train.batch_size, buckets, img_feats=train_feats,
                            shuffle=True, seed=cfg.train.seed)
        vi = BucketIterator(valid_ds, cfg.train.batch_size, buckets, img_feats=valid_feats)
        zero_launches()
        sync(device)
        t0 = time.time()
        model = build_model(cfg.model, device=device)
        model.load_state_dict(params_from_jax(init_params(cfg.model, seed=cfg.train.seed),
                                              cfg.model))
        tr = Trainer(cfg, model, ti, vi, device=device, mesh=mesh)
        tr.train()
        tr.close()
        val = tr.history[-1] if tr.history else tr.validate(tr.final_state)
        sync(device)
        rec = {"overrides": overrides, "val_ppl": val["ppl"], "val_elbo": val.get("elbo"),
               "val_kl": val.get("kl"), "seconds": round(time.time() - t0, 1)}
        if opt.sweep_bleu:
            dcfg = DecodeConfig(beam_size=opt.sweep_beam, max_length=40,
                                batch_size=cfg.train.batch_size,
                                pallas_step=route_pallas_step(opt.route))
            translator = Translator(tr.model, sv, tv, dcfg, buckets=buckets, device=device)
            out = translator.translate_ids([list(map(int, a)) for a in valid_ds.src],
                                           valid_feats if cfg.model.img_feat_dim else None)
            translator.close()
            hyps = [tv.decode(nbest[0][1]) for nbest in out]
            refs = [[tv.decode(t)] for t in valid_ds.tgt]
            rec["valid_bleu"] = round(corpus_bleu(hyps, refs)["bleu"], 2)
        rec.update(route=opt.route, device=str(device), card=card, launches=launches())
        results.append(rec)
        print(f"[{i + 1}/{len(combos)}] {overrides} -> ppl {val['ppl']:.3f} "
              f"(kl {val.get('kl', 0):.2f}"
              + (f", bleu {rec['valid_bleu']}" if "valid_bleu" in rec else "")
              + f", {rec['seconds']}s)", flush=True)
        with open(opt.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    if mesh is not None:
        mesh.close()

    if opt.sweep_bleu:
        ranked, key = sorted(results, key=lambda r: -r["valid_bleu"]), "BLEU"
    else:
        ranked, key = sorted(results, key=lambda r: r["val_ppl"]), "ppl"
    print(f"\n=== ranked by validation {key} ({card}) ===")
    for r in ranked[:10]:
        print((f"bleu {r['valid_bleu']:6.2f}  " if opt.sweep_bleu else "")
              + f"ppl {r['val_ppl']:.3f}  {r['overrides']}")
    return results


if __name__ == "__main__":
    main()
