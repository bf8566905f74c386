"""The region gate's seed 12 split into training and decoding: train
vmmt_c on the gate's ambiguous corpus with 4 region features pooled by
attention (``tools/quality_gate.py -models vmmt_c -seeds 12 -img_regions 4
-img_pool attn``) on one route of the port, then decode the test split
with the same weights at pallas_step 0 (plain step), 1 (row 3) and 2 (row
4). A BLEU that follows the training route and not the decode step places
a result in training. Prints one JSON line: the route, the last training
step's metrics, the test BLEU at each pallas_step and the card.

    python docs/experiments/regions_decode_split.py kernels
    python docs/experiments/regions_decode_split.py scans

Run from the repository's root on a CUDA card.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from variational_mmt_torch.config import DecodeConfig  # noqa: E402
from variational_mmt_torch.convert import params_from_jax  # noqa: E402
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator  # noqa: E402
from variational_mmt_torch.data.synthetic import make_ambiguous_corpus  # noqa: E402
from variational_mmt_torch.decode.translator import Translator  # noqa: E402
from variational_mmt_torch.evals.bleu import corpus_bleu  # noqa: E402
from variational_mmt_torch.models.model import build_model, init_params  # noqa: E402
from variational_mmt_torch.tools import quality_gate as qg  # noqa: E402
from variational_mmt_torch.train.trainer import Trainer  # noqa: E402


def main(route: str) -> dict:
    seed = 12
    args = qg.parse_args(["-models", "vmmt_c", "-seeds", str(seed), "-img_regions", "4",
                          "-img_pool", "attn", "-route", route])
    device = torch.device("cuda")
    n = args.n_train + args.n_valid + args.n_test
    a, b = args.n_train, args.n_train + args.n_valid
    src, tgt, feats, sv, tv, _, _ = make_ambiguous_corpus(
        n, vocab_size=args.vocab_size, img_dim=args.img_dim, seed=args.data_seed,
        regions=args.img_regions)
    cfg = qg.build_cfg("vmmt_c", seed, args)
    ids = lambda lines, v: [np.asarray(v.encode(s), np.int32) for s in lines]  # noqa: E731
    it = BucketIterator(BinarizedDataset(ids(src[:a], sv), ids(tgt[:a], tv)), args.batch_size,
                        qg.BUCKETS, img_feats=feats[:a], shuffle=True, seed=seed)
    model = build_model(cfg.model, device=device)
    model.load_state_dict(params_from_jax(init_params(cfg.model, seed=seed), cfg.model))
    trainer = Trainer(cfg, model, it, device=device)
    hist = trainer.train(args.steps)
    trainer.close()
    out = {"route": route, "last_step": {k: float(v) for k, v in hist[-1].items()
                                         if isinstance(v, (int, float))}}
    for ps in (0, 1, 2):
        dcfg = DecodeConfig(beam_size=4, max_length=40, batch_size=args.batch_size, alpha=0.6,
                            pallas_step=ps)
        tr = Translator(trainer.model, sv, tv, dcfg, buckets=qg.BUCKETS, device=device)
        hyp = tr.translate_ids([sv.encode(s) for s in src[b:]], feats[b:])
        tr.close()
        out[f"test_bleu_pallas_step{ps}"] = round(
            corpus_bleu([tv.decode(nb[0][1]) for nb in hyp], [[r] for r in tgt[b:]])["bleu"], 2)
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 check=True).stdout.strip().splitlines()[0]
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1])), flush=True)
