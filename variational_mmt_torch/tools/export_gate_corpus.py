"""Write the quality gate's discriminative corpus
(``data/synthetic.make_ambiguous_corpus``) in the preprocess CLI's output
format, so that the train and translate CLIs run on the corpus the gate
uses. Mirrors the root ``tools/export_gate_corpus.py``, flag for flag, and
writes the same files on the same flags:

    python -m variational_mmt_torch.tools.export_gate_corpus -out /tmp/gate [-data_seed 0]

Writes ``<out>.{train,valid,test}.npz``, ``<out>.vocab.{src,tgt}.json``,
``<out>.{train,valid,test}.feats.npy``, ``<out>.{test.src,test.ref}.txt``
and ``<out>.meta.json`` with the oracle and text-only BLEU asymptotes, and
prints the meta line. Host code: no ``-device``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from variational_mmt_torch.data.dataset import binarize
from variational_mmt_torch.data.synthetic import make_ambiguous_corpus, oracle_bleu_bounds


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("export gate corpus")
    p.add_argument("-out", required=True, help="output path prefix")
    p.add_argument("-n_train", type=int, default=6000)
    p.add_argument("-n_valid", type=int, default=300)
    p.add_argument("-n_test", type=int, default=500)
    p.add_argument("-data_seed", type=int, default=0)
    p.add_argument("-vocab_size", type=int, default=200)
    p.add_argument("-img_dim", type=int, default=512)
    p.add_argument("-img_regions", type=int, default=0)
    args = p.parse_args(argv)

    n = args.n_train + args.n_valid + args.n_test
    src, tgt, feats, sv, tv, senses, amb = make_ambiguous_corpus(
        n, vocab_size=args.vocab_size, img_dim=args.img_dim,
        seed=args.data_seed, regions=args.img_regions,
    )
    a, b = args.n_train, args.n_train + args.n_valid
    splits = {"train": (0, a), "valid": (a, b), "test": (b, n)}
    sv.save(args.out + ".vocab.src.json")
    tv.save(args.out + ".vocab.tgt.json")
    for name, (lo, hi) in splits.items():
        ds = binarize([sv.encode(s) for s in src[lo:hi]],
                      [tv.encode(t) for t in tgt[lo:hi]])
        ds.save(f"{args.out}.{name}.npz")
        np.save(f"{args.out}.{name}.feats.npy", feats[lo:hi])
    with open(args.out + ".test.src.txt", "w") as f:
        for s in src[b:]:
            f.write(" ".join(s) + "\n")
    with open(args.out + ".test.ref.txt", "w") as f:
        for t in tgt[b:]:
            f.write(" ".join(t) + "\n")
    o_bleu, t_bleu = oracle_bleu_bounds(src[b:], tgt[b:], senses[b:], amb, args.vocab_size)
    meta = {"oracle_bleu": round(o_bleu, 2), "text_asymptote": round(t_bleu, 2),
            "n_train": args.n_train, "n_valid": args.n_valid,
            "n_test": args.n_test, "vocab_size": args.vocab_size,
            "img_dim": args.img_dim, "img_regions": args.img_regions,
            "data_seed": args.data_seed}
    with open(args.out + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps(meta))
    return meta


if __name__ == "__main__":
    main()
