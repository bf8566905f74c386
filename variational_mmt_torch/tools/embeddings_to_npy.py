"""Convert GloVe or word2vec text embeddings to a vocab-aligned ``.npy``
table for ``-pre_word_vecs_enc`` / ``-pre_word_vecs_dec``. Mirrors the
root ``tools/embeddings_to_npy.py``, flag for flag, and writes the same
file on the same input:

    python -m variational_mmt_torch.tools.embeddings_to_npy -emb_file glove.txt \\
        -vocab demo.vocab.src.json -output src_emb.npy [-emb_dim 300] [-seed 0]

Rows of vocab tokens missing from the file are 0.1 times standard normals
from numpy ``-seed`` (``data/embeddings.align_to_vocab``); the coverage is
printed. Host code: no device flag.
"""

from __future__ import annotations

import argparse

import numpy as np

from variational_mmt_torch.data.embeddings import align_to_vocab, read_text_embeddings
from variational_mmt_torch.data.vocab import Vocab


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-emb_file", required=True, help="GloVe/word2vec text file")
    p.add_argument("-vocab", required=True, help="vocab JSON from preprocess")
    p.add_argument("-output", required=True, help="output .npy path")
    p.add_argument("-emb_dim", type=int, default=0,
                   help="expected dim (0 = infer from the file)")
    p.add_argument("-seed", type=int, default=0)
    args = p.parse_args(argv)

    vocab = Vocab.load(args.vocab)
    table, matched = align_to_vocab(read_text_embeddings(args.emb_file), vocab.itos,
                                    emb_dim=args.emb_dim or None, seed=args.seed)
    np.save(args.output, table)
    print(f"matched {matched}/{len(vocab.itos)} vocab tokens "
          f"({100.0 * matched / max(len(vocab.itos), 1):.1f}%); "
          f"wrote {table.shape} -> {args.output}")
    return table


if __name__ == "__main__":
    main()
