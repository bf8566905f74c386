"""``preprocess`` CLI of the port: ``python -m variational_mmt_torch.cli.preprocess``.

Mirrors ``variational_mmt_tpu/cli/preprocess.py``, flag for flag: raw (or
``-pretokenized``) parallel text -> joint BPE codes learned on the training
pairs, the source and target vocabs (one joint vocab under
``-share_vocab``, with the larger of the two budgets), and the binarized
training and validation sets, both segmented with the training BPE:

    python -m variational_mmt_torch.cli.preprocess -train_src train.en \\
        -train_tgt train.de -valid_src val.en -valid_tgt val.de \\
        -save_data data/demo [-bpe_merges 10000] [-shard_size N] [...]

It writes ``<save_data>.bpe.codes``, ``.vocab.src.json``,
``.vocab.tgt.json``, ``.train.npz`` (or the shards ``.train.NN.npz`` with
``-shard_size``) and ``.valid.npz``, the same bytes and arrays as JAX's CLI
on the same input, and prints the ``suggested -buckets`` line. A re-run
first removes the previous run's training layout. ``-bpe_merges 0`` means
``-no_bpe``. Image features are not processed here: they stay in their own
files, aligned to the corpus lines. Host code only: no device flag, and no
``torch`` import.
"""

from __future__ import annotations

import argparse
import os
from typing import List

from variational_mmt_torch.data.bpe import BPE, learn_bpe
from variational_mmt_torch.data.dataset import BinarizedDataset, binarize
from variational_mmt_torch.data.tokenizer import tokenize
from variational_mmt_torch.data.vocab import Vocab


def add_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-train_src", required=True)
    p.add_argument("-train_tgt", required=True)
    p.add_argument("-valid_src", default="")
    p.add_argument("-valid_tgt", default="")
    p.add_argument("-save_data", required=True)
    p.add_argument("-src_vocab_size", type=int, default=10000)
    p.add_argument("-tgt_vocab_size", type=int, default=10000)
    p.add_argument("-src_words_min_frequency", type=int, default=1)
    p.add_argument("-tgt_words_min_frequency", type=int, default=1)
    p.add_argument("-src_seq_length", type=int, default=64)
    p.add_argument("-tgt_seq_length", type=int, default=64)
    p.add_argument("-bpe_merges", type=int, default=10000)
    p.add_argument("-no_bpe", action="store_true", help="skip BPE (input already segmented)")
    p.add_argument("-pretokenized", action="store_true",
                   help="input is already tokenized; whitespace-split only")
    p.add_argument("-no_lower", action="store_true")
    p.add_argument("-share_vocab", action="store_true")
    p.add_argument("-vocab_pad_multiple", type=int, default=1,
                   help="pad both vocabs with inert filler types to a multiple of N "
                        "(a vocab sharded N ways)")
    p.add_argument("-shard_size", type=int, default=0,
                   help="examples per training shard (0 = one file)")


def _round8(n: int) -> int:
    return max(8, ((n + 7) // 8) * 8)


def read_corpus(path: str, pretokenized: bool, lower: bool) -> List[List[str]]:
    with open(path, encoding="utf-8") as f:
        if pretokenized:
            return [(line.lower() if lower else line).split() for line in f]
        return [tokenize(line, lower=lower) for line in f]


def suggested_buckets(ds: BinarizedDataset) -> str:
    """Bucket boundaries at the 25/50/75/90/100th percentiles of
    max(source, target + 1) after BPE, rounded up to multiples of 8; ""
    for an empty set."""
    lens = sorted(max(len(s), len(t) + 1) for s, t in zip(ds.src, ds.tgt))
    if not lens:
        return ""

    def pct(p):
        return lens[min(len(lens) - 1, int(p * len(lens)))]

    cand = sorted({_round8(pct(p)) for p in (0.25, 0.5, 0.75, 0.9, 1.0)})
    return (f"suggested -buckets {','.join(str(b) for b in cand)} "
            f"(len p50={pct(0.5)}, p90={pct(0.9)}, max={lens[-1]})")


def write_train(ds: BinarizedDataset, save_data: str, shard_size: int) -> None:
    """The training set as one ``.train.npz`` or as shards of
    ``shard_size``, after removing both layouts of a previous run (a stale
    single file would shadow fresh shards, and stale high-index shards
    would be read back in, breaking example index == corpus line)."""
    single = save_data + ".train.npz"
    stale = BinarizedDataset.shard_paths(single)
    if shard_size > 0 and os.path.exists(single):
        stale.append(single)
    for path in stale:
        print(f"removing stale {path} (re-run)")
        os.remove(path)
    if shard_size <= 0:
        ds.save(single)
        print(f"train: {len(ds)} examples -> {single}")
        return
    n_shards = (len(ds) + shard_size - 1) // shard_size
    for si in range(n_shards):
        lo, hi = si * shard_size, min((si + 1) * shard_size, len(ds))
        BinarizedDataset(ds.src[lo:hi], None if ds.tgt is None else ds.tgt[lo:hi]
                         ).save(f"{save_data}.train.{si:02d}.npz")
    print(f"train: {len(ds)} examples -> {n_shards} shards ({save_data}.train.00.npz ...)")


def main(argv=None) -> None:
    p = argparse.ArgumentParser("vmmt-torch preprocess")
    add_args(p)
    opt = p.parse_args(argv)
    lower = not opt.no_lower

    print(f"reading {opt.train_src} / {opt.train_tgt}")
    train_src = read_corpus(opt.train_src, opt.pretokenized, lower)
    train_tgt = read_corpus(opt.train_tgt, opt.pretokenized, lower)
    if len(train_src) != len(train_tgt):
        raise SystemExit(f"src/tgt line counts differ: {len(train_src)} vs {len(train_tgt)}")
    # learning 0 merges would split every word into characters
    bpe = None
    if not opt.no_bpe and opt.bpe_merges > 0:
        print(f"learning {opt.bpe_merges} BPE merges (joint)")
        bpe = BPE(learn_bpe(train_src + train_tgt, opt.bpe_merges))
        bpe.save(opt.save_data + ".bpe.codes")
        train_src = [bpe.segment(t) for t in train_src]
        train_tgt = [bpe.segment(t) for t in train_tgt]

    print("building vocabularies")
    if opt.share_vocab:
        sv = tv = Vocab.build(
            train_src + train_tgt, max_size=max(opt.src_vocab_size, opt.tgt_vocab_size),
            min_freq=min(opt.src_words_min_frequency, opt.tgt_words_min_frequency))
    else:
        sv = Vocab.build(train_src, max_size=opt.src_vocab_size,
                         min_freq=opt.src_words_min_frequency)
        tv = Vocab.build(train_tgt, max_size=opt.tgt_vocab_size,
                         min_freq=opt.tgt_words_min_frequency)
    if opt.vocab_pad_multiple > 1:
        for v in {id(sv): sv, id(tv): tv}.values():
            v.pad_to_multiple(opt.vocab_pad_multiple)
    sv.save(opt.save_data + ".vocab.src.json")
    tv.save(opt.save_data + ".vocab.tgt.json")
    print(f"src vocab {len(sv)}; tgt vocab {len(tv)}")

    def encoded(src, tgt):
        return binarize([sv.encode(t) for t in src], [tv.encode(t) for t in tgt],
                        max_src_len=opt.src_seq_length, max_tgt_len=opt.tgt_seq_length)

    ds = encoded(train_src, train_tgt)
    write_train(ds, opt.save_data, opt.shard_size)
    line = suggested_buckets(ds)
    if line:
        print(line)

    if opt.valid_src:
        valid_src = read_corpus(opt.valid_src, opt.pretokenized, lower)
        valid_tgt = read_corpus(opt.valid_tgt, opt.pretokenized, lower)
        if bpe is not None:
            valid_src = [bpe.segment(t) for t in valid_src]
            valid_tgt = [bpe.segment(t) for t in valid_tgt]
        vds = encoded(valid_src, valid_tgt)
        vds.save(opt.save_data + ".valid.npz")
        print(f"valid: {len(vds)} examples -> {opt.save_data}.valid.npz")


if __name__ == "__main__":
    main()
