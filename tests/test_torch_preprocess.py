"""PyTorch port: the data build. The port's preprocess CLI against JAX's on
one tiny raw corpus, flag case by flag case: the same file names, the
``.bpe.codes`` equal byte for byte, the vocab JSON equal, every ``.npz``
array equal, and the same ``suggested -buckets`` line; then ``learn_bpe``,
``Vocab.build``, ``detokenize``, ``read_text_embeddings`` and
``align_to_vocab`` against JAX's on the same inputs, and the port's copies
of the configs against JAX's, key for key."""

import json
import os
import pathlib

import numpy as np
import pytest

from variational_mmt_tpu.cli import preprocess as jax_preprocess
from variational_mmt_tpu.data import bpe as jax_bpe
from variational_mmt_tpu.data import embeddings as jax_emb
from variational_mmt_tpu.data import tokenizer as jax_tok
from variational_mmt_tpu.data import vocab as jax_vocab
from variational_mmt_torch.cli import preprocess
from variational_mmt_torch.data import bpe, embeddings, tokenizer, vocab

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORDS = ("a", "man", "woman", "dog", "dogs", "rides", "riding", "horse", "horses", "on",
         "the", "beach", "street", "two", "children", "play", "playing", "in", "park")


def raw_lines(rng, n):
    """Raw sentences with capitals and punctuation for the tokenizer."""
    out = []
    for _ in range(n):
        words = [WORDS[i] for i in rng.integers(0, len(WORDS), rng.integers(2, 12))]
        words[0] = words[0].capitalize()
        if rng.random() < 0.3:
            words.insert(int(rng.integers(1, len(words) + 1)), ",")
        out.append(" ".join(words) + rng.choice([".", " !", "'s.", ""]) + "\n")
    return out


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(3)
    for name, n in (("train.src", 60), ("train.tgt", 60), ("valid.src", 12),
                    ("valid.tgt", 12)):
        (d / name).write_text("".join(raw_lines(rng, n)), encoding="utf-8")
    return d


def argv(raw, out, *flags):
    return ["-train_src", str(raw / "train.src"), "-train_tgt", str(raw / "train.tgt"),
            "-valid_src", str(raw / "valid.src"), "-valid_tgt", str(raw / "valid.tgt"),
            "-save_data", str(out / "demo"), "-bpe_merges", "40", *flags]


def run_both(raw, tmp_path, capsys, *runs):
    """Each package's CLI over ``runs`` (lists of flags, in order) into its
    own directory; returns (port dir, jax dir, port's last output, JAX's)."""
    out = {}
    for name, main in (("port", preprocess.main), ("jax", jax_preprocess.main)):
        d = tmp_path / name
        d.mkdir()
        for flags in runs:
            capsys.readouterr()
            main(argv(raw, d, *flags))
        out[name] = (d, capsys.readouterr().out)
    return out["port"][0], out["jax"][0], out["port"][1], out["jax"][1]


def assert_same_files(port_dir, jax_dir):
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir))
    for name in names:
        a, b = port_dir / name, jax_dir / name
        if name.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files), name
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, (name, k)
                np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{name}:{k}")
        elif name.endswith(".json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text()), name
        else:
            assert a.read_bytes() == b.read_bytes(), name
    return names


def buckets_line(out):
    lines = [line for line in out.splitlines() if line.startswith("suggested -buckets")]
    assert len(lines) == 1
    return lines[0]


CASES = {
    "default_bpe": ([],),
    "no_bpe": (["-no_bpe"],),
    "bpe_merges_0": (["-bpe_merges", "0"],),
    "share_vocab": (["-share_vocab", "-src_vocab_size", "20", "-tgt_vocab_size", "30"],),
    "vocab_pad_multiple_8": (["-vocab_pad_multiple", "8", "-src_vocab_size", "21"],),
    "shard_size": (["-shard_size", "16", "-src_seq_length", "6", "-no_lower"],),
    "rerun_switches_layout": (["-shard_size", "16"], [], ["-shard_size", "25"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocess_cli_writes_what_jax_writes(case, raw, tmp_path, capsys):
    port_dir, jax_dir, port_out, jax_out = run_both(raw, tmp_path, capsys, *CASES[case])
    names = assert_same_files(port_dir, jax_dir)
    assert buckets_line(port_out) == buckets_line(jax_out)
    has_codes = "demo.bpe.codes" in names
    assert has_codes == (case not in ("no_bpe", "bpe_merges_0"))
    shards = [n for n in names if n.startswith("demo.train.") and n != "demo.train.npz"]
    assert ("demo.train.npz" in names) == (not shards)
    if case == "rerun_switches_layout":  # 60 examples: 3 shards of 25, none stale
        assert shards == ["demo.train.00.npz", "demo.train.01.npz", "demo.train.02.npz"]
    if case == "share_vocab":
        src = json.loads((port_dir / "demo.vocab.src.json").read_text())
        assert src == json.loads((port_dir / "demo.vocab.tgt.json").read_text())
        assert len(src) == 34  # the larger budget, 30, plus the four specials
    if case == "vocab_pad_multiple_8":
        for side in ("src", "tgt"):
            assert len(json.loads((port_dir / f"demo.vocab.{side}.json").read_text())) % 8 == 0


def test_preprocess_output_reads_back_as_jax_reads_it(raw, tmp_path, capsys):
    """The port's sharded layout loads through the port's dataset as JAX's
    single file does through JAX's."""
    from variational_mmt_tpu.data.dataset import BinarizedDataset as JaxDataset
    from variational_mmt_torch.data.dataset import BinarizedDataset

    port_dir, jax_dir, _, _ = run_both(raw, tmp_path, capsys, ["-shard_size", "7"])
    ours = BinarizedDataset.load(str(port_dir / "demo.train.npz"))
    theirs = JaxDataset.load(str(jax_dir / "demo.train.npz"))
    assert len(ours) == len(theirs) == 60
    for a, b in zip(ours.src + ours.tgt, theirs.src + theirs.tgt):
        np.testing.assert_array_equal(a, b)


def test_preprocess_imports_no_torch():
    import subprocess
    import sys

    code = ("import sys; import variational_mmt_torch.cli.preprocess; "
            "sys.exit(int('torch' in sys.modules))")
    assert subprocess.run([sys.executable, "-c", code], cwd=ROOT).returncode == 0


def tokenized(raw):
    lines = (raw / "train.src").read_text().splitlines() + \
        (raw / "train.tgt").read_text().splitlines()
    return [jax_tok.tokenize(line) for line in lines]


@pytest.mark.parametrize("merges,min_freq", [(40, 2), (500, 1), (7, 3)])
def test_learn_bpe_equals_jax(raw, merges, min_freq):
    lines = tokenized(raw)
    got = bpe.learn_bpe(lines, merges, min_freq)
    assert got == jax_bpe.learn_bpe(lines, merges, min_freq) and got
    words = sorted({w for t in lines for w in t}) + ["ridingman", "x"]
    ours, theirs = bpe.BPE(got), jax_bpe.BPE(got, use_native=False)
    assert [ours.segment_word(w) for w in words] == [theirs.segment_word(w) for w in words]


def test_bpe_save_load_round_trip_with_jax(tmp_path):
    merges = [("#", "a"), ("a", "b</w>"), ("#a", "ab</w>")]
    bpe.BPE(merges).save(str(tmp_path / "ours"))
    jax_bpe.BPE(merges, use_native=False).save(str(tmp_path / "theirs"))
    assert (tmp_path / "ours").read_bytes() == (tmp_path / "theirs").read_bytes()
    assert bpe.BPE.load(str(tmp_path / "ours")).merges == merges


@pytest.mark.parametrize("max_size,min_freq,pad", [(0, 1, 1), (10, 1, 8), (25, 2, 3),
                                                   (5, 4, 1)])
def test_vocab_build_equals_jax(raw, max_size, min_freq, pad):
    lines = tokenized(raw) + [["<unk>", "</s>", "the"]]
    ours = vocab.Vocab.build(lines, max_size=max_size, min_freq=min_freq)
    theirs = jax_vocab.Vocab.build(lines, max_size=max_size, min_freq=min_freq)
    if pad > 1:
        ours.itos.append("<vpad1>")  # a data type that collides with a filler name
        ours.stoi["<vpad1>"] = len(ours.itos) - 1
        theirs.itos.append("<vpad1>")
        theirs.stoi["<vpad1>"] = len(theirs.itos) - 1
        ours.pad_to_multiple(pad)
        theirs.pad_to_multiple(pad)
    assert ours.to_list() == theirs.to_list()
    assert ours.stoi == theirs.stoi
    assert ("the" in ours) == ("the" in theirs) and "nowhere" not in ours


def test_detokenize_equals_jax(raw):
    lines = tokenized(raw) + [["(", "a", ")", "b", "'s", "c", ",", "[", "d", "]", "!"]]
    for toks in lines:
        assert tokenizer.detokenize(toks) == jax_tok.detokenize(toks)


@pytest.mark.parametrize("header", [True, False])
def test_embeddings_read_and_align_equal_jax(tmp_path, header):
    rng = np.random.default_rng(4)
    rows = [f"{w} " + " ".join(f"{x:.6f}" for x in rng.standard_normal(5))
            for w in ("the", "man", "dog", "horse")]
    rows += ["bad 1.0 2.0", "worse a b c d e", "two words 1 2 3 4 5"]
    text = ("4 5\n" if header else "") + "\n".join(rows) + "\n"
    path = tmp_path / "vecs.txt"
    path.write_text(text)
    ours, theirs = embeddings.read_text_embeddings(str(path)), \
        jax_emb.read_text_embeddings(str(path))
    assert sorted(ours) == sorted(theirs) == ["dog", "horse", "man", "the"]
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    itos = vocab.SPECIALS + ["the", "cat", "horse", "man"]
    for kw in (dict(), dict(seed=3, init_scale=0.5), dict(emb_dim=5)):
        (ta, na), (tb, nb) = embeddings.align_to_vocab(ours, itos, **kw), \
            jax_emb.align_to_vocab(theirs, itos, **kw)
        assert na == nb == 3
        np.testing.assert_array_equal(ta, tb)
    with pytest.raises(ValueError, match="no embeddings"):
        embeddings.align_to_vocab({}, itos)


@pytest.mark.parametrize("name", ["nmt_multi30k.json", "vmmt_f_multi30k.json",
                                  "vmmt_c_multi30k.json"])
def test_port_configs_equal_jax(name):
    ours = json.loads((ROOT / "variational_mmt_torch" / "configs" / name).read_text())
    theirs = json.loads((ROOT / "variational_mmt_tpu" / "configs" / name).read_text())
    assert ours == theirs


@pytest.mark.parametrize("name", ["nmt_multi30k.json", "vmmt_f_multi30k.json"])
def test_port_configs_load(name):
    from variational_mmt_torch.config import Config

    from variational_mmt_torch.models.model import param_shapes

    cfg = Config.from_json((ROOT / "variational_mmt_torch" / "configs" / name).read_text())
    assert cfg.model.model_type == name.split("_multi30k")[0]
    assert param_shapes(cfg.model)  # a model the port builds
