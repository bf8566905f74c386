"""PyTorch port: the native host code (variational_mmt_torch/native/, the
C++ batcher, packer and BPE segmenter) against the port's Python paths and
the JAX package's Python paths (``use_native=False``): array for array and
byte for byte. A case is skipped only when g++ is missing; any other
reason for ``available()`` to be False fails it."""

import os
import random
import shutil
import threading

import numpy as np
import pytest

from variational_mmt_tpu.data.bpe import BPE as JaxBPE
from variational_mmt_tpu.data.bpe import learn_bpe as jax_learn_bpe
from variational_mmt_tpu.data.dataset import BinarizedDataset as JaxBinarizedDataset
from variational_mmt_tpu.data.dataset import BucketIterator as JaxBucketIterator
from variational_mmt_tpu.data.packing import PackedBucketIterator as JaxPackedBucketIterator
from variational_mmt_torch import native
from variational_mmt_torch.data.bpe import BPE, learn_bpe, remove_bpe
from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
from variational_mmt_torch.data.packing import PackedBucketIterator

BATCH_FIELDS = ("src", "tgt_in", "tgt_out", "indices", "example_mask", "img")
PACKED_FIELDS = ("src", "tgt_in", "tgt_out", "src_seg", "tgt_seg", "seg_first", "seg_last",
                 "indices", "seg_mask", "img")


@pytest.fixture
def fresh(monkeypatch):
    """The loader's cache emptied for one test, restored after it."""
    for name, value in (("_TRIED", False), ("_LIB", None), ("_REASON", None)):
        monkeypatch.setattr(native, name, value)
    return monkeypatch


@pytest.fixture(scope="module", autouse=True)
def have_native():
    if not native.available():
        if native.unavailable_reason() == native.NO_GXX:
            pytest.skip("no g++: the native library cannot be built")
        pytest.fail(f"native library unavailable: {native.unavailable_reason()}")


def corpus(n, seed, hi=30):
    rng = np.random.default_rng(seed)
    src = [rng.integers(4, 50, rng.integers(1, hi)).astype(np.int32) for _ in range(n)]
    tgt = [rng.integers(4, 50, rng.integers(1, hi)).astype(np.int32) for _ in range(n)]
    return src, tgt


def assert_same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("with_tgt", [True, False])
@pytest.mark.parametrize("feats", ["none", "flat", "conv"])
def test_batcher_matches_python_and_jax(with_tgt, feats):
    """Shuffled epochs over three buckets with 41 examples in batches of 8:
    every bucket ends in a partial batch. Without a target side the native
    path gives tgt_in = tgt_out = None, as the port's Python path does
    (JAX's native path gives PAD arrays there, so JAX is compared on the
    other fields)."""
    n = 41
    src, tgt = corpus(n, seed=0)
    rng = np.random.default_rng(1)
    img = {"none": None, "flat": rng.standard_normal((n, 16)),
           "conv": rng.standard_normal((n, 4, 16))}[feats]
    if img is not None:
        img = img.astype(np.float64 if feats == "flat" else np.float32)  # f64 is made f32
    kw = dict(batch_size=8, buckets=[8, 16, 32], img_feats=img, shuffle=True, seed=3)
    ds = BinarizedDataset(src, tgt if with_tgt else None)
    it_cc = BucketIterator(ds, **kw)
    assert it_cc.use_native
    it_py = BucketIterator(ds, **kw, use_native=False)
    it_jax = JaxBucketIterator(JaxBinarizedDataset(src, tgt if with_tgt else None), **kw,
                               use_native=False)
    for epoch in (0, 1):
        cc, py, jx = (list(it.epoch(epoch)) for it in (it_cc, it_py, it_jax))
        assert len(cc) == len(py) == len(jx) == len(it_cc)
        assert any(b.example_mask.min() == 0 for b in cc)  # partial batches
        for c, p, j in zip(cc, py, jx):
            assert_same(c, p, BATCH_FIELDS)
            assert_same(c, j, BATCH_FIELDS if with_tgt else
                        ("src", "indices", "example_mask", "img"))
            if not with_tgt:
                assert c.tgt_in is None and c.tgt_out is None


@pytest.mark.parametrize("K,B,L", [(4, 16, 24), (1, 8, 16), (7, 8, 32)])
def test_packer_matches_python_and_jax(K, B, L):
    """Every field of every batch of a shuffled epoch (tests/test_pack.py:344),
    and the native exact batch count."""
    n = 700
    src, tgt = corpus(n, seed=3)
    feats = np.random.default_rng(4).standard_normal((n, 8)).astype(np.float32)
    kw = dict(img_feats=feats, seed=5, max_segments=K)
    it_cc = PackedBucketIterator(BinarizedDataset(src, tgt), B, [L], **kw)
    assert it_cc.use_native
    it_py = PackedBucketIterator(BinarizedDataset(src, tgt), B, [L], **kw, use_native=False)
    it_jax = JaxPackedBucketIterator(JaxBinarizedDataset(src, tgt), B, [L], **kw,
                                     use_native=False)
    cc, py, jx = (list(it.epoch(2)) for it in (it_cc, it_py, it_jax))
    assert len(cc) == len(py) == len(jx) > 1
    assert it_cc.epoch_batches(2) == it_py.epoch_batches(2) == len(cc)
    for c, p, j in zip(cc, py, jx):
        assert_same(c, p, PACKED_FIELDS)
        assert_same(c, j, PACKED_FIELDS)


def test_packer_above_16_segments_takes_python():
    src, tgt = corpus(60, seed=5, hi=4)
    ds = BinarizedDataset(src, tgt)
    it = PackedBucketIterator(ds, 4, [64], max_segments=17)
    assert not it.use_native
    assert PackedBucketIterator(ds, 4, [64], max_segments=16).use_native
    with pytest.raises(ValueError, match="at most 16"):
        native.pack_plan(ds.src_flat()[1], ds.tgt_flat()[1], np.arange(len(ds)), 4, 64, 17)


def test_packer_refuses_empty_lines_before_the_native_plan():
    src, tgt = corpus(6, seed=6)
    src[2] = np.zeros(0, np.int32)
    with pytest.raises(ValueError, match="empty source or target"):
        PackedBucketIterator(BinarizedDataset(src, tgt), 2, [32], use_native=True)


WORDS = ["lower", "lowest", "newer", "wider", "training", "trainer", "außergewöhnlich",
         "straße", "naïve", "mädchen", "日本語"]


def bpe_case(case):
    """(tokenized lines, merges to learn, words to segment)."""
    if case == "words":
        rng = random.Random(0)
        lines = [[rng.choice(WORDS) for _ in range(8)] for _ in range(200)]
        return lines, 80, WORDS + ["unseen", "wördxyz", "a", "", "ab", "x" * 5000]
    lines = [["#goal", "#goal", "#go"] for _ in range(30)]
    return lines, 20, ["#goal", "#gone", "#go", "plain#tag", "#"]


@pytest.mark.parametrize("case", ["words", "hash_leading_merges"])
def test_bpe_matches_python_and_jax(case):
    """Byte-identical pieces from the C++ segmenter, the port's Python
    loop and JAX's, including merges whose left symbol is '#' (only a
    '#version' line is a comment; tests/test_native.py:105-139) and a word
    longer than the first output buffer."""
    lines, n_merges, words = bpe_case(case)
    merges = learn_bpe(lines, n_merges)
    assert merges == jax_learn_bpe(lines, n_merges)
    if case == "hash_leading_merges":
        assert any(a == "#" for a, _ in merges)
    cc, py = BPE(merges), BPE(merges, use_native=False)
    jx = JaxBPE(merges, use_native=False)
    assert cc._native is not None and py._native is None
    for w in words:
        got = cc.segment_word(w)
        assert got == py.segment_word(w) == jx.segment_word(w), w
        assert [p.encode("utf-8") for p in got] == [p.encode("utf-8") for p in py.segment_word(w)]
        if w:
            assert remove_bpe(got) == [w]


def test_bpe_segments_in_8_threads_at_once():
    """A buffer a call: 8 threads segmenting uncached words through one
    handle (the threaded serving front end) never see another's pieces."""
    merges = learn_bpe([[f"word{i}" for i in range(20)] for _ in range(20)], 40)
    nb = native.NativeBPE(merges)
    py = BPE(merges, use_native=False)
    words = [f"word{i}" for i in range(20)] + [f"word{i}x{i}" for i in range(20)]
    want = {w: py.segment_word(w) for w in words}
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(400):
            w = words[int(rng.integers(len(words)))]
            if nb.segment_word(w) != want[w]:
                errors.append(w)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


def test_a_library_others_could_write_is_not_loaded(tmp_path, fresh):
    """A copy of the built library, made writable by the group and others,
    is refused with a reason; the same file, private again, loads."""
    lib = tmp_path / "libvmmt_native-copy.so"
    built = [p for p in native.BUILD_DIR.glob("libvmmt_native-*.so")]
    assert built
    shutil.copy(built[0], lib)
    fresh.setattr(native, "_lib_path", lambda gxx, extra: lib)
    for mode, loads in ((0o777, False), (0o775, False), (0o757, False), (0o755, True)):
        os.chmod(lib, mode)
        fresh.setattr(native, "_TRIED", False)
        assert native.available() is loads, oct(mode)
        if not loads:
            assert "writable by others" in native.unavailable_reason()
            with pytest.raises(RuntimeError, match="writable by others"):
                native.NativeBPE([("a", "b")])


def test_a_file_that_is_no_library_is_refused_with_the_loader_error(tmp_path, fresh):
    lib = tmp_path / "libvmmt_native-junk.so"
    lib.write_bytes(b"not a shared object")
    os.chmod(lib, 0o755)
    fresh.setattr(native, "_lib_path", lambda gxx, extra: lib)
    assert not native.available()
    assert native.unavailable_reason().startswith(f"{lib} does not load")


def test_missing_gxx_is_the_reason(fresh):
    fresh.setattr(native, "_gxx", lambda: None)
    assert not native.available()
    assert native.unavailable_reason() == native.NO_GXX
    src, tgt = corpus(5, seed=7)
    assert not BucketIterator(BinarizedDataset(src, tgt), 2, [32]).use_native
    assert BPE([("a", "b")])._native is None


def test_a_failed_build_gives_the_compiler_output(tmp_path, fresh):
    """A library that must be built and cannot be: the reason holds g++'s
    own error text, never hidden."""
    broken = tmp_path / "batcher.cpp"
    broken.write_text("this is not C++\n")
    for name in ("bpe.cpp", "packer.cpp"):
        shutil.copy(native.HERE / name, tmp_path / name)
    fresh.setattr(native, "HERE", tmp_path)
    fresh.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert not native.available()
    reason = native.unavailable_reason()
    assert reason.startswith("g++ failed") and "batcher.cpp" in reason and "error" in reason
    assert not list((tmp_path / "build").glob("*.tmp"))
