"""PyTorch port: MBR decoding (``decode/mbr.py``) against the JAX
package's: ``mbr_select`` picks the same candidate with the same
utilities (1e-12) on seeded candidate lists with duplicates and exact
ties (broken by the model scores, then by order), and
``mbr_translate_ids`` dispatches its N corpus passes at seeds
``seed + k * 7919``, two in flight, as JAX's does, and returns each
sentence's consensus with its own score."""

import numpy as np
import pytest

from variational_mmt_tpu.decode import mbr as jax_mbr
from variational_mmt_torch.config import DecodeConfig
from variational_mmt_torch.decode import mbr


def candidates(n, seed):
    rng = np.random.default_rng(seed)
    pool = [list(rng.integers(4, 12, rng.integers(1, 9))) for _ in range(max(2, n // 2))]
    cands = [list(pool[rng.integers(len(pool))]) for _ in range(n)]  # duplicates
    scores = [float(rng.integers(-5, 0)) for _ in range(n)]  # ties in the scores too
    return cands, scores


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("with_scores", [False, True])
def test_mbr_select_equals_jax(seed, with_scores):
    cands, scores = candidates(9, seed)
    s = scores if with_scores else None
    best, utils = mbr.mbr_select(cands, s)
    jbest, jutils = jax_mbr.mbr_select(cands, s)
    assert best == jbest
    np.testing.assert_allclose(utils, jutils, rtol=0, atol=1e-12)


def test_mbr_select_breaks_exact_ties_by_score_then_order():
    cands = [[5, 6], [7, 8], [5, 6], [7, 8]]  # two pairs: equal utilities
    assert mbr.mbr_select(cands)[0] == jax_mbr.mbr_select(cands)[0] == 0
    scores = [-3.0, -1.0, -3.0, -1.0]
    assert mbr.mbr_select(cands, scores)[0] == jax_mbr.mbr_select(cands, scores)[0] == 1
    with pytest.raises(ValueError):
        mbr.mbr_select([])


class FakeTranslator:
    """Records dispatches and finalizes; a pass's hypothesis of sentence i
    is [i, seed % 5] with score -seed % 7."""

    def __init__(self, temp=1.0, seed=3):
        self.dcfg = DecodeConfig(beam_size=1, sampling_temp=temp, decode_seed=seed)
        self.log = []

    def dispatch_ids(self, src_ids, img_feats=None, seed=None):
        self.log.append(("dispatch", seed))
        return seed, len(src_ids)

    def finalize_ids(self, pending):
        seed, n = pending
        self.log.append(("finalize", seed))
        return [[(float(-(seed % 7)), [i, seed % 5])] for i in range(n)]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_mbr_translate_ids_dispatches_n_passes_at_strided_seeds(package):
    mod = mbr if package == "port" else jax_mbr
    tr = FakeTranslator()
    out = mod.mbr_translate_ids(tr, [[4], [5], [6]], n_samples=4)
    seeds = [3 + k * 7919 for k in range(4)]
    assert mod.SEED_STRIDE == 7919
    assert tr.log == [("dispatch", seeds[0]), ("dispatch", seeds[1]), ("finalize", seeds[0]),
                      ("dispatch", seeds[2]), ("finalize", seeds[1]),
                      ("dispatch", seeds[3]), ("finalize", seeds[2]), ("finalize", seeds[3])]
    assert len(out) == 3 and all(len(n) == 1 for n in out)
    for i, ((score, ids),) in enumerate(out):
        k = [s % 5 for s in seeds].index(ids[1])
        assert ids[0] == i and score == float(-(seeds[k] % 7))


def test_mbr_translate_ids_equals_jax_and_checks_its_arguments():
    port = mbr.mbr_translate_ids(FakeTranslator(), [[4], [5]], n_samples=5, seed=11)
    assert port == jax_mbr.mbr_translate_ids(FakeTranslator(), [[4], [5]], n_samples=5, seed=11)
    with pytest.raises(ValueError, match="n_samples"):
        mbr.mbr_translate_ids(FakeTranslator(), [[4]], n_samples=0)
    with pytest.raises(ValueError, match="sampling_temp"):
        mbr.mbr_translate_ids(FakeTranslator(temp=0.0), [[4]], n_samples=2)
