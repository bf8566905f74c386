"""PyTorch port: its copies of the METEOR scorer and the Porter stemmer
(``evals/meteor.py``, ``evals/porter.py``) against the JAX package's, equal
to the last bit: corpus and sentence scores on seeded sentence pairs (with
repeated words, stems, synonyms and paraphrases to match), both presets,
with and without the synonym and paraphrase tables (read by ``load_table``
from files), and the stems of a word list."""

import numpy as np
import pytest

from variational_mmt_tpu.evals import meteor as jax_meteor
from variational_mmt_tpu.evals import porter as jax_porter
from variational_mmt_torch.evals import meteor, porter

WORDS = ("the a dog dogs running runs ran runner man men walking walks walked park parks "
         "happily happy happiness quick quickly relational conditional generalization "
         "hopeful hopefully caresses ponies ties caress cats feed agreed plastered "
         "motoring sing conflated troubled sized hopping tanned falling hissing fizzed "
         "failing filing is of on with to street red blue big small child children").split()


def pairs(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ref = [str(w) for w in rng.choice(WORDS, rng.integers(3, 15))]
        hyp = [w if rng.random() < 0.6 else str(rng.choice(WORDS)) for w in ref]
        if rng.random() < 0.5:
            hyp = hyp[::-1] if rng.random() < 0.3 else hyp[1:] + hyp[:1]
        refs = [ref] + ([[str(w) for w in rng.choice(WORDS, 6)]] if rng.random() < 0.3 else [])
        out.append((hyp, refs))
    return out


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("meteor")
    (d / "syn.txt").write_text("dog\thound canine\nman\tguy\nrunning sprinting\nbig large\n")
    (d / "para.txt").write_text("street\troad avenue\nchild kid\n\nsingle\n")
    return str(d / "syn.txt"), str(d / "para.txt")


@pytest.mark.parametrize("preset", ["original", "1.5-en"])
@pytest.mark.parametrize("with_tables", [False, True])
def test_meteor_equals_jax_to_the_bit(preset, with_tables, tables):
    kw = {}
    if with_tables:
        kw = dict(synonyms=meteor.load_table(tables[0]), paraphrases=meteor.load_table(tables[1]))
        assert kw["synonyms"] == jax_meteor.load_table(tables[0])
        assert kw["paraphrases"] == jax_meteor.load_table(tables[1])
    data = pairs(40, seed=11 + with_tables)
    hyps, refs = [h for h, _ in data], [r for _, r in data]
    assert meteor.meteor_score(hyps, refs, preset=preset, **kw) == \
        jax_meteor.meteor_score(hyps, refs, preset=preset, **kw)
    ours, theirs = meteor.MeteorScorer(preset, **kw), jax_meteor.MeteorScorer(preset, **kw)
    for h, r in data:
        assert ours.sentence(h, r) == theirs.sentence(h, r)
    with pytest.raises(ValueError):
        meteor.meteor_score(hyps, refs[:-1], preset=preset)


def test_meteor_sentence_equals_jax():
    for h, r in pairs(20, seed=3):
        for params in ((0.9, 3.0, 0.5), (0.8, 2.0, 0.4)):
            want = jax_meteor.meteor_sentence(h, r, *params)
            assert meteor.meteor_sentence(h, r, *params) == want


def test_stems_equal_jax():
    words = WORDS + ["", "a", "sky", "agreement", "generalizations", "oscillators",
                     "electricity", "formaliti", "hopefulness", "adjustable"]
    assert [porter.stem(w) for w in words] == [jax_porter.stem(w) for w in words]
