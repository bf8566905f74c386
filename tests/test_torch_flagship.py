"""The flagship cells' configuration and synthetic traffic
(variational_mmt_torch/tools/flagship.py), at a tiny vocabulary and image
width; exact checks (shapes, ranges, determinism)."""

import numpy as np

from variational_mmt_torch.config import Config, ModelConfig
from variational_mmt_torch.tools import flagship

TINY = ModelConfig(model_type="vmmt_c", src_vocab_size=30, tgt_vocab_size=40, img_feat_dim=6)


def test_config_is_the_flagship():
    with open(flagship.CONFIG) as f:
        m = Config.from_json(f.read()).model
    assert (m.model_type, m.emb_dim, m.hidden_dim, m.enc_layers, m.dec_layers) == \
        ("vmmt_c", 500, 500, 2, 2)
    assert (m.latent_dim, m.img_feat_dim, m.compute_dtype) == (128, 2048, "bfloat16")
    assert m.use_pallas and m.fused_ce


def test_train_batches_are_fixed_and_in_range():
    got = flagship.train_batches(TINY, n_batches=3, batch_size=8)
    again = flagship.train_batches(TINY, n_batches=3, batch_size=8)
    assert len(got) == 3
    for b, b2 in zip(got, again):
        for field in ("src", "tgt_in", "tgt_out", "img"):
            np.testing.assert_array_equal(getattr(b, field), getattr(b2, field))
        assert b.src.shape[0] == b.tgt_in.shape[0] == b.img.shape[0] == 8
        assert b.img.shape[1] == TINY.img_feat_dim and (b.img >= 0).all()
        src_len = (b.src > 0).sum(1)
        tgt_len = (b.tgt_out > 0).sum(1)  # the tokens and EOS
        assert ((src_len >= 8) & (src_len <= 24)).all()
        assert ((tgt_len >= 9) & (tgt_len <= 25)).all()
        assert b.src.max() < TINY.src_vocab_size and b.tgt_out.max() < TINY.tgt_vocab_size


def test_requests_draw_one_stream():
    draw, again = flagship.requests(TINY), flagship.requests(TINY)
    (s1, i1), (s2, i2) = draw(5), draw(5)
    assert s1 != s2
    r1, _ = again(5)
    assert r1 == s1
    for src in s1 + s2:
        assert 8 <= len(src) <= 24 and all(4 <= t < TINY.src_vocab_size for t in src)
    assert i1.shape == (5, TINY.img_feat_dim) and (i1 >= 0).all()
