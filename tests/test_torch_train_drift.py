"""PyTorch port: 100 train steps of the port against JAX's on the quality
gate's synthetic corpus (``tests/torch_train_drift.py``: tiny vmmt_c of
the gate's configuration, f32, CPU, dropout off, JAX's reparameterization
noise handed to the port each step). The loss and the KL sum of every step
agree within 1e-5 relative: a difference in Adam's count, the anneal's
step or the clip would open a gap that grows with the steps. Two cases:
pooled image features, and 4 region features pooled by attention (the
gate's ``-img_regions 4 -img_pool attn``)."""

import time

import pytest

import torch_train_drift as drift


@pytest.mark.parametrize("regions", [0, 4], ids=["pool5", "regions_attn"])
def test_hundred_train_steps_hold_jax_step_by_step(regions):
    t0 = time.time()
    rows = list(drift.run(100, seed=0, regions=regions))
    assert len(rows) == 100
    for row in rows:
        for k in ("loss", "kl"):
            assert row[f"{k}_port"] == pytest.approx(row[f"{k}_jax"], rel=1e-5, abs=1e-6), row
    assert all(row["kl_jax"] > 0 for row in rows)  # the latent carries information
    print(f"100 steps of both packages ({regions} regions) in {time.time() - t0:.1f} s")
