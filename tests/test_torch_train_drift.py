"""PyTorch port: 100 train steps of the port against JAX's on the quality
gate's synthetic corpus (``tests/torch_train_drift.py``: tiny vmmt_c of
the gate's configuration, f32, CPU, dropout off, JAX's reparameterization
noise handed to the port each step). The loss and the KL sum of every step
agree within 1e-5 relative: a difference in Adam's count, the anneal's
step or the clip would open a gap that grows with the steps."""

import time

import pytest

import torch_train_drift as drift


def test_hundred_train_steps_hold_jax_step_by_step():
    t0 = time.time()
    rows = list(drift.run(100, seed=0))
    assert len(rows) == 100
    for row in rows:
        for k in ("loss", "kl"):
            assert row[f"{k}_port"] == pytest.approx(row[f"{k}_jax"], rel=1e-5, abs=1e-6), row
    assert all(row["kl_jax"] > 0 for row in rows)  # the latent carries information
    print(f"100 steps of both packages in {time.time() - t0:.1f} s")
