"""PyTorch port: the ResNet feature trunk (``variational_mmt_torch/models/
resnet.py``) against the JAX package's ``resnet_apply`` on the same
random torchvision-layout weights (``tests/test_resnet.py``'s
``make_state_dict``), in float32 on the CPU; ``load_weights``,
``preprocess_image`` and ``extract_features`` against JAX's."""

import numpy as np
import pytest
import torch
from PIL import Image

from test_resnet import make_state_dict
from variational_mmt_tpu.models import resnet as jax_resnet
from variational_mmt_torch.models import resnet


def port_apply(sd, imgs):
    with torch.inference_mode():
        pool5, conv = resnet.ResNetTrunk(sd, device="cpu")(torch.from_numpy(imgs))
    return pool5.numpy(), conv.numpy()


@pytest.mark.parametrize("batch", [1, 2])
def test_reduced_trunk_matches_jax(batch):
    sd = make_state_dict(base=8, stages=(1, 1, 1, 1))
    imgs = np.random.default_rng(1).standard_normal((batch, 64, 64, 3)).astype(np.float32)
    want_pool, want_conv = (np.asarray(a) for a in jax_resnet.resnet_apply(sd, imgs))
    pool5, conv = port_apply(sd, imgs)
    assert pool5.shape == (batch, 256) and conv.shape == (batch, 4, 256)
    np.testing.assert_allclose(pool5, want_pool, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(conv, want_conv, rtol=1e-4, atol=2e-4)


def test_full_resnet50_layout_matches_jax():
    """The real ResNet-50 layout (base 64, stages 3-4-6-3) at a 64x64 input:
    a 2x2 final map, so conv's h-major flattening is checked too."""
    sd = make_state_dict(base=64, stages=(3, 4, 6, 3), seed=2)
    assert resnet.stage_sizes(sd) == jax_resnet.stage_sizes(sd) == (3, 4, 6, 3)
    img = np.random.default_rng(3).standard_normal((1, 64, 64, 3)).astype(np.float32)
    want_pool, want_conv = (np.asarray(a) for a in jax_resnet.resnet_apply(sd, img))
    pool5, conv = port_apply(sd, img)
    assert pool5.shape == (1, 2048) and conv.shape == (1, 4, 2048)
    np.testing.assert_allclose(pool5, want_pool, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(conv, want_conv, rtol=1e-3, atol=1e-3)


def test_full_resnet50_shapes_at_224():
    sd = make_state_dict(base=64, stages=(3, 4, 6, 3), seed=2)
    img = np.random.default_rng(4).standard_normal((1, 224, 224, 3)).astype(np.float32)
    pool5, conv = port_apply(sd, img)
    assert pool5.shape == (1, 2048) and conv.shape == (1, 49, 2048)
    assert np.isfinite(pool5).all() and np.isfinite(conv).all()
    # pool5 is the mean of the 49 regions
    np.testing.assert_allclose(pool5[0], conv[0].mean(axis=0), rtol=1e-5, atol=1e-5)


def test_load_weights_npz_and_pth_match_jax(tmp_path):
    sd = make_state_dict(base=8, stages=(1, 1, 1, 1))
    extra = dict(sd, **{"fc.weight": np.zeros((10, 128), np.float32),
                        "bn1.num_batches_tracked": np.array(7, np.int64)})
    np.savez(tmp_path / "w.npz", **extra)
    torch.save({k: torch.as_tensor(v) for k, v in extra.items()}, tmp_path / "w.pth")
    for name in ("w.npz", "w.pth"):
        got = resnet.load_weights(str(tmp_path / name))
        want = jax_resnet.load_weights(str(tmp_path / name))
        assert set(got) == set(want) == set(sd)
        for k in sd:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("hw", [(300, 400), (466, 350), (479, 256)])
def test_preprocess_matches_jax(hw):
    """JAX's three geometry cases (tests/test_resnet.py): the long side
    truncated, crop offsets rounded half to even."""
    raw = np.random.default_rng(4).integers(0, 256, hw + (3,), dtype=np.uint8)
    got = resnet.preprocess_image(Image.fromarray(raw))
    want = jax_resnet.preprocess_image(Image.fromarray(raw))
    assert got.shape == (224, 224, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("feat_type", ["pool5", "conv"])
def test_extract_features_matches_jax_and_rows_stand_alone(feat_type):
    """5 images at batch 4: equal to JAX's padded extraction, and the last,
    partial batch's row equal to that image run alone."""
    sd = make_state_dict(base=8, stages=(1, 1, 1, 1))
    rng = np.random.default_rng(5)
    imgs = [rng.standard_normal((64, 64, 3)).astype(np.float32) for _ in range(5)]
    got = resnet.extract_features(sd, imgs, feat_type, batch_size=4, device="cpu")
    want = jax_resnet.extract_features(sd, imgs, feat_type, batch_size=4)
    assert got.shape == want.shape == ((5, 256) if feat_type == "pool5" else (5, 4, 256))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)
    solo = resnet.extract_features(sd, imgs[4:], feat_type, batch_size=4, device="cpu")
    np.testing.assert_allclose(got[4], solo[0], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="feat_type"):
        resnet.extract_features(sd, imgs, "fc", device="cpu")


def test_forward_restores_the_tf32_flag():
    sd = make_state_dict(base=8, stages=(1, 1, 1, 1))
    trunk = resnet.ResNetTrunk(sd, device="cpu")
    prev = torch.backends.cudnn.allow_tf32
    seen = []
    run = trunk.trunk_nchw
    trunk.trunk_nchw = lambda x: seen.append(torch.backends.cudnn.allow_tf32) or run(x)
    try:
        torch.backends.cudnn.allow_tf32 = True
        trunk(torch.zeros(1, 32, 32, 3))
        assert seen == [False] and torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
