"""PyTorch port: the ``extract_features`` CLI against the JAX package's, and
``save_features`` / ``load_features``. The port's torch backend runs on the
CPU (``-device cpu``) beside JAX's jax backend on the same PNG files and
``.npz`` weights; the torchvision backend runs beside JAX's with the same
fake torchvision module (``tests/test_extract_features.py``)."""

import sys

import numpy as np
import pytest
from PIL import Image

from test_extract_features import _write_images, fake_torchvision  # noqa: F401
from test_resnet import make_state_dict
from variational_mmt_tpu.cli import extract_features as jax_cli
from variational_mmt_tpu.data.features import load_features as jax_load_features
from variational_mmt_torch.cli import extract_features as cli
from variational_mmt_torch.data.features import load_features, save_features


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(6)
    names = []
    for i, hw in enumerate([(40, 52), (48, 52), (300, 260), (64, 64), (90, 33)]):
        Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)).save(d / f"img{i}.png")
        names.append(f"img{i}.png")
    (d / "list.txt").write_text("\n".join(names) + "\n")
    np.savez(d / "w.npz", **make_state_dict(base=8, stages=(1, 1, 1, 1)))
    return d


@pytest.mark.parametrize("feat_type,ext", [("pool5", ".npy"), ("conv", ".npy"),
                                           ("pool5", ".h5"), ("conv", ".h5")])
def test_cli_torch_backend_matches_jax_cli(images, tmp_path, feat_type, ext):
    common = ["-images_dir", str(images), "-image_list", str(images / "list.txt"),
              "-weights", str(images / "w.npz"), "-feat_type", feat_type, "-batch_size", "2"]
    jax_cli.main(common + ["-output", str(tmp_path / f"jax{ext}"), "-backend", "jax"])
    got = cli.main(common + ["-output", str(tmp_path / f"port{ext}"), "-backend", "torch",
                             "-device", "cpu"])
    want = jax_load_features(str(tmp_path / f"jax{ext}"))
    assert got.shape == want.shape == ((5, 256) if feat_type == "pool5" else (5, 49, 256))
    np.testing.assert_allclose(load_features(str(tmp_path / f"port{ext}")), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(load_features(str(tmp_path / f"port{ext}")), got)


def test_auto_backend_without_torchvision_takes_the_trunk(images, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torchvision", None)
    names = ["img1.png", "img3.png"]
    auto = cli.extract(str(images), names, "pool5", 2, weights=str(images / "w.npz"),
                       device="cpu")
    torch_ = cli.extract(str(images), names, "pool5", 2, backend="torch",
                         weights=str(images / "w.npz"), device="cpu")
    np.testing.assert_array_equal(auto, torch_)


@pytest.mark.parametrize("feat_type", ["pool5", "conv"])
def test_torchvision_backend_matches_jax(fake_torchvision, tmp_path, feat_type):  # noqa: F811
    _write_images(str(tmp_path), [(255, 0, 0), (0, 255, 0), (0, 0, 255)])
    common = ["-images_dir", str(tmp_path), "-image_list", str(tmp_path / "list.txt"),
              "-feat_type", feat_type, "-batch_size", "2"]
    jax_cli.main(common + ["-output", str(tmp_path / "jax.npy")])
    got = cli.main(common + ["-output", str(tmp_path / "port.npy"), "-device", "cpu"])
    want = np.load(tmp_path / "jax.npy")
    assert got.shape == want.shape == ((3, 2048) if feat_type == "pool5" else (3, 49, 2048))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_torch_backend_refuses_without_weights(tmp_path):
    with pytest.raises(SystemExit, match="-weights"):
        cli.extract_torch(str(tmp_path), ["a.png"], "pool5", 2, "", "cpu")
    with pytest.raises(SystemExit, match="-weights"):
        cli.extract(str(tmp_path), ["a.png"], "pool5", 2, backend="torch", device="cpu")


def test_missing_pil_is_named(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(SystemExit, match="PIL"):
        cli.LazyImages(str(tmp_path), ["a.png"])
    from variational_mmt_torch.models.resnet import preprocess_image

    with pytest.raises(ImportError, match="PIL"):
        preprocess_image(None)


@pytest.mark.parametrize("shape", [(5, 16), (3, 49, 8)])
@pytest.mark.parametrize("ext", [".npy", ".h5", ".hdf5"])
def test_save_features_round_trips(tmp_path, shape, ext):
    feats = np.random.default_rng(7).standard_normal(shape)  # float64 in, float32 out
    path = str(tmp_path / f"f{ext}")
    save_features(path, feats)
    got = load_features(path)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, feats.astype(np.float32))
    np.testing.assert_array_equal(jax_load_features(path), got)


def test_save_features_refusals(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="unsupported"):
        save_features(str(tmp_path / "f.txt"), np.zeros((2, 3)))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match=r"h5py.*\.npy"):
        save_features(str(tmp_path / "f.h5"), np.zeros((2, 3)))
    assert not (tmp_path / "f.h5").exists()
