"""``extract_features`` CLI of the port: ``python -m
variational_mmt_torch.cli.extract_features``. Mirrors
``variational_mmt_tpu/cli/extract_features.py``: an images directory and an
ordered file list -> a ``.npy`` or ``.h5`` file of ResNet-50 pool5 (N, 2048)
or conv (N, 49, 2048) features, row i aligned to list line i.

    python -m variational_mmt_torch.cli.extract_features -images_dir imgs \\
        -image_list train_images.txt -output train.feats.npy \\
        -weights resnet50-0676ba61.pth [-feat_type conv] [-batch_size 32]

Two backends:

- ``torch``: the port's trunk (``models/resnet.py``) over torchvision-layout
  weights (``-weights``, ``.pth`` or ``.npz``), float32 with TF32 off;
- ``torchvision`` (when installed): its ``resnet50(weights="IMAGENET1K_V1")``,
  as the reference pipeline used; torchvision fetches those weights itself.

``auto`` takes torchvision when it imports and no ``-weights`` is given,
else the port's trunk. Both run on ``-device`` (cuda unless ``-device
cpu``; an error without CUDA). Images are decoded and preprocessed one
batch at a time, so a Multi30k-size list is never held in memory. Needs
PIL (Pillow); ``.h5`` output needs h5py.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List

import numpy as np
import torch

from variational_mmt_torch.data.features import save_features
from variational_mmt_torch.models.resnet import (extract_features, f32_convolutions,
                                                 load_weights, preprocess_image)


def add_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-images_dir", required=True)
    p.add_argument("-image_list", required=True, help="file: one image filename per corpus line")
    p.add_argument("-output", required=True, help=".npy or .h5 output")
    p.add_argument("-feat_type", default="pool5", choices=["pool5", "conv"])
    p.add_argument("-batch_size", type=int, default=32)
    p.add_argument("-backend", default="auto", choices=["auto", "torch", "torchvision"],
                   help="auto: torchvision if importable and no -weights given, else the "
                        "port's torch trunk")
    p.add_argument("-weights", default="",
                   help="torchvision-layout ResNet state_dict (.pth or .npz) for the torch "
                        "backend (e.g. the standard resnet50 IMAGENET1K_V1 file)")
    p.add_argument("-device", default="cuda", help="cuda (default) or cpu")


def _image_module():
    try:
        from PIL import Image
    except ImportError as e:
        raise SystemExit(f"extracting features needs PIL (Pillow), which is not installed "
                         f"({e})") from None
    return Image


class LazyImages:
    """A sequence that decodes and preprocesses images when sliced, so
    ``extract_features`` streams the corpus one batch at a time (a
    Multi30k-size list preprocessed up front would take about 0.6 MB an
    image of host memory)."""

    def __init__(self, images_dir: str, names: List[str]):
        self.images_dir, self.names = images_dir, names
        self.Image = _image_module()

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self.names)))]
        return preprocess_image(self.Image.open(os.path.join(self.images_dir, self.names[i])))


def extract_torch(images_dir: str, names: List[str], feat_type: str, batch_size: int,
                  weights: str, device: torch.device) -> np.ndarray:
    if not weights:
        raise SystemExit(
            "the torch backend needs -weights (a torchvision-layout ResNet state_dict, .pth "
            "or .npz); this command downloads nothing. With torchvision installed, "
            "-backend torchvision uses its bundled download instead.")
    return extract_features(load_weights(weights), LazyImages(images_dir, names), feat_type,
                            batch_size, device=device)


def extract_torchvision(images_dir: str, names: List[str], feat_type: str, batch_size: int,
                        device: torch.device) -> np.ndarray:
    try:
        import torchvision
        from torchvision import transforms
    except ImportError as e:
        raise SystemExit(
            f"torchvision is required for -backend torchvision but is not installed ({e}). "
            "Use -backend torch with -weights, or supply precomputed features (HDF5/NPY, one "
            "row per corpus line), as the reference pipeline does.") from None
    Image = _image_module()
    model = torchvision.models.resnet50(weights="IMAGENET1K_V1")
    model.eval()
    keep = -1 if feat_type == "pool5" else -2  # up to avgpool (B,C,1,1) or layer4 (B,C,7,7)
    trunk = torch.nn.Sequential(*list(model.children())[:keep]).to(device)
    prep = transforms.Compose([
        transforms.Resize(256),
        transforms.CenterCrop(224),
        transforms.ToTensor(),
        transforms.Normalize(mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225]),
    ])
    feats = []
    with torch.inference_mode(), f32_convolutions():
        for s in range(0, len(names), batch_size):
            imgs = [prep(Image.open(os.path.join(images_dir, n)).convert("RGB"))
                    for n in names[s:s + batch_size]]
            out = trunk(torch.stack(imgs).to(device))
            B, C = out.shape[:2]
            out = out.reshape(B, C) if feat_type == "pool5" else \
                out.permute(0, 2, 3, 1).reshape(B, -1, C)
            feats.append(out.cpu().numpy())
    return np.concatenate(feats, axis=0)


def extract(images_dir: str, names: List[str], feat_type: str, batch_size: int,
            backend: str = "auto", weights: str = "", device=None) -> np.ndarray:
    """(N, C) or (N, h*w, C) features of ``names`` under ``images_dir``."""
    from variational_mmt_torch.cli.train import cli_device

    device = cli_device(device)
    if backend == "auto":
        try:
            import torchvision  # noqa: F401

            backend = "torch" if weights else "torchvision"
        except ImportError:
            backend = "torch"
    if backend == "torch":
        return extract_torch(images_dir, names, feat_type, batch_size, weights, device)
    return extract_torchvision(images_dir, names, feat_type, batch_size, device)


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser("vmmt-torch extract_features")
    add_args(p)
    opt = p.parse_args(argv)
    with open(opt.image_list, encoding="utf-8") as f:
        names = [line.strip() for line in f if line.strip()]
    t0 = time.perf_counter()
    feats = extract(opt.images_dir, names, opt.feat_type, opt.batch_size,
                    backend=opt.backend, weights=opt.weights, device=opt.device)
    seconds = time.perf_counter() - t0
    save_features(opt.output, feats)
    print(f"wrote {feats.shape} features to {opt.output}; extraction {seconds:.3f} s, "
          f"{len(names) / seconds:.1f} images/s (weights' load and image decoding included)")
    return feats


if __name__ == "__main__":
    main()
