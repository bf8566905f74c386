"""ResNet-50 feature trunk for offline image-feature extraction. Mirrors
``variational_mmt_tpu/models/resnet.py``: the ResNet v1.5 inference trunk
(conv1 -> bn -> relu -> maxpool -> bottleneck stages -> global average
pool) over a state dict in torchvision's layout, so the standard
``resnet50-*.pth`` (IMAGENET1K_V1) file loads as it is.

- The stages are inferred from the ``layer{i}.{j}.*`` keys (``stage_sizes``),
  so reduced variants load through the same path.
- The stride sits on each stage's first 3x3 (v1.5, :117-118); the first
  block of a stage carries the downsample branch (:122-125).
- BatchNorm is the inference affine ``x * scale + (b - m * scale)`` with
  ``scale = g * 1 / sqrt(v + eps)`` (:107-108), computed once at load;
  folding it into the convolutions is left for later.
- The convolutions are cuDNN's (``F.conv2d``): JAX computes them with
  ``lax.conv_general_dilated`` outside any Pallas kernel (:87-96).
- ``forward`` computes in float32 with TF32 off for its own call
  (``f32_convolutions``), whatever the process's global flags say.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from variational_mmt_torch.device import resolve_device

BN_EPS = 1e-5
# ImageNet preprocessing constants (torchvision transforms defaults)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_weights(path: str) -> Dict[str, np.ndarray]:
    """A ResNet state dict from a torch ``.pth`` or a ``.npz``, as
    {torchvision key: float32 array}; the classifier head (``fc.*``) and
    ``num_batches_tracked`` are dropped. ``.pth`` goes through
    ``weights_only`` loading first and, when that refuses the file (a
    pickled module or another legacy pickle), through full unpickling with
    a warning."""
    if path.endswith(".npz"):
        raw = dict(np.load(path))
    else:
        try:
            sd = torch.load(path, map_location="cpu", weights_only=True)
        except Exception:
            import warnings

            warnings.warn(
                f"{path}: restricted (weights_only) torch.load failed; "
                "falling back to full unpickling — only load files you trust")
            sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):  # a full module was saved
            sd = sd.state_dict()
        raw = {k: v.numpy() for k, v in sd.items()}
    return {k: np.asarray(v, np.float32) for k, v in raw.items()
            if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}


def stage_sizes(params: Dict[str, object]) -> Tuple[int, ...]:
    """Blocks per stage, from the ``layer{i}.{j}.*`` keys."""
    counts: Dict[int, int] = {}
    for k in params:
        m = re.match(r"layer(\d+)\.(\d+)\.", k)
        if m:
            s, b = int(m.group(1)), int(m.group(2))
            counts[s] = max(counts.get(s, 0), b + 1)
    if not counts:
        raise ValueError("no layer{i}.{j}.* keys — not a ResNet state_dict")
    return tuple(counts[i] for i in sorted(counts))


@contextlib.contextmanager
def f32_convolutions():
    """cuDNN convolutions in float32 (TF32 off) inside the block; the
    previous setting comes back after it."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _buffer_name(key: str) -> str:
    return key.replace(".", "__")


class ResNetTrunk(nn.Module):
    """The inference trunk over a torchvision-layout state dict, on
    ``device`` (cuda unless ``device='cpu'``). ``forward`` takes (B, H, W, 3)
    float32 normalized images and returns ``(pool5 (B, C), conv (B, h*w,
    C))``: (B, 2048) and (B, 49, 2048) for ResNet-50 at 224x224."""

    def __init__(self, params: Dict[str, np.ndarray], device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.stages = stage_sizes(params)
        for k, v in params.items():
            if k.endswith(".weight") and np.ndim(v) == 4:
                # OIHW; channels_last, as the activations are
                w = torch.tensor(np.asarray(v, np.float32))
                self.register_buffer(_buffer_name(k), w.contiguous(
                    memory_format=torch.channels_last))
        for prefix in (k[:-len(".running_mean")] for k in params
                       if k.endswith(".running_mean")):
            g, b, m, v = (torch.tensor(np.asarray(params[f"{prefix}.{n}"], np.float32))
                          for n in ("weight", "bias", "running_mean", "running_var"))
            scale = g * torch.reciprocal(torch.sqrt(v + BN_EPS))
            self.register_buffer(_buffer_name(prefix + ".scale"), scale.view(1, -1, 1, 1))
            self.register_buffer(_buffer_name(prefix + ".shift"),
                                 (b - m * scale).view(1, -1, 1, 1))
        self.to(self.device)
        self.eval()

    def _has(self, key: str) -> bool:
        return hasattr(self, _buffer_name(key))

    def _w(self, key: str) -> torch.Tensor:
        return getattr(self, _buffer_name(key))

    def _conv(self, x, key: str, stride: int, pad: int):
        return F.conv2d(x, self._w(key), stride=stride, padding=pad)

    def _bn(self, x, prefix: str):
        return x * self._w(prefix + ".scale") + self._w(prefix + ".shift")

    def _bottleneck(self, x, p: str, stride: int):
        out = F.relu(self._bn(self._conv(x, f"{p}.conv1.weight", 1, 0), f"{p}.bn1"))
        # v1.5: the stride lives on the 3x3
        out = F.relu(self._bn(self._conv(out, f"{p}.conv2.weight", stride, 1), f"{p}.bn2"))
        out = self._bn(self._conv(out, f"{p}.conv3.weight", 1, 0), f"{p}.bn3")
        identity = x
        if self._has(f"{p}.downsample.0.weight"):
            identity = self._bn(self._conv(x, f"{p}.downsample.0.weight", stride, 0),
                                f"{p}.downsample.1")
        return F.relu(out + identity)

    def trunk_nchw(self, x: torch.Tensor) -> torch.Tensor:
        """The trunk on NCHW images, at the precision the caller's cuDNN
        flags give; returns the last stage's (B, C, h, w) map."""
        x = F.relu(self._bn(self._conv(x, "conv1.weight", 2, 3), "bn1"))
        # max_pool2d pads with -inf, as JAX's reduce_window does (:140-143)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for si, n_blocks in enumerate(self.stages, start=1):
            for bi in range(n_blocks):
                x = self._bottleneck(x, f"layer{si}.{bi}", 2 if (si > 1 and bi == 0) else 1)
        return x

    def forward(self, images_nhwc) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.as_tensor(images_nhwc).to(self.device, torch.float32)
        # NHWC memory seen as NCHW is a channels_last tensor, the layout
        # cuDNN's NHWC convolutions take without a transpose
        with f32_convolutions():
            x = self.trunk_nchw(x.permute(0, 3, 1, 2))
        B, C, h, w = x.shape
        # h-major then w, as JAX's NHWC reshape (:148-149)
        conv = x.permute(0, 2, 3, 1).reshape(B, h * w, C)
        return x.mean(dim=(2, 3)), conv


def preprocess_image(img, size: int = 224, resize_to: int = 256) -> np.ndarray:
    """PIL image -> normalized (size, size, 3) float32, as torchvision's
    Resize(256) + CenterCrop(224) + ToTensor + Normalize: a bilinear resize
    of the shorter side with the long side truncated to int, crop offsets
    by Python's round() (half to even)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("preprocess_image needs PIL (Pillow), which is not installed") from e

    img = img.convert("RGB")
    w, h = img.size
    if w <= h:
        nw, nh = resize_to, max(1, int(h * resize_to / w))
    else:
        nh, nw = resize_to, max(1, int(w * resize_to / h))
    img = img.resize((nw, nh), Image.BILINEAR)
    left = int(round((nw - size) / 2.0))
    top = int(round((nh - size) / 2.0))
    img = img.crop((left, top, left + size, top + size))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def extract_features(params: Dict[str, np.ndarray], images, feat_type: str = "pool5",
                     batch_size: int = 32, device=None) -> np.ndarray:
    """Batches of preprocessed (H, W, 3) arrays (a sequence, sliced one
    batch at a time) through the trunk on ``device``. Returns (N, C) for
    pool5 or (N, h*w, C) for conv. The last batch is not padded: row i
    depends on image i alone."""
    if feat_type not in ("pool5", "conv"):
        raise ValueError(f"feat_type must be pool5 or conv, got {feat_type!r}")
    trunk = ResNetTrunk(params, device)
    out = []
    with torch.inference_mode():
        for s in range(0, len(images), batch_size):
            batch = torch.from_numpy(np.stack(list(images[s:s + batch_size])))
            pool5, conv = trunk(batch)
            out.append((pool5 if feat_type == "pool5" else conv).cpu().numpy())
    return np.concatenate(out, axis=0)
