"""Image-feature loading, row i aligned to corpus line i. Mirrors
``load_features`` of ``variational_mmt_tpu/data/features.py`` (:19-82).

``.npy`` and ``.npz`` need numpy only. HDF5 goes through ``h5py``,
imported inside the call; a machine without it gets an error that says so
(the card's machine has none: convert the file to ``.npy`` there).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def load_features(path: str, split: Optional[str] = None, mmap: bool = False) -> np.ndarray:
    """An (N, D) or (N, R, D) feature array. HDF5 and ``.npz``: the dataset
    named ``split``, else the only one (HDF5 also takes feats / features /
    data). Conv maps (N, 7, 7, C) or (N, C, 7, 7) become (N, 49, C)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".h5", ".hdf5"):
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"{path}: reading HDF5 features needs h5py, which is not "
                              "installed; convert the file to .npy (numpy.save)") from e
        with h5py.File(path, "r") as f:
            keys = list(f.keys())
            if split is not None:
                if split not in f:
                    raise KeyError(f"split {split!r} not in {path} (has {keys})")
                key = split
            elif len(keys) == 1:
                key = keys[0]
            else:
                key = next((c for c in ("feats", "features", "data") if c in f), None)
                if key is None:
                    raise KeyError(f"ambiguous HDF5 datasets {keys} in {path}; pass split=")
            arr = np.asarray(f[key], np.float32)
    elif ext == ".npy":
        if split is not None:
            raise ValueError(f"{path} is a single-array .npy and cannot honor split={split!r}")
        arr = np.load(path, mmap_mode="r" if mmap else None)
    elif ext == ".npz":
        z = np.load(path)
        if split is not None and split not in z:
            raise KeyError(f"split {split!r} not in {path} (has {list(z.keys())})")
        arr = np.asarray(z[split if split is not None else list(z.keys())[0]], np.float32)
    else:
        raise ValueError(f"unsupported feature file: {path}")
    arr = np.asarray(arr)
    if arr.ndim == 4:  # conv maps -> (N, H*W, C)
        if arr.shape[1] == arr.shape[2]:  # NHWC
            n, h, w, c = arr.shape
            arr = arr.reshape(n, h * w, c)
        else:  # NCHW
            n, c, h, w = arr.shape
            arr = arr.transpose(0, 2, 3, 1).reshape(n, h * w, c)
    return arr
