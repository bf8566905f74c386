"""The input pipeline's host C++ (``batcher.cpp``, ``packer.cpp``,
``bpe.cpp``), built at first use and loaded with ctypes. Mirrors
``variational_mmt_tpu/native/__init__.py``: the same three sources (copied
here), entry points and ctypes signatures.

The sources are compiled together by ``g++ -O3 -shared -fPIC``, with
``-march=native`` first and without it if that fails, into one library
under ``build/vmmt_torch_native/`` at the repo root. Its name carries a
hash of the sources and the flags (with ``-march=native`` also of the
target g++ expands it to, so a library built on another CPU is never
taken), so it is rebuilt only when one of them changes. Each build writes
a per-process temporary file and renames it into place: serving
dispatchers and test workers may build at once. Only a library that this
user owns and that nobody else can write is loaded.

:func:`available` is False only with a reason, :func:`unavailable_reason`:
no ``g++``, the compiler's error output, a library refused for its owner
or mode, or the loader's error. The reason is logged once. Callers then take the Python
paths, which give the same arrays and segmentations. Nothing here imports
torch (the serving dispatchers import BPE) or builds at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import stat
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

HERE = Path(__file__).resolve().parent
SOURCES = ("batcher.cpp", "bpe.cpp", "packer.cpp")
BUILD_DIR = HERE.parent.parent / "build" / "vmmt_torch_native"
FLAGS = ("-O3", "-shared", "-fPIC")
FLAG_SETS = (("-march=native",), ())  # -march=native may be refused
MAX_SEGMENTS = 16  # packer.cpp's OpenRow holds at most 16 segments a row
NO_GXX = "no g++"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_REASON: Optional[str] = None


def _gxx() -> Optional[str]:
    return shutil.which("g++")


def _target(gxx: str, extra: Tuple[str, ...]) -> bytes:
    """What ``-march=native`` means on this host: the compiler proper's
    command line, with every -m option it expands to (empty without it)."""
    if "-march=native" not in extra:
        return b""
    out = subprocess.run([gxx, *extra, "-E", "-v", "-x", "c++", os.devnull],
                         capture_output=True, timeout=60)
    return b"\n".join(line for line in out.stderr.splitlines() if b"-march=" in line)


def _lib_path(gxx: str, extra: Tuple[str, ...]) -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((HERE / name).read_bytes())
    h.update(" ".join(FLAGS + extra).encode())
    h.update(_target(gxx, extra))
    return BUILD_DIR / f"libvmmt_native-{h.hexdigest()[:12]}.so"


def _build(gxx: str, extra: Tuple[str, ...], out: Path) -> Optional[str]:
    """Compile into ``out``; None on success, else the compiler's output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [gxx, *FLAGS, *extra, *(str(HERE / s) for s in SOURCES), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        return f"{' '.join(cmd)}: no result in 300 s"
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        return f"{' '.join(cmd)}: exit {proc.returncode}\n{proc.stderr.strip()}"
    os.chmod(tmp, 0o755)
    os.replace(tmp, out)
    return None


def _safe_to_load(path: Path) -> bool:
    """Owned by this user and writable by nobody else."""
    st = os.stat(path)
    return st.st_uid == os.getuid() and not st.st_mode & (stat.S_IWGRP | stat.S_IWOTH)


def _open(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.assemble_batch.restype = None
    lib.gather_rows_f32.restype = None
    lib.bpe_create.restype = ctypes.c_void_p
    lib.bpe_create.argtypes = [ctypes.c_char_p]
    lib.bpe_free.argtypes = [ctypes.c_void_p]
    lib.bpe_segment.restype = ctypes.c_int64
    lib.bpe_segment.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_int64]
    lib.pack_plan.restype = ctypes.c_int64
    lib.assemble_packed.restype = None
    return lib


def _find() -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    """(library, None) or (None, why not)."""
    gxx = _gxx()
    if gxx is None:
        return None, NO_GXX
    paths = [(extra, _lib_path(gxx, extra)) for extra in FLAG_SETS]
    built = [p for _, p in paths if p.exists()]
    errors = []
    if not built:
        for extra, path in paths:
            err = _build(gxx, extra, path)
            if err is None:
                built = [path]
                break
            errors.append(err)
    if not built:
        return None, "g++ failed:\n" + "\n".join(errors)
    if not _safe_to_load(built[0]):
        return None, (f"{built[0]} is not owned by this user or is writable by others: "
                      "not loaded")
    try:
        return _open(built[0]), None
    except (OSError, AttributeError) as e:  # not a library, or one without these symbols
        return None, f"{built[0]} does not load: {e}"


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _REASON
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            _LIB, _REASON = _find()
            if _LIB is None:
                log.warning("native host code unavailable, taking the Python paths: %s",
                            _REASON)
        return _LIB


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why :func:`available` is False (None when it is True)."""
    _load()
    return _REASON


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_REASON}")
    return lib


def _p(a: Optional[np.ndarray], t):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(t))


def assemble_batch(src_data: np.ndarray, src_off: np.ndarray,
                   tgt_data: Optional[np.ndarray], tgt_off: Optional[np.ndarray],
                   indices: np.ndarray, B: int, L: int, bos: int, eos: int, pad: int):
    """(src, tgt_in, tgt_out, indices, mask) of one (B, L) batch as fresh
    arrays (batcher.cpp). Without a target side tgt_in and tgt_out are all
    ``pad``."""
    lib = _lib()
    out_src, out_tin, out_tout = (np.empty((B, L), np.int32) for _ in range(3))
    out_idx = np.empty((B,), np.int32)
    out_mask = np.empty((B,), np.float32)
    idx64 = np.ascontiguousarray(indices, np.int64)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.assemble_batch(
        _p(src_data, i32), _p(src_off, i64), _p(tgt_data, i32), _p(tgt_off, i64),
        _p(idx64, i64), i64(len(idx64)), i64(B), i64(L), i32(bos), i32(eos), i32(pad),
        _p(out_src, i32), _p(out_tin, i32), _p(out_tout, i32), _p(out_idx, i32),
        _p(out_mask, ctypes.c_float))
    return out_src, out_tin, out_tout, out_idx, out_mask


def gather_rows(feats: np.ndarray, indices: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """``feats[indices]`` in f32 with the rows of mask 0 zeroed
    (batcher.cpp); ``feats`` should already be contiguous f32."""
    lib = _lib()
    feats = np.ascontiguousarray(feats, np.float32)
    B = len(indices)
    out = np.empty((B,) + feats.shape[1:], np.float32)
    lib.gather_rows_f32(
        _p(feats, ctypes.c_float), ctypes.c_int64(int(np.prod(feats.shape[1:]))),
        _p(np.ascontiguousarray(indices, np.int32), ctypes.c_int32), ctypes.c_int64(B),
        _p(np.ascontiguousarray(mask, np.float32), ctypes.c_float),
        _p(out, ctypes.c_float))
    return out


def pack_plan(src_off: np.ndarray, tgt_off: np.ndarray, order: np.ndarray,
              B: int, L: int, K: int):
    """Greedy first-fit packing plan of one epoch (packer.cpp): (row_off
    int64 (n_rows+1,), row_examples int64 (n,)), the corpus indices of
    each packed row; batch b is rows [b*B, (b+1)*B)."""
    lib = _lib()
    if K > MAX_SEGMENTS:
        raise ValueError(f"the native packer holds at most {MAX_SEGMENTS} segments a row, "
                         f"got {K}")
    i64 = ctypes.c_int64
    order64 = np.ascontiguousarray(order, np.int64)
    n = len(order64)
    row_off = np.empty(n + 1, np.int64)
    row_examples = np.empty(max(n, 1), np.int64)
    n_rows = lib.pack_plan(
        _p(np.ascontiguousarray(src_off, np.int64), i64),
        _p(np.ascontiguousarray(tgt_off, np.int64), i64), _p(order64, i64), i64(n),
        i64(B), i64(L), i64(K), _p(row_off, i64), _p(row_examples, i64))
    if n_rows < 0:
        raise RuntimeError("native pack_plan rejected its arguments")
    return row_off[: n_rows + 1], row_examples[:n]


def assemble_packed(src_data, src_off, tgt_data, tgt_off, row_off, row_examples,
                    row0: int, n_rows: int, B: int, L: int, K: int,
                    bos: int, eos: int, pad: int):
    """One packed batch from a :func:`pack_plan` (packer.cpp): (src,
    tgt_in, tgt_out, src_seg, tgt_seg, seg_first, seg_last, indices,
    seg_mask) as fresh arrays."""
    lib = _lib()
    ids = [np.empty((B, L), np.int32) for _ in range(5)]  # src, tgt_in, tgt_out, segs
    per_seg = [np.empty((B, K), np.int32) for _ in range(3)]  # first, last, indices
    seg_mask = np.empty((B, K), np.float32)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.assemble_packed(
        _p(src_data, i32), _p(src_off, i64), _p(tgt_data, i32), _p(tgt_off, i64),
        _p(np.ascontiguousarray(row_off, np.int64), i64),
        _p(np.ascontiguousarray(row_examples, np.int64), i64),
        i64(row0), i64(n_rows), i64(B), i64(L), i64(K), i32(bos), i32(eos), i32(pad),
        *(_p(a, i32) for a in ids + per_seg), _p(seg_mask, ctypes.c_float))
    return (*ids, *per_seg, seg_mask)


class NativeBPE:
    """C++ BPE segmenter handle (bpe.cpp), byte-identical to
    ``data/bpe.py``'s Python loop."""

    def __init__(self, merges):
        self._lib = _lib()
        txt = "\n".join(f"{a} {b}" for a, b in merges) + "\n"
        self._h = self._lib.bpe_create(txt.encode("utf-8"))

    def segment_word(self, word: str, cap: int = 4096):
        # a buffer a call: ctypes releases the GIL during the C call and the
        # threaded serving front end segments concurrently
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.bpe_segment(self._h, word.encode("utf-8"), buf, len(buf))
        if n < 0:  # a word longer than the buffer
            return self.segment_word(word, 4 * cap)
        return buf.value.decode("utf-8").split(" ") if n else []

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.bpe_free(h)
