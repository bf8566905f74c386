"""``-profile_dir``: a ``torch.profiler`` trace of a region. Mirrors
``trace`` of ``variational_mmt_tpu/utils/profiling.py``: with a directory,
the region runs under the profiler (the CPU, and CUDA when the region's
device is a card) and its Chrome trace is written to
``<dir>/trace.json`` (open it in ui.perfetto.dev); without one, nothing
happens."""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str], cuda: bool = False) -> Iterator[None]:
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"wrote profiler trace {path}")
