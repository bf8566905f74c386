"""Structured metric logs. A copy of ``MetricsLogger`` of
``variational_mmt_tpu/utils/metrics_log.py``: JSON lines of
``{step, wall_time, prefix/name: value}`` and, with a directory, TensorBoard
scalar events.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str], tensorboard_dir: Optional[str] = None):
        self.path = path
        self._f = None
        self._tb = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", encoding="utf-8")
        if tensorboard_dir:
            from variational_mmt_torch.utils.tensorboard import TensorBoardWriter

            self._tb = TensorBoardWriter(tensorboard_dir)

    def log(self, step: int, scalars: Dict[str, float], prefix: str = "") -> None:
        if self._tb is not None:
            self._tb.log(step, {k: float(v) for k, v in scalars.items()}, prefix)
        if self._f is None:
            return
        rec = {"step": step, "wall_time": time.time()}
        for k, v in scalars.items():
            rec[(prefix + "/" + k) if prefix else k] = float(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
