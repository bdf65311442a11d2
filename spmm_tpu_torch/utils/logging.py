"""Minimal metric logging (copy of ``spmm_tpu.utils.logging``; SURVEY §5.5:
replaces the reference's rank-0 prog-bar self.log + print statements).

Writes JSONL metric records (step, wallclock, metrics) and keeps running
means for console summaries; pluggable into TensorBoard via the JSONL.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Mapping, Optional


class MetricLogger:
    def __init__(self, log_path: Optional[str] = None, window: int = 1000):
        self.log_path = log_path
        self._window: dict[str, deque] = {}
        self._window_size = window
        self._fh = None
        if log_path:
            os.makedirs(os.path.dirname(os.path.abspath(log_path)),
                        exist_ok=True)
            self._fh = open(log_path, "a")

    def log(self, step: int, metrics: Mapping[str, Any]):
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            v = float(v)
            record[k] = v
            self._window.setdefault(
                k, deque(maxlen=self._window_size)).append(v)
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    def mean(self, key: str) -> float:
        w = self._window.get(key)
        return sum(w) / len(w) if w else float("nan")

    def summary(self) -> dict[str, float]:
        return {k: self.mean(k) for k in self._window}

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
