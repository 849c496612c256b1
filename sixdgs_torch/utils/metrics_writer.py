"""Metrics/observability: JSONL scalar logging + optional TensorBoard.

Copy of sixdgs_tpu/utils/metrics_writer.py (it imports no JAX).

Replaces the reference's SummaryWriter usage (reference train.py:210-298,
pose_estimation/train.py:51-56,190-303) with an
always-available JSON-lines writer; if the tensorboard package exists, scalars
are mirrored there too.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, log_dir: str, filename: str = "metrics.jsonl",
                 use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._fh = open(self.path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"t": time.time(), "tag": tag, "value": float(value), "step": int(step)}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def text(self, tag: str, value: str) -> None:
        rec = {"t": time.time(), "tag": tag, "text": value}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            self._tb.add_text(tag, value)

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
