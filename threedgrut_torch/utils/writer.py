"""Experiment tracking, port of threedgrut_tpu/utils/writer.py: TensorBoard
through `torch.utils.tensorboard` where it imports, and always a
`metrics.jsonl` file of one {"t", "step", tag: value} object per scalar.

TensorBoard is imported inside MetricsWriter.__init__ (it can pull in
TensorFlow and take seconds), never when this module is imported.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricsWriter:
    """TensorBoard SummaryWriter wrapper beside a JSONL metrics file."""

    def __init__(self, out_dir: str, experiment_name: str):
        self.dir = os.path.join(out_dir, experiment_name)
        os.makedirs(self.dir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            SummaryWriter = None
        if SummaryWriter is not None:
            self._tb = SummaryWriter(log_dir=self.dir)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        v = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, v, step)
        self._jsonl.write(json.dumps(
            {"t": time.time(), "step": step, tag: v}) + "\n")

    def scalars(self, values: dict, step: int, prefix: str = "") -> None:
        """Every entry of `values` that converts to a float."""
        for k, v in values.items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            self.scalar(f"{prefix}{k}", v, step)

    def image(self, tag: str, img: np.ndarray, step: int) -> None:
        """img: [H, W, 3] float in [0, 1] (TensorBoard only)."""
        if self._tb is not None:
            self._tb.add_image(tag, np.clip(img, 0, 1).transpose(2, 0, 1),
                               step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
        self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """Jet colormap for hit-count and depth panels: [...] in [0, 1] ->
    [..., 3]."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)
