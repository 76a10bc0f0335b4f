"""Timers, port of threedgrut_tpu/utils/timer.py: a host-scoped timer with a
registry, and a device timer.

CUDA launches return before the device finishes, so DeviceTimer waits for
the device: on a card it records a pair of CUDA events around the call and
synchronizes on the second; on the CPU it takes the host clock (the work is
done when the call returns). It never reads a value back to wait.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, Optional

import numpy as np
import torch


class TimingRegistry:
    """Named lists of elapsed seconds."""

    def __init__(self):
        self._samples: Dict[str, list] = collections.defaultdict(list)

    def add(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self._samples.items():
            arr = np.asarray(v)
            out[k] = {"mean_s": float(arr.mean()),
                      "total_s": float(arr.sum()), "count": int(arr.size)}
        return out

    def reset(self) -> None:
        self._samples.clear()


# The registry ScopedTimer uses unless it is given one.
REGISTRY = TimingRegistry()


def timings_summary() -> Dict[str, Dict[str, float]]:
    return REGISTRY.summary()


def reset_timings() -> None:
    REGISTRY.reset()


class ScopedTimer:
    """with ScopedTimer("name"): ... adds the block's host seconds to
    `registry` (REGISTRY by default)."""

    def __init__(self, name: str, enabled: bool = True,
                 registry: Optional[TimingRegistry] = None):
        self.name = name
        self.enabled = enabled
        self.registry = REGISTRY if registry is None else registry

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self.registry.add(self.name, time.perf_counter() - self.t0)
        return False


class DeviceTimer:
    """Wall time of a callable on `device` including its device work, over
    the last `window` calls."""

    def __init__(self, device="cpu", window: int = 100):
        self.device = torch.device(device)
        self.samples = collections.deque(maxlen=window)

    def measure(self, fn, *args):
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            out = fn(*args)
            self.samples.append(time.perf_counter() - t0)
            return out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        self.samples.append(start.elapsed_time(end) / 1e3)
        return out

    @property
    def mean_ms(self) -> float:
        return 1000.0 * float(np.mean(self.samples)) if self.samples else 0.0
