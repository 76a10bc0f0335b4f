"""The traced window: torch.profiler over whole steps or frames, and its
reduction to what the per-layer metric readers read.

From the device timeline: the busy time (the union of kernel, memcpy and
memset intervals), kernel time by name, the device span of each
record_function label (its gpu_user_annotation intervals, merged), and the
idle gaps between busy intervals, each put down to the host operation the
calling thread was inside at the gap's midpoint.
"""
from __future__ import annotations

import bisect
import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def total(intervals) -> float:
    return sum(b - a for a, b in intervals)


class Trace:
    """A reduced device trace; times in seconds."""

    def __init__(self, events: list, window_s: float, units: int):
        self.window_s = window_s
        self.units = units
        dev = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.busy = merge([(e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0))
                            * 1e-6) for e in dev])
        self.busy_s = total(self.busy)
        self.kernels = [(e["name"], e.get("dur", 0) * 1e-6) for e in dev
                        if e.get("cat") == "kernel"]
        self.annotations: Dict[str, list] = {}
        for e in events:
            if e.get("cat") == "gpu_user_annotation":
                self.annotations.setdefault(e["name"], []).append(
                    (e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6))
        self.host = [e for e in events if e.get("cat") in (
            "cpu_op", "user_annotation") and "dur" in e]

    def span_s(self, match: Callable[[str], bool]) -> float:
        """Device seconds under the labels that `match`, overlaps once."""
        iv = [x for name, ivs in self.annotations.items() if match(name)
              for x in ivs]
        return total(merge(iv))

    def kernel_s(self, pattern: str) -> float:
        return sum(d for n, d in self.kernels if pattern in n)

    def device_ops(self, k: int = 10):
        by = {}
        for n, d in self.kernels:
            by[n] = by.get(n, 0.0) + d
        return [[n[:96], s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10):
        """Idle seconds between busy intervals by the innermost host
        operation of the launching thread around each gap's midpoint."""
        if not self.busy:
            return []
        tids = {}
        for e in self.host:
            tids[e["tid"]] = tids.get(e["tid"], 0) + 1
        main = max(tids, key=tids.get) if tids else None
        ops = sorted(((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                       e["name"]) for e in self.host if e["tid"] == main))
        starts = [o[0] for o in ops]
        gaps = [(a_end, b_start) for (_, a_end), (b_start, _) in
                zip(self.busy, self.busy[1:]) if b_start > a_end]
        by = {}
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            i = bisect.bisect_right(starts, mid)
            name = "_no_host_op_"
            # The innermost enclosing operation starts last among those
            # that contain the midpoint; look back over a bounded stretch.
            for j in range(i - 1, max(-1, i - 400), -1):
                if ops[j][1] >= mid:
                    name = ops[j][2]
                    break
            by[name] = by.get(name, 0.0) + (g1 - g0)
        return [[n[:96], s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def traced(run_units: Callable[[], int], out_dir: Path) -> Trace:
    """Run run_units() (which returns how many whole steps or frames it
    ran) under the profiler, synchronized at both ends, and reduce it."""
    from torch.profiler import ProfilerActivity, profile
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        units = run_units()
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events, window_s, units)
