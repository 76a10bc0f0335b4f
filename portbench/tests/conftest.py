"""Shared pieces of the benchmark's own tests: the repository root on the
path, the `cuda` marker, and each cell shrunk to a size the CPU renders
in seconds with the program's plain paths."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA card (skips without one)")


def shrink(cfg: dict, traffic: dict):
    """The cell at a CPU size: 3,000 particles, 64x48 views on a ring of
    16 captures (14 for training), 96x64 fly-through frames, 48x48 hybrid
    frames, a few traced units."""
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["particles"] = 3000
    if "scene" in cfg:
        cfg["scene"].update(width=64, height=48, focal=60.0, captures=16,
                            train_views=14)
    cfg["isect_capacity"] = 1 << 20
    traffic["trace_steps"] = 3
    if traffic["kind"] == "hybrid":
        traffic.update(width=48, height=48, focal=45.0, max_frames=16,
                       warm_frames=1, trace_frames=2, check_frames=1,
                       check_within=1)
        cfg["engine"]["candidate_capacity"] = 4096
    if traffic["kind"] == "video":
        traffic.update(width=96, height=64, max_frames=32, trace_frames=6,
                       check_frames=2, check_within=4,
                       isect_capacity=1 << 16)
    return cfg, traffic


@pytest.fixture
def small_cell():
    from portbench import run

    def make(workload: str):
        manifest, w, cfg, traffic, limits = run.cell(workload)
        cfg, traffic = shrink(cfg, traffic)
        return manifest, w, cfg, traffic, limits
    return make
