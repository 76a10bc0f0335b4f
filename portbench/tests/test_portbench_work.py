"""The frozen work counts and the trace reduction on inputs whose answers
are worked out by hand."""
from __future__ import annotations

import pytest
import torch

from portbench import tracing, work


def test_bound_is_the_larger_of_bytes_and_operations():
    assert work.bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert work.bound_ms(0, 67e9) == pytest.approx(1.0)
    assert work.bound_ms(3.35e9, 134e9) == pytest.approx(2.0)


def test_walked_windows_count_the_windows_a_walk_touches():
    walked = torch.tensor([0.0, 1.0, 128.0, 129.0, 10.0])
    starts = torch.tensor([0, 0, 0, 0, 125])
    # none; [0, 1); [0, 128); [0, 129) spans two; [125, 135) spans two.
    assert work.walked_windows(walked, starts) == 0 + 1 + 1 + 2 + 2


def test_b1_work_counts_rays_rows_and_pairs():
    walked = torch.tensor([10.0, 0.0])
    starts = torch.tensor([0, 10])
    nbytes, ops = work.b1_work(2, walked, starts, mask=False)
    assert nbytes == 2 * 8 * 256 * 4 * 2 + 2 * 8 + 10 * 64
    assert ops == (work.FLOP_PAIR - work.FLOP_PAIR_ROW) * 256 * 10 \
        + work.FLOP_PAIR_ROW * 10
    nb_mask, _ = work.b1_work(2, walked, starts, mask=True)
    assert nb_mask - nbytes == 16 * 256 * 1


def test_b7_and_b8_work():
    windows = torch.tensor([2.0, 1.0])
    counted = torch.tensor([[3.0] * 256, [1.0] * 256])
    nbytes, ops = work.b7_work(2, windows, counted)
    assert nbytes == 3 * 128 * 64 * 4 + 2 * 8 * 256 * 4 * 2 + 2 * 8
    assert ops == work.FLOP_GRT_PAIR * 128 * 256 * 3 \
        + work.FLOP_GRT_COUNTED * 1024
    _, ops8 = work.b8_work(2, windows, counted, 1000)
    assert ops8 == (work.FLOP_GRT_PAIR + work.FLOP_GRT_BWD_CHAIN
                    + work.FLOP_GRT_BWD_REDUCE) * 1024


def ev(cat, name, ts, dur, tid=1):
    return dict(cat=cat, name=name, ts=ts, dur=dur, tid=tid)


def test_trace_busy_spans_and_idle_gaps():
    events = [
        ev("kernel", "k_a", 0, 10), ev("kernel", "k_b", 5, 10),
        ev("gpu_memcpy", "copy", 40, 10), ev("kernel", "k_a", 100, 20),
        ev("gpu_user_annotation", "3dgut.project", 0, 15),
        ev("gpu_user_annotation", "3dgut.project", 100, 20),
        ev("user_annotation", "train.backward", 10, 100),
        ev("cpu_op", "aten::mul", 60, 20),
        ev("cpu_op", "other_thread", 0, 500, tid=2),
    ]
    t = tracing.Trace(events, window_s=200e-6, units=2)
    assert t.busy_s == pytest.approx(45e-6)         # [0,15] [40,50] [100,120]
    assert t.kernel_s("k_a") == pytest.approx(30e-6)
    assert t.span_s(lambda n: n == "3dgut.project") == pytest.approx(35e-6)
    gaps = dict(t.idle_gaps())
    # Gap [15, 40] (mid 27.5) is under train.backward only; gap [50, 100]
    # (mid 75) under aten::mul inside it.
    assert gaps["train.backward"] == pytest.approx(25e-6)
    assert gaps["aten::mul"] == pytest.approx(50e-6)
    assert t.device_ops()[0][0] == "k_a"
