"""What the per-layer metric readers (portbench/metrics/<name>.py) share.

A reader is a module with `read(ctx)`, returning a number or None when its
cell gives it nothing to read. `ctx` is a Context of the traced window.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from portbench import work
from portbench.tracing import Trace


class Context(NamedTuple):
    kind: str            # the traffic's kind: "train" or "video"
    trace: Trace         # the traced window, `trace.units` steps or frames
    work: dict           # LaunchRecorder.work()
    other_ops: float     # work.step_ops over the window's units
    extra_kernels: int   # copy kernels the recorder added


def idle_share(ctx: Context, kind: str) -> Optional[float]:
    """% of the traced window in which the device ran nothing."""
    if ctx.kind != kind:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def span_ms(ctx: Context, kind: str, prefix: str) -> Optional[float]:
    """Device ms a unit under the record_function labels `prefix` and
    `prefix.*` (None when the window has none of them)."""
    if ctx.kind != kind:
        return None
    s = ctx.trace.span_s(lambda n: n == prefix or n.startswith(prefix + "."))
    if s <= 0:
        return None
    return 1e3 * s / ctx.trace.units


def roofline(ctx: Context, kind: str, kernel: str) -> Optional[float]:
    """% of the kernel's summed device time that its work's bound takes."""
    if ctx.kind != kind:
        return None
    w = ctx.work.get(kernel)
    t = ctx.trace.kernel_s(work.kernel_pattern(kernel))
    if not w or not w["launches"] or t <= 0:
        return None
    return 100.0 * w["bound_ms"] * 1e-3 / t


def mfu(ctx: Context, kind: str) -> Optional[float]:
    """% of the float32 peak over the traced window that the units'
    counted operations take."""
    if ctx.kind != kind:
        return None
    ops = ctx.other_ops + sum(w["ops"] for w in ctx.work.values())
    return 100.0 * ops / (ctx.trace.window_s * work.PEAK_F32_FLOPS)
