"""The comparison that decides `correct`: the timed path's own outputs
against the plain reference (portbench/reference/), each number beside
the limit that portbench/limits/<workload>.json sets for it.

Training: each of the first steps' loss, the first gradient as the
optimizer holds it after one step, and the change of every parameter field
over those steps. Norms are compared leaf by leaf (a leaf is one of the six
fields), the gap between the program's norm and the reference's measured
against the larger of the reference's norm of that leaf and of the median
leaf. Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both.

Frames: 8-bit frames drawn from the seed among those the window completed,
against the reference's frame at the same pose converted the same way.
"""
from __future__ import annotations

import statistics
from typing import Dict

import torch

NEGLIGIBLE = 1e-3


def rel_gap(prog: Dict[str, float], ref: Dict[str, float], keep) -> float:
    med = statistics.median(ref[f] for f in keep)
    return max(abs(prog[f] - ref[f]) / max(ref[f], med, 1e-30)
               for f in keep)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog: {"losses": [..], "grad_norms": {f: x}, "change_norms": {f: x}}
    of the program; ref: reference.train.train_steps' result plus the
    starting fields ("start")."""
    g_ref = {f: float(torch.linalg.norm(g.double()))
             for f, g in ref["first_grad"].items()}
    med = statistics.median(g_ref.values())
    keep = [f for f, x in g_ref.items() if x >= NEGLIGIBLE * med]
    d_ref = {f: float(torch.linalg.norm((ref["fields"][f].double()
                                         - ref["start"][f].double())))
             for f in g_ref}
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    return dict(loss_gap=loss_gap,
                grad_gap=rel_gap(prog["grad_norms"], g_ref, keep),
                change_gap=rel_gap(prog["change_norms"], d_ref, keep))


def to_u8(rgb: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] radiance -> 8-bit, as the render and viewer entries write
    frames: clip to [0, 1], scale by 255, truncate."""
    return (rgb.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def frame_numbers(pairs) -> Dict[str, float]:
    """pairs: [(program frame, reference frame)] as uint8 [H, W, 3].
    The mean absolute difference in 8-bit levels, and the share of values
    more than 2 levels apart, each the worst over the frames."""
    mean_gap = far_share = 0.0
    for got, want in pairs:
        d = (got.to(torch.int16) - want.to(torch.int16)).abs().float()
        mean_gap = max(mean_gap, float(d.mean()))
        far_share = max(far_share, float((d > 2).float().mean()))
    return dict(frame_mean_gap=mean_gap, frame_far_share=far_share)


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or not finite, fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        lim = limits.get(name)
        good = (lim is not None and value == value and value <= lim)
        ok &= good
        out[name] = {"value": value, "limit": lim}
    return ok, out
