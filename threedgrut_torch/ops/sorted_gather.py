"""Gather packed particle rows into sorted-slot order, with a scatter-free
backward; port of threedgrut_tpu/ops/sorted_gather.py.

Forward: data_sorted[j] = packed[sorted_idx[j]]. Backward
(`unsort_segment_sum`): stably sort the slot cotangent rows by the particle
id each slot gathered from, then sum each particle's contiguous segment
with kernel B5 (segments from the binning's `particle_ends`: every
expansion slot appears once, so after the stable sort particle p's rows sit
exactly at [ends[p-1], ends[p]), clamped to the capacity under overflow) or
kernel B6 (segments from the sorted id column, for a compacted row subset).
Tail slots carry id N and are dropped either way: the forward clamps N to
N - 1, so autograd's own gather transpose would wrongly add their
cotangents to particle N - 1.

`gather_rows` is the 3DGRT candidate row gather (table[idx] for arbitrary,
repeating ids): its backward (`unsort_gather_segment_sum`) stably sorts the
ids, gathers the [m, 64] cotangent rows in that order and sums them with
B6 at 64 channels. Neither transpose scatters, so both are deterministic
(autograd's own, index_add_, uses atomics on the card).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from threedgrut_torch.ops import segment_sum


def sort_rows(ids: torch.Tensor, g: torch.Tensor,
              grad_precision: str = "f32"):
    """The rows of g ([m, 16]) grouped by particle: ([m] sorted ids, rows in
    that order) by a stable sort on `ids`, the rows rounded to bf16 (round
    to nearest even, as JAX's astype) when `grad_precision="bf16"`. These
    are the inputs of B5 and B6."""
    sorted_ids, order = torch.sort(ids, stable=True)
    rows = g[order]
    if grad_precision == "bf16":
        rows = rows.to(torch.bfloat16).to(torch.float32)
    return sorted_ids.contiguous(), rows


def unsort_segment_sum(ids: torch.Tensor, g: torch.Tensor, n: int,
                       ends: Optional[torch.Tensor] = None,
                       grad_precision: str = "f32") -> torch.Tensor:
    """The scatter-free gather transpose: [m] int32 particle id per row and
    [m, 16] cotangent rows -> [n, 16] per-particle sums (rows with id >= n
    dropped). `ends` ([>= n] int32, the binning's particle_ends) is valid
    only when `ids` covers every expansion slot (the dense case, B5); pass
    None for a compacted subset (B6). `grad_precision="bf16"` rounds the
    rows to bf16 before the f32 sums (`sort_rows`)."""
    with record_function("3dgut.bwd_unsort"):
        sorted_ids, rows = sort_rows(ids, g, grad_precision)
        if ends is None:
            return segment_sum.segment_sum_rows_by_ids(rows, sorted_ids, n)
        return segment_sum.segment_sum_rows(rows, ends[:n].contiguous())


class _SortedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, sorted_idx, particle_ends, grad_precision):
        n = packed.shape[0]
        ctx.save_for_backward(sorted_idx, particle_ends)
        ctx.n, ctx.grad_precision = n, grad_precision
        return packed[torch.clamp(sorted_idx, max=n - 1).long()]

    @staticmethod
    def backward(ctx, g):
        sorted_idx, particle_ends = ctx.saved_tensors
        d_packed = unsort_segment_sum(sorted_idx, g.contiguous(), ctx.n,
                                      ends=particle_ends,
                                      grad_precision=ctx.grad_precision)
        return d_packed, None, None, None


def sorted_gather(packed: torch.Tensor, sorted_idx: torch.Tensor,
                  particle_ends: torch.Tensor,
                  grad_precision: str = "f32") -> torch.Tensor:
    """packed[sorted_idx] ([cap, 16]) with the scatter-free backward above.
    Tail slots carry particle id N = packed.shape[0]; the gather clamps it
    to N - 1 (JAX's semantics; torch would raise). Those rows lie past every
    tile range and never composite."""
    return _SortedGather.apply(packed, sorted_idx, particle_ends,
                               grad_precision)


def unsort_gather_segment_sum(idx: torch.Tensor, g: torch.Tensor,
                              n: int) -> torch.Tensor:
    """The scatter-free transpose of table[idx] for wide rows (the JAX
    package's unsort_gather_segment_sum): [m] int32 ids (rows with id >= n
    dropped) and [m, F] f32 cotangent rows -> [n, F] per-particle sums, by a
    stable sort of the ids, a row gather in that order and B6."""
    with record_function("3dgrt.bwd_unsort"):
        keys, order = torch.sort(idx, stable=True)
        return segment_sum.segment_sum_rows_by_ids(g[order], keys.contiguous(),
                                                   n)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        return table[idx.long()]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return unsort_gather_segment_sum(idx, g.contiguous(), ctx.n), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for arbitrary (repeating) int32 row ids [m] in [0, N):
    the JAX package's gather_rows (the 3DGRT candidate row gather), with
    the scatter-free backward `unsort_gather_segment_sum`."""
    return _GatherRows.apply(table, idx)
