"""Row gather -> compositor in one autograd.Function, with a backward
compacted to the windows the forward walked; port of
threedgrut_tpu/ops/fused_raster.py: `composite_particles` (3DGUT, the tile
compositor B1/B2) and `composite_bundles` (3DGRT, the bundle compositor
B7/B8; its part is described at the function).

3DGUT: the compositor's walk stops once every pixel of a tile is
saturated, so slots past a tile's early exit get exactly-zero gradients
(B2 zeroes its output). The two-stage path (sorted_gather +
tile_composite) cannot know that and unsorts every slot. Here the backward
reads the forward's walked slot counts (output row 7) and, when the walked
windows fit in `walk_capacity` slots, gathers just those windows before
the unsort and sums them with B6; otherwise it takes the dense unsort over
every slot with B5. Gradients are the same either way (up to the order of
f32 sums): the bound only decides which runs. The JAX package chooses the
branch on the device (lax.cond); here the host reads the walked-window
count, one sync per backward. `branches` counts the branches the backwards
took ("3dgut.compact", "3dgut.dense", "3dgrt.compact", "3dgrt.dense").
"""
from __future__ import annotations

import collections

import torch
from torch.profiler import record_function

from threedgrut_torch import constants as C
from threedgrut_torch.ops import bundle_trace, tile_raster
from threedgrut_torch.ops.sorted_gather import (unsort_gather_segment_sum,
                                                unsort_segment_sum)

branches: collections.Counter = collections.Counter()


def _window_union(wlo, whi, nw: int):
    """The union of window ranges [wlo_i, whi_i] (whi_i = -1: none) that
    are ordered by wlo: one scatter-max and a cummax. Returns ([nw] bool
    mask, [] int64 count)."""
    cover = torch.full((nw,), -1, dtype=torch.int64, device=wlo.device)
    cover = cover.scatter_reduce(0, wlo, whi, reduce="amax")
    cover = torch.cummax(cover, dim=0).values
    wmask = cover >= torch.arange(nw, device=wlo.device)
    return wmask, wmask.sum()


def walked_window_mask(out: torch.Tensor, tile_starts: torch.Tensor,
                       nw: int):
    """Walked-window coverage from the forward's per-tile walked-slot counts
    (row 7). Tile t walked slots [start_t, start_t + walked_t), i.e. windows
    [start_t // CHUNK, (start_t + walked_t - 1) // CHUNK]; their union over
    the slot-ordered tiles is one scatter-max and a cummax. Returns ([nw]
    bool mask, [] int64 count)."""
    ch = tile_raster.CHUNK
    walked = out[:, 7, 0].to(torch.int64)
    starts = tile_starts.to(torch.int64)
    has = walked > 0
    wlo = torch.where(has, starts // ch, torch.zeros_like(starts))
    whi = torch.where(has, (starts + walked - 1) // ch,
                      torch.full_like(starts, -1))
    return _window_union(wlo, whi, nw)


def _walked_windows(wmask, cnt, wc: int):
    """The first `wc` walked windows' indices [wc] (the j-th walked window
    is the first w with cumsum(wmask)[w] == j + 1; past the count they
    repeat the last window) and which of the wc are real ([wc] bool)."""
    nw = wmask.shape[0]
    dev = wmask.device
    csum = torch.cumsum(wmask.to(torch.int32), 0, dtype=torch.int32)
    want = torch.arange(1, wc + 1, dtype=torch.int32, device=dev)
    wsel = torch.clamp(torch.searchsorted(csum, want), max=nw - 1)
    return wsel, torch.arange(wc, device=dev) < cnt


def compact_walked(out, tile_starts, sorted_idx, g_slots, walk_capacity,
                   n):
    """The slot rows of the windows the forward walked, padded to
    `walk_capacity` slots: ([wc] int32 particle ids, [wc, 16] rows), with
    filler rows of id n (dropped by B6). None when the walked windows do
    not fit (the host reads their count: one sync)."""
    ch = tile_raster.CHUNK
    nw, wc = g_slots.shape[0] // ch, walk_capacity // ch
    wmask, cnt = walked_window_mask(out, tile_starts, nw)
    cnt = int(cnt)
    if cnt > wc:
        return None
    wsel, valid = _walked_windows(wmask, cnt, wc)
    ids = torch.where(valid[:, None], sorted_idx.view(nw, ch)[wsel],
                      torch.full((wc, ch), n, dtype=sorted_idx.dtype,
                                 device=sorted_idx.device))
    rows = g_slots.view(nw, ch, -1)[wsel].reshape(wc * ch, -1)
    return ids.reshape(-1), rows


class _CompositeParticles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, sorted_idx, particle_ends, tile_starts,
                tile_ends, rays, args, aux_outputs, walk_capacity,
                grad_precision):
        n = packed.shape[0]
        data_sorted = packed[torch.clamp(sorted_idx, max=n - 1).long()]
        fwd = (data_sorted, tile_starts, tile_ends, rays, *args[:6],
               aux_outputs, False, *args[7:])
        ctx.order = tile_raster.forward_order(
            data_sorted, tile_starts, tile_ends, rays, args[7],
            ctx.needs_input_grad[0])
        if rays.device.type == "cpu":
            out, _ = tile_raster.tile_composite_plain(*fwd)
        else:
            out, _ = tile_raster._launch(*fwd, order=ctx.order)
        ctx.save_for_backward(sorted_idx, particle_ends, data_sorted,
                              tile_starts, tile_ends, rays, out)
        ctx.n, ctx.args = n, args
        ctx.walk_capacity, ctx.grad_precision = walk_capacity, grad_precision
        return out

    @staticmethod
    def backward(ctx, g_out):
        (sorted_idx, particle_ends, data_sorted, tile_starts, tile_ends,
         rays, out) = ctx.saved_tensors
        g_slots = tile_raster.tile_composite_backward(
            data_sorted, tile_starts, tile_ends, rays, out, g_out,
            *ctx.args, order=ctx.order)                       # [cap, 16]
        ctx.order = None    # B1's record is spent: free it for the unsort
        walked = compact_walked(out, tile_starts, sorted_idx, g_slots,
                                ctx.walk_capacity, ctx.n)
        branches["3dgut.dense" if walked is None else "3dgut.compact"] += 1
        if walked is not None:
            d_packed = unsort_segment_sum(*walked, ctx.n, ends=None,
                                          grad_precision=ctx.grad_precision)
        else:
            d_packed = unsort_segment_sum(sorted_idx, g_slots, ctx.n,
                                          ends=particle_ends,
                                          grad_precision=ctx.grad_precision)
        return (d_packed,) + (None,) * 9


def composite_particles(packed, sorted_idx, particle_ends, tile_starts,
                        tile_ends, rays, degree: int,
                        min_transmittance: float,
                        min_response: float = C.MIN_KERNEL_RESPONSE,
                        min_alpha: float = C.MIN_ALPHA,
                        max_alpha: float = C.MAX_ALPHA,
                        has_t_max: bool = True, aux_grads: bool = True,
                        aux_outputs: bool = True,
                        low_precision_grads: bool = False,
                        walk_capacity: int = 0, sorted_passes: int = 0,
                        row_termination: bool = False) -> torch.Tensor:
    """tile_composite(packed[sorted_idx], ...)[0], differentiable in the
    packed rows [N, 16] through B2 and the walked-window-compacted unsort.
    The forward equals the two-stage path's. `walk_capacity` (a multiple of
    256 below the slot capacity) bounds the compacted unsort.
    `sorted_passes` and `row_termination` select B1's and B2's sorted and
    row-terminated legs; the walked counts, and so the compaction, are
    those of the row-terminated walk."""
    cap = sorted_idx.shape[0]
    n = packed.shape[0]
    if not (walk_capacity % 256 == 0 and 0 < walk_capacity < cap):
        raise ValueError(f"walk_capacity must be a multiple of 256 in "
                         f"(0, {cap}), got {walk_capacity}")
    # Row 7's walked counts are f32: exact integers only below 2^24.
    if cap > (1 << 24) or n > (1 << 24):
        raise ValueError(f"capacity {cap} and particle count {n} must not "
                         f"exceed 2^24")
    if not aux_outputs and aux_grads:
        raise ValueError("aux_outputs=False requires aux_grads=False")
    tile_raster.check_passes(sorted_passes)
    args = (int(degree), float(min_transmittance), float(min_response),
            float(min_alpha), float(max_alpha), bool(has_t_max),
            bool(aux_grads), int(sorted_passes), bool(row_termination))
    return _CompositeParticles.apply(
        packed, sorted_idx, particle_ends, tile_starts, tile_ends, rays,
        args, bool(aux_outputs), int(walk_capacity),
        "bf16" if low_precision_grads else "f32")


# ---- 3DGRT: the bundle compositor ------------------------------------------

def compact_walked_bundles(out, win_starts, flat_idx, valid, g_rows,
                           walk_capacity, n):
    """The rows of the windows the bundles walked, padded to
    `walk_capacity` rows: ([wc] int32 particle ids, [wc, 64] rows with
    channel 12 masked by `valid`), filler rows of id n (dropped by B6).
    Bundle b walked windows [win_starts[b], win_starts[b] + out[b, 7]); the
    ranges are disjoint and ordered. None when the walked windows do not
    fit (the host reads their count: one sync)."""
    ch = bundle_trace.CHUNK
    nw, wc = g_rows.shape[0] // ch, walk_capacity // ch
    walked = out[:, 7, 0].to(torch.int64)
    starts = win_starts.to(torch.int64)
    has = walked > 0
    wmask, cnt = _window_union(
        torch.where(has, starts, torch.zeros_like(starts)),
        torch.where(has, starts + walked - 1, torch.full_like(starts, -1)),
        nw)
    cnt = int(cnt)
    if cnt > wc:
        return None
    wsel, vsel = _walked_windows(wmask, cnt, wc)
    ids = torch.where(vsel[:, None], flat_idx.view(nw, ch)[wsel],
                      torch.full((wc, ch), n, dtype=flat_idx.dtype,
                                 device=flat_idx.device))
    rows = g_rows.view(nw, ch, -1)[wsel].reshape(wc * ch, -1)
    rows[:, 12] *= valid.view(nw, ch)[wsel].reshape(-1).to(rows.dtype)
    return ids.reshape(-1), rows


class _CompositeBundles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows64, flat_idx, valid, rays, win_starts, win_ends,
                args, walk_capacity):
        d = rows64.detach()[flat_idx.long()]
        d[:, 12] *= valid.to(d.dtype)
        ctx.order = bundle_trace.forward_order(d, rays, args[-1],
                                               ctx.needs_input_grad[0])
        out = bundle_trace.composite_fn(rays.device)(
            d, rays, win_starts, win_ends, *args, order=ctx.order)
        ctx.save_for_backward(flat_idx, valid, d, rays, win_starts,
                              win_ends, out)
        ctx.n, ctx.args = rows64.shape[0], args
        ctx.walk_capacity = walk_capacity
        return out

    @staticmethod
    def backward(ctx, g_out):
        flat_idx, valid, d, rays, win_starts, win_ends, out = \
            ctx.saved_tensors
        g_rows = bundle_trace.bundle_composite_backward(
            d, rays, win_starts, win_ends, out, g_out, *ctx.args,
            order=ctx.order)                                   # [capF, 64]
        ctx.order = None    # B7's orders are spent: free them for the unsort
        # The branch is chosen on the host: the walked-window count is read
        # back (one sync per backward), where the JAX package's lax.cond
        # decides on the device. The compact branch gathers just the walked
        # windows; the dense one unsorts every slot. Both give the same sums.
        with record_function("3dgrt.bwd_compact"):
            walked = compact_walked_bundles(out, win_starts, flat_idx, valid,
                                            g_rows, ctx.walk_capacity, ctx.n)
        branches["3dgrt.dense" if walked is None else "3dgrt.compact"] += 1
        if walked is None:
            g_rows[:, 12] *= valid.to(g_rows.dtype)
            walked = (flat_idx, g_rows)
        return (unsort_gather_segment_sum(*walked, ctx.n),) + (None,) * 7


def composite_bundles(rows64, flat_idx, valid, rays, win_starts, win_ends,
                      degree: int, sh_degree: int, min_transmittance: float,
                      min_response: float = C.MIN_KERNEL_RESPONSE,
                      min_alpha: float = C.MIN_ALPHA,
                      max_alpha: float = C.MAX_ALPHA,
                      sorted_passes: int = 0,
                      walk_capacity: int = 0) -> torch.Tensor:
    """bundle_composite(rows64[flat_idx] with opacity masked by `valid`,
    ...), differentiable in the packed candidate rows rows64 [N, 64]: the
    backward is B8, then the rows of the windows the forward walked (each
    bundle's prefix [win_starts[b], win_starts[b] + out[b, 7])) compacted
    into `walk_capacity` rows when they fit, else every slot, then the
    sort by particle id and B6 at 64 channels (`unsort_gather_segment_sum`).
    The forward equals grt.trace's gather_rows route. `walk_capacity`: a
    multiple of 256 in (0, capF)."""
    cap = flat_idx.shape[0]
    n = rows64.shape[0]
    if not (walk_capacity % 256 == 0 and 0 < walk_capacity < cap):
        raise ValueError(f"walk_capacity must be a multiple of 256 in "
                         f"(0, {cap}), got {walk_capacity}")
    # Row 7's walked counts are f32: exact integers only below 2^24.
    if cap > (1 << 24) or n > (1 << 24):
        raise ValueError(f"capacity {cap} and particle count {n} must not "
                         f"exceed 2^24")
    args = (int(degree), int(sh_degree), float(min_transmittance),
            float(min_response), float(min_alpha), float(max_alpha),
            int(sorted_passes))
    return _CompositeBundles.apply(rows64, flat_idx, valid, rays, win_starts,
                                   win_ends, args, int(walk_capacity))
