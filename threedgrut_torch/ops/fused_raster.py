"""Slot gather -> tile compositor in one autograd.Function, with a backward
compacted to the windows the forward walked; port of the 3DGUT half of
threedgrut_tpu/ops/fused_raster.py.

The compositor's walk stops once every pixel of a tile is saturated, so
slots past a tile's early exit get exactly-zero gradients (B2 zeroes its
output). The two-stage path (sorted_gather + tile_composite) cannot know
that and unsorts every slot. Here the backward reads the forward's walked
slot counts (output row 7) and, when the walked windows fit in
`walk_capacity` slots, gathers just those windows before the unsort and
sums them with B6; otherwise it takes the dense unsort over every slot with
B5. Gradients are the same either way (up to the order of f32 sums): the
bound only decides which runs. The JAX package chooses the branch on the
device (lax.cond); here the host reads the walked-window count, one sync
per backward.
"""
from __future__ import annotations

import torch

from threedgrut_torch import constants as C
from threedgrut_torch.ops import tile_raster
from threedgrut_torch.ops.sorted_gather import unsort_segment_sum


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
    cover = torch.full((nw,), -1, dtype=torch.int64, device=out.device)
    cover = cover.scatter_reduce(0, wlo, whi, reduce="amax")
    cover = torch.cummax(cover, dim=0).values
    wmask = cover >= torch.arange(nw, device=out.device)
    return wmask, wmask.sum()


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
    # The j-th walked window is the first w with cumsum(wmask)[w] == j + 1.
    dev = g_slots.device
    csum = torch.cumsum(wmask.to(torch.int32), 0, dtype=torch.int32)
    want = torch.arange(1, wc + 1, dtype=torch.int32, device=dev)
    wsel = torch.clamp(torch.searchsorted(csum, want), max=nw - 1)
    valid = torch.arange(wc, device=dev) < cnt
    ids = torch.where(valid[:, None], sorted_idx.view(nw, ch)[wsel],
                      torch.full((wc, ch), n, dtype=sorted_idx.dtype,
                                 device=dev))
    rows = g_slots.view(nw, ch, -1)[wsel].reshape(wc * ch, -1)
    return ids.reshape(-1), rows


class _CompositeParticles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, sorted_idx, particle_ends, tile_starts,
                tile_ends, rays, args, aux_outputs, walk_capacity,
                grad_precision):
        n = packed.shape[0]
        data_sorted = packed[torch.clamp(sorted_idx, max=n - 1).long()]
        fn = (tile_raster.tile_composite_plain if rays.device.type == "cpu"
              else tile_raster._launch)
        out, _ = fn(data_sorted, tile_starts, tile_ends, rays, *args[:6],
                    aux_outputs, False)
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
            *ctx.args)                                        # [cap, 16]
        walked = compact_walked(out, tile_starts, sorted_idx, g_slots,
                                ctx.walk_capacity, ctx.n)
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
                        walk_capacity: int = 0) -> torch.Tensor:
    """tile_composite(packed[sorted_idx], ...)[0], differentiable in the
    packed rows [N, 16] through B2 and the walked-window-compacted unsort.
    The forward equals the two-stage path's. `walk_capacity` (a multiple of
    256 below the slot capacity) bounds the compacted unsort."""
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
    args = (int(degree), float(min_transmittance), float(min_response),
            float(min_alpha), float(max_alpha), bool(has_t_max),
            bool(aux_grads))
    return _CompositeParticles.apply(
        packed, sorted_idx, particle_ends, tile_starts, tile_ends, rays,
        args, bool(aux_outputs), int(walk_capacity),
        "bf16" if low_precision_grads else "f32")
