"""Tile binning: particle->tile intersections, (tile, depth) order and tile
ranges; port of threedgrut_tpu/ops/tiles.py.

The pipeline is the JAX package's: count-time cull masks (kernel B3, which
also writes each particle's record for B4), a cumsum of the counts, a
stable depth-rank sort that compacts the live particles, slot expansion
(kernel B4), one stable sort on the tile key, and searchsorted tile
ranges. Because expansion runs in depth-rank order, the
stable tile sort yields (tile, depth) order without a depth key.

Overflow is data: `isect_capacity` is a fixed bound, `num_intersections`
the true total, and `overflow` says whether the total exceeded it (the
caller grows the capacity and retries).

`row_last_touch` gives each pixel the last slot of its tile whose projected
footprint reaches the pixel's row, the bound of the compositor's
row-terminated mode.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from threedgrut_torch.ops import expand as ex
from threedgrut_torch.ops.projection import Projection


class TileBinning(NamedTuple):
    sorted_particle_idx: torch.Tensor  # [cap] int32; tail slots carry N
    sorted_tile: torch.Tensor          # [cap] int32; culled/tail = num_tiles
    tile_starts: torch.Tensor          # [num_tiles] int32
    tile_ends: torch.Tensor            # [num_tiles] int32
    num_intersections: torch.Tensor    # [] int32 true total (pre-clamp)
    overflow: torch.Tensor             # [] bool
    particle_ends: torch.Tensor        # [N] int32 cumsum of counts
    particle_counts: torch.Tensor      # [N] int32
    sorted_rowbits: Optional[torch.Tensor] = None  # [cap] int32 y0*16+y1


def depth_rank(counts: torch.Tensor, depth: torch.Tensor):
    """Depth-rank compaction: (ids_of_rank, ends_rank) int32 [N], the
    particles in stable depth order with the ones of zero count last, and
    the inclusive cumsum of their counts in that order (B4's inputs)."""
    big = torch.finfo(torch.float32).max
    rank_key = torch.where(counts > 0, depth, torch.full_like(depth, big))
    ids_of_rank = torch.sort(rank_key, stable=True).indices.to(torch.int32)
    ends_rank = torch.cumsum(counts[ids_of_rank.long()], 0, dtype=torch.int32)
    return ids_of_rank, ends_rank


def bin_particles(proj: Projection, tile_grid: Tuple[int, int],
                  isect_capacity: int,
                  tile_culling: bool = True) -> TileBinning:
    """Bin the projected particles into `isect_capacity` slots. Equal, field
    by field, to the JAX package's _bin_particles_xla on the same input."""
    gx, gy = tile_grid
    num_tiles = gx * gy
    n = proj.depth.shape[0]
    cap = isect_capacity
    if n >= (1 << 24) or cap >= (1 << 24):
        raise ValueError("particle ids and slots must stay below 2^24 (the "
                         "pid payload shares its word with 8 row bits)")
    dev = proj.depth.device

    tile_min = proj.tile_min.to(torch.int32).contiguous()
    tile_max = proj.tile_max.to(torch.int32).contiguous()
    n_tiles = proj.n_tiles.to(torch.int32).contiguous()
    conic = proj.conic.contiguous()
    center = proj.center.contiguous()
    max_power = proj.max_power.contiguous()
    counts, record = ex.cull_masks(tile_min, tile_max, n_tiles, conic,
                                   center, max_power, tile_culling)
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    total = ends[-1]
    overflow = total > cap

    ids_of_rank, ends_rank = depth_rank(counts, proj.depth)
    tile_key, pid, rowbits = ex.expand_keys(
        ends_rank, ids_of_rank, record, cap, tile_grid, tile_culling)
    del record                  # freed before the tile sort

    # Stable sort on the tile key alone keeps each tile's depth order; the
    # 8-bit row extent rides in the payload's top bits.
    packed = pid | (rowbits << 24)
    sorted_tile, order = torch.sort(tile_key, stable=True)
    sorted_packed = packed[order]
    sorted_idx = sorted_packed & 0x00FFFFFF
    sorted_rowbits = (sorted_packed >> 24) & 0xFF

    tiles = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    tstarts = torch.searchsorted(sorted_tile, tiles, right=False,
                                 out_int32=True)
    tends = torch.searchsorted(sorted_tile, tiles, right=True,
                               out_int32=True)
    return TileBinning(
        sorted_particle_idx=sorted_idx, sorted_tile=sorted_tile,
        tile_starts=tstarts, tile_ends=tends, num_intersections=total,
        overflow=overflow, particle_ends=ends, particle_counts=counts,
        sorted_rowbits=sorted_rowbits)


def particle_row_extent(proj: Projection) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Per-particle global pixel-row interval [py0, py1] of the projected
    footprint {power <= max_power} (the tile cull's conic and max_power):
    for power = 0.5 (cx dx^2 + cz dy^2) + cb dx dy the extremal |dy| on the
    level set is sqrt(2 mp cx / (cx cz - cb^2)); padded by 1 px."""
    cx, cb, cz = proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2]
    det = cx * cz - cb * cb
    safe = det > 1e-12
    dy = torch.sqrt(torch.clamp(2.0 * proj.max_power * cx, min=0.0)
                    / torch.where(safe, det, torch.ones_like(det)))
    dy = torch.where(safe, dy, torch.full_like(dy, 1e9))
    cy = proj.center[:, 1]
    return torch.floor(cy - dy) - 1.0, torch.ceil(cy + dy) + 1.0


ROW_BLOCK = 256      # slots per block of row_last_touch's fallback rule


def row_last_touch(binning: TileBinning, proj: Projection,
                   tile_grid: Tuple[int, int]) -> torch.Tensor:
    """Per-pixel last-touch slot bound [num_tiles, 256] f32 for the
    compositor's row-terminated mode (rays row 7): the index of the last
    slot of the pixel's tile whose projected footprint reaches the pixel's
    row within the tile, or -1. Bit-equal to the JAX package's.

    The footprint rows come from the binning's row bits (y0 * 16 + y1, the
    clipped tile-local extent) or, without them, from particle_row_extent.
    The last touch is a segmented max over each tile's slots, with the JAX
    package's blockwise rule kept: a tile whose whole slot range sits inside
    one 256-slot block that it owns neither end of gets its last slot
    (end - 1) in every row."""
    gx, gy = tile_grid
    num_tiles = gx * gy
    cap = binning.sorted_particle_idx.shape[0]
    n = proj.depth.shape[0]
    dev = binning.sorted_tile.device
    tile = binning.sorted_tile.long()
    if binning.sorted_rowbits is not None:
        rb = binning.sorted_rowbits
        y0 = torch.div(rb, 16, rounding_mode="floor").to(torch.float32)
        y1 = torch.remainder(rb, 16).to(torch.float32)
    else:
        py0, py1 = particle_row_extent(proj)
        pid = torch.clamp(binning.sorted_particle_idx.long(), max=n - 1)
        ty = torch.div(torch.clamp(tile, max=num_tiles - 1), gx,
                       rounding_mode="floor").to(torch.float32)
        y0 = torch.clamp(py0[pid] - ty * 16.0, 0.0, 15.0)
        y1 = torch.clamp(py1[pid] - ty * 16.0, 0.0, 15.0)
    real = tile < num_tiles
    r = torch.arange(16, dtype=torch.float32, device=dev)
    cover = (y0[:, None] <= r) & (r <= y1[:, None]) & real[:, None]
    slotf = torch.arange(cap, dtype=torch.float32, device=dev)
    f = torch.where(cover, slotf[:, None], torch.full_like(slotf[:1], -1.0))
    lt = torch.full((num_tiles + 1, 16), -1.0, device=dev)
    lt = lt.scatter_reduce(0, tile[:, None].expand(cap, 16), f, "amax")
    lt = lt[:num_tiles]

    s = binning.tile_starts.long()
    e = binning.tile_ends.long()
    has_any = e > s
    b0 = torch.div(s, ROW_BLOCK, rounding_mode="floor")
    b1 = torch.div(torch.clamp(e - 1, min=0), ROW_BLOCK,
                   rounding_mode="floor")
    blocks = tile.view(cap // ROW_BLOCK, ROW_BLOCK)
    b0c = torch.clamp(b0, max=cap // ROW_BLOCK - 1)
    tid = torch.arange(num_tiles, device=dev)
    inside = (has_any & (b0 == b1) & (blocks[b0c, 0] != tid)
              & (blocks[b0c, -1] != tid))
    lt = torch.where(inside[:, None], (e - 1)[:, None].to(torch.float32), lt)
    lt = torch.where(has_any[:, None], lt, torch.full_like(lt, -1.0))
    return lt.repeat_interleave(16, dim=1)
