"""Binning kernels B3 (count-time cull masks) and B4 (slot key expansion),
port of threedgrut_tpu/ops/pallas/expand.py.

Each kernel has a wrapper that launches the CUDA kernel for CUDA tensors
(csrc/cull_masks.cu, csrc/expand_keys.cu) and runs the plain PyTorch
version, defined beside it, for CPU tensors. Outputs are equal bit for bit:
both kernels are compiled with --fmad=false and repeat the plain versions'
float operations in order.

B3 hands B4 one record per particle (RECORD: 16 int32 words, floats as
their bits; csrc/tile_power.cuh RecordWord), so that B4 gathers each depth
rank's particle as one aligned 64-byte record. The plain versions write and
read the same layout.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from threedgrut_torch import constants as C
from threedgrut_torch.ops import cuda_build
from threedgrut_torch.ops.projection import tile_min_power_response

_P = ctypes.c_void_p
_I = ctypes.c_int
_B3_ARGS = [_P] * 6 + [_I, _I, _P, _P, _P]
_B4_ARGS = [_P] * 3 + [_I] * 5 + [_P] * 5
WINDOW = 256            # slots of one B4 block (csrc/expand_keys.cu WIN)

# The record's words: (name, first word, words), in csrc/tile_power.cuh's
# order. bbox_w is tile_max.x - tile_min.x clamped to >= 1; e_dy the
# footprint's row half-extent; rcp the power test's 1 / (256 a), 1 / (256 c).
RECORD = (("tile_min", 0, 2), ("bbox_w", 2, 1), ("count", 3, 1),
          ("masks", 4, 3), ("conic", 7, 3), ("center", 10, 2),
          ("max_power", 12, 1), ("e_dy", 13, 1), ("rcp", 14, 2))
RECORD_WORDS = 16
_FLOAT_FIELDS = ("conic", "center", "max_power", "e_dy", "rcp")


class Record(NamedTuple):
    tile_min: torch.Tensor   # [N, 2] int32
    bbox_w: torch.Tensor     # [N] int32, >= 1
    count: torch.Tensor      # [N] int32 surviving tiles
    masks: torch.Tensor      # [N, 3] int32 mask words m0, m1, m2
    conic: torch.Tensor      # [N, 3] f32
    center: torch.Tensor     # [N, 2] f32
    max_power: torch.Tensor  # [N] f32
    e_dy: torch.Tensor       # [N] f32
    rcp: torch.Tensor        # [N, 2] f32


def pack_record(fields: Dict[str, torch.Tensor]) -> torch.Tensor:
    """int32 [N, 16] from the Record fields (RECORD's layout)."""
    cols = []
    for name, _, words in RECORD:
        x = fields[name].reshape(-1, words)
        cols.append(x.contiguous().view(torch.int32)
                    if name in _FLOAT_FIELDS else x.to(torch.int32))
    return torch.cat(cols, dim=1)


def unpack_record(record: torch.Tensor) -> Record:
    """The Record fields of an int32 [N, 16] record."""
    out = {}
    for name, at, words in RECORD:
        x = record[:, at:at + words]
        if name in _FLOAT_FIELDS:
            x = x.contiguous().view(torch.float32)
        out[name] = x[:, 0] if words == 1 else x
    return Record(**out)


def power_reciprocals(conic: torch.Tensor) -> torch.Tensor:
    """[..., 2] the tile power test's 1 / (256 a) and 1 / (256 c) of conics
    [..., 3] (a, b, c), as tile_min_power_response computes them; the
    record carries them so that B4 divides once per particle."""
    return torch.stack([1.0 / (float(C.TILE_X * C.TILE_X) * conic[..., 0]),
                        1.0 / (float(C.TILE_Y * C.TILE_Y) * conic[..., 2])],
                       dim=-1)


def row_half_extent(conic: torch.Tensor, max_power: torch.Tensor):
    """The footprint's row half-extent sqrt(2 mp a / (a c - b^2)), 1e9 for
    a degenerate conic (the expand.py _kernel formula)."""
    cx, cb, cz = conic[..., 0], conic[..., 1], conic[..., 2]
    det = cx * cz - cb * cb
    return torch.where(
        det > 1e-12,
        torch.sqrt(torch.clamp(2.0 * max_power * cx, min=0.0)
                   / torch.clamp(det, min=1e-12)),
        torch.full_like(det, 1e9))


def _popcount(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of non-negative int64 values below 2^32."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def select_nth_set_bit(m0, m1, m2, r):
    """Bit position (0..63) of the (r+1)-th set bit of the 64-bit mask
    packed as 24+24+16-bit words; undefined but finite when r >= popcount."""
    m0, m1, m2, r = (x.to(torch.int64) for x in (m0, m1, m2, r))
    c0 = _popcount(m0)
    c1 = _popcount(m1)
    in1 = (r >= c0) & (r < c0 + c1)
    in2 = r >= (c0 + c1)
    zero = torch.zeros_like(r)
    m = torch.where(in2, m2, torch.where(in1, m1, m0))
    rr = r - torch.where(in2, c0 + c1, torch.where(in1, c0, zero))
    base = torch.where(in2, torch.full_like(r, 48),
                       torch.where(in1, torch.full_like(r, 24), zero))
    for width in (16, 8, 4, 2, 1):
        low = m & ((1 << width) - 1)
        c = _popcount(low)
        go = rr >= c
        base = base + torch.where(go, torch.full_like(r, width), zero)
        rr = rr - torch.where(go, c, zero)
        m = torch.where(go, m >> width, low)
    return base.to(torch.int32)


# ---------------------------------------------------------------------------
# B3: count-time cull masks and the record
# ---------------------------------------------------------------------------

def cull_masks_plain(tile_min, tile_max, n_tiles, conic, center, max_power,
                     tile_culling: bool = True):
    """Plain version of B3 (the JAX package's batched [N, 64] form):
    returns (counts int32 [N], record int32 [N, 16])."""
    bw = tile_max[:, 0] - tile_min[:, 0]
    bh = tile_max[:, 1] - tile_min[:, 1]
    n_tiles = n_tiles.to(torch.int32)
    zero = torch.zeros_like(n_tiles)
    if tile_culling:
        maskable = (bw <= 8) & (bh <= 8)
        dev = tile_min.device
        o = torch.arange(8, dtype=torch.int32, device=dev)
        oy = o.repeat_interleave(8)[None, :]                  # [1, 64]
        ox = o.repeat(8)[None, :]
        tmin_f = tile_min.to(torch.float32)
        txy = torch.stack([tmin_f[:, 0:1] + ox.to(torch.float32),
                           tmin_f[:, 1:2] + oy.to(torch.float32)], dim=-1)
        power = tile_min_power_response(txy, conic[:, None, :],
                                        center[:, None, :])  # [N, 64]
        inside = (ox < bw[:, None]) & (oy < bh[:, None])
        ok = inside & (power < max_power[:, None])
        j = (oy * bw[:, None] + ox).to(torch.int64)
        cnt = ok.sum(1, dtype=torch.int32)
        live = n_tiles > 0
        counts = torch.where(live, torch.where(maskable, cnt, n_tiles), zero)
        keep = live & maskable
        words = []
        for lo, wid in ((0, 24), (24, 24), (48, 16)):
            bit = torch.where(ok & (j >= lo) & (j < lo + wid),
                              torch.ones_like(j) << torch.clamp(j - lo, 0, 31),
                              torch.zeros_like(j))
            words.append(torch.where(keep, bit.sum(1).to(torch.int32), zero))
        masks = torch.stack(words, dim=1)
    else:
        counts = n_tiles
        masks = torch.zeros((n_tiles.shape[0], 3), dtype=torch.int32,
                            device=n_tiles.device)
    return counts, pack_record(dict(
        tile_min=tile_min, bbox_w=torch.clamp(bw, min=1), count=counts,
        masks=masks, conic=conic, center=center, max_power=max_power,
        e_dy=row_half_extent(conic, max_power),
        rcp=power_reciprocals(conic)))


def cull_masks(tile_min, tile_max, n_tiles, conic, center, max_power,
               tile_culling: bool = True):
    """B3: (counts int32 [N], record int32 [N, 16]): each particle's
    surviving tile count (n_tiles without tile culling) and its record
    (RECORD) — the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if tile_min.device.type == "cpu":
        return cull_masks_plain(tile_min, tile_max, n_tiles, conic, center,
                                max_power, tile_culling)
    n = n_tiles.shape[0]
    args = cuda_build.checked_inputs(
        ("tile_min", tile_min, torch.int32, (n, 2)),
        ("tile_max", tile_max, torch.int32, (n, 2)),
        ("n_tiles", n_tiles, torch.int32, (n,)),
        ("conic", conic, torch.float32, (n, 3)),
        ("center", center, torch.float32, (n, 2)),
        ("max_power", max_power, torch.float32, (n,)))
    cuda_build.check_aligned(("tile_min", tile_min, 8),
                             ("tile_max", tile_max, 8), ("center", center, 8))
    dev = tile_min.device
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    record = torch.empty((n, RECORD_WORDS), dtype=torch.int32, device=dev)
    lib = cuda_build.library("cull_masks", _B3_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.launches["cull_masks"] += 1
    cuda_build.check("cull_masks", lib.cull_masks(
        *[a.data_ptr() for a in args], n, int(bool(tile_culling)),
        counts.data_ptr(), record.data_ptr(), stream))
    return counts, record


# ---------------------------------------------------------------------------
# B4: slot key expansion
# ---------------------------------------------------------------------------

def slot_keys(slot, end, pid, f: Record, tile_grid, tile_culling: bool):
    """B4's outputs (tile_key, pid, rowbits) of owned slots, each slot
    given the end of its rank's segment, its particle `pid` and that
    particle's Record fields `f` (one entry per slot)."""
    gx, gy = tile_grid
    local = slot - (end - f.count)
    m0, m1, m2 = f.masks.unbind(1)
    sel = select_nth_set_bit(m0, m1, m2, torch.clamp(local, min=0))
    cell = torch.where((m0 | m1 | m2) == 0, local, sel)
    ty = f.tile_min[:, 1] + torch.div(cell, f.bbox_w, rounding_mode="floor")
    tx = f.tile_min[:, 0] + torch.remainder(cell, f.bbox_w)
    tile = ty * gx + tx
    if tile_culling:
        txy = torch.stack([tx, ty], dim=-1).to(torch.float32)
        valid = tile_min_power_response(txy, f.conic,
                                        f.center) < f.max_power
        tile = torch.where(valid, tile, torch.full_like(tile, gx * gy))
    s_cy = f.center[:, 1]
    ty_pix = ty.to(torch.float32) * float(C.TILE_Y)
    y0l = torch.clamp(torch.floor(s_cy - f.e_dy) - 1.0 - ty_pix, 0.0, 15.0)
    y1l = torch.clamp(torch.ceil(s_cy + f.e_dy) + 1.0 - ty_pix, 0.0, 15.0)
    return (tile.to(torch.int32), pid.to(torch.int32),
            (y0l * 16.0 + y1l).to(torch.int32))


def expand_keys_plain(ends_rank, ids_of_rank, record, isect_capacity: int,
                      tile_grid, tile_culling: bool):
    """Plain version of B4 with per-slot tensor ops: returns int32
    (tile_key, pid, rowbits), each [cap]."""
    gx, gy = tile_grid
    n = ends_rank.shape[0]
    slot = torch.arange(isect_capacity, dtype=torch.int32,
                        device=ends_rank.device)
    r = torch.searchsorted(ends_rank, slot, right=True)   # owning rank
    owned = r < n
    rc = torch.clamp(r, max=max(n - 1, 0))
    p = ids_of_rank[rc].to(torch.int64)
    keys = slot_keys(slot, ends_rank[rc], p, unpack_record(record[p]),
                     tile_grid, tile_culling)
    tail = (gx * gy, n, 15)
    return tuple(torch.where(owned, k, torch.full_like(k, v))
                 for k, v in zip(keys, tail))


def expand_keys(ends_rank, ids_of_rank, record, isect_capacity: int,
                tile_grid, tile_culling: bool):
    """B4: (tile_key, pid, rowbits) int32 [cap] for every intersection slot.

    ends_rank [N] int32: inclusive cumsum of the per-particle counts taken
    in depth-rank order (live particles first; any non-decreasing list is
    taken); ids_of_rank [N] int32: the particle of each rank; record int32
    [N, 16]: B3's records. Slots past the true total carry pid N and
    rowbits 15; culled or unowned slots the sentinel tile gx * gy."""
    if ends_rank.device.type == "cpu":
        return expand_keys_plain(ends_rank, ids_of_rank, record,
                                 isect_capacity, tile_grid, tile_culling)
    n = ends_rank.shape[0]
    args = cuda_build.checked_inputs(
        ("ends_rank", ends_rank, torch.int32, (n,)),
        ("ids_of_rank", ids_of_rank, torch.int32, (n,)),
        ("record", record, torch.int32, (n, RECORD_WORDS)))
    cuda_build.check_aligned(("record", record, 16))
    gx, gy = tile_grid
    cap = isect_capacity
    dev = ends_rank.device
    first = torch.empty(-(-cap // WINDOW), dtype=torch.int32, device=dev)
    outs = [torch.empty(cap, dtype=torch.int32, device=dev) for _ in range(3)]
    lib = cuda_build.library("expand_keys", _B4_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.launches["expand_keys"] += 1
    cuda_build.check("expand_keys", lib.expand_keys(
        *[a.data_ptr() for a in args], n, cap, gx, gx * gy,
        int(bool(tile_culling)), first.data_ptr(),
        *[o.data_ptr() for o in outs], stream))
    return tuple(outs)


# csrc/cull_masks.cu's and csrc/expand_keys.cu's kernels and their threads
# per block, in their *_blocks_per_sm entries' order
_B3_KERNELS = (("cull_masks_kernel", 256),)
_B4_KERNELS = (("window_ranks_kernel", WINDOW),
               ("expand_keys_kernel", WINDOW))


def blocks_per_sm() -> Dict[str, Tuple[int, int]]:
    """{kernel: (threads per block, blocks an SM holds at once)} for B3's
    and B4's kernels, as the CUDA runtime computes them."""
    return {**cuda_build.blocks_per_sm(
        cuda_build.library("cull_masks", _B3_ARGS),
        "cull_masks_blocks_per_sm", _B3_KERNELS),
        **cuda_build.blocks_per_sm(
            cuda_build.library("expand_keys", _B4_ARGS),
            "expand_keys_blocks_per_sm", _B4_KERNELS)}
