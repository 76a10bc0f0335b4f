"""Kernel B9: 16-way stream compaction, the member partition of the flat
3DGRT cull (grt.bundle_candidates_twolevel_flat's compact_kernel leg), port
of threedgrut_tpu/ops/pallas/stream_compact.py.

The flat super lists are segments of CHUNK = 128-slot windows; each slot
holds a particle id, a 16-bit mask of the member bundles whose cones it
passed and each member's axis depth. Per (segment, member) stream the
member's hits are left-packed, in slot order, into the stream's own output
windows: hit k of stream o goes to slot base_w[o] * 128 + k when that slot
lies below min(lim_w[o], flat_capacity / 128) * 128 (the first hits are
kept; overflow is the caller's flag). Unwritten slots hold id 0 and depth
FILL_DEPTH. The JAX kernel carries ids as exact f32 and takes one
[nws, R, 128] channel-row array; the port takes int32 ids and separate
tensors.

`compact_streams` launches csrc/stream_compact.cu for CUDA tensors and runs
its plain version for CPU tensors. The kernel computes the same placement in
three passes over windows (count, place, write) and keeps one segment per
window, so the segments' window ranges must be disjoint (the flat layout's):
the plain version refuses overlapping ranges (`check_disjoint`), so that
the CPU path, on which the tests run the callers, holds them to the
kernel's contract. The card path does not check (a check would wait for
the device).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from threedgrut_torch.ops import cuda_build

CHUNK = 128
STREAMS = 16            # the streams (member bundles) the kernel is built for
FILL_DEPTH = 3.4e38     # the depth of a slot never written (JAX _FILL_DEPTH)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P]
# csrc/stream_compact.cu's passes and their threads per block, in
# compact_streams_blocks_per_sm's order
_KERNELS = (("window_counts_kernel", 256), ("window_places_kernel", 512),
            ("window_write_kernel", 256))


def check_disjoint(seg_ws: torch.Tensor, seg_we: torch.Tensor) -> None:
    """Raise if two non-empty segments share a window."""
    live = seg_we > seg_ws
    ws, order = torch.sort(seg_ws[live].to(torch.int64))
    we = seg_we[live].to(torch.int64)[order]
    if bool((ws[1:] < we[:-1]).any()):
        raise ValueError("B9's segments must cover disjoint window ranges")


def compact_streams_plain(gid, bits, depth, seg_ws, seg_we, base_w, lim_w,
                          flat_capacity: int) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Plain B9: per segment, the exclusive cumsum of each stream's mask
    bit ranks its hits. The segments' window ranges must be disjoint, as
    the kernel's (check_disjoint)."""
    check_disjoint(seg_ws, seg_we)
    dev = gid.device
    n_streams = depth.shape[1]
    out_gid = torch.zeros(flat_capacity, dtype=torch.int32, device=dev)
    out_dep = torch.full((flat_capacity,), FILL_DEPTH, dtype=torch.float32,
                         device=dev)
    hi = torch.clamp(lim_w.to(torch.int64),
                     max=flat_capacity // CHUNK) * CHUNK
    lo = base_w.to(torch.int64) * CHUNK
    streams = torch.arange(n_streams, dtype=torch.int32, device=dev)
    for sp, (w0, w1) in enumerate(zip(seg_ws.tolist(), seg_we.tolist())):
        if w1 <= w0:
            continue
        sel = ((bits[w0 * CHUNK:w1 * CHUNK][None, :] >> streams[:, None])
               & 1).bool()                                   # [S, L]
        o = slice(sp * n_streams, (sp + 1) * n_streams)
        dst = lo[o, None] + torch.cumsum(sel, 1) - 1
        s, j = (sel & (dst < hi[o, None])).nonzero(as_tuple=True)
        d = dst[s, j]
        out_gid[d] = gid[w0 * CHUNK + j]
        out_dep[d] = depth[w0 + j // CHUNK, s, j % CHUNK]
    return out_gid, out_dep


def compact_streams(gid: torch.Tensor, bits: torch.Tensor,
                    depth: torch.Tensor, seg_ws: torch.Tensor,
                    seg_we: torch.Tensor, base_w: torch.Tensor,
                    lim_w: torch.Tensor,
                    flat_capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B9. gid, bits [nws * 128] int32 (particle id and member mask per
    slot), depth [nws, 16, 128] f32 (each member's depth per slot),
    seg_ws, seg_we [n_seg] int32 window ranges (disjoint: a window lies in
    one segment at most), base_w and lim_w [n_seg * 16] int32 first and
    one-past-last output window per stream in (segment, stream) order (the
    kernel also stops at flat_capacity).
    Returns (gid [flat_capacity] int32, depth [flat_capacity] f32)."""
    if flat_capacity % CHUNK:
        raise ValueError(f"flat_capacity {flat_capacity} is not a multiple "
                         f"of {CHUNK}")
    if depth.dim() != 3 or depth.shape[2] != CHUNK:
        raise ValueError(f"depth must be [nws, streams, {CHUNK}], got "
                         f"{tuple(depth.shape)}")
    nws, n_streams = depth.shape[0], depth.shape[1]
    if gid.device.type == "cpu":
        return compact_streams_plain(gid, bits, depth, seg_ws, seg_we,
                                     base_w, lim_w, flat_capacity)
    if n_streams != STREAMS:
        raise ValueError(f"the kernel takes {STREAMS} streams, got "
                         f"{n_streams}")
    n_seg = seg_ws.shape[0]
    cuda_build.checked_inputs(
        ("gid", gid, torch.int32, (nws * CHUNK,)),
        ("bits", bits, torch.int32, (nws * CHUNK,)),
        ("depth", depth, torch.float32, (nws, STREAMS, CHUNK)),
        ("seg_ws", seg_ws, torch.int32, (n_seg,)),
        ("seg_we", seg_we, torch.int32, (n_seg,)),
        ("base_w", base_w, torch.int32, (n_seg * STREAMS,)),
        ("lim_w", lim_w, torch.int32, (n_seg * STREAMS,)))
    out_gid = torch.zeros(flat_capacity, dtype=torch.int32,
                          device=gid.device)
    out_dep = torch.full((flat_capacity,), FILL_DEPTH, dtype=torch.float32,
                         device=gid.device)
    # The passes' scratch: each (window, stream)'s limit and first slot.
    scratch = torch.empty(nws * 2 * STREAMS, dtype=torch.int32,
                          device=gid.device)
    lib = cuda_build.library("compact_streams", _ARGS)
    stream = torch.cuda.current_stream(gid.device).cuda_stream
    cuda_build.launches["compact_streams"] += 1
    cuda_build.check("compact_streams", lib.compact_streams(
        gid.data_ptr(), bits.data_ptr(), depth.data_ptr(), seg_ws.data_ptr(),
        seg_we.data_ptr(), base_w.data_ptr(), lim_w.data_ptr(), n_seg, nws,
        flat_capacity // CHUNK, scratch.data_ptr(), out_gid.data_ptr(),
        out_dep.data_ptr(), stream))
    return out_gid, out_dep


def blocks_per_sm() -> Dict[str, Tuple[int, int]]:
    """{kernel: (threads per block, blocks an SM holds at once)} for B9's
    three passes, as the CUDA runtime computes them."""
    return cuda_build.blocks_per_sm(
        cuda_build.library("compact_streams", _ARGS),
        "compact_streams_blocks_per_sm", _KERNELS)
