"""Kernels B5 and B6: deterministic per-particle sums of slot cotangent rows
over contiguous segments, port of threedgrut_tpu/ops/pallas/segment_sum.py.

Rows are [m, F] row-major and already grouped by particle (stably sorted by
particle id); the sums are [n, F]. F is 16 for B5 (the 3DGUT packed row)
and 16 or 64 for B6 (the 3DGRT candidate row); the plain versions take any
width. (The JAX kernels take and return the channel-major [F, m] layout
that its TPU compiler favours; the port keeps rows.)

  * `segment_sum_rows` (B5): segment p is [min(ends[p-1], cap),
    min(ends[p], cap)) for the binning's inclusive slot-count cumsum `ends`.
  * `segment_sum_rows_by_ids` (B6): segment p is the run of rows whose sorted
    id equals p; rows with id >= n are dropped. Its kernel first writes each
    segment's first row, then walks the segments as B5 does.

Both launch csrc/segment_sum.cu for CUDA tensors and run their plain version
(an f64 `index_add_` cast back to f32) for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from threedgrut_torch.ops import cuda_build

NCH = 16                # channels of B5's rows (the packed particle row)
NCH_BY_IDS = (16, 64)   # the widths B6's kernel is instantiated for

_P = ctypes.c_void_p
_I = ctypes.c_int
_B5_ARGS = [_P, _P, _I, _I, _P, _P]
# csrc/segment_sum.cu's kernels (a template's <channels, channels a
# thread>) and their threads per block, in segment_sum_blocks_per_sm's order
_KERNELS = (("segment_sum_rows_kernel", 256), ("segment_starts_kernel", 256),
            ("segment_sum_rows_by_ids_kernel<16,4>", 256),
            ("segment_sum_rows_by_ids_kernel<16,1>", 256),
            ("segment_sum_rows_by_ids_kernel<64,1>", 256))


def segment_sum_rows_plain(g: torch.Tensor,
                           ends: torch.Tensor) -> torch.Tensor:
    """Plain B5: row r < min(ends[-1], cap) belongs to the particle p with
    ends[p-1] <= r < ends[p]."""
    cap, n = g.shape[0], ends.shape[0]
    out = torch.zeros((n, g.shape[1]), dtype=torch.float64, device=g.device)
    total = min(int(ends[-1]), cap) if n else 0
    rows = torch.arange(total, dtype=torch.int32, device=g.device)
    pid = torch.searchsorted(ends.to(torch.int32), rows, right=True)
    out.index_add_(0, pid, g[:total].to(torch.float64))
    return out.to(torch.float32)


def segment_sum_rows_by_ids_plain(g: torch.Tensor, ids_sorted: torch.Tensor,
                                  n: int) -> torch.Tensor:
    """Plain B6: rows with id < n summed into their particle."""
    out = torch.zeros((n, g.shape[1]), dtype=torch.float64, device=g.device)
    keep = ids_sorted < n
    out.index_add_(0, ids_sorted[keep].long(), g[keep].to(torch.float64))
    return out.to(torch.float32)


def _check_rows(g, widths):
    if g.dim() != 2 or g.shape[1] not in widths:
        raise ValueError(f"rows must be [m, F] with F in {widths}, got "
                         f"{tuple(g.shape)}")


def segment_sum_rows(g: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """B5: [cap, 16] rows grouped by particle, [n] int32 inclusive segment
    ends (monotone; clamped to cap) -> [n, 16] per-particle sums."""
    _check_rows(g, (NCH,))
    if g.device.type == "cpu":
        return segment_sum_rows_plain(g, ends)
    cap, n = g.shape[0], ends.shape[0]
    cuda_build.checked_inputs(("g", g, torch.float32, (cap, NCH)),
                              ("ends", ends, torch.int32, (n,)))
    out = torch.empty((n, NCH), dtype=torch.float32, device=g.device)
    lib = cuda_build.library("segment_sum_rows", _B5_ARGS)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    cuda_build.launches["segment_sum_rows"] += 1
    cuda_build.check("segment_sum_rows", lib.segment_sum_rows(
        g.data_ptr(), ends.data_ptr(), cap, n, out.data_ptr(), stream))
    return out


def segment_sum_rows_by_ids(g: torch.Tensor, ids_sorted: torch.Tensor,
                            n: int) -> torch.Tensor:
    """B6: [m, F] rows (F 16 or 64) and their [m] int32 particle ids,
    sorted ascending -> [n, F] per-particle sums; rows with id >= n are
    dropped."""
    if g.device.type == "cpu":
        if g.dim() != 2 or g.shape[1] % 8:
            raise ValueError(f"rows must be [m, F] with F a multiple of 8, "
                             f"got {tuple(g.shape)}")
        return segment_sum_rows_by_ids_plain(g, ids_sorted, n)
    _check_rows(g, NCH_BY_IDS)
    m, f = g.shape
    cuda_build.checked_inputs(("g", g, torch.float32, (m, f)),
                              ("ids_sorted", ids_sorted, torch.int32, (m,)))
    out = torch.empty((n, f), dtype=torch.float32, device=g.device)
    starts = torch.empty(n + 1, dtype=torch.int32, device=g.device)
    lib = cuda_build.library("segment_sum_rows_by_ids",
                             [_P, _P, _I, _I, _I, _P, _P, _P])
    stream = torch.cuda.current_stream(g.device).cuda_stream
    cuda_build.launches["segment_sum_rows_by_ids"] += 1
    cuda_build.check("segment_sum_rows_by_ids", lib.segment_sum_rows_by_ids(
        g.data_ptr(), ids_sorted.data_ptr(), m, n, f, starts.data_ptr(),
        out.data_ptr(), stream))
    return out


def blocks_per_sm() -> Dict[str, Tuple[int, int]]:
    """{kernel: (threads per block, blocks an SM holds at once)} for
    csrc/segment_sum.cu's kernels, as the CUDA runtime computes them."""
    return cuda_build.blocks_per_sm(
        cuda_build.library("segment_sum_rows", _B5_ARGS),
        "segment_sum_blocks_per_sm", _KERNELS)


def f32_sum_bound(abs_sums: torch.Tensor, lengths: torch.Tensor,
                  sums: torch.Tensor) -> torch.Tensor:
    """How far a sequential f32 sum of `lengths` terms may lie from the
    plain version's f64 sum rounded once: len * 2^-24 * sum|x| (the
    recursive-summation bound) plus 2^-23 * |sum| (the roundings of the
    results). abs_sums [n, F] are the segment sums of |x|."""
    u = 2.0 ** -24
    return (lengths.to(abs_sums.dtype)[:, None] * u * abs_sums
            + 2 * u * sums.abs())
