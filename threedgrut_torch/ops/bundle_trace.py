"""Kernel B7, the 3DGRT bundle compositor forward, port of
threedgrut_tpu/ops/pallas/bundle_trace.py (_forward, _forward_kernel).

Candidates arrive as one flat array of 64-float rows ([capF, 64], capF a
multiple of CHUNK = 128), in windows of 128 consecutive rows; bundle b owns
windows [win_starts[b], win_ends[b]), its candidates in bundle-axis depth
order (render/grt.flatten_candidates). Row layout: A (9: world->canonical
incl. 1/scale, row-major), mean (3), opacity (12; 0 for masked slots), 3
pad, then SH coefficients 16 per channel (red 16-31, green 32-47, blue
48-63). Rays [nb, 8, 256]: rows 0-2 origin, 3-5 unit direction (zero for
an inactive ray), 6 t_max (<= 0: unbounded), 7 initial transmittance.
Output [nb, 8, 256]: rows 0-2 rgb, 3 opacity, 4 depth, 5 transmittance,
6 hit count, 7 windows the bundle walked before its early exit.

Per (ray, candidate): the 3DGUT pair math (ops/tile_raster._tile_pairs,
csrc/tile_pair.cuh) plus the front-of-origin (v.u < 0) and canonical-slab
(g <= 9) gates, and SH colour along the ray, max(0, coeffs . basis + 0.5).
Per ray and window: the keys hit_t (alpha > 0) or 3.4e38 (otherwise) go
through exactly `sorted_passes` passes of odd-even transposition (pass i
compares positions (j, j+1) with j = i mod 2, swapping on a strict <); the
exclusive product of 1 - alpha in that order gives T_before = carry *
excl; a row counts while T_before > min_transmittance; the carry becomes
min(carry, min over counted rows of T_before (1 - alpha)). A bundle stops
after the first window that leaves no ray above min_transmittance. The 16
passes are part of the result: a full sort would composite differently.

`bundle_composite` launches csrc/bundle_trace_fwd.cu for CUDA tensors and
runs `bundle_composite_plain` for CPU tensors. It is a
torch.autograd.Function whose backward (kernel B8) is not ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from threedgrut_torch import constants as C
from threedgrut_torch.ops import cuda_build
from threedgrut_torch.ops.tile_raster import _tile_pairs

CHUNK = 128          # rows per window: the flat layout's and re-sort's unit
ROW64 = 64           # packed floats per candidate row
PIX = 256            # rays per bundle
BIG = 3.4e38         # sort key of a row that composites nothing

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def sh_basis_rows(rays: torch.Tensor, sh_degree: int) -> torch.Tensor:
    """Per-ray SH basis [nb, 16, PIX] from the unit directions of rays
    [nb, 8, PIX]; rows past (sh_degree + 1)^2 are zero."""
    x, y, z = rays[:, 3], rays[:, 4], rays[:, 5]
    rows = [torch.full_like(x, C.SH_C0)]
    if sh_degree >= 1:
        rows += [-C.SH_C1 * y, C.SH_C1 * z, -C.SH_C1 * x]
    if sh_degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        rows += [C.SH_C2[0] * x * y, C.SH_C2[1] * y * z,
                 C.SH_C2[2] * (2.0 * zz - xx - yy), C.SH_C2[3] * x * z,
                 C.SH_C2[4] * (xx - yy)]
    if sh_degree >= 3:
        rows += [C.SH_C3[0] * y * (3.0 * xx - yy), C.SH_C3[1] * x * y * z,
                 C.SH_C3[2] * y * (4.0 * zz - xx - yy),
                 C.SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                 C.SH_C3[4] * x * (4.0 * zz - xx - yy),
                 C.SH_C3[5] * z * (xx - yy), C.SH_C3[6] * x * (xx - 3.0 * yy)]
    rows += [torch.zeros_like(x)] * (16 - len(rows))
    return torch.stack(rows, dim=1)


def oddeven_passes(key: torch.Tensor, vals, passes: int):
    """`passes` passes of odd-even transposition along dim 1 of key [B, K,
    ...]: pass i swaps positions (j, j+1), j = i mod 2, where key[j+1] <
    key[j]. Returns (key, vals) permuted alike."""
    k = key.shape[1]
    for i in range(passes):
        lo = slice(i % 2, k - 1, 2)
        hi = slice(i % 2 + 1, k, 2)
        swap = key[:, hi] < key[:, lo]
        out = []
        for x in [key] + list(vals):
            a, b = x[:, lo], x[:, hi]
            x = x.clone()
            x[:, lo] = torch.where(swap, b, a)
            x[:, hi] = torch.where(swap, a, b)
            out.append(x)
        key, vals = out[0], out[1:]
    return key, vals


def _window(S, rays, basis, carry, degree, min_transmittance, min_response,
            min_alpha, max_alpha, sorted_passes, stats):
    """One window of B bundles: S [B, CHUNK, 64], rays [B, 8, PIX], basis
    [B, 16, PIX], carry [B, PIX]. Returns the window's sums [B, 5, PIX]
    (rgb, opacity, depth), hits [B, PIX] and the new carry."""
    q = _tile_pairs(S, rays, degree, min_response, min_alpha, max_alpha,
                    True)
    gates = (q["vdotu"] < 0.0) & (q["g"] <= C.MAX_PARTICLE_SQ_DISTANCE)
    alpha = torch.where(gates, q["alpha"], torch.zeros_like(q["alpha"]))
    one_m = 1.0 - alpha
    if stats is not None:
        live = carry > min_transmittance
        # A ray's hits out of row order: a hit nearer than an earlier one.
        before = torch.where(alpha > 0.0, q["hit_t"],
                             torch.full_like(alpha, -BIG)).cummax(1).values
        inverted = ((alpha[:, 1:] > 0.0)
                    & (q["hit_t"][:, 1:] < before[:, :-1])).any(1)
        stats["live_ray_windows"] += int(live.sum())
        stats["inverted_ray_windows"] += int((inverted & live).sum())
    if sorted_passes:
        key = torch.where(alpha > 0.0, q["hit_t"],
                          torch.full_like(alpha, BIG))
        pos = torch.arange(CHUNK, device=S.device)[None, :, None].expand(
            alpha.shape)
        _, (om_s, pos_s) = oddeven_passes(key, [one_m, pos], sorted_passes)
    else:
        om_s, pos_s = one_m, None
    incl = torch.cumprod(om_s, dim=1)
    excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
    if pos_s is not None:
        excl = torch.empty_like(excl).scatter_(1, pos_s, excl)
    t_before = carry[:, None, :] * excl
    live = t_before > min_transmittance
    w = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
    sums = [torch.sum(w * torch.clamp(torch.matmul(
        S[..., 16 + 16 * c:32 + 16 * c], basis) + 0.5, min=0.0), dim=1)
        for c in range(3)]
    sums += [w.sum(1), (w * q["hit_t"]).sum(1)]
    hits = (w > 0.0).sum(1).to(torch.float32)
    t_after = torch.where(live, t_before * one_m, torch.full_like(w, BIG))
    carry = torch.minimum(t_after.amin(1), carry)
    return torch.stack(sums, dim=1), hits, carry


def bundle_composite_plain(data, rays, win_starts, win_ends, degree: int,
                           sh_degree: int, min_transmittance: float,
                           min_response: float = C.MIN_KERNEL_RESPONSE,
                           min_alpha: float = C.MIN_ALPHA,
                           max_alpha: float = C.MAX_ALPHA,
                           sorted_passes: int = 0,
                           stats: Optional[dict] = None) -> torch.Tensor:
    """Plain version of B7: a loop over window index, each step taking the
    next window of every bundle still walking, vectorised across them.
    With a `stats` dict, also counts the work the data asks for: windows x
    rays alive at their start ("live_ray_windows"), and of those the ones
    whose hits are out of row order ("inverted_ray_windows")."""
    if stats is not None:
        stats.update(live_ray_windows=0, inverted_ray_windows=0)
    nb = rays.shape[0]
    dev = rays.device
    windows = data.reshape(-1, CHUNK, ROW64)
    nw = windows.shape[0]
    ws = torch.clamp(win_starts.long(), 0, nw)
    we = torch.clamp(win_ends.long(), 0, nw)
    out = torch.zeros((nb, 8, PIX), dtype=torch.float32, device=dev)
    carry = rays[:, 7].clone()
    basis = sh_basis_rows(rays, sh_degree)
    walking = we > ws
    k = 0
    while True:
        b = torch.nonzero(walking & (ws + k < we)).reshape(-1)
        if b.numel() == 0:
            break
        sums, hits, cb = _window(windows[ws[b] + k], rays[b], basis[b],
                                 carry[b], degree, min_transmittance,
                                 min_response, min_alpha, max_alpha,
                                 sorted_passes, stats)
        out[b, 0:5] += sums
        out[b, 6] += hits
        out[b, 7] += 1.0
        carry[b] = cb
        walking[b] = (cb > min_transmittance).any(1)
        k += 1
    out[:, 5] = carry
    return out


def _launch(data, rays, win_starts, win_ends, degree, sh_degree,
            min_transmittance, min_response, min_alpha, max_alpha,
            sorted_passes):
    nb = rays.shape[0]
    cap = data.shape[0]
    cuda_build.checked_inputs(
        ("rays", rays, torch.float32, (nb, 8, PIX)),
        ("data", data, torch.float32, (cap, ROW64)),
        ("win_starts", win_starts, torch.int32, (nb,)),
        ("win_ends", win_ends, torch.int32, (nb,)))
    if cap % CHUNK:
        raise ValueError(f"the candidate rows must be a multiple of {CHUNK} "
                         f"(the kernel loads whole windows), got {cap}")
    if degree not in C.GG_SCALE:
        raise ValueError(f"unsupported kernel degree {degree}")
    if not 0 <= sh_degree <= 3:
        raise ValueError(f"unsupported SH degree {sh_degree}")
    if sorted_passes < 0:
        raise ValueError(f"sorted_passes must be >= 0, got {sorted_passes}")
    out = torch.empty((nb, 8, PIX), dtype=torch.float32, device=rays.device)
    lib = cuda_build.library("bundle_trace_fwd",
                             [_P] * 5 + [_I] * 4 + [_F] * 4 + [_I, _P])
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    cuda_build.launches["bundle_trace_fwd"] += 1
    cuda_build.check("bundle_trace_fwd", lib.bundle_trace_fwd(
        data.data_ptr(), win_starts.data_ptr(), win_ends.data_ptr(),
        rays.data_ptr(), out.data_ptr(), nb, cap // CHUNK, degree, sh_degree,
        min_transmittance, min_response, min_alpha, max_alpha,
        int(sorted_passes), stream))
    return out


class _BundleComposite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, rays, win_starts, win_ends, degree, sh_degree,
                min_transmittance, min_response, min_alpha, max_alpha,
                sorted_passes):
        fn = bundle_composite_plain if rays.device.type == "cpu" else _launch
        return fn(data.detach(), rays.detach(), win_starts, win_ends, degree,
                  sh_degree, min_transmittance, min_response, min_alpha,
                  max_alpha, sorted_passes)

    @staticmethod
    def backward(ctx, g_out):
        raise NotImplementedError(
            "the backward of the 3DGRT bundle compositor (kernel B8, "
            "bundle_trace.py _backward_windows) is not ported yet: ROADMAP "
            "queue A item 10 and queue B, B8")


def bundle_composite(data, rays, win_starts, win_ends, degree: int,
                     sh_degree: int, min_transmittance: float,
                     min_response: float = C.MIN_KERNEL_RESPONSE,
                     min_alpha: float = C.MIN_ALPHA,
                     max_alpha: float = C.MAX_ALPHA,
                     sorted_passes: int = 0) -> torch.Tensor:
    """B7: the [nb, 8, 256] output buffer (module docstring) of the flat
    candidate rows `data` [capF, 64] for the bundles of `rays`, each
    walking its window range. Launches the kernel for CUDA tensors, the
    plain version for CPU tensors. Differentiating it raises (B8)."""
    return _BundleComposite.apply(
        data, rays, win_starts, win_ends, int(degree), int(sh_degree),
        float(min_transmittance), float(min_response), float(min_alpha),
        float(max_alpha), int(sorted_passes))
