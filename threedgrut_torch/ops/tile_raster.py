"""Kernels B1 and B2, the 3DGUT tile compositor forward and backward,
port of threedgrut_tpu/ops/pallas/tile_raster.py.

Layouts are the JAX package's. Each sorted slot holds a packed 16-float row
[A (9: world->canonical incl. 1/scale, row-major), mean (3), opacity,
rgb (3)]. Rays are packed per tile as [num_tiles, 8, 256]: rows 0-2 origin,
3-5 unit direction, 6 t_max (<= 0: unbounded), 7 unused. The output is
[num_tiles, 8, 256]: rows 0-2 rgb, 3 opacity, 4 depth, 5 transmittance,
6 hit count, 7 slots walked by the tile before its early exit.

`tile_composite` launches csrc/tile_raster_fwd.cu (B1) for CUDA tensors and
runs `tile_composite_plain` for CPU tensors. It is a torch.autograd.Function
whose backward is kernel B2 (csrc/tile_raster_bwd.cu; plain version
`tile_composite_backward_plain`): per-slot gradients [cap, 16] of the packed
rows, exactly 0 on slots the forward's walk never reached.
"""
from __future__ import annotations

import ctypes

import torch
from torch.profiler import record_function

from threedgrut_torch import constants as C
from threedgrut_torch.ops import cuda_build
from threedgrut_torch.ops.particles import kernel_response

CHUNK = 128          # slots per window (the early-exit granularity)
PIX = C.TILE_SIZE    # pixels per tile
ROW_F = 16           # packed floats per particle

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _tile_pairs(S, ray, degree, min_response, min_alpha, max_alpha,
                has_t_max):
    """Pair quantities of a tile's slot rows S [..., K, >= 13] against its
    rays [..., 8, PIX], each [..., K, PIX] (or [..., K, 1]): the plain form
    of csrc/tile_pair.cuh, batched over any leading dims. `alpha` is zero
    where the hit is not accepted."""
    o = [ray[..., i:i + 1, :] for i in range(3)]      # [..., 1, PIX]
    d = [ray[..., 3 + i:4 + i, :] for i in range(3)]
    a = [S[..., i:i + 1] for i in range(9)]           # [..., K, 1]
    w0 = [o[i] - S[..., 9 + i:10 + i] for i in range(3)]
    u = [a[3 * r] * w0[0] + a[3 * r + 1] * w0[1] + a[3 * r + 2] * w0[2]
         for r in range(3)]
    v = [a[3 * r] * d[0] + a[3 * r + 1] * d[1] + a[3 * r + 2] * d[2]
         for r in range(3)]
    cr = [v[1] * u[2] - v[2] * u[1], v[2] * u[0] - v[0] * u[2],
          v[0] * u[1] - v[1] * u[0]]
    crsq = cr[0] * cr[0] + cr[1] * cr[1] + cr[2] * cr[2]
    vsq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    inv_vsq = 1.0 / torch.clamp(vsq, min=1e-24)
    g = crsq * inv_vsq
    # The kernels keep sqrt away from 0, as the JAX kernel does.
    g_resp = torch.clamp(g, min=1e-12) if degree in (0, 1, 3, 5) else g
    resp = kernel_response(g_resp, degree)
    alpha_raw = resp * S[..., 12:13]
    alpha = torch.clamp(alpha_raw, max=max_alpha)
    vdotu = v[0] * u[0] + v[1] * u[1] + v[2] * u[2]
    hit_t = torch.abs(vdotu) * inv_vsq
    accept = (resp > min_response) & (alpha > min_alpha)
    if has_t_max:
        tmax = ray[..., 6:7, :]
        accept &= (tmax <= 0.0) | (hit_t <= tmax)
    alpha = torch.where(accept, alpha, torch.zeros_like(alpha))
    return dict(w0=w0, u=u, v=v, cr=cr, inv_vsq=inv_vsq, g=g, resp=resp,
                alpha_raw=alpha_raw, alpha=alpha, accept=accept,
                vdotu=vdotu, hit_t=hit_t)


def _tile_weights(alpha, min_transmittance):
    """Front-to-back transmittance of one tile: (one_m, incl, t_before, w),
    each [K, PIX]. torch.cumprod runs in slot order, the kernels' order."""
    one_m = 1.0 - alpha
    incl = torch.cumprod(one_m, dim=0)
    t_before = torch.cat([torch.ones_like(incl[:1]), incl[:-1]])
    live = t_before > min_transmittance
    w = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
    return one_m, incl, t_before, w


def _walked(incl, s, e, min_transmittance):
    """Slots the walk of tile range [s, e) covers before its early exit:
    it stops after the first window at whose end no pixel has
    T > min_transmittance (T is non-increasing)."""
    w_lo, w_hi = s // CHUNK, (e - 1) // CHUNK + 1
    last = [min(e, (j + 1) * CHUNK) - s - 1 for j in range(w_lo, w_hi)]
    alive = (incl[last] > min_transmittance).any(1)            # [windows]
    n_walk = len(last) if bool(alive.all()) else int(
        torch.argmin(alive.to(torch.int32))) + 1
    return min(max((w_lo + n_walk) * CHUNK, s), e) - s


def tile_composite_plain(data_sorted, tile_starts, tile_ends, rays,
                         degree: int, min_transmittance: float,
                         min_response: float = C.MIN_KERNEL_RESPONSE,
                         min_alpha: float = C.MIN_ALPHA,
                         max_alpha: float = C.MAX_ALPHA,
                         has_t_max: bool = True, aux_outputs: bool = True,
                         emit_flags: bool = False):
    """Plain version of B1: a loop over tiles, each tile's whole slot range
    at once, transmittance by torch.cumprod. Returns (out, flags or None)."""
    num_tiles = rays.shape[0]
    dev = rays.device
    out = torch.zeros((num_tiles, 8, PIX), dtype=torch.float32, device=dev)
    out[:, 5] = 1.0
    flags = (torch.zeros(data_sorted.shape[0], dtype=torch.float32,
                         device=dev) if emit_flags else None)
    starts = tile_starts.tolist()
    ends = tile_ends.tolist()
    for t in range(num_tiles):
        s, e = starts[t], ends[t]
        if e <= s:
            continue
        S = data_sorted[s:e]                              # [K, 16]
        q = _tile_pairs(S, rays[t], degree, min_response, min_alpha,
                        max_alpha, has_t_max)
        _, incl, t_before, w = _tile_weights(q["alpha"], min_transmittance)
        out[t, 0:3] = S[:, 13:16].T @ w
        out[t, 3] = w.sum(0)
        if aux_outputs:
            out[t, 4] = (w * q["hit_t"]).sum(0)
            out[t, 6] = (w > 0.0).sum(0).to(torch.float32)
        live = t_before > min_transmittance
        t_after = torch.where(live, incl, torch.full_like(incl, 3.4e38))
        out[t, 5] = torch.clamp(t_after.min(0).values, max=1.0)
        out[t, 7] = float(_walked(incl, s, e, min_transmittance))
        if emit_flags:
            flags[s:e] = w.max(1).values
    return out, flags


def _response_grad(g, resp, degree: int):
    """dr/dg given r = kernel_response(g) (csrc/tile_pair.cuh
    kernel_response_grad, JAX _response_and_grad_coeff)."""
    s = C.GG_SCALE[degree]
    if degree in (0, 1, 3, 5):
        sq = torch.sqrt(torch.clamp(g, min=1e-12))
    if degree == 0:
        return torch.where(resp > 0.0, 0.5 * s / sq, torch.zeros_like(g))
    if degree == 1:
        return resp * s * 0.5 / sq
    if degree == 2:
        return resp * s
    if degree == 3:
        return resp * s * 1.5 * sq
    if degree == 4:
        return resp * s * 2.0 * g
    if degree == 5:
        return resp * s * 2.5 * g * sq
    return resp * s * 4.0 * (g * g) * g


def tile_composite_backward_plain(data_sorted, tile_starts, tile_ends, rays,
                                  out, g_out, degree: int,
                                  min_transmittance: float,
                                  min_response: float = C.MIN_KERNEL_RESPONSE,
                                  min_alpha: float = C.MIN_ALPHA,
                                  max_alpha: float = C.MAX_ALPHA,
                                  has_t_max: bool = True,
                                  aux_grads: bool = True):
    """Plain version of B2: per-slot gradients [cap, 16] of the packed rows
    for the output cotangent g_out [num_tiles, 8, 256], given the forward's
    output `out`. A loop over tiles; the suffix sums come from the forward
    totals (a_tot - cumsum), as in the kernel. Slots past a tile's early
    exit, and slots of no tile, get exactly 0."""
    num_tiles = rays.shape[0]
    grad = torch.zeros_like(data_sorted)
    starts = tile_starts.tolist()
    ends = tile_ends.tolist()
    for t in range(num_tiles):
        s, e = starts[t], ends[t]
        if e <= s:
            continue
        S = data_sorted[s:e]
        q = _tile_pairs(S, rays[t], degree, min_response, min_alpha,
                        max_alpha, has_t_max)
        one_m, incl, t_before, w = _tile_weights(q["alpha"],
                                                 min_transmittance)
        walked = _walked(incl, s, e, min_transmittance)
        if walked <= 0:
            continue
        go, fo = g_out[t], out[t]
        dC, dO = go[0:3], go[3][None, :]
        dD, dT = go[4][None, :], go[5][None, :]
        a_tot = fo[0] * dC[0] + fo[1] * dC[1] + fo[2] * dC[2] + fo[3] * dO[0]
        if aux_grads:
            a_tot = a_tot + fo[4] * dD[0]
        qj = (S[:, 13:14] * dC[0][None, :] + S[:, 14:15] * dC[1][None, :]
              + S[:, 15:16] * dC[2][None, :])
        qj = qj + q["hit_t"] * dD + dO if aux_grads else qj + dO
        suffix = a_tot[None, :] - torch.cumsum(w * qj, dim=0)
        inv_one_m = 1.0 / torch.clamp(one_m, min=1e-6)
        d_alpha = t_before * qj - suffix * inv_one_m
        if aux_grads:
            d_alpha = d_alpha - dT * fo[5][None, :] * inv_one_m
        live = w > 0.0
        zero = torch.zeros_like(w)
        unclamped = (q["alpha_raw"] < max_alpha) & live
        d_resp = torch.where(unclamped, S[:, 12:13] * d_alpha, zero)
        d_opa = torch.where(unclamped, q["resp"] * d_alpha, zero)
        d_g = d_resp * _response_grad(q["g"], q["resp"], degree)
        inv_vsq = q["inv_vsq"]
        d_crsq = d_g * inv_vsq
        d_vsq = (-q["g"] * inv_vsq) * d_g
        u, v, cr, w0 = q["u"], q["v"], q["cr"], q["w0"]
        if aux_grads:
            d_hit = torch.where(live, w * dD, zero)
            d_m = torch.sign(q["vdotu"]) * inv_vsq * d_hit
            d_vsq = d_vsq + (-q["hit_t"] * inv_vsq) * d_hit
        else:
            d_m = zero
        crxv = [cr[1] * v[2] - cr[2] * v[1], cr[2] * v[0] - cr[0] * v[2],
                cr[0] * v[1] - cr[1] * v[0]]
        uxcr = [u[1] * cr[2] - u[2] * cr[1], u[2] * cr[0] - u[0] * cr[2],
                u[0] * cr[1] - u[1] * cr[0]]
        du = [torch.where(live, 2.0 * d_crsq * crxv[i] + d_m * v[i], zero)
              for i in range(3)]
        dv = [torch.where(live, 2.0 * d_crsq * uxcr[i] + d_m * u[i]
                          + 2.0 * d_vsq * v[i], zero) for i in range(3)]
        d = rays[t, 3:6]
        rows = [(du[r] * w0[k] + dv[r] * d[k][None, :]).sum(1)
                for r in range(3) for k in range(3)]
        su = [x.sum(1) for x in du]
        rows += [-(S[:, k] * su[0] + S[:, 3 + k] * su[1]
                   + S[:, 6 + k] * su[2]) for k in range(3)]
        rows.append(d_opa.sum(1))
        rows += [(w * dC[c][None, :]).sum(1) for c in range(3)]
        grad[s:s + walked] = torch.stack(rows, dim=1)[:walked]
    return grad


def _check_launch(data_sorted, tile_starts, tile_ends, rays, degree,
                  **tile_buffers):
    """Validate a compositor launch's inputs (and any further [num_tiles,
    8, 256] f32 buffers) before their pointers go to C."""
    cap = data_sorted.shape[0]
    num_tiles = rays.shape[0]
    cuda_build.checked_inputs(
        ("rays", rays, torch.float32, (num_tiles, 8, PIX)),
        ("data_sorted", data_sorted, torch.float32, (cap, ROW_F)),
        ("tile_starts", tile_starts, torch.int32, (num_tiles,)),
        ("tile_ends", tile_ends, torch.int32, (num_tiles,)),
        *[(k, v, torch.float32, (num_tiles, 8, PIX))
          for k, v in tile_buffers.items()])
    if cap % CHUNK:
        raise ValueError(f"the slot capacity must be a multiple of {CHUNK} "
                         f"(the kernel loads whole windows), got {cap}")
    if degree not in C.GG_SCALE:
        raise ValueError(f"unsupported kernel degree {degree}")


def _launch(data_sorted, tile_starts, tile_ends, rays, degree,
            min_transmittance, min_response, min_alpha, max_alpha,
            has_t_max, aux_outputs, emit_flags):
    dev = rays.device
    cap = data_sorted.shape[0]
    num_tiles = rays.shape[0]
    _check_launch(data_sorted, tile_starts, tile_ends, rays, degree)
    out = torch.empty((num_tiles, 8, PIX), dtype=torch.float32, device=dev)
    flags = (torch.zeros(cap, dtype=torch.float32, device=dev)
             if emit_flags else None)
    lib = cuda_build.library("tile_raster_fwd",
                             [_P] * 6 + [_I, _I, _F, _F, _F, _F, _I, _I, _P])
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.launches["tile_raster_fwd"] += 1
    cuda_build.check("tile_raster_fwd", lib.tile_raster_fwd(
        data_sorted.data_ptr(), tile_starts.data_ptr(), tile_ends.data_ptr(),
        rays.data_ptr(), out.data_ptr(),
        flags.data_ptr() if emit_flags else None, num_tiles, degree,
        min_transmittance, min_response, min_alpha, max_alpha,
        int(bool(has_t_max)), int(bool(aux_outputs)), stream))
    return out, flags


def _launch_backward(data_sorted, tile_starts, tile_ends, rays, out, g_out,
                     degree, min_transmittance, min_response, min_alpha,
                     max_alpha, has_t_max, aux_grads):
    cap = data_sorted.shape[0]
    num_tiles = rays.shape[0]
    _check_launch(data_sorted, tile_starts, tile_ends, rays, degree,
                  out=out, g_out=g_out)
    # Zeroed: slots the walk never reaches keep an exact 0.
    grad = torch.zeros((cap, ROW_F), dtype=torch.float32, device=rays.device)
    lib = cuda_build.library("tile_raster_bwd",
                             [_P] * 7 + [_I, _I, _F, _F, _F, _F, _I, _I, _P])
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    cuda_build.launches["tile_raster_bwd"] += 1
    cuda_build.check("tile_raster_bwd", lib.tile_raster_bwd(
        data_sorted.data_ptr(), tile_starts.data_ptr(), tile_ends.data_ptr(),
        rays.data_ptr(), out.data_ptr(), g_out.data_ptr(), grad.data_ptr(),
        num_tiles, degree, min_transmittance, min_response, min_alpha,
        max_alpha, int(bool(has_t_max)), int(bool(aux_grads)), stream))
    return grad


def tile_composite_backward(data_sorted, tile_starts, tile_ends, rays, out,
                            g_out, degree: int, min_transmittance: float,
                            min_response: float = C.MIN_KERNEL_RESPONSE,
                            min_alpha: float = C.MIN_ALPHA,
                            max_alpha: float = C.MAX_ALPHA,
                            has_t_max: bool = True, aux_grads: bool = True):
    """B2: per-slot gradients [cap, 16] of the packed rows for the output
    cotangent `g_out`, given the forward's output `out` (the JAX package's
    _backward_windows, in slot layout). `aux_grads=False` drops the depth
    and transmittance cotangents (rows 4-5 of g_out are not read). Launches
    the kernel for CUDA tensors; the plain version for CPU tensors."""
    fn = (tile_composite_backward_plain if rays.device.type == "cpu"
          else _launch_backward)
    with record_function("3dgut.bwd_composite"):
        return fn(data_sorted, tile_starts, tile_ends, rays, out,
                  g_out.contiguous(), degree, min_transmittance,
                  min_response, min_alpha, max_alpha, has_t_max, aux_grads)


class _TileComposite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data_sorted, tile_starts, tile_ends, rays, degree,
                min_transmittance, min_response, min_alpha, max_alpha,
                has_t_max, aux_outputs, emit_flags, aux_grads):
        fn = tile_composite_plain if rays.device.type == "cpu" else _launch
        data_sorted, rays = data_sorted.detach(), rays.detach()
        out, flags = fn(data_sorted, tile_starts, tile_ends, rays, degree,
                        min_transmittance, min_response, min_alpha,
                        max_alpha, has_t_max, aux_outputs, emit_flags)
        if flags is None:
            flags = torch.zeros(0, dtype=torch.float32, device=rays.device)
        ctx.mark_non_differentiable(flags)
        ctx.save_for_backward(data_sorted, tile_starts, tile_ends, rays, out)
        ctx.args = (degree, min_transmittance, min_response, min_alpha,
                    max_alpha, has_t_max, aux_grads)
        ctx.emit_flags = emit_flags
        return out, flags

    @staticmethod
    def backward(ctx, g_out, g_flags):
        if ctx.emit_flags:
            raise ValueError(
                "gut.render(hit_visibility=True) is eval-only and cannot be "
                "differentiated: the contributed-bit leg of the compositor "
                "has no backward. For training use hit_visibility=False; "
                "the trainer derives the same bit from nonzero gradients")
        data_sorted, tile_starts, tile_ends, rays, out = ctx.saved_tensors
        g_data = tile_composite_backward(data_sorted, tile_starts, tile_ends,
                                         rays, out, g_out, *ctx.args)
        return (g_data,) + (None,) * 12


def tile_composite(data_sorted, tile_starts, tile_ends, rays, degree: int,
                   min_transmittance: float,
                   min_response: float = C.MIN_KERNEL_RESPONSE,
                   min_alpha: float = C.MIN_ALPHA,
                   max_alpha: float = C.MAX_ALPHA, has_t_max: bool = True,
                   aux_outputs: bool = True, emit_flags: bool = False,
                   aux_grads: bool = True):
    """B1 forward, differentiable in `data_sorted` through B2: returns
    (out, flags). `out` is the [num_tiles, 8, 256] output buffer (module
    docstring); `flags` is None unless `emit_flags`, then the per-slot max
    composite weight [cap] (> 0 iff the slot contributed to some pixel; that
    leg has no backward). Tile ranges must lie within [0, cap].
    `aux_grads=False` asserts the loss reads only rgb and opacity: the
    backward then drops the depth and transmittance cotangents. A
    differentiable call with `aux_outputs=False` needs `aux_grads=False`
    (the backward rebuilds its totals from the depth row)."""
    if (not aux_outputs and aux_grads and torch.is_grad_enabled()
            and data_sorted.requires_grad):
        raise ValueError("aux_outputs=False requires aux_grads=False")
    out, flags = _TileComposite.apply(
        data_sorted, tile_starts, tile_ends, rays, degree,
        float(min_transmittance), float(min_response), float(min_alpha),
        float(max_alpha), bool(has_t_max), bool(aux_outputs),
        bool(emit_flags), bool(aux_grads))
    return out, (flags if emit_flags else None)
