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
rows, exactly 0 on slots the forward's walk never reached. A
differentiable forward's B1 also writes a record of its walk that its B2
re-walks (`forward_order`, laid out by `order_buffer`): in the sorted mode
each pixel-window's compositing order, which B2 follows instead of sorting
again; without passes each pixel-window's live-row mask (a bit per row,
set where the pixel took the row: w > 0; plain version `live_rows_plain`),
so that B2 evaluates pairs only on rows some pixel of a warp took. B2 given
no record runs B1 to write it. Both launch their tiles heaviest first, in
one order the record holds (`heaviest_first`).

Two options change the semantics, as in the JAX kernel:
  * `sorted_passes` > 0 (the "sorted" k-buffer mode): per pixel and
    absolute 128-slot window (slots 128 w ... 128 w + 127, so CHUNK is part
    of the result), the keys hit_t of the tile's rows, accepted or not,
    with rows before the tile's start pinned at -3.4e38 and rows at or past
    its end at +3.4e38, go through exactly `sorted_passes` passes of
    odd-even transposition (pass i compares positions (j, j+1), j = i mod 2,
    swapping where key[j+1] < key[j]). The exclusive product of 1 - alpha
    in that order gives T_before = carry * excl; a row counts while
    T_before > min_transmittance; the carry becomes min(carry, min over
    counted rows of T_before (1 - alpha)). The emitted flag of a slot is
    the max over the tile's pixels of that row's weight.
  * `row_termination`: rays row 7 holds each pixel's last-touch slot lt
    (tiles.row_last_touch); alpha is 0 where the slot index exceeds lt
    (before the sort: such rows keep their key). A tile starts only if some
    lt >= 128 w0 and stops after window g unless some pixel has
    T > min_transmittance and lt >= 128 (g + 1).
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


def oddeven_passes(key: torch.Tensor, vals, passes: int, activity=None):
    """`passes` passes of odd-even transposition along dim 1 of key [B, K,
    ...]: pass i swaps positions (j, j+1), j = i mod 2, where key[j+1] <
    key[j]. Returns (key, vals) permuted alike. A list `activity` gets,
    per pass, whether it swapped anything in each lane [B, ...]."""
    k = key.shape[1]
    for i in range(passes):
        lo = slice(i % 2, k - 1, 2)
        hi = slice(i % 2 + 1, k, 2)
        swap = key[:, hi] < key[:, lo]
        if activity is not None:
            activity.append(swap.any(1))
        out = []
        for x in [key] + list(vals):
            a, b = x[:, lo], x[:, hi]
            x = x.clone()
            x[:, lo] = torch.where(swap, b, a)
            x[:, hi] = torch.where(swap, a, b)
            out.append(x)
        key, vals = out[0], out[1:]
    return key, vals


BIG = 3.4e38         # sort key pinning a row outside the tile's range
TILE_BATCH = 64      # tiles per step of the plain versions' window walk


def _tile_weights(alpha, min_transmittance):
    """Front-to-back transmittance of one tile: (one_m, incl, t_before, w),
    each [K, PIX]. torch.cumprod runs in slot order, the kernels' order."""
    one_m = 1.0 - alpha
    incl = torch.cumprod(one_m, dim=0)
    t_before = torch.cat([torch.ones_like(incl[:1]), incl[:-1]])
    live = t_before > min_transmittance
    w = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
    return one_m, incl, t_before, w


def _row_gate(alpha, rows, lt):
    """Row termination: alpha [..., K, PIX] is 0 where the slot index rows
    [..., K] exceeds the pixel's last touch lt [..., PIX]."""
    keep = rows.to(torch.float32)[..., None] <= lt[..., None, :]
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def _walked(incl, s, e, min_transmittance, lt=None):
    """Slots the walk of tile range [s, e) covers before its early exit:
    it stops after the first window at whose end no pixel has
    T > min_transmittance (T is non-increasing) and, with row termination,
    a last touch lt at or past the next window. A row-terminated tile whose
    pixels all end before its first window walks nothing."""
    w_lo, w_hi = s // CHUNK, (e - 1) // CHUNK + 1
    if lt is not None and not bool((lt >= float(w_lo * CHUNK)).any()):
        return 0
    last = [min(e, (j + 1) * CHUNK) - s - 1 for j in range(w_lo, w_hi)]
    alive = incl[last] > min_transmittance                     # [windows, PIX]
    if lt is not None:
        nxt = torch.tensor([float((j + 1) * CHUNK) for j in range(w_lo, w_hi)],
                           device=lt.device)
        alive = alive & (lt[None, :] >= nxt[:, None])
    alive = alive.any(1)
    n_walk = len(last) if bool(alive.all()) else int(
        torch.argmin(alive.to(torch.int32))) + 1
    return min(max((w_lo + n_walk) * CHUNK, s), e) - s


def _passes_run(activity, passes):
    """Passes the kernels' network runs per lane: it stops after the first
    pass that follows a pass with no swap and swaps nothing itself."""
    act = torch.stack(activity)                            # [passes, B, PIX]
    run = torch.full(act.shape[1:], passes, device=act.device)
    if passes > 1:
        i = torch.arange(2, passes + 1, device=act.device)[:, None, None]
        run = torch.where(~act[1:] & ~act[:-1], i, run).amin(0)
    return run


def _window_weights(S, rays, rows, s, e, carry, lt, degree,
                    min_transmittance, min_response, min_alpha, max_alpha,
                    has_t_max, sorted_passes, stats=None):
    """Sorted-mode compositing weights of one absolute window of B tiles:
    S [B, CHUNK, 16] its rows, rays [B, 8, PIX], rows [B, CHUNK] their slot
    indices, s, e [B] the tile ranges, carry [B, PIX], lt [B, PIX] or None.
    Returns (pair quantities, 1 - alpha, T_before, live, w), each [B,
    CHUNK, PIX] in row order, and the row at each compositing position. A
    `stats` dict counts the network's work as the kernels do it:
    "live_pixel_windows" (pixels that run it: carry > min_T and, with row
    termination, lt at or past the tile's first row of the window) and
    "network_passes" (the passes those run, _passes_run)."""
    q = _tile_pairs(S, rays, degree, min_response, min_alpha, max_alpha,
                    has_t_max)
    in_range = (rows >= s[:, None]) & (rows < e[:, None])
    alpha = torch.where(in_range[..., None], q["alpha"],
                        torch.zeros_like(q["alpha"]))
    if lt is not None:
        alpha = _row_gate(alpha, rows, lt)
    one_m = 1.0 - alpha
    key = torch.where((rows < s[:, None])[..., None],
                      torch.full_like(alpha, -BIG), q["hit_t"])
    key = torch.where((rows >= e[:, None])[..., None],
                      torch.full_like(alpha, BIG), key)
    pos = torch.arange(CHUNK, device=S.device)[None, :, None].expand(
        alpha.shape)
    activity = [] if stats is not None else None
    _, (om_s, pos_s) = oddeven_passes(key, [one_m, pos], sorted_passes,
                                      activity)
    if stats is not None:
        go = carry > min_transmittance
        if lt is not None:
            first = torch.maximum(rows[:, 0], s).to(torch.float32)
            go &= first[:, None] <= lt
        stats["live_pixel_windows"] += int(go.sum())
        stats["network_passes"] += int(
            (_passes_run(activity, sorted_passes) * go).sum())
    incl = torch.cumprod(om_s, dim=1)
    excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
    excl = torch.empty_like(excl).scatter_(1, pos_s, excl)
    t_before = carry[:, None, :] * excl
    live = t_before > min_transmittance
    w = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
    return q, one_m, t_before, live, w, pos_s


def _window_walk(tile_starts, tile_ends, rays, row_termination,
                 min_transmittance, step):
    """Walk every tile's absolute windows, vectorised across the tiles:
    step k calls step(b, wi, carry_b) for the tiles b still walking with
    window wi = w0 + k, which returns their new carry. Returns (carry
    [num_tiles, PIX], slots walked [num_tiles]), the walk stopping as the
    kernels' does (module docstring)."""
    s = tile_starts.long()
    e = tile_ends.long()
    w0 = torch.div(s, CHUNK, rounding_mode="floor")
    w1 = torch.where(e > s, torch.div(e - 1, CHUNK, rounding_mode="floor")
                     + 1, w0)
    carry = torch.ones((rays.shape[0], PIX), device=rays.device)
    lt = rays[:, 7] if row_termination else None
    walking = e > s
    if lt is not None:
        walking &= (lt >= (w0 * CHUNK).to(torch.float32)[:, None]).any(1)
    walked = torch.zeros_like(w0)
    k = 0
    while True:
        step_tiles = torch.nonzero(walking & (w0 + k < w1)).reshape(-1)
        if step_tiles.numel() == 0:
            break
        for b in step_tiles.split(TILE_BATCH):
            wi = w0[b] + k
            cb = step(b, wi, carry[b])
            carry[b] = cb
            walked[b] += 1
            alive = cb > min_transmittance
            if lt is not None:
                alive &= lt[b] >= ((wi + 1) * CHUNK).to(torch.float32)[:, None]
            walking[b] = alive.any(1)
        k += 1
    gf = (w0 + walked) * CHUNK
    return carry, torch.minimum(torch.maximum(gf, s), e) - s


def _composite_windows(data_sorted, tile_starts, tile_ends, rays, degree,
                       min_transmittance, min_response, min_alpha, max_alpha,
                       has_t_max, aux_outputs, emit_flags, sorted_passes,
                       row_termination, stats):
    """Plain B1 in the sorted mode, window by window (the re-sort runs in
    absolute windows): step k takes window w0 + k of every tile still
    walking, vectorised across them."""
    num_tiles = rays.shape[0]
    windows = data_sorted.view(-1, CHUNK, ROW_F)
    out = torch.zeros((num_tiles, 8, PIX), dtype=torch.float32,
                      device=rays.device)
    flags = (torch.zeros(windows.shape[:2], dtype=torch.float32,
                         device=rays.device) if emit_flags else None)
    s, e = tile_starts.long(), tile_ends.long()
    lt = rays[:, 7] if row_termination else None
    lane = torch.arange(CHUNK, device=rays.device)

    def step(b, wi, carry):
        S = windows[wi]
        q, one_m, t_before, live, w, _ = _window_weights(
            S, rays[b], wi[:, None] * CHUNK + lane, s[b], e[b], carry,
            None if lt is None else lt[b], degree, min_transmittance,
            min_response, min_alpha, max_alpha, has_t_max, sorted_passes,
            stats)
        out[b, 0:3] += torch.matmul(S[..., 13:16].transpose(1, 2), w)
        out[b, 3] += w.sum(1)
        if aux_outputs:
            out[b, 4] += (w * q["hit_t"]).sum(1)
            out[b, 6] += (w > 0.0).sum(1).to(torch.float32)
        if emit_flags:
            # Rows of other tiles carry w == 0: their flags stay as set.
            flags.index_add_(0, wi, w.amax(2))
        t_after = torch.where(live, t_before * one_m,
                              torch.full_like(t_before, BIG))
        return torch.minimum(t_after.amin(1), carry)

    carry, walked = _window_walk(tile_starts, tile_ends, rays,
                                 row_termination, min_transmittance, step)
    out[:, 5] = carry
    out[:, 7] = walked.to(torch.float32)[:, None]
    return out, (flags.reshape(-1) if emit_flags else None)


def _tile_state(data_sorted, rays, t, s, e, row_termination, degree,
                min_transmittance, min_response, min_alpha, max_alpha,
                has_t_max, taken=None):
    """The default legs' compositing state of tile t's slots [s, e): (rows
    S [K, 16], pair quantities, lt [PIX] or None, and _tile_weights' 1 -
    alpha, incl, T_before, w, each [K, PIX]). `taken` [K, PIX] (a live-row
    mask) keeps alpha only on the rows it marks."""
    lt = rays[t, 7] if row_termination else None
    S = data_sorted[s:e]                                  # [K, 16]
    q = _tile_pairs(S, rays[t], degree, min_response, min_alpha, max_alpha,
                    has_t_max)
    alpha = q["alpha"]
    if lt is not None:
        alpha = _row_gate(alpha, torch.arange(s, e, device=S.device), lt)
    if taken is not None:
        alpha = torch.where(taken, alpha, torch.zeros_like(alpha))
    return (S, q, lt) + _tile_weights(alpha, min_transmittance)


WARP = 32             # pixels of a warp: 32 consecutive pixels of a tile
DEFAULT_STATS = ("pixel_live_pairs", "live_pairs", "warp_live_rows",
                 "saturated_warp_rows", "row_parts", "live_row_parts")


def shares_origin(rays):
    """[num_tiles] bool: whether tile t's 256 ray origins (rays rows 0-2)
    are bitwise equal, as csrc/tile_raster_fwd.cu tile_shares_origin
    tests (every global-shutter camera)."""
    o = rays[:, 0:3].contiguous().view(torch.int32)
    return (o == o[:, :, :1]).all(dim=2).all(dim=1)


def _count_default(stats, t_before, w, rows, lt, walked, min_transmittance,
                   shared):
    """Add one tile's work in the default legs to `stats` (walked rows only;
    t_before, w [K, PIX] in slot order, rows [K] the slot indices, lt [PIX]
    or None): "pixel_live_pairs", the pairs B1 evaluates (T > min_T and,
    with row termination, the row at or before lt); "live_pairs", the rows
    taken (w > 0: the pairs B2 evaluates); "warp_live_rows", the (warp,
    row) with some taken lane (B2's reductions); "saturated_warp_rows",
    the (warp, row) with no lane B1 evaluates (which B1 skips);
    "row_parts", the pair's per-row part (w0 = o - mean, u = A w0) that
    B1's pairs need: once per row some pixel evaluates where the tile's
    rays share one origin (`shared`), else once per pixel-live pair;
    "live_row_parts", the same for the taken rows (B2)."""
    px = t_before[:walked] > min_transmittance
    if lt is not None:
        px &= rows[:walked].to(torch.float32)[:, None] <= lt[None, :]
    live = w[:walked] > 0.0
    stats["pixel_live_pairs"] += int(px.sum())
    stats["live_pairs"] += int(live.sum())
    stats["row_parts"] += int((px.any(1) if shared else px).sum())
    stats["live_row_parts"] += int((live.any(1) if shared else live).sum())
    stats["warp_live_rows"] += int(
        live.view(walked, PIX // WARP, WARP).any(-1).sum())
    stats["saturated_warp_rows"] += int(
        (~px).view(walked, PIX // WARP, WARP).all(-1).sum())


def tile_composite_plain(data_sorted, tile_starts, tile_ends, rays,
                         degree: int, min_transmittance: float,
                         min_response: float = C.MIN_KERNEL_RESPONSE,
                         min_alpha: float = C.MIN_ALPHA,
                         max_alpha: float = C.MAX_ALPHA,
                         has_t_max: bool = True, aux_outputs: bool = True,
                         emit_flags: bool = False, sorted_passes: int = 0,
                         row_termination: bool = False, stats=None):
    """Plain version of B1. Without passes: a loop over tiles, each tile's
    whole slot range at once, transmittance by torch.cumprod (a `stats`
    dict gets the default legs' work, _count_default); with passes, window
    by window (and `stats` gets the network's work, _window_weights).
    Returns (out, flags or None)."""
    if sorted_passes:
        if stats is not None:
            stats.update(live_pixel_windows=0, network_passes=0)
        return _composite_windows(
            data_sorted, tile_starts, tile_ends, rays, degree,
            min_transmittance, min_response, min_alpha, max_alpha,
            has_t_max, aux_outputs, emit_flags, sorted_passes,
            row_termination, stats)
    if stats is not None:
        stats.update(dict.fromkeys(DEFAULT_STATS, 0))
        shared = shares_origin(rays).tolist()
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
        S, q, lt, _, incl, t_before, w = _tile_state(
            data_sorted, rays, t, s, e, row_termination, degree,
            min_transmittance, min_response, min_alpha, max_alpha, has_t_max)
        out[t, 0:3] = S[:, 13:16].T @ w
        out[t, 3] = w.sum(0)
        if aux_outputs:
            out[t, 4] = (w * q["hit_t"]).sum(0)
            out[t, 6] = (w > 0.0).sum(0).to(torch.float32)
        live = t_before > min_transmittance
        t_after = torch.where(live, incl, torch.full_like(incl, BIG))
        out[t, 5] = torch.clamp(t_after.min(0).values, max=1.0)
        walked = _walked(incl, s, e, min_transmittance, lt)
        out[t, 7] = float(walked)
        if stats is not None:
            _count_default(stats, t_before, w, torch.arange(s, e, device=dev),
                           lt, walked, min_transmittance, shared[t])
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


def _slot_grads(S, ray, q, one_m, t_before, w, qj, suffix, t_final, g,
                degree: int, max_alpha: float, aux_grads: bool):
    """The 16 per-slot gradient entries of rows S [..., K, 16] summed over
    the pixels of rays ray [..., 8, PIX], given the pair quantities q, the
    compositing state (1 - alpha, T_before, w, each [..., K, PIX]), q_j, the
    suffix sum_{k after j} w_k q_k, the forward's final transmittance
    t_final [..., 1, PIX] and the output cotangent g [..., 8, PIX] (module
    docstring of the JAX kernel: d_alpha, then the exact cross form).
    Returns [..., K, 16]; pixels with w == 0 contribute exactly 0."""
    dC = [g[..., c:c + 1, :] for c in range(3)]
    dD, dT = g[..., 4:5, :], g[..., 5:6, :]
    inv_one_m = 1.0 / torch.clamp(one_m, min=1e-6)
    d_alpha = t_before * qj - suffix * inv_one_m
    if aux_grads:
        d_alpha = d_alpha - dT * t_final * inv_one_m
    live = w > 0.0
    zero = torch.zeros_like(w)
    unclamped = (q["alpha_raw"] < max_alpha) & live
    d_resp = torch.where(unclamped, S[..., 12:13] * d_alpha, zero)
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
    d = [ray[..., 3 + k:4 + k, :] for k in range(3)]
    rows = [(du[r] * w0[k] + dv[r] * d[k]).sum(-1)
            for r in range(3) for k in range(3)]
    su = [x.sum(-1) for x in du]
    rows += [-(S[..., k] * su[0] + S[..., 3 + k] * su[1]
               + S[..., 6 + k] * su[2]) for k in range(3)]
    rows.append(d_opa.sum(-1))
    rows += [(w * dC[c]).sum(-1) for c in range(3)]
    return torch.stack(rows, dim=-1)


def _pixel_q(S, q, g, aux_grads):
    """q_j = rgb . dC + hit_t dD + dO (dD only with aux_grads) per (slot,
    pixel) of rows S [..., K, 16] for the output cotangent g [..., 8, PIX]."""
    qj = (S[..., 13:14] * g[..., 0:1, :] + S[..., 14:15] * g[..., 1:2, :]
          + S[..., 15:16] * g[..., 2:3, :])
    if aux_grads:
        return qj + q["hit_t"] * g[..., 4:5, :] + g[..., 3:4, :]
    return qj + g[..., 3:4, :]


def _total(out, g_out, aux_grads):
    """a_tot = sum over all hits of w q, rebuilt from the forward's output
    rows: rgb . dC + opacity dO (+ depth dD with aux_grads), [..., PIX]."""
    a_tot = (out[..., 0, :] * g_out[..., 0, :]
             + out[..., 1, :] * g_out[..., 1, :]
             + out[..., 2, :] * g_out[..., 2, :]
             + out[..., 3, :] * g_out[..., 3, :])
    if aux_grads:
        a_tot = a_tot + out[..., 4, :] * g_out[..., 4, :]
    return a_tot


def _composite_windows_backward(data_sorted, tile_starts, tile_ends, rays,
                                out, g_out, degree, min_transmittance,
                                min_response, min_alpha, max_alpha,
                                has_t_max, aux_grads, sorted_passes,
                                row_termination):
    """Plain B2 in the sorted mode, window by window as _composite_windows:
    the suffix runs in each pixel's compositing order (prefix sums there,
    mapped back to row order), each row's entries sum over the tile's
    pixels."""
    windows = data_sorted.view(-1, CHUNK, ROW_F)
    grad = torch.zeros_like(windows)
    s, e = tile_starts.long(), tile_ends.long()
    lt = rays[:, 7] if row_termination else None
    lane = torch.arange(CHUNK, device=rays.device)
    prefix = torch.zeros((rays.shape[0], PIX), device=rays.device)
    a_tot = _total(out, g_out, aux_grads)

    def step(b, wi, carry):
        S = windows[wi]
        rows = wi[:, None] * CHUNK + lane
        q, one_m, t_before, live, w, pos_s = _window_weights(
            S, rays[b], rows, s[b], e[b], carry,
            None if lt is None else lt[b], degree, min_transmittance,
            min_response, min_alpha, max_alpha, has_t_max, sorted_passes)
        go = g_out[b]
        qj = _pixel_q(S, q, go, aux_grads)
        wq = w * qj
        rest = (a_tot[b] - prefix[b])[:, None, :]
        incl_s = torch.cumsum(torch.gather(wq, 1, pos_s), dim=1)
        suffix = torch.empty_like(wq).scatter_(1, pos_s, rest - incl_s)
        G = _slot_grads(S, rays[b], q, one_m, t_before, w, qj, suffix,
                        out[b, 5:6], go, degree, max_alpha, aux_grads)
        in_range = (rows >= s[b, None]) & (rows < e[b, None])
        grad.index_add_(0, wi, torch.where(in_range[..., None], G,
                                           torch.zeros_like(G)))
        prefix[b] = prefix[b] + wq.sum(1)
        t_after = torch.where(live, t_before * one_m,
                              torch.full_like(t_before, BIG))
        return torch.minimum(t_after.amin(1), carry)

    _window_walk(tile_starts, tile_ends, rays, row_termination,
                 min_transmittance, step)
    return grad.reshape(-1, ROW_F)


def tile_composite_backward_plain(data_sorted, tile_starts, tile_ends, rays,
                                  out, g_out, degree: int,
                                  min_transmittance: float,
                                  min_response: float = C.MIN_KERNEL_RESPONSE,
                                  min_alpha: float = C.MIN_ALPHA,
                                  max_alpha: float = C.MAX_ALPHA,
                                  has_t_max: bool = True,
                                  aux_grads: bool = True,
                                  sorted_passes: int = 0,
                                  row_termination: bool = False, mask=None):
    """Plain version of B2: per-slot gradients [cap, 16] of the packed rows
    for the output cotangent g_out [num_tiles, 8, 256], given the forward's
    output `out`. Without passes a loop over tiles; the suffix sums come
    from the forward totals (a_tot - cumsum), as in the kernel; with a
    live-row `mask` (live_rows_plain's or B1's (words, win_base)) only the
    rows it marks composite, as in the kernel's re-walk. With passes window
    by window. Slots past a tile's early exit, and slots of no tile, get
    exactly 0."""
    if sorted_passes:
        if mask is not None:
            raise ValueError("a live-row mask belongs to the default legs "
                             "(0 sorted passes)")
        return _composite_windows_backward(
            data_sorted, tile_starts, tile_ends, rays, out, g_out, degree,
            min_transmittance, min_response, min_alpha, max_alpha, has_t_max,
            aux_grads, sorted_passes, row_termination)
    num_tiles = rays.shape[0]
    grad = torch.zeros_like(data_sorted)
    starts = tile_starts.tolist()
    ends = tile_ends.tolist()
    for t in range(num_tiles):
        s, e = starts[t], ends[t]
        if e <= s:
            continue
        taken = None
        if mask is not None:
            base = int(mask[1][t])
            taken = unpack_rows(mask[0][base:base + _windows(s, e)], s, e)
        S, q, lt, one_m, incl, t_before, w = _tile_state(
            data_sorted, rays, t, s, e, row_termination, degree,
            min_transmittance, min_response, min_alpha, max_alpha, has_t_max,
            taken)
        walked = _walked(incl, s, e, min_transmittance, lt)
        if walked <= 0:
            continue
        go, fo = g_out[t], out[t]
        qj = _pixel_q(S, q, go, aux_grads)
        suffix = (_total(fo, go, aux_grads)[None, :]
                  - torch.cumsum(w * qj, dim=0))
        G = _slot_grads(S, rays[t], q, one_m, t_before, w, qj, suffix,
                        fo[5:6], go, degree, max_alpha, aux_grads)
        grad[s:s + walked] = G[:walked]
    return grad


def _check_launch(data_sorted, tile_starts, tile_ends, rays, degree,
                  sorted_passes, **tile_buffers):
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
    check_passes(sorted_passes)


def check_passes(sorted_passes: int) -> None:
    if sorted_passes < 0:
        raise ValueError(f"sorted_passes must be >= 0, got {sorted_passes}")


_FWD_ARGS = [_P] * 9 + [_I, _I] + [_F] * 4 + [_I] * 4 + [_P]
_BWD_ARGS = [_P] * 10 + [_I, _I] + [_F] * 4 + [_I] * 4 + [_P]


def heaviest_first(work):
    """B1's and B2's block order: the tiles by decreasing `work`
    [num_tiles] (their slot counts), int32, so the longest blocks do not
    start in the last wave."""
    return torch.argsort(work, descending=True).to(torch.int32)


def walk_words(sorted_passes: int) -> int:
    """Words per pixel and window of the walk record B1 writes for B2: the
    compositing order (sorted legs: a byte per position) or the live-row
    mask (default legs: a bit per row)."""
    return CHUNK // 4 if sorted_passes else CHUNK // 32


def order_buffer(tile_starts, tile_ends, cap: int, words: int = CHUNK // 4):
    """Room for the walk records that B1 writes and B2 reads: (words
    [steps, `words`, PIX] int32, win_base [num_tiles] int32, tile_order
    [num_tiles] int32), tile t's k-th window at step win_base[t] + k;
    `words` per walk_words (default: the sorted legs' compositing orders);
    tile_order the block order both kernels launch (heaviest_first), made
    once for the pair. Sized for every window of every tile's range, at
    most cap / CHUNK + num_tiles (ranges are disjoint), so no host sync."""
    s, e = tile_starts.long(), tile_ends.long()
    first = torch.div(s, CHUNK, rounding_mode="floor")
    nwin = torch.where(e > s, torch.div(e - 1, CHUNK, rounding_mode="floor")
                       + 1 - first, torch.zeros_like(s))
    win_base = (torch.cumsum(nwin, 0) - nwin).to(torch.int32)
    buf = torch.empty((cap // CHUNK + s.shape[0], words, PIX),
                      dtype=torch.int32, device=tile_starts.device)
    return buf, win_base, heaviest_first(e - s)


def _windows(s: int, e: int) -> int:
    """Absolute windows that a tile's slot range [s, e) touches."""
    return (e - 1) // CHUNK + 1 - s // CHUNK if e > s else 0


_BIT = torch.arange(32, dtype=torch.int64)


def pack_rows(taken, s: int, e: int):
    """A tile's live-row mask words [windows, CHUNK // 32, PIX] int32 (bit
    k of word j: row 32 j + k of the window) from its taken rows [e - s,
    PIX] bool over slots [s, e)."""
    w0 = s // CHUNK
    nw = _windows(s, e)
    full = torch.zeros((nw * CHUNK, PIX), dtype=torch.int64,
                       device=taken.device)
    full[s - w0 * CHUNK:e - w0 * CHUNK] = taken.to(torch.int64)
    bits = full.view(nw, CHUNK // 32, 32, PIX) << _BIT.to(
        taken.device)[None, None, :, None]
    words = bits.sum(2)                                  # [0, 2^32)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_rows(words, s: int, e: int):
    """The taken rows [e - s, PIX] bool of a tile's mask words (pack_rows)."""
    nw = words.shape[0]
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w[:, :, None, :] >> _BIT.to(words.device)[None, None, :, None]) & 1
    lo = s - (s // CHUNK) * CHUNK
    return bits.reshape(nw * CHUNK, PIX)[lo:lo + e - s] != 0


def live_rows_plain(data_sorted, tile_starts, tile_ends, rays, degree: int,
                    min_transmittance: float,
                    min_response: float = C.MIN_KERNEL_RESPONSE,
                    min_alpha: float = C.MIN_ALPHA,
                    max_alpha: float = C.MAX_ALPHA, has_t_max: bool = True,
                    row_termination: bool = False):
    """Plain version of the live-row mask B1's default legs write for B2:
    (words, win_base) as order_buffer(..., CHUNK // 32) lays them out, bit
    k of word j of a pixel-window set where the pixel took row 32 j + k of
    the window (w > 0), every other word 0."""
    words, win_base, _ = order_buffer(tile_starts, tile_ends,
                                      data_sorted.shape[0], CHUNK // 32)
    words.zero_()
    for t, (s, e) in enumerate(zip(tile_starts.tolist(),
                                   tile_ends.tolist())):
        if e <= s:
            continue
        w = _tile_state(data_sorted, rays, t, s, e, row_termination, degree,
                        min_transmittance, min_response, min_alpha,
                        max_alpha, has_t_max)[-1]
        base = int(win_base[t])
        words[base:base + _windows(s, e)] = pack_rows(w > 0.0, s, e)
    return words, win_base


def dynamic_smem(sorted_passes: int, backward: bool = False) -> int:
    """Bytes of dynamic shared memory a launch of B1 (B2 with `backward`)
    with `sorted_passes` takes: the sorted legs' per-pixel buffers (csrc/
    tile_raster_fwd.cu, tile_raster_bwd.cu), 0 for the others."""
    name = "tile_raster_bwd" if backward else "tile_raster_fwd"
    lib = cuda_build.library(name, _BWD_ARGS if backward else _FWD_ARGS)
    fn = getattr(lib, f"{name}_smem")
    fn.argtypes, fn.restype = [_I], _I
    return int(fn(int(sorted_passes)))


def _check_order(order, cap, num_tiles, sorted_passes):
    cuda_build.checked_inputs(
        ("order", order[0], torch.int32,
         (cap // CHUNK + num_tiles, walk_words(sorted_passes), PIX)),
        ("win_base", order[1], torch.int32, (num_tiles,)),
        ("tile_order", order[2], torch.int32, (num_tiles,)))


def _launch(data_sorted, tile_starts, tile_ends, rays, degree,
            min_transmittance, min_response, min_alpha, max_alpha,
            has_t_max, aux_outputs, emit_flags, sorted_passes=0,
            row_termination=False, order=None):
    """B1. `order` (order_buffer with walk_words(sorted_passes) words)
    receives each walked window's record for B2: the compositing orders
    with sorted passes, the live-row masks without; its tile order is the
    launch's (without a record, heaviest_first's)."""
    dev = rays.device
    cap = data_sorted.shape[0]
    num_tiles = rays.shape[0]
    _check_launch(data_sorted, tile_starts, tile_ends, rays, degree,
                  sorted_passes)
    if order is not None:
        _check_order(order, cap, num_tiles, sorted_passes)
    out = torch.empty((num_tiles, 8, PIX), dtype=torch.float32, device=dev)
    flags = (torch.zeros(cap, dtype=torch.float32, device=dev)
             if emit_flags else None)
    tile_order = (heaviest_first(tile_ends - tile_starts) if order is None
                  else order[2])
    lib = cuda_build.library("tile_raster_fwd", _FWD_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.launches["tile_raster_fwd"] += 1
    cuda_build.check("tile_raster_fwd", lib.tile_raster_fwd(
        data_sorted.data_ptr(), tile_starts.data_ptr(), tile_ends.data_ptr(),
        rays.data_ptr(), out.data_ptr(),
        flags.data_ptr() if emit_flags else None,
        None if order is None else order[0].data_ptr(),
        None if order is None else order[1].data_ptr(),
        tile_order.data_ptr(), num_tiles,
        degree, min_transmittance, min_response, min_alpha, max_alpha,
        int(bool(has_t_max)), int(bool(aux_outputs)), int(sorted_passes),
        int(bool(row_termination)), stream))
    return out, flags


def _launch_backward(data_sorted, tile_starts, tile_ends, rays, out, g_out,
                     degree, min_transmittance, min_response, min_alpha,
                     max_alpha, has_t_max, aux_grads, sorted_passes=0,
                     row_termination=False, order=None):
    """B2. It re-walks the record B1 wrote into `order` for this forward
    (the compositing orders with sorted passes, the live-row masks
    without), in its tile order; without it, B1 runs first to write it."""
    cap = data_sorted.shape[0]
    num_tiles = rays.shape[0]
    _check_launch(data_sorted, tile_starts, tile_ends, rays, degree,
                  sorted_passes, out=out, g_out=g_out)
    if order is None:
        order = order_buffer(tile_starts, tile_ends, cap,
                             walk_words(sorted_passes))
        _launch(data_sorted, tile_starts, tile_ends, rays, degree,
                min_transmittance, min_response, min_alpha, max_alpha,
                has_t_max, False, False, sorted_passes, row_termination,
                order)
    _check_order(order, cap, num_tiles, sorted_passes)
    # Zeroed: slots the walk never reaches keep an exact 0.
    grad = torch.zeros((cap, ROW_F), dtype=torch.float32, device=rays.device)
    tile_order = order[2]
    lib = cuda_build.library("tile_raster_bwd", _BWD_ARGS)
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    cuda_build.launches["tile_raster_bwd"] += 1
    cuda_build.check("tile_raster_bwd", lib.tile_raster_bwd(
        data_sorted.data_ptr(), tile_starts.data_ptr(), tile_ends.data_ptr(),
        rays.data_ptr(), out.data_ptr(), g_out.data_ptr(),
        order[0].data_ptr(), order[1].data_ptr(),
        tile_order.data_ptr(), grad.data_ptr(),
        num_tiles, degree, min_transmittance, min_response, min_alpha,
        max_alpha, int(bool(has_t_max)), int(bool(aux_grads)),
        int(sorted_passes), int(bool(row_termination)), stream))
    return grad


def tile_composite_backward(data_sorted, tile_starts, tile_ends, rays, out,
                            g_out, degree: int, min_transmittance: float,
                            min_response: float = C.MIN_KERNEL_RESPONSE,
                            min_alpha: float = C.MIN_ALPHA,
                            max_alpha: float = C.MAX_ALPHA,
                            has_t_max: bool = True, aux_grads: bool = True,
                            sorted_passes: int = 0,
                            row_termination: bool = False, order=None):
    """B2: per-slot gradients [cap, 16] of the packed rows for the output
    cotangent `g_out`, given the forward's output `out` (the JAX package's
    _backward_windows, in slot layout). `aux_grads=False` drops the depth
    and transmittance cotangents (rows 4-5 of g_out are not read);
    `sorted_passes` and `row_termination` must be the forward's, `order`
    the walk record its B1 wrote (forward_order), if it wrote one. Launches
    the kernel for CUDA tensors; the plain version for CPU tensors."""
    args = (data_sorted, tile_starts, tile_ends, rays, out,
            g_out.contiguous(), degree, min_transmittance, min_response,
            min_alpha, max_alpha, has_t_max, aux_grads, sorted_passes,
            row_termination)
    with record_function("3dgut.bwd_composite"):
        if rays.device.type == "cpu":
            return tile_composite_backward_plain(*args)
        return _launch_backward(*args, order=order)


def forward_order(data_sorted, tile_starts, tile_ends, rays, sorted_passes,
                  needs_grad: bool):
    """The walk record a differentiable forward's B1 fills for its B2 (the
    compositing orders with sorted passes, the live-row masks without):
    only on the card, when a backward will run. The backward frees it once
    B2 has read it."""
    if not (needs_grad and rays.device.type != "cpu"):
        return None
    return order_buffer(tile_starts, tile_ends, data_sorted.shape[0],
                        walk_words(sorted_passes))


class _TileComposite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data_sorted, tile_starts, tile_ends, rays, degree,
                min_transmittance, min_response, min_alpha, max_alpha,
                has_t_max, aux_outputs, emit_flags, aux_grads, sorted_passes,
                row_termination):
        data_sorted, rays = data_sorted.detach(), rays.detach()
        args = (data_sorted, tile_starts, tile_ends, rays, degree,
                min_transmittance, min_response, min_alpha, max_alpha,
                has_t_max, aux_outputs, emit_flags, sorted_passes,
                row_termination)
        ctx.order = forward_order(data_sorted, tile_starts, tile_ends, rays,
                                  sorted_passes,
                                  ctx.needs_input_grad[0] and not emit_flags)
        if rays.device.type == "cpu":
            out, flags = tile_composite_plain(*args)
        else:
            out, flags = _launch(*args, order=ctx.order)
        if flags is None:
            flags = torch.zeros(0, dtype=torch.float32, device=rays.device)
        ctx.mark_non_differentiable(flags)
        ctx.save_for_backward(data_sorted, tile_starts, tile_ends, rays, out)
        ctx.args = (degree, min_transmittance, min_response, min_alpha,
                    max_alpha, has_t_max, aux_grads, sorted_passes,
                    row_termination)
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
                                         rays, out, g_out, *ctx.args,
                                         order=ctx.order)
        ctx.order = None    # B1's record is spent: free it
        return (g_data,) + (None,) * 14


def tile_composite(data_sorted, tile_starts, tile_ends, rays, degree: int,
                   min_transmittance: float,
                   min_response: float = C.MIN_KERNEL_RESPONSE,
                   min_alpha: float = C.MIN_ALPHA,
                   max_alpha: float = C.MAX_ALPHA, has_t_max: bool = True,
                   aux_outputs: bool = True, emit_flags: bool = False,
                   aux_grads: bool = True, sorted_passes: int = 0,
                   row_termination: bool = False):
    """B1 forward, differentiable in `data_sorted` through B2: returns
    (out, flags). `out` is the [num_tiles, 8, 256] output buffer (module
    docstring); `flags` is None unless `emit_flags`, then the per-slot max
    composite weight [cap] (> 0 iff the slot contributed to some pixel; that
    leg has no backward). Tile ranges must lie within [0, cap].
    `aux_grads=False` asserts the loss reads only rgb and opacity: the
    backward then drops the depth and transmittance cotangents. A
    differentiable call with `aux_outputs=False` needs `aux_grads=False`
    (the backward rebuilds its totals from the depth row).
    `sorted_passes` and `row_termination` select the sorted and the
    row-terminated legs (module docstring; row termination reads rays row
    7)."""
    check_passes(sorted_passes)
    if (not aux_outputs and aux_grads and torch.is_grad_enabled()
            and data_sorted.requires_grad):
        raise ValueError("aux_outputs=False requires aux_grads=False")
    out, flags = _TileComposite.apply(
        data_sorted, tile_starts, tile_ends, rays, degree,
        float(min_transmittance), float(min_response), float(min_alpha),
        float(max_alpha), bool(has_t_max), bool(aux_outputs),
        bool(emit_flags), bool(aux_grads), int(sorted_passes),
        bool(row_termination))
    return out, (flags if emit_flags else None)
