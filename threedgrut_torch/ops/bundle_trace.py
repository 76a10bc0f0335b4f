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
torch.autograd.Function whose backward is kernel B8
(csrc/bundle_trace_bwd.cu; plain version `bundle_composite_backward_plain`):
per-slot gradients [capF, 64] of the candidate rows (A 9, mean 3, opacity,
3 zeros, 48 SH), exactly 0 on windows the forward's walk never reached. No
gradient flows to the rays or the window ranges. With sorted passes on the
card, the differentiable forwards (`_BundleComposite`, and
fused_raster.composite_bundles) have B7 write each live ray-window's
compositing order into `order_buffer` (words [capF / 128, 32, 256]: a row
index per byte, its top bit HIT set where the sorted key is < 3.4e38),
and B8 re-walks it without a network; B8 called without orders runs B7
first to write them. Traces and evaluation (no gradient) write none. The
plain versions take the same buffer (`order`), for the tests.

Backward, per (ray, counted pair j) with q_j = colour . dC + hit_t dD + dO:
the suffix sum_{k after j} w_k q_k, taken in the ray's compositing order (the
re-sorted one), is the residual a_tot - prefix_j with a_tot rebuilt from the
forward's rows 0-4; then
  d_alpha = T_before q_j - (suffix + dT t_final) / max(1 - alpha, 1e-6)
chains through alpha = min(opacity resp(g), max_alpha) (gated on
alpha_raw < max_alpha), g = |v x u|^2 / |v|^2 and hit_t = |v.u| / |v|^2 to
du, dv (the exact cross form), and dA[r][k] = du_r (o - mean)_k + dv_r d_k,
dmean_k = -sum_r A[r][k] du_r, dopacity = resp d_alpha, and the SH rows
basis_k w dC_c [raw colour_c > 0]; each summed over the bundle's rays.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.profiler import record_function

from threedgrut_torch import constants as C
from threedgrut_torch.ops import cuda_build
from threedgrut_torch.ops.tile_raster import (_passes_run, _response_grad,
                                              _tile_pairs, oddeven_passes)

CHUNK = 128          # rows per window: the flat layout's and re-sort's unit
ROW64 = 64           # packed floats per candidate row
PIX = 256            # rays per bundle
BIG = 3.4e38         # sort key of a row that composites nothing
HIT = 0x80           # an order byte's hit bit: the sorted key is < BIG

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


def _window_weights(S, rays, carry, degree, min_transmittance,
                    min_response, min_alpha, max_alpha, sorted_passes,
                    order_rows=None, activity=None):
    """Compositing weights of one window of B bundles: S [B, CHUNK, 64],
    rays [B, 8, PIX], carry [B, PIX]. Returns (pair quantities, alpha,
    1 - alpha, T_before, live, w), each [B, CHUNK, PIX] in row order, the
    row index at each compositing position (None without passes) and the
    sorted keys (None without passes or with `order_rows`). `order_rows`
    [B, CHUNK, PIX] gives that row index instead of the network (the
    compositing orders a forward wrote); a list `activity` gets the
    network's per-pass swap flags (oddeven_passes)."""
    q = _tile_pairs(S, rays, degree, min_response, min_alpha, max_alpha,
                    True)
    gates = (q["vdotu"] < 0.0) & (q["g"] <= C.MAX_PARTICLE_SQ_DISTANCE)
    alpha = torch.where(gates, q["alpha"], torch.zeros_like(q["alpha"]))
    one_m = 1.0 - alpha
    key_s = None
    if sorted_passes and order_rows is not None:
        pos_s = order_rows
        om_s = torch.gather(one_m, 1, pos_s)
    elif sorted_passes:
        key = torch.where(alpha > 0.0, q["hit_t"],
                          torch.full_like(alpha, BIG))
        pos = torch.arange(CHUNK, device=S.device)[None, :, None].expand(
            alpha.shape)
        key_s, (om_s, pos_s) = oddeven_passes(key, [one_m, pos],
                                              sorted_passes, activity)
    else:
        om_s, pos_s = one_m, None
    incl = torch.cumprod(om_s, dim=1)
    excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
    if pos_s is not None:
        excl = torch.empty_like(excl).scatter_(1, pos_s, excl)
    t_before = carry[:, None, :] * excl
    live = t_before > min_transmittance
    w = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
    return q, alpha, one_m, t_before, live, w, pos_s, key_s


def order_words(key_s, pos_s):
    """The compositing orders of a window in B7's layout: int32 words [B,
    CHUNK // 4, PIX] from the sorted keys and the row at each position
    ([B, CHUNK, PIX]); byte k & 3 of word k >> 2 is position k's row, its
    top bit (HIT) set where the sorted key is < BIG."""
    byte = pos_s.to(torch.int64) | torch.where(
        key_s < BIG, HIT, 0).to(torch.int64)
    b = byte.reshape(byte.shape[0], CHUNK // 4, 4, byte.shape[-1])
    word = (b[:, :, 0] | b[:, :, 1] << 8 | b[:, :, 2] << 16
            | b[:, :, 3] << 24)
    return torch.where(word >= 1 << 31, word - (1 << 32), word).to(
        torch.int32)


def order_bytes(words):
    """The bytes [B, CHUNK, PIX] (int64) of order words [B, CHUNK // 4,
    PIX]: row index | HIT at each compositing position."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    b = torch.stack([(w >> (8 * i)) & 0xFF for i in range(4)], dim=2)
    return b.reshape(w.shape[0], CHUNK, w.shape[-1])


def _raw_colours(S, basis):
    """Per-(row, ray) SH colour before its clamp, coeffs . basis + 0.5,
    for red, green and blue: 3 x [B, CHUNK, PIX]."""
    return [torch.matmul(S[..., 16 + 16 * c:32 + 16 * c], basis) + 0.5
            for c in range(3)]


def _next_carry(live, t_before, one_m, carry):
    t_after = torch.where(live, t_before * one_m,
                          torch.full_like(t_before, BIG))
    return torch.minimum(t_after.amin(1), carry)


def _window(S, rays, basis, carry, degree, min_transmittance, min_response,
            min_alpha, max_alpha, sorted_passes, stats):
    """One window of B bundles: S [B, CHUNK, 64], rays [B, 8, PIX], basis
    [B, 16, PIX], carry [B, PIX]. Returns the window's sums [B, 5, PIX]
    (rgb, opacity, depth), hits [B, PIX], the new carry and the window's
    compositing orders (order_words; None without passes)."""
    activity = [] if stats is not None and sorted_passes else None
    q, alpha, one_m, t_before, live, w, pos_s, key_s = _window_weights(
        S, rays, carry, degree, min_transmittance, min_response, min_alpha,
        max_alpha, sorted_passes, activity=activity)
    if stats is not None:
        alive = carry > min_transmittance
        # A ray's hits out of row order: a hit nearer than an earlier one.
        before = torch.where(alpha > 0.0, q["hit_t"],
                             torch.full_like(alpha, -BIG)).cummax(1).values
        inverted = ((alpha[:, 1:] > 0.0)
                    & (q["hit_t"][:, 1:] < before[:, :-1])).any(1)
        stats["live_ray_windows"] += int(alive.sum())
        stats["inverted_ray_windows"] += int((inverted & alive).sum())
        stats["live_pairs"] += int(live.sum())
        stats["live_hits"] += int((live & (alpha > 0.0)
                                   & (q["hit_t"] < BIG)).sum())
        if activity is not None:
            run = _passes_run(activity, sorted_passes)
            stats["network_passes"] += int(run[alive].sum())
    sums = [torch.sum(w * torch.clamp(col, min=0.0), dim=1)
            for col in _raw_colours(S, basis)]
    sums += [w.sum(1), (w * q["hit_t"]).sum(1)]
    hits = (w > 0.0).sum(1).to(w.dtype)
    words = None if key_s is None else order_words(key_s, pos_s)
    return (torch.stack(sums, dim=1), hits,
            _next_carry(live, t_before, one_m, carry), words)


def bundle_composite_plain(data, rays, win_starts, win_ends, degree: int,
                           sh_degree: int, min_transmittance: float,
                           min_response: float = C.MIN_KERNEL_RESPONSE,
                           min_alpha: float = C.MIN_ALPHA,
                           max_alpha: float = C.MAX_ALPHA,
                           sorted_passes: int = 0,
                           stats: Optional[dict] = None,
                           order: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain version of B7: a loop over window index, each step taking the
    next window of every bundle still walking, vectorised across them.
    With a `stats` dict, also counts the work the data asks for: windows x
    rays alive at their start ("live_ray_windows"), of those the ones
    whose hits are out of row order ("inverted_ray_windows"), the passes
    the kernel's network runs on them ("network_passes": it stops after an
    odd and an even pass in a row that swap nothing), the (ray, row) pairs
    with T_before > min_transmittance ("live_pairs", where a walk in
    compositing order has not stopped) and of those the hits, sorted key
    below BIG ("live_hits": the pairs B8 evaluates on the orders). With
    sorted passes, `order` (order_buffer) receives the compositing order
    of every ray of every walked window, as the kernel writes it for its
    live rays."""
    if stats is not None:
        stats.update(live_ray_windows=0, inverted_ray_windows=0,
                     network_passes=0, live_pairs=0, live_hits=0)
    if order is not None:
        _check_order_plain(order, data, sorted_passes)
    nb = rays.shape[0]
    dev = rays.device
    windows = data.reshape(-1, CHUNK, ROW64)
    nw = windows.shape[0]
    ws = torch.clamp(win_starts.long(), 0, nw)
    we = torch.clamp(win_ends.long(), 0, nw)
    out = torch.zeros((nb, 8, PIX), dtype=data.dtype, device=dev)
    carry = rays[:, 7].clone()
    basis = sh_basis_rows(rays, sh_degree)
    walking = we > ws
    k = 0
    while True:
        b = torch.nonzero(walking & (ws + k < we)).reshape(-1)
        if b.numel() == 0:
            break
        sums, hits, cb, words = _window(
            windows[ws[b] + k], rays[b], basis[b], carry[b], degree,
            min_transmittance, min_response, min_alpha, max_alpha,
            sorted_passes, stats)
        if order is not None:
            order[ws[b] + k] = words
        out[b, 0:5] += sums
        out[b, 6] += hits
        out[b, 7] += 1.0
        carry[b] = cb
        walking[b] = (cb > min_transmittance).any(1)
        k += 1
    out[:, 5] = carry
    return out


def _window_backward(S, rays, basis, carry, prefix, a_tot, go, t_final,
                     degree, min_transmittance, min_response, min_alpha,
                     max_alpha, sorted_passes, words=None):
    """The backward of one window of B bundles (module docstring): S [B,
    CHUNK, 64], rays and the output cotangent go [B, 8, PIX], basis [B, 16,
    PIX], carry, prefix (the sum of w q over the earlier windows), a_tot
    and t_final [B, PIX], and with sorted passes optionally the window's
    compositing orders `words` [B, CHUNK // 4, PIX] (read for the rays
    alive at its start; the network runs where they are None). Returns the
    window's per-slot gradients [B, CHUNK, 64], the new carry and the new
    prefix."""
    order_rows = None
    if sorted_passes and words is not None:
        ident = torch.arange(CHUNK, device=S.device)[None, :, None]
        order_rows = torch.where((carry > min_transmittance)[:, None, :],
                                 order_bytes(words) & (HIT - 1), ident)
    q, alpha, one_m, t_before, live, w, pos_s, _ = _window_weights(
        S, rays, carry, degree, min_transmittance, min_response, min_alpha,
        max_alpha, sorted_passes, order_rows)
    zero = torch.zeros_like(w)
    dC = [go[:, c, None, :] for c in range(3)]
    dO, dD, dT = go[:, 3, None, :], go[:, 4, None, :], go[:, 5, None, :]
    cols = _raw_colours(S, basis)
    qj = (torch.clamp(cols[0], min=0.0) * dC[0]
          + torch.clamp(cols[1], min=0.0) * dC[1]
          + torch.clamp(cols[2], min=0.0) * dC[2] + q["hit_t"] * dD + dO)
    wq = w * qj
    rest = (a_tot - prefix)[:, None, :]
    if pos_s is not None:
        # The suffix runs in the ray's compositing order: prefix sums there,
        # mapped back to row order.
        incl_s = torch.cumsum(torch.gather(wq, 1, pos_s), dim=1)
        suffix = torch.empty_like(wq).scatter_(1, pos_s, rest - incl_s)
    else:
        suffix = rest - torch.cumsum(wq, dim=1)
    inv_one_m = 1.0 / torch.clamp(one_m, min=1e-6)
    counted = w > 0.0
    d_alpha = torch.where(
        counted,
        t_before * qj - suffix * inv_one_m - dT * t_final[:, None, :]
        * inv_one_m, zero)
    unclamped = (q["alpha_raw"] < max_alpha) & counted
    d_resp = torch.where(unclamped, S[..., 12:13] * d_alpha, zero)
    d_opa = torch.where(unclamped, q["resp"] * d_alpha, zero)
    d_g = d_resp * _response_grad(q["g"], q["resp"], degree)
    d_hit = torch.where(counted, w * dD, zero)
    inv_vsq = q["inv_vsq"]
    d_m = torch.sign(q["vdotu"]) * inv_vsq * d_hit
    d_crsq = d_g * inv_vsq
    d_vsq = (-q["g"] * inv_vsq) * d_g + (-q["hit_t"] * inv_vsq) * d_hit
    u, v, cr, w0 = q["u"], q["v"], q["cr"], q["w0"]
    crxv = [cr[1] * v[2] - cr[2] * v[1], cr[2] * v[0] - cr[0] * v[2],
            cr[0] * v[1] - cr[1] * v[0]]
    uxcr = [u[1] * cr[2] - u[2] * cr[1], u[2] * cr[0] - u[0] * cr[2],
            u[0] * cr[1] - u[1] * cr[0]]
    du = [2.0 * d_crsq * crxv[i] + d_m * v[i] for i in range(3)]
    dv = [2.0 * d_crsq * uxcr[i] + d_m * u[i] + 2.0 * d_vsq * v[i]
          for i in range(3)]
    d = [rays[:, 3 + k, None, :] for k in range(3)]
    rows = [(du[r] * w0[k] + dv[r] * d[k]).sum(-1)
            for r in range(3) for k in range(3)]
    su = [x.sum(-1) for x in du]
    rows += [-(S[..., k] * su[0] + S[..., 3 + k] * su[1]
               + S[..., 6 + k] * su[2]) for k in range(3)]
    rows.append(d_opa.sum(-1))
    G = torch.stack(rows, dim=-1)                              # [B, CHUNK, 13]
    gsh = [torch.matmul(torch.where(cols[c] > 0.0, w * dC[c], zero),
                        basis.transpose(1, 2)) for c in range(3)]
    G = torch.cat([G, torch.zeros_like(G[..., :3])] + gsh, dim=-1)
    return (G, _next_carry(live, t_before, one_m, carry),
            prefix + wq.sum(1))


def bundle_composite_backward_plain(
        data, rays, win_starts, win_ends, out, g_out, degree: int,
        sh_degree: int, min_transmittance: float,
        min_response: float = C.MIN_KERNEL_RESPONSE,
        min_alpha: float = C.MIN_ALPHA, max_alpha: float = C.MAX_ALPHA,
        sorted_passes: int = 0,
        order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of B8: per-slot gradients [capF, 64] of the candidate
    rows for the output cotangent g_out [nb, 8, 256] (rows 6-7 unread),
    given the forward's output `out`. The forward's loop over window index,
    vectorised across the bundles still walking; windows no walk reached
    stay exactly 0. With sorted passes and `order` (the compositing orders
    the forward wrote), each ray re-walks its order instead of sorting."""
    if order is not None:
        _check_order_plain(order, data, sorted_passes)
    nb = rays.shape[0]
    windows = data.reshape(-1, CHUNK, ROW64)
    nw = windows.shape[0]
    grad = torch.zeros_like(windows)
    ws = torch.clamp(win_starts.long(), 0, nw)
    we = torch.clamp(win_ends.long(), 0, nw)
    carry = rays[:, 7].clone()
    prefix = torch.zeros_like(carry)
    basis = sh_basis_rows(rays, sh_degree)
    a_tot = (out[:, 0] * g_out[:, 0] + out[:, 1] * g_out[:, 1]
             + out[:, 2] * g_out[:, 2] + out[:, 3] * g_out[:, 3]
             + out[:, 4] * g_out[:, 4])
    walking = we > ws
    k = 0
    while True:
        b = torch.nonzero(walking & (ws + k < we)).reshape(-1)
        if b.numel() == 0:
            break
        G, cb, pb = _window_backward(
            windows[ws[b] + k], rays[b], basis[b], carry[b], prefix[b],
            a_tot[b], g_out[b], out[b, 5], degree, min_transmittance,
            min_response, min_alpha, max_alpha, sorted_passes,
            None if order is None else order[ws[b] + k])
        grad[ws[b] + k] = G
        carry[b], prefix[b] = cb, pb
        walking[b] = (cb > min_transmittance).any(1)
        k += 1
    return grad.reshape(-1, ROW64)


def _check_launch(data, rays, win_starts, win_ends, degree, sh_degree,
                  sorted_passes, **bundle_buffers):
    """Validate a compositor launch's inputs (and any further [nb, 8, 256]
    f32 buffers) before their pointers go to C."""
    nb = rays.shape[0]
    cap = data.shape[0]
    cuda_build.checked_inputs(
        ("rays", rays, torch.float32, (nb, 8, PIX)),
        ("data", data, torch.float32, (cap, ROW64)),
        ("win_starts", win_starts, torch.int32, (nb,)),
        ("win_ends", win_ends, torch.int32, (nb,)),
        *[(k, v, torch.float32, (nb, 8, PIX))
          for k, v in bundle_buffers.items()])
    if cap % CHUNK:
        raise ValueError(f"the candidate rows must be a multiple of {CHUNK} "
                         f"(the kernel loads whole windows), got {cap}")
    if degree not in C.GG_SCALE:
        raise ValueError(f"unsupported kernel degree {degree}")
    if not 0 <= sh_degree <= 3:
        raise ValueError(f"unsupported SH degree {sh_degree}")
    if sorted_passes < 0:
        raise ValueError(f"sorted_passes must be >= 0, got {sorted_passes}")


def order_buffer(data: torch.Tensor) -> torch.Tensor:
    """Room for the compositing orders that B7 writes and B8 re-walks: int32
    words [capF // CHUNK, CHUNK // 4, PIX], absolute window g at [g]. Each
    window belongs to one bundle (grt._segments), so no bundle offsets and
    no host sync: 32 KB per window."""
    return torch.empty((data.shape[0] // CHUNK, CHUNK // 4, PIX),
                       dtype=torch.int32, device=data.device)


def forward_order(data, rays, sorted_passes: int, needs_grad: bool):
    """The order buffer a differentiable forward's B7 fills for its B8:
    only on the card, with sorted passes, when a backward will run."""
    if not (needs_grad and sorted_passes and rays.device.type != "cpu"):
        return None
    return order_buffer(data)


def _order_shape(data):
    return (data.shape[0] // CHUNK, CHUNK // 4, PIX)


def _check_order_plain(order, data, sorted_passes):
    if not sorted_passes:
        raise ValueError("compositing orders exist only with sorted passes")
    if order.dtype != torch.int32 or tuple(order.shape) != _order_shape(data):
        raise ValueError(f"order must be int32 of shape {_order_shape(data)}, "
                         f"got {order.dtype} {tuple(order.shape)}")


def _check_order(order, data):
    """An order buffer for the kernels: int32 of data's window count, on
    data's device, contiguous."""
    cuda_build.checked_inputs(
        ("data", data, torch.float32, (data.shape[0], ROW64)),
        ("order", order, torch.int32, _order_shape(data)))


def dynamic_smem(sorted_passes: int) -> int:
    """Bytes of dynamic shared memory a launch of B7 with `sorted_passes`
    takes (csrc/bundle_trace_fwd.cu): the sorted leg's per-ray columns, 0
    without passes."""
    fn = getattr(cuda_build.library("bundle_trace_fwd", _FWD_ARGS),
                 "bundle_trace_fwd_smem")
    fn.argtypes, fn.restype = [_I], _I
    return int(fn(int(sorted_passes)))


_FWD_ARGS = [_P] * 6 + [_I] * 4 + [_F] * 4 + [_I, _P]
_BWD_ARGS = [_P] * 10 + [_I] * 5 + [_F] * 4 + [_I, _P]


def _launch(data, rays, win_starts, win_ends, degree, sh_degree,
            min_transmittance, min_response, min_alpha, max_alpha,
            sorted_passes, order=None):
    """B7. With sorted passes, `order` (order_buffer) receives each live
    ray-window's compositing order for B8; a launch without passes cannot
    write one and refuses it."""
    nb = rays.shape[0]
    cap = data.shape[0]
    _check_launch(data, rays, win_starts, win_ends, degree, sh_degree,
                  sorted_passes)
    if order is not None:
        if not sorted_passes:
            raise ValueError("B7 writes compositing orders only with sorted "
                             "passes")
        _check_order(order, data)
    out = torch.empty((nb, 8, PIX), dtype=torch.float32, device=rays.device)
    lib = cuda_build.library("bundle_trace_fwd", _FWD_ARGS)
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    cuda_build.launches["bundle_trace_fwd"] += 1
    cuda_build.check("bundle_trace_fwd", lib.bundle_trace_fwd(
        data.data_ptr(), win_starts.data_ptr(), win_ends.data_ptr(),
        rays.data_ptr(), out.data_ptr(),
        None if order is None else order.data_ptr(), nb, cap // CHUNK,
        degree, sh_degree, min_transmittance, min_response, min_alpha,
        max_alpha, int(sorted_passes), stream))
    return out


def backward_slots(num_bundles: int, sorted_passes: int) -> int:
    """Blocks of a B8 launch: as many as the card holds at once (at most
    one per bundle), each with its own 256 KB slot of the scratch."""
    fn = getattr(cuda_build.library("bundle_trace_bwd", _BWD_ARGS),
                 "bundle_trace_bwd_slots")
    fn.argtypes, fn.restype = [_I, _I], _I
    slots = int(fn(int(num_bundles), int(sorted_passes)))
    if slots <= 0:
        raise RuntimeError(f"CUDA kernel bundle_trace_bwd: occupancy query "
                           f"failed (cudaError {-slots})")
    return slots


def _launch_backward(data, rays, win_starts, win_ends, out, g_out, degree,
                     sh_degree, min_transmittance, min_response, min_alpha,
                     max_alpha, sorted_passes, order=None):
    """B8. With sorted passes it re-walks the compositing orders that B7
    wrote into `order` for this forward; without them, B7 runs first to
    write them. Without passes it walks rows in order and reads no
    `order`."""
    nb = rays.shape[0]
    cap = data.shape[0]
    _check_launch(data, rays, win_starts, win_ends, degree, sh_degree,
                  sorted_passes, out=out, g_out=g_out)
    if sorted_passes and order is None:
        order = order_buffer(data)
        _launch(data, rays, win_starts, win_ends, degree, sh_degree,
                min_transmittance, min_response, min_alpha, max_alpha,
                sorted_passes, order)
    if sorted_passes:
        _check_order(order, data)
    dev = rays.device
    # Zeroed: windows the walk never reaches keep an exact 0.
    grad = torch.zeros((cap, ROW64), dtype=torch.float32, device=dev)
    slots = backward_slots(nb, sorted_passes)
    scratch = torch.empty((slots, CHUNK, PIX, 2), dtype=torch.float32,
                          device=dev)
    next_bundle = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = cuda_build.library("bundle_trace_bwd", _BWD_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.launches["bundle_trace_bwd"] += 1
    cuda_build.check("bundle_trace_bwd", lib.bundle_trace_bwd(
        data.data_ptr(), win_starts.data_ptr(), win_ends.data_ptr(),
        rays.data_ptr(), out.data_ptr(), g_out.data_ptr(),
        order.data_ptr() if sorted_passes else None, scratch.data_ptr(),
        next_bundle.data_ptr(), grad.data_ptr(), nb, slots, cap // CHUNK,
        degree, sh_degree, min_transmittance, min_response, min_alpha,
        max_alpha, int(sorted_passes), stream))
    return grad


def bundle_composite_backward(data, rays, win_starts, win_ends, out, g_out,
                              degree: int, sh_degree: int,
                              min_transmittance: float,
                              min_response: float = C.MIN_KERNEL_RESPONSE,
                              min_alpha: float = C.MIN_ALPHA,
                              max_alpha: float = C.MAX_ALPHA,
                              sorted_passes: int = 0,
                              order: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """B8: per-slot gradients [capF, 64] of the candidate rows for the
    output cotangent `g_out`, given the forward's output `out` (the JAX
    package's _backward_windows, in row layout); `order` the compositing
    orders the forward's B7 wrote, if it wrote them. Launches the kernel
    for CUDA tensors; the plain version for CPU tensors."""
    fn = (bundle_composite_backward_plain if rays.device.type == "cpu"
          else _launch_backward)
    with record_function("3dgrt.bwd_kernel"):
        return fn(data, rays, win_starts, win_ends, out, g_out.contiguous(),
                  degree, sh_degree, min_transmittance, min_response,
                  min_alpha, max_alpha, sorted_passes, order=order)


def composite_fn(device: torch.device):
    """B7's entry for tensors on `device`: the kernel, or on the CPU its
    plain version."""
    return bundle_composite_plain if device.type == "cpu" else _launch


class _BundleComposite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, rays, win_starts, win_ends, *args):
        data, rays = data.detach(), rays.detach()
        ctx.order = forward_order(data, rays, args[-1],
                                  ctx.needs_input_grad[0])
        out = composite_fn(rays.device)(data, rays, win_starts, win_ends,
                                        *args, order=ctx.order)
        ctx.save_for_backward(data, rays, win_starts, win_ends, out)
        ctx.args = args
        return out

    @staticmethod
    def backward(ctx, g_out):
        data, rays, win_starts, win_ends, out = ctx.saved_tensors
        g_data = bundle_composite_backward(data, rays, win_starts, win_ends,
                                           out, g_out, *ctx.args,
                                           order=ctx.order)
        ctx.order = None    # spent: freed before the gather's backward
        return (g_data,) + (None,) * (3 + len(ctx.args))


def bundle_composite(data, rays, win_starts, win_ends, degree: int,
                     sh_degree: int, min_transmittance: float,
                     min_response: float = C.MIN_KERNEL_RESPONSE,
                     min_alpha: float = C.MIN_ALPHA,
                     max_alpha: float = C.MAX_ALPHA,
                     sorted_passes: int = 0) -> torch.Tensor:
    """B7: the [nb, 8, 256] output buffer (module docstring) of the flat
    candidate rows `data` [capF, 64] for the bundles of `rays`, each
    walking its window range, differentiable in `data` through B8 (with
    sorted passes on the card, B7 writes the compositing orders that B8
    re-walks). Launches the kernels for CUDA tensors, the plain versions
    for CPU tensors."""
    return _BundleComposite.apply(
        data, rays, win_starts, win_ends, int(degree), int(sh_degree),
        float(min_transmittance), float(min_response), float(min_alpha),
        float(max_alpha), int(sorted_passes))
