"""Kernel M1: mesh closest-hit (Moller-Trumbore, the least t of each ray
over the faces), the playground's mesh intersection. It replaces no TPU
kernel: threedgrut_tpu/playground/mesh.py intersect is XLA (a dense
[R, 4096] test per chunk of faces under lax.scan); see
csrc/mesh_intersect.cu for why it is a kernel here and how it culls.

`closest_hits` launches csrc/mesh_intersect.cu for CUDA tensors and runs
its plain version, `closest_hits_plain`, for CPU tensors. The plain version
is the function's definition: the brute force over every ray x face pair,
chunked over rays as well as faces so that its [rays, faces] temporaries
stay under PAIRS_PER_CHUNK pairs. It keeps the JAX function's tie-break
(the lowest face index of the least t) and its expressions, each a
separate tensor operation in JAX's order, which is what the kernel (built
with --fmad=false) computes too.

The kernel first culls, per block of BLOCK consecutive rays, the faces that
no ray of the block can hit (an interval evaluation of the pair test over
the block's boxes of origins and directions), then runs the exact test over
the survivors only. `block_face_masks_plain` is that cull in torch
operations, equal to the kernel's diagnostic entry (`block_face_masks` on
CUDA tensors) mask for mask; `block_cull_plain` also counts the cull's
work, for chip_smoke.py's bound; `closest_hits_culled_plain` models the
kernel's algorithm on the CPU. They serve the tests and chip_smoke.py; no
path calls them.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from threedgrut_torch.ops import cuda_build

FACE_CHUNK = 4096          # the JAX function's chunk of faces
# The plain version's pairs per step (16 MB a temporary).
PAIRS_PER_CHUNK = 1 << 22
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _I, _I, ctypes.c_float, _P, _P, _P, _P, _P]
_MASK_ARGS = [_P, _P, _P, _I, _I, ctypes.c_float, _P, _P]
BLOCK = 256                # rays a block of the kernel (its THREADS)


def triangles(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """[F, 9] f32 rows (p0, e1 = p1 - p0, e2 = p2 - p0), the test's
    per-face inputs as the JAX function computes them."""
    f = faces.to(torch.int64)
    p0 = vertices[f[:, 0]]
    return torch.cat([p0, vertices[f[:, 1]] - p0, vertices[f[:, 2]] - p0],
                     dim=1).contiguous()


def _pair_test(o, d, tri, t_min: float):
    """t (inf where the pair does not hit), u, w of rays [r, 3] x faces
    [f, 9], each [r, f]."""
    d0, d1, d2 = (d[:, k:k + 1] for k in range(3))
    o0, o1, o2 = (o[:, k:k + 1] for k in range(3))
    p0, p1, p2, a0, a1, a2, b0, b1, b2 = (tri[None, :, k] for k in range(9))
    h0 = d1 * b2 - d2 * b1
    h1 = d2 * b0 - d0 * b2
    h2 = d0 * b1 - d1 * b0
    a = a0 * h0 + a1 * h1 + a2 * h2
    nondegenerate = torch.abs(a) > 1e-9
    inv_a = 1.0 / torch.where(nondegenerate, a, torch.ones_like(a))
    s0, s1, s2 = o0 - p0, o1 - p1, o2 - p2
    u = (s0 * h0 + s1 * h1 + s2 * h2) * inv_a
    q0 = s1 * a2 - s2 * a1
    q1 = s2 * a0 - s0 * a2
    q2 = s0 * a1 - s1 * a0
    w = (d0 * q0 + d1 * q1 + d2 * q2) * inv_a
    t = (b0 * q0 + b1 * q1 + b2 * q2) * inv_a
    ok = (nondegenerate & (u >= 0) & (w >= 0) & (u + w <= 1)
          & (t > torch.tensor(t_min, dtype=torch.float32)))
    return torch.where(ok, t, torch.full_like(t, float("inf"))), u, w


def closest_hits_plain(rays_o, rays_d, tri, t_min: float = 1e-4):
    """Plain M1: (t [R] inf on a miss, face [R] int32 -1, u, w [R] 0)."""
    r, nf = rays_o.shape[0], tri.shape[0]
    dev = rays_o.device
    best_t = torch.full((r,), float("inf"), device=dev)
    best_face = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(r, device=dev)
    best_w = torch.zeros(r, device=dev)
    fc = min(FACE_CHUNK, max(nf, 1))
    rc = max(1, PAIRS_PER_CHUNK // fc)
    for r0 in range(0, r, rc):
        rs = slice(r0, min(r, r0 + rc))
        for f0 in range(0, nf, fc):
            t, u, w = _pair_test(rays_o[rs], rays_d[rs], tri[f0:f0 + fc],
                                 t_min)
            # argmin takes the first of equal minima; a strict `<` across
            # chunks keeps the earlier chunk's.
            tc, arg = torch.min(t, dim=1)
            better = tc < best_t[rs]
            best_t[rs] = torch.where(better, tc, best_t[rs])
            best_face[rs] = torch.where(better, (arg + f0).to(torch.int32),
                                        best_face[rs])
            best_u[rs] = torch.where(better, u.gather(1, arg[:, None])[:, 0],
                                     best_u[rs])
            best_w[rs] = torch.where(better, w.gather(1, arg[:, None])[:, 0],
                                     best_w[rs])
    return best_t, best_face, best_u, best_w


def _iv_add(x, y):
    return x[0] + y[0], x[1] + y[1]


def _iv_sub(x, y):
    return x[0] - y[1], x[1] - y[0]


def _iv_mul(x, y):
    """Interval product: the four corner products, each rounded; a NaN
    corner gives NaN ends (torch.minimum and maximum return it)."""
    p, q, r, s = x[0] * y[0], x[0] * y[1], x[1] * y[0], x[1] * y[1]
    return (torch.minimum(torch.minimum(p, q), torch.minimum(r, s)),
            torch.maximum(torch.maximum(p, q), torch.maximum(r, s)))


def _iv_mulc(x, c):
    p, q = x[0] * c, x[1] * c
    return torch.minimum(p, q), torch.maximum(p, q)


def _block_boxes(rays_o, rays_d, block: int):
    """Per block of `block` consecutive rays (the last one padded with
    rays of zero direction): (any live ray [B], a live ray with a
    non-finite component [B], origin box, direction box: each ([B, 3] lo,
    [B, 3] hi)) over the live rays (d != 0) that are finite."""
    r = rays_o.shape[0]
    nb = -(-r // block)
    pad = (0, 0, 0, nb * block - r)
    o = torch.nn.functional.pad(rays_o, pad).reshape(nb, block, 3)
    d = torch.nn.functional.pad(rays_d, pad).reshape(nb, block, 3)
    live = (d != 0).any(-1)
    finite = torch.isfinite(o).all(-1) & torch.isfinite(d).all(-1)
    good = (live & finite)[..., None]
    inf = torch.tensor(float("inf"), device=o.device)

    def box(x):
        return (torch.where(good, x, inf).amin(1),
                torch.where(good, x, -inf).amax(1))
    return live.any(1), (live & ~finite).any(1), box(o), box(d)


def block_cull_plain(rays_o, rays_d, tri, t_min: float = 1e-4,
                     block: int = BLOCK):
    """The kernel's cull and the work it does: (masks [ceil(R / block), F]
    bool, the faces each block of `block` consecutive rays keeps; culled
    [B] bool, the blocks that run the cull, those with a live ray and no
    live non-finite one; full [B] int64, the faces of each culled block
    whose interval of a keeps one sign beyond 1e-9, so that the cull goes
    on past the a tests to the u, w and t rules).

    A face is dropped only where the pair test's expressions
    (`_pair_test`'s, in its order), evaluated on the intervals of the
    block's live rays' origins and directions with each end rounded to
    nearest, prove that every ray fails it: |a| <= 1e-9 throughout, or,
    where a keeps one sign beyond 1e-9, hi(u) < 0, hi(w) < 0, lo(u) +
    lo(w) > 1 or hi(t) <= t_min. Each comparison is false on a NaN end,
    which keeps the face. A block with no live ray keeps no face; one with
    a live non-finite ray keeps every face."""
    any_live, keep_all, (olo, ohi), (dlo, dhi) = _block_boxes(
        rays_o, rays_d, block)
    nf = tri.shape[0]
    eps = torch.tensor(1e-9, dtype=torch.float32)
    tm = torch.tensor(t_min, dtype=torch.float32)
    culled = any_live & ~keep_all
    out = torch.zeros((any_live.shape[0], nf), dtype=torch.bool,
                      device=rays_o.device)
    full = torch.zeros(any_live.shape[0], dtype=torch.int64,
                       device=rays_o.device)
    o = [(olo[:, k:k + 1], ohi[:, k:k + 1]) for k in range(3)]
    d = [(dlo[:, k:k + 1], dhi[:, k:k + 1]) for k in range(3)]
    for f0 in range(0, nf, FACE_CHUNK):
        p0, p1, p2, a0, a1, a2, b0, b1, b2 = (
            tri[None, f0:f0 + FACE_CHUNK, k] for k in range(9))
        h0 = _iv_sub(_iv_mulc(d[1], b2), _iv_mulc(d[2], b1))
        h1 = _iv_sub(_iv_mulc(d[2], b0), _iv_mulc(d[0], b2))
        h2 = _iv_sub(_iv_mulc(d[0], b1), _iv_mulc(d[1], b0))
        a = _iv_add(_iv_add(_iv_mulc(h0, a0), _iv_mulc(h1, a1)),
                    _iv_mulc(h2, a2))
        degenerate = (a[0] >= -eps) & (a[1] <= eps)
        one_sign = (a[0] > eps) | (a[1] < -eps)
        inv_a = (1.0 / a[1], 1.0 / a[0])
        s0 = (o[0][0] - p0, o[0][1] - p0)
        s1 = (o[1][0] - p1, o[1][1] - p1)
        s2 = (o[2][0] - p2, o[2][1] - p2)
        u = _iv_mul(_iv_add(_iv_add(_iv_mul(s0, h0), _iv_mul(s1, h1)),
                            _iv_mul(s2, h2)), inv_a)
        q0 = _iv_sub(_iv_mulc(s1, a2), _iv_mulc(s2, a1))
        q1 = _iv_sub(_iv_mulc(s2, a0), _iv_mulc(s0, a2))
        q2 = _iv_sub(_iv_mulc(s0, a1), _iv_mulc(s1, a0))
        w = _iv_mul(_iv_add(_iv_add(_iv_mul(d[0], q0), _iv_mul(d[1], q1)),
                            _iv_mul(d[2], q2)), inv_a)
        t = _iv_mul(_iv_add(_iv_add(_iv_mulc(q0, b0), _iv_mulc(q1, b1)),
                            _iv_mulc(q2, b2)), inv_a)
        fails = ((u[1] < 0) | (w[1] < 0) | (u[0] + w[0] > 1)
                 | (t[1] <= tm))
        keep = ~degenerate & ~(one_sign & fails)
        out[:, f0:f0 + FACE_CHUNK] = (keep | keep_all[:, None]) \
            & any_live[:, None]
        # The kernel's `face_survives` leaves at the a tests unless a keeps
        # one sign.
        full += (one_sign & culled[:, None]).sum(1)
    return out, culled, full


def block_face_masks_plain(rays_o, rays_d, tri, t_min: float = 1e-4,
                           block: int = BLOCK) -> torch.Tensor:
    """The kernel's cull: [ceil(R / block), F] bool, the faces each block
    of `block` consecutive rays keeps (block_cull_plain's masks)."""
    return block_cull_plain(rays_o, rays_d, tri, t_min, block)[0]


def closest_hits_culled_plain(rays_o, rays_d, tri, t_min: float = 1e-4,
                              block: int = BLOCK):
    """The kernel's algorithm on the CPU, for the tests: each block of
    `block` rays runs the exact pair test over the faces it keeps
    (block_face_masks_plain), in ascending order, the first of equal least
    t winning. Equal to closest_hits_plain bit for bit wherever the cull
    keeps every face that a ray of the block hits."""
    masks = block_face_masks_plain(rays_o, rays_d, tri, t_min, block)
    r = rays_o.shape[0]
    dev = rays_o.device
    best_t = torch.full((r,), float("inf"), device=dev)
    best_face = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(r, device=dev)
    best_w = torch.zeros(r, device=dev)
    for b in range(masks.shape[0]):
        faces = torch.nonzero(masks[b]).squeeze(1)
        if not faces.numel():
            continue
        rs = slice(b * block, min(r, (b + 1) * block))
        t, u, w = _pair_test(rays_o[rs], rays_d[rs], tri[faces], t_min)
        tc, arg = torch.min(t, dim=1)
        hit = tc < float("inf")
        best_t[rs] = torch.where(hit, tc, best_t[rs])
        best_face[rs] = torch.where(hit, faces[arg].to(torch.int32),
                                    best_face[rs])
        best_u[rs] = torch.where(hit, u.gather(1, arg[:, None])[:, 0],
                                 best_u[rs])
        best_w[rs] = torch.where(hit, w.gather(1, arg[:, None])[:, 0],
                                 best_w[rs])
    return best_t, best_face, best_u, best_w


def _checked(rays_o, rays_d, tri):
    r, nf = rays_o.shape[0], tri.shape[0]
    cuda_build.checked_inputs(
        ("rays_o", rays_o, torch.float32, (r, 3)),
        ("rays_d", rays_d, torch.float32, (r, 3)),
        ("tri", tri, torch.float32, (nf, 9)))
    cuda_build.check_aligned(("tri", tri, 16))
    return r, nf


def block_face_masks(rays_o: torch.Tensor, rays_d: torch.Tensor,
                     tri: torch.Tensor, t_min: float = 1e-4
                     ) -> torch.Tensor:
    """The faces each block of BLOCK rays keeps in M1's cull, [ceil(R /
    BLOCK), F] bool: the kernel's diagnostic entry (steps 1-3, counted as
    `mesh_intersect_masks`) for CUDA tensors, block_face_masks_plain for
    CPU tensors. For the tests and chip_smoke.py."""
    if rays_o.device.type == "cpu":
        return block_face_masks_plain(rays_o, rays_d, tri, t_min)
    r, nf = _checked(rays_o, rays_d, tri)
    mask = torch.zeros((-(-r // BLOCK), nf), dtype=torch.uint8,
                       device=rays_o.device)
    lib = cuda_build.library("mesh_intersect_masks", _MASK_ARGS)
    stream = torch.cuda.current_stream(rays_o.device).cuda_stream
    cuda_build.launches["mesh_intersect_masks"] += 1
    cuda_build.check("mesh_intersect_masks", lib.mesh_intersect_masks(
        rays_o.data_ptr(), rays_d.data_ptr(), tri.data_ptr(), r, nf,
        float(t_min), mask.data_ptr(), stream))
    return mask.view(torch.bool)


def closest_hits(rays_o: torch.Tensor, rays_d: torch.Tensor,
                 tri: torch.Tensor, t_min: float = 1e-4
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """M1. rays_o, rays_d [R, 3] f32, tri [F, 9] f32 (`triangles`).
    Returns (t [R] f32, inf on a miss; face [R] int32, -1 on a miss; u, w
    [R] f32, the barycentrics of the hit, 0 on a miss). A ray hits a face
    where a != 0 (|a| > 1e-9), u >= 0, w >= 0, u + w <= 1 and t > t_min;
    of equal least t the lowest face index wins."""
    if rays_o.device.type == "cpu":
        return closest_hits_plain(rays_o, rays_d, tri, t_min)
    r, nf = _checked(rays_o, rays_d, tri)
    dev = rays_o.device
    out_t = torch.empty(r, device=dev)
    out_face = torch.empty(r, dtype=torch.int32, device=dev)
    out_u = torch.empty(r, device=dev)
    out_w = torch.empty(r, device=dev)
    lib = cuda_build.library("mesh_intersect", _ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.launches["mesh_intersect"] += 1
    cuda_build.check("mesh_intersect", lib.mesh_intersect(
        rays_o.data_ptr(), rays_d.data_ptr(), tri.data_ptr(), r, nf,
        float(t_min), out_t.data_ptr(), out_face.data_ptr(),
        out_u.data_ptr(), out_w.data_ptr(), stream))
    return out_t, out_face, out_u, out_w
