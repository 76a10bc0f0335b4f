"""Kernel M1: mesh closest-hit (Moller-Trumbore over every ray x face pair,
the least t of each ray), the playground's mesh intersection. It replaces
no TPU kernel: threedgrut_tpu/playground/mesh.py intersect is XLA (a dense
[R, 4096] test per chunk of faces under lax.scan); see
csrc/mesh_intersect.cu for why it is a kernel here.

`closest_hits` launches csrc/mesh_intersect.cu for CUDA tensors and runs
its plain version for CPU tensors. The plain version is chunked over rays
as well as faces so that its [rays, faces] temporaries stay under
PAIRS_PER_CHUNK pairs, and it keeps the JAX function's tie-break (the
lowest face index of the least t) and its expressions, each a separate
tensor operation in JAX's order, which is what the kernel (built with
--fmad=false) computes too.
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
    r, nf = rays_o.shape[0], tri.shape[0]
    cuda_build.checked_inputs(
        ("rays_o", rays_o, torch.float32, (r, 3)),
        ("rays_d", rays_d, torch.float32, (r, 3)),
        ("tri", tri, torch.float32, (nf, 9)))
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
