"""Gaussian-particle response math, port of threedgrut_tpu/ops/particles.py.

Canonical-space formulation shared by the oracle and the tile compositor:

    gro = (1/s) R^T (o - mu),  grd = normalize((1/s) R^T d)
    grayDist = |grd x gro|^2,  response = exp(s_n grayDist^(n/2))
    alpha = min(max_alpha, response * density)
    accept = response > min_response and alpha > min_alpha
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from threedgrut_torch.constants import (
    GG_SCALE,
    MAX_ALPHA,
    MIN_ALPHA,
    MIN_KERNEL_RESPONSE,
)
from threedgrut_torch.ops import quaternion


def kernel_response(gray_dist: torch.Tensor, degree: int) -> torch.Tensor:
    """Generalized-Gaussian response exp(s_n d^(n/2)); degree 0 is linear."""
    if degree not in GG_SCALE:
        raise ValueError(f"unsupported kernel degree {degree}")
    s = GG_SCALE[degree]
    if degree == 0:
        return torch.clamp(1.0 + s * torch.sqrt(gray_dist), min=0.0)
    if degree == 1:
        return torch.exp(s * torch.sqrt(gray_dist))
    if degree == 2:
        return torch.exp(s * gray_dist)
    if degree == 3:
        return torch.exp(s * gray_dist * torch.sqrt(gray_dist))
    if degree == 4:
        return torch.exp(s * gray_dist * gray_dist)
    if degree == 5:
        return torch.exp(s * gray_dist * gray_dist * torch.sqrt(gray_dist))
    d2 = gray_dist * gray_dist
    return torch.exp(s * d2 * d2)


def canonical_ray(position, quat, scale, ray_o, ray_d, eps: float = 1e-12):
    """World ray -> particle canonical frame; returns (gro, grd unit)."""
    R = quaternion.to_rotation_matrix(quat)
    inv_s = 1.0 / scale
    gro = inv_s * torch.einsum("...i,...ij->...j", ray_o - position, R)
    grdu = inv_s * torch.einsum("...i,...ij->...j", ray_d, R)
    n = torch.linalg.norm(grdu, dim=-1, keepdim=True)
    return gro, grdu / torch.clamp(n, min=eps)


class HitResult(NamedTuple):
    alpha: torch.Tensor       # compositing alpha in [0, max_alpha]
    accept: torch.Tensor      # bool acceptance test
    hit_t: torch.Tensor       # scaled projection distance (depth)
    response: torch.Tensor    # raw kernel response
    gray_dist: torch.Tensor   # canonical squared distance
    proj: torch.Tensor        # canonical hit parameter


def particle_hit(position, quat, scale, density, ray_o, ray_d,
                 kernel_degree: int, min_response: float = MIN_KERNEL_RESPONSE,
                 min_alpha: float = MIN_ALPHA, max_alpha: float = MAX_ALPHA,
                 surfel: bool = False) -> HitResult:
    """One particle against one ray, broadcast over leading dims. `density`
    is the post-activation opacity; rejected hits return alpha 0.

    `surfel=True` is the 2DGS barycentric-surfel variant: the response is
    taken where the ray meets the particle's canonical z = 0 plane, and the
    hit distance is the scaled plane-intersection distance; rays parallel
    to the plane never hit."""
    gro, grd = canonical_ray(position, quat, scale, ray_o, ray_d)
    grd_b, gro_b = torch.broadcast_tensors(grd, gro)
    if surfel:
        gz = grd_b[..., 2]
        hits_plane = torch.abs(gz) > 1e-9
        t_pl = -gro_b[..., 2] / torch.where(hits_plane, gz,
                                            torch.ones_like(gz))
        pt = gro_b + grd_b * t_pl[..., None]
        gray_dist = torch.where(hits_plane, torch.sum(pt * pt, dim=-1),
                                torch.full_like(gz, float("inf")))
        proj = t_pl
    else:
        gcrod = torch.linalg.cross(grd_b, gro_b, dim=-1)
        gray_dist = torch.sum(gcrod * gcrod, dim=-1)
        proj = torch.sum(grd * (-gro), dim=-1)
    response = kernel_response(
        torch.where(torch.isfinite(gray_dist), gray_dist,
                    torch.full_like(gray_dist, 1e6)), kernel_degree)
    alpha = torch.clamp(response * density, max=max_alpha)
    accept = (response > min_response) & (alpha > min_alpha)
    grds = scale * grd * proj[..., None]
    hit_t = torch.sqrt(torch.sum(grds * grds, dim=-1))
    alpha = torch.where(accept, alpha, torch.zeros_like(alpha))
    return HitResult(alpha=alpha, accept=accept, hit_t=hit_t,
                     response=response, gray_dist=gray_dist, proj=proj)


def particle_normal(position, quat, scale, ray_o, ray_d,
                    ellipsoid_sq_radius: float = 9.0, eps: float = 1e-12,
                    surfel: bool = False) -> torch.Tensor:
    """Unit surface normal where the ray meets the particle's iso-response
    ellipsoid (canonical squared radius `ellipsoid_sq_radius`), in world
    space. Surfels give (0, 0, sign(grd.z) (R scale).z), normalised."""
    R = quaternion.to_rotation_matrix(quat)
    gro, grd = canonical_ray(position, quat, scale, ray_o, ray_d)
    grd, gro = torch.broadcast_tensors(grd, gro)
    if surfel:
        srot_z = torch.einsum("...ij,...j->...i", R, scale)[..., 2]
        sign = torch.where(grd[..., 2] > 0, 1.0, -1.0)
        z = sign * srot_z
        zero = torch.zeros_like(z)
        out = torch.stack([zero, zero, z], dim=-1)
    else:
        gcrod = torch.linalg.cross(grd, gro, dim=-1)
        gray_dist = torch.sum(gcrod * gcrod, dim=-1)
        proj = torch.sum(grd * (-gro), dim=-1)
        t_surf = proj - torch.sqrt(
            torch.clamp(ellipsoid_sq_radius - gray_dist, min=0.0))
        p = gro + grd * t_surf[..., None]
        out = torch.einsum("...ij,...j->...i", R, p * scale)
    norm = torch.linalg.norm(out, dim=-1, keepdim=True)
    return out / torch.clamp(norm, min=eps)
