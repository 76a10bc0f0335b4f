"""Playground materials: diffuse, mirror, glass and PBR metallic-roughness,
port of threedgrut_tpu/playground/materials.py.

Each material maps an incoming ray and its hit to (next direction,
attenuation, emitted radiance, continue): a Whitted-style tracer with one
continuation ray per hit, not a Monte Carlo integrator.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from threedgrut_torch.device import resolve


class MaterialKind(enum.IntEnum):
    DIFFUSE = 0
    MIRROR = 1
    GLASS = 2
    PBR = 3


@dataclasses.dataclass
class Materials:
    """Struct-of-arrays material table on one device, indexed by material
    id. Textures live in per-material stacks of one shared size; a
    material without a texture carries a neutral level and has_* == 0.
    Base-colour textures multiply the base colour factor (glTF); normal
    maps are tangent-space, in [0, 1]."""
    kind: torch.Tensor            # [M] int32
    base_color: torch.Tensor      # [M, 3]
    metallic: torch.Tensor        # [M]
    roughness: torch.Tensor       # [M]
    ior: torch.Tensor             # [M]
    emissive: torch.Tensor        # [M, 3]
    tex_color: torch.Tensor       # [M, TH, TW, 3]
    has_tex: torch.Tensor         # [M] int32
    tex_normal: torch.Tensor      # [M, NH, NW, 3]
    has_normal_tex: torch.Tensor  # [M] int32


FIELDS = tuple(f.name for f in dataclasses.fields(Materials))


def from_numpy(fields, device="cuda") -> Materials:
    """The JAX Materials' fields (numpy arrays) -> the port's, on
    `device`."""
    dev = resolve(device)
    return Materials(**{f: torch.tensor(np.asarray(fields[f]), device=dev)
                        for f in FIELDS})


def _stack_textures(texs, size_default=(1, 1), neutral=(1.0, 1.0, 1.0)):
    """Per-material textures (or None) -> one [M, H, W, 3] stack at the
    largest size (nearest resampling) and the has-texture flags."""
    hs = [t.shape[0] for t in texs if t is not None] or [size_default[0]]
    ws = [t.shape[1] for t in texs if t is not None] or [size_default[1]]
    H, W = max(hs), max(ws)
    out = np.empty((len(texs), H, W, 3), np.float32)
    has = np.zeros((len(texs),), np.int32)
    for i, t in enumerate(texs):
        if t is None:
            out[i] = np.asarray(neutral, np.float32)
        else:
            t = np.asarray(t, np.float32)
            if t.shape[:2] != (H, W):
                yi = (np.arange(H) * t.shape[0] // H)
                xi = (np.arange(W) * t.shape[1] // W)
                t = t[yi][:, xi]
            out[i] = t[..., :3]
            has[i] = 1
    return out, has


def make_materials(specs, device="cuda") -> Materials:
    """Material table from spec dicts (kind, base_color, metallic,
    roughness, ior, emissive, base_color_texture, normal_texture; the
    JAX package's defaults), on `device`."""
    kinds, colors, metallic, rough, ior, emis = [], [], [], [], [], []
    texs, ntexs = [], []
    for s in specs:
        kinds.append(int(s.get("kind", MaterialKind.DIFFUSE)))
        colors.append(s.get("base_color", (0.8, 0.8, 0.8)))
        metallic.append(s.get("metallic", 0.0))
        rough.append(s.get("roughness", 0.5))
        ior.append(s.get("ior", 1.5))
        emis.append(s.get("emissive", (0.0, 0.0, 0.0)))
        texs.append(s.get("base_color_texture"))
        ntexs.append(s.get("normal_texture"))
    tex, has_tex = _stack_textures(texs)
    ntex, has_ntex = _stack_textures(ntexs, neutral=(0.5, 0.5, 1.0))
    return from_numpy(dict(
        kind=np.asarray(kinds, np.int32),
        base_color=np.asarray(colors, np.float32),
        metallic=np.asarray(metallic, np.float32),
        roughness=np.asarray(rough, np.float32),
        ior=np.asarray(ior, np.float32),
        emissive=np.asarray(emis, np.float32),
        tex_color=tex, has_tex=has_tex, tex_normal=ntex,
        has_normal_tex=has_ntex), device)


def sample_texture(tex: torch.Tensor, mid: torch.Tensor,
                   uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of tex [M, H, W, 3] at per-ray (material, uv), wrap
    addressing (a CUDA texture's and glTF's REPEAT default)."""
    h, w = tex.shape[1], tex.shape[2]
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    y0i = torch.remainder(y0.to(torch.int64), h)
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.remainder(y0i + 1, h)
    mid = mid.to(torch.int64)
    c00 = tex[mid, y0i, x0i]
    c10 = tex[mid, y0i, x1i]
    c01 = tex[mid, y1i, x0i]
    c11 = tex[mid, y1i, x1i]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return d - 2.0 * torch.sum(d * n, -1, keepdim=True) * n


def refract(d: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """Snell refraction; reflection on total internal reflection. Returns
    (direction, tir [R])."""
    cos_i = -torch.sum(d * n, -1, keepdim=True)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    refr = eta * d + (eta * cos_i - cos_t) * n
    return torch.where(tir, reflect(d, n), refr), tir[..., 0]


def schlick(cos_i: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - cos_i, 0.0, 1.0),
                                       5.0)


def bounce(materials: Materials, mat_id: torch.Tensor, d: torch.Tensor,
           n: torch.Tensor, env_radiance: torch.Tensor,
           uv: Optional[torch.Tensor] = None,
           tangent: Optional[torch.Tensor] = None):
    """Per-hit shading. Returns (next_dir [R, 3], attenuation [R, 3],
    emitted [R, 3], continue [R] bool).

    DIFFUSE terminates with base_color * max(0, -d.n) * the environment's
    ambient; MIRROR reflects, attenuated by base_color; GLASS continues
    along the refracted ray, the Fresnel reflection weight folded into the
    attenuation; PBR reflects about a normal lerped toward the surface
    normal by roughness and emits its diffuse part locally. With `uv` (and
    `tangent`), base-colour textures modulate the colour and tangent-space
    normal maps perturb the shading normal."""
    mid = torch.clamp(mat_id, 0, materials.kind.shape[0] - 1).to(torch.int64)
    kind = materials.kind[mid]
    color = materials.base_color[mid]
    if uv is not None:
        tex_rgb = sample_texture(materials.tex_color, mid, uv)
        color = torch.where(materials.has_tex[mid][:, None] > 0,
                            color * tex_rgb, color)
        if tangent is not None:
            tn = sample_texture(materials.tex_normal, mid, uv) * 2.0 - 1.0
            bitan = torch.linalg.cross(n, tangent)
            n_pert = _unit(tangent * tn[:, 0:1] + bitan * tn[:, 1:2]
                           + n * tn[:, 2:3])
            n = torch.where(materials.has_normal_tex[mid][:, None] > 0,
                            n_pert, n)
    metallic = materials.metallic[mid][:, None]
    rough = materials.roughness[mid][:, None]
    ior = materials.ior[mid]
    emissive = materials.emissive[mid]

    entering = torch.sum(d * n, -1) < 0
    n_face = torch.where(entering[:, None], n, -n)
    cos_i = torch.clamp(-torch.sum(d * n_face, -1), 0.0, 1.0)

    refl = reflect(d, n_face)
    eta = torch.where(entering, 1.0 / ior, ior)
    refr, _ = refract(d, n_face, eta[:, None])
    f0 = ((ior - 1.0) / (ior + 1.0)) ** 2
    fres = schlick(cos_i, f0)

    ndotl = torch.clamp(-torch.sum(d * n_face, -1, keepdim=True), 0.0, 1.0)
    diffuse_rgb = color * ndotl * env_radiance

    is_diffuse = (kind == MaterialKind.DIFFUSE)[:, None]
    is_mirror = (kind == MaterialKind.MIRROR)[:, None]
    is_glass = (kind == MaterialKind.GLASS)[:, None]
    is_pbr = (kind == MaterialKind.PBR)[:, None]

    # PBR: the mirror direction lerped toward the normal by roughness (the
    # single-sample stand-in of a GGX lobe of the reference's viewer).
    pbr_dir = _unit(refl * (1.0 - rough) + n_face * rough)
    spec_w = metallic + (1.0 - metallic) * fres[:, None]

    zero = torch.zeros_like(color)
    next_dir = torch.where(is_mirror, refl,
                           torch.where(is_glass, refr,
                                       torch.where(is_pbr, pbr_dir, d)))
    atten = torch.where(is_mirror, color,
                        torch.where(is_glass, (1.0 - fres[:, None]) * color,
                                    torch.where(is_pbr, spec_w * color,
                                                zero)))
    emitted = emissive + torch.where(
        is_diffuse, diffuse_rgb,
        torch.where(is_pbr, (1.0 - spec_w) * diffuse_rgb, zero))
    cont = (is_mirror | is_glass | is_pbr)[:, 0]
    return next_dir, atten, emitted, cont
