"""Plain PyTorch reference of the playground's hybrid frame: primary rays
rasterized with 3DGUT and bounded by their closest mesh hit, the mesh
shaded, and the secondary rays off mirrors and glass traced through the
particles (3DGRT, every hit in its own order) with up to max_bounces
further mesh bounces. It imports nothing of the program: it builds its own
vertex normals, tangents and material tables from the scene's arrays,
tests every ray against every face, and finds each secondary ray's
particles by testing it against every particle's bounding sphere.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import render as R

MIRROR, GLASS, PBR, DIFFUSE = 1, 2, 3, 0


class Mesh(NamedTuple):
    tri: torch.Tensor        # [F, 9] p0, e1, e2
    faces: torch.Tensor      # [F, 3] int64
    normals: torch.Tensor    # [V, 3] area-weighted vertex normals
    uvs: torch.Tensor        # [V, 2]
    tangents: torch.Tensor   # [V, 3]
    material: torch.Tensor   # [F] int64


def build_mesh(parts, device) -> Mesh:
    """parts: [(vertices, faces, uvs, material id)] numpy arrays."""
    vs, fs, uvs, vns, vts, mids = [], [], [], [], [], []
    off = 0
    for v, f, uv, mid in parts:
        v = np.asarray(v, np.float32)
        f = np.asarray(f, np.int64)
        uv = np.asarray(uv, np.float32)
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        vn = np.zeros_like(v)
        for k in range(3):
            np.add.at(vn, f[:, k], fn)
        vn = vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True),
                             1e-12)
        # Tangents from the UV derivatives, orthogonal to the normal; an
        # arbitrary frame where the UVs are degenerate.
        e1, e2 = v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]
        d1, d2 = uv[f[:, 1]] - uv[f[:, 0]], uv[f[:, 2]] - uv[f[:, 0]]
        det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
        r = np.where(np.abs(det) > 1e-12,
                     1.0 / np.where(det == 0, 1, det), 0.0)
        tf = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r[:, None]
        vt = np.zeros_like(v)
        for k in range(3):
            np.add.at(vt, f[:, k], tf)
        vt = vt - vn * np.sum(vt * vn, -1, keepdims=True)
        bad = np.linalg.norm(vt, axis=-1) < 1e-8
        alt = np.cross(vn, np.where(np.abs(vn[:, 2:3]) < 0.9,
                                    [[0.0, 0.0, 1.0]], [[1.0, 0.0, 0.0]]))
        vt = np.where(bad[:, None], alt, vt)
        vt = vt / np.maximum(np.linalg.norm(vt, axis=-1, keepdims=True),
                             1e-12)
        vs.append(v)
        fs.append(f + off)
        uvs.append(uv)
        vns.append(vn)
        vts.append(vt.astype(np.float32))
        mids.append(np.full(len(f), mid, np.int64))
        off += len(v)

    def t(x, dt=torch.float32):
        return torch.tensor(np.concatenate(x), dtype=dt, device=device)

    v, f = t(vs), t(fs, torch.int64)
    p0 = v[f[:, 0]]
    tri = torch.cat([p0, v[f[:, 1]] - p0, v[f[:, 2]] - p0], 1)
    return Mesh(tri, f, t(vns), t(uvs), t(vts), t(mids, torch.int64))


class Hit(NamedTuple):
    t: torch.Tensor          # [R] inf on a miss
    material: torch.Tensor   # [R] -1 on a miss
    normal: torch.Tensor
    uv: torch.Tensor
    tangent: torch.Tensor


def unit(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def closest_hit(mesh: Mesh, o, d, t_min=1e-4, chunk=1 << 13) -> Hit:
    """Every ray against every face (Moller-Trumbore); the least t wins,
    the first face of equal ones."""
    r = o.shape[0]
    best_t = o.new_full((r,), math.inf)
    best_f = torch.zeros(r, dtype=torch.int64, device=o.device)
    bu, bw = o.new_zeros(r), o.new_zeros(r)
    tri = mesh.tri.to(o.dtype)
    p0, a, b = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    for c0 in range(0, r, chunk):
        oc, dc = o[c0:c0 + chunk, None], d[c0:c0 + chunk, None]
        h = torch.linalg.cross(dc.expand(-1, b.shape[0], -1),
                               b[None].expand(dc.shape[0], -1, -1), dim=-1)
        det = (a[None] * h).sum(-1)
        ok = det.abs() > 1e-9
        inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
        s = oc - p0[None]
        u = (s * h).sum(-1) * inv
        q = torch.linalg.cross(s, a[None].expand_as(s), dim=-1)
        w = (dc * q).sum(-1) * inv
        t = (b[None] * q).sum(-1) * inv
        ok &= (u >= 0) & (w >= 0) & (u + w <= 1) & (t > t_min)
        t = torch.where(ok, t, torch.full_like(t, math.inf))
        tc, arg = t.min(1)
        sl = slice(c0, c0 + chunk)
        best_t[sl], best_f[sl] = tc, arg
        bu[sl] = u.gather(1, arg[:, None])[:, 0]
        bw[sl] = w.gather(1, arg[:, None])[:, 0]
    fi = mesh.faces[best_f]
    w0 = (1 - bu - bw)[:, None]

    def interp(attr):
        attr = attr.to(o.dtype)
        return (attr[fi[:, 0]] * w0 + attr[fi[:, 1]] * bu[:, None]
                + attr[fi[:, 2]] * bw[:, None])

    miss = ~torch.isfinite(best_t)
    normal = unit(interp(mesh.normals))
    return Hit(best_t, torch.where(miss, -1, mesh.material[best_f]),
               torch.where(miss[:, None], torch.zeros_like(normal), normal),
               interp(mesh.uvs), unit(interp(mesh.tangents)))


def sample_env(env, dirs, default=(0.0, 0.0, 0.0)):
    """Bilinear equirect lookup (polar angle from +z, azimuth from +x)."""
    if env is None:
        return torch.tensor(default, dtype=dirs.dtype,
                            device=dirs.device).expand(dirs.shape[:-1] + (3,))
    env = env.to(dirs.dtype)
    h, w = env.shape[:2]
    d = unit(dirs)
    theta = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0))
    phi = torch.arctan2(d[..., 1], d[..., 0])
    u = (phi / (2 * math.pi) + 0.5) * (w - 1)
    v = theta / math.pi * (h - 1)
    u0 = torch.clamp(torch.floor(u).long(), 0, w - 1)
    v0 = torch.clamp(torch.floor(v).long(), 0, h - 1)
    u1, v1 = torch.clamp(u0 + 1, max=w - 1), torch.clamp(v0 + 1, max=h - 1)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    return (env[v0, u0] * (1 - fu) * (1 - fv) + env[v0, u1] * fu * (1 - fv)
            + env[v1, u0] * (1 - fu) * fv + env[v1, u1] * fu * fv)


def sample_tex(tex, uv):
    """Bilinear lookup of tex [H, W, 3] with wrap-around addressing."""
    h, w = tex.shape[:2]
    x, y = uv[:, 0] * w - 0.5, uv[:, 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    x0, y0 = torch.remainder(x0.long(), w), torch.remainder(y0.long(), h)
    x1, y1 = torch.remainder(x0 + 1, w), torch.remainder(y0 + 1, h)
    return ((tex[y0, x0] * (1 - fx) + tex[y0, x1] * fx) * (1 - fy)
            + (tex[y1, x0] * (1 - fx) + tex[y1, x1] * fx) * fy)


def reflect(d, n):
    return d - 2.0 * (d * n).sum(-1, keepdim=True) * n


def shade(materials, hit: Hit, d, env):
    """(next direction, attenuation, emitted, continues) of each hit:
    mirrors reflect, glass refracts (Schlick's Fresnel weight folded into
    the attenuation, reflection on total internal reflection), PBR
    reflects about a normal turned toward the surface normal by its
    roughness and emits its diffuse part, diffuse stops."""
    mid = torch.clamp(hit.material, min=0)
    dev, dt = d.device, d.dtype

    def col(key, default):
        return torch.tensor([m.get(key, default) for m in materials],
                            dtype=dt, device=dev)[mid]

    kind = col("kind", DIFFUSE).long()
    color = col("base_color", (0.8, 0.8, 0.8))
    n = hit.normal
    for i, m in enumerate(materials):
        sel = (mid == i)[:, None]
        if m.get("base_color_texture") is not None:
            tex = torch.tensor(m["base_color_texture"], dtype=dt, device=dev)
            color = torch.where(sel, color * sample_tex(tex, hit.uv), color)
        if m.get("normal_texture") is not None:
            tn = sample_tex(torch.tensor(m["normal_texture"], dtype=dt,
                                         device=dev), hit.uv) * 2.0 - 1.0
            bitan = torch.linalg.cross(n, hit.tangent, dim=-1)
            n_pert = unit(hit.tangent * tn[:, 0:1] + bitan * tn[:, 1:2]
                          + n * tn[:, 2:3])
            n = torch.where(sel, n_pert, n)
    env_at_n = sample_env(env, hit.normal, default=(1.0, 1.0, 1.0))
    metallic = col("metallic", 0.0)[:, None]
    rough = col("roughness", 0.5)[:, None]
    ior = col("ior", 1.5)
    emissive = col("emissive", (0.0, 0.0, 0.0))
    entering = (d * n).sum(-1) < 0
    nf = torch.where(entering[:, None], n, -n)
    cos_i = torch.clamp(-(d * nf).sum(-1), 0.0, 1.0)
    refl = reflect(d, nf)
    eta = torch.where(entering, 1.0 / ior, ior)[:, None]
    ci = -(d * nf).sum(-1, keepdim=True)
    sin2 = eta * eta * torch.clamp(1.0 - ci * ci, min=0.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2, min=0.0))
    refr = torch.where(sin2 > 1.0, refl, eta * d + (eta * ci - cos_t) * nf)
    f0 = ((ior - 1.0) / (ior + 1.0)) ** 2
    fres = f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - cos_i, 0.0, 1.0), 5)
    ndotl = torch.clamp(-(d * nf).sum(-1, keepdim=True), 0.0, 1.0)
    diffuse = color * ndotl * env_at_n
    is_m, is_g = (kind == MIRROR)[:, None], (kind == GLASS)[:, None]
    is_p, is_d = (kind == PBR)[:, None], (kind == DIFFUSE)[:, None]
    pbr_dir = unit(refl * (1.0 - rough) + nf * rough)
    spec_w = metallic + (1.0 - metallic) * fres[:, None]
    zero = torch.zeros_like(color)
    nd = torch.where(is_m, refl, torch.where(
        is_g, refr, torch.where(is_p, pbr_dir, d)))
    atten = torch.where(is_m, color, torch.where(
        is_g, (1.0 - fres[:, None]) * color,
        torch.where(is_p, spec_w * color, zero)))
    emitted = emissive + torch.where(is_d, diffuse, torch.where(
        is_p, (1.0 - spec_w) * diffuse, zero))
    return nd, atten, emitted, (is_m | is_g | is_p)[:, 0]


def trace_rays(a: R.Acts, o, d, t_max, min_transmittance, sh_degree,
               ray_chunk=128):
    """Every particle a ray [R, 3] hits before t_max (inf: unbounded), in
    its own order of hit distance, blended front to back (kernel degree
    4). Returns (rgb [R, 3], opacity [R], transmittance [R])."""
    r = o.shape[0]
    dev = o.device
    rgb = o.new_zeros((r, 3))
    opa = o.new_zeros(r)
    trans = o.new_ones(r)
    rad = R.bounding_radius(a.scales, a.opacity, 4)
    live = a.opacity > R.MIN_ALPHA
    p = a.positions[live]
    rad, ids_live = rad[live], torch.nonzero(live).squeeze(1)
    pp = (p * p).sum(-1)
    for c0 in range(0, r, ray_chunk):
        oc, dc = o[c0:c0 + ray_chunk], d[c0:c0 + ray_chunk]
        tm = t_max[c0:c0 + ray_chunk]
        # Sphere test: distance from the ray's line, and the extent along
        # it, with a margin for rounding.
        tc = p @ dc.T - (oc * dc).sum(-1)[None]            # [N, r]
        dist2 = pp[:, None] - 2 * (p @ oc.T) + (oc * oc).sum(-1)[None] \
            - tc * tc
        rr = rad[:, None]
        cand = ((dist2 <= rr * rr * 1.0001 + 1e-6) & (tc + rr > 0)
                & (tc - rr <= tm[None]))
        pid, ray = torch.nonzero(cand, as_tuple=True)
        del tc, dist2, cand
        if pid.numel() == 0:
            continue
        order = torch.argsort(ray, stable=True)
        pid, ray = ids_live[pid[order]], ray[order]
        counts = torch.bincount(ray, minlength=oc.shape[0])
        k = int(counts.max())
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(ray.numel(), device=dev) - starts[ray]
        ids = torch.full((oc.shape[0], k), -1, dtype=torch.int64,
                         device=dev)
        ids[ray, slot] = pid
        valid = ids >= 0
        ids = torch.clamp(ids, min=0)
        pos, rot, s = a.positions[ids], a.rot[ids], a.scales[ids]
        op = torch.where(valid, a.opacity[ids], torch.zeros_like(
            a.opacity[ids]))
        inv = 1.0 / s
        gro = inv * torch.einsum("rki,rkij->rkj", oc[:, None] - pos, rot)
        grd = inv * torch.einsum("ri,rkij->rkj", dc, rot)
        grd = unit(grd)
        cr = torch.linalg.cross(grd, gro, dim=-1)
        dist = (cr * cr).sum(-1)
        resp = torch.exp(R.GG_SCALE[4] * dist * dist)
        alpha = torch.clamp(resp * op, max=R.MAX_ALPHA)
        proj = (grd * (-gro)).sum(-1)
        hit = torch.linalg.norm(s * grd * proj[..., None], dim=-1)
        acc = ((resp > R.MIN_RESPONSE) & (alpha > R.MIN_ALPHA) & (proj > 0)
               & (dist <= R.MAX_SQ_DISTANCE) & valid
               & (hit <= tm[:, None]))
        alpha = torch.where(acc, alpha, torch.zeros_like(alpha))
        basis = R.sh_basis(dc, sh_degree)
        nb = basis.shape[-1]
        colour = torch.clamp(torch.einsum(
            "rc,rkcx->rkx", basis, a.features[ids][:, :, :nb]) + 0.5,
            min=0.0)
        key = torch.where(alpha > 0, hit, torch.full_like(hit, math.inf))
        srt = torch.argsort(key, dim=-1, stable=True)
        c, op_r, tf = R.blend(torch.gather(alpha, -1, srt),
                              torch.gather(colour, 1, srt[..., None]
                                           .expand_as(colour)),
                              min_transmittance)
        rgb[c0:c0 + ray_chunk], opa[c0:c0 + ray_chunk] = c, op_r
        trans[c0:c0 + ray_chunk] = tf
    return rgb, opa, trans


def trace_pass(a, mesh, materials, env, o, d, eng, sh_degree):
    """The traced continuation of rays that left the meshes: each bounce
    takes the particles up to the next mesh hit, the environment on a miss
    and the mesh's shading on a hit, while the throughput and the
    accumulated opacity allow."""
    r = o.shape[0]
    dev = o.device
    radiance = o.new_zeros((r, 3))
    thr = o.new_ones((r, 3))
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    total_op = o.new_zeros(r)
    for _ in range(eng["max_bounces"]):
        hit = closest_hit(mesh, o, d)
        live = alive & (d != 0).any(-1)
        idx = torch.nonzero(live).squeeze(1)
        seg_rgb, seg_op, seg_tr = o.new_zeros((r, 3)), o.new_zeros(r), \
            o.new_ones(r)
        if idx.numel():
            c, op_r, tf = trace_rays(a, o[idx], d[idx], hit.t[idx],
                                     eng["min_transmittance"], sh_degree)
            seg_rgb[idx], seg_op[idx], seg_tr[idx] = c, op_r, tf
        radiance = radiance + thr * seg_rgb
        total_op = total_op + torch.where(alive, seg_op * thr.mean(-1),
                                          torch.zeros_like(total_op))
        tl = seg_tr[:, None]
        hit_mesh = alive & (hit.material >= 0)
        miss = alive & ~torch.isfinite(hit.t)
        radiance = radiance + torch.where(miss[:, None],
                                          thr * tl * sample_env(env, d),
                                          torch.zeros_like(radiance))
        nd, atten, emitted, cont = shade(materials, hit, d, env)
        radiance = radiance + torch.where(hit_mesh[:, None],
                                          thr * tl * emitted,
                                          torch.zeros_like(radiance))
        new_thr = thr * tl * atten
        hp = o + d * hit.t[:, None]
        go = (hit_mesh & cont & (new_thr.amax(-1) > 1e-4)
              & (total_op < eng["max_opacity"]))
        o = torch.where(go[:, None], hp + nd * 1e-4, o)
        d = torch.where(go[:, None], nd, d)
        thr = torch.where(go[:, None], new_thr, thr)
        alive = go
    return radiance


@torch.no_grad()
def hybrid_frame(a: R.Acts, mesh: Mesh, materials, env, cam: R.Camera,
                 eng, sh_degree: int) -> torch.Tensor:
    """The hybrid frame's radiance [H, W, 3]."""
    dirs, origin = R.pixel_rays(cam, a.positions.dtype)
    gx, gy = R.tile_grid(cam)
    d = dirs.reshape(-1, 3)
    o = origin.expand_as(d)
    hit = closest_hit(mesh, o, d)
    t_hit = torch.where(torch.isfinite(hit.t), hit.t, torch.zeros_like(hit.t))

    def image(x):
        c = x.shape[-1]
        img = x.reshape(gy, gx, R.TILE, R.TILE, c).permute(0, 2, 1, 3, 4)
        return img.reshape(gy * R.TILE, gx * R.TILE, c)[:cam.height,
                                                        :cam.width]

    t_img = image(t_hit[:, None])[..., 0]
    rgb, trans = R.render("gut", a, cam, sh_degree, t_max=t_img,
                          min_transmittance=eng["min_transmittance"],
                          with_transmittance=True)
    nd, atten, emitted, cont = shade(materials, hit, d, env)
    hit_mesh = hit.material >= 0
    go = hit_mesh & cont
    sec_o = o + d * t_hit[:, None] + nd * 1e-4
    sec_d = torch.where(go[:, None], nd, torch.zeros_like(nd))
    sec = trace_pass(a, mesh, materials, env, sec_o, sec_d, eng, sh_degree)
    zero = torch.zeros_like(emitted)
    em = image(torch.where(hit_mesh[:, None], emitted, zero))
    at = image(torch.where(go[:, None], atten, zero))
    env_bg = image(torch.where(~hit_mesh[:, None], sample_env(env, d), zero))
    tr = trans[..., None]
    return rgb + tr * (em + at * image(sec)) + tr * env_bg
