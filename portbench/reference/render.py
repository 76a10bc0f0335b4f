"""Plain PyTorch reference of the two camera renderers the benchmark times.

It imports nothing of the program. From the raw particle fields and a
camera it works out again everything the program derives: activations,
the unscented-transform projection and tile cull of the 3DGUT rasterizer,
a conservative sphere cull for the 3DGRT tracer, the per-pixel ray-space
particle response, the compositing order and the front-to-back blend.

  * 3DGUT ("gut"): each 16x16 tile composites the particles whose
    projected footprint reaches it (the sigma-point projection, its
    tile-min power test), in one global order of camera depth, with the
    particle's SH colour taken toward the camera centre; kernel degree 2.
  * 3DGRT ("grt"): each ray composites every particle it hits (canonical
    squared distance at most 9, in front of the origin) in its own order
    of hit distance, with the SH colour taken along the ray; kernel
    degree 4.

Tiles are composited in blocks with padded candidate lists, so that a
full-size frame fits in memory; `render_with_grad` recomputes each block
under autograd to carry an image cotangent back to the particles.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

TILE = 16
# Response scale exp(s d^(n/2)) of the generalised Gaussian of degree n.
GG_SCALE = {2: -0.5, 4: -0.0555555555556}
MIN_RESPONSE = 0.0113
MIN_ALPHA = 1.0 / 255.0
MAX_ALPHA = 0.99
MAX_SQ_DISTANCE = 9.0
# The rasterizer's projector: sigma points, the image margin a point may
# lie in, dilation of the 2D covariance, the extent's sigma cap.
UT_MARGIN = 0.1
MIN_SENSOR_Z = 0.2
DILATION = 0.3
MAX_EXTENT_SIGMA = 3.33
MIN_LAMBDA = 0.01
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

MODES = {
    "gut": dict(degree=2, min_transmittance=1e-4),
    "grt": dict(degree=4, min_transmittance=1e-3),
}


class Camera(NamedTuple):
    """An ideal pinhole camera at one pose; all tensors on one device."""
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    c2w: torch.Tensor     # [4, 4] camera to world, right-down-front axes


class Acts(NamedTuple):
    """Post-activation particles."""
    positions: torch.Tensor   # [N, 3]
    rot: torch.Tensor         # [N, 3, 3] canonical to world
    scales: torch.Tensor      # [N, 3]
    opacity: torch.Tensor     # [N]
    features: torch.Tensor    # [N, 16, 3] SH coefficients


def activate(raw: Dict[str, torch.Tensor]) -> Acts:
    """Raw fields (positions, rotation wxyz, log scale, logit density,
    features_albedo, features_specular, alive) -> activations."""
    q = raw["rotation"]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    w, x, y, z = q.unbind(-1)
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)
    n = q.shape[0]
    opacity = torch.sigmoid(raw["density"][:, 0]) * raw["alive"].to(q.dtype)
    feats = torch.cat([raw["features_albedo"][:, None, :],
                       raw["features_specular"].reshape(n, -1, 3)], 1)
    return Acts(raw["positions"], rot, torch.exp(raw["scale"]), opacity,
                feats)


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis [..., (degree+1)^2] at unit directions [..., 3]."""
    x, y, z = dirs.unbind(-1)
    out = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [SH_C2[0] * x * y, SH_C2[1] * y * z,
                SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * x * z,
                SH_C2[4] * (xx - yy)]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        out += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                SH_C3[2] * y * (4 * zz - xx - yy),
                SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                SH_C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, -1)


def world_to_camera(cam: Camera):
    R = cam.c2w[:3, :3].T
    return R, -R @ cam.c2w[:3, 3]


def tile_grid(cam: Camera) -> Tuple[int, int]:
    return -(-cam.width // TILE), -(-cam.height // TILE)


# ---- 3DGUT: sigma-point projection and tile cull ---------------------------

def ut_projection(a: Acts, cam: Camera):
    """Per particle: 2D centre, conic (a, b, c), max_power, sort depth,
    validity and tile box [x0, x1) x [y0, y1)."""
    R, t = world_to_camera(cam)
    w, h = cam.width, cam.height
    dt = a.positions.dtype

    def proj(p):
        pc = p @ R.T + t
        z = pc[..., 2]
        safe = torch.where(z > 0, z, torch.ones_like(z))
        uv = torch.stack([pc[..., 0] / safe * cam.fx + cam.cx,
                          pc[..., 1] / safe * cam.fy + cam.cy], -1)
        uv = torch.where((z > 0)[..., None], uv, torch.zeros_like(uv))
        mx, my = w * UT_MARGIN, h * UT_MARGIN
        ok = ((z > 0) & (uv[..., 0] > -mx) & (uv[..., 1] > -my)
              & (uv[..., 0] < w + mx) & (uv[..., 1] < h + my))
        return uv, ok

    # Sigma points: alpha 1, beta 2, kappa 0 in 3 dimensions.
    delta = math.sqrt(3.0)
    w0, wi, wc0 = 0.0, 1.0 / 6.0, 2.0
    off = delta * a.scales[..., None] * a.rot.transpose(-1, -2)
    p0, v0 = proj(a.positions)
    pp, vp = proj(a.positions[:, None] + off)
    pm, vm = proj(a.positions[:, None] - off)
    center = w0 * p0 + wi * (pp.sum(1) + pm.sum(1))

    def outer(d):
        return torch.stack([d[..., 0] * d[..., 0], d[..., 0] * d[..., 1],
                            d[..., 1] * d[..., 1]], -1)

    cov = wc0 * outer(p0 - center) + wi * (
        outer(pp - center[:, None]).sum(1)
        + outer(pm - center[:, None]).sum(1))
    any_ok = v0 | vp.any(1) | vm.any(1)
    dil = cov + torch.tensor([DILATION, 0.0, DILATION], dtype=dt,
                             device=cov.device)
    det_d = dil[:, 0] * dil[:, 2] - dil[:, 1] * dil[:, 1]
    det_ok = det_d != 0
    safe_det = torch.where(det_ok, det_d, torch.ones_like(det_d))
    conic = torch.stack([dil[:, 2], -dil[:, 1], dil[:, 0]], -1) \
        / safe_det[:, None]
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] * cov[:, 1]
    comp = a.opacity * torch.sqrt(torch.clamp(det / safe_det, min=0.000025))
    max_power = torch.log(torch.clamp(comp, min=MIN_ALPHA) / MIN_ALPHA)
    ext_f = torch.clamp(torch.sqrt(2.0 * max_power), max=MAX_EXTENT_SIGMA)
    mid = 0.5 * (dil[:, 0] + dil[:, 2])
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det_d, min=MIN_LAMBDA))
    radius = ext_f * torch.sqrt(lam)
    diag = torch.sqrt(torch.clamp(torch.stack([dil[:, 0], dil[:, 2]], -1),
                                  min=0.0))
    extent = torch.minimum(ext_f[:, None] * diag, radius[:, None])
    z = (a.positions @ R.T + t)[:, 2]
    valid = ((a.opacity >= MIN_ALPHA) & (z >= MIN_SENSOR_Z) & any_ok
             & det_ok & (comp >= MIN_ALPHA) & (radius > 0))
    gx, gy = tile_grid(cam)
    lo = torch.floor((center - 0.5 - extent) / TILE)
    hi = torch.ceil((center - 0.5 + extent) / TILE)
    lim = torch.tensor([gx, gy], device=lo.device)
    box_lo = torch.minimum(torch.clamp(lo.long(), min=0), lim)
    box_hi = torch.minimum(torch.clamp(hi.long(), min=0), lim)
    valid &= extent[:, 0] > 1e-6
    return center, conic, max_power, z, valid, box_lo, box_hi


def tile_min_power(tile_xy, conic, center):
    """The least Gaussian power over a 16x16 tile (the projector's
    approximation: the nearest edge point along each axis)."""
    size = torch.tensor([TILE, TILE], dtype=center.dtype,
                        device=center.device)
    tmin = size * tile_xy
    tmax = tmin + size
    min_off = tmin - center
    left_above = (min_off > 0).to(center.dtype)
    not_in = left_above + (center > tmax).to(center.dtype)
    outside = (not_in[..., 0] + not_in[..., 1]) > 0
    p = tmax + (tmin - tmax) * left_above
    dxy = torch.where(min_off >= 0, size, -size)
    diff = center - p
    cx, cb, cz = conic.unbind(-1)
    tx = not_in[..., 1] * torch.clamp(
        (dxy[..., 0] * cx * diff[..., 0] + dxy[..., 0] * cb * diff[..., 1])
        / (TILE * TILE * cx), 0.0, 1.0)
    ty = not_in[..., 0] * torch.clamp(
        (dxy[..., 1] * cb * diff[..., 0] + dxy[..., 1] * cz * diff[..., 1])
        / (TILE * TILE * cz), 0.0, 1.0)
    dx = center[..., 0] - (p[..., 0] + tx * dxy[..., 0])
    dy = center[..., 1] - (p[..., 1] + ty * dxy[..., 1])
    power = 0.5 * (cx * dx * dx + cz * dy * dy) + cb * dx * dy
    return torch.where(outside, power, torch.zeros_like(power))


def expand_boxes(box_lo, box_hi, keep):
    """(particle, tile x, tile y) of every tile in each kept box."""
    nx = torch.clamp(box_hi[:, 0] - box_lo[:, 0], min=0)
    ny = torch.clamp(box_hi[:, 1] - box_lo[:, 1], min=0)
    cnt = torch.where(keep, nx * ny, torch.zeros_like(nx))
    pid = torch.repeat_interleave(torch.arange(cnt.shape[0],
                                               device=cnt.device), cnt)
    start = torch.cumsum(cnt, 0) - cnt
    k = torch.arange(pid.shape[0], device=cnt.device) - start[pid]
    tx = box_lo[pid, 0] + k % nx[pid]
    ty = box_lo[pid, 1] + k // nx[pid]
    return pid, tx, ty


def gut_lists(a: Acts, cam: Camera):
    """3DGUT tile lists: (tile id, particle id) of every pair, sorted by
    tile and, inside a tile, by camera depth (ties by particle id)."""
    with torch.no_grad():
        center, conic, max_power, z, valid, lo, hi = ut_projection(a, cam)
        gx, gy = tile_grid(cam)
        pid, tx, ty = expand_boxes(lo, hi, valid)
        txy = torch.stack([tx, ty], -1).to(center.dtype)
        keep = tile_min_power(txy, conic[pid], center[pid]) < max_power[pid]
        pid, tile = pid[keep], (ty * gx + tx)[keep]
        rank = torch.empty_like(z, dtype=torch.long)
        rank[torch.sort(z, stable=True).indices] = torch.arange(
            z.shape[0], device=z.device)
        order = torch.argsort(tile * z.shape[0] + rank[pid])
        return tile[order], pid[order]


# ---- 3DGRT: a conservative sphere cull per tile -----------------------------

def bounding_radius(scales, opacity, degree: int):
    """Radius of each particle's acceptance region: response above both
    floors and canonical squared distance at most 9."""
    floor = torch.clamp(MIN_ALPHA / torch.clamp(opacity, min=1e-12),
                        min=MIN_RESPONSE)
    floor = torch.clamp(floor, max=0.9999)
    d_max = torch.pow(torch.log(floor) / GG_SCALE[degree], 2.0 / degree)
    return scales.amax(-1) * torch.sqrt(torch.clamp(d_max,
                                                    max=MAX_SQ_DISTANCE))


def grt_lists(a: Acts, cam: Camera):
    """3DGRT tile lists: every particle whose bounding sphere meets the
    tile's frustum of pixel-centre rays (a superset of its hits)."""
    with torch.no_grad():
        R, t = world_to_camera(cam)
        pc = a.positions @ R.T + t
        r = bounding_radius(a.scales, a.opacity, 4)
        live = (a.opacity > MIN_ALPHA) & (pc[:, 2] > -r)
        gx, gy = tile_grid(cam)

        def axis_range(coord, c0, f, n_tiles, size):
            edges = (torch.arange(n_tiles + 1, device=coord.device,
                                  dtype=coord.dtype) * TILE + 0.5 - c0) / f
            edges = torch.clamp(edges, max=(size - 0.5 - c0) / f)
            lo_u, hi_u = edges[:-1], edges[1:]
            zc = pc[:, 2:3]
            ok = (((coord[:, None] - lo_u * zc)
                   >= -r[:, None] * torch.sqrt(1 + lo_u * lo_u))
                  & ((hi_u * zc - coord[:, None])
                     >= -r[:, None] * torch.sqrt(1 + hi_u * hi_u)))
            idx = torch.arange(n_tiles, device=coord.device)
            first = torch.where(ok, idx, n_tiles).amin(1)
            last = torch.where(ok, idx, -1).amax(1)
            return first, last + 1

        x0, x1 = axis_range(pc[:, 0], cam.cx, cam.fx, gx, cam.width)
        y0, y1 = axis_range(pc[:, 1], cam.cy, cam.fy, gy, cam.height)
        lo = torch.stack([x0, y0], -1)
        hi = torch.stack([x1, y1], -1)
        pid, tx, ty = expand_boxes(lo, hi, live)
        tile = ty * gx + tx
        order = torch.argsort(tile * a.positions.shape[0] + pid)
        return tile[order], pid[order]


# ---- compositing -----------------------------------------------------------

def pixel_rays(cam: Camera, dtype):
    """World directions [gy*gx, 256, 3] of the tile-padded pixel centres
    (tile-major, row-major inside a tile) and the shared origin [3]."""
    gx, gy = tile_grid(cam)
    dev = cam.c2w.device
    ys = torch.arange(gy * TILE, device=dev, dtype=dtype)
    xs = torch.arange(gx * TILE, device=dev, dtype=dtype)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    d = torch.stack([(px + 0.5 - cam.cx) / cam.fx,
                     (py + 0.5 - cam.cy) / cam.fy, torch.ones_like(px)], -1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    d = d @ cam.c2w[:3, :3].to(dtype).T
    d = d.reshape(gy, TILE, gx, TILE, 3).permute(0, 2, 1, 3, 4)
    return d.reshape(gy * gx, TILE * TILE, 3), cam.c2w[:3, 3].to(dtype)


def blocks(tile, n_tiles, budget):
    """Blocks of tiles of similar list length: lists of (tile ids, list
    starts, list length) with sum(len(tiles) * longest * 256) <= budget."""
    counts = torch.bincount(tile, minlength=n_tiles)
    starts = torch.cumsum(counts, 0) - counts
    order = torch.argsort(counts, descending=True).tolist()
    counts_l, starts_l = counts.tolist(), starts.tolist()
    out, cur, longest = [], [], 0
    for t in order:
        c = counts_l[t]
        if c == 0:
            break
        if cur and (len(cur) + 1) * max(longest, c) * 256 > budget:
            out.append((cur, longest))
            cur, longest = [], 0
        cur.append(t)
        longest = max(longest, c)
    if cur:
        out.append((cur, longest))
    return [(torch.tensor(ts, device=tile.device),
             torch.tensor([starts_l[t] for t in ts], device=tile.device),
             torch.tensor([counts_l[t] for t in ts], device=tile.device), k)
            for ts, k in out]


def composite_block(mode, a_pos, a_rot, a_scale, a_opa, colour_src,
                    ids, valid, dirs, origin, sh_degree, t_max=None,
                    min_transmittance=None):
    """Front-to-back blend of one block of tiles: ids [B, K] particle ids
    (padding masked by `valid`), dirs [B, 256, 3]. colour_src is the
    per-particle colour [N, 3] (gut) or the SH coefficients [N, 16, 3]
    (grt). `t_max` [B, 256] bounds each ray's hits (<= 0: unbounded).
    Returns rgb [B, 256, 3], opacity [B, 256] and the final
    transmittance [B, 256]."""
    cfg = dict(MODES[mode])
    if min_transmittance is not None:
        cfg["min_transmittance"] = min_transmittance
    p, rot, s = a_pos[ids], a_rot[ids], a_scale[ids]
    opa = torch.where(valid, a_opa[ids], torch.zeros_like(a_opa[ids]))
    inv = 1.0 / s
    gro = inv * torch.einsum("bki,bkij->bkj", origin - p, rot)
    grd = torch.einsum("bpi,bkij->bpkj", dirs, rot) * inv[:, None]
    grd = grd / torch.clamp(torch.linalg.norm(grd, dim=-1, keepdim=True),
                            min=1e-12)
    gro_b = gro[:, None].expand_as(grd)
    cr = torch.linalg.cross(grd, gro_b, dim=-1)
    dist = (cr * cr).sum(-1)
    sc = GG_SCALE[cfg["degree"]]
    resp = torch.exp(sc * dist) if cfg["degree"] == 2 \
        else torch.exp(sc * dist * dist)
    alpha = torch.clamp(resp * opa[:, None], max=MAX_ALPHA)
    accept = (resp > MIN_RESPONSE) & (alpha > MIN_ALPHA)
    if mode == "grt":
        accept &= ((grd * (-gro_b)).sum(-1) > 0) & (dist <= MAX_SQ_DISTANCE)
    if mode == "grt" or t_max is not None:
        proj = (grd * (-gro_b)).sum(-1)
        hit = torch.linalg.norm(s[:, None] * grd * proj[..., None], dim=-1)
    if t_max is not None:
        tm = t_max[..., None]
        accept &= (tm <= 0) | (hit <= tm)
    alpha = torch.where(accept, alpha, torch.zeros_like(alpha))
    if mode == "gut":
        colour = colour_src[ids][:, None].expand(-1, dirs.shape[1], -1, -1)
    else:
        basis = sh_basis(dirs, sh_degree)
        k = basis.shape[-1]
        colour = torch.clamp(torch.einsum(
            "bpc,bkcx->bpkx", basis, colour_src[ids][:, :, :k]) + 0.5,
            min=0.0)
        key = torch.where(alpha > 0, hit, torch.full_like(hit, math.inf))
        order = torch.argsort(key, dim=-1, stable=True)
        alpha = torch.gather(alpha, -1, order)
        colour = torch.gather(colour, 2, order[..., None].expand_as(colour))
    return blend(alpha, colour, cfg["min_transmittance"])


def blend(alpha, colour, min_transmittance):
    """Front-to-back blend along the last axis of alpha [..., K] (colour
    [..., K, 3]): a hit counts while the transmittance before it exceeds
    `min_transmittance`. Returns (rgb, opacity, final transmittance)."""
    log1m = torch.log1p(-alpha)
    csum = torch.cumsum(log1m, -1)
    t_before = torch.exp(csum - log1m)
    live = t_before > min_transmittance
    wgt = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
    t_final = torch.exp(torch.where(live, log1m, torch.zeros_like(log1m))
                        .sum(-1))
    return (torch.einsum("...k,...kx->...x", wgt, colour), wgt.sum(-1),
            t_final)


class Frame(NamedTuple):
    lists: Tuple[torch.Tensor, torch.Tensor]
    dirs: torch.Tensor
    origin: torch.Tensor
    blocks: list


def prepare_frame(mode: str, a: Acts, cam: Camera, budget: int) -> Frame:
    lists = (gut_lists if mode == "gut" else grt_lists)(a, cam)
    dirs, origin = pixel_rays(cam, a.positions.dtype)
    gx, gy = tile_grid(cam)
    return Frame(lists, dirs, origin, blocks(lists[0], gx * gy, budget))


def block_ids(frame: Frame, blk, n):
    tiles, starts, counts, k = blk
    ar = torch.arange(k, device=tiles.device)
    valid = ar[None] < counts[:, None]
    pos = torch.where(valid, starts[:, None] + ar[None], 0)
    ids = torch.where(valid, frame.lists[1][pos], n)
    return tiles, ids, valid


def colour_source(mode, a: Acts, cam: Camera, sh_degree: int):
    """Per-particle colour toward the camera centre, clamped at use (gut),
    or the SH coefficients themselves (grt)."""
    if mode == "grt":
        return a.features
    d = a.positions - cam.c2w[:3, 3].to(a.positions.dtype)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                        min=1e-12)
    basis = sh_basis(d, sh_degree)
    k = basis.shape[-1]
    rad = torch.einsum("nc,ncx->nx", basis, a.features[:, :k]) + 0.5
    return torch.clamp(rad, min=0.0)


def padded(x, n_extra=1):
    """x with `n_extra` zero rows appended (the padding particle)."""
    return torch.cat([x, x.new_zeros((n_extra,) + x.shape[1:])])


def padded_inputs(a: Acts, colours):
    eye = torch.eye(3, dtype=a.rot.dtype, device=a.rot.device)[None]
    return (padded(a.positions), torch.cat([a.rot, eye]),
            torch.cat([a.scales, a.scales.new_ones(1, 3)]),
            padded(a.opacity), padded(colours))


def to_tiles(img: torch.Tensor, cam: Camera) -> torch.Tensor:
    """[H, W, c] -> [gy*gx, 256, c] on the tile-padded grid (zero pad)."""
    gx, gy = tile_grid(cam)
    c = img.shape[-1]
    pad = img.new_zeros((gy * TILE, gx * TILE, c))
    pad[:cam.height, :cam.width] = img
    t = pad.reshape(gy, TILE, gx, TILE, c).permute(0, 2, 1, 3, 4)
    return t.reshape(gy * gx, TILE * TILE, c)


def to_image(frame: Frame, cam: Camera, parts, channels, fill=0.0):
    gx, gy = tile_grid(cam)
    img = parts[0][1].new_full((gy * gx, TILE * TILE, channels), fill)
    for tiles, val in parts:
        img[tiles] = val
    img = img.reshape(gy, gx, TILE, TILE, channels).permute(0, 2, 1, 3, 4)
    return img.reshape(gy * TILE, gx * TILE, channels)[:cam.height,
                                                       :cam.width]


def render(mode: str, a: Acts, cam: Camera, sh_degree: int,
           budget: int = 1 << 25, t_max=None, min_transmittance=None,
           with_transmittance: bool = False):
    """The frame's pre-background radiance [H, W, 3] (no autograd); with
    `with_transmittance` also its final transmittance [H, W]. `t_max`
    [H, W] bounds each pixel's hits (<= 0: unbounded)."""
    with torch.no_grad():
        frame = prepare_frame(mode, a, cam, budget)
        colours = colour_source(mode, a, cam, sh_degree)
        ins = padded_inputs(a, colours)
        n = a.positions.shape[0]
        tm = None if t_max is None else to_tiles(t_max[..., None], cam)[..., 0]
        parts, trans = [], []
        for blk in frame.blocks:
            tiles, ids, valid = block_ids(frame, blk, n)
            rgb, _, tf = composite_block(
                mode, *ins, ids, valid, frame.dirs[tiles], frame.origin,
                sh_degree, None if tm is None else tm[tiles],
                min_transmittance)
            parts.append((tiles, rgb))
            trans.append((tiles, tf[..., None]))
        img = to_image(frame, cam, parts, 3)
        if not with_transmittance:
            return img
        t_img = to_image(frame, cam, trans, 1, fill=1.0)[..., 0]
        return img, t_img


def render_with_grad(mode: str, a: Acts, cam: Camera, sh_degree: int,
                     image_grad_fn, budget: int = 1 << 24):
    """Render, take the image cotangent image_grad_fn(image) -> (value,
    cotangent [H, W, 3]), and carry it back through every block into the
    activations `a` (which may require grad). Returns the value."""
    frame = prepare_frame(mode, a, cam, budget)
    colours = colour_source(mode, a, cam, sh_degree)
    n = a.positions.shape[0]
    leaves = [x.detach().requires_grad_(True) for x in
              (a.positions, a.rot, a.scales, a.opacity, colours)]
    with torch.no_grad():
        ins = padded_inputs(Acts(*leaves[:4], a.features), leaves[4])
        parts = []
        for blk in frame.blocks:
            tiles, ids, valid = block_ids(frame, blk, n)
            rgb = composite_block(mode, *ins, ids, valid,
                                  frame.dirs[tiles], frame.origin,
                                  sh_degree)[0]
            parts.append((tiles, rgb))
        image = to_image(frame, cam, parts, 3)
    value, g_img = image_grad_fn(image)
    g_tiles = to_tiles(g_img, cam)
    for blk in frame.blocks:
        tiles, ids, valid = block_ids(frame, blk, n)
        ins = padded_inputs(Acts(*leaves[:4], a.features), leaves[4])
        rgb = composite_block(mode, *ins, ids, valid, frame.dirs[tiles],
                              frame.origin, sh_degree)[0]
        torch.autograd.backward(rgb, g_tiles[tiles])
    outs = [a.positions, a.rot, a.scales, a.opacity, colours]
    pairs = [(o, l.grad) for o, l in zip(outs, leaves)
             if o.requires_grad and l.grad is not None]
    if pairs:
        torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
    return value
