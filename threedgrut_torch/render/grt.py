"""3DGRT: volumetric Gaussian tracing of arbitrary rays, port of
threedgrut_tpu/render/grt.py (its default "bundle" route, forward and
backward, and its exact "ray" oracle).

Rays are grouped into bundles of 256. A two-level cone cull (super bundles
of 16 Morton-adjacent bundles, then each bundle against its super's list)
stands in for the reference's BVH and gives every bundle a depth-sorted
candidate list; `flatten_candidates` lays the lists out in one flat array
of 128-row windows (with `flat_cull`, bundle_candidates_twolevel_flat
builds that layout directly from flat super lists; its compact_kernel leg
runs kernel B9, ops/stream_compact.py; with `packed_cull` the two-level
cull sorts single int32 keys of quantized depth and list position,
bundle_candidates_twolevel_packed); `pack_rows64` and a row gather
give each slot its 64-float row; the bundle compositor (kernel B7,
ops/bundle_trace.py) composites each ray front to back with a bounded
per-ray re-sort.

Every stage of the fast path runs under a `torch.profiler.record_function`
label: "3dgrt.cull" (in the flat cull its stages "3dgrt.cull.super",
"3dgrt.cull.super_lists", "3dgrt.cull.members" and "3dgrt.cull.layout"),
"3dgrt.flatten", "3dgrt.pack", "3dgrt.gather", "3dgrt.composite", and in
the backward "3dgrt.bwd_kernel" (B8),
"3dgrt.bwd_compact" and "3dgrt.bwd_unsort" (the sort by particle id and
B6). The culls and the flat layout are discrete decisions and run without
autograd; gradients flow from the five parameter tensors through
`pack_rows64` and the row gather into the compositor, whose backward is
kernel B8. With `walk_capacity`, the gather and the compositor are one
function (ops/fused_raster.composite_bundles) whose backward gathers only
the windows the forward walked.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from threedgrut_torch import constants as C
from threedgrut_torch.ops import bundle_trace, fused_raster, stream_compact
from threedgrut_torch.ops import particles as particle_ops
from threedgrut_torch.ops import quaternion
from threedgrut_torch.ops import sh as sh_ops
from threedgrut_torch.ops.compositing import composite
from threedgrut_torch.ops.sorted_gather import gather_rows

CHUNK = bundle_trace.CHUNK
# A bundle whose rays deviate more than ~72 degrees from the mean axis has
# no usable cone: it accepts every particle.
_MIN_BUNDLE_COS = 0.3
SUPER_MULT = 16


class TraceResult(NamedTuple):
    rgb: torch.Tensor            # [R, 3]
    opacity: torch.Tensor        # [R]
    depth: torch.Tensor          # [R]
    transmittance: torch.Tensor  # [R]
    hit_count: torch.Tensor      # [R]
    overflow: torch.Tensor       # [] bool: a capacity was exceeded
    visibility: torch.Tensor     # [N] bool: entered some candidate list
    normal: Optional[torch.Tensor] = None  # [R, 3] weighted surface normal
    # [nb] int32: each bundle's candidates, clamped to candidate_capacity
    counts: Optional[torch.Tensor] = None


def bounding_radius(scales, opacities, kernel_degree: int,
                    min_alpha: float = C.MIN_ALPHA,
                    min_response: float = C.MIN_KERNEL_RESPONSE,
                    density_clamping: bool = False) -> torch.Tensor:
    """World-space radius of each particle's iso-response surface at the
    acceptance threshold: response * opacity >= min_alpha and response >=
    min_response, canonical squared distance at most 9. With
    `density_clamping` the response floor is raised to
    min(min_response / opacity, 0.97) (eval-time kernel clamping)."""
    s = C.GG_SCALE[kernel_degree]
    opa = torch.clamp(opacities, min=1e-12)
    floor = torch.clamp(min_alpha / opa, min=min_response)
    if density_clamping:
        floor = torch.maximum(floor, torch.clamp(min_response / opa,
                                                 max=0.97))
    floor = torch.clamp(floor, max=0.9999)
    if kernel_degree == 0:
        rc = (1.0 - floor) / (-s)
        d_max = rc * rc
    else:
        d_max = torch.pow(torch.log(floor) / s, 2.0 / kernel_degree)
    d_max = torch.clamp(d_max, max=C.MAX_PARTICLE_SQ_DISTANCE)
    return torch.amax(scales, dim=-1) * torch.sqrt(d_max)


class Bundles(NamedTuple):
    origin: torch.Tensor       # [nb, 3] mean origin
    direction: torch.Tensor    # [nb, 3] unit mean direction
    base_radius: torch.Tensor  # [nb] max |o_r - o_b|
    tan_spread: torch.Tensor   # [nb] max tangent of ray-to-axis angle
    coherent: torch.Tensor     # [nb] bool: the cone test is meaningful
    # [nb] with `spread_origins`: how far behind the mean origin, along
    # the axis, a ray may start. The cone test keeps particles that far
    # behind it. Without (None: the JAX package's test), rays of different
    # origins (a mirror's, a glass ball's) lose the particles that lie in
    # front of a ray's origin but behind the bundle's mean (ROADMAP C17).
    back: Optional[torch.Tensor] = None


def _unit(x, dim=-1):
    return x / torch.clamp(torch.linalg.norm(x, dim=dim, keepdim=True),
                           min=1e-12)


def make_bundles(rays_o, rays_d, bundle_size: int,
                 spread_origins: bool = False) -> Bundles:
    nb = rays_o.shape[0] // bundle_size
    o = rays_o.reshape(nb, bundle_size, 3)
    d = rays_d.reshape(nb, bundle_size, 3)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    ob = o.mean(1)
    db = _unit(d.mean(1))
    base = torch.linalg.norm(o - ob[:, None], dim=-1).amax(1)
    cosang = torch.einsum("nbi,ni->nb", d, db)
    coherent = cosang.amin(1) > _MIN_BUNDLE_COS
    cosang = torch.clamp(cosang, _MIN_BUNDLE_COS, 1.0)
    sinang = torch.sqrt(torch.clamp(1.0 - cosang * cosang, 0.0, 1.0))
    tan = (sinang / cosang).amax(1)
    back = None
    if spread_origins:
        back = torch.clamp(-torch.einsum("nbi,ni->nb", o - ob[:, None],
                                         db).amin(1), min=0.0)
    return Bundles(ob, db, base, tan, coherent, back)


def _cone_hit(positions, radius, valid, bundles: Bundles):
    """Conservative cone test: (hit [nb, N] bool, t_ax [nb, N])."""
    v = positions[None, :, :] - bundles.origin[:, None, :]
    t_ax = torch.einsum("bni,bi->bn", v, bundles.direction)
    d_ax = torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1) - t_ax * t_ax,
                                  min=0.0))
    limit = (radius[None, :] + bundles.base_radius[:, None]
             + torch.clamp(t_ax, min=0.0) * bundles.tan_spread[:, None])
    rear = radius[None, :]
    if bundles.back is not None:
        rear = rear + bundles.back[:, None]
    cone_ok = (d_ax <= limit) & (t_ax >= -rear)
    hit = valid[None, :] & (cone_ok | ~bundles.coherent[:, None])
    return hit, t_ax


def _nearest_first(key, k: int):
    """Indices of the k largest entries of key [..., M] per row, ties to
    the lower index first (XLA's top_k order), as int32."""
    return torch.sort(key, dim=-1, descending=True,
                      stable=True).indices[..., :k].to(torch.int32)


def bundle_candidates(positions, radius, valid, bundles: Bundles,
                      capacity: int):
    """Single-level cone test + per-bundle compaction. Returns (cand_idx
    [nb, capacity] int32 depth-ascending, counts [nb] int32 clamped to
    capacity, overflow [] bool, visibility [N] bool)."""
    hit, t_ax = _cone_hit(positions, radius, valid, bundles)
    counts = hit.sum(1, dtype=torch.int32)
    overflow = (counts > capacity).any()
    key = torch.where(hit, -t_ax, torch.full_like(t_ax, -math.inf))
    k = min(capacity, key.shape[1])
    cand_idx = _nearest_first(key, k)
    if k < capacity:
        cand_idx = torch.nn.functional.pad(cand_idx, (0, capacity - k))
    return (cand_idx, torch.clamp(counts, max=capacity), overflow,
            hit.any(0))


def _morton_16(u: torch.Tensor) -> torch.Tensor:
    """Interleave the low 16 bits of u with zeros (part1by1)."""
    u = (u | (u << 8)) & 0x00FF00FF
    u = (u | (u << 4)) & 0x0F0F0F0F
    u = (u | (u << 2)) & 0x33333333
    u = (u | (u << 1)) & 0x55555555
    return u


def bundle_morton_order(bundles: Bundles) -> torch.Tensor:
    """Permutation [nb] int32 grouping direction-adjacent bundles: Morton
    code of the bundle directions projected onto the plane orthogonal to
    their mean, so consecutive 16 bundles form compact super cones."""
    d = bundles.direction
    dm = _unit(d.mean(0))
    ex = torch.tensor([1.0, 0.0, 0.0], device=d.device)
    ey = torch.tensor([0.0, 1.0, 0.0], device=d.device)
    a = torch.where(torch.abs(dm[0]) < 0.9, ex, ey)
    e1 = _unit(torch.linalg.cross(dm, a))
    e2 = torch.linalg.cross(dm, e1)

    def quant(x):
        lo, hi = x.min(), x.max()
        q = (x - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0
        return q.to(torch.int32)

    code = _morton_16(quant(d @ e1)) | (_morton_16(quant(d @ e2)) << 1)
    return torch.sort(code, stable=True).indices.to(torch.int32)


def make_super_bundles(member: Bundles, perm, super_mult: int) -> Bundles:
    """Super cones bounding every member ray of `super_mult` consecutive
    bundles of the permuted order: the base covers the member origin
    offsets and bases; the spread is the tangent-addition bound with each
    member's axis deviation (a member that makes it meaningless marks the
    super incoherent, which accepts every particle)."""
    nb = member.origin.shape[0]
    ns = nb // super_mult
    p = perm.long()
    o = member.origin[p].reshape(ns, super_mult, 3)
    d = member.direction[p].reshape(ns, super_mult, 3)
    base = member.base_radius[p].reshape(ns, super_mult)
    tan = member.tan_spread[p].reshape(ns, super_mult)
    coh = member.coherent[p].reshape(ns, super_mult)
    os_ = o.mean(1)
    ds = _unit(d.mean(1))
    base_s = (torch.linalg.norm(o - os_[:, None], dim=-1) + base).amax(1)
    back_s = None
    if member.back is not None:
        # A member ray starts within `base` of its member's mean origin.
        back_s = torch.clamp((base - torch.einsum(
            "nmi,ni->nm", o - os_[:, None], ds)).amax(1), min=0.0)
    dot = torch.einsum("nmi,ni->nm", d, ds)
    cosphi = torch.clamp(dot, _MIN_BUNDLE_COS, 1.0)
    tanphi = torch.sqrt(torch.clamp(1.0 - cosphi * cosphi, 0.0, 1.0)) / cosphi
    denom = 1.0 - tan * tanphi
    ok = (denom > 0.2) & (dot > _MIN_BUNDLE_COS)
    tan_s = torch.where(ok, (tan + tanphi) / torch.clamp(denom, min=0.2),
                        torch.zeros_like(tan)).amax(1)
    coherent = (coh & ok).all(1)
    return Bundles(os_, ds, base_s, tan_s, coherent, back_s)


def _members(bundles: Bundles, perm, super_mult: int):
    """Each super's member bundles in the permuted order: origin and
    direction [ns, m, 3], base radius, spread, coherence and back (or
    None) [ns, m]."""
    pl = perm.long()
    ns = pl.shape[0] // super_mult
    return tuple(None if x is None else x[pl].reshape(ns, super_mult,
                                                      *x.shape[1:])
                 for x in (bundles.origin, bundles.direction,
                           bundles.base_radius, bundles.tan_spread,
                           bundles.coherent, bundles.back))


def _member_hits(p_s, r_s, ob, db, base, tan, coh, back):
    """Level 2 of the two-level culls: G groups of K listed particles
    (positions p_s [G, K, 3], radii r_s [G, K]: a super's dense list, or
    one 128-slot window of the flat lists) against the group's m member
    bundles (ob, db [G, m, 3], base, tan, coh, back or None [G, m]).
    Returns (hit [G, m, K] bool, before any slot mask; t_ax [G, m, K]
    member-axis depth). The
    cone test expands |p - o|^2 into dot products (the JAX form), so hits
    at the cone margin are decided by the same arithmetic in every leg."""
    t_ax = (torch.einsum("nsc,nmc->nms", p_s, db)
            - torch.einsum("nmc,nmc->nm", ob, db)[:, :, None])
    pp = torch.sum(p_s * p_s, dim=-1)
    po = torch.einsum("nsc,nmc->nms", p_s, ob)
    oo = torch.sum(ob * ob, dim=-1)
    d_sq = pp[:, None, :] - 2.0 * po + oo[..., None] - t_ax * t_ax
    del po
    d_ax = torch.sqrt(torch.clamp(d_sq, min=0.0))
    del d_sq
    limit = (r_s[:, None, :] + base[..., None]
             + torch.clamp(t_ax, min=0.0) * tan[..., None])
    rear = r_s[:, None, :] if back is None else (r_s[:, None, :]
                                                 + back[..., None])
    cone_ok = (d_ax <= limit) & (t_ax >= -rear)
    del d_ax, limit
    return cone_ok | ~coh[..., None], t_ax


def _inverse(perm):
    """The inverse permutation (int64) of perm [nb]."""
    pl = perm.long()
    inv = torch.empty_like(pl)
    inv[pl] = torch.arange(pl.shape[0], device=pl.device)
    return inv


def _quantized(t, hit, bits: int):
    """Each row's depths t [..., K] quantized to `bits` bits between the
    row's nearest and farthest hit (the JAX package's expressions, so that
    the buckets are its own)."""
    big = 3.4e38
    lo = torch.where(hit, t, torch.full_like(t, big)).amin(-1, keepdim=True)
    hi = torch.where(hit, t, torch.full_like(t, -big)).amax(-1, keepdim=True)
    top = (1 << bits) - 1
    s = top / torch.clamp(hi - lo, min=1e-12)
    return torch.clamp((t - lo) * s, 0, top).to(torch.int32)


def _packed_sort(hit, t, bits: int, pos_bits: int, keep: int):
    """One sort of single int32 keys per row: `bits` bits of quantized
    depth over `pos_bits` bits of list position, misses as _PACKED_FILLER
    (last). Returns the first `keep` keys' positions [..., keep] int32
    (those of the fillers are 2^pos_bits - 1): hits nearest first by bucket,
    a bucket in list order."""
    pos = torch.arange(t.shape[-1], dtype=torch.int32, device=t.device)
    key = torch.where(hit, (_quantized(t, hit, bits) << pos_bits) | pos,
                      torch.full_like(pos, _PACKED_FILLER))
    key = torch.sort(key, dim=-1).values[..., :keep]
    return key & ((1 << pos_bits) - 1)


# The packed culls' key of a miss: above every hit's.
_PACKED_FILLER = 0x7FFFFFFF


def bundle_candidates_twolevel(positions, radius, valid, rays_o, rays_d,
                               bundle_size: int, capacity: int,
                               super_mult: int = SUPER_MULT,
                               super_capacity: int = 8192,
                               spread_origins: bool = False,
                               packed_l1: bool = False):
    """Two-level cull: super bundles of `super_mult` Morton-adjacent
    bundles compact the particles to `super_capacity` candidates each
    (nearest by super-axis depth), then each member bundle tests its
    super's list and sorts its hits by its own axis depth (stable: ties keep
    the super-list order). The super cones bound every member ray, so the
    candidate sets are the single-level ones when no list overflowed;
    `visibility` is the super-level hit, a superset of the single-level one.
    With `packed_l1` (and at most 2^20 particles) the super lists come from
    one sort of int32 keys, 11 bits of quantized super depth over 20 bits
    of particle id, instead of the nearest-first sort: the same sets, and
    within one depth bucket the lists run in id order.

    Returns (cand_idx [nb, L] int32 depth-ascending, counts [nb] int32
    clamped to L = min(capacity, super list width), overflow [] bool (either
    level), visibility [N] bool), in caller bundle order."""
    n = positions.shape[0]
    nb = rays_o.shape[0] // bundle_size
    ns = nb // super_mult
    if ns * super_mult != nb:
        raise ValueError(f"{nb} bundles are not a multiple of {super_mult}")
    s_cap = min(super_capacity, n)
    bundles = make_bundles(rays_o, rays_d, bundle_size, spread_origins)
    perm = bundle_morton_order(bundles)
    sup = make_super_bundles(bundles, perm, super_mult)
    hit1, t_ax1 = _cone_hit(positions, radius, valid, sup)        # [ns, N]
    counts1 = hit1.sum(1, dtype=torch.int32)
    overflow1 = (counts1 > s_cap).any()
    visibility = hit1.any(0)
    if packed_l1 and n <= (1 << 20):
        sup_idx = _packed_sort(hit1, t_ax1, 11, 20, s_cap)
    else:
        sup_idx = _nearest_first(
            torch.where(hit1, -t_ax1, torch.full_like(t_ax1, -math.inf)),
            s_cap)
    del hit1, t_ax1
    sup_mask = (torch.arange(s_cap, device=positions.device)[None, :]
                < torch.clamp(counts1, max=s_cap)[:, None])

    # Level 2: each permuted bundle against its super's list (the packed
    # keys' fillers, past the hits, are masked).
    pr = torch.cat([positions, radius[:, None]], dim=-1)
    pr_s = pr[torch.clamp(sup_idx.reshape(-1), max=n - 1).long()].reshape(
        ns, s_cap, 4)
    hit2, t_ax = _member_hits(pr_s[..., :3], pr_s[..., 3],
                              *_members(bundles, perm, super_mult))
    hit2 &= sup_mask[:, None, :]
    counts2 = hit2.sum(-1, dtype=torch.int32)                    # [ns, m]
    overflow = overflow1 | (counts2 > capacity).any()

    keep = min(capacity, s_cap)
    key2 = torch.where(hit2, t_ax, torch.full_like(t_ax, math.inf))
    del hit2, t_ax
    order = torch.sort(key2, dim=-1, stable=True).indices[..., :keep]
    del key2
    gid = torch.gather(sup_idx[:, None, :].expand(ns, super_mult, s_cap), -1,
                       order)
    cand_idx = gid.reshape(nb, keep)
    counts = torch.clamp(counts2, max=keep).reshape(nb)
    iperm = _inverse(perm)
    return cand_idx[iperm], counts[iperm], overflow, visibility


def bundle_candidates_twolevel_packed(positions, radius, valid, rays_o,
                                      rays_d, bundle_size: int,
                                      capacity: int,
                                      super_mult: int = SUPER_MULT,
                                      super_capacity: int = 8192,
                                      spread_origins: bool = False):
    """The two-level cull with both compaction sorts on single int32 keys:
    level 1 sorts 11 bits of quantized super depth over 20 bits of particle
    id, level 2 13 bits of quantized member depth over 18 bits of super-list
    position. The hit tests are bundle_candidates_twolevel's, so the
    candidate sets are its own; within one depth bucket a list runs in list
    order instead of exact depth (near ties; B7's per-ray re-sort undoes
    most of it but not all, so frames differ somewhat from the exact
    cull's, as the JAX package's do). The lists hold positions into the
    super lists: `resolve_packed` turns a flat layout of them into
    particle ids.

    Returns (cand_local [nb, keep] int32 positions into the bundle's super
    list, counts [nb] int32, overflow [] bool, visibility [N] bool, sup_idx
    [ns, s_cap] int32 particle ids (the key fillers' 2^20 - 1 past each
    list's hits), sup_of [nb] int32 super of each caller-order bundle)."""
    n = positions.shape[0]
    nb = rays_o.shape[0] // bundle_size
    ns = nb // super_mult
    if ns * super_mult != nb:
        raise ValueError(f"{nb} bundles are not a multiple of {super_mult}")
    if n > (1 << 20):
        raise ValueError(f"packed cull: {n} particles exceed the 2^20 that "
                         f"level 1's 20 position bits hold")
    s_cap = min(super_capacity, n)
    if s_cap > (1 << 18):
        raise ValueError(f"packed cull: a super list of {s_cap} exceeds the "
                         f"2^18 that level 2's 18 position bits hold")
    bundles = make_bundles(rays_o, rays_d, bundle_size, spread_origins)
    perm = bundle_morton_order(bundles)
    sup = make_super_bundles(bundles, perm, super_mult)
    hit1, t_ax1 = _cone_hit(positions, radius, valid, sup)        # [ns, N]
    counts1 = hit1.sum(1, dtype=torch.int32)
    overflow1 = (counts1 > s_cap).any()
    visibility = hit1.any(0)
    sup_idx = _packed_sort(hit1, t_ax1, 11, 20, s_cap)           # [ns, s_cap]
    del hit1, t_ax1
    sup_mask = (torch.arange(s_cap, device=positions.device)[None, :]
                < torch.clamp(counts1, max=s_cap)[:, None])

    pr = torch.cat([positions, radius[:, None]], dim=-1)
    pr_s = pr[torch.clamp(sup_idx.reshape(-1), max=n - 1).long()].reshape(
        ns, s_cap, 4)
    hit2, t_ax = _member_hits(pr_s[..., :3], pr_s[..., 3],
                              *_members(bundles, perm, super_mult))
    hit2 &= sup_mask[:, None, :]
    counts2 = hit2.sum(-1, dtype=torch.int32)                    # [ns, m]
    overflow = overflow1 | (counts2 > capacity).any()
    keep = min(capacity, s_cap)
    cand_local = _packed_sort(hit2, t_ax, 13, 18, keep).reshape(nb, keep)
    counts = torch.clamp(counts2, max=keep).reshape(nb)
    iperm = _inverse(perm)
    sup_of = (iperm // super_mult).to(torch.int32)
    return (cand_local[iperm], counts[iperm], overflow, visibility, sup_idx,
            sup_of)


def resolve_packed(flat_local, valid, win_bundle, sup_idx, sup_of):
    """The packed cull's flat layout of super-list positions -> particle
    ids: one gather of flat size (slots that hold no candidate take 0)."""
    s_cap = sup_idx.shape[1]
    sup_slot = sup_of.long()[win_bundle.long()]                    # [nw]
    g = (sup_slot * s_cap).repeat_interleave(CHUNK) + flat_local.long()
    return torch.where(valid, sup_idx.reshape(-1)[g],
                       torch.zeros_like(flat_local))


def _segments(counts, capacity: int):
    """The CHUNK-aligned flat layout of segments of `counts` rows in order:
    segment b occupies ceil(counts[b] / CHUNK) * CHUNK rows from offs[b].
    Returns (offs [nb] int64, valid [capacity] bool, win_starts [nb]
    int32, win_ends [nb] int32, overflow [] bool, owner [capacity / CHUNK]
    int64, local [capacity / CHUNK, CHUNK] int64): owner is the last
    segment starting at or before each window (windows past the total
    report the last segment), local a slot's row within its owner. Rows
    past `capacity` are dropped: a straddling segment keeps its first rows.

    The JAX package fills the owner per window with a scatter-max that
    clips a trailing empty segment's start onto the last window; when the
    total lands exactly on the capacity that window then takes the empty
    segment's extents (ROADMAP C3, C6). Taking the last segment that
    starts at or before the window does not."""
    cap = int(capacity)
    if cap % CHUNK:
        raise ValueError(f"flat capacity {cap} is not a multiple of {CHUNK}")
    dev = counts.device
    counts = counts.to(torch.int64)
    padded = -(-counts // CHUNK) * CHUNK
    ends = torch.cumsum(padded, 0)
    offs = ends - padded
    nw = cap // CHUNK
    offw = offs // CHUNK
    owner = torch.searchsorted(offw, torch.arange(nw, device=dev),
                               right=True) - 1
    local = (torch.arange(cap, device=dev).reshape(nw, CHUNK)
             - offs[owner][:, None])
    valid = (local < counts[owner][:, None]).reshape(cap)
    return (offs, valid, torch.clamp(offw, max=nw).to(torch.int32),
            torch.clamp(ends // CHUNK, max=nw).to(torch.int32),
            ends[-1] > cap, owner, local)


def flatten_candidates(cand_idx, counts, flat_capacity: int):
    """Per-bundle candidate lists -> one flat layout of CHUNK-row windows.

    Bundle b occupies ceil(counts[b] / CHUNK) * CHUNK contiguous rows (an
    empty bundle none), in bundle order (`_segments`, without the JAX
    package's fault C6). Returns (flat_idx [capF] int32, valid [capF] bool,
    win_starts [nb] int32, win_ends [nb] int32, overflow [] bool,
    win_bundle [capF / CHUNK] int32 owning bundle per window). Under
    overflow, rows past capF are dropped: a straddling bundle keeps its
    nearest candidates, later bundles render empty."""
    L = cand_idx.shape[1]
    (_, valid, win_starts, win_ends, overflow, owner,
     local) = _segments(torch.clamp(counts, max=L), flat_capacity)
    src = owner[:, None] * L + torch.clamp(local, 0, L - 1)
    flat_idx = torch.where(valid.reshape(src.shape),
                           cand_idx.reshape(-1)[src], 0)
    return (flat_idx.reshape(-1).to(torch.int32), valid, win_starts,
            win_ends, overflow, owner.to(torch.int32))


def _bundle_counts(valid, win_starts, win_ends):
    """Per-bundle candidate counts [nb] int32 of a flat layout: its valid
    rows over each bundle's windows."""
    per_w = valid.reshape(-1, CHUNK).sum(1)
    cum = torch.cat([per_w.new_zeros(1), torch.cumsum(per_w, 0)])
    return (cum[win_ends.long()] - cum[win_starts.long()]).to(torch.int32)


def _super_lists_expand(hit1, counts1, s_cap: int, capS: int):
    """Flat super lists in ascending particle id, straight from the level-1
    hit mask [ns, N] (no depth sort): super s lists its first min(counts1[s],
    s_cap) hits in id order (the lowest ids are kept under truncation, which
    the caller flags) in its CHUNK-aligned segment of the `capS` rows.
    Downstream the super-list order is only the tie-break of each bundle's
    depth sort. Counts and ranks are integers (the JAX package's f32 window
    cumsum, ROADMAP C1, is exact only below 2^24 hits).

    Returns (flat_sup [capS] int32, valid_s [capS] bool, sup_ws [ns] int32,
    sup_we [ns] int32, overflow [] bool (the layout exceeds capS),
    win_sup [capS / CHUNK] int32 owning super per window)."""
    c1 = counts1.to(torch.int64)
    (offs, valid_s, sup_ws, sup_we, overflow, win_sup,
     _) = _segments(torch.clamp(c1, max=s_cap), capS)
    s, p = hit1.nonzero(as_tuple=True)
    rank = torch.arange(s.shape[0], device=s.device) - (
        torch.cumsum(c1, 0) - c1)[s]
    dest = offs[s] + rank
    keep = (rank < s_cap) & (dest < capS)
    flat_sup = torch.zeros(capS, dtype=torch.int32, device=hit1.device)
    flat_sup[dest[keep]] = p[keep].to(torch.int32)
    return (flat_sup, valid_s, sup_ws, sup_we, overflow,
            win_sup.to(torch.int32))


def _stable_lexsort(major, minor):
    """Indices that sort by (major, minor), ties in input order."""
    order = torch.sort(minor, dim=-1, stable=True).indices
    return torch.gather(order, -1, torch.sort(
        torch.gather(major, -1, order), dim=-1, stable=True).indices)


def _flat_pairs_expand_sort(flat_sup, hit2, t_ax, win_sup, counts2,
                            capacity: int, flat_capacity: int):
    """The default layout leg: the true (slot, member) hit pairs, taken in
    (member, window, slot) order, are already grouped by bundle o = member
    * ns + super in super-list order; a pair whose rank in its bundle is at
    or past `capacity` is dropped (the first hits are kept; flagged
    upstream), and one stable (bundle, depth) sort puts each bundle's pairs
    in depth order, ties in super-list order. Returns (flat_idx, valid,
    win_starts, win_ends, overflow) in (member, super) bundle order."""
    ns, m = counts2.shape
    per_o = counts2.t().reshape(-1).to(torch.int64)
    counts_o = torch.clamp(per_o, max=capacity)
    (offs, valid, ws_o, we_o, overflow, _,
     _) = _segments(counts_o, flat_capacity)
    mem, w, j = hit2.transpose(0, 1).nonzero(as_tuple=True)
    o = mem * ns + win_sup.long()[w]
    rank = torch.arange(o.shape[0], device=o.device) - (
        torch.cumsum(per_o, 0) - per_o)[o]
    keep = rank < capacity
    o, mem, w, j = o[keep], mem[keep], w[keep], j[keep]
    order = _stable_lexsort(o, t_ax[w, mem, j])
    o = o[order]
    dest = offs[o] + torch.arange(o.shape[0], device=o.device) - (
        torch.cumsum(counts_o, 0) - counts_o)[o]
    inside = dest < flat_capacity
    flat_idx = torch.zeros(flat_capacity, dtype=torch.int32,
                           device=flat_sup.device)
    flat_idx[dest[inside]] = flat_sup[(w * CHUNK + j)[order][inside]]
    return flat_idx, valid, ws_o, we_o, overflow


def _flat_member_sort(flat_sup, hit2, t_ax, win_sup, sup_ws, counts2,
                      capacity: int, flat_capacity: int):
    """The expand_sort=False leg: a stable sort of each member's column of
    the flat super lists by (super, depth; misses at FILL_DEPTH) puts each
    (member, super) bundle's hits first in its super's segment, in depth
    order with ties in super-list order (a capacity overflow keeps the
    nearest). Returns what _flat_pairs_expand_sort returns."""
    ns, m = counts2.shape
    nws = hit2.shape[0]
    capS = nws * CHUNK
    dep = torch.where(hit2, t_ax,
                      torch.full_like(t_ax, stream_compact.FILL_DEPTH))
    dep = dep.transpose(0, 1).reshape(m, capS)
    supk = win_sup.long().repeat_interleave(CHUNK).expand(m, capS)
    gid_sorted = flat_sup[_stable_lexsort(supk, dep)]        # [m, capS]
    counts_o = torch.clamp(counts2.t().reshape(-1), max=capacity)
    (_, valid, ws_o, we_o, overflow, owner,
     local) = _segments(counts_o, flat_capacity)
    src = sup_ws.long()[owner % ns][:, None] * CHUNK + local
    flat_idx = torch.where(
        valid.reshape(src.shape),
        gid_sorted[(owner // ns)[:, None], torch.clamp(src, max=capS - 1)],
        0)
    return flat_idx.reshape(-1), valid, ws_o, we_o, overflow


def _flat_compact(flat_sup, hit2, t_ax, sup_ws, sup_we, counts2,
                  capacity: int, flat_capacity: int):
    """The compact_kernel leg: kernel B9 left-packs each (super, member)
    stream's hits into its own CHUNK-aligned windows in super-list order
    (as many as the windows of its clamped count hold), then one stable
    sort of the
    `flat_capacity` slots by (owning bundle, depth) restores each
    bundle's depth order, ties in super-list order. Returns what
    _flat_pairs_expand_sort returns, in (super, member) bundle order."""
    m = counts2.shape[1]
    counts_o = torch.clamp(counts2.reshape(-1), max=capacity)
    (_, valid, ws_o, we_o, overflow, owner,
     _) = _segments(counts_o, flat_capacity)
    bits = (hit2.to(torch.int32) << torch.arange(
        m, dtype=torch.int32, device=hit2.device)[None, :, None]).sum(
            1, dtype=torch.int32)                                  # [nws, 128]
    # Each stream writes its bundle's windows [ws_o, we_o).
    gid, dep = stream_compact.compact_streams(
        flat_sup, bits.reshape(-1), t_ax.contiguous(), sup_ws, sup_we, ws_o,
        we_o, flat_capacity)
    order = _stable_lexsort(owner.repeat_interleave(CHUNK), dep)
    return gid[order], valid, ws_o, we_o, overflow


def bundle_candidates_twolevel_flat(
        positions, radius, valid, rays_o, rays_d, bundle_size: int,
        capacity: int, super_mult: int = SUPER_MULT,
        super_capacity: int = 8192, super_flat_capacity: Optional[int] = None,
        flat_capacity: Optional[int] = None,
        compact_kernel: Optional[bool] = None, expand_sort: bool = True):
    """The two-level cull with flat super lists: the candidate sets and the
    per-bundle depth order (ties in super-list order) of
    bundle_candidates_twolevel, laid out directly as the compositor's flat
    products. Super lists are compacted into `super_flat_capacity` rows
    (None: the dense worst case ns * ceil(s_cap / 128) * 128), the level-2
    cone test runs per (flat super slot, member), and the bundle lists land
    in `flat_capacity` rows (None: nb * ceil(min(capacity, s_cap) / 128) *
    128). Three legs build the bundle lists:

      * `expand_sort=True` (default): super lists in particle-id order
        (`_super_lists_expand`), then `_flat_pairs_expand_sort`;
      * `expand_sort=False`: depth-ordered super lists, then
        `_flat_member_sort`;
      * `compact_kernel=True`: depth-ordered super lists, then kernel B9
        (`_flat_compact`). None means off, as in the JAX package.

    Under a flagged per-bundle capacity overflow the default leg keeps
    each bundle's first `capacity` hits in super-list order, the B9 leg the
    nearest `capacity` of its first ceil(capacity / 128) * 128, the member
    sort the nearest (the JAX package's legs do the same). Returns (flat_idx [capF] int32, valid [capF] bool, win_starts
    [nb] int32, win_ends [nb] int32, overflow [] bool, visibility [N]
    bool (the super-level hit)) with win_* in caller bundle order."""
    n = positions.shape[0]
    nb = rays_o.shape[0] // bundle_size
    m = super_mult
    ns = nb // m
    if ns * m != nb:
        raise ValueError(f"{nb} bundles are not a multiple of {m}")
    s_cap = min(super_capacity, n)
    if super_flat_capacity is None:
        super_flat_capacity = ns * (-(-s_cap // CHUNK) * CHUNK)
    capS = int(super_flat_capacity)
    if flat_capacity is None:
        flat_capacity = nb * (-(-min(capacity, s_cap) // CHUNK) * CHUNK)
    capF = int(flat_capacity)
    with record_function("3dgrt.cull.super"):
        bundles = make_bundles(rays_o, rays_d, bundle_size)
        perm = bundle_morton_order(bundles)
        sup = make_super_bundles(bundles, perm, m)
        hit1, t_ax1 = _cone_hit(positions, radius, valid, sup)    # [ns, N]
        counts1 = hit1.sum(1, dtype=torch.int32)
        overflow = (counts1 > s_cap).any()
        visibility = hit1.any(0)
    with record_function("3dgrt.cull.super_lists"):
        if expand_sort and not compact_kernel:
            lists = _super_lists_expand(hit1, counts1, s_cap, capS)
        else:
            lists = flatten_candidates(_nearest_first(
                torch.where(hit1, -t_ax1, torch.full_like(t_ax1, -math.inf)),
                s_cap), counts1, capS)
        del hit1, t_ax1
        flat_sup, valid_s, sup_ws, sup_we, ovf_s, win_sup = lists
        overflow = overflow | ovf_s
    with record_function("3dgrt.cull.members"):
        nws = capS // CHUNK
        pr = torch.cat([positions, radius[:, None]], dim=-1)[flat_sup.long()]
        ws = win_sup.long()
        hit2, t_ax = _member_hits(
            pr[:, :3].reshape(nws, CHUNK, 3), pr[:, 3].reshape(nws, CHUNK),
            *(None if x is None else x[ws]
              for x in _members(bundles, perm, m)))
        del pr
        hit2 &= valid_s.reshape(nws, 1, CHUNK)                  # [nws, m, 128]
        # Each super's hits per member: its windows' counts (windows past
        # the lists hold none). A cumsum down the [nws, m] counts would
        # scan the windows serially on the card.
        counts2 = torch.zeros((ns, m), dtype=torch.int64,
                              device=hit2.device).index_add_(
            0, ws, hit2.sum(-1))                                # [ns, m]
        overflow = overflow | (counts2 > capacity).any()
    iperm = _inverse(perm)
    with record_function("3dgrt.cull.layout"):
        if compact_kernel:
            out = _flat_compact(flat_sup, hit2, t_ax, sup_ws, sup_we, counts2,
                                capacity, capF)
            o_of = iperm                                # (super, member)
        else:
            if expand_sort:
                out = _flat_pairs_expand_sort(flat_sup, hit2, t_ax, win_sup,
                                              counts2, capacity, capF)
            else:
                out = _flat_member_sort(flat_sup, hit2, t_ax, win_sup, sup_ws,
                                        counts2, capacity, capF)
            o_of = (iperm % m) * ns + iperm // m        # (member, super)
    flat_idx, valid_f, ws_o, we_o, ovf_f = out
    return (flat_idx, valid_f, ws_o[o_of], we_o[o_of], overflow | ovf_f,
            visibility)


def pack_rows64(positions, quats, scales, opacities, features):
    """[N, 64] rows for the bundle compositor (ops/bundle_trace.py layout):
    A = diag(1/scale) R^T (9), mean (3), opacity, 3 zeros, then the first
    16 SH coefficients of red, green and blue (zeros past K)."""
    n = positions.shape[0]
    R = quaternion.to_rotation_matrix(quats)
    A = R.transpose(-1, -2) / scales[..., :, None]
    k = features.shape[1]
    coeffs = (torch.cat([features, features.new_zeros(n, 16 - k, 3)], 1)
              if k < 16 else features[:, :16])
    return torch.cat([A.reshape(n, 9), positions, opacities[:, None],
                      positions.new_zeros(n, 3), coeffs[:, :, 0],
                      coeffs[:, :, 1], coeffs[:, :, 2]], dim=-1)


class BundleInputs(NamedTuple):
    """The bundle compositor's inputs for a set of rays (grt.prepare)."""
    rays: torch.Tensor        # [nb, 8, 256] o, d (0 if inactive), t_max, T0
    win_starts: torch.Tensor  # [nb] int32
    win_ends: torch.Tensor    # [nb] int32
    overflow: torch.Tensor    # [] bool
    visibility: torch.Tensor  # [N] bool, cone level
    counts: torch.Tensor      # [nb] int32 candidates per bundle
    rows64: torch.Tensor      # [N, 64] packed rows (pack_rows64)
    flat_idx: torch.Tensor    # [capF] int32 particle id per flat slot
    valid: torch.Tensor       # [capF] bool: the slot holds a candidate


def _rays_unit(rays_d):
    dnorm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return rays_d / torch.clamp(dnorm, min=1e-12), dnorm[..., 0] > 1e-12


def _two_level(n: int, nb: int, super_capacity: int,
               two_level_above: Optional[int]) -> bool:
    """Whether the two-level cull pays: more particles than
    `two_level_above` (None: super_capacity, the JAX package's rule), nb a
    multiple of 16 and at least 32."""
    above = super_capacity if two_level_above is None else two_level_above
    return n > above and nb % SUPER_MULT == 0 and nb >= 2 * SUPER_MULT


def candidate_lists(positions, radius, valid, rays_o, rays_d,
                    bundle_size: int, candidate_capacity: int,
                    super_capacity: int = 8192,
                    two_level_above: Optional[int] = None,
                    spread_origins: bool = False, packed_l1: bool = False):
    """Per-bundle candidate lists (bundle_candidates' outputs): the two-level
    cull when it pays (`_two_level`; `packed_l1` packs its level-1 sort),
    else the single-level one."""
    nb = rays_o.shape[0] // bundle_size
    if _two_level(positions.shape[0], nb, super_capacity, two_level_above):
        return bundle_candidates_twolevel(
            positions, radius, valid, rays_o, rays_d, bundle_size,
            candidate_capacity, super_capacity=super_capacity,
            spread_origins=spread_origins, packed_l1=packed_l1)
    return bundle_candidates(
        positions, radius, valid,
        make_bundles(rays_o, rays_d, bundle_size, spread_origins),
        candidate_capacity)


def _cull_inputs(positions, scales, opacities, rays_dn, active,
                 kernel_degree, density_clamping):
    """(positions, bounding radii, valid, directions) for the culls,
    detached: inactive rays take a fixed direction."""
    radius = bounding_radius(scales, opacities, kernel_degree,
                             density_clamping=density_clamping)
    d_safe = torch.where(active[:, None], rays_dn,
                         torch.full_like(rays_dn, 1.0 / math.sqrt(3.0)))
    return positions.detach(), radius, opacities >= C.MIN_ALPHA, d_safe


def _cull(positions, scales, opacities, rays_o, rays_dn, active,
          kernel_degree, bundle_size, candidate_capacity, super_capacity,
          density_clamping, two_level_above=None, spread_origins=False,
          packed_l1=False):
    """`candidate_lists` of the particles' bounding radii, without
    autograd."""
    with torch.no_grad(), record_function("3dgrt.cull"):
        p, radius, valid, d_safe = _cull_inputs(
            positions, scales, opacities, rays_dn, active, kernel_degree,
            density_clamping)
        return candidate_lists(p, radius, valid, rays_o, d_safe,
                               bundle_size, candidate_capacity,
                               super_capacity, two_level_above,
                               spread_origins, packed_l1)


def prepare(positions, quats, scales, opacities, features, rays_o, rays_d,
            kernel_degree: int = C.KERNEL_DEGREE_3DGRT,
            candidate_capacity: int = 2048, initial_transmittance=1.0,
            t_max=None, density_clamping: bool = False,
            super_capacity: int = 8192,
            flat_capacity: Optional[int] = None,
            two_level_above: Optional[int] = None,
            flat_cull: bool = False,
            super_flat_capacity: Optional[int] = None,
            spread_origins: bool = False, packed_cull: bool = False,
            packed_l1: bool = False) -> BundleInputs:
    """Everything of the bundle route before the row gather (256-ray
    bundles): cull, flat layout, packed rows and rays. With `flat_cull`
    and the two-level condition the flat cull
    (bundle_candidates_twolevel_flat, `super_flat_capacity` rows of super
    lists) gives the flat layout directly; it does not take
    `spread_origins` (ValueError). Otherwise, with `packed_cull` and the
    two-level condition, the packed cull (bundle_candidates_twolevel_packed)
    lists super-list positions, which `resolve_packed` turns into particle
    ids after the flat layout; `packed_l1` packs the two-level cull's
    level-1 sort only. Differentiable in the five parameter tensors through
    the packed rows."""
    if flat_cull and spread_origins:
        raise ValueError("flat_cull does not take spread_origins: its cone "
                         "tests keep JAX's rear bound (ROADMAP C17)")
    r_total = rays_o.shape[0]
    nb = r_total // 256
    dev = rays_o.device
    rays_dn, active = _rays_unit(rays_d)
    two_level = _two_level(positions.shape[0], nb, super_capacity,
                           two_level_above)
    resolver = None
    if flat_cull and two_level:
        with torch.no_grad(), record_function("3dgrt.cull"):
            p, radius, valid, d_safe = _cull_inputs(
                positions, scales, opacities, rays_dn, active, kernel_degree,
                density_clamping)
            (flat_idx, valid, win_starts, win_ends, overflow,
             visibility) = bundle_candidates_twolevel_flat(
                p, radius, valid, rays_o, d_safe, 256, candidate_capacity,
                super_capacity=super_capacity,
                super_flat_capacity=super_flat_capacity,
                flat_capacity=flat_capacity)
            counts = _bundle_counts(valid, win_starts, win_ends)
    else:
        if packed_cull and two_level:
            with torch.no_grad(), record_function("3dgrt.cull"):
                p, radius, valid, d_safe = _cull_inputs(
                    positions, scales, opacities, rays_dn, active,
                    kernel_degree, density_clamping)
                (cand_idx, counts, overflow, visibility,
                 *resolver) = bundle_candidates_twolevel_packed(
                    p, radius, valid, rays_o, d_safe, 256,
                    candidate_capacity, super_capacity=super_capacity,
                    spread_origins=spread_origins)
        else:
            cand_idx, counts, overflow, visibility = _cull(
                positions, scales, opacities, rays_o, rays_dn, active,
                kernel_degree, 256, candidate_capacity, super_capacity,
                density_clamping, two_level_above, spread_origins, packed_l1)
        if flat_capacity is None:
            flat_capacity = nb * (-(-cand_idx.shape[1] // CHUNK) * CHUNK)
        with torch.no_grad(), record_function("3dgrt.flatten"):
            (flat_idx, valid, win_starts, win_ends, ovf_flat,
             win_bundle) = flatten_candidates(cand_idx, counts, flat_capacity)
            overflow = overflow | ovf_flat
            if resolver:
                flat_idx = resolve_packed(flat_idx, valid, win_bundle,
                                          *resolver)
    with record_function("3dgrt.pack"):
        rows64 = pack_rows64(positions, quats, scales, opacities, features)
        t0 = _per_ray(initial_transmittance, r_total, 1.0, dev)
        if t_max is None:
            tmx = torch.zeros(r_total, device=dev)
        else:
            tmx = _per_ray(t_max, r_total, 0.0, dev)
            tmx = torch.where(torch.isfinite(tmx), tmx, torch.zeros_like(tmx))
        rays = torch.cat([
            rays_o, torch.where(active[:, None], rays_dn,
                                torch.zeros_like(rays_dn)),
            tmx[:, None], t0[:, None]], dim=-1)
        rays = rays.reshape(nb, 256, 8).transpose(1, 2).contiguous()
    return BundleInputs(rays, win_starts, win_ends, overflow, visibility,
                        counts, rows64, flat_idx, valid)


def gather_candidates(inp: BundleInputs) -> torch.Tensor:
    """The compositor's candidate rows [capF, 64]: the packed rows gathered
    into the flat layout (gather_rows, whose backward is the sort by
    particle id and B6), with the opacity (channel 12) of the slots that
    hold no candidate set to 0."""
    with record_function("3dgrt.gather"):
        data = gather_rows(inp.rows64, inp.flat_idx)
        valid = inp.valid.to(data.dtype)
        if data.requires_grad:
            # Out of place, so that autograd records it (a copy of the
            # rows; a trace without gradients masks in place).
            return torch.cat([data[:, :12], data[:, 12:13] * valid[:, None],
                              data[:, 13:]], dim=1)
        data[:, 12] *= valid
        return data


def trace(positions, quats, scales, opacities, features, rays_o, rays_d,
          sh_degree: int = 3, kernel_degree: int = C.KERNEL_DEGREE_3DGRT,
          min_transmittance: float = C.MIN_TRANSMITTANCE_3DGRT,
          bundle_size: int = 256, candidate_capacity: int = 2048,
          initial_transmittance=1.0, t_max=None,
          return_normals: bool = False, density_clamping: bool = False,
          order: str = "bundle", surfel: bool = False,
          sorted_passes: int = C.GRT_SORTED_PASSES,
          super_capacity: int = 8192, flat_capacity: Optional[int] = None,
          packed_cull: bool = False, packed_l1: bool = False,
          flat_cull: bool = False,
          super_flat_capacity: Optional[int] = None,
          walk_capacity: Optional[int] = None,
          two_level_above: Optional[int] = None,
          spread_origins: bool = False) -> TraceResult:
    """Trace arbitrary rays through the particles, on the device of the
    inputs (post-activation tensors).

    R must be a multiple of `bundle_size`. Rays with a zero direction are
    inactive and return zeros (transmittance `initial_transmittance`).
    `initial_transmittance` (a float or [R]) starts each ray's
    transmittance; `t_max` [R] bounds its segment (hit_t <= t_max; on the
    bundle route a bound <= 0 or not finite means unbounded).

    `order="bundle"` (the default) composites each bundle's candidates
    through kernel B7 in bundle-axis depth order, re-sorted per ray by
    `sorted_passes` odd-even transposition passes inside each 128-row
    window (exact whenever a ray's inversions span at most that many
    positions). `order="ray"` is the exact per-ray sort in plain torch (the
    oracle); `return_normals` and `surfel` take it too.

    `flat_capacity` bounds the total flat candidate rows (a multiple of
    128; None = nb * candidate list width); overflow of it, of a bundle's
    `candidate_capacity` or of a super list's `super_capacity` is reported
    in `overflow`: grow and trace again. `visibility` is the cone-level bit
    (the particle entered some candidate list), a superset of the hits.
    `spread_origins` (rays of many origins, such as secondary rays) makes
    the cone tests keep the particles that lie behind a bundle's mean
    origin but in front of one of its rays' (the JAX package's drop them,
    ROADMAP C17); the bundle route's flat cull does not take it
    (ValueError).
    The two-level cull runs above `two_level_above` particles (None:
    above super_capacity, the JAX package's rule). With `flat_cull` the
    bundle route's two-level cull is the flat one
    (bundle_candidates_twolevel_flat: the same candidates and order, laid
    out directly in the flat layout; its super lists take
    `super_flat_capacity` rows, None the dense worst case); the ray route
    ignores it, as the JAX package does. Otherwise `packed_cull` makes the
    bundle route's two-level cull the packed one
    (bundle_candidates_twolevel_packed: the same candidate sets, each list
    ordered by quantized depth, near ties in list order); `packed_l1` packs
    only the two-level cull's level-1 sort, on either route (the ray route
    ignores `packed_cull`, as the JAX package does).

    The bundle route is differentiable in the five parameter tensors: B8
    is the compositor's backward, and the row gather's is the sort by
    particle id and B6. With `walk_capacity` in (0, capF) (a multiple of
    256) the gather and compositor are fused_raster.composite_bundles,
    whose backward sums only the rows of the windows the forward walked
    when they fit in walk_capacity rows."""
    if order not in ("bundle", "ray"):
        raise ValueError(f"unknown order {order!r}")
    r_total = rays_o.shape[0]
    if r_total % bundle_size:
        raise ValueError(f"{r_total} rays are not a multiple of the bundle "
                         f"size {bundle_size}")
    if (order == "bundle" and not return_normals and bundle_size == 256
            and not surfel):
        inp = prepare(positions, quats, scales, opacities, features, rays_o,
                      rays_d, kernel_degree, candidate_capacity,
                      initial_transmittance, t_max, density_clamping,
                      super_capacity, flat_capacity, two_level_above,
                      flat_cull, super_flat_capacity, spread_origins,
                      packed_cull, packed_l1)
        fused = (walk_capacity is not None
                 and 0 < walk_capacity < inp.flat_idx.shape[0])
        if fused:
            with record_function("3dgrt.composite"):
                out = fused_raster.composite_bundles(
                    inp.rows64, inp.flat_idx, inp.valid, inp.rays,
                    inp.win_starts, inp.win_ends, kernel_degree, sh_degree,
                    min_transmittance, sorted_passes=sorted_passes,
                    walk_capacity=walk_capacity)
        else:
            data = gather_candidates(inp)
            with record_function("3dgrt.composite"):
                out = bundle_trace.bundle_composite(
                    data, inp.rays, inp.win_starts, inp.win_ends,
                    kernel_degree, sh_degree, min_transmittance,
                    sorted_passes=sorted_passes)

        def unrow(i):
            return out[:, i, :].reshape(r_total)

        return TraceResult(
            rgb=out[:, 0:3, :].transpose(1, 2).reshape(r_total, 3),
            opacity=unrow(3), depth=unrow(4), transmittance=unrow(5),
            hit_count=unrow(6), overflow=inp.overflow,
            visibility=inp.visibility, counts=inp.counts)
    rays_dn, active = _rays_unit(rays_d)
    cand_idx, counts, overflow, visibility = _cull(
        positions, scales, opacities, rays_o, rays_dn, active, kernel_degree,
        bundle_size, candidate_capacity, super_capacity, density_clamping,
        two_level_above, spread_origins, packed_l1)
    return _trace_ray_order(
        positions, quats, scales, opacities, features, rays_o, rays_dn,
        active, cand_idx, counts, overflow, visibility, sh_degree,
        kernel_degree, min_transmittance, bundle_size, candidate_capacity,
        initial_transmittance, t_max, return_normals, surfel)


def _per_ray(x, r_total: int, fill: float, device):
    if x is None:
        return torch.full((r_total,), fill, device=device)
    if isinstance(x, (int, float)):
        return torch.full((r_total,), float(x), device=device)
    return torch.as_tensor(x, dtype=torch.float32,
                           device=device).reshape(r_total)


def _trace_ray_order(positions, quats, scales, opacities, features, rays_o,
                     rays_dn, active, cand_idx, counts, overflow, visibility,
                     sh_degree, kernel_degree, min_transmittance,
                     bundle_size, candidate_capacity, initial_transmittance,
                     t_max, return_normals, surfel):
    """The oracle: per bundle, every (ray, candidate) pair with the exact
    per-ray depth sort, composited by ops/compositing.composite."""
    r_total = rays_o.shape[0]
    nb = r_total // bundle_size
    dev = rays_o.device
    keepc = min(candidate_capacity, cand_idx.shape[1])
    cand_idx = cand_idx[:, :keepc].long()
    cand_mask = (torch.arange(keepc, device=dev)[None, :]
                 < torch.clamp(counts, max=keepc)[:, None])
    t0_all = _per_ray(initial_transmittance, r_total, 1.0, dev)
    tmx_all = _per_ray(t_max, r_total, math.inf, dev)
    outs = []
    for b in range(nb):
        sl = slice(b * bundle_size, (b + 1) * bundle_size)
        ci, cm = cand_idx[b], cand_mask[b]
        o, d, act = rays_o[sl], rays_dn[sl], active[sl]
        p, q, s = positions[ci], quats[ci], scales[ci]
        op = torch.where(cm, opacities[ci], torch.zeros_like(opacities[ci]))
        f = features[ci]
        hit = particle_ops.particle_hit(
            p[None], q[None], s[None], op[None], o[:, None], d[:, None],
            kernel_degree, surfel=surfel)
        gate = ((hit.proj > 0.0) & (hit.gray_dist <= C.MAX_PARTICLE_SQ_DISTANCE)
                & (hit.hit_t <= tmx_all[sl][:, None]) & cm[None, :]
                & act[:, None])
        alpha = torch.where(gate, hit.alpha, torch.zeros_like(hit.alpha))
        colors = sh_ops.radiance_from_sh(
            sh_degree, f[None], d[:, None, :].expand(bundle_size, keepc, 3))
        sort_t = torch.where(alpha > 0.0, hit.hit_t,
                             torch.full_like(alpha, math.inf))
        order = torch.argsort(sort_t, dim=-1, stable=True)
        res = composite(torch.gather(alpha, -1, order),
                        torch.gather(colors, 1, order[..., None].expand(
                            -1, -1, 3)),
                        torch.gather(hit.hit_t, -1, order), min_transmittance,
                        t0_all[sl])
        if return_normals:
            nrm = particle_ops.particle_normal(
                p[None], q[None], s[None], o[:, None], d[:, None],
                surfel=surfel)
            nrm_s = torch.gather(nrm, 1, order[..., None].expand(-1, -1, 3))
            normal = torch.einsum("bk,bkc->bc", res.weights, nrm_s)
        else:
            normal = torch.zeros((bundle_size, 3), device=dev)
        outs.append((res.rgb, res.opacity, res.depth, res.transmittance,
                     res.hit_count.to(torch.float32), normal))
    rgb, opa, dep, trans, hits, normal = (torch.cat(x) for x in zip(*outs))
    return TraceResult(rgb=rgb, opacity=opa, depth=dep, transmittance=trans,
                       hit_count=hits, overflow=overflow,
                       visibility=visibility,
                       normal=normal if return_normals else None,
                       counts=counts)


def trace_naive(positions, quats, scales, opacities, features, rays_o,
                rays_d, sh_degree: int = 3,
                kernel_degree: int = C.KERNEL_DEGREE_3DGRT,
                min_transmittance: float = C.MIN_TRANSMITTANCE_3DGRT,
                surfel: bool = False) -> TraceResult:
    """O(R*N) oracle: every particle against every ray, exact sort."""
    r, n = rays_o.shape[0], positions.shape[0]
    d = _unit(rays_d)
    hit = particle_ops.particle_hit(
        positions[None], quats[None], scales[None], opacities[None],
        rays_o[:, None, :], d[:, None, :], kernel_degree, surfel=surfel)
    gate = (hit.proj > 0.0) & (hit.gray_dist <= C.MAX_PARTICLE_SQ_DISTANCE)
    alpha = torch.where(gate, hit.alpha, torch.zeros_like(hit.alpha))
    colors = sh_ops.radiance_from_sh(sh_degree, features[None],
                                     d[:, None, :].expand(r, n, 3))
    sort_t = torch.where(alpha > 0.0, hit.hit_t,
                         torch.full_like(alpha, math.inf))
    order = torch.argsort(sort_t, dim=-1, stable=True)
    res = composite(torch.gather(alpha, -1, order),
                    torch.gather(colors, 1, order[..., None].expand(-1, -1,
                                                                    3)),
                    torch.gather(hit.hit_t, -1, order), min_transmittance)
    return TraceResult(
        rgb=res.rgb, opacity=res.opacity, depth=res.depth,
        transmittance=res.transmittance,
        hit_count=res.hit_count.to(torch.float32),
        overflow=torch.zeros((), dtype=torch.bool, device=rays_o.device),
        visibility=(alpha > 0.0).any(0))


def render(positions, quats, scales, opacities, features, cam, pose,
           resolution: Tuple[int, int], sh_degree: int = 3,
           kernel_degree: int = C.KERNEL_DEGREE_3DGRT,
           min_transmittance: float = C.MIN_TRANSMITTANCE_3DGRT,
           candidate_capacity: int = 2048,
           T_to_world=None, density_clamping: bool = False,
           surfel: bool = False, flat_capacity: Optional[int] = None,
           walk_capacity: Optional[int] = None, device="cuda", **kw):
    """Camera render through the trace (render.method = 3dgrt) on
    `device`. Returns (RenderOutputs, overflow) like gut.render; the
    bundles are the 16x16 pixel tiles of the tile-padded image. Further
    keywords (sorted_passes, super_capacity, ...) go to `trace`."""
    from threedgrut_torch.device import resolve, tuple_to
    from threedgrut_torch.render import gut
    from threedgrut_torch.render.gut_reference import RenderOutputs

    dev = resolve(device)
    positions, quats, scales, opacities, features = (
        x.to(dev) for x in (positions, quats, scales, opacities, features))
    cam, pose = tuple_to(cam, dev), tuple_to(pose, dev)
    if T_to_world is not None:
        T_to_world = torch.as_tensor(T_to_world, dtype=torch.float32,
                                     device=dev)
    w, h = resolution
    wp, hp = gut.pad_to_tiles(resolution)
    tile_grid = (wp // C.TILE_X, hp // C.TILE_Y)
    with torch.no_grad(), record_function("3dgrt.rays"):
        rays = gut.packed_world_rays(cam, pose, tile_grid, T_to_world)
        ray_o = rays[:, 0:3, :].transpose(1, 2).reshape(-1, 3)
        ray_d = rays[:, 3:6, :].transpose(1, 2).reshape(-1, 3)
    out = trace(positions, quats, scales, opacities, features, ray_o, ray_d,
                sh_degree, kernel_degree, min_transmittance,
                bundle_size=C.TILE_SIZE,
                candidate_capacity=candidate_capacity,
                density_clamping=density_clamping, surfel=surfel,
                flat_capacity=flat_capacity, walk_capacity=walk_capacity,
                **kw)

    def unflat(x):
        img = x.reshape(tile_grid[1] * tile_grid[0], C.TILE_SIZE, -1)
        return gut.tile_unpack(img.transpose(1, 2), tile_grid)[:h, :w]

    outputs = RenderOutputs(
        rgb=unflat(out.rgb), opacity=unflat(out.opacity)[..., 0],
        depth=unflat(out.depth)[..., 0],
        transmittance=unflat(out.transmittance)[..., 0],
        hit_count=unflat(out.hit_count)[..., 0], visibility=out.visibility)
    return outputs, out.overflow
