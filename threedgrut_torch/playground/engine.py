"""Playground engine: a path tracer over Gaussians and meshes, port of
threedgrut_tpu/playground/engine.py (the reference system's
Engine3DGRUT and its OptiX playground kernel).

Per pass, a loop of { mesh closest hit (kernel M1) -> the Gaussians along
the segment up to it (3DGRT trace with `t_max`, kernel B7) -> material
bounce with throughput and emission } until a miss, the opacity threshold
or `max_bounces`; then spp passes with pixel jitter, depth of field
(Shirley's concentric disc), an environment map, a denoiser, a filmic
tonemap and gamma. `render_hybrid` is the paper's hybrid 3DGRUT mode:
primary rays are rasterized with 3DGUT (kernels B3, B4, B1), each bounded
by its mesh hit through the per-ray `t_max`, and the secondary rays off
mirrors and glass are traced.

Unlike the JAX engine, both renders return `overflow`: the OR of every
trace pass's flag and of the rasterizer's (the JAX engine drops the
trace's flag, ROADMAP C15). The trace's super lists grow with the
candidate capacity (`super_lists`). `render_fitted` grows the candidate
capacity until a frame fits. The trace culls bundles of 256 consecutive
rays with one cone each, so the engine chooses the bundles
(`Engine._trace_live`): camera rays by 16x16 pixel tiles in blocks of
tiles (`block_order`), secondary rays by tile and surface
(`surface_groups`), a group traced again in smaller groups while its
candidate list is full (`split_groups`); dead rays are not traced. Random draws (pixel
jitter, lens samples) come from a torch.Generator and enter the ray
functions as arguments.
Everything runs on `device` without autograd; the mesh tests run under
the `record_function` label "playground.mesh", the shading under
"playground.shade" (the trace and the rasterizer under their own
"3dgrt.*" and "3dgut.*" labels).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from threedgrut_torch import constants as C
from threedgrut_torch.cameras import (
    Camera,
    FisheyeCamera,
    PinholeCamera,
    fisheye_camera_rays,
    pinhole_camera_rays,
    pose_from_matrix,
)
from threedgrut_torch.device import resolve, tuple_to
from threedgrut_torch.playground import denoiser
from threedgrut_torch.playground import envmap as env_mod
from threedgrut_torch.playground import materials as mat_mod
from threedgrut_torch.playground import mesh as mesh_mod
from threedgrut_torch.render import grt, gut
from threedgrut_torch.trainer import GRT_SUPER_CAPACITY, MAX_ISECT_CAPACITY

# The hybrid rasterizes with isect_capacity = candidate_capacity * 256 (one
# bundle's rays): the binning's ceiling bounds the candidate capacity.
MAX_CANDIDATE_CAPACITY = MAX_ISECT_CAPACITY // C.TILE_SIZE


@dataclasses.dataclass
class EngineConfig:
    max_bounces: int = 4
    spp: int = 1
    candidate_capacity: int = 2048
    kernel_degree: int = C.KERNEL_DEGREE_3DGRT
    min_transmittance: float = C.MIN_TRANSMITTANCE_3DGRT_EVAL
    max_opacity: float = 0.995          # a ray stops above this opacity
    sh_degree: int = 3
    tonemap: bool = False               # filmic HDR transform
    gamma: float = 1.0
    use_dof: bool = False               # depth of field
    aperture: float = 0.01
    focus_z: float = 1.0
    denoise: bool = False
    denoiser: str = "atrous"            # "atrous" | "bilateral"


def ray_padding(n_rays: int, n_particles: int) -> int:
    """The rays of a camera-ray trace call, padded: to whole bundles (256
    rays) and, above GRT_SUPER_CAPACITY particles, to whole super bundles
    (16 bundles), so that the two-level cull can run: it needs a multiple
    of 16 bundles, and the single-level cull would sort a [bundles,
    particles] key array (an 800x800 frame of a 1M scene: 2.5e9 keys).
    Below that count the two culls' lists are the same."""
    granule = C.TILE_SIZE
    if n_particles > GRT_SUPER_CAPACITY:
        granule *= grt.SUPER_MULT
    return -(-n_rays // granule) * granule


# The rays of one grt.trace call: 256 bundles. The two-level cull groups a
# call's bundles 16 at a time by the Morton order of their directions; over
# a whole frame's grid of bundles (not a power of two a side: 50 x 50 at
# 800x800) a group can straddle one of the curve's jumps and span the view,
# and its super cone then takes nearly every particle of a dense scene. A
# call over the 16 x 16 bundles of one block of the image keeps every group
# a compact 4 x 4 block.
TRACE_CHUNK = 256 * C.TILE_SIZE
BLOCK_TILES = 16


def block_order(tile_grid: Tuple[int, int], device) -> torch.Tensor:
    """The tiles [gx * gy] (row-major) reordered block by block: blocks of
    BLOCK_TILES x BLOCK_TILES tiles in row-major order, the tiles of a
    block row-major within it."""
    gx, gy = tile_grid
    ty, tx = torch.meshgrid(torch.arange(gy, device=device),
                            torch.arange(gx, device=device), indexing="ij")
    b = BLOCK_TILES
    key = (((ty // b) * (-(-gx // b)) + tx // b) * b * b
           + (ty % b) * b + tx % b)
    return torch.argsort(key.reshape(-1))


def surface_groups(idx: torch.Tensor, surface: torch.Tensor):
    """The live secondary rays `idx` (ascending) in groups of one 256-ray
    tile's rays that left one surface (material id `surface`), each
    filled up to 256 slots with copies of its first ray. A tile's rays
    off a smooth mirror or a glass ball stay coherent over the bounces
    (neighbouring pixels, nearby points, nearby directions); rays sorted
    by where they start are not (behind a glass ball, neighbouring exit
    points take rays from far-apart pixels). Returns (src [G, 256], keep
    [G, 256] bool: the slot holds a ray of its own, not a copy); no group
    when `idx` is empty."""
    if idx.numel() == 0:
        return idx.new_zeros((0, C.TILE_SIZE)), torch.zeros(
            (0, C.TILE_SIZE), dtype=torch.bool, device=idx.device)
    key = (idx // C.TILE_SIZE) * (int(surface.max()) + 2) + surface[idx] + 1
    order = torch.sort(key, stable=True).indices
    idx, key = idx[order], key[order]
    _, counts = torch.unique_consecutive(key, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    seg = torch.repeat_interleave(torch.arange(counts.numel(),
                                               device=idx.device), counts)
    slot = seg * C.TILE_SIZE + (torch.arange(idx.numel(), device=idx.device)
                                - starts[seg])
    src = idx[starts].repeat_interleave(C.TILE_SIZE)
    src[slot] = idx
    keep = torch.zeros_like(src, dtype=torch.bool)
    keep[slot] = True
    return src.reshape(-1, C.TILE_SIZE), keep.reshape(-1, C.TILE_SIZE)


# A group of secondary rays whose list reaches this many candidates is
# split (Engine._trace_live): a secondary bundle's cone spans its rays' origins and directions, and through a dense
# scene a wide one (a grazing patch of a mirror floor, a glass ball's exit
# rays) takes a large share of the particles, where a camera tile's takes a
# few thousand of a 1M scene.
SPLIT_COUNT = 32768
# Secondary rays are traced 64 bundles a call, with the single-level cull:
# the two-level cull groups a call's bundles 16 at a time by direction, and
# a group of a mirror floor's bundles off a grazing tile's patch (or off
# distant patches) spans them all: its super cone takes up to every
# particle, so its super list is no cheaper than the single-level test.
SECONDARY_CHUNK = 64 * C.TILE_SIZE


def fill_groups(src: torch.Tensor, keep: torch.Tensor):
    """Groups of rays src [G, n] (keep [G, n] bool: the slot holds a ray of
    its own, not a copy) as bundles [G, 256], each filled up with copies of
    its first slot."""
    fill = C.TILE_SIZE - src.shape[1]
    return (torch.cat([src, src[:, :1].expand(-1, fill)], 1),
            torch.cat([keep, torch.zeros_like(keep[:, :1]).expand(-1, fill)],
                      1))


def split_groups(src: torch.Tensor, keep: torch.Tensor):
    """Each group [G, n] as four groups of n / 4 slots; a group with no ray
    of its own is dropped, and the copy slots of the others hold their
    first own ray."""
    n = src.shape[1] // 4
    src, keep = src.reshape(-1, n), keep.reshape(-1, n)
    live = keep.any(1)
    src, keep = src[live], keep[live]
    first = torch.gather(src, 1, keep.to(torch.int8).argmax(1)[:, None])
    return torch.where(keep, src, first), keep


def super_lists(candidate_capacity: int) -> Dict[str, int]:
    """The trace's super-list arguments for a candidate capacity. The JAX
    engine leaves them at grt.trace's 8192 (ROADMAP C15, C7's class), so a
    scene with more particles than that in one super cone truncates every
    frame. Here a super bundle's list has room for its 16 member bundles'
    lists (the trainer's rule, trainer.grt_super_lists, gives 8: a 400 x
    400 frame of a 1M scene then overflows at the capacity ceiling), and
    the two-level cull runs above 8192 particles, as the JAX package's
    does."""
    return dict(super_capacity=max(GRT_SUPER_CAPACITY,
                                   grt.SUPER_MULT * candidate_capacity),
                two_level_above=GRT_SUPER_CAPACITY)


class Engine:
    """Headless playground renderer. `positions` ... `features` are
    post-activation particle tensors; they, the mesh, the materials and the
    envmap [H, W, 3] are moved to `device`."""

    def __init__(self, positions, quats, scales, opacities, features,
                 mesh: Optional[mesh_mod.TriangleMesh] = None,
                 materials: Optional[mat_mod.Materials] = None,
                 envmap: Optional[torch.Tensor] = None,
                 config: Optional[EngineConfig] = None, device="cuda",
                 seed: int = 0):
        self.device = resolve(device)
        self.gaussians = tuple(x.to(self.device) for x in (
            positions, quats, scales, opacities, features))
        self.mesh = mesh
        self.materials = materials or mat_mod.make_materials(
            [dict(kind=mat_mod.MaterialKind.DIFFUSE)], self.device)
        self.envmap = envmap
        self.cfg = config or EngineConfig()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    @property
    def mesh(self) -> Optional[mesh_mod.TriangleMesh]:
        return self._mesh

    @mesh.setter
    def mesh(self, m):
        self._mesh = None if m is None else m.to(self.device)

    @property
    def materials(self) -> mat_mod.Materials:
        return self._materials

    @materials.setter
    def materials(self, m):
        self._materials = mat_mod.Materials(
            **{f: getattr(m, f).to(self.device) for f in mat_mod.FIELDS})

    @property
    def envmap(self) -> Optional[torch.Tensor]:
        return self._envmap

    @envmap.setter
    def envmap(self, e):
        self._envmap = None if e is None else torch.as_tensor(
            e, dtype=torch.float32, device=self.device)

    # -- ray generation ----------------------------------------------------
    def draws(self, resolution: Tuple[int, int]):
        """One pass's (pixel jitter [H, W, 2] or None, lens draw [H, W, 2]
        or None) from the engine's generator, uniform in [0, 1): jitter
        when spp > 1, the lens with depth of field."""
        w, h = resolution

        def draw():
            return torch.rand((h, w, 2), generator=self.generator,
                              device=self.device)

        return (draw() if self.cfg.spp > 1 else None,
                draw() if self.cfg.use_dof else None)

    def _camera_rays(self, cam: Camera, T_to_world: torch.Tensor,
                     resolution: Tuple[int, int],
                     jitter: Optional[torch.Tensor] = None,
                     lens: Optional[torch.Tensor] = None):
        """World rays [H*W, 3] (origins, unit directions) of a pinhole (with
        the pixel offsets `jitter`, pixel centres without) or fisheye
        camera; with depth of field, moved by the lens draw `lens`."""
        if isinstance(cam, PinholeCamera):
            o, d = pinhole_camera_rays(cam, resolution, jitter=jitter)
        elif isinstance(cam, FisheyeCamera):
            o, d = fisheye_camera_rays(cam, resolution)
        else:
            raise TypeError(type(cam))
        if self.cfg.use_dof:
            o, d = self._apply_dof(o, d, lens)
        R = T_to_world[:3, :3]
        t = T_to_world[:3, 3]
        ow = o.reshape(-1, 3) @ R.T + t
        dw = d.reshape(-1, 3) @ R.T
        return ow, dw / torch.linalg.norm(dw, dim=-1, keepdim=True)

    def _apply_dof(self, o, d, lens):
        """Shirley's concentric disc lens sampling; `lens` [..., 2] is the
        uniform draw in [0, 1)."""
        u = lens * 2.0 - 1.0
        ux, uy = u[..., 0], u[..., 1]
        major_x = torch.abs(ux) > torch.abs(uy)
        r = torch.where(major_x, ux, uy)
        theta = torch.where(
            major_x,
            (math.pi / 4) * (uy / torch.where(ux == 0, 1.0, ux)),
            (math.pi / 2) - (math.pi / 4) * (ux / torch.where(uy == 0, 1.0,
                                                               uy)))
        lens_xy = self.cfg.aperture * torch.stack(
            [r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
        focus_t = self.cfg.focus_z / torch.clamp(d[..., 2], min=1e-6)
        focus_p = o + d * focus_t[..., None]
        o2 = o + torch.cat([lens_xy, torch.zeros_like(lens_xy[..., :1])], -1)
        d2 = focus_p - o2
        return o2, d2 / torch.linalg.norm(d2, dim=-1, keepdim=True)

    # -- core pass ---------------------------------------------------------
    def _trace_calls(self, o, d, t_max, src: torch.Tensor, capacity: int,
                     camera: bool):
        """grt.trace of the rays `src` [M] (M a multiple of 256: bundles of
        256) at `capacity` candidates, in calls of TRACE_CHUNK camera rays
        (each padded, `ray_padding`, with copies of its last ray) or
        SECONDARY_CHUNK secondary rays (the single-level cull with
        spread_origins). Returns ([M, 6]: rgb, opacity, depth,
        transmittance; counts [M / 256]: each bundle's candidates, clamped
        to `capacity`; overflow)."""
        cfg = self.cfg
        n = self.gaussians[0].shape[0]
        chunk = TRACE_CHUNK if camera else SECONDARY_CHUNK
        cull = super_lists(capacity)
        if not camera:
            cull["two_level_above"] = n
        res, counts = [], []
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        for c0 in range(0, src.numel(), chunk):
            part = src[c0:c0 + chunk]
            m = part.numel()
            pad = ray_padding(m, n) if camera else m
            sel = torch.cat([part, part[-1:].expand(pad - m)])
            seg = grt.trace(
                *self.gaussians, o[sel], d[sel], sh_degree=cfg.sh_degree,
                kernel_degree=cfg.kernel_degree,
                min_transmittance=cfg.min_transmittance,
                candidate_capacity=capacity, t_max=t_max[sel],
                spread_origins=not camera, **cull)
            res.append(torch.cat([seg.rgb, seg.opacity[:, None],
                                  seg.depth[:, None],
                                  seg.transmittance[:, None]], 1)[:m])
            counts.append(seg.counts[:m // C.TILE_SIZE])
            overflow = overflow | seg.overflow
        return torch.cat(res), torch.cat(counts), overflow

    def _trace_live(self, o, d, live, t_max, surface=None):
        """grt.trace of the `live` rays alone (`_trace_calls`); every other
        ray gets what the trace gives an inactive ray (zeros,
        transmittance 1). Returns (rgb [R, 3], opacity, depth,
        transmittance [R], overflow). R is a multiple of 256, the rays of a
        16x16 tile (of camera rays, or of the camera rays they come from)
        consecutive.

        The trace culls bundles of 256 consecutive rays with one cone each.
        Camera rays (`surface` None) are traced by tiles, a tile's dead
        rays as copies of its first live ray. Secondary rays, each with
        the material id of the `surface` it left, are traced in groups of
        one tile's rays off one surface (surface_groups). A group whose
        list fills min(candidate_capacity, SPLIT_COUNT) candidates is split
        into groups of 64, then 16, 4 and 1 rays (split_groups), each
        filled up to a bundle with copies (fill_groups), and traced again;
        the 1-ray groups at candidate_capacity. A list shorter than its
        capacity (or at a capacity of every particle) holds all of its
        bundle's candidates, so a group is kept only where its list is
        complete. `overflow` is that of the 1-ray
        groups' traces, and below SPLIT_COUNT that of every trace: a list
        over candidate_capacity asks for a larger one (render_fitted).

        The JAX engine traces every ray in pixel order, the dead ones with
        a zero direction, to which the cull gives a fixed direction: a
        bundle of live and dead rays, or of rays that left different
        surfaces (a tile at a mesh's edge: some rays off the glass 2 units
        away, some off the floor 8 away, some dead), spans their
        directions and origins; its cone then takes up to every particle
        (ROADMAP C15: on a 1M scene no candidate capacity fits), and its
        candidates come in the order of a meaningless axis."""
        r = o.shape[0]
        dev = self.device
        out = torch.zeros((r, 6), device=dev)
        out[:, 5] = 1.0
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        cap = self.cfg.candidate_capacity
        if surface is None:
            lt = live.reshape(-1, C.TILE_SIZE)
            tiles = torch.nonzero(lt.any(1)).squeeze(1)
            if tiles.numel():
                lane = torch.arange(C.TILE_SIZE, device=dev)
                slots = (tiles[:, None] * C.TILE_SIZE + lane).reshape(-1)
                keep = lt[tiles].reshape(-1)
                first = tiles * C.TILE_SIZE + lt[tiles].to(
                    torch.int8).argmax(1)
                src = torch.where(keep, slots,
                                  first.repeat_interleave(C.TILE_SIZE))
                res, _, overflow = self._trace_calls(o, d, t_max, src, cap,
                                                     True)
                out[slots[keep]] = res[keep]
        else:
            idx = torch.nonzero(live).squeeze(1)
            n = self.gaussians[0].shape[0]
            src, keep = surface_groups(idx, surface)
            while src.numel():
                last = src.shape[1] == 1
                capacity = cap if last else min(cap, SPLIT_COUNT)
                full, full_keep = fill_groups(src, keep)
                res, counts, ovf = self._trace_calls(
                    o, d, t_max, full.reshape(-1), capacity, False)
                if last or cap < SPLIT_COUNT:
                    overflow = overflow | ovf
                if last:
                    ok = torch.ones_like(counts, dtype=torch.bool)
                else:
                    ok = (counts < capacity) | (capacity >= n)
                take = (full_keep & ok[:, None]).reshape(-1)
                out[full.reshape(-1)[take]] = res[take]
                if last:
                    break
                src, keep = split_groups(src[~ok], keep[~ok])
        return out[:, :3], out[:, 3], out[:, 4], out[:, 5], overflow

    def _trace_pass(self, ray_o, ray_d, surface=None):
        """One path-traced pass over [R, 3] world rays (a zero direction:
        an inactive ray) in 16x16 tiles: camera rays (`surface` None), or
        rays that left the surfaces of material ids `surface` [R]
        (`_trace_live`). Returns (radiance [R, 3], opacity [R], first
        depth [R], overflow [] bool)."""
        cfg = self.cfg
        dev = self.device
        o, d = ray_o, ray_d
        r = o.shape[0]
        radiance = torch.zeros((r, 3), device=dev)
        throughput = torch.ones((r, 3), device=dev)
        alive = torch.ones(r, dtype=torch.bool, device=dev)
        total_opacity = torch.zeros(r, device=dev)
        first_depth = torch.full((r,), float("inf"), device=dev)
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        zero3 = torch.zeros_like(radiance)

        for bounce_i in range(cfg.max_bounces):
            with record_function("playground.mesh"):
                mh = mesh_mod.intersect(self.mesh, o, d)
            seg_rgb, seg_opacity, seg_depth, seg_trans, seg_ovf = \
                self._trace_live(o, d, alive & (d != 0).any(-1), mh.t,
                                 surface)
            overflow = overflow | seg_ovf
            radiance = radiance + throughput * seg_rgb
            total_opacity = total_opacity + torch.where(
                alive, seg_opacity * throughput.mean(-1),
                torch.zeros_like(total_opacity))
            t_local = seg_trans[:, None]
            if bounce_i == 0:
                first_depth = torch.where(
                    torch.isfinite(mh.t), torch.minimum(mh.t, seg_depth),
                    seg_depth)

            with record_function("playground.shade"):
                hit_mesh = alive & (mh.material_id >= 0)
                miss = alive & ~torch.isfinite(mh.t)
                # A miss sees the environment through the remaining
                # transmittance.
                env = env_mod.sample_envmap(self.envmap, d)
                radiance = radiance + torch.where(
                    miss[:, None], throughput * t_local * env, zero3)
                # A mesh hit is shaded and continues.
                env_at_n = env_mod.sample_envmap(
                    self.envmap, mh.normal, default_color=(1.0, 1.0, 1.0))
                nd, atten, emitted, cont = mat_mod.bounce(
                    self.materials, mh.material_id, d, mh.normal, env_at_n,
                    uv=mh.uv, tangent=mh.tangent)
                radiance = radiance + torch.where(
                    hit_mesh[:, None], throughput * t_local * emitted, zero3)
                new_throughput = throughput * t_local * atten
                hit_p = o + d * mh.t[:, None]
                cont_mask = (hit_mesh & cont
                             & (torch.amax(new_throughput, -1) > 1e-4)
                             & (total_opacity < cfg.max_opacity))
                o = torch.where(cont_mask[:, None], hit_p + nd * 1e-4, o)
                d = torch.where(cont_mask[:, None], nd, d)
                throughput = torch.where(cont_mask[:, None], new_throughput,
                                         throughput)
                alive = cont_mask
                surface = torch.where(cont_mask, mh.material_id, -1)

        return radiance, total_opacity, first_depth, overflow

    def _display(self, rgb: torch.Tensor) -> torch.Tensor:
        if self.cfg.tonemap:
            rgb = env_mod.filmic_tonemap(rgb)
        if self.cfg.gamma != 1.0:
            rgb = torch.pow(torch.clamp(rgb, 0.0, 1.0), 1.0 / self.cfg.gamma)
        return rgb

    # -- public API --------------------------------------------------------
    @torch.no_grad()
    def render(self, cam: Camera, T_to_world, resolution: Tuple[int, int]
               ) -> Dict[str, torch.Tensor]:
        """A frame of cfg.spp path-traced passes (each pass's draws from
        the engine's generator, `draws`): rgb [H, W, 3], opacity and depth
        [H, W] (the first pass's), overflow."""
        cfg = self.cfg
        w, h = resolution
        cam = tuple_to(cam, self.device)
        T = torch.as_tensor(T_to_world, dtype=torch.float32,
                            device=self.device)
        wp, hp = gut.pad_to_tiles(resolution)
        tile_grid = (wp // C.TILE_X, hp // C.TILE_Y)
        order = block_order(tile_grid, self.device)
        acc = torch.zeros((h, w, 5), device=self.device)
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        depth = None
        for s in range(cfg.spp):
            jitter, lens = self.draws(resolution)
            o, d = self._camera_rays(cam, T, resolution, jitter, lens)
            # The trace's bundles are 256 consecutive rays: the pixels'
            # 16x16 tiles (rows of pixels would make cones ~16x wider),
            # in block order (block_order). The padding pixels get no
            # direction: they are not traced.
            rays = torch.nn.functional.pad(
                torch.cat([o, d], -1).reshape(h, w, 6),
                (0, 0, 0, wp - w, 0, hp - h))
            rays = gut.tile_pack(rays, tile_grid).transpose(1, 2)[order]
            rgb, op, dep, ovf = self._trace_pass(
                rays[..., :3].reshape(-1, 3), rays[..., 3:].reshape(-1, 3))
            res = torch.empty((order.numel(), C.TILE_SIZE, 5),
                              device=self.device)
            res[order] = torch.cat([rgb, op[:, None], dep[:, None]],
                                   -1).reshape(-1, C.TILE_SIZE, 5)
            img = gut.tile_unpack(res.transpose(1, 2), tile_grid)[:h, :w]
            acc = acc + img
            overflow = overflow | ovf
            if depth is None:
                depth = img[..., 4]
        rgb = acc[..., :3] / cfg.spp
        if cfg.denoise:
            fn = (denoiser.atrous_denoise if cfg.denoiser == "atrous"
                  else denoiser.bilateral_denoise)
            rgb = fn(rgb, depth)
        return {"rgb": self._display(rgb), "opacity": acc[..., 3] / cfg.spp,
                "depth": depth, "overflow": overflow}

    @torch.no_grad()
    def render_hybrid(self, cam: Camera, T_to_world,
                      resolution: Tuple[int, int]
                      ) -> Dict[str, torch.Tensor]:
        """The hybrid 3DGRUT mode: primary rays rasterized with 3DGUT, each
        bounded by its mesh hit (`t_max`), secondary reflection and
        refraction rays traced with 3DGRT; consistent because both evaluate
        the same 3D ray-space response. The raster's capacity is
        candidate_capacity * 256."""
        cfg = self.cfg
        dev = self.device
        w, h = resolution
        cam = tuple_to(cam, dev)
        T = torch.as_tensor(T_to_world, dtype=torch.float32, device=dev)
        pose = pose_from_matrix(T)
        wp, hp = gut.pad_to_tiles(resolution)
        tile_grid = (wp // C.TILE_X, hp // C.TILE_Y)
        n_tiles = tile_grid[0] * tile_grid[1]

        # Primary rays on the padded grid, in the raster's tile order.
        rays_pk = gut.packed_world_rays(cam, pose, tile_grid, T)
        o = rays_pk[:, 0:3, :].transpose(1, 2).reshape(-1, 3)
        d = rays_pk[:, 3:6, :].transpose(1, 2).reshape(-1, 3)
        with record_function("playground.mesh"):
            mh = mesh_mod.intersect(self.mesh, o, d)

        def unflat(x):
            img = x.reshape(n_tiles, C.TILE_SIZE, -1)
            return gut.tile_unpack(img.transpose(1, 2), tile_grid)

        t_hit = torch.where(torch.isfinite(mh.t), mh.t,
                            torch.zeros_like(mh.t))
        t_img = unflat(t_hit)[..., 0]
        outputs, overflow = gut.render(
            *self.gaussians, cam, pose, resolution,
            cfg.candidate_capacity * C.TILE_SIZE, sh_degree=cfg.sh_degree,
            kernel_degree=C.KERNEL_DEGREE_3DGUT,
            min_transmittance=cfg.min_transmittance, T_to_world=T,
            t_max=t_img, device=dev)
        hit_img = unflat((mh.material_id >= 0).to(torch.float32))[..., 0] > 0.5
        trans = outputs.transmittance[..., None]

        # Mesh shading and the traced continuation (flat over the padded
        # rays).
        env_at_n = env_mod.sample_envmap(self.envmap, mh.normal,
                                         default_color=(1.0, 1.0, 1.0))
        nd, atten, emitted, cont = mat_mod.bounce(
            self.materials, mh.material_id, d, mh.normal, env_at_n,
            uv=mh.uv, tangent=mh.tangent)
        hit_mesh = mh.material_id >= 0
        cont_mask = hit_mesh & cont
        sec_o = o + d * t_hit[:, None] + nd * 1e-4
        sec_d = torch.where(cont_mask[:, None], nd, torch.zeros_like(nd))
        # The secondary rays in block order (block_order), so that a trace
        # call's tiles are neighbours.
        order = (block_order(tile_grid, dev)[:, None] * C.TILE_SIZE
                 + torch.arange(C.TILE_SIZE, device=dev)).reshape(-1)
        sec_rgb = torch.empty_like(sec_o)
        sec_rgb[order], _, _, sec_ovf = self._trace_pass(
            sec_o[order], sec_d[order], mh.material_id[order])

        zero3 = torch.zeros_like(emitted)
        emitted_img = unflat(torch.where(hit_mesh[:, None], emitted, zero3))
        atten_img = unflat(torch.where(cont_mask[:, None], atten, zero3))
        sec_img = unflat(sec_rgb)
        radiance = outputs.rgb + trans * (emitted_img[:h, :w]
                                          + atten_img[:h, :w]
                                          * sec_img[:h, :w])
        # The environment through the transparent pixels that miss the
        # meshes.
        env_bg = env_mod.sample_envmap(self.envmap, d)
        env_img = unflat(torch.where(~hit_mesh[:, None], env_bg, zero3))
        radiance = radiance + trans * env_img[:h, :w]
        return {"rgb": self._display(radiance), "opacity": outputs.opacity,
                "depth": torch.where(hit_img[:h, :w], t_img[:h, :w],
                                     outputs.depth),
                "overflow": overflow | sec_ovf}

    def render_fitted(self, cam: Camera, T_to_world,
                      resolution: Tuple[int, int], hybrid: bool = False,
                      grown: Optional[List[int]] = None
                      ) -> Dict[str, torch.Tensor]:
        """render (or render_hybrid) until the frame fits: on overflow the
        candidate capacity doubles (the hybrid's raster capacity with it)
        and the frame is rendered again; at MAX_CANDIDATE_CAPACITY a frame
        that still overflows raises. Every capacity grown to is appended to
        `grown`."""
        fn = self.render_hybrid if hybrid else self.render
        while True:
            out = fn(cam, T_to_world, resolution)
            if not bool(out["overflow"]):
                return out
            cap = self.cfg.candidate_capacity
            if cap >= MAX_CANDIDATE_CAPACITY:
                raise RuntimeError(
                    f"playground frame overflows at the ceiling "
                    f"candidate_capacity {cap} (raster capacity "
                    f"{cap * C.TILE_SIZE}): the frame would be truncated")
            self.cfg.candidate_capacity = min(2 * cap, MAX_CANDIDATE_CAPACITY)
            if grown is not None:
                grown.append(self.cfg.candidate_capacity)
