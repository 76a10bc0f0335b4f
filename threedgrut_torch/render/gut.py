"""Fast 3DGUT renderer, port of threedgrut_tpu/render/gut.py:
UT projection -> tile binning (kernels B3, B4) -> packed slot gather ->
tile compositor (kernel B1), differentiable through the compositor's
backward (B2) and the scatter-free gradient reduction (B5 or B6).

Projection and binning run without autograd (binning is a discrete
decision; its outputs are integers, and the JAX package's gradients do not
flow through them either). Packing and the SH colours stay differentiable.

A train step spread over a (data, tile, model) mesh of processes
(parallel/dp.py) passes its rank's `shard`: projection, SH colours and
packing then run on the rank's particle shard and are gathered over the
model axis, and the compositor (B1, B2) runs on the rank's strip of tiles,
whose output is gathered over the tile axis. Binning runs on the full set.

Each stage runs under a `torch.profiler.record_function` label
("3dgut.project", "3dgut.bin", "3dgut.pack", "3dgut.gather", "3dgut.rays",
"3dgut.composite"; in the backward "3dgut.bwd_composite" and
"3dgut.bwd_unsort"), which costs nothing unless a profiler is recording.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.profiler import record_function

from threedgrut_torch import constants as C
from threedgrut_torch.cameras import (
    Camera,
    SensorPose,
    ShutterType,
    relative_shutter_time,
)
from threedgrut_torch.device import resolve, tuple_to
from threedgrut_torch.ops import fused_raster
from threedgrut_torch.ops import projection as proj_ops
from threedgrut_torch.ops import quaternion
from threedgrut_torch.ops import tile_raster
from threedgrut_torch.ops import tiles as tile_ops
from threedgrut_torch.ops.sorted_gather import sorted_gather
from threedgrut_torch.render.gut_reference import (
    RenderOutputs,
    camera_center_world,
    camera_space_rays,
    precomputed_features,
)


def pad_to_tiles(resolution: Tuple[int, int]) -> Tuple[int, int]:
    w, h = resolution
    return (-(-w // C.TILE_X) * C.TILE_X, -(-h // C.TILE_Y) * C.TILE_Y)


def tile_pack(img: torch.Tensor, tile_grid: Tuple[int, int]) -> torch.Tensor:
    """[H, W, c] -> [num_tiles, c, 256] (row-major pixels within a tile)."""
    gx, gy = tile_grid
    c = img.shape[-1]
    x = img.reshape(gy, C.TILE_Y, gx, C.TILE_X, c)
    x = x.permute(0, 2, 1, 3, 4).reshape(gx * gy, C.TILE_SIZE, c)
    return x.permute(0, 2, 1).contiguous()


def tile_unpack(buf: torch.Tensor, tile_grid: Tuple[int, int]) -> torch.Tensor:
    """[num_tiles, c, 256] -> [H, W, c]."""
    gx, gy = tile_grid
    c = buf.shape[1]
    x = buf.permute(0, 2, 1).reshape(gy, gx, C.TILE_Y, C.TILE_X, c)
    return x.permute(0, 2, 1, 3, 4).reshape(gy * C.TILE_Y, gx * C.TILE_X, c)


def pack_particles(positions, quats, scales, opacities,
                   colors) -> torch.Tensor:
    """Per-particle 16-float rows for the compositor: A = diag(1/scale) R^T
    (world -> canonical incl. scales), mean, opacity, and the use-time
    clamped SH colour max(c, 0)."""
    R = quaternion.to_rotation_matrix(quats)
    A = R.transpose(-1, -2) / scales[..., :, None]
    return torch.cat([A.reshape(-1, 9), positions, opacities[..., None],
                      torch.clamp(colors, min=0.0)], dim=-1)


def prepare_packed(positions, quats, scales, opacities, features,
                   cam: Camera, pose: SensorPose, resolution, isect_capacity,
                   shutter=ShutterType.GLOBAL, sh_degree=3,
                   tile_culling=True, shard=None):
    """Projection + binning + packing (no slot gather). Returns
    (proj, binning, packed [N, 16], tile_grid). With a mesh rank's `shard`
    (parallel/dp.RankShard) the projection and the packing run on its
    particle shard and are gathered; the results are those of the whole
    set."""
    if isect_capacity % tile_raster.CHUNK:
        raise ValueError(f"isect_capacity must be a multiple of "
                         f"{tile_raster.CHUNK}, got {isect_capacity}")
    wp, hp = pad_to_tiles(resolution)
    tile_grid = (wp // C.TILE_X, hp // C.TILE_Y)
    local = (positions, quats, scales, opacities, features)
    if shard is not None:
        local = shard.local_particles(local)
    with torch.no_grad():
        with record_function("3dgut.project"):
            proj = proj_ops.project(*local[:4], cam, pose, shutter,
                                    resolution)
            if shard is not None:
                proj = shard.gather_projection(proj)
        with record_function("3dgut.bin"):
            binning = tile_ops.bin_particles(proj, tile_grid, isect_capacity,
                                             tile_culling=tile_culling)
    with record_function("3dgut.pack"):
        cam_center = camera_center_world(pose)
        colors = precomputed_features(local[0], local[4], cam_center,
                                      sh_degree)
        packed = pack_particles(*local[:4], colors)
        if shard is not None:
            packed = shard.gather_particles(packed)
    return proj, binning, packed, tile_grid


def prepare(positions, quats, scales, opacities, features, cam: Camera,
            pose: SensorPose, resolution, isect_capacity,
            shutter=ShutterType.GLOBAL, sh_degree=3, tile_culling=True,
            low_precision_grads=False, shard=None):
    """Everything before compositing. Returns (proj, binning,
    data_sorted [cap, 16], tile_grid); `data_sorted` is differentiable in
    the particle inputs through sorted_gather's scatter-free backward."""
    proj, binning, packed, tile_grid = prepare_packed(
        positions, quats, scales, opacities, features, cam, pose, resolution,
        isect_capacity, shutter, sh_degree, tile_culling, shard)
    with record_function("3dgut.gather"):
        data_sorted = sorted_gather(
            packed, binning.sorted_particle_idx, binning.particle_ends,
            "bf16" if low_precision_grads else "f32")
    return proj, binning, data_sorted, tile_grid


def packed_world_rays(cam: Camera, pose: SensorPose, tile_grid,
                      T_to_world=None, t_max=None,
                      shutter: ShutterType = ShutterType.GLOBAL,
                      jitter=None) -> torch.Tensor:
    """World-space rays on the tile-padded grid, packed [T, 8, 256]. `t_max`
    [hp, wp] bounds each ray's segment (row 6; <= 0 unbounded). A rolling
    `shutter` gives each pixel the pose slerped to its shutter time."""
    wp, hp = (tile_grid[0] * C.TILE_X, tile_grid[1] * C.TILE_Y)
    dev = cam.focal.device
    ray_o_c, ray_d_c = camera_space_rays(cam, (wp, hp), jitter=jitter)
    if shutter != ShutterType.GLOBAL:
        xs = torch.arange(wp, dtype=torch.float32, device=dev) + 0.5
        ys = torch.arange(hp, dtype=torch.float32, device=dev) + 0.5
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        alpha = relative_shutter_time(shutter, (wp, hp),
                                      torch.stack([gx, gy], -1))
        q = quaternion.slerp(pose.q_start, pose.q_end, alpha[..., None])
        t_w2c = (pose.t_start * (1.0 - alpha[..., None])
                 + pose.t_end * alpha[..., None])
        q_inv = quaternion.normalize(
            torch.cat([q[..., :1], -q[..., 1:]], dim=-1))
        ray_d = quaternion.rotate(q_inv, ray_d_c).reshape(-1, 3)
        ray_o = (-quaternion.rotate(q_inv, t_w2c)).reshape(-1, 3)
    else:
        if T_to_world is None:
            q_inv = quaternion.normalize(
                torch.cat([pose.q_start[:1], -pose.q_start[1:]]))
            R = quaternion.to_rotation_matrix(q_inv)
            t = camera_center_world(pose)
        else:
            R = T_to_world[:3, :3]
            t = T_to_world[:3, 3]
        ray_o = ray_o_c.reshape(-1, 3) @ R.T + t
        ray_d = ray_d_c.reshape(-1, 3) @ R.T
    if t_max is None:
        tmax_img = torch.zeros((hp, wp, 1), device=dev)
    else:
        tmax_img = torch.where(torch.isfinite(t_max), t_max,
                               torch.zeros_like(t_max))[..., None]
    rays_img = torch.cat([ray_o.reshape(hp, wp, 3), ray_d.reshape(hp, wp, 3),
                          tmax_img, torch.zeros((hp, wp, 1), device=dev)],
                         dim=-1)
    return tile_pack(rays_img, tile_grid)


def render(positions, quats, scales, opacities, features, cam: Camera,
           pose: SensorPose, resolution: Tuple[int, int],
           isect_capacity: int, shutter: ShutterType = ShutterType.GLOBAL,
           sh_degree: int = 3, kernel_degree: int = C.KERNEL_DEGREE_3DGUT,
           min_transmittance: float = C.MIN_TRANSMITTANCE_3DGUT,
           tile_culling: bool = True, T_to_world=None, t_max=None,
           ray_jitter=None, sorted_passes: int = 0,
           aux_gradients: bool = True, aux_outputs: bool = True,
           low_precision_grads: bool = False, hit_visibility: bool = False,
           visibility_threshold: float = 0.0, row_termination: bool = False,
           walk_capacity=None, shard=None,
           device="cuda") -> Tuple[RenderOutputs, torch.Tensor]:
    """Render one frame on `device`. Returns (outputs, overflow flag).

    Inputs are post-activation particle tensors (moved to `device`); the
    outputs are differentiable in them.
    `isect_capacity` bounds the tile intersections; `overflow` (a bool
    tensor) says the true count exceeded it and the caller should grow the
    capacity and render again. `t_max` [h, w] bounds each ray's segment.
    `aux_gradients=False` drops the gradients through depth, transmittance
    and hit count (for a loss that reads only rgb and opacity).
    `aux_outputs=False` (which needs `aux_gradients=False` to be
    differentiated) leaves depth and hit count at zero.
    `low_precision_grads=True` rounds the per-slot cotangents to bf16 before
    the per-particle f32 sums.
    `hit_visibility=True` makes `visibility` hit-based: a particle is
    visible iff one of its slots got a composite weight above
    `visibility_threshold` at some pixel (the eval path of the trainer; this
    leg cannot be differentiated).
    `walk_capacity` (a multiple of 256 below `isect_capacity`) takes the
    fused path (ops/fused_raster.py), whose backward unsorts only the
    windows the forward walked when they fit in that many slots.
    `sorted_passes` > 0 composites each pixel's hits of a 128-slot window
    in the order of that many odd-even passes on their depths (the "sorted"
    k-buffer mode); `row_termination` stops each pixel at the last slot
    whose projected footprint reaches its row (ops/tiles.row_last_touch).
    `shard` (parallel/dp.RankShard) renders one mesh rank's part of the
    frame and gathers the whole (not with `hit_visibility`).
    """
    dev = resolve(device)
    positions, quats, scales, opacities, features = (
        x.to(dev) for x in (positions, quats, scales, opacities, features))
    cam, pose = tuple_to(cam, dev), tuple_to(pose, dev)
    w, h = resolution
    use_fused = (walk_capacity is not None
                 and 0 < walk_capacity < isect_capacity
                 and not hit_visibility)
    if shard is not None and hit_visibility:
        raise ValueError("hit_visibility reads every tile's slots: a mesh "
                         "rank's render (shard) does not take it")

    if use_fused:
        proj, binning, packed, tile_grid = prepare_packed(
            positions, quats, scales, opacities, features, cam, pose,
            resolution, isect_capacity, shutter, sh_degree, tile_culling,
            shard)
    else:
        proj, binning, data_sorted, tile_grid = prepare(
            positions, quats, scales, opacities, features, cam, pose,
            resolution, isect_capacity, shutter, sh_degree, tile_culling,
            low_precision_grads, shard)
    hp, wp = tile_grid[1] * C.TILE_Y, tile_grid[0] * C.TILE_X
    if t_max is not None:
        t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
        t_max = torch.nn.functional.pad(
            t_max, (0, wp - t_max.shape[1], 0, hp - t_max.shape[0]))
    if ray_jitter is not None:
        ray_jitter = torch.as_tensor(ray_jitter, dtype=torch.float32,
                                     device=dev)
        ray_jitter = torch.nn.functional.pad(
            ray_jitter, (0, 0, 0, wp - ray_jitter.shape[1], 0,
                         hp - ray_jitter.shape[0]), value=0.5)
    if T_to_world is not None:
        T_to_world = torch.as_tensor(T_to_world, dtype=torch.float32,
                                     device=dev)
    with record_function("3dgut.rays"):
        rays = packed_world_rays(cam, pose, tile_grid, T_to_world, t_max,
                                 shutter=shutter, jitter=ray_jitter)
        if row_termination:
            with torch.no_grad():
                rays[:, 7] = tile_ops.row_last_touch(binning, proj, tile_grid)
    tile_starts, tile_ends = binning.tile_starts, binning.tile_ends
    strip = None if shard is None else shard.local_tiles(rays.shape[0])
    if strip is not None:
        rays, tile_starts, tile_ends = (x[strip] for x in (rays, tile_starts,
                                                           tile_ends))
    with record_function("3dgut.composite"):
        if use_fused:
            out = fused_raster.composite_particles(
                packed, binning.sorted_particle_idx, binning.particle_ends,
                tile_starts, tile_ends, rays, kernel_degree,
                min_transmittance, has_t_max=t_max is not None,
                aux_grads=aux_gradients, aux_outputs=aux_outputs,
                low_precision_grads=low_precision_grads,
                walk_capacity=walk_capacity, sorted_passes=sorted_passes,
                row_termination=row_termination)
            flags_slot = None
        else:
            out, flags_slot = tile_raster.tile_composite(
                data_sorted, tile_starts, tile_ends, rays,
                kernel_degree, min_transmittance,
                has_t_max=t_max is not None, aux_outputs=aux_outputs,
                emit_flags=hit_visibility, aux_grads=aux_gradients,
                sorted_passes=sorted_passes, row_termination=row_termination)
    if shard is not None:
        out = shard.gather_tiles(out)

    img = tile_unpack(out, tile_grid)[:h, :w]
    # Visibility: projected to a renderable splat this frame; with
    # hit_visibility, also contributed at some pixel (a particle's slots are
    # reduced with one scatter of their binarized flags; slots that did not
    # contribute, and tail slots, write row n, which is dropped: no boolean
    # mask index, so no wait for the device).
    visibility = proj.valid & (proj.n_tiles > 0)
    if hit_visibility:
        n = positions.shape[0]
        hit = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        ids = torch.where(flags_slot > visibility_threshold,
                          binning.sorted_particle_idx, n)
        hit[ids.long()] = True
        visibility = visibility & hit[:n]
    outputs = RenderOutputs(
        rgb=img[..., 0:3], opacity=img[..., 3], depth=img[..., 4],
        transmittance=img[..., 5], hit_count=img[..., 6],
        visibility=visibility)
    return outputs, binning.overflow
