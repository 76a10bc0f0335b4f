"""Frame-coherent inference, port of threedgrut_tpu/render/infer.py:
hit-visibility compaction and frozen binning for interactive and video
rendering.

The per-frame renderer (render/gut.py) projects, bins, sorts and gathers
the whole scene every frame. Between nearby frames most of that work can be
reused:

  1. `refresh` renders one frame exactly with `hit_visibility=True` (B1's
     per-slot weight census) and compacts the particles that contributed
     into a `CompactScene` of static size `n_compact`; `render_compact`
     then renders later frames from that scene at a proportionally smaller
     intersection capacity.
  2. `capture_binning` keeps the compacted scene's binning (sorted slot
     ids, particle ends, tile ranges) at the refresh camera, and
     `render_frozen` reuses it for later frames: it only recomputes the SH
     colours, gathers the rows and composites with B1's sorted leg, whose
     per-window re-sort absorbs a bounded drift of the depth order.

Both are approximations across frames (exact at the refresh camera); call
`refresh` again every few frames to bound the drift. Nothing here waits for
the device: counts and overflow flags stay tensors for the caller to read.
Every function runs without autograd, on `device` (the card unless the
caller asks for the CPU), under a `record_function` span ("infer.refresh",
"infer.compact", "infer.capture", "infer.frozen").
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.profiler import record_function

from threedgrut_torch import constants as C
from threedgrut_torch.cameras import Camera, SensorPose, ShutterType
from threedgrut_torch.device import resolve, tuple_to
from threedgrut_torch.ops import tile_raster
from threedgrut_torch.ops.sorted_gather import sorted_gather
from threedgrut_torch.render import gut
from threedgrut_torch.render.gut_reference import (
    RenderOutputs,
    camera_center_world,
    precomputed_features,
)


class CompactScene(NamedTuple):
    """The hit-visible subset of a scene at a static size. Tail rows carry
    opacity 0 (invalid to the projector, never binned)."""
    positions: torch.Tensor   # [Nc, 3]
    quats: torch.Tensor       # [Nc, 4]
    scales: torch.Tensor      # [Nc, 3]
    opacities: torch.Tensor   # [Nc]
    features: torch.Tensor    # [Nc, K, 3]
    src_idx: torch.Tensor     # [Nc] int32 source particle id (tail: N)
    count: torch.Tensor       # [] int32 true visible count
    overflow: torch.Tensor    # [] bool: the visible count exceeded Nc

    def to(self, device) -> "CompactScene":
        return CompactScene(*(x.to(device) for x in self))


class FrozenBinning(NamedTuple):
    """The binning of a compacted scene at a refresh camera, kept for
    reuse."""
    sorted_idx: torch.Tensor     # [capc] int32 compact-scene particle ids
    particle_ends: torch.Tensor  # [Nc] int32
    tile_starts: torch.Tensor    # [num_tiles] int32
    tile_ends: torch.Tensor      # [num_tiles] int32
    overflow: torch.Tensor       # [] bool


def _on(device, *xs):
    dev = resolve(device)
    return dev, [x.to(dev) for x in xs]


@torch.no_grad()
def compact_visible(positions, quats, scales, opacities, features,
                    visibility, n_compact: int,
                    device="cuda") -> CompactScene:
    """Gather the `visibility`-marked particles into a scene of
    min(n_compact, N) rows, in ascending source id (a stable compaction by
    an inclusive cumsum and one scatter). If more are visible, the ones of
    highest id are dropped and `overflow` is set (the caller grows
    `n_compact` and refreshes again, as with the intersection capacity)."""
    dev, (positions, quats, scales, opacities, features, visibility) = _on(
        device, positions, quats, scales, opacities, features, visibility)
    n = positions.shape[0]
    m = min(n_compact, n)
    vis = visibility.to(torch.bool)
    rank = torch.cumsum(vis.to(torch.int32), 0, dtype=torch.int32) - 1
    count = vis.sum(dtype=torch.int32)
    # Each visible particle of rank < m writes its id to its rank; the
    # others write to row m, which is dropped.
    dst = torch.where(vis & (rank < m), rank, m).long()
    src = torch.full((m + 1,), n, dtype=torch.int32, device=dev)
    src[dst] = torch.arange(n, dtype=torch.int32, device=dev)
    src = src[:m]
    rows = torch.clamp(src, max=n - 1).long()
    return CompactScene(
        positions=positions[rows], quats=quats[rows], scales=scales[rows],
        opacities=torch.where(src < n, opacities[rows],
                              torch.zeros((), device=dev)),
        features=features[rows], src_idx=src, count=count,
        overflow=count > n_compact)


@torch.no_grad()
def refresh(positions, quats, scales, opacities, features, cam: Camera,
            pose: SensorPose, resolution, isect_capacity: int,
            n_compact: int, shutter: ShutterType = ShutterType.GLOBAL,
            sh_degree: int = 3, sorted_passes: int = 0, T_to_world=None,
            visibility_threshold: float = 0.0, device="cuda"
            ) -> Tuple[RenderOutputs, torch.Tensor, CompactScene]:
    """An exact frame with the hit-visibility census, and the compaction of
    its visible particles. Returns (outputs, isect overflow, CompactScene).
    `visibility_threshold` > 0 drops the particles whose largest composite
    weight at any pixel did not exceed it (a bounded error in the frames
    rendered from the compacted scene; 0 keeps every contributor)."""
    with record_function("infer.refresh"):
        dev, (positions, quats, scales, opacities, features) = _on(
            device, positions, quats, scales, opacities, features)
        out, overflow = gut.render(
            positions, quats, scales, opacities, features, cam, pose,
            resolution, isect_capacity, shutter=shutter, sh_degree=sh_degree,
            sorted_passes=sorted_passes, T_to_world=T_to_world,
            hit_visibility=True, aux_gradients=False,
            visibility_threshold=visibility_threshold, device=dev)
        scene = compact_visible(positions, quats, scales, opacities,
                                features, out.visibility, n_compact, dev)
        return out, overflow, scene


@torch.no_grad()
def capture_binning(scene: CompactScene, cam: Camera, pose: SensorPose,
                    resolution, isect_capacity: int,
                    shutter: ShutterType = ShutterType.GLOBAL,
                    device="cuda") -> FrozenBinning:
    """Project and bin the compacted scene once (B3, B4), keeping the
    products that `render_frozen` reuses."""
    with record_function("infer.capture"):
        dev = resolve(device)
        scene = scene.to(dev)
        _, binning, _, _ = gut.prepare_packed(
            *scene[:5], tuple_to(cam, dev), tuple_to(pose, dev), resolution,
            isect_capacity, shutter, sh_degree=0)
        return FrozenBinning(
            sorted_idx=binning.sorted_particle_idx,
            particle_ends=binning.particle_ends,
            tile_starts=binning.tile_starts, tile_ends=binning.tile_ends,
            overflow=binning.overflow)


@torch.no_grad()
def render_compact(scene: CompactScene, cam: Camera, pose: SensorPose,
                   resolution, isect_capacity: int,
                   shutter: ShutterType = ShutterType.GLOBAL,
                   sh_degree: int = 3, sorted_passes: int = 0,
                   T_to_world=None, aux_outputs: bool = False,
                   device="cuda") -> Tuple[RenderOutputs, torch.Tensor]:
    """The full per-frame pipeline over the compacted scene (exact for the
    visible set; the error comes only from particles that became visible
    since the refresh). Returns (outputs, isect overflow); `visibility` is
    over the compacted rows. `aux_outputs=True` keeps depth and hit
    count."""
    with record_function("infer.compact"):
        return gut.render(
            *scene[:5], cam, pose, resolution, isect_capacity,
            shutter=shutter, sh_degree=sh_degree,
            sorted_passes=sorted_passes, T_to_world=T_to_world,
            aux_gradients=False, aux_outputs=aux_outputs, device=device)


@torch.no_grad()
def render_frozen(scene: CompactScene, frozen: FrozenBinning, cam: Camera,
                  pose: SensorPose, resolution, sh_degree: int = 3,
                  sorted_passes: int = 16, T_to_world=None,
                  kernel_degree: int = C.KERNEL_DEGREE_3DGUT,
                  min_transmittance: float = C.MIN_TRANSMITTANCE_3DGUT,
                  device="cuda") -> RenderOutputs:
    """Reuse a refresh camera's binning as it is: recompute the rows' SH
    colours for this camera, gather them in the frozen slot order, and
    composite with `sorted_passes` re-sort passes (B1's sorted leg) under a
    global shutter. Exact at the refresh camera itself. Depth and hit count
    are left at zero, and `visibility` is None: a frozen frame runs no
    census (the JAX package returns an all-False mask, ROADMAP C5)."""
    with record_function("infer.frozen"):
        dev = resolve(device)
        scene, frozen = scene.to(dev), FrozenBinning(
            *(x.to(dev) for x in frozen))
        cam, pose = tuple_to(cam, dev), tuple_to(pose, dev)
        if T_to_world is not None:
            T_to_world = torch.as_tensor(T_to_world, dtype=torch.float32,
                                         device=dev)
        w, h = resolution
        wp, hp = gut.pad_to_tiles(resolution)
        tile_grid = (wp // C.TILE_X, hp // C.TILE_Y)
        colors = precomputed_features(scene.positions, scene.features,
                                      camera_center_world(pose), sh_degree)
        packed = gut.pack_particles(scene.positions, scene.quats,
                                    scene.scales, scene.opacities, colors)
        data_sorted = sorted_gather(packed, frozen.sorted_idx,
                                    frozen.particle_ends, "f32")
        rays = gut.packed_world_rays(cam, pose, tile_grid, T_to_world,
                                     shutter=ShutterType.GLOBAL)
        out, _ = tile_raster.tile_composite(
            data_sorted, frozen.tile_starts, frozen.tile_ends, rays,
            kernel_degree, min_transmittance, sorted_passes=sorted_passes,
            has_t_max=False, aux_grads=False, aux_outputs=False)
        img = gut.tile_unpack(out, tile_grid)[:h, :w]
        return RenderOutputs(
            rgb=img[..., 0:3], opacity=img[..., 3], depth=img[..., 4],
            transmittance=img[..., 5], hit_count=img[..., 6],
            visibility=None)
