"""Model-level entry points, port of threedgrut_tpu/api.py: load a scene,
render a camera view (the reference's model.forward) and trace arbitrary
rays (model.trace)."""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from threedgrut_torch import constants as C
from threedgrut_torch.cameras import Camera, SensorPose
from threedgrut_torch.device import resolve
from threedgrut_torch.model.gaussians import FIELDS, Gaussians, from_numpy


def load_scene(path: str, capacity: Optional[int] = None,
               device="cuda") -> Gaussians:
    """Load a scene onto `device`: a 3DGS .ply, an .ingp (both padded to
    `capacity`, default round_capacity of their row count) or the JAX
    package's .npz checkpoint (keys `params/<field>`, at its own
    capacity)."""
    dev = resolve(device)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        from threedgrut_torch.export.ply import import_ply
        return import_ply(path, capacity=capacity, device=dev)
    if ext == ".ingp":
        from threedgrut_torch.export.ingp import import_ingp
        return import_ingp(path, capacity=capacity, device=dev)
    if ext == ".npz":
        with np.load(path) as data:
            return from_numpy({f: data[f"params/{f}"] for f in FIELDS}, dev)
    raise ValueError(f"unsupported scene format {ext!r}")


def render(params: Gaussians, cam: Camera, pose: SensorPose,
           resolution: Tuple[int, int], method: str = "3dgut",
           sh_degree: Optional[int] = None, isect_capacity: int = 1 << 20,
           device="cuda", **kw):
    """Render a camera view on `device`; returns (RenderOutputs, overflow).
    method "3dgut" is the tile rasterizer; "3dgrt" traces each pixel's ray
    (kernel degree 4, candidate capacity max(256, isect_capacity // 256))."""
    deg = sh_degree if sh_degree is not None else params.max_sh_degree
    args = (params.get_positions(), params.get_rotation(),
            params.get_scale(), params.get_density(), params.get_features())
    if method == "3dgut":
        from threedgrut_torch.render import gut
        return gut.render(*args, cam, pose, resolution, isect_capacity,
                          sh_degree=deg, device=device, **kw)
    if method == "3dgrt":
        from threedgrut_torch.render import grt
        return grt.render(*args, cam, pose, resolution, sh_degree=deg,
                          kernel_degree=C.KERNEL_DEGREE_3DGRT,
                          candidate_capacity=max(256, isect_capacity // 256),
                          device=device, **kw)
    raise ValueError(f"unknown method {method!r}")


def trace(params: Gaussians, rays_o, rays_d, sh_degree: Optional[int] = None,
          device="cuda", **kw):
    """Trace arbitrary rays [R, 3] on `device` (the reference's model.trace;
    grt.trace's keywords apply). Rays are padded to a multiple of 256 with
    inactive (zero-direction) rays, and the per-ray outputs cut back."""
    from threedgrut_torch.render import grt
    dev = resolve(device)
    rays_o = torch.as_tensor(rays_o, dtype=torch.float32, device=dev)
    rays_d = torch.as_tensor(rays_d, dtype=torch.float32, device=dev)
    deg = sh_degree if sh_degree is not None else params.max_sh_degree
    r = rays_o.shape[0]
    pad = (-r) % 256
    if pad:
        rays_o = torch.cat([rays_o, rays_o.new_zeros(pad, 3)])
        rays_d = torch.cat([rays_d, rays_d.new_zeros(pad, 3)])
    for name in ("initial_transmittance", "t_max"):
        x = kw.get(name)
        if isinstance(x, (torch.Tensor, np.ndarray)):
            x = torch.as_tensor(x, dtype=torch.float32, device=dev)
            kw[name] = torch.nn.functional.pad(x.reshape(r), (0, pad))
    out = grt.trace(*(x.to(dev) for x in (
        params.get_positions(), params.get_rotation(), params.get_scale(),
        params.get_density(), params.get_features())),
        rays_o, rays_d, sh_degree=deg, **kw)
    if pad:
        out = grt.TraceResult(*(
            x[:r] if (isinstance(x, torch.Tensor) and x.ndim
                      and x.shape[0] == r + pad) else x for x in out))
    return out
