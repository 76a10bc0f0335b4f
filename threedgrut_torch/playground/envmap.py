"""Environment maps and tonemapping for the playground, port of
threedgrut_tpu/playground/envmap.py (equirectangular sampling, filmic
tonemap)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def sample_envmap(envmap: Optional[torch.Tensor], dirs: torch.Tensor,
                  default_color=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """Bilinear sample of an equirect [H, W, 3] map along directions
    [..., 3] (polar angle from +z, azimuth from +x); `default_color`
    everywhere when there is no map."""
    if envmap is None:
        return torch.tensor(default_color, dtype=torch.float32,
                            device=dirs.device).expand(dirs.shape[:-1] + (3,))
    h, w = envmap.shape[:2]
    d = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                           min=1e-12)
    theta = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0))
    phi = torch.arctan2(d[..., 1], d[..., 0])
    u = (phi / (2.0 * math.pi) + 0.5) * (w - 1)
    v = theta / math.pi * (h - 1)
    u0 = torch.clamp(torch.floor(u).to(torch.int64), 0, w - 1)
    v0 = torch.clamp(torch.floor(v).to(torch.int64), 0, h - 1)
    u1 = torch.clamp(u0 + 1, max=w - 1)
    v1 = torch.clamp(v0 + 1, max=h - 1)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    return (envmap[v0, u0] * (1 - fu) * (1 - fv)
            + envmap[v0, u1] * fu * (1 - fv)
            + envmap[v1, u0] * (1 - fu) * fv
            + envmap[v1, u1] * fu * fv)


def filmic_tonemap(x: torch.Tensor) -> torch.Tensor:
    """ACES-style filmic curve (the playground's HDR display transform)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(x, 1.0 / 2.4) - 0.055)
