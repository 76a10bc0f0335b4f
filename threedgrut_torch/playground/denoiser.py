"""Denoisers for the playground's stochastic renders (SPP, depth of field),
port of threedgrut_tpu/playground/denoiser.py; the reference system
toggles OptiX's AI denoiser instead. Plain tensor operations: fixed
stencils of shifted images and exponential weights.

  * `bilateral_denoise`: one depth-guided joint-bilateral pass.
  * `atrous_denoise`: SVGF-style a-trous wavelet filter (Dammertz et al.
    2010, Schied et al. 2017): dilated 5x5 passes whose colour weights
    are normalized by the local luminance deviation, plus depth guidance.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _pad_edge(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-replicate padding of the two leading (H, W) dims."""
    if x.dim() == 2:
        return F.pad(x[None, None], (pad,) * 4, mode="replicate")[0, 0]
    return F.pad(x.permute(2, 0, 1)[None], (pad,) * 4,
                 mode="replicate")[0].permute(1, 2, 0)


def _finite_depth(depth: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))


def bilateral_denoise(rgb: torch.Tensor, depth: Optional[torch.Tensor] = None,
                      radius: int = 2, sigma_space: float = 1.5,
                      sigma_color: float = 0.1,
                      sigma_depth: float = 0.5) -> torch.Tensor:
    """Edge-preserving denoise of [H, W, 3], optionally depth-guided."""
    h, w, _ = rgb.shape
    pad = radius
    rp = _pad_edge(rgb, pad)
    dp = None if depth is None else _pad_edge(_finite_depth(depth), pad)
    acc = torch.zeros_like(rgb)
    wacc = torch.zeros((h, w, 1), device=rgb.device)
    inv2ss = 1.0 / (2.0 * sigma_space ** 2)
    inv2sc = 1.0 / (2.0 * sigma_color ** 2)
    inv2sd = 1.0 / (2.0 * sigma_depth ** 2)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            shifted = rp[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
            wgt = torch.exp(torch.tensor(-(dx * dx + dy * dy) * inv2ss,
                                         dtype=torch.float32))
            cd = torch.sum((shifted - rgb) ** 2, dim=-1, keepdim=True)
            wgt = wgt * torch.exp(-cd * inv2sc)
            if dp is not None:
                ds = dp[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
                dd = (ds - dp[pad:pad + h, pad:pad + w]) ** 2
                wgt = wgt * torch.exp(-dd[..., None] * inv2sd)
            acc = acc + shifted * wgt
            wacc = wacc + wgt
    return acc / torch.clamp(wacc, min=1e-8)


def _luminance(rgb):
    return (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1]
            + 0.0722 * rgb[..., 2])


def _local_variance(lum: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Luminance variance over a (2r+1)^2 neighbourhood (SVGF's spatial
    estimate for a single frame)."""
    h, w = lum.shape
    p = _pad_edge(lum, radius)
    s1 = torch.zeros_like(lum)
    s2 = torch.zeros_like(lum)
    n = (2 * radius + 1) ** 2
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            v = p[radius + dy:radius + dy + h, radius + dx:radius + dx + w]
            s1 = s1 + v
            s2 = s2 + v * v
    mean = s1 / n
    return torch.clamp(s2 / n - mean * mean, min=0.0)


# 1D a-trous B3 spline kernel; its outer product is the 5x5 stencil.
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def atrous_denoise(rgb: torch.Tensor, depth: Optional[torch.Tensor] = None,
                   n_passes: int = 4, sigma_color: float = 4.0,
                   sigma_depth: float = 0.2) -> torch.Tensor:
    """SVGF-style a-trous wavelet denoise of [H, W, 3]: pass i applies the
    5x5 B3-spline stencil dilated by 2^i, with colour weights normalized by
    the local luminance deviation (more noise, more smoothing) and depth
    weights where `depth` is given."""
    h, w, _ = rgb.shape
    out = rgb
    dpth = None if depth is None else _finite_depth(depth)
    for i in range(n_passes):
        step = 1 << i
        pad = 2 * step
        sigma_l = sigma_color * torch.sqrt(_local_variance(
            _luminance(out))) + 1e-4
        rp = _pad_edge(out, pad)
        dp = None if dpth is None else _pad_edge(dpth, pad)
        lum = _luminance(out)
        acc = torch.zeros_like(out)
        wacc = torch.zeros((h, w, 1), device=rgb.device)
        for ky in range(5):
            for kx in range(5):
                dy = (ky - 2) * step
                dx = (kx - 2) * step
                shifted = rp[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
                ld = torch.abs(_luminance(shifted) - lum)
                wgt = (_B3[ky] * _B3[kx]) * torch.exp(-ld / sigma_l)
                if dp is not None:
                    dd = torch.abs(dp[pad + dy:pad + dy + h,
                                      pad + dx:pad + dx + w] - dpth)
                    wgt = wgt * torch.exp(-dd / sigma_depth)
                acc = acc + shifted * wgt[..., None]
                wacc = wacc + wgt[..., None]
        out = acc / torch.clamp(wacc, min=1e-8)
    return out
