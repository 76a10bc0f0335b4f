"""Image losses, port of threedgrut_tpu/model/losses.py: L1, L2, SSIM with
an 11x11 Gaussian window (sigma 1.5, zero 'same' padding) and PSNR. The
training objective is lambda_l1 L1 + lambda_l2 L2 + lambda_ssim (1 - SSIM),
with an optional per-pixel mask."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_SSIM_C1 = 0.01 ** 2
_SSIM_C2 = 0.03 ** 2


@functools.lru_cache(maxsize=8)
def _gaussian_window(size: int, sigma: float) -> tuple:
    x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return tuple(float(v) for v in np.asarray(g / np.sum(g), np.float32))


def _blur_axis(img: torch.Tensor, axis: int, w) -> torch.Tensor:
    """1-D 'same' zero-padded correlation along `axis` of [H, W, C], as a
    shift-multiply-accumulate over the taps (the JAX package's form)."""
    half = len(w) // 2
    n = img.shape[axis]
    pad = [0, 0] * img.dim()
    # F.pad lists (before, after) pairs from the last dimension backwards.
    k = 2 * (img.dim() - 1 - axis)
    pad[k], pad[k + 1] = half, half
    xp = F.pad(img, pad)
    acc = None
    for i, wi in enumerate(w):
        term = wi * xp.narrow(axis, i, n)
        acc = term if acc is None else acc + term
    return acc


def _blur(img: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [H, W, C] with 'same' zero padding."""
    w = _gaussian_window(size, sigma)
    return _blur_axis(_blur_axis(img, 0, w), 1, w)


def ssim(pred: torch.Tensor, gt: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over an [H, W, C] image pair in [0, 1]."""
    mu_p = _blur(pred, window_size, sigma)
    mu_g = _blur(gt, window_size, sigma)
    mu_p2, mu_g2, mu_pg = mu_p * mu_p, mu_g * mu_g, mu_p * mu_g
    sigma_p = _blur(pred * pred, window_size, sigma) - mu_p2
    sigma_g = _blur(gt * gt, window_size, sigma) - mu_g2
    sigma_pg = _blur(pred * gt, window_size, sigma) - mu_pg
    num = (2.0 * mu_pg + _SSIM_C1) * (2.0 * sigma_pg + _SSIM_C2)
    den = (mu_p2 + mu_g2 + _SSIM_C1) * (sigma_p + sigma_g + _SSIM_C2)
    return torch.mean(num / den)


def l1(pred, gt, mask=None):
    d = torch.abs(pred - gt)
    if mask is not None:
        return torch.sum(d * mask) / (torch.sum(mask) * pred.shape[-1]
                                      + 1e-12)
    return torch.mean(d)


def l2(pred, gt, mask=None):
    d = (pred - gt) ** 2
    if mask is not None:
        return torch.sum(d * mask) / (torch.sum(mask) * pred.shape[-1]
                                      + 1e-12)
    return torch.mean(d)


def psnr(pred, gt):
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def total_loss(pred, gt, lambda_l1: float = 0.8, lambda_l2: float = 0.0,
               lambda_ssim: float = 0.2, mask=None):
    """The reference training objective. Returns (loss, dict of terms)."""
    terms = {}
    loss = 0.0
    if lambda_l1:
        terms["l1"] = l1(pred, gt, mask)
        loss = loss + lambda_l1 * terms["l1"]
    if lambda_l2:
        terms["l2"] = l2(pred, gt, mask)
        loss = loss + lambda_l2 * terms["l2"]
    if lambda_ssim:
        if mask is not None:
            pred = pred * mask
            gt = gt * mask
        terms["ssim"] = ssim(pred, gt)
        loss = loss + lambda_ssim * (1.0 - terms["ssim"])
    terms["total"] = loss
    return loss, terms
