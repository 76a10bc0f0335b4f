"""Plain PyTorch reference of the timed train step: render, the
0.8 L1 + 0.2 (1 - SSIM) loss, its gradients, Adam, and the MCMC strategy's
position noise. It imports nothing of the program.

A step's gradients reach the raw particle fields through the activations;
the projection, the tile cull and the compositing order are discrete
decisions and carry none, as in the renderers they stand in for.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import render as R

FIELDS = ("positions", "rotation", "scale", "density", "features_albedo",
          "features_specular")
LR = dict(positions=1.6e-4, rotation=1e-3, scale=5e-3, density=0.05,
          features_albedo=2.5e-3, features_specular=2.5e-3 / 20.0)
POSITIONS_LR_FINAL = 1.6e-6
LR_MAX_STEPS = 30000
BETA1, BETA2, EPS = 0.9, 0.999, 1e-15


def ssim(pred, gt, size=11, sigma=1.5):
    """Mean SSIM of [H, W, C] images: a separable 11-tap Gaussian window
    (sigma 1.5) with zero 'same' padding."""
    x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = torch.tensor(g / g.sum(), dtype=pred.dtype, device=pred.device)

    def blur(img):
        c = img.shape[-1]
        t = img.permute(2, 0, 1)[:, None]
        t = F.conv2d(t, g.reshape(1, 1, size, 1), padding=(size // 2, 0))
        t = F.conv2d(t, g.reshape(1, 1, 1, size), padding=(0, size // 2))
        return t[:, 0].permute(1, 2, 0).reshape(img.shape[:2] + (c,))

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mp, mg = blur(pred), blur(gt)
    sp = blur(pred * pred) - mp * mp
    sg = blur(gt * gt) - mg * mg
    spg = blur(pred * gt) - mp * mg
    num = (2 * mp * mg + c1) * (2 * spg + c2)
    den = (mp * mp + mg * mg + c1) * (sp + sg + c2)
    return (num / den).mean()


def loss_fn(pred, gt, keep=None):
    """The training objective. `keep` [H, W] bool takes the mean over the
    kept pixels only (a planted fault: half of the batch left out)."""
    if keep is not None:
        k = keep[..., None].to(pred.dtype)
        l1 = (torch.abs(pred - gt) * k).sum() / (k.sum() * pred.shape[-1])
        return 0.8 * l1 + 0.2 * (1.0 - ssim(pred * k, gt * k))
    return 0.8 * torch.abs(pred - gt).mean() + 0.2 * (1.0 - ssim(pred, gt))


def positions_lr(scene_extent: float, step: float) -> float:
    t = min(max(step / LR_MAX_STEPS, 0.0), 1.0)
    lo = math.log(LR["positions"] * scene_extent)
    hi = math.log(POSITIONS_LR_FINAL * scene_extent)
    return math.exp(lo * (1 - t) + hi * t)


def sh_degree_at(step: int) -> int:
    """Progressive SH: one degree every 1000 steps, from 0 up to 3; `step`
    is the trainer's global step before the step it renders."""
    return min(step // 1000, 3)


def train_steps(mode: str, raw: Dict[str, torch.Tensor], views, gts,
                scene_extent: float, first_step: int, seed: int,
                noise_lr: float = 5e5, keep=None) -> Dict[str, List]:
    """Run len(views) steps from `raw` (a dict of raw fields, copied) with
    zero Adam moments; the trainer's global step before the first is
    `first_step`. The position noise is drawn as the trainer draws it: one
    standard normal [C, 3] a step from a torch.Generator on the fields'
    device seeded with `seed`. Returns each step's loss, the first step's
    gradient per field, and the fields after the last step."""
    dev = raw["positions"].device
    p = {k: v.detach().clone() for k, v in raw.items()}
    m = {f: torch.zeros_like(p[f]) for f in FIELDS}
    v = {f: torch.zeros_like(p[f]) for f in FIELDS}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    losses, first_grad = [], None
    for i, (cam, gt) in enumerate(zip(views, gts)):
        step = first_step + i + 1
        leaves = {f: p[f].detach().requires_grad_(True) for f in FIELDS}
        a = R.activate(dict(leaves, alive=p["alive"]))

        def image_grad(img):
            img = img.detach().requires_grad_(True)
            loss = loss_fn(img, gt, keep)
            (g,) = torch.autograd.grad(loss, img)
            return loss.detach(), g

        loss = R.render_with_grad(mode, a, cam, sh_degree_at(step - 1),
                                  image_grad)
        grads = {f: (leaves[f].grad if leaves[f].grad is not None
                     else torch.zeros_like(p[f])) for f in FIELDS}
        losses.append(float(loss))
        if first_grad is None:
            first_grad = {f: g.clone() for f, g in grads.items()}
        t = float(i + 1)
        bc1, bc2 = 1 - BETA1 ** t, 1 - BETA2 ** t
        with torch.no_grad():
            for f in FIELDS:
                g = grads[f]
                m[f] = BETA1 * m[f] + (1 - BETA1) * g
                v[f] = BETA2 * v[f] + (1 - BETA2) * g * g
                lr = positions_lr(scene_extent, t) if f == "positions" \
                    else LR[f]
                p[f] = p[f] - lr * (m[f] / bc1) / (torch.sqrt(v[f] / bc2)
                                                   + EPS)
            perturb(p, torch.randn(p["positions"].shape, generator=gen,
                                   device=dev).to(p["positions"].dtype),
                    positions_lr(scene_extent, step), noise_lr)
    return dict(losses=losses, first_grad=first_grad, fields=p)


def perturb(p, noise, pos_lr: float, noise_lr: float) -> None:
    """MCMC position noise: positions += Sigma (noise * sigmoid(100 (1 -
    opacity - 0.995)) * noise_lr * pos_lr) on live particles."""
    a = R.activate(p)
    gate = torch.sigmoid(100.0 * ((1.0 - a.opacity) - 0.995))
    n = noise * gate[:, None] * noise_lr * pos_lr
    cov = torch.einsum("nij,nj,nkj->nik", a.rot, a.scales ** 2, a.rot)
    delta = torch.einsum("nij,nj->ni", cov, n)
    p["positions"] = torch.where(p["alive"][:, None],
                                 p["positions"] + delta, p["positions"])
