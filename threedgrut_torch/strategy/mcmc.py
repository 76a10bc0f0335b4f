"""3DGS-as-MCMC strategy: relocate dead, grow, perturb; port of
threedgrut_tpu/strategy/mcmc.py.

Reference semantics: threedgrut/strategy/mcmc.py + the relocation CUDA kernel
threedgrut/strategy/src/gaussian_mcmc.cu:33-101 —
  * relocate: dead particles (opacity <= threshold) move to multinomially
    sampled live particles (probability proportional to opacity); both source
    and relocated get corrected opacity 1-(1-a)^(1/n) and scale
    a / (sum_{i<=n} sum_{k<i} binom(i-1,k) (-1)^k a_new^{k+1}/sqrt(k+1)) * s
    (Eq. 9 of the MCMC paper).
  * add: grow 5% every 100 steps up to max_n, sampling sources the same way.
  * perturb: positions += Sigma @ (randn * sigmoid(k(threshold_shift - a)) *
    noise_lr * positions_lr) every step.

All three are masked writes made in place on the fixed-capacity parameters.
The relocation math is a closed-form double sum over binom_n_max (51)
terms, a [M, 51] x [51, 51] product: plain torch, as in the JAX package
(the reference's CUDA kernel exists only because torch could not fuse
that loop). The draws are arguments of the pure functions (`relocate(...,
src)`, `add_gaussians(..., src, n_add)`, `perturb(..., noise)`);
MCMCStrategy draws them from the trainer's torch.Generator
(torch.multinomial with replacement, torch.randn), so they are not the
JAX package's numbers.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch.profiler import record_function

from threedgrut_torch.config import StrategyConfig
from threedgrut_torch.device import resolve
from threedgrut_torch.model.gaussians import Gaussians
from threedgrut_torch.ops import quaternion
from threedgrut_torch.optimizers import (AdamState, OptimizerConfig,
                                         positions_lr_schedule)
from threedgrut_torch.strategy.base import BaseStrategy, zero_opt_slots


def binom_table(n_max: int, device="cuda") -> torch.Tensor:
    return torch.tensor([[math.comb(n, k) if k <= n else 0
                          for k in range(n_max)] for n in range(n_max)],
                        dtype=torch.float32, device=resolve(device))


def relocation_correction(opacity: torch.Tensor, scale: torch.Tensor,
                          ratio: torch.Tensor, binoms: torch.Tensor,
                          n_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized port of compute_relocation_kernel (gaussian_mcmc.cu:33-71).

    opacity [M], scale [M, 3], ratio [M] int (clamped to [1, n_max]).
    Returns (new_opacity [M], new_scale [M, 3])."""
    dev = opacity.device
    ratio = torch.clamp(ratio, 1, n_max)
    new_op = 1.0 - torch.pow(1.0 - opacity, 1.0 / ratio.to(opacity.dtype))
    i = torch.arange(1, n_max + 1, device=dev)[:, None]     # [n_max, 1]
    k = torch.arange(0, n_max, device=dev)[None, :]         # [1, n_max]
    # term[i, k] = binom(i-1, k) * (-1)^k / sqrt(k+1) * new_op^(k+1), k <= i-1
    mask_ik = (k <= (i - 1)).to(torch.float32)
    bin_ik = binoms[i - 1, k] * mask_ik
    sign = torch.pow(-1.0, k).to(torch.float32)
    inv_sqrt = 1.0 / torch.sqrt(k + 1.0)
    pow_op = torch.pow(new_op[:, None], k + 1.0)           # [M, n_max]
    inner = bin_ik * sign * inv_sqrt                       # [n_max, n_max]
    # denom[m] = sum_{i=1..ratio_m} sum_k inner[i-1, k] * pow_op[m, k]
    per_i = pow_op @ inner.T                                # [M, n_max] (i-1)
    i_mask = (torch.arange(n_max, device=dev)[None, :]
              < ratio[:, None]).to(torch.float32)
    denom = torch.sum(per_i * i_mask, dim=-1)
    coeff = opacity / torch.clamp(denom, min=1e-12)
    return new_op, coeff[:, None] * scale


def source_probs(params: Gaussians, opacity_threshold: float) -> torch.Tensor:
    """[C] sampling weights of the sources: opacity where live (alive and
    above the threshold), else 0."""
    opacity = params.get_density()
    return torch.where(params.alive & (opacity > opacity_threshold),
                       opacity, 0.0)


def _sample_sources(generator: torch.Generator, probs: torch.Tensor,
                    n: int) -> torch.Tensor:
    """n source slots drawn with replacement in proportion to `probs` (on
    the generator's device); raises where no weight is positive."""
    return torch.multinomial(probs, n, replacement=True, generator=generator)


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def _move_to_sources(params: Gaussians, src: torch.Tensor,
                     moved: torch.Tensor, opacity_threshold: float,
                     binoms: torch.Tensor) -> torch.Tensor:
    """The common part of relocate and add (mcmc.py:100-113): each slot of
    `moved` copies its source src[slot]; each source drawn n times is
    corrected once with ratio n + 1 first (every draw of the same source
    shares that ratio, so this matches the reference's per-draw kernel).
    Returns the number of draws of each slot [C] int32."""
    c = params.capacity
    counts = torch.zeros(c, dtype=torch.int32, device=src.device)
    counts.index_add_(0, src, moved.to(torch.int32))
    picked = counts > 0
    op_src, sc_src = relocation_correction(
        params.get_density(), params.get_scale(), counts + 1, binoms,
        binoms.shape[0])
    eps = torch.finfo(torch.float32).eps
    density_c = torch.where(
        picked[:, None],
        inverse_sigmoid(torch.clamp(op_src, opacity_threshold,
                                    1.0 - eps))[:, None],
        params.density)
    scale_c = torch.where(picked[:, None],
                          torch.log(torch.clamp(sc_src, min=1e-12)),
                          params.scale)
    mm = moved[:, None]
    for f in ("positions", "rotation", "features_albedo",
              "features_specular"):
        p = getattr(params, f)
        p.copy_(torch.where(mm, p[src], p))
    params.density.copy_(torch.where(mm, density_c[src], density_c))
    params.scale.copy_(torch.where(mm, scale_c[src], scale_c))
    return counts


@torch.no_grad()
def relocate(params: Gaussians, opt_state: AdamState, src: torch.Tensor,
             opacity_threshold: float, binoms: torch.Tensor
             ) -> Tuple[AdamState, torch.Tensor]:
    """Move dead (alive but opacity <= threshold) particles to sampled live
    ones, in place. src: [C] int64, a source slot drawn for every slot
    (_sample_sources over source_probs). Returns (opt_state with the
    sources' moments zeroed, the number relocated as a 0-d tensor)."""
    dead = params.alive & (params.get_density() <= opacity_threshold)
    counts = _move_to_sources(params, src, dead, opacity_threshold, binoms)
    return zero_opt_slots(opt_state, counts > 0), dead.sum()


@torch.no_grad()
def add_gaussians(params: Gaussians, opt_state: AdamState,
                  src: torch.Tensor, opacity_threshold: float,
                  binoms: torch.Tensor, n_add: int
                  ) -> Tuple[AdamState, torch.Tensor]:
    """Grow by n_add particles (into the first free slots), in place, each
    a copy of its drawn source src[slot]. Returns (opt_state with the new
    slots' moments zeroed, the number added as a 0-d tensor)."""
    free = ~params.alive
    rank_free = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    take = free & (rank_free < n_add)
    _move_to_sources(params, src, take, opacity_threshold, binoms)
    params.alive |= take
    # The reference's add_new_gaussians appends new gaussians with ZEROED
    # optimizer state and keeps the sources' moments (mcmc.py:138-142) —
    # unlike relocate, which zeroes the sources.
    return zero_opt_slots(opt_state, take), take.sum()


@torch.no_grad()
def perturb(params: Gaussians, noise: torch.Tensor, pos_lr: float,
            noise_lr: float) -> None:
    """positions += Sigma @ (noise * sigmoid(-k(opacity - (1 - thr))) * lr)
    with k=100 (mcmc.py:150-166), in place; noise: [C, 3] standard
    normal draws."""
    opacity = params.get_density()
    gate = torch.sigmoid(100.0 * ((1.0 - opacity) - 0.995))
    n = noise * gate[:, None] * noise_lr * pos_lr
    R = quaternion.to_rotation_matrix(params.get_rotation())
    s2 = params.get_scale() ** 2
    cov = torch.einsum("nij,nj,nkj->nik", R, s2, R)
    delta = torch.einsum("nij,nj->ni", cov, n)
    pos = params.positions
    pos.copy_(torch.where(params.alive[:, None], pos + delta, pos))


class MCMCStrategy(BaseStrategy):
    """The MCMC hooks on the trainer's state. `counts` holds, after each
    post_optimizer_step, the 0-d tensors of the moves that ran
    ("relocate", "add")."""

    def __init__(self, cfg: StrategyConfig, opt_cfg: OptimizerConfig,
                 capacity: int, device="cuda"):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.binoms = binom_table(cfg.mcmc_binom_n_max, device)
        self.counts: Dict[str, torch.Tensor] = {}

    def post_optimizer_step(self, trainer, view, aux) -> None:
        step, cfg, p = trainer.global_step, self.cfg, trainer.params
        thr = cfg.mcmc_opacity_threshold
        self.counts = {}
        # Relocation and growth share the GS densify window/frequency
        # (reference configs/strategy/mcmc.yaml: every 100 in [500, 25000];
        # preset_mcmc sets densify_end=25000 accordingly).
        if (step >= cfg.densify_start and step < cfg.densify_end
                and step % cfg.mcmc_add_frequency == 0):
            # One host read per event, as in the JAX package (which reads
            # the alive count after relocate: relocate does not change it).
            # With no live particle there is nothing to sample from, and
            # both moves are skipped.
            probs = source_probs(p, thr)
            n_live, n_alive = torch.stack(
                [(probs > 0).sum(), p.alive.sum()]).tolist()
            if n_live > 0:
                with record_function("strategy.relocate"):
                    src = _sample_sources(trainer.generator, probs,
                                          p.capacity)
                    trainer.opt_state, self.counts["relocate"] = relocate(
                        p, trainer.opt_state, src, thr, self.binoms)
                target = min(cfg.mcmc_max_gaussians, p.capacity,
                             int(1.05 * n_alive))
                n_add = max(0, target - n_alive)
                if n_add > 0:
                    with record_function("strategy.add"):
                        src = _sample_sources(trainer.generator,
                                              source_probs(p, thr),
                                              p.capacity)
                        trainer.opt_state, self.counts["add"] = \
                            add_gaussians(p, trainer.opt_state, src, thr,
                                          self.binoms, n_add)
        # Position noise every step.
        with record_function("strategy.perturb"):
            noise = torch.randn(p.positions.shape,
                                generator=trainer.generator,
                                device=p.positions.device)
            pos_lr = positions_lr_schedule(self.opt_cfg,
                                           trainer.scene_extent, step)
            perturb(p, noise, pos_lr, cfg.mcmc_noise_lr)
