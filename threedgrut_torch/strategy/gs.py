"""Classic 3DGS densification: clone / split / prune / density reset; port
of threedgrut_tpu/strategy/gs.py.

Reference semantics: threedgrut/strategy/gs.py —
  * post_backward accumulates ||d L/d pos|| * distance-to-camera / 2 per
    visible particle (gs.py:104-115).
  * every `densify_frequency` steps in [start, end): clone small high-grad
    particles (an exact copy in a free slot, gs.py:180-203) and split large
    high-grad ones into `split_n` covariance-sampled samples with scale
    /(0.8*split_n) (gs.py:128-178; the original becomes one of them).
  * prune by opacity < threshold (gs.py:246-260); density reset every 3000
    steps to <= the reset value, ending with the densify window.

The layout is the JAX package's: fixed-capacity parameters and an `alive`
mask. Clone and split targets go to free slots by rank matching (the k-th
needing source to the k-th free slot); every move is a masked write made in
place, with no reallocation and no host read. The random draws are
arguments of the pure functions (`densify(..., n1, n2)`); GSStrategy draws
them from the trainer's torch.Generator, so they are not the JAX package's
numbers.

One fault of the JAX package is not copied (ROADMAP C8): JAX moves and
shrinks every split source, also those that received no free slot, so at
exhausted capacity a split loses its second sample. Here a split moves and
shrinks only a source that received a slot; the others keep their values
and moments until a later event.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from threedgrut_torch.config import StrategyConfig
from threedgrut_torch.device import resolve
from threedgrut_torch.model.gaussians import Gaussians
from threedgrut_torch.ops import quaternion
from threedgrut_torch.optimizers import AdamState
from threedgrut_torch.strategy.base import BaseStrategy, zero_opt_slots


@dataclasses.dataclass
class GSState:
    grad_accum: torch.Tensor   # [C]
    grad_denom: torch.Tensor   # [C] int32
    rolling_vis: torch.Tensor  # [C] EMA of hit-based contribution (the role
                               # of the reference's rolling_weight_contrib,
                               # gs.py:205-221)


def init_state(capacity: int, device="cuda") -> GSState:
    dev = resolve(device)
    return GSState(
        grad_accum=torch.zeros(capacity, dtype=torch.float32, device=dev),
        grad_denom=torch.zeros(capacity, dtype=torch.int32, device=dev),
        rolling_vis=torch.ones(capacity, dtype=torch.float32, device=dev))


@torch.no_grad()
def accumulate(state: GSState, params: Gaussians,
               pos_grad_norm: torch.Tensor, cam_pos: torch.Tensor,
               visibility: torch.Tensor, vis_ema: float = 0.9) -> GSState:
    """pos_grad_norm: [C] = ||dL/dpos|| this step (the step's aux);
    visibility: [C] bool, the hit-based visibility of the step."""
    mask = (pos_grad_norm != 0.0) & params.alive
    dist = torch.linalg.norm(params.positions - cam_pos, dim=-1)
    return GSState(
        grad_accum=state.grad_accum + torch.where(
            mask, pos_grad_norm * dist * 0.5, 0.0),
        grad_denom=state.grad_denom + mask.to(torch.int32),
        rolling_vis=(vis_ema * state.rolling_vis
                     + (1.0 - vis_ema) * (visibility != 0).to(
                         torch.float32)))


def _assign_free_slots(need: torch.Tensor, free: torch.Tensor):
    """Match the k-th needing source to the k-th free slot.

    Returns (take [C] bool over free slots actually used, src [C] int64
    source slot for each free slot; arbitrary where not taken). The k-th
    needing source is the first slot where the count of needing slots
    reaches k + 1: a search, with no scatter and no host read."""
    cum_need = torch.cumsum(need.to(torch.int32), 0, dtype=torch.int32)
    rank_free = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    take = free & (rank_free < cum_need[-1])
    src = torch.searchsorted(cum_need, rank_free + 1).clamp_(
        max=need.shape[0] - 1)
    return take, src


def grad_average(state: GSState) -> torch.Tensor:
    """[C] accumulated gradient over its count (0 where none)."""
    return torch.nan_to_num(torch.where(
        state.grad_denom > 0,
        state.grad_accum / torch.clamp(state.grad_denom, min=1), 0.0))


def densify_masks(params: Gaussians, state: GSState, scene_extent: float,
                  grad_threshold: float, scale_threshold: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(clone_mask, split_mask) [C]: alive particles whose average gradient
    reaches the threshold, small ones (largest scale at most
    scale_threshold * scene_extent) to clone and the rest to split."""
    high = (grad_average(state) >= grad_threshold) & params.alive
    small = params.get_scale().max(dim=-1).values <= float(
        np.float32(scale_threshold) * np.float32(scene_extent))
    return high & small, high & ~small


@torch.no_grad()
def densify(params: Gaussians, opt_state: AdamState, state: GSState,
            n1: torch.Tensor, n2: torch.Tensor, scene_extent: float,
            grad_threshold: float, scale_threshold: float,
            split_scale_factor: float
            ) -> Tuple[AdamState, GSState, Dict[str, torch.Tensor]]:
    """One clone+split pass on `params` (in place). n1, n2: [C, 3] standard
    normal draws, the offsets of a split's first and second sample. Returns
    (opt_state, the reset state, {"clone", "split"}: the sources cloned and
    split, as 0-d tensors)."""
    clone_mask, split_mask = densify_masks(
        params, state, scene_extent, grad_threshold, scale_threshold)
    need = clone_mask | split_mask
    alive = params.alive
    free = ~alive
    take, src = _assign_free_slots(need, free)
    # The sources that received a slot (C8: only these are split).
    got = need & (torch.cumsum(need.to(torch.int32), 0, dtype=torch.int32)
                  <= free.sum(dtype=torch.int32))
    split_done = split_mask & got

    # Covariance-sampled offsets for splits (reference gs.py:142-147):
    # offset = R @ (s * n), n ~ N(0, I).
    scales = params.get_scale()
    R = quaternion.to_rotation_matrix(params.get_rotation())     # [C, 3, 3]
    off_orig = torch.einsum("nij,nj->ni", R, n1 * scales)
    off_new = torch.einsum("nij,nj->ni", R, n2 * scales)
    # log in f32, as the JAX package takes it of its traced scalar.
    split_scale = params.scale - float(
        np.log(np.float32(split_scale_factor)))

    # Free slots take their source's values (a clone's copy or a split's
    # second sample); split sources with a slot move and shrink in place.
    tk = take[:, None]
    from_split = split_mask[src][:, None]
    sd = split_done[:, None]
    pos, scale = params.positions, params.scale
    new_pos = torch.where(
        tk, torch.where(from_split, (pos + off_new)[src], pos[src]),
        torch.where(sd, pos + off_orig, pos))
    new_scale = torch.where(
        tk, torch.where(from_split, split_scale[src], scale[src]),
        torch.where(sd, split_scale, scale))
    pos.copy_(new_pos)
    scale.copy_(new_scale)
    for f in ("rotation", "density", "features_albedo", "features_specular"):
        p = getattr(params, f)
        p.copy_(torch.where(tk, p[src], p))
    params.alive |= take

    # Zero Adam moments for new slots and split originals (the reference
    # zeroes appended/split state; a clone's original keeps its moments).
    opt_state = zero_opt_slots(opt_state, take | split_done)
    counts = {"clone": (clone_mask & got).sum(), "split": split_done.sum()}
    return opt_state, init_state(params.capacity, alive.device), counts


@torch.no_grad()
def prune(params: Gaussians, density_threshold: float) -> torch.Tensor:
    """Drop particles whose opacity is below the threshold (in place).
    Returns how many were alive and went, as a 0-d tensor. (The JAX
    function also passes the optimizer and strategy states through
    unchanged; this one takes neither.)"""
    keep = params.get_density() >= density_threshold
    gone = (params.alive & ~keep).sum()
    params.alive &= keep
    return gone


@torch.no_grad()
def prune_scale(params: Gaussians, cam_positions: torch.Tensor,
                cam_forward: torch.Tensor, max_focal: float,
                threshold: float) -> None:
    """Screen-size pruning (reference gs.py:224-244), in place: remove
    particles whose projected min-scale/depth ratio exceeds `threshold`
    pixels for the nearest camera. cam_positions [K, 3], cam_forward
    [K, 3] unit view directions. As in the JAX package, GSStrategy never
    calls it (StrategyConfig.prune_scale_threshold is read nowhere)."""
    rel = params.positions[:, None, :] - cam_positions[None, :, :]
    depth = torch.einsum("nkc,kc->nk", rel, cam_forward)
    min_depth = torch.clamp(depth.min(dim=1).values, min=1e-8)
    ratio = params.get_scale().min(dim=1).values / min_depth * max_focal
    params.alive &= ratio < threshold


@torch.no_grad()
def prune_weight(params: Gaussians, state: GSState, threshold: float) -> None:
    """Weight-contribution pruning (reference gs.py:205-221), in place: drop
    particles whose rolling hit-based contribution fell below
    `threshold`."""
    params.alive &= state.rolling_vis >= threshold


@torch.no_grad()
def decay_density(params: Gaussians, gamma: float) -> None:
    """density_logit <- logit(gamma * sigmoid(density)), in place:
    multiplicative opacity decay."""
    op = torch.sigmoid(params.density) * gamma
    op = torch.clamp(op, 1e-6, 1.0 - 1e-6)
    params.density.copy_(torch.log(op / (1.0 - op)))


@torch.no_grad()
def reset_density(params: Gaussians, reset_value: float) -> None:
    """density <- min(density, inverse_sigmoid(reset_value)), in place
    (reference gs.py:291-306); the cap is computed in f32, as in JAX."""
    v = torch.tensor(reset_value, dtype=torch.float32)
    params.density.clamp_(max=float(torch.log(v / (1.0 - v))))


class GSStrategy(BaseStrategy):
    """The GS hooks on the trainer's state. `counts` holds, after each
    post_optimizer_step, the 0-d tensors of the events that ran
    ("clone", "split", "prune"), read by whoever wants them."""

    def __init__(self, cfg: StrategyConfig, capacity: int, device="cuda"):
        self.cfg = cfg
        self.state = init_state(capacity, device)
        self.counts: Dict[str, torch.Tensor] = {}

    def post_backward(self, trainer, view, aux) -> None:
        if trainer.global_step <= self.cfg.densify_end \
                or self.cfg.prune_weight_frequency > 0:
            dev = self.state.grad_accum.device
            cam_pos = torch.as_tensor(view.T_to_world, dtype=torch.float32,
                                      device=dev)[:3, 3]
            with record_function("strategy.accumulate"):
                self.state = accumulate(self.state, trainer.params,
                                        aux["pos_grad_norm"], cam_pos,
                                        aux["visibility"],
                                        self.cfg.prune_weight_ema)

    def _due(self, step: int, start: int, end: int, freq: int) -> bool:
        return freq > 0 and start <= step and (end < 0 or step < end) \
            and step % freq == 0

    def post_optimizer_step(self, trainer, view, aux) -> None:
        step, cfg, p = trainer.global_step, self.cfg, trainer.params
        self.counts = {}
        if self._due(step, cfg.densify_start, cfg.densify_end,
                     cfg.densify_frequency):
            with record_function("strategy.densify"):
                n1, n2 = (torch.randn((p.capacity, 3),
                                      generator=trainer.generator,
                                      device=p.positions.device)
                          for _ in range(2))
                trainer.opt_state, self.state, counts = densify(
                    p, trainer.opt_state, self.state, n1, n2,
                    trainer.scene_extent, cfg.densify_grad_threshold,
                    cfg.densify_scale_threshold, 0.8 * cfg.split_n)
            self.counts.update(counts)
            with record_function("strategy.prune"):
                self.counts["prune"] = prune(p, cfg.prune_density_threshold)
        if self._due(step, cfg.prune_weight_start, -1,
                     cfg.prune_weight_frequency):
            with record_function("strategy.prune"):
                prune_weight(p, self.state, cfg.prune_weight_threshold)
        # Density resets END with the densify window (reference
        # configs/strategy/gs.yaml:25-28): an unbounded reset every 3000
        # steps would collapse a converged model for good.
        if self._due(step, cfg.reset_density_frequency, cfg.densify_end,
                     cfg.reset_density_frequency):
            with record_function("strategy.reset"):
                reset_density(p, cfg.reset_density_value)
        if (cfg.density_decay_frequency > 0
                and self._due(step, cfg.density_decay_frequency, -1,
                              cfg.density_decay_frequency)):
            with record_function("strategy.decay"):
                decay_density(p, cfg.density_decay_gamma)
