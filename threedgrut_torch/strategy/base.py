"""Strategy lifecycle interface, port of threedgrut_tpu/strategy/base.py.

A strategy's hooks run after each train step: `post_backward` reads the
step's statistics, `post_optimizer_step` changes the scene (densify, prune,
relocate). The parameters keep their capacity-padded shape and identity
(model/gaussians.py): every move is a masked write made in place under
torch.no_grad(), so no kernel ever sees a new shape. The optimizer state
is replaced, never written into: the port's Adam builds new moment tensors
each step (optimizers.step), and so does `zero_opt_slots`.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from threedgrut_torch.optimizers import AdamState


class BaseStrategy:
    def post_backward(self, trainer, view, aux: Dict[str, Any]) -> None:
        """Called after gradients are computed (accumulate statistics)."""

    def post_optimizer_step(self, trainer, view, aux: Dict[str, Any]) -> None:
        """Called after the optimizer step (densify / prune / relocate)."""

    def wants_momentum_buffers(self) -> bool:
        return True


class NoOpStrategy(BaseStrategy):
    pass


def zero_opt_slots(opt_state: AdamState, mask: torch.Tensor) -> AdamState:
    """A new AdamState with both moments zeroed at the slots selected by
    `mask` [C] (the reference zeroes the optimizer state of cloned, split
    and relocated particles, strategy/base.py:52-83)."""
    def z(d):
        return {k: torch.where(mask.reshape((-1,) + (1,) * (v.dim() - 1)),
                               0.0, v) for k, v in d.items()}
    return opt_state._replace(exp_avg=z(opt_state.exp_avg),
                              exp_avg_sq=z(opt_state.exp_avg_sq))
