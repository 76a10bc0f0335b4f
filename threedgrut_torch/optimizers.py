"""Per-field Adam for the Gaussian parameters, with SelectiveAdam; port of
threedgrut_tpu/optimizers.py.

Per-group learning rates with eps 1e-15; the positions LR is scaled by the
scene extent and decays exponentially to positions_lr_final over max_steps;
SelectiveAdam leaves the moments and the parameter of every particle that
was not visible this frame untouched. Bias correction uses the global step.
Written as plain tensor ops (not torch.optim) so the state is the JAX
package's: one (exp_avg, exp_avg_sq) pair per field, shaped like it, and a
step count. `step` writes the new parameter values into the module's
parameters in place and returns a new state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

PARAM_FIELDS = ("positions", "rotation", "scale", "density",
                "features_albedo", "features_specular")


class AdamState(NamedTuple):
    step: int                              # steps taken
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """positions_lr is multiplied by the scene extent and decayed
    exponentially to positions_lr_final."""
    positions_lr: float = 1.6e-4
    positions_lr_final: float = 1.6e-6
    density_lr: float = 0.05
    features_albedo_lr: float = 2.5e-3
    features_specular_lr: float = 2.5e-3 / 20.0
    rotation_lr: float = 1e-3
    scale_lr: float = 5e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-15
    max_steps: int = 30000
    selective: bool = False                # SelectiveAdam visibility gating


def positions_lr_schedule(cfg: OptimizerConfig, scene_extent: float,
                          step: float) -> float:
    """Exponential interpolation lr_init -> lr_final over max_steps."""
    lr_init = cfg.positions_lr * scene_extent
    lr_final = cfg.positions_lr_final * scene_extent
    t = min(max(step / cfg.max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def learning_rates(cfg: OptimizerConfig, scene_extent: float,
                   step: float) -> Dict[str, float]:
    return {
        "positions": positions_lr_schedule(cfg, scene_extent, step),
        "rotation": cfg.rotation_lr,
        "scale": cfg.scale_lr,
        "density": cfg.density_lr,
        "features_albedo": cfg.features_albedo_lr,
        "features_specular": cfg.features_specular_lr,
    }


def init(params) -> AdamState:
    """Zero moments shaped like the parameters of a Gaussians module."""
    return AdamState(
        step=0,
        exp_avg={f: torch.zeros_like(getattr(params, f).detach())
                 for f in PARAM_FIELDS},
        exp_avg_sq={f: torch.zeros_like(getattr(params, f).detach())
                    for f in PARAM_FIELDS})


def state_from_numpy(exp_avg: Dict[str, np.ndarray],
                     exp_avg_sq: Dict[str, np.ndarray], step,
                     device) -> AdamState:
    """The JAX AdamState's moments and step (numpy) -> the port's state on
    `device` (a torch.device or name, see device.resolve)."""
    def t(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=device)
    return AdamState(step=int(step),
                     exp_avg={f: t(exp_avg[f]) for f in PARAM_FIELDS},
                     exp_avg_sq={f: t(exp_avg_sq[f]) for f in PARAM_FIELDS})


@torch.no_grad()
def step(params, grads: Dict[str, torch.Tensor], state: AdamState,
         cfg: OptimizerConfig, scene_extent: float,
         visibility: Optional[torch.Tensor] = None) -> AdamState:
    """One Adam step on the module `params` (updated in place) with the
    per-field gradients `grads`; `visibility` [C] bool enables the
    SelectiveAdam gate when cfg.selective. Returns the new state."""
    new_step = state.step + 1
    t = float(new_step)
    bc1 = 1.0 - cfg.beta1 ** t
    bc2 = 1.0 - cfg.beta2 ** t
    lrs = learning_rates(cfg, scene_extent, t)
    gate = visibility if cfg.selective and visibility is not None else None
    new_m, new_v = {}, {}
    for f in PARAM_FIELDS:
        p = getattr(params, f)
        g = grads[f]
        m, v = state.exp_avg[f], state.exp_avg_sq[f]
        m_new = cfg.beta1 * m + (1.0 - cfg.beta1) * g
        v_new = cfg.beta2 * v + (1.0 - cfg.beta2) * (g * g)
        upd = lrs[f] * (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if gate is not None:
            gf = gate.reshape((-1,) + (1,) * (p.dim() - 1))
            m_new = torch.where(gf, m_new, m)
            v_new = torch.where(gf, v_new, v)
            upd = upd * gf.to(upd.dtype)
        p.sub_(upd)
        new_m[f], new_v[f] = m_new, v_new
    return AdamState(step=new_step, exp_avg=new_m, exp_avg_sq=new_v)
