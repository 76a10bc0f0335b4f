"""The mesh trainer, port of threedgrut_tpu/parallel/trainer.py: the
single-device Trainer's surface (epoch loop, densification on replicated
state, capacity growth, checkpoints, validation) over a (data, tile,
model) mesh of processes, so that `python -m threedgrut_torch.train
--multichip D,T,M` trains. Every rank runs this class; a step takes B = D
views, one per data row, and its gradient is their mean (parallel/dp.py).

Random draws: the trainer's generator (the strategies' draws) is seeded
with cfg.train.seed on every rank, so that densification keeps the state
replicated; a view's draws (ray jitter, the random background) come from a
generator seeded from (cfg.train.seed, data row), the same on the row's
tile and model ranks. With one data row the two are one generator, as in
the single-device Trainer, and a (1, T, M) mesh draws what Trainer draws.

Densification accumulates per view (ROADMAP C18): post_backward runs once
per view of the step, in data-row order, with that view's camera,
position-gradient norm (the norm of its own gradient, at the single-device
step's scale) and hit visibility; post_optimizer_step runs once a step. A
step of B views thus accumulates what B single-view steps would from the
same parameters. The JAX package feeds one statistic a step instead: the
norm of the batch gradient, weighted by the first view's camera.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from threedgrut_torch.config import Config
from threedgrut_torch.model.gaussians import FIELDS, Gaussians
from threedgrut_torch.parallel import dp
from threedgrut_torch.trainer import Trainer, step_fn


def row_seed(seed: int, row: int) -> int:
    """The view generator's seed of a data row (row 0: the run's seed)."""
    return int(seed) + 1_000_003 * int(row)


class DPTrainer(Trainer):
    """Trainer over a mesh. `mesh_shape` (data, tile, model) builds the mesh
    over the initialized process group (dp.make_mesh; a (1, 1, 1) mesh
    needs none); or pass a built `mesh`. `device` is this rank's device.
    Only the 3DGUT rasterizer trains on the mesh (dp.check_supported, a
    ValueError before any group is made)."""

    def __init__(self, cfg: Config, dataset, val_dataset=None,
                 params: Optional[Gaussians] = None, strategy=None,
                 device="cuda", writer=None,
                 mesh_shape: Optional[Tuple[int, int, int]] = None,
                 mesh: Optional[dp.Mesh] = None):
        if mesh is None:
            if mesh_shape is None:
                world = (dist.get_world_size() if dist.is_available()
                         and dist.is_initialized() else 1)
                mesh_shape = (1, world, 1)
            dp.check_supported(cfg, mesh_shape)
            mesh = dp.make_mesh(*mesh_shape)
        else:
            dp.check_supported(cfg, mesh.shape)
        super().__init__(cfg, dataset, val_dataset, params=params,
                         strategy=strategy, device=device, writer=writer)
        self.mesh = mesh
        self.shard = dp.RankShard(mesh)
        self.batch = self.views_per_step = mesh.shape[0]
        if self.batch == 1:
            self.view_generator = self.generator
        else:
            self.view_generator = torch.Generator(device=self.device)
            self.view_generator.manual_seed(
                row_seed(cfg.train.seed, mesh.coords[0]))
        if params is not None:
            self.replicate()

    @property
    def is_main(self) -> bool:
        return self.mesh.rank == 0

    def replicate(self) -> None:
        """Broadcast the parameters, Adam's moments and the strategy's state
        from rank 0."""
        tensors = [getattr(self.params, f) for f in FIELDS]
        if self.opt_state is not None:
            tensors += list(self.opt_state.exp_avg.values())
            tensors += list(self.opt_state.exp_avg_sq.values())
        state = getattr(self.strategy, "state", None)
        if state is not None and dataclasses.is_dataclass(state):
            tensors += [getattr(state, f.name)
                        for f in dataclasses.fields(state)]
        dp.replicate(tensors, self.mesh)

    def train_step_batch(self, views: Sequence) -> Dict[str, Any]:
        """One step on B views (the data rows' views, in row order): this
        rank renders its row's view. Returns the step's aux (the mean loss
        terms and PSNR over the views, the reduced gradients)."""
        view = dp.shard_batch(views, self.mesh)
        with self.lock:
            T, cam, gt, mask, shutter, T_end = self._view_tensors(view)
            self.opt_state, aux = step_fn(
                self.params, self.opt_state, T, cam, gt, mask,
                self.scene_extent, view.resolution, self.active_sh_degree(),
                self.cfg, train=True, generator=self.view_generator,
                shutter=shutter, T_end=T_end,
                isect_capacity=self.isect_capacity, shard=self.shard)
            self.global_step += 1
            # The flag is ORed over the mesh: every rank grows alike.
            self._grow_on_overflow(aux["overflow"])
            t_s = time.perf_counter()
            if self.strategy is not None:
                for i, v in enumerate(views):
                    self.strategy.post_backward(self, v, dict(
                        aux, pos_grad_norm=aux["view_pos_grad_norm"][i],
                        visibility=aux["view_visibility"][i]))
                self.strategy.post_optimizer_step(self, views[0], aux)
            self._strategy_s = time.perf_counter() - t_s
        return aux

    def train_step(self, view) -> Dict[str, Any]:
        """The single-view API: the view repeated on every data row."""
        return self.train_step_batch([view] * self.batch)

    def _step_views(self, views) -> Dict[str, Any]:
        return self.train_step_batch(views)

    def save_checkpoint(self, out_dir: str, name: Optional[str] = None):
        """Rank 0 writes the checkpoint (the state is replicated); every
        rank waits for it."""
        path = None
        if self.is_main:
            path = super().save_checkpoint(out_dir, name)
        if self.mesh.groups["data"] is not None:
            dist.barrier()
        return path

    @classmethod
    def load_checkpoint(cls, path: str, dataset=None, val_dataset=None,
                        device="cuda", strategy=None,
                        mesh_shape: Optional[Tuple[int, int, int]] = None,
                        mesh: Optional[dp.Mesh] = None,
                        **trainer_kw) -> "DPTrainer":
        """Resume on a mesh from any checkpoint of this package or the JAX
        package: every rank reads it (with the strategy's state, as
        Trainer.load_checkpoint restores it), then rank 0's copy is
        broadcast."""
        tr = super().load_checkpoint(path, dataset=dataset,
                                     val_dataset=val_dataset, device=device,
                                     strategy=strategy,
                                     mesh_shape=mesh_shape, mesh=mesh,
                                     **trainer_kw)
        tr.replicate()
        return tr
