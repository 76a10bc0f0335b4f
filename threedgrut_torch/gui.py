"""Live training viewer, port of threedgrut_tpu/gui.py (the reference
system's polyscope training GUI): the web viewer renders the trainer's
current parameters on every frame request, so a browser shows the scene
sharpening as training goes on.

    trainer = Trainer(...)
    gui = TrainingGUI(trainer)      # serves on :8080 from a daemon thread
    trainer.run(...)
    gui.close()

The port's Adam updates the parameters in place and densification swaps
them, so a frame renders from a snapshot: the activated tensors cloned
while the trainer's lock (held by train_step and its strategy hooks) is
taken, rendered after it is released. Frames render with the trainer's
current intersection capacity (the JAX GUI renders with the config's
first value and drops the overflow flag, ROADMAP C16) and grow it on
overflow.
"""
from __future__ import annotations

from typing import Tuple

import torch

from threedgrut_torch.cameras import pose_from_matrix
from threedgrut_torch.playground.engine import EngineConfig
from threedgrut_torch.render import gut
from threedgrut_torch.trainer import (MAX_ISECT_CAPACITY, Trainer,
                                      render_params)


class TrainerEngineProxy:
    """Engine-shaped view of a live trainer: its Gaussians rasterized from
    a snapshot taken under the trainer's lock. It has no meshes, so trace
    and hybrid frames are raster frames too."""

    def __init__(self, trainer: Trainer):
        self.trainer = trainer
        self.device = trainer.device
        self.cfg = EngineConfig()     # the viewer panel's state
        self.mesh = None
        self.materials = None
        self.isect_capacity = trainer.isect_capacity

    def snapshot(self):
        """Clones of the trainer's activated tensors, taken under its lock;
        the viewer's SH degree and the capacity follow the trainer's."""
        with self.trainer.lock, torch.no_grad():
            acts = tuple(x.detach().clone()
                         for x in render_params(self.trainer.params))
            self.cfg.sh_degree = self.trainer.active_sh_degree()
            self.isect_capacity = max(self.isect_capacity,
                                      self.trainer.isect_capacity)
        return acts

    @property
    def gaussians(self):
        return self.snapshot()

    @torch.no_grad()
    def render_fitted(self, cam, T_to_world, resolution: Tuple[int, int],
                      hybrid: bool = False, grown=None):
        """A frame of the snapshot, its capacity doubled on overflow up to
        the binning's ceiling, past which it raises."""
        acts = self.snapshot()
        T = torch.as_tensor(T_to_world, dtype=torch.float32,
                            device=self.device)
        pose = pose_from_matrix(T)
        while True:
            out, overflow = gut.render(
                *acts, cam, pose, resolution, self.isect_capacity,
                sh_degree=self.cfg.sh_degree, T_to_world=T,
                device=self.device)
            if not bool(overflow):
                return {"rgb": out.rgb, "opacity": out.opacity,
                        "depth": out.depth, "overflow": overflow}
            if self.isect_capacity >= MAX_ISECT_CAPACITY:
                raise RuntimeError(
                    f"live frame overflows at the ceiling isect_capacity "
                    f"{self.isect_capacity}: the frame would be truncated")
            self.isect_capacity = min(2 * self.isect_capacity,
                                      MAX_ISECT_CAPACITY)
            if grown is not None:
                grown.append(self.isect_capacity)


class TrainingGUI:
    """The web viewer of a live trainer, with /train_status reporting its
    step and logged history."""

    def __init__(self, trainer: Trainer, port: int = 8080,
                 resolution: Tuple[int, int] = (400, 400),
                 target=(0.0, 0.0, 0.0), host: str = "0.0.0.0"):
        from threedgrut_torch.playground.web_viewer import WebViewer

        def status():
            return dict(step=trainer.global_step,
                        history=list(trainer.history))

        self.proxy = TrainerEngineProxy(trainer)
        self.viewer = WebViewer(self.proxy, resolution=resolution,
                                target=target, status_fn=status)
        self.server = self.viewer.serve(port=port, blocking=False, host=host)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
