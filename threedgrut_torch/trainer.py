"""Training harness, port of threedgrut_tpu/trainer.py: the train step
(render -> background -> 0.8 L1 + 0.2 DSSIM -> backward -> Adam or
SelectiveAdam) and the eval step, each through the 3DGUT rasterizer or,
with render.method = 3dgrt, the 3DGRT trace; progressive SH, capacity
growth on overflow, densification through a strategy's hooks
(strategy/gs.py, strategy/mcmc.py), checkpoints in the JAX package's .npz
format (loadable without a dataset, for evaluation), and the metrics of a
run: a writer's scalars and validation panels and per-stage host timers.

PyTorch runs eagerly, so a step is a sequence of calls rather than one
compiled program; each phase runs under a `torch.profiler.record_function`
label ("train.forward", "train.loss", "train.backward", "train.adam").
Random draws (the random background, ray jitter) come from the trainer's
torch.Generator, seeded with cfg.train.seed, as do the strategies' (split
offsets, relocation and growth sources, position noise); they are not the
JAX package's numbers.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from threedgrut_torch import optimizers
from threedgrut_torch.cameras import SensorPose, ShutterType, pose_from_matrix
from threedgrut_torch.config import Config, from_dict, to_dict
from threedgrut_torch.device import resolve, tuple_to
from threedgrut_torch.model import background, losses
from threedgrut_torch.model.gaussians import FIELDS, Gaussians, from_numpy
from threedgrut_torch.render import grt, gut

# The capacity ceiling of the binning: particle ids and slots are packed
# with 8 row bits into one 32-bit word (ops/tiles.py).
MAX_ISECT_CAPACITY = (1 << 24) - 256
# The 3DGRT super lists' width in the JAX package (grt.trace's default), and
# the particle count above which its two-level cull runs.
GRT_SUPER_CAPACITY = 8192


def render_params(g: Gaussians):
    """Raw parameters -> post-activation render inputs (differentiable)."""
    return (g.get_positions(), g.get_rotation(), g.get_scale(),
            g.get_density(), g.get_features())


def walk_capacity_for(cfg: Config,
                      isect_capacity: int) -> Optional[int]:
    """The fused backward's bound: walk_compact_fraction of the capacity,
    rounded up to 256 (None when the fraction is 0)."""
    frac = cfg.render.walk_compact_fraction
    if frac <= 0.0:
        return None
    return -(-int(isect_capacity * frac) // 256) * 256


def grt_super_lists(isect_capacity: int) -> Dict[str, int]:
    """The 3DGRT cull's super-list arguments for a capacity. The JAX package
    leaves the super lists at trace's 8192 whatever the capacity, so a scene
    with more particles than that in one super cone overflows at every
    capacity the trainer grows to (ROADMAP C7). Here the super lists grow
    with the capacity, while the two-level cull runs above 8192 particles
    as there: wherever the JAX package does not overflow, the candidate
    lists are its own."""
    return dict(super_capacity=max(GRT_SUPER_CAPACITY, isect_capacity // 32),
                two_level_above=GRT_SUPER_CAPACITY)


def step_fn(params: Gaussians, opt_state: optimizers.AdamState, T_to_world,
            camera, rgb_gt, mask, scene_extent: float, resolution,
            sh_degree: int, cfg: Config, train: bool,
            generator: Optional[torch.Generator] = None, shutter=0,
            T_end=None, isect_capacity: Optional[int] = None, shard=None):
    """One train (or eval) step on the device of `params`, the counterpart
    of the JAX package's _step_fn. Inputs are tensors on that device. A
    train step updates `params` in place and returns (new opt_state, aux);
    an eval step returns (opt_state, aux) with the prediction and the
    hit-based visibility.

    `shard` (parallel/dp.RankShard, train steps of the 3DGUT rasterizer
    only) makes it one rank's part of a step over a (data, tile, model)
    mesh: the render runs on the rank's particle shard and tile strip, and
    before Adam the gradients, visibility, overflow flag and metrics are
    reduced over the mesh (RankShard.reduce: the mean over the data rows'
    views, the same on every rank); aux then also holds each view's
    position-gradient norm and visibility ("view_pos_grad_norm",
    "view_visibility", [B, N])."""
    dev = params.positions.device
    if shard is not None:
        shard.check_step(cfg, train)
    pose = pose_from_matrix(T_to_world)
    shutter = ShutterType(shutter)
    if isect_capacity is None:
        isect_capacity = cfg.render.isect_capacity
    if T_end is not None:
        pose_end = pose_from_matrix(T_end)
        pose = SensorPose(q_start=pose.q_start, t_start=pose.t_start,
                          q_end=pose_end.q_start, t_end=pose_end.t_start)
    if cfg.render.method not in ("3dgut", "3dgrt"):
        raise ValueError(f"unknown render.method {cfg.render.method!r}")
    jitter = None
    if train and cfg.render.ray_jitter and cfg.render.method == "3dgut":
        # The trace takes no jitter (as the JAX package's).
        jitter = torch.rand((resolution[1], resolution[0], 2),
                            generator=generator, device=dev)
    with torch.set_grad_enabled(train):
        with record_function("train.forward"):
            if cfg.render.method == "3dgrt":
                # The visibility is the cone-level bit, as the JAX
                # package's (training ands it with the hits below).
                out, overflow = grt.render(
                    *render_params(params), camera, pose, resolution,
                    sh_degree=sh_degree,
                    kernel_degree=cfg.render.particle_kernel_degree,
                    min_transmittance=cfg.render.min_transmittance,
                    candidate_capacity=isect_capacity // 256,
                    flat_capacity=isect_capacity, T_to_world=T_to_world,
                    density_clamping=(
                        cfg.render.particle_kernel_density_clamping),
                    surfel=cfg.render.surfel_primitive,
                    walk_capacity=(walk_capacity_for(cfg, isect_capacity)
                                   if train else None),
                    **grt_super_lists(isect_capacity), device=dev)
            else:
                out, overflow = gut.render(
                    *render_params(params), camera, pose, resolution,
                    isect_capacity, shutter=shutter, sh_degree=sh_degree,
                    kernel_degree=cfg.render.particle_kernel_degree,
                    min_transmittance=cfg.render.min_transmittance,
                    tile_culling=cfg.render.tile_culling, T_to_world=T_to_world,
                    ray_jitter=jitter, sorted_passes=cfg.render.k_buffer_passes,
                    # The loss reads only rgb (and opacity through the
                    # background): no depth/transmittance cotangents, and in
                    # training no depth/hit-count forward either.
                    aux_gradients=False, aux_outputs=not train,
                    low_precision_grads=cfg.render.low_precision_grads and train,
                    row_termination=cfg.render.row_termination,
                    # Eval reads the kernel's contributed bit; training derives
                    # it from nonzero gradients below.
                    hit_visibility=not train,
                    walk_capacity=(walk_capacity_for(cfg, isect_capacity)
                                   if train else None),
                    shard=shard, device=dev)
            pred = background.compose(out.rgb, out.opacity,
                                      cfg.model.background_color,
                                      train=train, generator=generator)
        with record_function("train.loss"):
            loss, terms = losses.total_loss(
                pred, rgb_gt, cfg.loss.lambda_l1, cfg.loss.lambda_l2,
                cfg.loss.lambda_ssim, mask if cfg.loss.use_mask else None)
    if not train:
        return opt_state, dict(
            terms=terms, psnr=losses.psnr(pred, rgb_gt), pred=pred,
            visibility=out.visibility, overflow=overflow,
            opacity=out.opacity, depth=out.depth, hit_count=out.hit_count)

    fields = [getattr(params, f) for f in optimizers.PARAM_FIELDS]
    with record_function("train.backward"):
        grads = dict(zip(optimizers.PARAM_FIELDS,
                         torch.autograd.grad(loss, fields)))
    terms = {k: v.detach() for k, v in terms.items()}
    psnr = losses.psnr(pred.detach(), rgb_gt)
    cone_vis = out.visibility
    extra = {}
    if shard is not None:
        with record_function("train.reduce"):
            grads, cone_vis, overflow, terms, psnr, extra = shard.reduce(
                grads, cone_vis, overflow, terms, psnr)
    # Hit-based visibility: a particle composited with weight > 0 this
    # frame. Occluded, culled and unwalked particles get exactly-zero
    # gradients through every path, so nonzero gradient == contributed.
    cap = params.capacity
    hit_vis = torch.zeros(cap, dtype=torch.bool, device=dev)
    for g in grads.values():
        hit_vis |= (g.reshape(cap, -1) != 0.0).any(-1)
    visibility = cone_vis & hit_vis
    with record_function("train.adam"):
        new_opt = optimizers.step(params, grads, opt_state, cfg.optimizer,
                                  scene_extent, visibility=visibility)
    aux = dict(terms=terms, psnr=psnr, pred=pred.detach(),
               visibility=visibility, overflow=overflow, grads=grads,
               pos_grad_norm=torch.linalg.norm(grads["positions"], dim=-1),
               **extra)
    return new_opt, aux


class Trainer:
    """Single-card trainer. `strategy` (strategy/gs.GSStrategy,
    strategy/mcmc.MCMCStrategy or None) densifies the scene after each
    step, as the JAX package's Trainer does: post_backward, then
    post_optimizer_step, after the overflow handling. Its state must live
    on the trainer's device. `writer` (utils/writer.MetricsWriter or None)
    receives run()'s scalars and validation panels. `dataset` may be None
    for a trainer that only evaluates (load_checkpoint(dataset=None)); its
    scene extent then comes from the checkpoint."""

    def __init__(self, cfg: Config, dataset, val_dataset=None,
                 params: Optional[Gaussians] = None, strategy=None,
                 device="cuda", writer=None):
        self.cfg = cfg
        self.device = resolve(device)
        self.dataset = dataset
        self.val_dataset = val_dataset
        self.strategy = strategy
        self.writer = writer
        self.scene_extent = (float(dataset.scene_extent)
                             if dataset is not None else None)
        self.global_step = 0
        self.params = params
        self.opt_state = (optimizers.init(params) if params is not None
                          else None)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.train.seed)
        self.isect_capacity = cfg.render.isect_capacity
        # The overflow flag of a step is acted on after the next one (the
        # JAX package reads it one step late so the readback overlaps
        # compute); the step that overflowed is slightly truncated.
        self._pending_overflow = None
        self._mask_cache: Dict[tuple, torch.Tensor] = {}
        self.history: list = []
        # The stage timers of run(), per step for the last 1000 steps: dicts
        # of step, data_ms (fetching the view, decoding it on first
        # access), step_ms (train_step, its strategy hooks included),
        # strategy_ms (the hooks) and, on a step whose strategy event ran,
        # its counts ("events"). step_ms ("train/time_step_ms") is host time
        # around an asynchronous step: it returns with launches still
        # running on the card, so it counts this step's launches and
        # whatever earlier work its host reads (the previous step's
        # overflow flag, the walked-window count) wait for.
        self.step_times: collections.deque = collections.deque(maxlen=1000)
        self._strategy_s = 0.0     # the last train_step's hooks
        # Held by train_step (Adam updates the parameters in place, the
        # strategies swap them): a reader on another thread (gui.py) takes
        # it to copy a consistent snapshot.
        self.lock = threading.RLock()

    # ---- progressive SH ----
    def active_sh_degree(self) -> int:
        m = self.cfg.model
        if m.progressive_sh_interval <= 0:
            return m.max_sh_degree
        return min(m.n_active_features
                   + self.global_step // m.progressive_sh_interval,
                   m.max_sh_degree)

    def _view_tensors(self, view):
        dev = self.device
        if view.mask is not None:
            mask = torch.as_tensor(view.mask, dtype=torch.float32,
                                   device=dev)
        else:
            key = tuple(view.resolution)
            mask = self._mask_cache.get(key)
            if mask is None:
                mask = torch.ones(view.resolution[::-1] + (1,), device=dev)
                self._mask_cache[key] = mask
        T = torch.as_tensor(view.T_to_world, dtype=torch.float32, device=dev)
        T_end = (torch.as_tensor(view.pose_end, dtype=torch.float32,
                                 device=dev)
                 if getattr(view, "pose_end", None) is not None else None)
        return (T, tuple_to(view.camera, dev),
                torch.as_tensor(view.rgb_gt, dtype=torch.float32, device=dev),
                mask, int(getattr(view, "shutter", 0)), T_end)

    def train_step(self, view) -> Dict[str, Any]:
        with self.lock:
            return self._train_step(view)

    def _train_step(self, view) -> Dict[str, Any]:
        T, cam, gt, mask, shutter, T_end = self._view_tensors(view)
        self.opt_state, aux = step_fn(
            self.params, self.opt_state, T, cam, gt, mask, self.scene_extent,
            view.resolution, self.active_sh_degree(), self.cfg, train=True,
            generator=self.generator, shutter=shutter, T_end=T_end,
            isect_capacity=self.isect_capacity)
        self.global_step += 1
        self._grow_on_overflow(aux["overflow"])
        t_s = time.perf_counter()
        if self.strategy is not None:
            self.strategy.post_backward(self, view, aux)
            self.strategy.post_optimizer_step(self, view, aux)
        self._strategy_s = time.perf_counter() - t_s
        return aux

    def _grow_on_overflow(self, overflow) -> None:
        """Act on the previous step's overflow flag (read one step late):
        double the capacity, up to MAX_ISECT_CAPACITY."""
        prev_ovf, self._pending_overflow = (self._pending_overflow,
                                            overflow)
        if prev_ovf is not None and bool(prev_ovf):
            grown = min(self.isect_capacity * 2, MAX_ISECT_CAPACITY)
            if grown == self.isect_capacity:
                print(f"isect overflow at step {self.global_step - 1}; "
                      f"capacity already at the 2^24 packing ceiling "
                      f"({MAX_ISECT_CAPACITY}); continuing with truncation",
                      flush=True)
            else:
                self.isect_capacity = grown
                print(f"isect overflow at step {self.global_step - 1}; "
                      f"capacity -> {self.isect_capacity}", flush=True)
            # The step just run also used the old capacity; its flag
            # reports the shortage already answered.
            self._pending_overflow = None

    # Views a step of run() takes, and the step on them (DPTrainer takes
    # one per data row).
    views_per_step = 1

    def _step_views(self, views) -> Dict[str, Any]:
        return self.train_step(views[0])

    def eval_view(self, view) -> Dict[str, Any]:
        """Eval step with grow-and-retry: a truncated eval image is never
        scored."""
        T, cam, gt, mask, shutter, T_end = self._view_tensors(view)
        for _ in range(8):
            _, aux = step_fn(
                self.params, self.opt_state, T, cam, gt, mask,
                self.scene_extent, view.resolution, self.active_sh_degree(),
                self.cfg, train=False, shutter=shutter, T_end=T_end,
                isect_capacity=self.isect_capacity)
            if not bool(aux["overflow"]):
                break
            self.isect_capacity *= 2
            print(f"isect overflow during eval; capacity -> "
                  f"{self.isect_capacity}", flush=True)
        return aux

    def validate(self) -> Dict[str, float]:
        ds = self.val_dataset or self.dataset
        psnrs, ssims, n_ovf = [], [], 0
        for i in range(len(ds)):
            aux = self.eval_view(ds[i])
            psnrs.append(float(aux["psnr"]))
            ssims.append(float(aux["terms"].get("ssim", float("nan"))))
            n_ovf += int(bool(aux["overflow"]))
        out = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
        if n_ovf:
            out["overflow_views"] = n_ovf
            print(f"WARNING: {n_ovf}/{len(ds)} val renders overflowed "
                  f"isect capacity {self.isect_capacity}", flush=True)
        return out

    def run(self, iterations: Optional[int] = None, log_every: int = 100,
            out_dir: Optional[str] = None):
        """Train for `iterations` (default cfg.train.iterations) steps over
        the dataset's shuffled epochs. Every `log_every` steps: a console
        line, a history entry and, with a writer, the loss terms, PSNR,
        particle count, it/s and each stage's host ms per step since the
        last log point ("train/time_<stage>_ms", from step_times).
        Checkpoints at cfg.train.checkpoint_iterations, validation (and its
        panels) every cfg.train.val_frequency steps, ckpt_last at the
        end."""
        from threedgrut_torch.datasets.protocols import iterate_epochs
        iters = iterations or self.cfg.train.iterations
        stream = iterate_epochs(len(self.dataset), self.cfg.train.seed)
        t0 = time.time()
        for _ in range(iters):
            t_d = time.perf_counter()
            views = [self.dataset[next(stream)]
                     for _ in range(self.views_per_step)]
            t_s = time.perf_counter()
            aux = self._step_views(views)
            t_e = time.perf_counter()
            entry = dict(step=self.global_step, data_ms=1e3 * (t_s - t_d),
                         step_ms=1e3 * (t_e - t_s),
                         strategy_ms=1e3 * self._strategy_s)
            # A step whose strategy event ran: its counts (one host read
            # per event).
            counts = getattr(self.strategy, "counts", None)
            if counts:
                entry["events"] = {k: int(v) for k, v in counts.items()}
            self.step_times.append(entry)
            if log_every and self.global_step % log_every == 0:
                loss = float(aux["terms"]["total"])
                psnr = float(aux["psnr"])
                rate = self.global_step / (time.time() - t0)
                print(f"step {self.global_step:6d} loss {loss:.4f} "
                      f"psnr {psnr:.2f} it/s {rate:.1f}", flush=True)
                alive = int(self.params.num_active())
                self.history.append(dict(
                    step=self.global_step, loss=loss, psnr=psnr,
                    particles=alive, it_s=rate))
                del self.history[:-500]
                if self.writer is not None:
                    self.writer.scalars(aux["terms"], self.global_step,
                                        prefix="train/loss_")
                    self.writer.scalar("train/psnr", psnr, self.global_step)
                    self.writer.scalar("train/num_particles", alive,
                                       self.global_step)
                    self.writer.scalar("train/it_per_s", rate,
                                       self.global_step)
                    recent = list(self.step_times)[-log_every:]
                    for k in ("data", "step", "strategy"):
                        self.writer.scalar(
                            f"train/time_{k}_ms",
                            sum(e[f"{k}_ms"] for e in recent) / len(recent),
                            self.global_step)
            ckpts = self.cfg.train.checkpoint_iterations
            if out_dir and self.global_step in ckpts:
                self.save_checkpoint(out_dir)
            if (self.cfg.train.val_frequency
                    and self.global_step % self.cfg.train.val_frequency == 0
                    and self.val_dataset is not None):
                metrics = self.validate()
                print(f"val @ {self.global_step}: {metrics}", flush=True)
                if self.writer is not None:
                    self.writer.scalars(metrics, self.global_step,
                                        prefix="val/")
                    self.log_val_images()
        if out_dir:
            self.save_checkpoint(out_dir, name="ckpt_last")
        return self

    # Validation panels: pred, gt, hit-count and inverse-depth jet maps and
    # opacity at these view ids of the validation set.
    _VAL_VIEW_IDS = (0, 13, 27, 43, 78)

    def log_val_images(self) -> None:
        from threedgrut_torch.utils.writer import jet_colormap
        ds = self.val_dataset or self.dataset
        for vid in self._VAL_VIEW_IDS:
            if vid >= len(ds):
                continue
            view = ds[vid]
            aux = self.eval_view(view)
            pred, hits, depth, opacity = (
                aux[k].detach().cpu().numpy()
                for k in ("pred", "hit_count", "depth", "opacity"))
            tagp = f"val_{vid}"
            step = self.global_step
            self.writer.image(f"{tagp}/pred", pred, step)
            self.writer.image(f"{tagp}/gt", np.asarray(view.rgb_gt), step)
            self.writer.image(
                f"{tagp}/hits_jet",
                jet_colormap(hits / max(1.0, float(hits.max()))), step)
            inv = np.where(depth > 1e-6, 1.0 / np.maximum(depth, 1e-6), 0.0)
            inv = inv / max(1e-6, float(inv.max()))
            self.writer.image(f"{tagp}/inv_depth_jet", jet_colormap(inv),
                              step)
            self.writer.image(f"{tagp}/opacity",
                              np.repeat(opacity[..., None], 3, -1), step)

    # ---- checkpoints: the JAX package's .npz keys and .json config ----
    def save_checkpoint(self, out_dir: str, name: Optional[str] = None):
        os.makedirs(out_dir, exist_ok=True)
        name = name or f"ckpt_{self.global_step}"
        path = os.path.join(out_dir, f"{name}.npz")
        flat = {f"params/{f}": getattr(self.params, f).detach().cpu().numpy()
                for f in FIELDS}
        for f in optimizers.PARAM_FIELDS:
            flat[f"m/{f}"] = self.opt_state.exp_avg[f].cpu().numpy()
            flat[f"v/{f}"] = self.opt_state.exp_avg_sq[f].cpu().numpy()
        flat["opt_step"] = np.asarray(self.opt_state.step, np.int32)
        flat["global_step"] = np.int64(self.global_step)
        flat["scene_extent"] = np.float64(self.scene_extent)
        flat["isect_capacity"] = np.int64(self.isect_capacity)
        # Densification buffers travel with the checkpoint.
        strat_state = getattr(self.strategy, "state", None)
        if strat_state is not None and dataclasses.is_dataclass(strat_state):
            for f in dataclasses.fields(strat_state):
                flat[f"strategy/{f.name}"] = getattr(
                    strat_state, f.name).cpu().numpy()
        # Atomic: a process killed mid-save never leaves a truncated file.
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **flat)
        os.replace(tmp, path)
        with open(os.path.join(out_dir, f"{name}.json"), "w") as fh:
            json.dump(to_dict(self.cfg), fh, indent=2)
        return path

    @classmethod
    def load_checkpoint(cls, path: str, dataset=None, val_dataset=None,
                        device="cuda", strategy=None,
                        **trainer_kw) -> "Trainer":
        """Resume from a checkpoint written by this class or by the JAX
        package's Trainer (same keys; its .json config beside it). With no
        dataset the trainer can evaluate views (render_eval.Renderer); its
        scene extent is the checkpoint's, as it is for a resumed run. The
        `strategy/<field>` keys, where present, restore `strategy`'s state
        on the device its state already lives on. `trainer_kw` go to the
        class's constructor."""
        with open(path.replace(".npz", ".json")) as fh:
            cfg = from_dict(json.load(fh))
        dev = resolve(device)
        with np.load(path) as data:
            params = from_numpy({f: data[f"params/{f}"] for f in FIELDS},
                                dev)
            trainer = cls(cfg, dataset, val_dataset, params=params,
                          strategy=strategy, device=dev, **trainer_kw)
            trainer.opt_state = optimizers.state_from_numpy(
                {f: data[f"m/{f}"] for f in optimizers.PARAM_FIELDS},
                {f: data[f"v/{f}"] for f in optimizers.PARAM_FIELDS},
                data["opt_step"], dev)
            trainer.global_step = int(data["global_step"])
            trainer.scene_extent = float(data["scene_extent"])
            if "isect_capacity" in data:
                trainer.isect_capacity = int(data["isect_capacity"])
            strat_state = getattr(strategy, "state", None)
            if strat_state is not None \
                    and dataclasses.is_dataclass(strat_state):
                restored = {
                    f.name: torch.tensor(
                        data[f"strategy/{f.name}"],
                        device=getattr(strat_state, f.name).device)
                    for f in dataclasses.fields(strat_state)
                    if f"strategy/{f.name}" in data}
                if restored:
                    strategy.state = dataclasses.replace(strat_state,
                                                         **restored)
        return trainer
