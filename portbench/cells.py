"""The drivers a traffic file's "kind" selects: "train" drives
Trainer.train_step over the capture ring, "video" drives api.render along
the fly-through path, "hybrid" drives the playground's
Engine.render_hybrid along an orbit. Each builds the system under test
from the cell's configuration and the seed, warms every shape the window
uses, runs the window (or, traced, the traffic's traced units), and keeps
what the comparison needs. The reference runs only after the program's state is
freed and the memory peak is read.
"""
from __future__ import annotations

import gc
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from portbench import check, readers, scene, tracing, work
from portbench.reference import render as ref_render
from portbench.reference import train as ref_train

FIELDS = ("positions", "rotation", "scale", "density", "features_albedo",
          "features_specular")


class RingData:
    """The trainer's dataset: the ring's views, decoded frames in host
    memory, and the scene extent."""

    def __init__(self, views, extent):
        self.views, self.scene_extent = views, extent

    def __len__(self):
        return len(self.views)

    def __getitem__(self, i):
        return self.views[i]


def program_camera(cfg, width=None, height=None):
    from threedgrut_torch.cameras import PinholeCamera
    s = cfg["scene"]
    w, h = width or s["width"], height or s["height"]
    f = s["focal"] * w / s["width"]
    z = np.zeros
    return PinholeCamera(focal=np.array([f, f], np.float32),
                         principal=np.array([w / 2.0, h / 2.0], np.float32),
                         radial=z(6, np.float32), tangential=z(2, np.float32),
                         thin_prism=z(4, np.float32))


def gaussians(raw):
    from threedgrut_torch.model.gaussians import Gaussians
    return Gaussians(**{f: raw[f].clone() for f in FIELDS},
                     alive=raw["alive"].clone())


def free_device():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """What a run reports: the window's end-to-end numbers or the traced
    window's reduction, the comparison's numbers, and notes that make it
    not correct."""

    def __init__(self):
        self.metrics: Dict[str, float] = {}
        self.trace_ctx = None
        self.attempted = 0
        self.failed = 0
        self.faults = []
        self.numbers: Dict[str, float] = {}
        self.step_times = []
        self.memory_peak = 0
        self.setup_done = None


def train(cfg, traffic, seed, seconds, trace, device, out_dir: Path,
          run: Run, mark_setup):
    from threedgrut_torch import config as tcfg
    from threedgrut_torch.datasets.protocols import View
    from threedgrut_torch.strategy.mcmc import MCMCStrategy
    from threedgrut_torch.trainer import Trainer

    c = tcfg.make(cfg["preset"], cfg["overrides"])
    c.train.seed = int(seed)
    c.render.isect_capacity = cfg["isect_capacity"]
    s = cfg["scene"]
    w, h = s["width"], s["height"]
    poses = scene.ring_poses(cfg)
    gts = scene.ground_truth(cfg, seed, len(poses), device)
    cam = program_camera(cfg)
    views = [View(T_to_world=T, camera=cam, resolution=(w, h), rgb_gt=g)
             for T, g in zip(poses, gts)]
    extent = scene.scene_extent(poses)
    raw = scene.particles(cfg, seed, device)
    start = {f: raw[f].clone() for f in FIELDS}
    params = gaussians(raw)
    del raw
    strategy = MCMCStrategy(c.strategy, c.optimizer, params.capacity, device)
    trainer = Trainer(c, RingData(views, extent), params=params,
                      strategy=strategy, device=device)
    trainer.global_step = cfg["global_step_at_start"]
    k = 0       # steps taken: the ring is walked in order from view 0
    # The steps the reference follows, then warm-up through the next
    # relocation event and one step past it.
    n_cmp = traffic["compare_steps"]
    losses, grad_norms = [], None
    for i in range(n_cmp):
        aux = trainer.train_step(views[k % len(views)])
        k += 1
        losses.append(float(aux["terms"]["total"]))
        if i == 0:
            b1 = 1.0 - c.optimizer.beta1
            grad_norms = {f: float(torch.linalg.norm(
                (trainer.opt_state.exp_avg[f] / b1).double()))
                for f in FIELDS}
    change_norms = {f: float(torch.linalg.norm(
        (getattr(trainer.params, f).detach() - start[f]).double()))
        for f in FIELDS}
    del start, aux
    period = c.strategy.mcmc_add_frequency
    while True:
        trainer.train_step(views[k % len(views)])
        k += 1
        if trainer.global_step % period == 1:
            break
    sync(device)
    run.attempted = 0
    if not trace:
        mark_setup()
        t0 = time.perf_counter()
        stamps = []
        while True:
            trainer.train_step(views[k % len(views)])
            k += 1
            run.attempted += 1
            stamps.append(time.perf_counter())
            if stamps[-1] - t0 >= seconds:
                break
        sync(device)
        t1 = time.perf_counter()
        run.metrics["train_rays_per_s"] = run.attempted * w * h / (t1 - t0)
        run.step_times = [b - a for a, b in zip([t0] + stamps, stamps)]
    else:
        mark_setup()
        rec = work.LaunchRecorder()

        def units():
            nonlocal k
            with rec:
                for _ in range(traffic["trace_steps"]):
                    trainer.train_step(views[k % len(views)])
                    k += 1
            return traffic["trace_steps"]

        tr = tracing.traced(units, out_dir)
        run.attempted = tr.units
        n = int(trainer.params.alive.sum())
        other = tr.units * work.step_ops(n, trainer.params.capacity, w * h,
                                         True)
        run.trace_ctx = readers.Context("train", tr, rec.work(), other,
                                        rec.extra_kernels)
    if trainer.isect_capacity != cfg["isect_capacity"]:
        run.faults.append(f"isect_capacity grew to {trainer.isect_capacity}")
    if device.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(device)
    del trainer, strategy, params, views
    free_device()

    # The reference over the same first steps.
    reference_precision()
    ref = reference_train(cfg, traffic, seed, device, gts, poses, extent)
    run.numbers = check.train_numbers(
        dict(losses=losses, grad_norms=grad_norms,
             change_norms=change_norms), ref)


def reference_train(cfg, traffic, seed, device, gts, poses, extent,
                    dtype=torch.float32, keep=None):
    raw = scene.particles(cfg, seed, device)
    n = traffic["compare_steps"]
    cams = [scene.camera(cfg, T, device) for T in poses[:n]]
    gt_dev = [torch.tensor(g, device=device, dtype=dtype) for g in gts[:n]]
    start = {f: raw[f].to(dtype) if raw[f].is_floating_point() else raw[f]
             for f in raw}
    cams = [c._replace(c2w=c.c2w.to(dtype)) for c in cams]
    ref = ref_train.train_steps(cfg["renderer"], start, cams, gt_dev, extent,
                                cfg["global_step_at_start"], seed,
                                keep=keep)
    ref["start"] = start
    return ref


def reference_precision():
    """float32 matrix products without TF32 for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_sample(seed, traffic):
    """The frames drawn from the seed for the check: check_frames of the
    first check_within."""
    rng = np.random.default_rng(int(seed))
    return set(int(i) for i in rng.choice(traffic["check_within"],
                                          traffic["check_frames"],
                                          replace=False))


def frame_buffer(w, h, device):
    """The client's frame buffer: page-locked host memory, reused frame
    after frame; a frame drawn for the check is copied out of it."""
    return torch.empty((h, w, 3), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


def frames(frame, traffic, seconds, trace, device, out_dir, run, mark_setup,
           sample, kind, ops_per_frame):
    """Warm up, then render frames back to back: for `seconds` (the
    window's seconds a frame in run.metrics["frame_s"], each frame's time
    in run.step_times) or, traced, the traffic's trace_frames. Returns the
    frames drawn for the check, and marks those that never came."""
    kept = {}
    for i in range(traffic["warm_frames"]):
        frame(i)
    sync(device)
    mark_setup()
    if not trace:
        times, i = [], 0
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            img = frame(i)
            b = time.perf_counter()
            times.append(b - a)
            if i in sample:
                kept[i] = img.clone()
            i += 1
            if b - t0 >= seconds:
                break
        run.attempted = i
        run.metrics["frame_s"] = (time.perf_counter() - t0) / i
        run.step_times = times
    else:
        rec = work.LaunchRecorder()
        n = traffic["trace_frames"]

        def units():
            with rec:
                for i in range(n):
                    img = frame(i)
                    if i in sample:
                        kept[i] = img.clone()
            return n

        tr = tracing.traced(units, out_dir)
        run.attempted = n
        run.trace_ctx = readers.Context(kind, tr, rec.work(),
                                        n * ops_per_frame, rec.extra_kernels)
    if device.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(device)
    missing = sorted(sample - set(kept))
    if missing:
        run.faults.append(f"frames {missing} drawn for the check never came")
        run.failed = len(missing)
    return kept


def video(cfg, traffic, seed, seconds, trace, device, out_dir: Path,
          run: Run, mark_setup):
    from threedgrut_torch import api
    from threedgrut_torch.cameras import pose_from_matrix
    from threedgrut_torch.device import tuple_to

    w, h = traffic["width"], traffic["height"]
    cap = traffic["isect_capacity"]
    cam = tuple_to(program_camera(cfg, w, h), device)
    raw = scene.particles(cfg, seed, device)
    params = gaussians(raw)
    del raw
    sample = check_sample(seed, traffic)
    n_path = traffic["max_frames"]
    poses = scene.path_poses(cfg, traffic, n_path)
    mats = torch.tensor(np.stack(poses), device=device)
    overflow = torch.zeros((), dtype=torch.bool, device=device)
    host = frame_buffer(w, h, device)

    def frame(i):
        nonlocal overflow
        T = mats[i % n_path]
        out, ovf = api.render(params, cam, pose_from_matrix(T), (w, h),
                              method="3dgut", isect_capacity=cap,
                              T_to_world=T, device=device)
        overflow = overflow | ovf
        host.copy_(check.to_u8(out.rgb))
        return host

    alive = int(params.alive.sum())
    kept = frames(frame, traffic, seconds, trace, device, out_dir, run,
                  mark_setup, sample, "video",
                  work.step_ops(alive, 0, w * h, False))
    if not trace:
        run.metrics["video_frames_per_s"] = 1.0 / run.metrics.pop("frame_s")
        run.metrics["video_frame_ms_p95"] = float(
            np.percentile(np.asarray(run.step_times) * 1e3, 95))
    if bool(overflow):
        run.faults.append("a frame overflowed its isect_capacity")
    del params
    free_device()
    reference_precision()
    raw = scene.particles(cfg, seed, device)
    a = ref_render.activate(raw)
    pairs = []
    for i in sorted(kept):
        c = scene.camera(cfg, poses[i % n_path], device, w, h)
        want = check.to_u8(ref_render.render("gut", a, c, cfg["sh_degree"]))
        pairs.append((kept[i].to(device), want))
    if pairs:
        run.numbers = check.frame_numbers(pairs)


def hybrid(cfg, traffic, seed, seconds, trace, device, out_dir: Path,
           run: Run, mark_setup):
    from threedgrut_torch.cameras import PinholeCamera
    from threedgrut_torch.playground import materials as mat_mod
    from threedgrut_torch.playground import mesh as mesh_mod
    from threedgrut_torch.playground.engine import Engine, EngineConfig
    from threedgrut_torch.trainer import render_params
    from portbench import pgscene

    w, h, f = traffic["width"], traffic["height"], traffic["focal"]
    raw = scene.particles(cfg, seed, device)
    params = gaussians(raw)
    del raw
    parts = pgscene.meshes(cfg)
    mesh = mesh_mod.merge_meshes([
        mesh_mod.make_mesh(v, fc, mid, uvs=uv, device=device)
        for v, fc, uv, mid in parts])
    specs = pgscene.material_specs(cfg, seed)
    env = pgscene.sky(cfg["envmap"]["height"], cfg["envmap"]["width"])
    with torch.no_grad():
        acts = [x.detach() for x in render_params(params)]
    eng = Engine(*acts, mesh=mesh, materials=mat_mod.make_materials(
        specs, device), envmap=env, config=EngineConfig(**cfg["engine"]),
        device=device)
    del params
    cam = PinholeCamera(*(torch.tensor(x, dtype=torch.float32,
                                       device=device) for x in (
        [f, f], [w / 2.0, h / 2.0], [0.0] * 6, [0.0] * 2, [0.0] * 4)))
    n_path = traffic["max_frames"]
    mats = torch.tensor(np.stack([pgscene.orbit_pose(traffic, k)
                                  for k in range(n_path)]), device=device)
    sample = check_sample(seed, traffic)
    overflow = torch.zeros((), dtype=torch.bool, device=device)
    host = frame_buffer(w, h, device)

    def frame(i):
        nonlocal overflow
        out = eng.render_hybrid(cam, mats[i % n_path], (w, h))
        overflow = overflow | out["overflow"]
        host.copy_(check.to_u8(out["rgb"]))
        return host

    kept = frames(frame, traffic, seconds, trace, device, out_dir, run,
                  mark_setup, sample, "hybrid", 0.0)
    if not trace:
        run.metrics["pg_frame_ms"] = 1e3 * run.metrics.pop("frame_s")
    if bool(overflow):
        run.faults.append("a frame overflowed its candidate capacity")
    del eng, acts
    free_device()
    reference_precision()
    pairs = []
    for i in sorted(kept):
        want = reference_hybrid(cfg, traffic, seed, device, i)
        pairs.append((kept[i].to(device), check.to_u8(want)))
    if pairs:
        run.numbers = check.frame_numbers(pairs)


def reference_hybrid(cfg, traffic, seed, device, i, dtype=torch.float32,
                     turn_deg=0.0):
    """The reference's hybrid frame i of the orbit (`turn_deg` further
    round it: a planted fault)."""
    from portbench import pgscene
    from portbench.reference import playground as ref_pg
    raw = scene.particles(cfg, seed, device)
    a = ref_render.activate({k: v.to(dtype) if v.is_floating_point() else v
                             for k, v in raw.items()})
    del raw
    mesh = ref_pg.build_mesh(pgscene.meshes(cfg), device)
    env = torch.tensor(pgscene.sky(cfg["envmap"]["height"],
                                   cfg["envmap"]["width"]), device=device)
    t = dict(traffic, start_deg=traffic["start_deg"] + turn_deg)
    c2w = torch.tensor(pgscene.orbit_pose(t, i), device=device, dtype=dtype)
    w, h, f = traffic["width"], traffic["height"], traffic["focal"]
    cam = ref_render.Camera(f, f, w / 2.0, h / 2.0, w, h, c2w)
    return ref_pg.hybrid_frame(a, mesh, pgscene.material_specs(cfg, seed),
                               env, cam, cfg["engine"],
                               cfg["engine"]["sh_degree"]).float()


DRIVERS = {"train": train, "video": video, "hybrid": hybrid}
