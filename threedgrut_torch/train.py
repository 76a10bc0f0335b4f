"""Train entry point of the port, the counterpart of the repository's root
train.py:

    python -m threedgrut_torch.train --config-name nerf_synthetic_3dgut \
        path=data/lego out_dir=runs experiment_name=lego [a.b.c=value ...]

A preset (threedgrut_torch.config.PRESETS), dotted overrides and the
special keys path, out_dir, experiment_name and resume. The dataset type
follows the preset's name (nerf, colmap, scannetpp) unless dataset.type= is
given. A new run starts from the dataset's initialization points (COLMAP)
or from 100,000 random particles; `resume=<ckpt.npz>` continues a run from
its checkpoint, with that checkpoint's configuration and this command's
dotted overrides on top. Either way the densification strategy is built
from strategy.method (gs, mcmc, none) before the checkpoint loads, so a
resumed run restores the strategy's state and goes on densifying (the root
train.py resumes without one, ROADMAP C11). Metrics go to
<out_dir>/<experiment_name> (metrics.jsonl, TensorBoard events where
tensorboard imports) beside the checkpoints; at the end the scene is
exported (export_last.ply, .ingp and .usdz, the USDZ normalized by the
training cameras' poses where the dataset has them) and the test split is
rendered and scored (test_renders/). With --with-gui the live viewer
(threedgrut_torch/gui.py) serves frames of the training scene on
--gui-port while the run trains.

Runs on the card (`--device cuda`, the default; an error without one) or,
with `--device cpu`, on the CPU through the kernels' plain versions.

With `--multichip D,T,M` it trains on a (data, tile, model) mesh of D x T x
M processes (threedgrut_torch.parallel: a step takes D views; only the
3DGUT rasterizer trains there). Under a launcher that sets RANK and
WORLD_SIZE (torchrun) each process joins the group; otherwise the entry
builds the kernels once and starts the D x T x M local ranks itself and
waits for them (a mesh of one runs in this process). Rank r takes
cuda:(r % card count).
`--dist-backend` is nccl (the default: one rank per card) or gloo (several
ranks may share a card, or the CPU). Rank 0 writes the metrics,
checkpoints, export and test renders.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Tuple

SPECIAL_KEYS = ("path", "out_dir", "experiment_name", "resume")
DIST_BACKENDS = ("nccl", "gloo")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m threedgrut_torch.train",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-name", default="nerf_synthetic_3dgut",
                    help="preset name (threedgrut_torch.config.PRESETS)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--with-gui", action="store_true",
                    help="serve the live training viewer "
                         "(threedgrut_torch.gui.TrainingGUI) while training")
    ap.add_argument("--gui-port", type=int, default=8080,
                    help="the live viewer's port")
    ap.add_argument("--multichip", metavar="D,T,M", default=None,
                    help="train on a (data, tile, model) mesh of D x T x M "
                         "processes; a step takes D views")
    ap.add_argument("--dist-backend", default="nccl", choices=DIST_BACKENDS,
                    help="the mesh's torch.distributed backend: nccl (one "
                         "rank per card) or gloo")
    ap.add_argument("overrides", nargs="*",
                    help="dotted config overrides key=value; special keys: "
                         + ", ".join(SPECIAL_KEYS))
    args = ap.parse_args(argv)
    args.mesh_shape = None
    if args.multichip:
        try:
            shape = tuple(int(x) for x in args.multichip.split(","))
        except ValueError:
            shape = ()
        if len(shape) != 3 or min(shape) < 1:
            ap.error(f"--multichip expects D,T,M (three positive integers), "
                     f"got {args.multichip!r}")
        args.mesh_shape = shape
    return ap, args


def dataset_kwargs(ds_cfg) -> dict:
    """datasets.make's keywords from a DatasetConfig (as the root train.py
    passes them: bg_color and test_split_interval are not)."""
    if ds_cfg.type == "synthetic":
        r = ds_cfg.synthetic_resolution
        return dict(num_views=ds_cfg.synthetic_views, resolution=(r, r),
                    num_gt_gaussians=ds_cfg.synthetic_gt,
                    multi_sensor=ds_cfg.synthetic_multi_sensor)
    return dict(downsample_factor=ds_cfg.downsample_factor,
                shutter_type=ds_cfg.shutter_type)


def make_strategy(cfg, capacity: int, device):
    """The densification strategy of cfg.strategy.method (None for
    "none")."""
    method = cfg.strategy.method
    if method == "gs":
        from threedgrut_torch.strategy.gs import GSStrategy
        return GSStrategy(cfg.strategy, capacity, device)
    if method == "mcmc":
        from threedgrut_torch.strategy.mcmc import MCMCStrategy
        return MCMCStrategy(cfg.strategy, cfg.optimizer, capacity, device)
    if method == "none":
        return None
    raise ValueError(f"unknown strategy.method {method!r}")


def make_config(ap, args):
    """The run's Config and its dotted overrides, from the command line."""
    from threedgrut_torch import config as config_mod

    special, dotted = {}, []
    for ov in args.overrides:
        key, _, value = ov.partition("=")
        if key in SPECIAL_KEYS:
            special[key] = value
        else:
            dotted.append(ov)
    cfg = config_mod.make(args.config_name, dotted)
    cfg.dataset.path = special.get("path", cfg.dataset.path)
    cfg.out_dir = special.get("out_dir", cfg.out_dir)
    cfg.experiment_name = special.get("experiment_name", cfg.experiment_name)
    cfg.resume = special.get("resume", cfg.resume)
    if not any(ov.startswith("dataset.type=") for ov in dotted):
        for kind in ("nerf", "scannetpp", "colmap"):
            if kind in args.config_name:
                cfg.dataset.type = kind
                break
    if not cfg.dataset.path and cfg.dataset.type != "synthetic":
        ap.error("dataset path required: path=/path/to/scene "
                 "(dataset.type=synthetic needs none)")
    return cfg, dotted


def _entry_rank(rank: int, argv) -> Optional[dict]:
    """A rank spawned by run(): the same command line, as under a
    launcher."""
    return run(argv)[1]


def run(argv=None) -> Tuple[object, Optional[dict]]:
    """Train (and evaluate) as the command line says. Returns the trainer
    and the final test summary (None without a test split). With
    --multichip and no launcher, this process starts the ranks and returns
    (None, rank 0's summary)."""
    import torch

    from threedgrut_torch.device import resolve

    argv = sys.argv[1:] if argv is None else list(argv)
    ap, args = parse_args(argv)
    cfg, dotted = make_config(ap, args)
    if args.mesh_shape is None:
        return _train(args, cfg, dotted, resolve(args.device))

    import torch.distributed as dist

    from threedgrut_torch.parallel import dp, multihost
    shape = args.mesh_shape
    dp.check_supported(cfg, shape)
    world = shape[0] * shape[1] * shape[2]
    dev = resolve(args.device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # Under a launcher (or spawned below): join.
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"--multichip {args.multichip} needs {world} "
                             f"processes; WORLD_SIZE is "
                             f"{os.environ['WORLD_SIZE']}")
        rank = int(os.environ["RANK"])
        dev = multihost.rank_device(
            dev, int(os.environ.get("LOCAL_RANK", rank)))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        multihost.initialize(backend=args.dist_backend)
        return _train(args, cfg, dotted, dev, shape)
    if (args.dist_backend == "nccl" and dev.type == "cuda"
            and world > torch.cuda.device_count()):
        raise ValueError(
            f"--multichip {args.multichip} puts {world} ranks on "
            f"{torch.cuda.device_count()} card(s): NCCL takes one rank per "
            f"card; pass --dist-backend gloo to share cards")
    if args.dist_backend == "nccl" and dev.type != "cuda":
        raise ValueError("--dist-backend nccl needs --device cuda; pass "
                         "--dist-backend gloo on the CPU")
    if dev.type == "cuda":
        from threedgrut_torch.ops import cuda_build
        cuda_build.build()      # once, before the ranks start
    if world == 1:
        multihost.init_process_group(
            args.dist_backend, f"127.0.0.1:{multihost.free_port()}", 1, 0)
        try:
            return _train(args, cfg, dotted, dev, shape)
        finally:
            dist.destroy_process_group()
    summaries = multihost.spawn(
        _entry_rank, world, args=(argv,), backend=args.dist_backend,
        threads=max(1, (os.cpu_count() or 1) // world))
    return None, summaries[0]


def _train(args, cfg, dotted, dev, mesh_shape=None):
    import numpy as np

    from threedgrut_torch import config as config_mod
    from threedgrut_torch import datasets
    from threedgrut_torch.export.ingp import export_ingp
    from threedgrut_torch.export.ply import export_ply
    from threedgrut_torch.export.usdz import export_usdz
    from threedgrut_torch.model import gaussians
    from threedgrut_torch.render_eval import Renderer
    from threedgrut_torch.trainer import Trainer
    from threedgrut_torch.utils.writer import MetricsWriter

    trainer_cls, mesh_kw, main = Trainer, {}, True
    if mesh_shape is not None:
        from threedgrut_torch.parallel.trainer import DPTrainer
        trainer_cls, mesh_kw = DPTrainer, dict(mesh_shape=mesh_shape)
        main = int(os.environ.get("RANK", 0)) == 0

    val_split = ("val" if cfg.dataset.type in ("colmap", "scannetpp")
                 else "test")
    ds_kw = dataset_kwargs(cfg.dataset)
    dataset = datasets.make(cfg.dataset.type, cfg.dataset.path,
                            split="train", device=dev, **ds_kw)
    try:
        val_dataset = datasets.make(cfg.dataset.type, cfg.dataset.path,
                                    split=val_split, device=dev, **ds_kw)
        if len(val_dataset) == 0:
            val_dataset = None
    except FileNotFoundError:
        val_dataset = None

    out_dir = os.path.join(cfg.out_dir, cfg.experiment_name)
    writer = MetricsWriter(cfg.out_dir, cfg.experiment_name) if main else None
    if cfg.resume:
        with open(cfg.resume.replace(".npz", ".json")) as fh:
            run_cfg = config_mod.from_dict(json.load(fh))
        for ov in dotted:
            config_mod.apply_override(run_cfg, ov)
        with np.load(cfg.resume) as data:
            capacity = int(data["params/alive"].shape[0])
            saved = sorted(k for k in data.files
                           if k.startswith("strategy/"))
        strategy = make_strategy(run_cfg, capacity, dev)
        trainer = trainer_cls.load_checkpoint(
            cfg.resume, dataset=dataset, val_dataset=val_dataset,
            device=dev, strategy=strategy, **mesh_kw)
        trainer.cfg = run_cfg
        trainer.writer = writer
        print(f"resumed {cfg.resume} at step {trainer.global_step}: "
              f"strategy {run_cfg.strategy.method}, state restored from "
              f"{saved or 'no strategy/ keys'}", flush=True)
    else:
        run_cfg = cfg
        if hasattr(dataset, "initialization_points"):
            xyz, rgb = dataset.initialization_points()
            params = gaussians.init_from_points(
                xyz, colors=rgb, observer_points=dataset.observer_points,
                capacity=cfg.model.capacity, device=dev)
        else:
            n_init = (100_000 if cfg.model.capacity is None
                      else min(100_000, cfg.model.capacity))
            params = gaussians.init_random(
                n_init, max_sh_degree=cfg.model.max_sh_degree,
                capacity=cfg.model.capacity, device=dev)
        trainer = trainer_cls(cfg, dataset, val_dataset=val_dataset,
                              params=params,
                              strategy=make_strategy(cfg, params.capacity,
                                                     dev),
                              device=dev, writer=writer, **mesh_kw)

    mesh = (f", mesh {mesh_shape} over {args.dist_backend}"
            if mesh_shape is not None else "")
    print(f"training {cfg.experiment_name}: {len(dataset)} views, "
          f"{int(trainer.params.num_active())} particles in "
          f"{trainer.params.capacity} slots, "
          f"method={run_cfg.render.method}, "
          f"strategy={run_cfg.strategy.method}, device={dev}{mesh}",
          flush=True)
    gui = None
    if args.with_gui and main:
        from threedgrut_torch.gui import TrainingGUI
        gui = TrainingGUI(trainer, port=args.gui_port)
    try:
        trainer.run(out_dir=out_dir, log_every=100 if main else 0)
    finally:
        if gui is not None:
            gui.close()
    if mesh_shape is not None:
        # Each rank's launches and host step time, for a log that shows the
        # ranks ran the kernels.
        from threedgrut_torch.ops import cuda_build
        rank, world = trainer.mesh.rank, trainer.mesh.size
        step_ms = sorted(e["step_ms"] for e in trainer.step_times)
        lines = [f"mesh rank {rank} of {world}: launches "
                 f"{json.dumps(dict(cuda_build.launches))}\n"]
        if step_ms:
            lines.append(f"mesh rank {rank} of {world}: host step ms median "
                         f"{step_ms[len(step_ms) // 2]:.3f}\n")
        sys.stdout.write("".join(lines))    # one write: ranks share stdout
        sys.stdout.flush()
    if not main:
        return trainer, None
    # The final export (reference trainer.on_training_end): a failed export
    # fails the run.
    export_ply(trainer.params, os.path.join(out_dir, "export_last.ply"))
    export_ingp(trainer.params, os.path.join(out_dir, "export_last.ingp"))
    export_usdz(trainer.params, os.path.join(out_dir, "export_last.usdz"),
                dataset_poses=getattr(dataset, "_poses", None))
    print(f"exported export_last.ply, .ingp and .usdz to {out_dir}",
          flush=True)
    summary = None
    if val_dataset is not None:
        summary = Renderer(trainer, val_dataset).render_all(
            out_dir=os.path.join(out_dir, "test_renders"),
            compute_lpips=False)
        print("final test:", json.dumps(summary), flush=True)
        writer.scalars(summary, trainer.global_step, prefix="test/")
    writer.close()
    print(f"done; artifacts in {out_dir}", flush=True)
    return trainer, summary


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
