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
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Tuple

SPECIAL_KEYS = ("path", "out_dir", "experiment_name", "resume")


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
                    help="not ported: multi-device training is ROADMAP "
                         "queue A item 8")
    ap.add_argument("overrides", nargs="*",
                    help="dotted config overrides key=value; special keys: "
                         + ", ".join(SPECIAL_KEYS))
    args = ap.parse_args(argv)
    if args.multichip:
        ap.error("--multichip is not ported yet (ROADMAP queue A item 8, "
                 "multi-device)")
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


def run(argv=None) -> Tuple[object, Optional[dict]]:
    """Train (and evaluate) as the command line says. Returns the trainer
    and the final test summary (None without a test split)."""
    import numpy as np

    from threedgrut_torch import config as config_mod
    from threedgrut_torch import datasets
    from threedgrut_torch.device import resolve
    from threedgrut_torch.export.ingp import export_ingp
    from threedgrut_torch.export.ply import export_ply
    from threedgrut_torch.export.usdz import export_usdz
    from threedgrut_torch.model import gaussians
    from threedgrut_torch.render_eval import Renderer
    from threedgrut_torch.trainer import Trainer
    from threedgrut_torch.utils.writer import MetricsWriter

    ap, args = parse_args(argv)
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
    dev = resolve(args.device)

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
    writer = MetricsWriter(cfg.out_dir, cfg.experiment_name)
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
        trainer = Trainer.load_checkpoint(
            cfg.resume, dataset=dataset, val_dataset=val_dataset,
            device=dev, strategy=strategy)
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
        trainer = Trainer(cfg, dataset, val_dataset=val_dataset,
                          params=params,
                          strategy=make_strategy(cfg, params.capacity, dev),
                          device=dev, writer=writer)

    print(f"training {cfg.experiment_name}: {len(dataset)} views, "
          f"{int(trainer.params.num_active())} particles in "
          f"{trainer.params.capacity} slots, "
          f"method={run_cfg.render.method}, "
          f"strategy={run_cfg.strategy.method}, device={dev}", flush=True)
    gui = None
    if args.with_gui:
        from threedgrut_torch.gui import TrainingGUI
        gui = TrainingGUI(trainer, port=args.gui_port)
    try:
        trainer.run(out_dir=out_dir)
    finally:
        if gui is not None:
            gui.close()
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
