"""The readings that the limits of portbench/limits/<workload>.json are set
from, at the cell's own size, for several seeds in one process:

  program  the run's own comparison (its driver with a short window);
  control  the reference computed in bfloat16, the precision below the
           float32 the configuration states, judged as the program is;
  half     (training) the reference with half of the image left out of
           the loss, the mean taken over the rest;
  shifted  (frames) each drawn frame rendered at the next frame's pose.
           (hybrid frames: the same, one orbit step further round)

A state left unchanged reads 1 on change_gap by its definition and is not
run. The benchmark's own runs never run this.

    python3 portbench/control.py --workload <name> --seeds 1,2,3
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def train_readings(cells, check, cfg, traffic, seed, device):
    from portbench import scene
    poses = scene.ring_poses(cfg)
    n = traffic["compare_steps"]
    gts = scene.ground_truth(cfg, seed, n, device)
    extent = scene.scene_extent(poses)
    ref = cells.reference_train(cfg, traffic, seed, device, gts, poses,
                                extent)
    out = {}

    def as_program(r):
        return dict(
            losses=r["losses"],
            grad_norms={f: float(torch.linalg.norm(g.double()))
                        for f, g in r["first_grad"].items()},
            change_norms={f: float(torch.linalg.norm(
                r["fields"][f].double() - r["start"][f].double()))
                for f in r["first_grad"]})

    low = cells.reference_train(cfg, traffic, seed, device, gts, poses,
                                extent, dtype=torch.bfloat16)
    out["control"] = check.train_numbers(as_program(low), ref)
    del low
    s = cfg["scene"]
    keep = torch.zeros((s["height"], s["width"]), dtype=torch.bool,
                       device=device)
    keep[: s["height"] // 2] = True
    half = cells.reference_train(cfg, traffic, seed, device, gts, poses,
                                 extent, keep=keep)
    out["half"] = check.train_numbers(as_program(half), ref)
    return out


def frame_readings(cells, check, cfg, traffic, seed, device):
    from portbench import scene
    from portbench.reference import render as R
    w, h = traffic["width"], traffic["height"]
    sample = sorted(cells.check_sample(seed, traffic))
    poses = scene.path_poses(cfg, traffic, traffic["max_frames"])
    raw = scene.particles(cfg, seed, device)
    a = R.activate(raw)
    low = R.activate({k: v.to(torch.bfloat16) if v.is_floating_point()
                      else v for k, v in raw.items()})
    ctl, shifted = [], []
    for i in sample:
        c = scene.camera(cfg, poses[i], device, w, h)
        want = check.to_u8(R.render("gut", a, c, cfg["sh_degree"]))
        cb = c._replace(c2w=c.c2w.to(torch.bfloat16))
        ctl.append((check.to_u8(R.render("gut", low, cb,
                                         cfg["sh_degree"]).float()), want))
        c2 = scene.camera(cfg, poses[i + 1], device, w, h)
        shifted.append((check.to_u8(R.render("gut", a, c2,
                                             cfg["sh_degree"])), want))
    return dict(control=check.frame_numbers(ctl),
                shifted=check.frame_numbers(shifted))


def hybrid_readings(cells, check, cfg, traffic, seed, device):
    ctl, shifted = [], []
    for i in sorted(cells.check_sample(seed, traffic)):
        want = check.to_u8(cells.reference_hybrid(cfg, traffic, seed, device,
                                                  i))
        ctl.append((check.to_u8(cells.reference_hybrid(
            cfg, traffic, seed, device, i, dtype=torch.bfloat16)), want))
        shifted.append((check.to_u8(cells.reference_hybrid(
            cfg, traffic, seed, device, i,
            turn_deg=traffic["deg_per_frame"])), want))
    return dict(control=check.frame_numbers(ctl),
                shifted=check.frame_numbers(shifted))


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from portbench import cells, check, run
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0,
                    help="the program's window in each seed's run")
    args = ap.parse_args(argv)
    manifest, w, cfg, traffic, limits = run.cell(args.workload)
    device = torch.device("cuda", 0)
    cells.reference_precision()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        rec = dict(workload=args.workload, seed=seed)
        r = cells.Run()
        cells.DRIVERS[traffic["kind"]](
            cfg, traffic, seed, args.seconds, False, device,
            ROOT / "build" / "portbench", r, lambda: None)
        rec["program"] = r.numbers
        rec["faults"] = r.faults
        cells.free_device()
        if traffic["kind"] == "train":
            rec.update(train_readings(cells, check, cfg, traffic, seed,
                                      device))
        elif traffic["kind"] == "video":
            rec.update(frame_readings(cells, check, cfg, traffic, seed,
                                      device))
        else:
            rec.update(hybrid_readings(cells, check, cfg, traffic, seed,
                                       device))
        cells.free_device()
        rec["seconds"] = time.time() - t0
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
