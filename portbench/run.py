"""Run one cell of the benchmark of threedgrut_torch once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is found by name in BENCHMARK.json; its configuration, traffic
mix and limits by theirs: portbench/configs/<config>.json,
portbench/traffic/<traffic>.json, portbench/limits/<workload>.json, and
each per-layer metric's reader portbench/metrics/<metric>.py. The traffic's
"kind" picks the driver (portbench/cells.py). With --trace 0 the last line
of standard output carries the cell's end-to-end metrics, with --trace 1
its per-layer metrics read from a profiled window; both end with the
comparison against the plain reference, which decides `correct`.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "threedgrut_tpu")


def process_start_time() -> float:
    """Wall-clock time at which this process started (Linux)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    hz = os.sysconf("SC_CLK_TCK")
    return time.time() - uptime + start_ticks / hz


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def cell(name: str):
    """(manifest, workload entry, configuration, traffic, limits)."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    wl = {w["name"]: w for w in manifest["workloads"]}
    if name not in wl:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(wl)}")
    w = wl[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    cfg = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{name}.json")
    return manifest, w, cfg, traffic, limits


def metric_names(manifest, workload: str, trace: bool):
    """The cell's metrics: end-to-end ones that name it or name no cells,
    and per-layer ones that name it, or name no cells and move an
    end-to-end metric it reports."""
    e2e = [m["name"] for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    return [m["name"] for m in manifest["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in e2e]


def read_metric(name: str, ctx):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}",
        BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    t_start = process_start_time()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--step-log", default=None,
                    help="also write every step's or frame's host seconds "
                         "to this JSON file")
    args = ap.parse_args(argv)
    manifest, w, cfg, traffic, limits = cell(args.workload)

    import torch
    # One process on the card, with few host threads: the timed paths run
    # no work on the CPU's thread pool.
    torch.set_num_threads(1)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < w["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {w['chips']} CUDA device(s) needed, {have} "
              f"present", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from portbench import cells
    device = torch.device("cuda", 0)
    res = run_cell(cells, w, cfg, traffic, limits, manifest, args, device,
                   t_start)
    return res


def run_cell(cells, w, cfg, traffic, limits, manifest, args, device,
             t_start) -> int:
    import torch
    from portbench import check
    run = cells.Run()

    def mark_setup():
        run.setup_done = time.time()

    cells.DRIVERS[traffic["kind"]](
        cfg, traffic, args.seed, args.seconds, bool(args.trace), device,
        ROOT / "build" / "portbench", run, mark_setup)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    names = metric_names(manifest, w["name"], bool(args.trace))
    units = {m["name"]: m["unit"] for m in
             manifest["end_to_end"] + manifest["per_layer"]}
    metrics = {}
    if args.trace:
        for name in names:
            v = read_metric(name, run.trace_ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
    else:
        run.metrics["setup_s"] = run.setup_done - t_start
        for name in names:
            metrics[name] = {"value": run.metrics[name], "unit": units[name]}
    ok, checks = check.judge(run.numbers, limits)
    if not run.numbers:
        ok = False
    ok &= not run.faults
    if args.step_log:
        with open(args.step_log, "w") as fh:
            json.dump(dict(workload=w["name"], seed=args.seed,
                           seconds=run.step_times), fh)
    cuda = device.type == "cuda"
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=w["chips"], memory_peak_bytes=int(run.memory_peak))
    result = dict(correct=bool(ok), attempted=run.attempted,
                  failed=run.failed, metrics=metrics, device=dev)
    if args.trace:
        tr = run.trace_ctx.trace
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = dict(device_ops=tr.device_ops(),
                                   idle_gaps=tr.idle_gaps())
    for f in run.faults:
        print(f"portbench: {f}", file=sys.stderr)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
