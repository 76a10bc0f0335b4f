"""Digests of the compositors' outputs on the card, to hold two versions
of the kernels bit for bit against each other:

    python threedgrut_torch/golden/digest.py [--root CHECKOUT] [--time]
                                             [--step] [--only gut|grt]

`--root` names the checkout whose `threedgrut_torch` is imported (default:
the one holding this file), so one run can digest another version's
kernels with the same inputs. Each line is the sha256 (first 16 hex
digits) of a kernel's output:

  * B1's default and sorted legs (output [num_tiles, 8, 256] and flags)
    and B2's gradients [cap, 16] for a seeded output cotangent, on 20k
    Gaussians at 256x192 (scales raised 4x) and bench.py's 1M scene at
    800x800 (capacity 2,917,888), both from (0.3, -4, 1), the default leg
    also with every ray's origin nudged on its own (1e-5 x a seeded normal
    draw: no tile's rays share an origin, as under a rolling shutter); B2
    given no walk record (its wrapper runs B1 for one where the version has
    them) and, where the version writes them, on the live-row mask or
    compositing orders B1 wrote ("B2-rec", n/a where it writes none);
  * B7's output [nb, 8, 256] and B8's gradients [capF, 64] for a seeded
    cotangent at 0, 1, 2, 16 and 70 passes, on tools/bench_grt.py's 100k
    and 1M scenes and capacities (512x512 rays from (0, 0, -4)), through
    the dense and the flat cull, and on the 100k dense inputs with a bound
    t_max on every third bundle and an initial transmittance of 0.6 on
    every other one ("edge").

With `--time` it also prints CUDA-event times (mean of 10 launches after
one) of B1 and B2 on the 1M scene at the TIMED legs (B1 without a record,
as a frame runs it, and writing it where the version has one; B2 on it, as
a train step runs it), where the version launches its tiles heaviest first
also in launch order (tile t in block t), and that order's own cost
(heaviest_first: device ms, host us per call); and of B7 and of B8 on the
100k dense inputs at 0, 1 and 16 passes, B8 on the compositing orders its
B7 wrote where the version has them.

With `--step` it runs the default train step at full width (chip_smoke.py's
train_setup: bench.py's 1M scene, camera and Config() defaults at 800x800)
and prints the median wall time of 10 steps per tile order, the orders
interleaved step by step, then two profiled steps per order (chip_smoke.py's
profile_run: wall, device busy and idle share, host and device time per
stage), alternating."""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

# (name, sorted_passes, row termination at each tile's midpoint slot,
# emit_flags, every ray's origin nudged on its own)
LEGS = [("default", 0, False, False, False),
        ("default-flags", 0, False, True, False),
        ("default-per-pixel-origins", 0, False, False, True),
        ("rowterm-mid", 0, True, False, False),
        ("sorted1", 1, False, False, False),
        ("sorted2", 2, False, False, False),
        ("sorted16", 16, False, False, False),
        ("sorted16-flags", 16, False, True, False),
        ("sorted16-rowterm-mid", 16, True, False, False),
        ("sorted70", 70, False, False, False)]
TIMED = ("default", "default-per-pixel-origins", "rowterm-mid", "sorted16")
SCENES = [("20k-256x192", 20_000, (256, 192), 1 << 18, True),
          ("1M-800x800", 1_000_000, (800, 800), 2_917_888, False)]
# tools/bench_grt.py's configurations: (name, Gaussians, scale range,
# candidate, super, flat and super flat capacities).
GRT_SCENES = [("100k", 100_000, (0.01, 0.05), 1792, 24320, 919296, 1004800),
              ("1M", 1_000_000, (0.004, 0.02), 7680, 216832, 3384832,
               4591104)]
GRT_PASSES = (0, 1, 2, 16, 70)


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def grt_scene(n, scales, dev, side=512):
    """tools/bench_grt.py's seeded scene (positions, quaternions, scales,
    albedo, ray jitter, in its draw order; opacity 0.5) as the five
    post-activation tensors, and its side x side rays from (0, 0, -4) in
    16x16-tile order."""
    import torch
    rng = np.random.default_rng(0)
    pos = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    s = np.exp(rng.uniform(np.log(scales[0]), np.log(scales[1]),
                           (n, 3))).astype(np.float32)
    albedo = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    px = (np.arange(side) + 0.5) / side * 0.8 - 0.4
    gx, gy = np.meshgrid(px, px, indexing="xy")
    jit = rng.uniform(-0.4 / side, 0.4 / side, (2,) + gx.shape)
    d = np.stack([gx + jit[0], gy + jit[1], np.ones_like(gx)],
                 -1).astype(np.float32)
    t = side // 16
    d = d.reshape(t, 16, t, 16, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 3)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.array([[0.0, 0.0, -4.0]], np.float32), (side * side, 1))
    from threedgrut_torch.model.gaussians import from_arrays
    p = from_arrays(pos, q, np.log(s), np.zeros((n, 1), np.float32), albedo,
                    np.zeros((n, 45), np.float32), device=dev)
    acts = [x.detach() for x in (p.get_positions(), p.get_rotation(),
                                 p.get_scale(), p.get_density(),
                                 p.get_features())]
    return acts, torch.tensor(o, device=dev), torch.tensor(
        d.astype(np.float32), device=dev)


def cuda_ms(fn, iters=10):
    import torch
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def walk_record(tile_raster, fwd, passes, rowterm):
    """The record this version's B1 writes for its B2 (None where it writes
    none for the leg), filled by a B1 launch."""
    if passes == 0 and not hasattr(tile_raster, "walk_words"):
        return None
    words = (tile_raster.walk_words(passes)
             if hasattr(tile_raster, "walk_words") else None)
    args = (fwd[1], fwd[2], fwd[0].shape[0]) + ((words,) if words else ())
    rec = tile_raster.order_buffer(*args)
    tile_raster._launch(*fwd, False, False, passes, rowterm, order=rec)
    return rec


@contextlib.contextmanager
def launch_order(tile_raster):
    """This version's B1 and B2 wrappers launch tile t in block t (instead
    of heaviest first) inside the context, from an order made once."""
    import torch
    idents = {}

    def ident(work, *_):
        n = work.numel()
        if n not in idents:
            idents[n] = torch.arange(n, dtype=torch.int32,
                                     device=work.device)
        return idents[n]

    heaviest = tile_raster.heaviest_first
    tile_raster.heaviest_first = ident
    try:
        yield
    finally:
        tile_raster.heaviest_first = heaviest


def order_cost(tile_raster, work):
    """heaviest_first(work): device ms (CUDA events) and host us per call
    (100 calls queued without a sync)."""
    import torch
    ms = cuda_ms(lambda: tile_raster.heaviest_first(work))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        tile_raster.heaviest_first(work)
    host_us = (time.perf_counter() - t0) * 1e4
    torch.cuda.synchronize()
    return ms, host_us


def time_leg(tile_raster, fwd, b2_in, passes, rowterm):
    """{B1, B1 writing its record, B2 on it: ms} of one leg (module
    docstring), also in launch order where the version orders its tiles
    (the record made in that order)."""
    orders = [""]
    if hasattr(tile_raster, "heaviest_first"):
        orders.append(" in launch order")
    t = {}
    for o in orders:
        with launch_order(tile_raster) if o else contextlib.nullcontext():
            rec = walk_record(tile_raster, fwd, passes, rowterm)
            kw = {} if rec is None else {"order": rec}
            t["B1" + o] = cuda_ms(lambda: tile_raster._launch(
                *fwd, False, False, passes, rowterm))
            t["B1 writing its record" + o] = cuda_ms(
                lambda: tile_raster._launch(*fwd, False, False, passes,
                                            rowterm, **kw))
            t["B2" + o] = cuda_ms(lambda: tile_raster._launch_backward(
                *b2_in, **kw))
            del rec
    t["on B1's record"] = bool(kw)
    return t


def gut_digests(dev, timed):
    import torch
    from threedgrut_torch.cameras import (example_camera, look_at,
                                          pose_from_matrix)
    from threedgrut_torch.model.gaussians import bench_scene, from_numpy
    from threedgrut_torch.ops import tile_raster
    from threedgrut_torch.render import gut
    for sname, n, res, cap, raise_scale in SCENES:
        fields = bench_scene(n, seed=2, specular_std=0.1)
        if raise_scale:
            fields["scale"] = fields["scale"] + np.float32(np.log(4.0))
        p = from_numpy(fields, device=dev)
        T = look_at(np.array([0.3, -4.0, 1.0], np.float32),
                    np.zeros(3, np.float32), np.array([0, 0, 1.0], np.float32))
        cam = example_camera(res, dev)
        pose = pose_from_matrix(torch.tensor(T, device=dev))
        with torch.no_grad():
            _, binning, data, grid = gut.prepare(
                p.get_positions(), p.get_rotation(), p.get_scale(),
                p.get_density(), p.get_features(), cam, pose, res, cap)
            rays = gut.packed_world_rays(cam, pose, grid)
        s, e = binning.tile_starts, binning.tile_ends
        mid = torch.where(e > s, torch.div(s + e, 2, rounding_mode="floor"),
                          -1).to(torch.float32)
        nudge = 1e-5 * torch.randn(rays[:, 0:3].shape, device=dev,
                                   generator=torch.Generator(dev).manual_seed(5))
        for lname, passes, rowterm, flags, per_pixel in LEGS:
            r = rays.clone()
            if rowterm:
                r[:, 7] = mid[:, None]
            if per_pixel:
                r[:, 0:3] += nudge
            fwd = (data, s, e, r, 2, 1e-4, 0.0113, 1.0 / 255.0, 0.99, False)
            out, fl = tile_raster._launch(*fwd, True, flags, passes, rowterm)
            g_out = torch.randn(out.shape, device=dev,
                                generator=torch.Generator(dev).manual_seed(0))
            b2_in = fwd[:4] + (out, g_out) + fwd[4:] + (True, passes, rowterm)
            grad = tile_raster._launch_backward(*b2_in)
            rec = walk_record(tile_raster, fwd, passes, rowterm)
            on_rec = ("n/a" if rec is None else digest(
                tile_raster._launch_backward(*b2_in, order=rec)))
            del rec
            torch.cuda.synchronize()
            print(f"digest {sname} {lname}: B1 {digest(out, fl)} "
                  f"B2 {digest(grad)} B2-rec {on_rec} (walked "
                  f"{int(out[:, 7, 0].sum())}, nonzero rows "
                  f"{int((grad.abs().sum(1) > 0).sum())})", flush=True)
            if timed and n > 100_000 and lname in TIMED:
                t = time_leg(tile_raster, fwd, b2_in, passes, rowterm)
                print(f"time {sname} {lname}: {json.dumps(t)}", flush=True)
        if timed and n > 100_000 and hasattr(tile_raster, "heaviest_first"):
            ms, host_us = order_cost(tile_raster, e - s)
            print(f"time {sname} heaviest_first: device {ms:.4f} ms, host "
                  f"{host_us:.1f} us per call", flush=True)
        del p, binning, data, rays


def grt_digests(dev, timed):
    """B7's and B8's digests on bench_grt's scenes (module docstring)."""
    import torch
    from threedgrut_torch.ops import bundle_trace
    from threedgrut_torch.render import grt
    orders = hasattr(bundle_trace, "order_buffer")
    for name, n, scales, cand, sup, flat_cap, sflat in GRT_SCENES:
        acts, o, d = grt_scene(n, scales, dev)
        for flat in (False, True):
            kw = dict(kernel_degree=4, candidate_capacity=cand,
                      super_capacity=sup, flat_capacity=flat_cap)
            if flat:
                kw.update(flat_cull=True, super_flat_capacity=sflat)
            with torch.no_grad():
                inp = grt.prepare(*acts, o, d, **kw)
                data = grt.gather_candidates(inp)
            assert not bool(inp.overflow)
            cases = [("", inp.rays)]
            if name == "100k" and not flat:
                edge = inp.rays.clone()
                edge[::3, 6] = 4.2
                edge[::2, 7] = 0.6
                cases.append(("-edge", edge))
            for suffix, rays in cases:
                for passes in GRT_PASSES:
                    args = (data, rays, inp.win_starts, inp.win_ends, 4, 3,
                            1e-3, 0.0113, 1.0 / 255.0, 0.99, passes)
                    out = bundle_trace._launch(*args)
                    g_out = torch.randn(
                        out.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(passes))
                    g_out[:, 6:] = 0.0
                    bargs = args[:4] + (out, g_out) + args[4:]
                    grad = bundle_trace._launch_backward(*bargs)
                    torch.cuda.synchronize()
                    cull = "flat" if flat else "dense"
                    print(f"digest grt-{name}-{cull}{suffix} passes{passes}"
                          f": B7 {digest(out)} B8 {digest(grad)} (walked "
                          f"{int(out[:, 7, 0].sum())}, nonzero rows "
                          f"{int((grad != 0).any(1).sum())})", flush=True)
                    if not (timed and suffix == "" and name == "100k"
                            and not flat and passes in (0, 1, 16)):
                        continue
                    order = None
                    if orders and passes:
                        order = bundle_trace.order_buffer(data)
                        bundle_trace._launch(*args, order=order)
                    kw_o = {} if order is None else {"order": order}
                    t7 = cuda_ms(lambda: bundle_trace._launch(*args))
                    t8 = cuda_ms(lambda: bundle_trace._launch_backward(
                        *bargs, **kw_o))
                    print(f"time grt-{name}-{cull} passes{passes}: B7 "
                          f"{t7:.4f} ms, B8 {t8:.4f} ms (on B7's orders: "
                          f"{order is not None})", flush=True)
            del inp, data
        del acts, o, d


def step_profile(dev, tile_raster):
    """--step (module docstring)."""
    import torch
    sys.path.append(str(Path(__file__).resolve().parents[2]))
    import chip_smoke
    from threedgrut_torch.model.gaussians import bench_scene
    res = chip_smoke.MAIN_RES
    gt = np.zeros((res[1], res[0], 3), np.float32)
    tr, view = chip_smoke.train_setup(bench_scene(chip_smoke.MAIN_N, seed=0),
                                      res, chip_smoke.MAIN_CAP, gt, dev)
    orders = ["launch order"]
    if hasattr(tile_raster, "heaviest_first"):
        orders.insert(0, "heaviest first")

    def step(order):
        with (launch_order(tile_raster) if order == "launch order"
              and len(orders) > 1 else contextlib.nullcontext()):
            tr.train_step(view)

    for _ in range(2):
        step(orders[0])
    walls = {o: [] for o in orders}
    for _ in range(10):
        for o in orders:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(o)
            torch.cuda.synchronize()
            walls[o].append((time.perf_counter() - t0) * 1e3)
    for o in orders:
        print(f"step {o}: median wall {statistics.median(walls[o]):.3f} ms "
              f"of {[round(w, 3) for w in walls[o]]}", flush=True)
    for _ in range(2):
        for o in orders:
            prof = chip_smoke.profile_run(lambda: step(o),
                                          ("train.", "3dgut."))
            keep = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                         "device_idle_share",
                                         "stage_host_ms",
                                         "stage_device_span_ms")}
            print(f"step {o} profiled: {json.dumps(keep)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--step", action="store_true",
                    help="profile the default train step per tile order")
    ap.add_argument("--only", choices=("gut", "grt"),
                    help="digest only B1/B2 (gut) or only B7/B8 (grt)")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    from threedgrut_torch.ops import cuda_build
    if not torch.cuda.is_available():
        print("digest: no CUDA device", file=sys.stderr)
        return 2
    import threedgrut_torch
    print(f"digest of {Path(threedgrut_torch.__file__).parent}", flush=True)
    kernels = {"gut": ["tile_raster_fwd", "tile_raster_bwd"],
               "grt": ["bundle_trace_fwd", "bundle_trace_bwd"]}
    cuda_build.build(None if args.step else kernels.get(args.only))
    dev = torch.device("cuda:0")
    if args.only != "grt":
        gut_digests(dev, args.time)
    if args.only != "gut":
        grt_digests(dev, args.time)
    if args.step:
        from threedgrut_torch.ops import tile_raster
        step_profile(dev, tile_raster)
    return 0


if __name__ == "__main__":
    sys.exit(main())
