"""Digests of the compositors' outputs on the card, to hold two versions
of the kernels bit for bit against each other:

    python threedgrut_torch/golden/digest.py [--root CHECKOUT] [--time]
                                             [--step] [--only gut|grt|b6b9]

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
    every other one ("edge");
  * B6's per-particle sums ([n, F]) of the rows the train paths give it:
    at 16 channels the 3DGUT compact branch's (bench.py's 1M scene above:
    B2's gradients for a seeded cotangent on the windows B1 walked, sorted
    by particle and rounded to bf16, walk capacity Config()'s 0.625 of the
    capacity), at 64 the 3DGRT compact branch's (bench_grt's 100k dense
    inputs at 16 passes, B8's gradients, walk capacity 0.625 of the flat
    capacity);
  * B9's output (gid, depth) at the 1M flat cull's inputs (bench_grt's 1M
    scene through bundle_candidates_twolevel_flat's compact_kernel leg,
    captured at the call) and on a small seeded case with windows in no
    segment, limits that end inside a window and a flat capacity below
    the last streams' limits.

With `--time` it also prints CUDA-event times (mean of 10 launches after
one) of B1 and B2 on the 1M scene at the TIMED legs (B1 without a record,
as a frame runs it, and writing it where the version has one; B2 on it, as
a train step runs it), where the version launches its tiles heaviest first
also in launch order (tile t in block t), and that order's own cost
(heaviest_first: device ms, host us per call); and of B7 and of B8 on the
100k dense inputs at 0, 1 and 16 passes, B8 on the compositing orders its
B7 wrote where the version has them; and of B6 at both widths (also
on its rows with every segment cut to its first TAIL_CAP rows, the rest
relabelled n, to show what the long segments cost) and B9 at 1M, and the
flat cull's compact_kernel leg at 1M (host clock to a synchronize, median
of 3 after a warm run).

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
TAIL_CAP = 32           # rows per segment in B6's capped timing


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


def gut_prepared(dev, n, res, cap, raise_scale):
    """(params, camera, pose, gut.prepare's (projection, binning, slot
    data, grid)) of a SCENES entry: the seeded scene seen from
    (0.3, -4, 1)."""
    import torch
    from threedgrut_torch.cameras import (example_camera, look_at,
                                          pose_from_matrix)
    from threedgrut_torch.model.gaussians import bench_scene, from_numpy
    from threedgrut_torch.render import gut
    fields = bench_scene(n, seed=2, specular_std=0.1)
    if raise_scale:
        fields["scale"] = fields["scale"] + np.float32(np.log(4.0))
    p = from_numpy(fields, device=dev)
    T = look_at(np.array([0.3, -4.0, 1.0], np.float32),
                np.zeros(3, np.float32), np.array([0, 0, 1.0], np.float32))
    cam = example_camera(res, dev)
    pose = pose_from_matrix(torch.tensor(T, device=dev))
    with torch.no_grad():
        prep = gut.prepare(p.get_positions(), p.get_rotation(),
                           p.get_scale(), p.get_density(), p.get_features(),
                           cam, pose, res, cap)
    return p, cam, pose, prep


def gut_inputs(dev, n, res, cap, raise_scale):
    """(params, binning, slot data, grid, rays) of a SCENES entry, prepared
    for B1."""
    import torch
    from threedgrut_torch.render import gut
    p, cam, pose, (_, binning, data, grid) = gut_prepared(dev, n, res, cap,
                                                          raise_scale)
    with torch.no_grad():
        rays = gut.packed_world_rays(cam, pose, grid)
    return p, binning, data, grid, rays


def gut_digests(dev, timed):
    import torch
    from threedgrut_torch.ops import tile_raster
    for sname, n, res, cap, raise_scale in SCENES:
        p, binning, data, grid, rays = gut_inputs(dev, n, res, cap,
                                                  raise_scale)
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


def capped_segments(ids, n, cap):
    """Sorted ids with each particle's rows past its first `cap` relabelled
    n (dropped), and the permutation that sorts the result."""
    import torch
    first = torch.searchsorted(ids, ids, right=False)
    rank = torch.arange(ids.shape[0], device=ids.device) - first
    capped = torch.where(rank < cap, ids, torch.full_like(ids, n))
    return torch.sort(capped, stable=True)


def kernel_breakdown(fn, calls=5):
    """{kernel name: device ms per call of fn} from torch.profiler over
    `calls` calls after a warm one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0 and ev.device_type.name == "CUDA":
            out[ev.key[:60]] = round(us / 1e3 / calls, 4)
    return out


def b6_line(name, rows, ids, n, timed):
    """B6's digest on (rows, ids), with the work it does; with `timed`
    also its time, its kernels' device times, and its time on the rows
    with capped segments."""
    import torch
    from threedgrut_torch.ops import segment_sum
    out = segment_sum.segment_sum_rows_by_ids(rows, ids, n)
    lengths = torch.bincount(ids.long(), minlength=n + 1)[:n]
    torch.cuda.synchronize()
    print(f"digest b6-{rows.shape[1]} {name}: B6 {digest(out)} (rows "
          f"{rows.shape[0]}, kept {int((ids < n).sum())}, particles with "
          f"rows {int((lengths > 0).sum())}, longest segment "
          f"{int(lengths.max())}, nonzero rows "
          f"{int((out != 0).any(1).sum())})", flush=True)
    if timed:
        fn = lambda: segment_sum.segment_sum_rows_by_ids(rows, ids, n)
        ms = cuda_ms(fn, 20)
        cids, order = capped_segments(ids, n, TAIL_CAP)
        crows = rows[order]
        capped = cuda_ms(lambda: segment_sum.segment_sum_rows_by_ids(
            crows, cids, n), 20)
        print(f"time b6-{rows.shape[1]} {name}: B6 {ms:.4f} ms, segments "
              f"cut to {TAIL_CAP} rows {capped:.4f} ms (kept "
              f"{int((cids < n).sum())}); device ms by kernel "
              f"{json.dumps(kernel_breakdown(fn))}", flush=True)


def b9_small_case(dev, seed=11):
    """A seeded B9 case: 30 segments of 0-6 windows with a window in no
    segment after every fifth, bases from each stream's CHUNK-padded
    count, every other stream's limit one window short and a flat capacity
    three windows below the total."""
    import torch
    rng = np.random.default_rng(seed)
    wins = rng.integers(0, 7, 30)
    gaps = (np.arange(30) % 5 == 4).astype(np.int64)
    ws = np.cumsum(np.r_[0, (wins + gaps)[:-1]]).astype(np.int32)
    we = (ws + wins).astype(np.int32)
    nws = int(we[-1]) + 2
    bits = np.zeros(nws * 128, np.int64)
    dens = rng.choice([0.9, 0.4, 0.03], nws).repeat(128)
    for st in range(16):
        bits |= (rng.random(nws * 128) < dens).astype(np.int64) << st
    counts = np.array([[((bits[a * 128:b * 128] >> st) & 1).sum()
                        for st in range(16)] for a, b in zip(ws, we)])
    pad_w = -(-counts.reshape(-1) // 128)
    base = (np.cumsum(pad_w) - pad_w).astype(np.int32)
    lim = base + pad_w
    lim[::2] = base[::2] + np.maximum(pad_w[::2] - 1, 0)
    t = lambda x: torch.tensor(x, device=dev)
    return (t(rng.integers(0, 1 << 24, nws * 128).astype(np.int32)),
            t(bits.astype(np.int32)),
            t(rng.uniform(1, 9, (nws, 16, 128)).astype(np.float32)), t(ws),
            t(we), t(base), t(lim.astype(np.int32)),
            (int(pad_w.sum()) - 3) * 128)


def b9_line(name, args, timed):
    """B9's digest on `args`, with its hits and the 32-byte sectors of the
    depth input that hold one; with `timed` also its time and its kernels'
    device times."""
    import torch
    from threedgrut_torch.ops import stream_compact
    gid, dep = stream_compact.compact_streams(*args)
    bits, depth = args[1], args[2]
    nws = depth.shape[0]
    streams = torch.arange(16, device=bits.device)
    hit = ((bits.view(nws, 1, 128) >> streams[None, :, None]) & 1).bool()
    torch.cuda.synchronize()
    print(f"digest b9 {name}: B9 {digest(gid, dep)} (segments "
          f"{args[3].shape[0]}, windows {nws}, written "
          f"{int((dep < stream_compact.FILL_DEPTH).sum())} of "
          f"{dep.shape[0]}; hits {int(hit.sum())} in "
          f"{int(hit.view(nws, 16, 16, 8).any(-1).sum())} depth sectors)",
          flush=True)
    if timed:
        fn = lambda: stream_compact.compact_streams(*args)
        ms = cuda_ms(fn)
        print(f"time b9 {name}: B9 {ms:.4f} ms; device ms by kernel "
              f"{json.dumps(kernel_breakdown(fn))}", flush=True)


def b6_b9_inputs(dev):
    """B6's and B9's inputs (module docstring): {name: ("b6", (rows, ids,
    n)) or ("b9", compact_streams' arguments)}, and a function running the
    1M flat cull's compact_kernel leg."""
    import torch
    from threedgrut_torch.config import Config
    from threedgrut_torch.ops import (bundle_trace, fused_raster,
                                      sorted_gather, stream_compact,
                                      tile_raster)
    from threedgrut_torch.render import grt
    from threedgrut_torch.trainer import walk_capacity_for
    # B6 at 16 channels: the 3DGUT compact branch at bench.py's 1M scene.
    sname, n, res, cap, raise_scale = SCENES[1]
    p, binning, data, grid, rays = gut_inputs(dev, n, res, cap, raise_scale)
    s, e = binning.tile_starts, binning.tile_ends
    fwd = (data, s, e, rays, 2, 1e-4, 0.0113, 1.0 / 255.0, 0.99, False)
    out, _ = tile_raster._launch(*fwd, True, False, 0, False)
    g_out = torch.randn(out.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    grad = tile_raster._launch_backward(
        *(fwd[:4] + (out, g_out) + fwd[4:] + (True, 0, False)))
    n_p = p.get_positions().shape[0]
    walked = fused_raster.compact_walked(out, s, binning.sorted_particle_idx,
                                         grad, walk_capacity_for(Config(),
                                                                 cap), n_p)
    assert walked is not None
    with torch.no_grad():
        ids, rows = sorted_gather.sort_rows(*walked, "bf16")
    cases = {f"3dgut-{sname} compact": ("b6", (rows, ids, n_p))}
    del p, binning, data, grid, rays, out, g_out, grad, walked

    # B6 at 64 channels: the 3DGRT compact branch at bench_grt's 100k.
    name, n, scales, cand, sup, flat_cap, sflat = GRT_SCENES[0]
    acts, o, d = grt_scene(n, scales, dev)
    with torch.no_grad():
        inp = grt.prepare(*acts, o, d, kernel_degree=4,
                          candidate_capacity=cand, super_capacity=sup,
                          flat_capacity=flat_cap)
        data = grt.gather_candidates(inp)
    args = (data, inp.rays, inp.win_starts, inp.win_ends, 4, 3, 1e-3,
            0.0113, 1.0 / 255.0, 0.99, 16)
    out = bundle_trace._launch(*args)
    g_out = torch.randn(out.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(16))
    g_out[:, 6:] = 0.0
    grad = bundle_trace._launch_backward(*(args[:4] + (out, g_out)
                                           + args[4:]))
    n_p = inp.rows64.shape[0]
    walked = fused_raster.compact_walked_bundles(
        out, inp.win_starts, inp.flat_idx, inp.valid, grad,
        -(-int(flat_cap * 0.625) // 256) * 256, n_p)
    assert walked is not None
    with torch.no_grad():
        ids, rows = sorted_gather.sort_rows(*walked)
    cases[f"grt-{name} compact"] = ("b6", (rows, ids, n_p))
    del acts, o, d, inp, data, out, g_out, grad, walked

    # B9 at the 1M flat cull's inputs, captured at its call.
    name, n, scales, cand, sup, flat_cap, sflat = GRT_SCENES[1]
    acts, o, d = grt_scene(n, scales, dev)
    with torch.no_grad():
        dn, active = grt._rays_unit(d)
        cull_in = grt._cull_inputs(acts[0], acts[2], acts[3], dn, active, 4,
                                   False)
    cargs = (*cull_in[:3], o, cull_in[3], 256, cand)
    kw = dict(super_capacity=sup, super_flat_capacity=sflat,
              flat_capacity=flat_cap, compact_kernel=True)
    captured, real = {}, stream_compact.compact_streams

    def capture(*a):
        captured["args"] = a
        return real(*a)

    stream_compact.compact_streams = capture
    try:
        with torch.no_grad():
            assert not bool(grt.bundle_candidates_twolevel_flat(*cargs,
                                                                **kw)[4])
    finally:
        stream_compact.compact_streams = real
    cases[f"flat-cull-{name}"] = ("b9", captured.pop("args"))
    cases["small"] = ("b9", b9_small_case(dev))

    def cull_leg():
        with torch.no_grad():
            grt.bundle_candidates_twolevel_flat(*cargs, **kw)

    return cases, cull_leg


def b6_b9_digests(dev, timed):
    """B6's and B9's digests (module docstring)."""
    import torch
    cases, cull_leg = b6_b9_inputs(dev)
    for name, (kind, args) in cases.items():
        if kind == "b6":
            b6_line(name, *args, timed)
        else:
            b9_line(name, args, timed)
    if timed:
        runs = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cull_leg()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        print(f"time flat-cull-1M compact_kernel leg: "
              f"{statistics.median(runs[1:]):.3f} ms (median of "
              f"{[round(r, 3) for r in runs[1:]]})", flush=True)


def binning_calls(proj, grid, tile_culling):
    """This version's B3 and B4 on a projection, as its bin_particles runs
    them: (B3's [4, N] output (counts, m0, m1, m2), a function running
    B3 (None where the version runs none: the parent without tile
    culling), a function of the capacity running B4, the depth ranks'
    particle ids and ends). Versions since B3 writes a record (expand.
    unpack_record) return its counts and mask words as the [4, N]."""
    import torch
    from threedgrut_torch.ops import expand, tiles
    b3_in = (proj.tile_min.int().contiguous(),
             proj.tile_max.int().contiguous(), proj.n_tiles.int().contiguous(),
             proj.conic.contiguous(), proj.center.contiguous(),
             proj.max_power.contiguous())
    if hasattr(expand, "unpack_record"):
        b3 = lambda: expand.cull_masks(*b3_in, tile_culling=tile_culling)
        counts, record = b3()
        masks = torch.cat([counts[None],
                           expand.unpack_record(record).masks.T])
        b4_in = (record,)
    else:
        b3 = (lambda: expand.cull_masks(*b3_in)) if tile_culling else None
        if b3 is not None:
            masks = b3()
        else:
            masks = torch.zeros((4, b3_in[2].shape[0]), dtype=torch.int32,
                                device=proj.depth.device)
            masks[0] = b3_in[2]
        b4_in = (b3_in[0], b3_in[1], masks) + b3_in[3:]
    ids, ends = tiles.depth_rank(masks[0], proj.depth)
    return masks, b3, (lambda cap: expand.expand_keys(
        ends, ids, *b4_in, cap, grid, tile_culling)), ids, ends


def b4_sectors(proj, masks, ids, ends, cap):
    """Ranks owning a slot below `cap` and the 32-byte sectors their
    per-particle reads touch: per rank summed, and distinct, for the
    separate fields (the four [4, N] rows, tile_min, tile_max, conic,
    centre, max_power) and for one 64-byte record."""
    import torch
    c = masks[0][ids.long()]
    live = (c > 0) & (ends - c < cap)
    p = ids[live].long()
    spans = [(4, 4 * r * proj.depth.shape[0]) for r in range(4)] + [
        (8, 0), (8, 0), (12, 0), (8, 0), (4, 0)]
    per_rank, distinct = 0, 0
    for k, (nbytes, base) in enumerate(spans):
        a = base + nbytes * p
        first, last = a // 32, (a + nbytes - 1) // 32
        per_rank += int((last - first + 1).sum())
        secs = torch.cat([first, last]) + (k << 40)
        distinct += int(torch.unique(secs).numel())
    return dict(live_ranks=int(live.sum()), field_sectors=per_rank,
                field_sectors_distinct=distinct,
                record_sectors=2 * int(live.sum()))


def bbox_histogram(proj):
    """Cells B3 tests per live maskable particle (bbox <= 8 x 8 tiles), as
    {cells: particles}, and the same of each warp's (32 consecutive
    particles') largest, which sets the warp's pace."""
    import torch
    bw = (proj.tile_max[:, 0] - proj.tile_min[:, 0]).long()
    bh = (proj.tile_max[:, 1] - proj.tile_min[:, 1]).long()
    cells = torch.where((proj.n_tiles > 0) & (bw <= 8) & (bh <= 8)
                        & (bw > 0) & (bh > 0), bw * bh, 0)
    n = cells.shape[0]
    warp = torch.nn.functional.pad(cells, (0, -n % 32)).view(-1, 32)
    hist = lambda x: {k: v for k, v in enumerate(
        torch.bincount(x, minlength=65).tolist()) if v}
    return dict(cells=hist(cells), warp_max=hist(warp.amax(1)),
                tested=int(cells.sum()),
                warp_slots=32 * int(warp.amax(1).sum()))


def b3b4_digests(dev, timed):
    """B3's and B4's digests (module docstring)."""
    import torch
    from threedgrut_torch.ops import tiles
    for sname, n, res, cap, raise_scale in SCENES:
        _, _, _, (proj, _, _, grid) = gut_prepared(dev, n, res, cap,
                                                   raise_scale)
        for cull in (True, False):
            masks, b3, b4, ids, ends = binning_calls(proj, grid, cull)
            total = int(masks[0].sum())
            over = max(256, total // 2 // 256 * 256)
            torch.cuda.synchronize()
            print(f"digest b3b4 {sname} culling={cull}: B3 {digest(masks)} "
                  f"(particles {masks.shape[1]}, with tiles "
                  f"{int((masks[0] > 0).sum())}, total {total})", flush=True)
            for c in (cap, over):
                out = b4(c)
                torch.cuda.synchronize()
                print(f"digest b3b4 {sname} culling={cull} cap={c}: B4 "
                      f"{digest(*out)} (total {total}, sentinel tiles "
                      f"{int((out[0] == grid[0] * grid[1]).sum())})",
                      flush=True)
            if n > 100_000:
                b = tiles.bin_particles(proj, grid, cap, cull)
                fields = {f: digest(getattr(b, f))
                          for f in tiles.TileBinning._fields}
                torch.cuda.synchronize()
                print(f"digest b3b4 {sname} culling={cull} TileBinning: "
                      f"{json.dumps(fields)}", flush=True)
            if timed and n > 100_000 and cull:
                t3 = cuda_ms(b3, 20)
                t4 = cuda_ms(lambda: b4(cap), 20)
                print(f"time b3b4 {sname}: B3 {t3:.4f} ms, B4 {t4:.4f} ms, "
                      f"sum {t3 + t4:.4f} ms; device ms by kernel "
                      f"{json.dumps(kernel_breakdown(b3))} "
                      f"{json.dumps(kernel_breakdown(lambda: b4(cap)))}; "
                      f"{json.dumps(b4_sectors(proj, masks, ids, ends, cap))}"
                      f"; bbox {json.dumps(bbox_histogram(proj))}",
                      flush=True)
            del masks, b3, b4, ids, ends
        del proj


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
    ap.add_argument("--only", choices=("gut", "grt", "b6b9", "b3b4"),
                    help="digest only B1/B2 (gut), only B7/B8 (grt), only "
                         "B6/B9 (b6b9) or only B3/B4 (b3b4)")
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
               "grt": ["bundle_trace_fwd", "bundle_trace_bwd"],
               "b3b4": ["cull_masks", "expand_keys"]}
    cuda_build.build(None if args.step or args.only == "b6b9"
                     else kernels.get(args.only))
    dev = torch.device("cuda:0")
    if args.only in (None, "gut"):
        gut_digests(dev, args.time)
    if args.only in (None, "grt"):
        grt_digests(dev, args.time)
    if args.only in (None, "b6b9"):
        b6_b9_digests(dev, args.time)
    if args.only in (None, "b3b4"):
        b3b4_digests(dev, args.time)
    if args.step:
        from threedgrut_torch.ops import tile_raster
        step_profile(dev, tile_raster)
    return 0


if __name__ == "__main__":
    sys.exit(main())
