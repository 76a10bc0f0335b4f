#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`threedgrut_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (the kernels are built from
threedgrut_torch/csrc/ into build/ on first use). Imports nothing of JAX.
Phases, each of which fails the run on a miss:

  1. device: name, count, power limit; TF32 off for matmuls and cuDNN;
  2. build: the nine sources (B3 cull_masks, B4 expand_keys, B1
     tile_raster_fwd, B2 tile_raster_bwd, B5/B6 segment_sum, B7
     bundle_trace_fwd, B8 bundle_trace_bwd, B9 stream_compact, M1
     mesh_intersect) in parallel, with nvcc's register/smem/spill report;
  3. golden: the card's render of the golden scene (also with 16 re-sort
     passes and with row termination) and its 3DGRT trace (on the dense
     and on the flat cull) against the JAX reference's stored outputs
     (threedgrut_torch/golden/);
  4. parity: api.render on the card (kernels) against api.render on the CPU
     (the plain versions) at 100k Gaussians, 400x400, both visibility
     modes; one Trainer.train_step on the card against the same step on
     the CPU from the same parameters (loss, image, gradients, updated
     parameters, moments), on the fused path's compact branch (B6) and
     its dense fallback (B5), and on the two-stage path (B5); the same
     with preset_3dgut_sorted (16 passes; compact and dense branch) and
     with row termination (compact); one sorted Trainer.eval_view (the
     flags leg and hit visibility); then 3DGRT:
     api.trace on tools/bench_grt.py's 100k scene (the central 128x128
     rays of its grid, 64 bundles, the two-level cull), api.render(method=
     "3dgrt") (32 bundles) and one Trainer.eval_view of preset_3dgrt; then
     3DGRT training: bench_grt's fwd+bwd on those 128x128 rays (gradients
     of all five tensors, on the compact and the dense branch, the card
     run twice and bit-identical) and one preset_3dgrt Trainer.train_step;
     then the flat cull against the dense two-level cull on the card at
     bench_grt's 100k scene (per-bundle candidate lists, and api.trace);
  5. forward main path: api.render at full width (1M Gaussians of the
     benchmark scene, SH degree 3, 800x800), 5 orbit frames plus one
     hit-visibility frame, with the launch counts read around it;
  5b. inference and export at full width on phase 5's scene
     (threedgrut_torch/render/infer.py, export/): (a)
     tools/bench_infer_orbit.py's orbit (32 frames at 0.5 degrees, a
     refresh every 8) in exact mode (api.render), compact mode (refresh,
     then render_compact) at census thresholds 0 and 1/255 and frozen mode
     (capture_binning at each refresh, then render_frozen at 16 passes):
     the probe's visible count, n_compact and compact capacity, ms a frame
     per mode, PSNR against the exact frames, every overflow flag, and the
     gate: at each refresh camera the compact frame (threshold 0) within
     golden.compare of the exact one; (b) bench.py's BENCH_INFER=compact
     frame (n_compact 143,360, capacity 585,472, threshold 1/255) with a
     bench.py-shaped JSON line; (c) card vs CPU at phase 4's scene: the
     refresh (id sets up to census flips on 0.1% of the visible count),
     capture_binning exactly, render_compact and render_frozen on a stale
     binning within golden.compare; (d) .ply, .ingp (single, half) and
     .usdz of the 1M scene written and read back (api.load_scene bit-equal,
     its frame bit for bit; fp16 values equal to numpy's rounding), bytes
     and host seconds of each; the phase's peak memory;
  5c. (run after 8b, so that the phases before keep their order) the
     playground at full width on phase 5's scene
     (threedgrut_torch/playground/, gui.py): a mirror floor, a glass
     icosphere (1,280 faces) and a textured, normal-mapped .glb card
     written at the start, an equirect envmap from numpy, the viewer at
     bench.py's camera; (a) WebViewer frames in trace mode (3 bounces,
     spp 1; then spp 4 with depth of field and the a-trous denoiser
     over the centre 200x200), hybrid mode and raster mode along a
     16-frame orbit: per mode the
     first frame's capacity growth (each growth an overflow flag), ms a
     frame, launches a frame (B7 per trace call, M1 per bounce, B3, B4, B1
     per hybrid or raster frame) and the phase's peak memory; (b)
     Engine.render and render_hybrid card vs CPU at phase 4's scene
     through the centre 128x128 of the full-width camera (primary mesh
     faces equal off the edges; frames within golden.compare's value rule
     at TRACE_FLIP_SHARE); (c) M1 against its plain version, bit for
     bit, at (a)'s 640,000 primary rays, the bounce-2 rays of (a)'s last
     trace frame and its last hybrid frame's secondary rays, its cull's
     masks (the diagnostic entry) equal to block_face_masks_plain's, timed
     beside its bound (the cull's operations as it runs them and the live
     rays' surviving pairs) and the brute force's;
     (d) the HTTP surface on a loopback port over the centre 160x160
     (every mode and
     channel, the edits, a 2-keyframe video) and TrainingGUI on a
     full-width trainer taking 3 steps while another thread requests
     frames; (e) `python -m threedgrut_torch.playground --gs_object <the
     1M scene as .ply> --no-serve`; then, outside the phase's wall, (f)
     phase 6's train steps run again right after it and again after
     torch.cuda.empty_cache(), each with the allocator's counters, the
     live threads, the card's SM clock and temperature, and one step
     profiled (device busy time and idle share);
  6. train main path: Trainer.train_step at full width (bench.py's scene,
     camera and Config defaults), 6 steps, the last with
     walk_compact_fraction=0 (the dense branch, B5); losses, step ms,
     rays/s, peak memory, launch counts (B1 and B2 once a step), and a
     bench.py-shaped JSON line; then the same 6 steps with
     preset_3dgut_sorted (B1 and B2's sorted legs) and with
     row_termination=True, each with its own JSON line ("mode");
  6b. densification: (d) every strategy operation (densify, prune,
     relocate, add_gaussians, perturb, reset_density, accumulate) on the
     card against the CPU from the same state and draws at bench_grt's
     100k scene (masks, taken slots, sources and counts exact, floats
     within STRATEGY_RTOL/ATOL); then 6 Trainer.train_step calls with a
     strategy on a compressed schedule (events at steps 2, 4, 6; 5% of
     each scene dead): (a) GSStrategy on the full-width 3DGUT step
     (bench.py's 1M scene in 1,503,232 slots: clones, splits and prunes,
     growth), (b) MCMCStrategy on the same step (950,000 in 1,003,520
     slots: relocations, growth to exactly 1,000,000 at step 4), (c)
     MCMCStrategy with preset_3dgrt on bench_grt's 100k scene (110,592
     slots, filled at step 6); per step alive, the strategy's counts,
     loss, ms, overflow, capacity and launches (B1 and B2, or B7, B8 and
     B6, once a step), each leg's peak memory; (e) each strategy
     operation timed with CUDA events at (a)'s and (b)'s sizes and one
     profiled densified step of each ("strategy.*" spans);
  6c. data, entry points and eval: scenes written at the start into a
     temporary directory (bench.py's 1M scene as the ground truth, the
     port's own renders as frames), then driven through the port's entry
     points (`threedgrut_torch.train`, `threedgrut_torch.render`): (a)
     nerf_synthetic_3dgut on a lego-shaped NeRF scene (24/8 views of
     800x800 RGBA, lego's camera_angle_x, 100,000 random particles, 200
     steps, GS on a compressed schedule), the render entry on its test
     split, and a resume from its step-100 checkpoint that restores the
     strategy and densifies again (C11); (b) colmap_3dgut_mcmc on a Mip-
     NeRF 360-shaped COLMAP scene (one OPENCV camera at 4948x3288, 32
     images in images_4/ at 1237x822, 100,000 points), 100 steps with MCMC
     events, and one of its train steps card vs CPU; (c)
     nerf_synthetic_3dgrt on (a)'s files, 20 steps, and the render entry
     with the 3DGRT eval overrides; (d) the multi-sensor MCMC acceptance
     run (800x800, 12 views, 100 steps), the render entry rebuilding the
     scene from the checkpoint, and a fisheye rolling-shutter train step
     card vs CPU. Per leg: the artifacts, alive particles, step and data
     ms (first epoch and later), decode ms and the decoder, validation and
     test PSNR/SSIM, mean_render_s, peak memory and launches (every kernel
     of the renderer at least once a train step); each train run's final
     export (export_last.ply, .ingp, .usdz), and (a)'s export_last.ply read
     back through api.load_scene and rendered within golden.compare of
     the trainer's frame;
  6d. multi-device training (threedgrut_torch/parallel/) at full width on
     phase 6's scene, camera and configuration: (a) DPTrainer at mesh (1,
     1, 1) under NCCL (a world of one process) against Trainer.train_step
     from the same parameters, 6 steps, loss, image, parameters and
     moments bit-equal after each; (b) worlds of 2 and of 4 processes
     sharing cuda:0 over gloo (NCCL takes one rank per card), at (1, 2, 1)
     and (2, 1, 1) (the second view orbit_T(2)), then (1, 2, 2), 3 steps
     each: rank 0's gradients against the single-process step (the mean of
     the two views' at (2, 1, 1)) within 2e-4 max|g| + 5e-8, every rank's
     parameters and moments bit-equal after each step (a digest), B1 and
     B2 once a step on each rank on a strip of 2,500 / T tiles, step ms
     per rank (ranks time-sharing one card: no scaling figure), and which
     collectives gloo takes for CUDA tensors; (c) `python -m
     threedgrut_torch.train --multichip 1,2,1 --dist-backend gloo` for 20
     steps on 6c(a)'s NeRF scene (run at the end of 6c, on its files):
     exit 0, rank 0's checkpoint, export and test renders, each rank's
     launches (B2 once a step);
  7. 3DGRT main path: api.trace at tools/bench_grt.py's inference
     configuration (100k Gaussians, 512x512 rays, 16 re-sort passes), 6
     traces, then at its 1M capacities, 3 traces; overflow, launch counts,
     the super-list maximum and flat total beside bench_grt's recorded
     counts, ms, rays/s, peak memory, and a bench_grt-shaped JSON line;
     then the same with its BENCH_PACKED=flat mode (the flat cull, its
     super flat capacities; the super flat total checked too, and
     "flat_cull": true in the JSON line); then its BENCH_PACKED=1 (the
     packed cull) and l1 (the packed level-1 sort) modes: card vs CPU at
     the central 128x128 rays (golden.compare at TRACE_FLIP_SHARE), then
     at both configurations each bundle's candidate set equal to the
     exact two-level cull's; the lists' order and the frame against the
     exact cull's measured (quantized depth reorders near ties by design);
     ms a trace beside the exact cull's in the same call, a bench_grt-
     shaped JSON line each;
  8. 3DGRT train main path: bench_grt's fwd+bwd mode (100k, 6 steps; its
     1M capacities, 3 steps; walk_capacity 0.625 of the flat capacity) with
     a bench_grt-shaped JSON line (`grt_trace_rays_per_s_fwd_bwd`), the
     same on the flat cull, then 6 steps of the 100k fwd+bwd with
     BENCH_PACKED=1 (B7, B8, B6 once a step; its frame within
     golden.compare of the packed forward trace), measured against the
     exact cull's fwd+bwd from the same parameters (the frame, the share
     of particles whose gradient differs by more than f32 reordering, and
     the largest difference); then 6
     preset_3dgrt Trainer.train_step calls on bench_grt's 100k scene at
     512x512 (the last through gather_rows' backward): per step ms, rays/s,
     peak memory, overflow and capacities, launches (B7, B8, B6 once each),
     the backward's branch and the share of particles with a gradient;
  8b. the flat cull's legs at both bench_grt configurations: the
     compact_kernel leg (B9's path: B9 launched once) against the
     member-sort leg (equal) and the default expand-sort leg (equal up to
     the order of equal depths), the default leg against the dense cull,
     and each leg timed;
  9. kernels: each kernel against its plain version on the card at the
     main paths' shapes (B3, B4 and every TileBinning field exactly equal,
     B3's and B4's kernels' ptxas reports and blocks per SM;
     B1, B2 (also their 16-pass and row-terminated legs, at the sorted and
     row-terminated train paths' inputs, two launches bit-identical; the
     sorted legs also at 1 pass, the difference being `network_ms`, and
     each leg's ptxas report and dynamic shared memory), B7
     and B8 (16, 1 and 0 passes: B7 writing its compositing orders
     bit-identical to B7 writing none, B8 on them bit-identical to B8
     whose wrapper runs B7 for them; `network_ms` and each
     instantiation's ptxas report as for B1/B2) within stated
     tolerances; B5, B6
     at 16 and at 64 channels within the f32 summation bound; B9 at the
     1M flat cull's inputs bit-equal and bit-identical), timed with
     CUDA events beside its bound and, for B5 and B6, one PyTorch call
     computing the same sums; B5's, B6's and B9's kernels' ptxas reports
     and blocks per SM (the CUDA runtime's occupancy query); B1's and
     B2's default legs as the train step runs them (B1 writing its
     live-row mask, B2 on it, bit-equal to B2 given none), their bounds
     on the work the inputs need (the plain
     version's counts: pairs a pixel can take, live pairs, warp-live and
     saturated-warp rows, the pair's per-row parts: once per row where a
     tile's rays share one origin) and the four default instantiations'
     ptxas; then
     both with per-pixel origins (the train inputs' ray origins nudged
     one by one, so the kernels take the pair's per-pixel form) against
     their plain versions, timed beside the shared-origin form;
  10. profile: one full-width frame, one compact frame (5b(b)'s), a
     playground hybrid and trace frame (5c's scene at 400x400), one
     full-width train step (default
     and sorted), one 100k trace, one 100k fwd+bwd and one 1M trace on the
     flat cull (its "3dgrt.cull" span split into its stages) under
     torch.profiler, for the device's busy share and the time per stage.

Every max_memory_allocated figure is its phase's own: the peak since the
phase began less what earlier phases still held then (phase_start).

Each path checks the kernels of its own renderer and pass
(cuda_build.kernels_of; B6 is in both renderers' backward; B9 runs only
on the flat cull's compact_kernel leg, phase 8b; M1 only on phase 5c's
playground paths).

The line before the last holds the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. A failed phase prints FAIL and exits 1.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores,
# HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# Operation counts per unit of work, read off the kernel sources: one
# tile-min power test with the particle's part computed once
# (csrc/tile_power.cuh: 42 adds, subtractions and multiplications), that
# part and the row half-extent once per particle (csrc/cull_masks.cu:
# 16 a, 16 b, 16 c, two reciprocals, the half-extent's 7), a key
# expansion slot (csrc/expand_keys.cu: the power re-test plus the row
# extent), one (pixel, slot) pair of the compositor
# (csrc/tile_raster_fwd.cu).
FLOP_POWER_TEST = 42
FLOP_POWER_PARTICLE = 14
FLOP_EXPAND_SLOT = 57
FLOP_PAIR = 75
# Of those, the per-row part w0 = o - mean, u = A w0 (3 + 9 + 6): where a
# tile's 256 rays share one origin (every global-shutter camera) it is
# needed once per row, not once per pair.
FLOP_PAIR_ROW = 18
# B2 (csrc/tile_raster_bwd.cu): per live pair (w > 0) the pair math
# (FLOP_PAIR; its sorted legs' pass A still evaluates it per (pixel, walked
# slot)), the gradient chain (108 operations) and the 16 adds that sum its
# row over the tile (warps with no live lane skip the reduction). B1's
# default legs need the pair math only where the pixel can take the row
# (T > min_T and, with row termination, the row at or before its lt): the
# "pixel_live_pairs" of tile_raster.tile_composite_plain's stats, the
# per-row part its "row_parts" times (B2: "live_row_parts").
FLOP_REDUCE = 16
FLOP_CHAIN = 108
# The odd-even network of B1's and B7's sorted legs (csrc/tile_pair.cuh
# oddeven_network_regs): a compare and a select for each of the 64
# compare-exchanges of a pass, counted for the passes a live pixel- or
# ray-window runs (it stops after two quiet passes).
FLOP_SWAP = 2
# B7 (csrc/bundle_trace_fwd.cu): the pair math and both gates (80) and the
# compositing step (6) per (live ray, walked row); per counted pair the SH
# colour (3 x 16 products and sums, the +0.5 and clamp: 102) and the 10
# accumulating operations; FLOP_SWAP per pair of the network, 64 pairs per
# pass run.
FLOP_GRT_PAIR = 86
FLOP_GRT_COUNTED = 112
# B8 (csrc/bundle_trace_bwd.cu): the pair math of B7 (FLOP_GRT_PAIR) where
# its walk evaluates a pair (with passes only at the hits of B7's orders;
# no network); per counted pair the gradient
# chain (the colour and suffix ~120, the pair chain ~110, the 48 SH products
# and the gates: 280) and the 61 adds that sum its row over the bundle.
FLOP_GRT_BWD_CHAIN = 280
FLOP_GRT_BWD_REDUCE = 61
# The reference CUDA system's train step on an RTX 5090 (BASELINE.md): the
# one outside yardstick for the fwd+bwd+Adam rays/s.
BASELINE_RAYS_PER_S = 8.66e7

MAIN_N = 1_000_000
MAIN_RES = (800, 800)
MAIN_CAP = 2917888
PARITY_N = 100_000
PARITY_RES = (400, 400)
PARITY_CAP = 1 << 20
TRAIN_STEPS = 6
# tools/bench_grt.py's configurations (n, Gaussian scale range, candidate,
# super, flat and super flat capacities, traces and fwd+bwd steps run here)
# and its probe's recorded super-list maximum, flat total and super flat
# total for each. At 100k bench_grt's comment records a super flat total of
# 913,408, which its probe code does not give for its scene: the JAX
# package's cull gives 521,984 there
# (tests/test_torch_grt_flat.py::test_bench_grt_100k_super_flat_total).
GRT_CONFIGS = [
    dict(name="100k", n=100_000, scales=(0.01, 0.05), cand=1792,
         super_cap=24320, flat_cap=919296, sflat_cap=1004800, traces=6,
         rec_super=22093, rec_flat=835584, rec_sflat=521984),
    dict(name="1M", n=1_000_000, scales=(0.004, 0.02), cand=7680,
         super_cap=216832, flat_cap=3384832, sflat_cap=4591104, traces=3,
         rec_super=196936, rec_flat=3076992, rec_sflat=4173696),
]
# bench_grt's fwd+bwd walked-compaction bound: its BENCH_WALKFRAC default
# of flat_capacity, rounded up to 256.
GRT_WALK_FRACTION = 0.625
# The 3DGRT trainer at bench_grt's 100k scene: its flat capacity.
GRT_TRAIN_ISECT = 919296
GRT_TRAIN_STEPS = 6
# Card vs CPU gradients of a whole 3DGRT fwd+bwd on bench_grt's scene: the
# cull admits a cone-margin particle on one side only in some bundles
# (PERF.md), which shifts their 128-row re-sort windows; the particles those
# bundles reach may differ. A share of the particles with a nonzero
# gradient that may be loose (golden.rows_agree's test per row).
GRT_GRAD_LOOSE_SHARE = 0.05
GRT_SIDE = 512
GRT_PARITY_SIDE = 128
GRT_PARITY_RES = (128, 64)
# Phase 6b, densification: the schedule compressed so that every event
# falls inside DENSIFY_STEPS steps (every other value is Config()'s); the
# share of each leg's particles given an opacity below both strategies'
# thresholds (0.005), so that prune and relocate have work (bench.py's
# scene has opacity 0.5 everywhere); the legs' capacities.
DENSIFY_SCHEDULE = dict(densify_start=2, densify_frequency=2,
                        mcmc_add_frequency=2, densify_end=7,
                        reset_density_frequency=4)
DENSIFY_STEPS = 6
DENSIFY_DEAD_SHARE = 0.05
DENSIFY_DEAD_OPACITY = 0.001
# GS: bench.py's 1M scene in 1,503,232 slots; after step 1 the gradient
# threshold becomes the DENSIFY_GS_SOURCES-th largest average, and the
# scale threshold 0.003 of the extent (0.012: the scene's scales are
# 0.004-0.02, above Config()'s 0.01 x 4.0 everything would clone).
DENSIFY_GS_CAP = 1_503_232
DENSIFY_GS_SOURCES = 100_000
DENSIFY_GS_SCALE = 0.003
# MCMC: 950,000 particles in 1,003,520 slots grow by 5% an event to
# mcmc_max_gaussians (1,000,000) at step 4; the 3DGRT leg's 100k scene in
# 110,592 slots fills them at step 6 (+5,000, +5,250, +342).
DENSIFY_MCMC_N = 950_000
DENSIFY_MCMC_CAP = 1_003_520
DENSIFY_MCMC_MAX = 1_000_000
DENSIFY_GRT_CAP = 110_592
DENSIFY_TIME_ITERS = 10
# Strategy operations card vs CPU from the same state and draws: masks,
# alive, taken slots and sources exactly; floats within these (the same
# f32 operations; CUDA's and the CPU's exp, pow and products may differ by
# an ulp).
STRATEGY_RTOL, STRATEGY_ATOL = 1e-5, 1e-6


def phase_start() -> int:
    """Start a phase's memory record: the peak is reset, and the bytes
    allocated now (earlier phases' live tensors) are returned, to be taken
    off the phase's peak (phase_peak_gib)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def phase_peak_gib(base: int) -> float:
    """The phase's peak device memory in GiB: the most allocated since
    phase_start, less what was allocated when it started."""
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `iters` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(nbytes: float, flops: float):
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def walked_windows(out, tile_starts) -> int:
    """Windows the compositor's walk covered, from the forward's walked
    slots (row 7): each holds a 16-byte live-row mask per pixel (default
    legs) or a 128-byte compositing order (sorted legs)."""
    w = out[:, 7, 0].long()
    s = tile_starts.long()
    n = torch.where(w > 0, (s + w - 1) // 128 - s // 128 + 1,
                    torch.zeros_like(w))
    return int(n.sum())


def default_bounds(ntiles, walked, windows, stats, mask=True):
    """B1's and B2's bounds on the default legs' work (`stats` from
    tile_composite_plain): B1 reads the rays and the walked rows, writes
    its output (and, `mask`, the live-row mask: 16 bytes per pixel-window)
    and evaluates the pairs its pixels can take, their per-row part once
    per row where the tile's rays share an origin; B2 reads the rays, the
    forward's output, the cotangent, the walked rows and the mask, writes
    the walked rows' gradients, and runs the pair, the chain and the
    reduction for the live pairs (the pair's per-row part likewise)."""
    mask_bytes = 16 * 256 * windows
    per_pair = FLOP_PAIR - FLOP_PAIR_ROW
    b1 = bound_ms(ntiles * 8 * 256 * 4 * 2 + ntiles * 8 + walked * 64
                  + (mask_bytes if mask else 0),
                  per_pair * stats["pixel_live_pairs"]
                  + FLOP_PAIR_ROW * stats["row_parts"])
    b2 = bound_ms(ntiles * 8 * 256 * 4 * 3 + ntiles * 8 + walked * 64 * 2
                  + mask_bytes,
                  (per_pair + FLOP_CHAIN + FLOP_REDUCE) * stats["live_pairs"]
                  + FLOP_PAIR_ROW * stats["live_row_parts"])
    return b1, b2


def walked_pair_ops(rays, out) -> int:
    """The pair math of every (pixel, walked slot) (the sorted legs' pass
    A), `out` the forward's output: the per-row part once per walked slot
    of a tile whose rays share one origin, once per pixel elsewhere."""
    from threedgrut_torch.ops import tile_raster
    w = out[:, 7, 0].double()
    rows = torch.where(tile_raster.shares_origin(rays), w, 256 * w)
    return int((FLOP_PAIR - FLOP_PAIR_ROW) * 256 * w.sum()
               + FLOP_PAIR_ROW * rows.sum())


def profile_run(fn, prefixes):
    """fn() once (warm) and once under torch.profiler. From the trace's
    device timeline: the busy time (union of kernel, memcpy and memset
    intervals) and idle share over the run's wall time, device time per
    stage (the span of each record_function label with one of `prefixes`
    on the device timeline), host time per stage, and the top kernels. The
    trace is kept in build/chip_smoke_trace.json."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "chip_smoke_trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    dev_cats = ("kernel", "gpu_memcpy", "gpu_memset")
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in dev_cats)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_kernel, stage_span, stage_host, window = {}, {}, {}, {}
    for e in events:
        if e.get("cat") == "kernel":
            k = e["name"][:70]
            by_kernel[k] = by_kernel.get(k, 0.0) + e.get("dur", 0) / 1e3
        name = e.get("name", "")
        if name.startswith(tuple(prefixes)):
            if e.get("cat") == "gpu_user_annotation":
                stage_span[name] = stage_span.get(name, 0.0) + e["dur"] / 1e3
                lo, hi = window.get(name, (math.inf, -math.inf))
                window[name] = (min(lo, e["ts"]), max(hi, e["ts"] + e["dur"]))
            elif e.get("cat") == "user_annotation":
                stage_host[name] = stage_host.get(name, 0.0) + e["dur"] / 1e3
    if "train.loss" in window and "train.adam" in window:
        # The backward's kernels are launched by autograd's device thread,
        # outside the "train.backward" range of the calling thread: its
        # device span is the gap between the loss's end and Adam's start.
        stage_span["train.backward (loss end to adam start)"] = (
            window["train.adam"][0] - window["train.loss"][1]) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
            "kernel_launches": sum(1 for e in events
                                   if e.get("cat") == "kernel"),
            "stage_device_span_ms": stage_span, "stage_host_ms": stage_host,
            "top_kernels_ms": dict(top)}


class OneView:
    """A dataset of one training view (the Trainer's dataset protocol)."""

    def __init__(self, view, scene_extent: float):
        self.view, self.scene_extent = view, scene_extent

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        return self.view


def train_setup(fields, res, cap, gt, dev, walk_compact_fraction=0.625,
                low_precision_grads=True, cfg=None):
    """A Trainer on `dev` over one view from bench.py's camera, with
    Config() defaults (or `cfg`) but SH degree 3 from the first step
    (bench.py's)."""
    from threedgrut_torch.cameras import example_camera, look_at
    from threedgrut_torch.config import Config
    from threedgrut_torch.datasets.protocols import View
    from threedgrut_torch.model.gaussians import from_numpy
    from threedgrut_torch.trainer import Trainer
    cfg = copy.deepcopy(cfg) if cfg is not None else Config()
    cfg.render.isect_capacity = cap
    cfg.render.walk_compact_fraction = walk_compact_fraction
    cfg.render.low_precision_grads = low_precision_grads
    cfg.model.progressive_sh_interval = 0
    T = look_at(np.array([0.0, -4.0, 1.0], np.float32),
                np.zeros(3, np.float32), np.array([0.0, 0.0, 1.0],
                                                  np.float32))
    view = View(T_to_world=T, camera=example_camera(res, dev),
                resolution=res, rgb_gt=gt)
    trainer = Trainer(cfg, OneView(view, 4.0),
                      params=from_numpy(fields, device=dev), device=dev)
    return trainer, view


def train_parity(dev, tag):
    """One train step on the card and on the CPU from the same parameters,
    f32 gradients, on each way the gradient reduction can go, with the
    default legs, with preset_3dgut_sorted (16 passes) and with row
    termination, within step_agreement's tolerances; then one sorted
    Trainer.eval_view card vs CPU within golden.compare."""
    from threedgrut_torch import golden
    from threedgrut_torch.config import Config, preset_3dgut_sorted
    from threedgrut_torch.model.gaussians import bench_scene
    from threedgrut_torch.ops import cuda_build
    fields = bench_scene(PARITY_N, seed=0, specular_std=0.1)
    gt = np.random.default_rng(0).uniform(
        0, 1, (PARITY_RES[1], PARITY_RES[0], 3)).astype(np.float32)
    rowterm = Config()
    rowterm.render.row_termination = True
    # The fused path's compact branch (B6); the fused path with a walk
    # capacity of one window, which the walk exceeds, so its backward falls
    # back to the dense unsort (B5); and the two-stage path (B5).
    b5, b6 = "segment_sum_rows", "segment_sum_rows_by_ids"
    one_window = 256 / PARITY_CAP
    for mode, cfg, frac, kernel, other in (
            ("default", None, 0.625, b6, b5),
            ("default", None, one_window, b5, b6),
            ("default", None, 0.0, b5, b6),
            ("sorted16", preset_3dgut_sorted(), 0.625, b6, b5),
            ("sorted16", preset_3dgut_sorted(), one_window, b5, b6),
            ("row_termination", rowterm, 0.625, b6, b5)):
        runs = {}
        for device in (dev, "cpu"):
            tr, view = train_setup(fields, PARITY_RES, PARITY_CAP, gt,
                                   device, frac, low_precision_grads=False,
                                   cfg=cfg)
            cuda_build.launches.clear()
            aux = tr.train_step(view)
            runs[device] = (tr, aux, dict(cuda_build.launches))
        (tg, ag, lg), (tc, ac, _) = runs[dev], runs["cpu"]
        if (lg.get(kernel, 0) != 1 or lg.get(other, 0) != 0
                or lg.get("tile_raster_bwd", 0) != 1):
            fail(f"train parity ({mode}, walk_compact_fraction={frac}) did "
                 f"not run B2 and {kernel} once and {other} never: {lg}")
        rep, ok = step_agreement(tg, ag, tc, ac)
        print(f"train step card vs CPU ({mode}), {PARITY_N} Gaussians "
              f"{PARITY_RES}, walk_compact_fraction={frac} ({kernel}): "
              f"{json.dumps(rep)} {tag}", flush=True)
        if not ok:
            fail(f"the train step on the card disagrees with the plain path "
                 f"({mode}, walk_compact_fraction={frac})")

    auxs = []
    for device in (dev, "cpu"):
        tr, view = train_setup(fields, PARITY_RES, PARITY_CAP, gt, device,
                               cfg=preset_3dgut_sorted())
        cuda_build.launches.clear()
        auxs.append(tr.eval_view(view))
        if device == dev and dict(cuda_build.launches) != {
                k: 1 for k in cuda_build.kernels_of("gut", ("forward",))}:
            fail(f"the sorted eval step launched {dict(cuda_build.launches)}")
    rep, ok = golden.compare(
        *[dict(rgb=a["pred"], opacity=a["opacity"], depth=a["depth"],
               transmittance=1.0 - a["opacity"], hit_count=a["hit_count"],
               visibility=a["visibility"]) for a in auxs])
    print(f"Trainer.eval_view (preset_3dgut_sorted) card vs CPU, "
          f"{PARITY_N} Gaussians {PARITY_RES}: {json.dumps(rep)} psnr "
          f"{float(auxs[0]['psnr']):.6f} / {float(auxs[1]['psnr']):.6f} "
          f"{tag}", flush=True)
    if not ok or any(bool(a["overflow"]) for a in auxs):
        fail("the sorted eval step on the card disagrees with the plain "
             "path")


def step_agreement(tg, ag, tc, ac):
    """(report, ok) of a train step on the card (trainer tg, aux ag) against
    the same step on the CPU (tc, ac). Tolerances: loss rtol 1e-4; image
    values beyond atol 2e-4 + rtol 1e-4 on at most 0.1% of them; gradients,
    first moments (0.1 g), the |g| implied by the second moments and the
    updated parameters within golden.rows_agree (1e-4 x max for gradients
    and moments, 1e-6 x max for the parameters, compared where |g| clears
    2e-4 x max: Adam's first step is lr sign(g)); the visibility on all but
    0.1% of the particles."""
    from threedgrut_torch import golden
    rep = {"loss": (float(ag["terms"]["total"]),
                    float(ac["terms"]["total"]))}
    ok = abs(rep["loss"][0] - rep["loss"][1]) <= 1e-4 * abs(rep["loss"][1])
    d = (ag["pred"].cpu() - ac["pred"]).abs()
    loose = int((d > 2e-4 + 1e-4 * ac["pred"].abs()).sum())
    rep["image"] = {"max_abs": float(d.max()), "loose": loose}
    ok &= loose <= max(1, math.floor(1e-3 * d.numel()))
    for f, gc in ac["grads"].items():
        gg = ag["grads"][f].cpu()
        r1, o1 = golden.rows_agree(gg, gc, 1e-4)
        r2, o2 = golden.rows_agree(tg.opt_state.exp_avg[f],
                                   tc.opt_state.exp_avg[f], 1e-4)
        r3, o3 = golden.rows_agree(
            (tg.opt_state.exp_avg_sq[f].cpu() / 1e-3).sqrt(),
            (tc.opt_state.exp_avg_sq[f] / 1e-3).sqrt(), 1e-4)
        clear = gc.abs() > 2e-4 * float(gc.abs().max())
        pc = getattr(tc.params, f).detach()
        pg = torch.where(clear, getattr(tg.params, f).detach().cpu(), pc)
        r4, o4 = golden.rows_agree(pg, pc, 1e-6)
        rep[f] = {"grad": r1, "m": r2, "v": r3, "param": r4}
        ok &= o1 and o2 and o3 and o4
    dv = int((ag["visibility"].cpu() != ac["visibility"]).sum())
    rep["visibility_diff"] = dv
    ok &= dv <= max(1, math.floor(1e-3 * ac["visibility"].numel()))
    return rep, ok


def grt_bench_scene(n, scales, dev, side=GRT_SIDE, crop=None,
                    capacity=None):
    """tools/bench_grt.py's scene as Gaussians on `dev` (the same seeded
    numpy draws in the same order: positions, quaternions, scales, albedo,
    ray jitter), padded to `capacity` (default: the next multiple of 4096),
    and its side x side ray grid from (0, 0, -4) in 16x16-tile order, as
    CUDA/CPU tensors (origins, unit directions). `crop` keeps the central
    crop x crop rays of the grid."""
    from threedgrut_torch.model.gaussians import from_arrays
    rng = np.random.default_rng(0)
    pos = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    s = np.exp(rng.uniform(np.log(scales[0]), np.log(scales[1]),
                           (n, 3))).astype(np.float32)
    albedo = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    params = from_arrays(pos, q, np.log(s), np.zeros((n, 1), np.float32),
                         albedo, np.zeros((n, 45), np.float32), capacity,
                         device=dev)
    px = (np.arange(side) + 0.5) / side * 0.8 - 0.4
    gx, gy = np.meshgrid(px, px, indexing="xy")
    jit = rng.uniform(-0.4 / side, 0.4 / side, (2,) + gx.shape)
    d = np.stack([gx + jit[0], gy + jit[1], np.ones_like(gx)],
                 -1).astype(np.float32)
    if crop:
        lo = (side - crop) // 2
        d, side = d[lo:lo + crop, lo:lo + crop], crop
    t = side // 16
    d = d.reshape(t, 16, t, 16, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 3)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.array([[0.0, 0.0, -4.0]], np.float32), (side * side, 1))
    return (params, torch.tensor(o, device=dev),
            torch.tensor(d.astype(np.float32), device=dev))


def grt_trace_kw(cfg, flat=False):
    """grt.trace keywords of bench_grt's configuration `cfg`; `flat`: its
    BENCH_PACKED=flat mode (the flat cull, super_flat_capacity)."""
    kw = dict(kernel_degree=4, candidate_capacity=cfg["cand"],
              super_capacity=cfg["super_cap"], flat_capacity=cfg["flat_cap"],
              sorted_passes=16)
    if flat:
        kw.update(flat_cull=True, super_flat_capacity=cfg["sflat_cap"])
    return kw


def grt_parity(dev, tag):
    """3DGRT card vs CPU, within golden.compare: api.trace on bench_grt's
    100k scene (the central 128x128 rays of its 512x512 grid: 64 bundles
    of its angular size, so its capacities hold) at TRACE_FLIP_SHARE (the
    cull decides margin particles per device there); api.render(method=
    "3dgrt") of the 100k benchmark scene at 128x64 (32 bundles) and one
    Trainer.eval_view of preset_3dgrt on the golden scene at 128x128, at
    compare's default share."""
    from threedgrut_torch import api, golden
    from threedgrut_torch.cameras import example_camera, pose_from_matrix
    from threedgrut_torch.config import preset_3dgrt
    from threedgrut_torch.model.gaussians import bench_scene, from_numpy
    from threedgrut_torch.ops import cuda_build
    cfg = GRT_CONFIGS[0]
    runs = {}
    for device in (dev, "cpu"):
        params, o, d = grt_bench_scene(cfg["n"], cfg["scales"], device,
                                       crop=GRT_PARITY_SIDE)
        cuda_build.launches.clear()
        with torch.no_grad():
            out = api.trace(params, o, d, device=device, **grt_trace_kw(cfg))
        if bool(out.overflow):
            fail(f"api.trace parity on {device} overflowed")
        runs[device] = (out, dict(cuda_build.launches))
    if runs[dev][1] != {"bundle_trace_fwd": 1}:
        fail(f"api.trace on the card launched {runs[dev][1]}")
    rep, ok = golden.compare(runs[dev][0], runs["cpu"][0],
                             golden.TRACE_FLIP_SHARE)
    print(f"api.trace card vs CPU, bench_grt 100k, {GRT_PARITY_SIDE}^2 rays: "
          f"{json.dumps(rep)}", flush=True)
    if not ok:
        fail("api.trace on the card disagrees with the plain path")

    fields = bench_scene(PARITY_N, seed=0, specular_std=0.1)
    frames = []
    for device in (dev, "cpu"):
        with torch.no_grad():
            out, ovf = api.render(
                from_numpy(fields, device=device),
                example_camera(GRT_PARITY_RES, device),
                pose_from_matrix(torch.as_tensor(orbit_T(0), device=device)),
                GRT_PARITY_RES, method="3dgrt",
                isect_capacity=1 << 22, super_capacity=98304, device=device)
        if bool(ovf):
            fail(f"api.render(method='3dgrt') on {device} overflowed")
        frames.append(out)
    rep, ok = golden.compare(*frames)
    print(f"api.render(method='3dgrt') card vs CPU, {PARITY_N} Gaussians "
          f"{GRT_PARITY_RES}: {json.dumps(rep)}", flush=True)
    if not ok:
        fail("api.render(method='3dgrt') on the card disagrees with the "
             "plain path")

    cfg3 = preset_3dgrt()
    cfg3.model.progressive_sh_interval = 0
    auxs = []
    for device in (dev, "cpu"):
        tr, view = train_setup(golden.scene(), (128, 128), 1 << 20,
                               np.zeros((128, 128, 3), np.float32), device,
                               cfg=cfg3)
        auxs.append(tr.eval_view(view))
    rep, ok = golden.compare(
        *[dict(rgb=a["pred"], opacity=a["opacity"], depth=a["depth"],
               transmittance=1.0 - a["opacity"], hit_count=a["hit_count"],
               visibility=a["visibility"]) for a in auxs])
    print(f"Trainer.eval_view (preset_3dgrt) card vs CPU, golden scene "
          f"128x128: {json.dumps(rep)} psnr {float(auxs[0]['psnr']):.6f} / "
          f"{float(auxs[1]['psnr']):.6f} {tag}", flush=True)
    if not ok or any(bool(a["overflow"]) for a in auxs):
        fail("the 3DGRT eval step on the card disagrees with the plain path")


def grt_main_path(dev, tag, flat=False):
    """tools/bench_grt.py's configurations through api.trace (`flat`: its
    BENCH_PACKED=flat mode, the flat cull), each with the launch counts
    cleared just before and read just after its traces. Returns ({name:
    launches}, the 100k scene and rays, the 100k inputs of B7 from
    grt.prepare)."""
    from threedgrut_torch import api
    from threedgrut_torch.ops import cuda_build
    from threedgrut_torch.render import grt
    launches, keep = {}, None
    mode = "flat cull" if flat else "dense cull"
    for cfg in GRT_CONFIGS:
        base = phase_start()
        params, o, d = grt_bench_scene(cfg["n"], cfg["scales"], dev)
        kw = grt_trace_kw(cfg, flat)
        acts = grt_acts(params)
        with torch.no_grad():
            dn, active = grt._rays_unit(d)
            p, radius, valid, d_safe = grt._cull_inputs(
                acts[0], acts[2], acts[3], dn, active, 4, False)
            b = grt.make_bundles(o, d_safe, 256)
            sup = grt.make_super_bundles(b, grt.bundle_morton_order(b), 16)
            counts1 = grt._cone_hit(p, radius, valid, sup)[0].sum(1)
            super_max = int(counts1.max())
            super_flat = int((-(-counts1 // 128) * 128).sum())
            del counts1
            inp = grt.prepare(*acts, o, d, **{k: v for k, v in kw.items()
                                              if k != "sorted_passes"})
            flat_total = int((-(-inp.counts // 128) * 128).sum())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.launches.clear()
        ms = []
        for k in range(cfg["traces"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                out = api.trace(params, o, d, device=dev, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if bool(out.overflow):
                fail(f"3DGRT {cfg['name']} ({mode}) trace {k + 1} "
                     f"overflowed")
            for fld in ("rgb", "opacity", "depth", "transmittance",
                        "hit_count"):
                if not bool(torch.isfinite(getattr(out, fld)).all()):
                    fail(f"3DGRT {cfg['name']} ({mode}) trace {k + 1}: "
                         f"{fld} not finite")
        got = dict(cuda_build.launches)
        launches[cfg["name"]] = got
        peak = phase_peak_gib(base)
        print(f"3DGRT main path {cfg['name']} ({mode}) launches: {got}",
              flush=True)
        if got != {"bundle_trace_fwd": cfg["traces"]}:
            fail(f"{cfg['traces']} traces at {cfg['name']} ({mode}) "
                 f"launched {got}")
        for kname in cuda_build.kernels_of("grt", ("forward",)):
            if got.get(kname, 0) <= 0:
                fail(f"kernel {kname} was not launched on the 3DGRT path")
        cover = float((out.opacity > 0.01).float().mean())
        checks = [("super-list maximum", super_max, cfg["rec_super"]),
                  ("flat total", flat_total, cfg["rec_flat"])]
        if flat:
            checks.append(("super flat total", super_flat, cfg["rec_sflat"]))
        for what, v, rec in checks:
            print(f"3DGRT {cfg['name']} ({mode}): {what} {v} (recorded "
                  f"{rec}; {100 * (v - rec) / rec:+.4f}%)", flush=True)
            if abs(v - rec) > 1e-3 * rec:
                fail(f"3DGRT {cfg['name']}: {what} {v} is not within 0.1% "
                     f"of the recorded {rec}")
        steady = ms[1:5] if len(ms) >= 5 else ms[1:]
        med = float(np.median(steady))
        n_rays = o.shape[0]
        print(f"3DGRT {cfg['name']} ({mode}): trace ms "
              f"{[round(x, 3) for x in ms]}; median of traces "
              f"2-{len(steady) + 1} {med:.3f} ms, rays/s "
              f"{n_rays / (med / 1e3):.4e}; coverage {cover:.4f}; "
              f"max_memory_allocated {peak:.3f} GiB {tag}", flush=True)
        print(json.dumps({
            "metric": "grt_trace_rays_per_s_infer",
            "value": n_rays / (med / 1e3), "unit": "rays/s/chip",
            "backend": "cuda", "device": torch.cuda.get_device_name(0),
            "n_gaussians": cfg["n"], "n_rays": n_rays,
            "candidate_capacity": cfg["cand"],
            "flat_capacity": cfg["flat_cap"],
            "super_flat_capacity": cfg["sflat_cap"] if flat else None,
            "packed_cull": False, "flat_cull": flat,
            "candidate_overflow": False, "step_ms": med,
            "max_memory_allocated_gib": peak}), flush=True)
        if keep is None and not flat:
            keep = (params, o, d, inp)
        del params, o, d, inp, out, acts, p, radius, valid, d_safe
    return launches, keep


# bench_grt's BENCH_PACKED modes: "1" the packed cull (both levels on
# packed keys), "l1" the packed level-1 sort only.
GRT_PACKED_MODES = {"1": dict(packed_cull=True), "l1": dict(packed_l1=True)}


def grt_packed_parity(dev, tag):
    """The packed modes card vs CPU, as grt_parity holds the exact cull's
    trace: api.trace on bench_grt's 100k scene over the central 128x128
    rays of its grid, each mode within golden.compare at TRACE_FLIP_SHARE
    of the plain path (which tests/test_torch_grt_packed.py holds to the
    JAX package's packed culls)."""
    from threedgrut_torch import api, golden
    cfg = GRT_CONFIGS[0]
    scenes = {device: grt_bench_scene(cfg["n"], cfg["scales"], device,
                                      crop=GRT_PARITY_SIDE)
              for device in (dev, "cpu")}
    for mode, pkw in GRT_PACKED_MODES.items():
        outs = []
        for device, (params, o, d) in scenes.items():
            with torch.no_grad():
                outs.append(api.trace(params, o, d, device=device,
                                      **grt_trace_kw(cfg), **pkw))
        rep, ok = golden.compare(*outs, golden.TRACE_FLIP_SHARE)
        print(f"api.trace BENCH_PACKED={mode} card vs CPU, bench_grt 100k, "
              f"{GRT_PARITY_SIDE}^2 rays: {json.dumps(rep)} {tag}",
              flush=True)
        if not ok or any(bool(x.overflow) for x in outs):
            fail(f"api.trace BENCH_PACKED={mode} on the card disagrees with "
                 f"the plain path")


def grt_packed_main_path(dev, tag):
    """Phase 7's packed modes: tools/bench_grt.py's BENCH_PACKED=1 and l1 at
    both configurations through api.trace (100k: 6 traces, 1M: 3), the
    launch counts cleared just before and read just after each mode's
    traces. Each bundle's candidate set (grt.prepare's flat layout) must
    equal the exact two-level cull's, exactly. The lists' order against it
    (golden.lists_agree) and the frame against the exact cull's
    (golden.compare at TRACE_FLIP_SHARE) are measured, not held: quantized
    depth reorders a share of each list (the JAX package's design, the
    same share there: tests/test_torch_grt_packed.py), and the 16-pass
    re-sort does not undo every reorder. ms a trace beside the exact
    cull's, timed in the same call. Card vs CPU: grt_packed_parity. Returns
    ({"<mode> <name>": launches}, the phase's wall seconds)."""
    from threedgrut_torch import api, golden
    from threedgrut_torch.ops import cuda_build
    from threedgrut_torch.render import grt
    t_phase = time.time()
    grt_packed_parity(dev, tag)
    launches = {}
    for cfg in GRT_CONFIGS:
        base = phase_start()
        params, o, d = grt_bench_scene(cfg["n"], cfg["scales"], dev)
        acts = grt_acts(params)
        kw = grt_trace_kw(cfg)
        prep = {k: v for k, v in kw.items() if k != "sorted_passes"}
        runs = {}
        for mode, pkw in [("exact", {})] + list(GRT_PACKED_MODES.items()):
            with torch.no_grad():
                inp = grt.prepare(*acts, o, d, **prep, **pkw)
            if bool(inp.overflow):
                fail(f"3DGRT {cfg['name']} packed mode {mode}: the cull "
                     f"overflowed")
            lists = golden.bundle_lists(inp.flat_idx, inp.valid,
                                        inp.win_starts, inp.win_ends)
            del inp
            cuda_build.launches.clear()
            ms = []
            for k in range(cfg["traces"]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    out = api.trace(params, o, d, device=dev, **kw, **pkw)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if bool(out.overflow) or not all(
                        bool(torch.isfinite(getattr(out, f)).all())
                        for f in ("rgb", "opacity", "depth")):
                    fail(f"3DGRT {cfg['name']} packed mode {mode} trace "
                         f"{k + 1}: overflow or a value not finite")
            got = dict(cuda_build.launches)
            if got != {"bundle_trace_fwd": cfg["traces"]}:
                fail(f"3DGRT {cfg['name']} packed mode {mode}: "
                     f"{cfg['traces']} traces launched {got}")
            if mode != "exact":
                launches[f"packed_{mode} {cfg['name']}"] = got
            steady = ms[1:5] if len(ms) >= 5 else ms[1:]
            runs[mode] = (lists, out, float(np.median(steady)), ms)
        exact_lists, exact_out, exact_ms, _ = runs["exact"]
        for mode in GRT_PACKED_MODES:
            lists, out, med, ms = runs[mode]
            sets_equal = len(lists) == len(exact_lists) and all(
                len(a) == len(b) and set(a.tolist()) == set(b.tolist())
                for a, b in zip(lists, exact_lists))
            lrep, _ = golden.lists_agree(lists, exact_lists,
                                         golden.TRACE_FLIP_SHARE)
            frep, fok = golden.compare(out, exact_out,
                                       golden.TRACE_FLIP_SHARE)
            print(f"3DGRT {cfg['name']} BENCH_PACKED={mode}: candidate sets "
                  f"equal to the exact cull's {sets_equal}; lists against "
                  f"it {json.dumps(lrep)}; frame against it (measured, not "
                  f"held) {json.dumps(frep)}, within golden.compare at "
                  f"TRACE_FLIP_SHARE {fok}; trace ms "
                  f"{[round(x, 3) for x in ms]}, median {med:.3f} (exact "
                  f"cull {exact_ms:.3f}) {tag}", flush=True)
            if not sets_equal:
                fail(f"3DGRT {cfg['name']} BENCH_PACKED={mode}: candidate "
                     f"sets differ from the exact two-level cull's")
            n_rays = o.shape[0]
            print(json.dumps({
                "metric": "grt_trace_rays_per_s_infer",
                "value": n_rays / (med / 1e3), "unit": "rays/s/chip",
                "backend": "cuda", "device": torch.cuda.get_device_name(0),
                "n_gaussians": cfg["n"], "n_rays": n_rays,
                "candidate_capacity": cfg["cand"],
                "flat_capacity": cfg["flat_cap"], "packed_cull": mode,
                "flat_cull": False, "candidate_overflow": False,
                "step_ms": med, "exact_cull_step_ms": exact_ms,
                "max_memory_allocated_gib": phase_peak_gib(base)}),
                flush=True)
        del params, o, d, acts, runs, exact_out, exact_lists
    wall = time.time() - t_phase
    print(f"phase 7 packed modes wall {wall:.1f} s", flush=True)
    return launches, wall


def grt_packed_fwd_bwd(dev, tag):
    """Phase 8's packed fwd+bwd: bench_grt's fwd+bwd at 100k (6 steps) with
    BENCH_PACKED=1 (B7, B8 and B6 once a step), the launch counts cleared
    just before and read just after; its frame within golden.compare of
    the packed forward-only trace (api.trace) of the same parameters.
    Against the exact cull's fwd+bwd from the same parameters (measured,
    not held: the packed cull orders near-tie depths otherwise, and the
    16-pass re-sort does not undo every reorder): the frame by
    golden.compare, and the share of particles whose gradient of positions
    or opacities differs by more than f32 reordering (2e-4 x max|g| +
    5e-8, as tests/test_parallel.py) with the largest such difference.
    Returns ({"packed_1 100k": launches}, the wall seconds)."""
    from threedgrut_torch import golden
    from threedgrut_torch.ops import cuda_build, fused_raster
    from threedgrut_torch.render import grt
    t_phase = time.time()
    cfg = GRT_CONFIGS[0]
    params, o, d = grt_bench_scene(cfg["n"], cfg["scales"], dev)
    acts = grt_acts(params)
    del params
    kw = grt_trace_kw(cfg)
    walk = grt_walk_capacity(cfg["flat_cap"])
    want = cuda_build.kernels_of("grt")
    ex_out, _, ex_g = grt_fwd_bwd(acts, o, d, kw, walk, (0, 3))
    cuda_build.launches.clear()
    ms = []
    for k in range(cfg["traces"]):
        fused_raster.branches.clear()
        before = dict(cuda_build.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, loss, g = grt_fwd_bwd(acts, o, d, dict(kw, packed_cull=True),
                                   walk, (0, 3))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        step = {n: v - before.get(n, 0) for n, v in cuda_build.launches.items()
                if v != before.get(n, 0)}
        if step != {n: 1 for n in want} or bool(out.overflow) or not (
                math.isfinite(float(loss.detach()))
                and all(bool(torch.isfinite(x).all()) for x in g)):
            fail(f"3DGRT packed fwd+bwd step {k + 1}: launches {step}, "
                 f"overflow {bool(out.overflow)}, or a value not finite")
    launches = {f"packed_1 {cfg['name']}": dict(cuda_build.launches)}
    with torch.no_grad():
        fwd = grt.trace(*acts, o, d, packed_cull=True, **kw)
    crep, cok = golden.compare(out, fwd)
    frep, fok = golden.compare(out, ex_out, golden.TRACE_FLIP_SHARE)
    hit = None
    worst = 0.0
    for name, gp, ge in zip(("positions", "opacities"), g, ex_g):
        a = gp.reshape(gp.shape[0], -1).double()
        b = ge.reshape(ge.shape[0], -1).double()
        bound = 2e-4 * float(b.abs().max()) + 5e-8
        diff = (a - b).abs().amax(1)
        loose = diff > bound
        hit = loose if hit is None else hit | loose
        worst = max(worst, float(diff.max()) / max(float(b.abs().max()),
                                                  1e-30))
    nz = nonzero_share(ex_g)
    share = float(hit.double().mean()) / max(nz, 1e-12)
    med = float(np.median(ms[1:5]))
    print(f"3DGRT packed fwd+bwd {cfg['name']} (BENCH_PACKED=1): steps ms "
          f"{[round(x, 3) for x in ms]}, median of 2-5 {med:.3f}; frame vs "
          f"the packed forward trace {json.dumps(crep)}; against the exact "
          f"cull's fwd+bwd (measured, not held): frame {json.dumps(frep)} "
          f"(within TRACE_FLIP_SHARE {fok}), particles whose gradient "
          f"differs by more than 2e-4 x max|g| + 5e-8: {share:.6f} of those "
          f"with a gradient ({nz:.4f} of all), the largest difference "
          f"{worst:.4e} x max|g|; branch {dict(fused_raster.branches)} "
          f"{tag}", flush=True)
    if not cok:
        fail("the packed fwd+bwd's frame is outside golden.compare of the "
             "packed forward trace")
    wall = time.time() - t_phase
    print(f"phase 8 packed fwd+bwd wall {wall:.1f} s", flush=True)
    return launches, wall


def grt_flat_parity(dev, tag):
    """The flat cull against the dense two-level cull on the card, at
    tools/bench_grt.py's 100k scene and capacities (512x512 rays): each
    bundle's candidate list through grt.prepare's win_starts, win_ends and
    valid (golden.lists_agree: cone-margin flips and equal-depth reorders
    each on at most TRACE_FLIP_SHARE of the candidates), and api.trace's
    outputs within golden.compare at TRACE_FLIP_SHARE."""
    from threedgrut_torch import api, golden
    from threedgrut_torch.render import grt
    cfg = GRT_CONFIGS[0]
    params, o, d = grt_bench_scene(cfg["n"], cfg["scales"], dev)
    acts = grt_acts(params)
    lists, traces = {}, {}
    for flat in (False, True):
        kw = grt_trace_kw(cfg, flat)
        with torch.no_grad():
            inp = grt.prepare(*acts, o, d, **{k: v for k, v in kw.items()
                                              if k != "sorted_passes"})
            traces[flat] = api.trace(params, o, d, device=dev, **kw)
        if bool(inp.overflow) or bool(traces[flat].overflow):
            fail(f"3DGRT flat parity (flat_cull={flat}) overflowed")
        lists[flat] = golden.bundle_lists(inp.flat_idx, inp.valid,
                                          inp.win_starts, inp.win_ends)
        del inp
    rep, ok = golden.lists_agree(lists[True], lists[False],
                                 golden.TRACE_FLIP_SHARE)
    print(f"3DGRT flat cull vs dense two-level cull on the card, bench_grt "
          f"100k, 512^2 rays, per-bundle lists: {json.dumps(rep)}", flush=True)
    if not ok:
        fail("the flat cull's candidate lists disagree with the dense cull's")
    rep, ok = golden.compare(traces[True], traces[False],
                             golden.TRACE_FLIP_SHARE)
    print(f"api.trace flat_cull=True vs False on the card, bench_grt 100k: "
          f"{json.dumps(rep)} {tag}", flush=True)
    if not ok:
        fail("the flat cull's trace disagrees with the dense cull's")


def grt_cull_legs(dev, tag):
    """The flat cull's legs at each of bench_grt's configurations on the
    card, on api.trace's cull inputs: the compact_kernel leg (B9, the
    launch counts cleared just before and read just after it) against the
    member-sort leg (exactly equal lists: the same super lists and tie
    order) and the default expand-sort leg (the same lists exactly up to
    the order of equal depths, whose ties it breaks by particle id), and
    the default leg against the dense two-level cull (golden.lists_agree at
    TRACE_FLIP_SHARE). Each leg and the dense cull timed (host clock to a
    synchronize, median of 3 after a warm run). Returns ({name: launches of
    the B9 leg}, B9's arguments at the last configuration, {name: leg ms})."""
    from threedgrut_torch import golden
    from threedgrut_torch.ops import cuda_build, stream_compact
    from threedgrut_torch.render import grt
    launches, captured, leg_ms = {}, {}, {}
    real = stream_compact.compact_streams

    def capture(*args):
        captured["args"] = args
        return real(*args)

    for cfg in GRT_CONFIGS:
        params, o, d = grt_bench_scene(cfg["n"], cfg["scales"], dev)
        acts = grt_acts(params)
        del params
        with torch.no_grad():
            dn, active = grt._rays_unit(d)
            cull_in = grt._cull_inputs(acts[0], acts[2], acts[3], dn, active,
                                       4, False)
        args = (*cull_in[:3], o, cull_in[3], 256, cfg["cand"])
        kw = dict(super_capacity=cfg["super_cap"],
                  super_flat_capacity=cfg["sflat_cap"],
                  flat_capacity=cfg["flat_cap"])
        legs = {"expand_sort": {}, "member_sort": dict(expand_sort=False),
                "compact_kernel": dict(compact_kernel=True)}
        outs = {}
        for leg, lkw in legs.items():
            cuda_build.launches.clear()
            stream_compact.compact_streams = capture
            try:
                with torch.no_grad():
                    out = grt.bundle_candidates_twolevel_flat(*args, **kw,
                                                              **lkw)
                torch.cuda.synchronize()
            finally:
                stream_compact.compact_streams = real
            got = dict(cuda_build.launches)
            if got != ({"compact_streams": 1} if lkw.get("compact_kernel")
                       else {}):
                fail(f"the flat cull's {leg} leg at {cfg['name']} launched "
                     f"{got}")
            if leg == "compact_kernel":
                launches[cfg["name"]] = got
            if bool(out[4]):
                fail(f"the flat cull's {leg} leg overflowed at {cfg['name']}")
            outs[leg] = golden.bundle_lists(*out[:4])
        with torch.no_grad():
            ci, counts, ovf, _ = grt.bundle_candidates_twolevel(
                *args, super_capacity=cfg["super_cap"])
        if bool(ovf):
            fail(f"the dense two-level cull overflowed at {cfg['name']}")
        ci, counts = ci.cpu().numpy(), counts.cpu().numpy()
        dense = [ci[b, :c] for b, c in enumerate(counts.tolist())]
        del ci
        for name, (a, b, share) in {
                "B9 leg vs member-sort leg": (outs["compact_kernel"],
                                              outs["member_sort"], 0.0),
                "B9 leg vs expand-sort leg": (outs["compact_kernel"],
                                              outs["expand_sort"],
                                              golden.TRACE_FLIP_SHARE),
                "expand-sort leg vs dense two-level cull": (
                    outs["expand_sort"], dense, golden.TRACE_FLIP_SHARE),
        }.items():
            rep, ok = golden.lists_agree(a, b, share)
            print(f"3DGRT cull legs at {cfg['name']}, {name}: "
                  f"{json.dumps(rep)}", flush=True)
            if not ok or (name.startswith("B9") and rep["flipped"]):
                fail(f"{name} at {cfg['name']}: the lists disagree")
        times = {}
        for leg, fn in (
                ("dense_twolevel", lambda: grt.bundle_candidates_twolevel(
                    *args, super_capacity=cfg["super_cap"])),
                *((f"flat_{leg}", lambda lkw=lkw:
                   grt.bundle_candidates_twolevel_flat(*args, **kw, **lkw))
                  for leg, lkw in legs.items())):
            runs = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    fn()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            times[leg] = float(np.median(runs[1:]))
        leg_ms[cfg["name"]] = times
        print(f"3DGRT cull legs at {cfg['name']} (ms, median of 3): "
              f"{json.dumps(times)} {tag}", flush=True)
        del acts, o, d, cull_in, args, outs, dense
    return launches, captured["args"], leg_ms


def b9_record(args, launches, leg_ms, tag, ptxas):
    """B9 against its plain version on the card at the 1M flat cull's
    inputs `args`: both outputs bit-equal, two launches bit-identical.
    Bound from this run's counts: bytes of the gid and mask of every slot
    of the segments, 4 B of depth per hit and 8 B per output slot
    written."""
    from threedgrut_torch.ops import stream_compact
    gid, bits, depth, seg_ws, seg_we = args[:5]
    k = stream_compact.compact_streams(*args)
    same = all(torch.equal(a, b) for a, b in
               zip(k, stream_compact.compact_streams(*args)))
    p = stream_compact.compact_streams_plain(*args)
    equal = all(torch.equal(a, b) for a, b in zip(k, p))
    slots = int((seg_we - seg_ws).sum()) * 128
    hits = sum(int(((bits >> s) & 1).sum()) for s in range(16))
    written = int((k[1] < stream_compact.FILL_DEPTH).sum())
    err = float((k[1] - p[1]).abs().max().nan_to_num(0.0))
    print(f"B9 at 1M: {seg_ws.shape[0]} segments, {slots} super slots, "
          f"{hits} hits, {written} written of {k[0].shape[0]}; kernel == "
          f"plain {equal}; bit-identical {same}", flush=True)
    if not (equal and same and written > 0):
        fail("B9 disagrees with its plain version")
    b = bound_ms(8 * slots + 4 * hits + 8 * written, 0)
    rec = dict(
        name="compact_streams", route="cuda",
        source="threedgrut_torch/csrc/stream_compact.cu",
        replaces="threedgrut_tpu/ops/pallas/stream_compact.py:212",
        launches=sum(v.get("compact_streams", 0) for v in launches.values()),
        launches_forward=0, launches_grt_cull=launches, max_abs_err=err,
        ms=cuda_ms(lambda: stream_compact.compact_streams(*args), 10),
        plain_ms=cuda_ms(lambda: stream_compact.compact_streams_plain(*args),
                         1, warmup=0),
        bound_ms=b[0], bound_by=b[1], library_ms=None, segments=int(
            seg_ws.shape[0]), super_slots=slots, hits=hits, written=written,
        cull_leg_ms=leg_ms,
        ptxas=entry_occupancy(ptxas, stream_compact.blocks_per_sm()))
    print(f"B9 at 1M: {rec['ms']:.4f} ms (bound {rec['bound_ms']:.4f}, "
          f"plain {rec['plain_ms']:.3f} ms); ptxas {rec['ptxas']} {tag}",
          flush=True)
    return rec


def grt_record(data, inp, launches, train_launches, ptxas, tag):
    """B7 against its plain version on the card at the 100k main shapes
    (candidate rows `data`, the rest from grt.prepare's `inp`), with 16, 1
    and 0 passes: rows 0-5 within 2e-4 + 1e-4 |plain|, hit counts off by
    at most 1 on at most 0.1% of the rays, walked windows equal on all but
    0.1% of the bundles; with passes, the launch that writes the
    compositing orders (a train step's forward) bit-identical to the one
    that writes none. Timed as a trace runs it (no orders), and with the
    orders as the differentiable forward runs it (`ms_with_order`);
    `network_ms` is the 16-pass minus the 1-pass time. Returns (record,
    {passes: (work, kernel output, orders)}) for B8's record."""
    from threedgrut_torch.constants import (MAX_ALPHA, MIN_ALPHA,
                                            MIN_KERNEL_RESPONSE,
                                            MIN_TRANSMITTANCE_3DGRT)
    from threedgrut_torch.ops import bundle_trace
    err, timing = 0.0, {}
    for passes in (16, 1, 0):
        args = (data, inp.rays, inp.win_starts, inp.win_ends, 4, 3,
                MIN_TRANSMITTANCE_3DGRT, MIN_KERNEL_RESPONSE, MIN_ALPHA,
                MAX_ALPHA, passes)
        k = bundle_trace._launch(*args)
        order = bundle_trace.order_buffer(data) if passes else None
        same = order is None or torch.equal(
            k, bundle_trace._launch(*args, order=order))
        stats = {}
        p = bundle_trace.bundle_composite_plain(*args, stats=stats)
        d = (k - p).abs()
        within = bool((d[:, 0:6] <= 2e-4 + 1e-4 * p[:, 0:6].abs()).all())
        dh = d[:, 6]
        hits_ok = float(dh.max()) <= 1 and int((dh > 0).sum()) <= max(
            1, math.floor(1e-3 * dh.numel()))
        walk_diff = int((d[:, 7, 0] > 0).sum())
        print(f"B7 passes={passes}: per-row max |kernel - plain| "
              f"{d.amax(dim=(0, 2)).tolist()}; rays whose hit count differs "
              f"{int((dh > 0).sum())}; bundles whose walk differs "
              f"{walk_diff}; with orders bit-identical {same}; work {stats}",
              flush=True)
        if not (within and hits_ok and same and walk_diff <= max(
                1, math.floor(1e-3 * k.shape[0]))):
            fail(f"B7 (passes={passes}) outside its tolerances")
        err = max(err, float(d[:, 0:6].max()))
        timing[passes] = dict(
            ms=cuda_ms(lambda: bundle_trace._launch(*args), 10),
            ms_order=cuda_ms(lambda: bundle_trace._launch(
                *args, order=order), 10) if passes else None,
            plain=cuda_ms(lambda: bundle_trace.bundle_composite_plain(
                *args), 1, warmup=0) if passes != 1 else None,
            stats=stats, out=k, order=order)

    def b7_bound(passes):
        """bound_ms of the run with `passes` from its own output and work:
        bytes of its walked windows, rays and output; operations of its
        live ray-windows, counted pairs and (passes > 0) the passes its
        network runs on them."""
        t = timing[passes]
        k, stats = t["out"], t["stats"]
        nb = k.shape[0]
        return bound_ms(
            int(k[:, 7, 0].sum()) * 128 * 64 * 4 + nb * 8 * 256 * 4 * 2
            + nb * 8,
            FLOP_GRT_PAIR * 128 * stats["live_ray_windows"]
            + FLOP_GRT_COUNTED * float(k[:, 6].sum())
            + FLOP_SWAP * 64 * stats.get("network_passes", 0))

    t16, k16 = timing[16], timing[16]["out"]
    bound, bound0 = b7_bound(16), b7_bound(0)
    print(f"B7 at 100k: {k16.shape[0]} bundles, {int(k16[:, 7, 0].sum())} "
          f"windows walked of {int((inp.win_ends - inp.win_starts).sum())}, "
          f"{float(k16[:, 6].sum()):.0f} counted pairs; 16 passes "
          f"{t16['ms']:.4f} ms (with orders {t16['ms_order']:.4f}; bound "
          f"{bound[0]:.4f}), 1 pass {timing[1]['ms']:.4f} ms, 0 passes "
          f"{timing[0]['ms']:.4f} ms (bound {bound0[0]:.4f}) (plain "
          f"{t16['plain']:.2f} / {timing[0]['plain']:.2f} ms); ptxas sorted "
          f"{leg_ptxas(ptxas, 'bundle_trace_fwd', True)}, 0 passes "
          f"{leg_ptxas(ptxas, 'bundle_trace_fwd', False)} {tag}", flush=True)
    return dict(
        name="bundle_trace_fwd", route="cuda",
        source="threedgrut_torch/csrc/bundle_trace_fwd.cu",
        replaces="threedgrut_tpu/ops/pallas/bundle_trace.py:448",
        launches=sum(v.get("bundle_trace_fwd", 0) for v in launches.values()),
        launches_forward=0,
        launches_grt={n: v.get("bundle_trace_fwd", 0)
                      for n, v in launches.items()},
        launches_grt_train={n: v.get("bundle_trace_fwd", 0)
                            for n, v in train_launches.items()},
        max_abs_err=err, ms=t16["ms"], plain_ms=t16["plain"],
        ms_with_order=t16["ms_order"], ms_passes1=timing[1]["ms"],
        network_ms=t16["ms"] - timing[1]["ms"], ms_passes0=timing[0]["ms"],
        bound_ms_passes0=bound0[0], bound_ms=bound[0], bound_by=bound[1],
        library_ms=None, network=t16["stats"],
        ptxas={"sorted": leg_ptxas(ptxas, "bundle_trace_fwd", True),
               "passes0": leg_ptxas(ptxas, "bundle_trace_fwd", False)},
        dynamic_smem_bytes=bundle_trace.dynamic_smem(16)), timing


def grt_acts(params):
    """The five post-activation tensors of `params` (grt.trace's inputs),
    detached."""
    return [x.detach() for x in (
        params.get_positions(), params.get_rotation(), params.get_scale(),
        params.get_density(), params.get_features())]


def order_gib(flat_cap: int) -> float:
    """GiB of the compositing orders a differentiable 16-pass forward's B7
    writes for its B8 (bundle_trace.order_buffer: 32 KB per window)."""
    return flat_cap // 128 * 32 * 1024 / 2 ** 30


def grt_walk_capacity(flat_cap: int) -> int:
    return -(-int(flat_cap * GRT_WALK_FRACTION) // 256) * 256


def grt_fwd_bwd(acts, o, d, kw, walk_capacity, wrt):
    """tools/bench_grt.py's fwd+bwd: grt.trace of the rays, loss mean(rgb) +
    mean(opacity), the gradients of acts[i] for i in `wrt` (bench_grt's:
    positions 0 and opacities 3). Returns (trace, loss, grads)."""
    from threedgrut_torch.render import grt
    xs = [a.detach().requires_grad_(i in wrt) for i, a in enumerate(acts)]
    out = grt.trace(*xs, o, d, walk_capacity=walk_capacity, **kw)
    loss = out.rgb.mean() + out.opacity.mean()
    return out, loss, torch.autograd.grad(loss, [xs[i] for i in wrt])


def nonzero_share(grads) -> float:
    """The share of particles with a nonzero gradient in any tensor."""
    hit = None
    for g in grads:
        h = (g.reshape(g.shape[0], -1) != 0).any(1)
        hit = h if hit is None else hit | h
    return float(hit.float().mean())


def grt_train_parity(dev, tag):
    """3DGRT training, card vs CPU from the same parameters. (1) bench_grt's
    fwd+bwd on its 100k scene over the central 128x128 rays of its grid (64
    bundles, the two-level cull), gradients of all five tensors, on the
    compact branch (its walk capacity) and the dense one (two windows): the
    trace within golden.compare at TRACE_FLIP_SHARE, the loss rtol 1e-4,
    each tensor's gradient rows within golden.rows_agree's 1e-4 x max on
    all but GRT_GRAD_LOOSE_SHARE of the particles with a nonzero gradient;
    the card run twice, its gradients bit-identical, and equal on the two
    branches (the same nonzero rows summed in the same order). (2) One
    preset_3dgrt Trainer.train_step on the golden scene at 128x128 (the
    eval parity's scale) within step_agreement."""
    from threedgrut_torch import golden
    from threedgrut_torch.config import preset_3dgrt
    from threedgrut_torch.ops import cuda_build, fused_raster
    cfg = GRT_CONFIGS[0]
    kw = grt_trace_kw(cfg)
    want_launches = {k: 1 for k in cuda_build.kernels_of("grt")}
    names = ("positions", "rotation", "scale", "opacity", "features")
    card = {}
    for branch, walk in (("compact", grt_walk_capacity(cfg["flat_cap"])),
                         ("dense", 256)):
        runs = []
        for device in (dev, dev, "cpu"):
            params, o, d = grt_bench_scene(cfg["n"], cfg["scales"], device,
                                           crop=GRT_PARITY_SIDE)
            cuda_build.launches.clear()
            fused_raster.branches.clear()
            out, loss, grads = grt_fwd_bwd(grt_acts(params), o, d, kw, walk,
                                           range(5))
            if bool(out.overflow):
                fail(f"3DGRT fwd+bwd parity on {device} overflowed")
            runs.append((out, float(loss.detach()), [g.cpu() for g in grads],
                         dict(cuda_build.launches),
                         dict(fused_raster.branches)))
        (og, lg, gg, kg, bg), (_, _, g2, _, _), (oc, lc, gc, _, bc) = runs
        if kg != want_launches or bg != {f"3dgrt.{branch}": 1} or bc != bg:
            fail(f"3DGRT fwd+bwd parity ({branch}): launches {kg}, branches "
                 f"{bg} on the card, {bc} on the CPU")
        if not all(torch.equal(a, b) for a, b in zip(gg, g2)):
            fail(f"3DGRT fwd+bwd ({branch}): two card runs differ")
        card[branch] = gg
        rep, ok = golden.compare(og, oc, golden.TRACE_FLIP_SHARE)
        rep = {"trace": rep, "loss": (lg, lc)}
        ok &= abs(lg - lc) <= 1e-4 * abs(lc)
        for name, a, b in zip(names, gg, gc):
            r, _ = golden.rows_agree(a, b, 1e-4)
            nz = int((b.reshape(b.shape[0], -1) != 0).any(1).sum())
            r.update(nonzero_rows=nz, loose_share=r["loose_rows"] / max(nz, 1))
            rep[name] = r
            ok &= r["loose_share"] <= GRT_GRAD_LOOSE_SHARE
        print(f"3DGRT fwd+bwd card vs CPU ({branch} branch, walk_capacity "
              f"{walk}), bench_grt 100k, {GRT_PARITY_SIDE}^2 rays, allowed "
              f"loose share {GRT_GRAD_LOOSE_SHARE}: {json.dumps(rep)}; card "
              f"runs bit-identical {tag}", flush=True)
        if not ok:
            fail(f"the 3DGRT fwd+bwd on the card disagrees with the plain "
                 f"path ({branch} branch)")
    # The branches sum the same nonzero rows in the same order.
    if not all(torch.equal(a, b) for a, b in zip(*card.values())):
        fail("the compact and dense branches' gradients differ on the card")

    cfg3 = preset_3dgrt()
    cfg3.model.progressive_sh_interval = 0
    gt = np.random.default_rng(1).uniform(0, 1, (128, 128, 3)).astype(
        np.float32)
    runs = {}
    for device in (dev, "cpu"):
        tr, view = train_setup(golden.scene(), (128, 128), 1 << 20, gt,
                               device, cfg=cfg3)
        cuda_build.launches.clear()
        aux = tr.train_step(view)
        runs[device] = (tr, aux, dict(cuda_build.launches))
    (tg, ag, lg), (tc, ac, _) = runs[dev], runs["cpu"]
    if lg != want_launches:
        fail(f"the preset_3dgrt train step launched {lg}")
    rep, ok = step_agreement(tg, ag, tc, ac)
    print(f"Trainer.train_step (preset_3dgrt) card vs CPU, golden scene "
          f"128x128: {json.dumps(rep)} {tag}", flush=True)
    if not ok or any(bool(a["overflow"]) for a in (ag, ac)):
        fail("the 3DGRT train step on the card disagrees with the plain path")


def grt_fwd_bwd_main_path(dev, tag, flat=False):
    """tools/bench_grt.py's fwd+bwd mode as that file runs it without env
    knobs (`flat`: with BENCH_PACKED=flat, the flat cull): its seeded scene
    and capacities, 512x512 rays, 16 passes, loss mean(rgb) +
    mean(opacity), gradients to positions and opacities (and its 1e-20
    carried update), walk_capacity GRT_WALK_FRACTION of flat_capacity; 6
    steps at 100k (median of steps 2-5), then its 1M capacities, 3 steps
    (median of steps 2-3). Returns ({name: launches}, the 100k walk
    capacity)."""
    from threedgrut_torch.ops import cuda_build, fused_raster
    launches, want = {}, cuda_build.kernels_of("grt")
    mode = "flat cull" if flat else "dense cull"
    for cfg in GRT_CONFIGS:
        base = phase_start()
        params, o, d = grt_bench_scene(cfg["n"], cfg["scales"], dev)
        acts = grt_acts(params)
        del params
        kw = grt_trace_kw(cfg, flat)
        walk = grt_walk_capacity(cfg["flat_cap"])
        cuda_build.launches.clear()
        ms = []
        for k in range(cfg["traces"]):
            fused_raster.branches.clear()
            before = dict(cuda_build.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, loss, (gp, ga) = grt_fwd_bwd(acts, o, d, kw, walk, (0, 3))
            with torch.no_grad():
                acts[0] = acts[0] + 1e-20 * gp[0, 0]
                acts[3] = acts[3] + 1e-20 * ga[0]
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            step = {n: v - before.get(n, 0)
                    for n, v in cuda_build.launches.items()
                    if v != before.get(n, 0)}
            if bool(out.overflow):
                fail(f"3DGRT fwd+bwd {cfg['name']} ({mode}) step {k + 1} "
                     f"overflowed")
            if not (math.isfinite(float(loss.detach()))
                    and bool(torch.isfinite(gp).all())
                    and bool(torch.isfinite(ga).all())):
                fail(f"3DGRT fwd+bwd {cfg['name']} ({mode}) step {k + 1}: a "
                     f"value is not finite")
            if step != {n: 1 for n in want}:
                fail(f"3DGRT fwd+bwd {cfg['name']} ({mode}) step {k + 1} "
                     f"launched {step}")
            print(f"3DGRT fwd+bwd {cfg['name']} ({mode}) step {k + 1}: "
                  f"{ms[-1]:.3f} "
                  f"ms, loss {float(loss.detach()):.6f}, overflow False, "
                  f"launches {step}, branch {dict(fused_raster.branches)}, "
                  f"particles with a nonzero gradient "
                  f"{nonzero_share([gp, ga]):.4f} "
                  f"{tag}", flush=True)
        launches[cfg["name"]] = dict(cuda_build.launches)
        peak = phase_peak_gib(base)
        steady = ms[1:5] if len(ms) >= 5 else ms[1:]
        med = float(np.median(steady))
        n_rays = o.shape[0]
        orders = order_gib(cfg["flat_cap"])
        print(f"3DGRT fwd+bwd {cfg['name']} ({mode}): median of steps 2-"
              f"{len(steady) + 1} {med:.3f} ms, rays/s "
              f"{n_rays / (med / 1e3):.4e}, walk_capacity {walk}, "
              f"max_memory_allocated {peak:.3f} GiB (of it B7's orders "
              f"{orders:.3f} GiB) {tag}", flush=True)
        print(json.dumps({
            "metric": "grt_trace_rays_per_s_fwd_bwd",
            "value": n_rays / (med / 1e3), "unit": "rays/s/chip",
            "backend": "cuda", "device": torch.cuda.get_device_name(0),
            "n_gaussians": cfg["n"], "n_rays": n_rays,
            "candidate_capacity": cfg["cand"],
            "flat_capacity": cfg["flat_cap"], "walk_capacity": walk,
            "super_flat_capacity": cfg["sflat_cap"] if flat else None,
            "packed_cull": False, "flat_cull": flat,
            "candidate_overflow": False,
            "step_ms": med, "max_memory_allocated_gib": peak,
            "order_buffer_gib": orders}), flush=True)
        del acts, o, d, out, gp, ga
    return launches, grt_walk_capacity(GRT_CONFIGS[0]["flat_cap"])


def grt_train_view(dev, side=GRT_SIDE):
    """The 3DGRT trainer's view of bench_grt's scene: a side x side pinhole
    camera (focal 640 px, centred principal point) at (0, 0, -4) looking at
    the origin, zero ground truth."""
    from threedgrut_torch.cameras import PinholeCamera, look_at
    from threedgrut_torch.datasets.protocols import View

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    cam = PinholeCamera(focal=t([640.0, 640.0]),
                        principal=t([side / 2, side / 2]),
                        radial=t([0.0] * 6), tangential=t([0.0] * 2),
                        thin_prism=t([0.0] * 4))
    T = look_at(np.array([0.0, 0.0, -4.0], np.float32),
                np.zeros(3, np.float32), np.array([0.0, -1.0, 0.0],
                                                  np.float32))
    return View(T_to_world=T, camera=cam, resolution=(side, side),
                rgb_gt=np.zeros((side, side, 3), np.float32))


def grt_train_main_path(dev, tag):
    """GRT_TRAIN_STEPS Trainer.train_step calls with preset_3dgrt on
    bench_grt's 100k scene: a 512x512 pinhole camera (focal 640 px, centred
    principal point) at (0, 0, -4) looking at the origin, zero ground
    truth, isect_capacity GRT_TRAIN_ISECT; the last step with
    walk_compact_fraction 0 (gather_rows' backward). Fails unless every
    value is finite, no step from the second on overflows, and every step
    launched B7, B8 and B6 once and nothing else. Returns the launches."""
    from threedgrut_torch.config import preset_3dgrt
    from threedgrut_torch.ops import cuda_build, fused_raster
    from threedgrut_torch.trainer import Trainer, grt_super_lists
    cfg = GRT_CONFIGS[0]
    cfg3 = preset_3dgrt()
    cfg3.render.isect_capacity = GRT_TRAIN_ISECT
    cfg3.model.progressive_sh_interval = 0
    base = phase_start()
    params, _, _ = grt_bench_scene(cfg["n"], cfg["scales"], dev)
    side = GRT_SIDE
    view = grt_train_view(dev)
    tr = Trainer(cfg3, OneView(view, 4.0), params=params, device=dev)
    want = {n: 1 for n in cuda_build.kernels_of("grt")}
    cuda_build.launches.clear()
    ms, flags = [], []
    for k in range(GRT_TRAIN_STEPS):
        last = k == GRT_TRAIN_STEPS - 1
        if last:
            tr.cfg.render.walk_compact_fraction = 0.0
        cap = tr.isect_capacity
        fused_raster.branches.clear()
        before = dict(cuda_build.launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        aux = tr.train_step(view)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        peak = phase_peak_gib(base)
        step = {n: v - before.get(n, 0)
                for n, v in cuda_build.launches.items()
                if v != before.get(n, 0)}
        flags.append(bool(aux["overflow"]))
        branch = dict(fused_raster.branches)
        finite = all(bool(torch.isfinite(x).all()) for x in
                     [aux["pred"], *aux["grads"].values(),
                      *(getattr(tr.params, f) for f in aux["grads"])])
        print(f"3DGRT train step {k + 1}: {ms[-1]:.3f} ms, rays/s "
              f"{side * side / (ms[-1] / 1e3):.4e}, max_memory_allocated "
              f"{peak:.3f} GiB (of it B7's orders {order_gib(cap):.3f} "
              f"GiB), loss {float(aux['terms']['total']):.6f}, "
              f"overflow {flags[-1]}, isect_capacity {cap} (super lists "
              f"{grt_super_lists(cap)['super_capacity']}), launches {step}, "
              f"branch {branch or 'gather_rows'}, particles with a nonzero "
              f"gradient {nonzero_share(aux['grads'].values()):.4f} {tag}",
              flush=True)
        if not (finite and math.isfinite(float(aux["terms"]["total"]))):
            fail(f"3DGRT train step {k + 1}: a value is not finite")
        if step != want:
            fail(f"3DGRT train step {k + 1} launched {step}")
        if branch != ({} if last else {"3dgrt.compact": 1}):
            fail(f"3DGRT train step {k + 1} took the backward {branch}")
    tr.cfg.render.walk_compact_fraction = 0.625
    if any(flags[1:]):
        fail(f"3DGRT train steps overflowed after the first: {flags}")
    med = float(np.median(ms[1:5]))
    print(f"3DGRT train step (preset_3dgrt, bench_grt 100k, {side}x{side}) "
          f"median of steps 2-5 {med:.3f} ms, rays/s "
          f"{side * side / (med / 1e3):.4e} {tag}", flush=True)
    return dict(cuda_build.launches)


def b8_record(data, inp, b7_runs, launches, walk, ptxas, tag):
    """B8 against its plain version on the card at the 100k main shapes
    (16, 1 and 0 passes), on B7's output and the cotangent of bench_grt's
    loss mean(rgb) + mean(opacity): the nonzero slot rows equal, each value
    within 1e-4 x its column's max |plain| (the same per-ray chains summed
    over a bundle's rays in another order); with passes, B8 on the orders
    B7 wrote (as a train step runs it, and as it is timed) bit-identical
    to B8 whose wrapper runs B7 for them; `network_ms` is the 16-pass
    minus the 1-pass time (B8 runs no network: its walk differs only by
    the order). Then B6 at 64 channels on the compact branch's rows of the
    16-pass gradients. Returns the two records."""
    from threedgrut_torch.constants import (MAX_ALPHA, MIN_ALPHA,
                                            MIN_KERNEL_RESPONSE,
                                            MIN_TRANSMITTANCE_3DGRT)
    from threedgrut_torch.ops import (bundle_trace, fused_raster, segment_sum,
                                      sorted_gather)
    err, timing = 0.0, {}
    for passes in (16, 1, 0):
        run = b7_runs[passes]
        out, order = run["out"], run["order"]
        r_total = out.shape[0] * 256
        g_out = torch.zeros_like(out)
        g_out[:, 0:3] = 1.0 / (3 * r_total)
        g_out[:, 3] = 1.0 / r_total
        args = (data, inp.rays, inp.win_starts, inp.win_ends, out, g_out, 4,
                3, MIN_TRANSMITTANCE_3DGRT, MIN_KERNEL_RESPONSE, MIN_ALPHA,
                MAX_ALPHA, passes)
        k = bundle_trace._launch_backward(*args, order=order)
        same = torch.equal(k, bundle_trace._launch_backward(*args))
        p = bundle_trace.bundle_composite_backward_plain(*args)
        nz_k, nz_p = (k != 0).any(1), (p != 0).any(1)
        d = (k - p).abs()
        col = p.abs().amax(0)
        within = bool((d <= 1e-4 * col + 1e-30).all())
        print(f"B8 passes={passes}: max |kernel - plain| {float(d.max()):.3e}"
              f", worst |kernel - plain| / column max "
              f"{float((d / col.clamp(min=1e-30)).max()):.3e}; nonzero slots "
              f"{int(nz_k.sum())} kernel, {int(nz_p.sum())} plain; rows 13-15 "
              f"zero {not bool(k[:, 13:16].any())}; bit-identical {same}",
              flush=True)
        if not (within and same and torch.equal(nz_k, nz_p)
                and not bool(k[:, 13:16].any())):
            fail(f"B8 (passes={passes}) disagrees with its plain version")
        err = max(err, float(d.max()))
        timing[passes] = dict(
            ms=cuda_ms(lambda: bundle_trace._launch_backward(
                *args, order=order), 10),
            plain=cuda_ms(lambda: bundle_trace.bundle_composite_backward_plain(
                *args), 1, warmup=0) if passes != 1 else None,
            stats=run["stats"], out=out, grad=k)

    def b8_bound(passes):
        """bound_ms from the run's own work: its walked windows read, the
        [capF, 64] output written, rays, output and cotangent read, with
        passes the orders of its live ray-windows (128 bytes each); the
        pair math where its walk evaluates a pair (every live pair without
        passes, the live hits on the orders), the chain and reduction of
        its counted pairs. No network: B8 runs none."""
        t = timing[passes]
        out, k, stats = t["out"], t["grad"], t["stats"]
        nb = out.shape[0]
        pairs = stats["live_hits"] if passes else stats["live_pairs"]
        return bound_ms(
            int(out[:, 7, 0].sum()) * 128 * 64 * 4 + k.numel() * 4
            + nb * 8 * 256 * 4 * 3 + nb * 8
            + (128 * stats["live_ray_windows"] if passes else 0),
            FLOP_GRT_PAIR * pairs
            + (FLOP_GRT_BWD_CHAIN + FLOP_GRT_BWD_REDUCE)
            * float(out[:, 6].sum()))

    t16, out16, k16 = timing[16], timing[16]["out"], timing[16]["grad"]
    bound, bound0 = b8_bound(16), b8_bound(0)
    blocks = bundle_trace.backward_slots(out16.shape[0], 16)
    print(f"B8 at 100k: {out16.shape[0]} bundles, "
          f"{int(out16[:, 7, 0].sum())} windows walked, "
          f"{float(out16[:, 6].sum()):.0f} counted pairs; 16 passes "
          f"{t16['ms']:.4f} ms (bound {bound[0]:.4f}, {bound[1]}), 1 pass "
          f"{timing[1]['ms']:.4f} ms, 0 passes {timing[0]['ms']:.4f} ms "
          f"(bound {bound0[0]:.4f}) (plain {t16['plain']:.2f} / "
          f"{timing[0]['plain']:.2f} ms); {blocks} blocks; ptxas sorted "
          f"{leg_ptxas(ptxas, 'bundle_trace_bwd', True)}, 0 passes "
          f"{leg_ptxas(ptxas, 'bundle_trace_bwd', False)} {tag}", flush=True)
    total = lambda name: sum(v.get(name, 0) for v in launches.values())
    rec8 = dict(
        name="bundle_trace_bwd", route="cuda",
        source="threedgrut_torch/csrc/bundle_trace_bwd.cu",
        replaces="threedgrut_tpu/ops/pallas/bundle_trace.py:504",
        launches=total("bundle_trace_bwd"), launches_forward=0,
        launches_grt_train={n: v.get("bundle_trace_bwd", 0)
                            for n, v in launches.items()},
        max_abs_err=err, ms=t16["ms"], plain_ms=t16["plain"],
        ms_passes1=timing[1]["ms"], network_ms=t16["ms"] - timing[1]["ms"],
        ms_passes0=timing[0]["ms"], bound_ms_passes0=bound0[0],
        bound_ms=bound[0], bound_by=bound[1], library_ms=None,
        ptxas={"sorted": leg_ptxas(ptxas, "bundle_trace_bwd", True),
               "passes0": leg_ptxas(ptxas, "bundle_trace_bwd", False)},
        blocks=blocks)

    # B6 at 64 channels: the compact branch's rows, sorted by particle.
    n = inp.rows64.shape[0]
    walked = fused_raster.compact_walked_bundles(
        out16, inp.win_starts, inp.flat_idx, inp.valid, k16, walk, n)
    if walked is None:
        fail("the walked windows do not fit walk_capacity at 100k")
    with torch.no_grad():
        sid, rows = sorted_gather.sort_rows(*walked)
        lengths = torch.bincount(sid.long(), minlength=n + 1)[:n]
        kept = int((sid < n).sum())
        acc = torch.zeros((n + 1, 64), device=rows.device)
        ids_l = torch.clamp(sid, max=n).long()
    rec6 = sums_record(
        "segment_sum_rows_by_ids[64]",
        lambda g, i: segment_sum.segment_sum_rows_by_ids(g, i, n),
        lambda g, i: segment_sum.segment_sum_rows_by_ids_plain(g, i, n),
        (rows, sid), lengths, kept, kept * 256 + rows.shape[0] * 4 + n * 256,
        lambda: acc.index_add_(0, ids_l, rows),
        total("segment_sum_rows_by_ids"), tag,
        sums_occupancy(ptxas, "B6"))
    rec6["launches_grt_train"] = {n_: v.get("segment_sum_rows_by_ids", 0)
                                  for n_, v in launches.items()}
    return rec8, rec6


# ---- phase 5b: inference and export --------------------------------------

# (a) tools/bench_infer_orbit.py's orbit: 32 frames at 0.5 degrees a frame
# around (0, 0, 0) at radius 4 and height 1, a refresh every 8 frames, the
# frozen frames at 16 re-sort passes; its probe's 1.2x headroom on the
# visible count (in 4096s) and on the compacted scene's intersections (in
# 256s), both at frame 0.
ORBIT_FRAMES = 32
ORBIT_DEG = 0.5
ORBIT_REFRESH = 8
ORBIT_PASSES = 16
ORBIT_THRESHOLDS = (0.0, 1.0 / 255.0)
# (b) bench.py's BENCH_INFER=compact defaults: n_compact, compact capacity,
# census threshold and timed frames (after one warm frame).
BENCH_NC = 143_360
BENCH_CAPC = 585_472
BENCH_VIS_T = 1.0 / 255.0
BENCH_ITERS = 10
# (c) card vs CPU: the refresh's compacted id sets may differ by census
# flips (a weight at the threshold on one side only, golden.compare's
# class) on at most this share of the visible count (at least one).
INFER_FLIP_SHARE = 1e-3
# (c) the frozen frame's camera: frame 4 of the orbit (2 degrees from the
# refresh camera), so that the binning it reuses is stale.
INFER_STALE_FRAME = 4


def orbit_deg_T(i: int) -> np.ndarray:
    """Camera-to-world of frame i of bench_infer_orbit's orbit."""
    from threedgrut_torch.cameras import look_at
    a = math.radians(ORBIT_DEG) * i
    eye = np.array([4.0 * math.sin(a), -4.0 * math.cos(a), 1.0], np.float32)
    return look_at(eye, np.zeros(3, np.float32),
                   np.array([0.0, 0.0, 1.0], np.float32))


def pose_of(T, dev):
    from threedgrut_torch.cameras import pose_from_matrix
    return pose_from_matrix(torch.as_tensor(T, device=dev))


def frame_of(out) -> dict:
    """A frame's fields for golden.compare with an empty visibility mask:
    for frames over different particle sets, or a frozen frame (which
    runs no census)."""
    d = {k: getattr(out, k) for k in ("rgb", "opacity", "depth",
                                      "transmittance", "hit_count")}
    d["visibility"] = np.zeros(0, bool)
    return d


def psnr_of(a, b) -> torch.Tensor:
    """PSNR of frame a against frame b, both clipped to [0, 1] (bench.py's
    and bench_infer_orbit's), as a tensor: no wait for the device."""
    mse = ((a.clamp(0.0, 1.0) - b.clamp(0.0, 1.0)) ** 2).mean()
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def compact_sizes(acts, cam, pose, cap, threshold, dev):
    """bench_infer_orbit's probe at one camera: the visible count,
    n_compact = ceil(1.2 x visible / 4096) x 4096 and the compact capacity
    = ceil(1.2 x the compacted scene's intersections / 256) x 256."""
    from threedgrut_torch.render import gut, infer
    n = acts[0].shape[0]
    out, _ = gut.render(*acts, cam, pose, MAIN_RES, cap, hit_visibility=True,
                        aux_gradients=False, visibility_threshold=threshold,
                        device=dev)
    nvis = int(out.visibility.sum())
    n_c = min(n, -(-int(nvis * 1.2) // 4096) * 4096)
    _, _, scene = infer.refresh(*acts, cam, pose, MAIN_RES, cap, n_c,
                                visibility_threshold=threshold, device=dev)
    _, binning, _, _ = gut.prepare_packed(*scene[:5], cam, pose, MAIN_RES,
                                          cap, sh_degree=0)
    nisect = int(binning.num_intersections)
    return dict(visible=nvis, n_compact=n_c, isect_compact=nisect,
                cap_compact=-(-int(nisect * 1.2) // 256) * 256,
                scene_overflow=bool(scene.overflow))


def orbit_mode(mode, params, cam, cap, sizes, threshold, exact, dev):
    """One pass of the orbit in `mode` ("exact", "compact", "frozen"), each
    frame timed by the host clock between two synchronizes. Refresh frames
    (every ORBIT_REFRESH-th) run infer.refresh (and, frozen,
    capture_binning); the frames between render_compact or render_frozen.
    Returns the frames' rgb, ms, overflow flags, PSNR against `exact` and
    the launch counts: "default" for every frame but the frozen ones
    between refreshes, "sorted16" for those (B1's sorted leg)."""
    from threedgrut_torch import api, golden
    from threedgrut_torch.ops import cuda_build
    from threedgrut_torch.render import infer
    acts = (params.get_positions(), params.get_rotation(), params.get_scale(),
            params.get_density(), params.get_features())
    rgbs, ms, flags, psnr, gate = [], [], [], [], []
    counts = {"default": {}, "sorted16": {}}
    scene = frozen = None
    for i in range(ORBIT_FRAMES):
        T = orbit_deg_T(i)
        pose = pose_of(T, dev)
        refresh = i % ORBIT_REFRESH == 0
        kind = "sorted16" if mode == "frozen" and not refresh else "default"
        cuda_build.launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "exact":
            out, cap = render_retry(api, params, cam, T, MAIN_RES, cap, dev,
                                    aux_gradients=False, aux_outputs=False)
            f = {}
        elif refresh:
            out, ovf, scene = infer.refresh(
                *acts, cam, pose, MAIN_RES, cap, sizes["n_compact"],
                visibility_threshold=threshold, device=dev)
            f = {"isect": ovf, "scene": scene.overflow}
            if mode == "frozen":
                frozen = infer.capture_binning(scene, cam, pose, MAIN_RES,
                                               sizes["cap_compact"],
                                               device=dev)
                f["frozen_binning"] = frozen.overflow
        elif mode == "compact":
            out, ovf = infer.render_compact(scene, cam, pose, MAIN_RES,
                                            sizes["cap_compact"], device=dev)
            f = {"isect": ovf}
        else:
            out = infer.render_frozen(scene, frozen, cam, pose, MAIN_RES,
                                      sorted_passes=ORBIT_PASSES, device=dev)
            f = {}
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in cuda_build.launches.items():
            counts[kind][k] = counts[kind].get(k, 0) + v
        rgbs.append(out.rgb)
        flags.append(f)
        if exact is not None:
            psnr.append(psnr_of(out.rgb, exact[i]))
        if mode == "compact" and refresh and threshold == 0.0:
            # The gate: at the refresh camera, the compacted scene's frame
            # equals the exact one (refresh's own output, aux included).
            comp, covf = infer.render_compact(scene, cam, pose, MAIN_RES,
                                              sizes["cap_compact"],
                                              aux_outputs=True, device=dev)
            rep, ok = golden.compare(frame_of(comp),
                                     frame_of(out))
            rep["rgb_vs_exact_frame"] = float((comp.rgb - exact[i]).abs()
                                              .max())
            gate.append((i, rep, ok and not bool(covf)
                         and not any(bool(x) for x in f.values())))
    flags = [{k: bool(v) for k, v in f.items()} for f in flags]
    return dict(rgb=rgbs, ms=ms, flags=flags, gate=gate, launches=counts,
                psnr=[float(p) for p in psnr], cap=cap)


def orbit(params, cam, cap, dev, tag):
    """Phase 5b (a): the orbit in exact mode, compact mode at each
    threshold of ORBIT_THRESHOLDS and frozen mode (threshold 0); fails
    unless every frame is finite, no refresh overflows, each mode launched
    B3, B4 and B1 (frozen: B1's sorted leg between refreshes) and the
    gate holds at every refresh camera."""
    from threedgrut_torch.ops import cuda_build
    acts = (params.get_positions(), params.get_rotation(), params.get_scale(),
            params.get_density(), params.get_features())
    pose0 = pose_of(orbit_deg_T(0), dev)
    sizes = {t: compact_sizes(acts, cam, pose0, cap, t, dev)
             for t in ORBIT_THRESHOLDS}
    for t, s in sizes.items():
        print(f"5b(a) probe at threshold {t:.6f}: visible {s['visible']} of "
              f"{MAIN_N} -> n_compact {s['n_compact']}; compact "
              f"intersections {s['isect_compact']} -> capacity "
              f"{s['cap_compact']} (full capacity {cap}); scene overflow "
              f"{s['scene_overflow']}", flush=True)
    ex = orbit_mode("exact", params, cam, cap, None, 0.0, None, dev)
    runs = {"exact": ex}
    for t in ORBIT_THRESHOLDS:
        runs[f"compact t={t:.6f}"] = orbit_mode(
            "compact", params, cam, ex["cap"], sizes[t], t, ex["rgb"], dev)
    runs["frozen t=0.000000"] = orbit_mode(
        "frozen", params, cam, ex["cap"], sizes[0.0], 0.0, ex["rgb"], dev)
    fwd = cuda_build.kernels_of("gut", ("forward",))
    recs = {}
    for name, r in runs.items():
        for i, rgb in enumerate(r["rgb"]):
            if not bool(torch.isfinite(rgb).all()):
                fail(f"5b(a) {name} frame {i}: rgb not finite")
        bad = [(i, f) for i, f in enumerate(r["flags"])
               if i % ORBIT_REFRESH == 0 and any(f.values())]
        if bad:
            fail(f"5b(a) {name}: a refresh overflowed: {bad}")
        missing = [k for k in fwd if r["launches"]["default"].get(k, 0) <= 0]
        if name.startswith("frozen") and r["launches"]["sorted16"].get(
                "tile_raster_fwd", 0) != ORBIT_FRAMES - ORBIT_FRAMES // \
                ORBIT_REFRESH:
            missing.append("tile_raster_fwd[sorted16] once a frozen frame")
        if missing:
            fail(f"5b(a) {name}: not launched: {missing} "
                 f"({r['launches']})")
        for i, rep, ok in r["gate"]:
            print(f"5b(a) gate, {name}, refresh camera {i}: compact frame "
                  f"vs exact {json.dumps(rep)}", flush=True)
            if not ok:
                fail(f"5b(a) {name}: the compact frame at refresh camera "
                     f"{i} is outside golden.compare of the exact frame")
        refresh_ms = [m for i, m in enumerate(r["ms"])
                      if i % ORBIT_REFRESH == 0]
        between_ms = [m for i, m in enumerate(r["ms"])
                      if i % ORBIT_REFRESH != 0]
        rec = dict(ms_per_frame_median=float(np.median(r["ms"])),
                   ms_per_frame_mean=float(np.mean(r["ms"])),
                   refresh_ms_median=float(np.median(refresh_ms)),
                   between_ms_median=float(np.median(between_ms)),
                   overflow_frames=[i for i, f in enumerate(r["flags"])
                                    if any(f.values())],
                   launches=r["launches"])
        if r["psnr"]:
            approx = [p for i, p in enumerate(r["psnr"])
                      if i % ORBIT_REFRESH != 0]
            rec.update(psnr_min=float(min(approx)),
                       psnr_mean=float(np.mean(approx)),
                       psnr_refresh_min=float(min(
                           p for i, p in enumerate(r["psnr"])
                           if i % ORBIT_REFRESH == 0)))
        recs[name] = rec
        print(f"5b(a) orbit {name}: {json.dumps(rec)} {tag}", flush=True)
    del runs
    return recs, sizes


def bench_compact(params, cam, cap, dev, tag):
    """Phase 5b (b): bench.py's BENCH_INFER=compact at its camera: one
    refresh at threshold 1/255 into BENCH_NC rows, then BENCH_ITERS
    compact frames at BENCH_CAPC after a warm one, the loop ended by one
    synchronize; a bench.py-shaped JSON line. Returns the compacted scene
    and its camera (phase 10 profiles a frame of it) and the launches."""
    from threedgrut_torch.ops import cuda_build
    from threedgrut_torch.render import infer
    acts = (params.get_positions(), params.get_rotation(), params.get_scale(),
            params.get_density(), params.get_features())
    pose = pose_of(orbit_deg_T(0), dev)
    cuda_build.launches.clear()
    out, ovf, scene = infer.refresh(*acts, cam, pose, MAIN_RES, cap, BENCH_NC,
                                    visibility_threshold=BENCH_VIS_T,
                                    device=dev)
    if bool(scene.overflow) or bool(ovf):
        fail(f"5b(b): the refresh overflowed (visible {int(scene.count)} "
             f"of n_compact {BENCH_NC}, isect overflow {bool(ovf)})")
    infer.render_compact(scene, cam, pose, MAIN_RES, BENCH_CAPC, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flags = []
    for _ in range(BENCH_ITERS):
        o, covf = infer.render_compact(scene, cam, pose, MAIN_RES,
                                       BENCH_CAPC, device=dev)
        flags.append(covf)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(cuda_build.launches)
    psnr = float(psnr_of(o.rgb, out.rgb))
    overflow = bool(ovf) or any(bool(f) for f in flags)
    rec = {"metric": "rays_per_s_infer_compact_1M_gaussians",
           "value": MAIN_RES[0] * MAIN_RES[1] * BENCH_ITERS / dt,
           "unit": "rays/s/chip", "fps": BENCH_ITERS / dt,
           "frame_ms": 1e3 * dt / BENCH_ITERS, "psnr_vs_exact": psnr,
           "visible": int(scene.count), "n_compact": BENCH_NC,
           "cap_compact": BENCH_CAPC, "vis_threshold": BENCH_VIS_T,
           "isect_overflow": overflow, "backend": "cuda",
           "device": torch.cuda.get_device_name(0), "n_gaussians": MAIN_N,
           "resolution": list(MAIN_RES), "iters": BENCH_ITERS}
    print(json.dumps(rec), flush=True)
    if overflow or not bool(torch.isfinite(o.rgb).all()) or psnr < 30.0:
        fail(f"5b(b): overflow {overflow}, PSNR {psnr}")
    for k in cuda_build.kernels_of("gut", ("forward",)):
        if launches.get(k, 0) < BENCH_ITERS + 1:
            fail(f"5b(b): {k} launched {launches.get(k, 0)} times")
    return (scene, pose), launches


def infer_card_vs_cpu(fields, res, cap, dev, T0, T1):
    """Phase 5b (c) on one scene (raw fields) at `res`: infer.refresh at T0
    on the card against the CPU (the frames within golden.compare, the
    compacted id sets equal up to census flips on INFER_FLIP_SHARE of the
    visible count); capture_binning of the CPU's CompactScene copied to
    the card, every field exactly equal; render_compact of that scene at
    T0 and render_frozen on the binning captured at T0 but at the camera T1
    (B1's sorted leg on a stale binning), both within golden.compare.
    Returns (report, ok)."""
    from threedgrut_torch import golden
    from threedgrut_torch.cameras import example_camera
    from threedgrut_torch.model.gaussians import from_numpy
    from threedgrut_torch.render import infer
    cpu = torch.device("cpu")
    side = {}
    for d in (dev, cpu):
        p = from_numpy(fields, device=d)
        side[d] = ((p.get_positions(), p.get_rotation(), p.get_scale(),
                    p.get_density(), p.get_features()),
                   example_camera(res, d))
    acts, cam = side[dev]
    out, _ = infer.refresh(*acts, cam, pose_of(T0, dev), res, cap,
                           acts[0].shape[0], device=dev)[:2]
    nvis = int(out.visibility.sum())
    n_c = min(acts[0].shape[0], -(-int(nvis * 1.2) // 4096) * 4096)
    got = {}
    for d in (dev, cpu):
        a, c = side[d]
        got[d] = infer.refresh(*a, c, pose_of(T0, d), res, cap, n_c,
                               device=d)
    rep, ok = {}, True
    (og, fg, sg), (oc, fc, sc) = got[dev], got[cpu]
    rep["refresh"], ok_r = golden.compare(og, oc)
    ids = [set(s.src_idx[:int(s.count)].cpu().tolist()) for s in (sg, sc)]
    flips = len(ids[0] ^ ids[1])
    rep.update(visible=int(sc.count), n_compact=n_c, id_flips=flips,
               overflow=[bool(x) for x in (fg, fc, sg.overflow,
                                           sc.overflow)])
    ok &= ok_r and flips <= max(1, math.floor(INFER_FLIP_SHARE
                                              * int(sc.count)))
    ok &= not any(rep["overflow"])
    binning = {}
    for d in (dev, cpu):
        binning[d] = infer.capture_binning(sc.to(d), side[d][1],
                                           pose_of(T0, d), res, cap,
                                           device=d)
    unequal = [k for k, x, y in zip(infer.FrozenBinning._fields,
                                    binning[dev], binning[cpu])
               if not torch.equal(x.cpu(), y)]
    rep["capture_unequal_fields"] = unequal
    ok &= not unequal and not bool(binning[cpu].overflow)
    comp = {d: infer.render_compact(sc.to(d), side[d][1], pose_of(T0, d),
                                    res, cap, aux_outputs=True, device=d)
            for d in (dev, cpu)}
    rep["compact"], ok_c = golden.compare(comp[dev][0], comp[cpu][0])
    froz = {d: infer.render_frozen(sc.to(d), binning[d], side[d][1],
                                   pose_of(T1, d), res, device=d)
            for d in (dev, cpu)}
    rep["frozen"], ok_f = golden.compare(frame_of(froz[dev]),
                                         frame_of(froz[cpu]))
    ok &= ok_c and ok_f and froz[dev].visibility is None
    return rep, bool(ok)


def export_roundtrip(params, cam, cap, dev, tag):
    """Phase 5b (d) on the 1M scene: .ply, .ingp (single and half) and
    .usdz written into a temporary directory, host seconds and bytes of
    each; .ply and single .ingp read back through api.load_scene, their
    alive rows and mask bit-equal to the scene's and their frame bit for
    bit; the half .ingp's and the .usdz's values equal to numpy's fp16
    rounding of the alive rows."""
    import gzip
    import tempfile
    import zipfile
    from threedgrut_torch import api, golden
    from threedgrut_torch.export import _msgpack, alive_rows
    from threedgrut_torch.export.ingp import export_ingp
    from threedgrut_torch.export.ply import export_ply
    from threedgrut_torch.export.usdz import export_usdz
    rows = alive_rows(params)
    half = {k: v.astype(np.float16).astype(np.float32)
            for k, v in rows.items()}
    writers = {"ply": ("s.ply", export_ply),
               "ingp": ("s.ingp", export_ingp),
               "ingp_half": ("h.ingp", lambda p, f: export_ingp(
                   p, f, force_half=True)),
               "usdz": ("s.usdz", export_usdz)}
    rec = {}
    T = orbit_deg_T(0)
    with torch.no_grad():
        want, _ = render_retry(api, params, cam, T, MAIN_RES, cap, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        for name, (fname, write) in writers.items():
            path = Path(tmp) / fname
            t0 = time.perf_counter()
            write(params, str(path))
            rec[name] = dict(write_s=time.perf_counter() - t0,
                             bytes=path.stat().st_size)
        for name in ("ply", "ingp", "ingp_half"):
            path = Path(tmp) / writers[name][0]
            t0 = time.perf_counter()
            back = api.load_scene(str(path), device=dev)
            torch.cuda.synchronize()
            rec[name]["read_s"] = time.perf_counter() - t0
            got = alive_rows(back)
            ref = half if name == "ingp_half" else rows
            bad = [k for k in ref if not np.array_equal(got[k], ref[k])]
            if not torch.equal(back.alive, params.alive):
                bad.append("alive")
            if name != "ingp_half":
                with torch.no_grad():
                    out, _ = render_retry(api, back, cam, T, MAIN_RES, cap,
                                          dev)
                bad += [f"frame {k}" for k in golden.OUTPUTS
                        if not torch.equal(getattr(out, k),
                                           getattr(want, k))]
            rec[name]["unequal"] = bad
            del back
        t0 = time.perf_counter()
        with zipfile.ZipFile(Path(tmp) / "s.usdz") as z:
            names = z.namelist()
            blob = _msgpack.unpackb(gzip.decompress(z.read("s.nurec")))
        rec["usdz"]["read_s"] = time.perf_counter() - t0
        sd = blob["nre_data"]["state_dict"]
        pos = np.frombuffer(sd[".gaussians_nodes.gaussians.positions"],
                            np.float16).astype(np.float32).reshape(-1, 3)
        rec["usdz"]["members"] = names
        rec["usdz"]["unequal"] = ([] if np.array_equal(pos, half["positions"])
                                  else ["positions"])
    print(f"5b(d) export of {rows['positions'].shape[0]} particles: "
          f"{json.dumps(rec)} {tag}", flush=True)
    bad = {k: r["unequal"] for k, r in rec.items() if r["unequal"]}
    if bad or rec["usdz"]["members"] != ["s.usda", "s_gauss.usda",
                                         "s.nurec"]:
        fail(f"5b(d): the round trips differ: {bad}, usdz members "
             f"{rec['usdz']['members']}")
    return rec


def inference_export(params, cam, cap, dev, tag):
    """Phase 5b: frame-coherent inference and export at full width on phase
    5's scene (bench.py's 1M with specular 0.1: the census and the
    intersections do not depend on colour). (a) the orbit, (b) bench.py's
    steady compacted frame, (c) card vs CPU at phase 4's scene, (d) the
    exporters' round trips. Returns (records, the launches of (a) and (b)
    by run, and (b)'s compacted scene and pose for phase 10)."""
    from threedgrut_torch.model.gaussians import bench_scene
    t_phase = time.time()
    base = phase_start()
    with torch.no_grad():
        orbit_recs, sizes = orbit(params, cam, cap, dev, tag)
        steady, bench_launches = bench_compact(params, cam, cap, dev, tag)
        t0 = time.time()
        rep, ok = infer_card_vs_cpu(
            bench_scene(PARITY_N, seed=0, specular_std=0.1), PARITY_RES,
            PARITY_CAP, dev, orbit_deg_T(0), orbit_deg_T(INFER_STALE_FRAME))
        print(f"5b(c) inference card vs CPU, {PARITY_N} Gaussians "
              f"{PARITY_RES} ({time.time() - t0:.1f} s): {json.dumps(rep)}",
              flush=True)
        if not ok:
            fail("5b(c): inference on the card disagrees with the CPU")
        export = export_roundtrip(params, cam, cap, dev, tag)
    peak = phase_peak_gib(base)
    print(f"phase 5b (inference and export) wall {time.time() - t_phase:.1f}"
          f" s, max_memory_allocated {peak:.3f} GiB {tag}", flush=True)
    launches = {name: r["launches"] for name, r in orbit_recs.items()}
    launches["bench compact"] = {"default": bench_launches, "sorted16": {}}
    return dict(orbit=orbit_recs, sizes=sizes, card_vs_cpu=rep,
                export=export, peak_gib=peak), launches, steady


# ---- phase 5c: the playground ---------------------------------------------

# The viewer's camera at full width: example_camera's focal (0.9 x width)
# as a field of view, and bench.py's eye (0, -4, 1) as an orbit about the
# origin (yaw, pitch, radius).
PG_FOV_DEG = math.degrees(2.0 * math.atan(0.5 / 0.9))


def pg_fov(res) -> float:
    """The field of view that makes a viewer frame of `res` the centre
    crop of the full-width camera (its focal, 0.9 x 800 px): a 16x16 tile
    then spans the full-width frame's angle, and its cone the same
    candidates (the spp 4 sample at 400x400 over the whole view, with
    depth of field, outgrew 32768 candidates in a camera tile, and the
    capacity grew to its ceiling)."""
    return math.degrees(2.0 * math.atan(0.5 * res[0] / (0.9 * MAIN_RES[0])))
PG_EYE = (-0.5 * math.pi, math.asin(1.0 / math.sqrt(17.0)), math.sqrt(17.0))
PG_STEP = math.radians(0.5)       # orbit step between frames
PG_BOUNCES = 3                    # playground.py's --max_bounces default
# The engine's first candidate capacity: a full-width frame of the 1M scene
# needs more than EngineConfig's 2048 (each growth costs a whole frame);
# from here the first frame still grows it (to engine.SPLIT_COUNT, 32768,
# on the H100).
PG_START_CAPACITY = 16384
PG_TRACE_FRAMES = 1               # timed frames after the first
PG_SPP = 4
PG_SPP_FRAMES = 0                 # its first frame is the sample
PG_HYBRID_FRAMES = 1
PG_RASTER_FRAMES = 16
PG_VIDEO_FRAMES = 2
PG_GUI_STEPS = 3
# Phase 10's profiled playground frames at this resolution over the whole
# view: a full-width trace or hybrid frame takes seconds.
PG_SMALL_RES = (400, 400)
# The spp 4 sample with depth of field and the denoiser at this
# resolution, the centre crop of the full-width view (pg_fov): the glass
# ball's refractions, the costliest rays of the scene (over the centre
# 400x400 the sample took 57.8 s on the H100).
PG_SPP_RES = (200, 200)
# (d)'s HTTP surface and video at this resolution (a centre crop).
PG_HTTP_RES = (160, 160)
# (b) card vs CPU: phase 4's scene seen through the centre 128x128 of the
# full-width camera (its focal), 2 bounces, a candidate capacity that fits
# both devices' frames. Mesh faces may differ only on rays within
# PG_EDGE_EPS (barycentric) of an edge, on at most PG_FACE_FLIP_SHARE of
# the rays; frames within golden.compare's value rule at the trace's flip
# share (golden.TRACE_FLIP_SHARE: the cone test admits a margin particle
# on one device only).
PG_PARITY_SIDE = 128
PG_PARITY_BOUNCES = 2
PG_PARITY_CAP = 8192
PG_EDGE_EPS = 1e-5
PG_FACE_FLIP_SHARE = 1e-3
# M1 (csrc/mesh_intersect.cu) culls, per block of 256 rays, the faces no
# ray of the block can hit, then runs the exact test over the survivors.
# Operations, read off the source: the exact test per ray x surviving face
# pair (s = o - p0: 3; h: 9; a: 5; |a| test and select: 2; the reciprocal:
# 2; u: 6; q: 9; w: 6; t: 6; the four bounds and u + w: 6; the running
# minimum: 2), and the cull as face_survives runs it (an interval product
# by a constant 4, of two intervals 10, a sum 2): per face of a block that
# culls (a live ray, none non-finite) up to the a tests (h: 30, a: 16, the
# a tests: 4), and past them where a keeps one sign (1/a: 4, s: 6, u: 44,
# q: 30, w: 44, t: 26, the four rules: 5); block_cull_plain counts both.
# Blocks with no live ray or a live non-finite one cull nothing. Bytes: a
# ray 24 B in and 16 B out, a face's p0, e1, e2 36 B. Kernel and plain
# versions compute the same f32 expressions, each rounded (--fmad=false):
# outputs and masks must be equal bits.
FLOP_MESH_PAIR = 56
FLOP_MESH_CULL_A = 50
FLOP_MESH_CULL_REST = 159
M1_ITERS = 10


def png_bytes(img: np.ndarray) -> bytes:
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def write_glb(path, seed=5) -> None:
    """A textured, normal-mapped quad as a .glb (JSON and BIN chunks, as
    tests/test_playground.py's test_glb_roundtrip writes one): PBR factors,
    an embedded PNG base colour texture (a checker) and normal map (tilted
    normals), UVs."""
    import struct
    rng = np.random.default_rng(seed)
    pos = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                   np.float32)
    uv = np.array([[0, 0], [2, 0], [2, 2], [0, 2]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    checker = ((np.indices((16, 16)).sum(0) // 4) % 2).astype(np.uint8)
    tex = np.stack([checker * 200 + 40, 60 + checker * 0,
                    240 - checker * 180], -1).astype(np.uint8)
    nrm = np.clip(np.stack([128 + rng.integers(-40, 40, (8, 8)),
                            128 + rng.integers(-40, 40, (8, 8)),
                            np.full((8, 8), 230)], -1), 0, 255).astype(
        np.uint8)
    blobs, views = [pos.tobytes(), uv.tobytes(), idx.tobytes()], []
    off = 0
    for b in blobs:
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(b)})
        off += len(b)
    for img in (tex, nrm):
        data = png_bytes(img)
        data += b"\0" * ((4 - len(data) % 4) % 4)
        views.append({"buffer": 0, "byteOffset": off,
                      "byteLength": len(data)})
        blobs.append(data)
        off += len(data)
    binb = b"".join(blobs)
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "TEXCOORD_0": 1}, "indices": 2,
            "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [1.0, 1.0, 1.0, 1.0], "metallicFactor": 0.2,
            "roughnessFactor": 0.4, "baseColorTexture": {"index": 0}},
            "normalTexture": {"index": 1}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 2, "componentType": 5125, "count": 6,
             "type": "SCALAR"}],
        "bufferViews": views, "buffers": [{"byteLength": len(binb)}],
        "images": [{"bufferView": 3, "mimeType": "image/png"},
                   {"bufferView": 4, "mimeType": "image/png"}],
        "textures": [{"source": 0}, {"source": 1}]}
    js = json.dumps(gltf).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    total = 12 + 8 + len(js) + 8 + len(binb)
    Path(path).write_bytes(struct.pack("<III", 0x46546C67, 2, total)
                           + struct.pack("<II", len(js), 0x4E4F534A) + js
                           + struct.pack("<II", len(binb), 0x004E4942)
                           + binb)


def sky_envmap(h=64, w=128) -> np.ndarray:
    """An equirect sky [h, w, 3] from numpy: blue above the horizon, brown
    below, a sun of radiance ~4 (polar angle from +z, as
    playground/envmap.py samples it)."""
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = ((np.arange(w) + 0.5) / w - 0.5) * 2 * np.pi
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    up = np.clip(np.cos(th), 0, 1)[..., None]
    sky = (1 - up) * np.array([0.8, 0.85, 0.9]) + up * np.array(
        [0.25, 0.45, 0.9])
    ground = np.array([0.35, 0.28, 0.2])
    env = np.where((th < np.pi / 2)[..., None], sky, ground)
    sun = np.exp(-((th - 0.6) ** 2 + (ph - 1.0) ** 2) / 0.01)[..., None]
    return (env + 4.0 * sun).astype(np.float32)


def playground_scene(dev, glb_path):
    """Phase 5c's scene graph: playground.py's material table (mirror
    0.95, glass of IOR 1.33), a mirror floor quad below the scene, a glass
    icosphere (subdivision 3: 1,280 faces) on the line from bench.py's
    camera to the scene's centre (it fills the centre ~25 degrees of the
    view, so (b)'s centre crop is all glass), and the textured,
    normal-mapped .glb card (its PBR material appended)."""
    from threedgrut_torch.playground import materials as mat_mod
    from threedgrut_torch.playground import mesh as mesh_mod
    from threedgrut_torch.playground.gltf import load_glb_scene
    from threedgrut_torch.playground.scene import SceneGraph
    sg = SceneGraph(material_specs=[
        dict(kind=mat_mod.MaterialKind.MIRROR, base_color=(0.95,) * 3),
        dict(kind=mat_mod.MaterialKind.GLASS, ior=1.33)], device=dev)
    sg.add("floor", mesh_mod.make_quad([0, 0, -2.2], [4, 0, 0], [0, 4, 0],
                                       device=dev), material_id=0)
    sg.add("ball", mesh_mod.make_icosphere([0.0, -2.2, 0.55], 0.45,
                                           subdivisions=3, device=dev),
           material_id=1)
    card, specs = load_glb_scene(str(glb_path), device=dev)
    off = len(sg.material_specs)
    for s in specs:
        sg.add_material(s)
    card.material_id = card.material_id + off
    sg.add("card", card, translation=(-1.0, -1.8, 0.2),
           rotation_euler=(0.5 * math.pi, 0.0, 0.3), scale=0.35)
    return sg


def pg_camera(k: int):
    """(yaw, pitch, radius) of orbit frame k about bench.py's eye."""
    return (PG_EYE[0] + PG_STEP * k, PG_EYE[1], PG_EYE[2])


def pg_mode(viewer, mode, frames, tag, res=MAIN_RES, **cfg):
    """One viewer mode at resolution `res`, the centre crop of the
    full-width view (pg_fov): its first frame (the capacities grow there:
    each growth is an overflow flag the engine or the raster path
    raised), then `frames` timed frames along the orbit, each with its
    launches (with 0, the first frame is the sample, and must grow
    nothing). Returns the mode's record."""
    from threedgrut_torch.ops import cuda_build
    viewer.mode = mode
    viewer.resolution = res
    viewer.fov_deg = pg_fov(res)
    for k, v in cfg.items():
        setattr(viewer.engine.cfg, k, v)
    viewer.grown = []

    def frame(k):
        cuda_build.launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = viewer.render_outputs(*pg_camera(k))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for f in ("rgb", "opacity", "depth"):
            x = out[f]
            if tuple(x.shape[:2]) != (res[1], res[0]) or not bool(
                    torch.isfinite(x).all()):
                fail(f"5c(a) {mode} frame {k}: {f} {tuple(x.shape)} not "
                     f"finite or not the resolution's")
        return out, ms, dict(cuda_build.launches), bool(
            out.get("overflow", False))

    out, first_ms, first_launches, first_flag = frame(0)
    ms, launches, flags = [], [], []
    for k in range(1, frames + 1):
        out, m, n, flag = frame(k)
        ms.append(m)
        launches.append(n)
        flags.append(flag)
    if not frames:
        # The first frame is the sample (the mode grew nothing).
        if viewer.grown:
            fail(f"5c(a) {mode}: its only frame grew {viewer.grown}")
        ms, launches, flags = [first_ms], [first_launches], [first_flag]
    cover = float((out["opacity"] > 0.01).float().mean())
    rec = dict(mode=mode, config=dict(cfg), resolution=list(res),
               first_frame_ms=first_ms,
               ms=ms, ms_median=float(np.median(ms)),
               grown=[list(g) for g in viewer.grown],
               overflow_after_growth=flags,
               candidate_capacity=viewer.engine.cfg.candidate_capacity,
               raster_caps=viewer._raster_caps, launches=launches,
               coverage=cover, rgb_mean=float(out["rgb"].mean()))
    print(f"5c(a) {mode} {cfg} {res[0]}x{res[1]}: first frame "
          f"{first_ms:.1f} ms (grew "
          f"{rec['grown']}), ms a frame median {rec['ms_median']:.3f} of "
          f"{len(ms)}, overflow after growth {flags}, candidate capacity "
          f"{rec['candidate_capacity']}, raster caps {rec['raster_caps']}, "
          f"launches a frame {launches[-1]}, coverage {cover:.4f} {tag}",
          flush=True)
    return rec


PG_REQUIRED = {"trace": ("bundle_trace_fwd", "mesh_intersect"),
               "hybrid": ("cull_masks", "expand_keys", "tile_raster_fwd",
                          "bundle_trace_fwd", "mesh_intersect"),
               "raster": ("cull_masks", "expand_keys", "tile_raster_fwd")}


def pg_primary_rays(cam, T, res):
    """The hybrid's primary rays (tile order, padded grid)."""
    from threedgrut_torch import constants as C
    from threedgrut_torch.cameras import pose_from_matrix
    from threedgrut_torch.render import gut
    wp, hp = gut.pad_to_tiles(res)
    rays = gut.packed_world_rays(cam, pose_from_matrix(T),
                                 (wp // C.TILE_X, hp // C.TILE_Y), T)
    return (rays[:, 0:3, :].transpose(1, 2).reshape(-1, 3).contiguous(),
            rays[:, 3:6, :].transpose(1, 2).reshape(-1, 3).contiguous())


class mesh_rays_recorded:
    """Inside `with`, every call of the playground's mesh intersection
    (playground/mesh.py intersect, M1's caller) keeps its rays (o, d) in
    `calls`, the last `keep` calls. It keeps the tensors themselves, not
    copies, so that the frames it watches do no extra device work: the
    engine makes each call's rays anew and never writes into them, and
    intersect makes them contiguous anyway."""

    def __init__(self, keep: int):
        self.keep, self.calls = keep, []

    def __enter__(self):
        from threedgrut_torch.playground import mesh as mesh_mod
        self.inner = mesh_mod.intersect

        def recorded(mesh, rays_o, rays_d, *args, **kwargs):
            rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
            self.calls.append((rays_o, rays_d))
            del self.calls[:-self.keep]
            return self.inner(mesh, rays_o, rays_d, *args, **kwargs)
        mesh_mod.intersect = recorded
        return self

    def __exit__(self, *exc):
        from threedgrut_torch.playground import mesh as mesh_mod
        mesh_mod.intersect = self.inner
        return False


def m1_work(o, d, tri, cull):
    """M1's work at rays (o, d) and faces tri, given block_cull_plain's
    (masks, culled, full) there: the live blocks (those with a ray of
    nonzero direction), the surviving pairs the kernel tests (each ray of
    a live block against the faces the block keeps), the live pairs (the
    live rays' alone) and the bound on the cull's operations as it runs
    them and the live pairs'."""
    from threedgrut_torch.ops import mesh_intersect as mi
    masks, culled, full = cull
    r, nf = o.shape[0], tri.shape[0]
    nb = masks.shape[0]
    rays = (r - mi.BLOCK * torch.arange(nb, device=o.device)).clamp(
        max=mi.BLOCK)
    act = torch.nn.functional.pad((d != 0).any(-1), (0, nb * mi.BLOCK - r))
    act = act.reshape(nb, mi.BLOCK)
    live = act.any(1)
    kept = masks.sum(1)
    pairs = int((kept * rays)[live].sum())
    live_pairs = int((kept * act.sum(1)).sum())
    bound = bound_ms(r * (24 + 16) + nf * 36,
                     int(culled.sum()) * nf * FLOP_MESH_CULL_A
                     + int(full.sum()) * FLOP_MESH_CULL_REST
                     + live_pairs * FLOP_MESH_PAIR)
    return int(live.sum()), pairs, live_pairs, bound


def m1_check(name, o, d, tri, tag):
    """M1 against its plain version at one set of rays, bit for bit, and
    its cull's masks (the diagnostic entry) against block_face_masks_plain,
    exactly; CUDA-event time, surviving pairs and bounds. Fails on any
    difference. Returns the set's record."""
    from threedgrut_torch.ops import cuda_build
    from threedgrut_torch.ops import mesh_intersect as mi
    k = mi.closest_hits(o, d, tri)
    p = mi.closest_hits_plain(o, d, tri)
    n0 = cuda_build.launches["mesh_intersect_masks"]
    km = mi.block_face_masks(o, d, tri)
    cull = mi.block_cull_plain(o, d, tri)
    pm = cull[0]
    torch.cuda.synchronize()
    r, nf = o.shape[0], tri.shape[0]
    live, pairs, live_pairs, bound = m1_work(o, d, tri, cull)
    rec = dict(
        rays=r, faces=nf,
        active_rays=int((d != 0).any(-1).sum()),
        hits=int(torch.isfinite(k[0]).sum()),
        bit_equal=all(torch.equal(a, b) for a, b in zip(k, p)),
        face_diffs=int((k[1] != p[1]).sum()),
        masks_equal=torch.equal(km, pm),
        masks_launches=cuda_build.launches["mesh_intersect_masks"] - n0,
        blocks=int(pm.shape[0]), live_blocks=live,
        faces_kept_mean=float(pm.sum(1).float().mean()),
        faces_kept_max=int(pm.sum(1).max()),
        max_abs_err=max(float((a.float() - b.float()).nan_to_num(
            posinf=0.0, neginf=0.0).abs().max()) for a, b in zip(k, p)),
        pairs_brute=r * nf, surviving_pairs=pairs, live_pairs=live_pairs,
        culled_blocks=int(cull[1].sum()),
        faces_past_a_tests=int(cull[2].sum()),
        bound_ms=bound[0], bound_by=bound[1],
        bound_ms_brute=bound_ms(r * (24 + 16) + nf * 36,
                                r * nf * FLOP_MESH_PAIR)[0])
    print(f"5c(c) M1 vs plain on the card, {name}: {json.dumps(rec)} {tag}",
          flush=True)
    if not (rec["bit_equal"] and rec["masks_equal"]
            and rec["masks_launches"] == 1):
        fail(f"5c(c): M1 or its cull disagrees with its plain version at "
             f"the {name} rays")
    rec["ms"] = cuda_ms(lambda: mi.closest_hits(o, d, tri), M1_ITERS)
    print(f"kernel mesh_intersect (M1) at the {name} rays: {rec['ms']:.4f} "
          f"ms, bound {bound[0]:.4f} ms ({bound[1]}: {rec['culled_blocks']} "
          f"blocks x {nf} faces culled, {rec['faces_past_a_tests']} past "
          f"the a tests, {live_pairs} live pairs; {pairs} pairs tested of "
          f"{r * nf}), brute force's bound {rec['bound_ms_brute']:.4f} ms "
          f"{tag}",
          flush=True)
    return rec


def m1_record(viewer, launches, tag, ptxas, bounce2, secondary):
    """(c) M1 at (a)'s primary rays and faces, at `bounce2`, the rays of
    the second bounce of (a)'s last trace frame (the trace keeps a stopped
    ray's direction), and at `secondary`, the last hybrid frame's
    secondary rays (zero directions where a ray stops); m1_check at each:
    bit-equal to the plain version, masks equal. The kernel's record with
    its primary-ray time, the plain version's and the bound."""
    from threedgrut_torch.ops import mesh_intersect as mi
    cam = viewer._camera()
    T = viewer._pose(*pg_camera(0))
    o, d = pg_primary_rays(cam, T, viewer.resolution)
    mesh = viewer.engine.mesh
    tri = mi.triangles(mesh.vertices, mesh.faces)
    prim = m1_check("primary", o, d, tri, tag)
    sec = m1_check("bounce-2", *bounce2, tri, tag)
    hyb = m1_check("hybrid secondary", *secondary, tri, tag)
    plain_ms = cuda_ms(lambda: mi.closest_hits_plain(o, d, tri), 1)
    rep = next((v for kk, v in ptxas.items() if "mesh_intersect" in kk),
               None)
    return dict(
        name="mesh_intersect", route="cuda",
        source="threedgrut_torch/csrc/mesh_intersect.cu",
        replaces="none: threedgrut_tpu/playground/mesh.py:186 intersect "
                 "(XLA, no TPU kernel)",
        launches=sum(launches.values()), launches_playground=launches,
        max_abs_err=max(x["max_abs_err"] for x in (prim, sec, hyb)),
        ms=prim["ms"], plain_ms=plain_ms, bound_ms=prim["bound_ms"],
        bound_by=prim["bound_by"], library_ms=None,
        pairs=prim["pairs_brute"], surviving_pairs=prim["surviving_pairs"],
        bound_ms_brute=prim["bound_ms_brute"], primary=prim, bounce2=sec,
        hybrid_secondary=hyb, ptxas=rep)


def frames_agree(got, want, share):
    """golden.compare's value rule on a frame's rgb, opacity and depth:
    within 2e-4 + 1e-4 |want| on all but `share` of the values (at least
    one)."""
    rep, ok = {}, True
    for f in ("rgb", "opacity", "depth"):
        a = got[f].detach().cpu().double()
        b = want[f].detach().cpu().double()
        diff = (a - b).abs()
        loose = int((diff > 2e-4 + 1e-4 * b.abs()).sum())
        rep[f] = float(diff.max())
        rep[f + "_loose"] = loose
        ok &= loose <= max(1, math.floor(share * diff.numel()))
    return rep, bool(ok)


def playground_card_vs_cpu(fields, side, dev, glb_path):
    """(b) Engine.render and render_hybrid on the card against the CPU:
    `fields` (raw) through the centre side x side of the full-width camera
    with phase 5c's meshes, materials and envmap, PG_PARITY_BOUNCES
    bounces; the primary mesh hits' faces, then both frames. Returns
    (report, ok)."""
    from threedgrut_torch.cameras import PinholeCamera
    from threedgrut_torch.model.gaussians import from_numpy
    from threedgrut_torch.playground import engine as eng_mod
    from threedgrut_torch.playground import mesh as mesh_mod
    from threedgrut_torch import golden
    cpu = torch.device("cpu")
    res = (side, side)
    out, hits = {}, {}
    for d in (dev, cpu):
        p = from_numpy(fields, device=d)
        sg = playground_scene(d, glb_path)
        eng = eng_mod.Engine(
            p.get_positions(), p.get_rotation(), p.get_scale(),
            p.get_density(), p.get_features(), mesh=sg.mesh(),
            materials=sg.materials(), envmap=sky_envmap(),
            config=eng_mod.EngineConfig(max_bounces=PG_PARITY_BOUNCES,
                                        candidate_capacity=PG_PARITY_CAP),
            device=d)
        f = 0.9 * MAIN_RES[0]
        z = [0.0]
        cam = PinholeCamera(*(torch.tensor(x, dtype=torch.float32, device=d)
                              for x in ([f, f], [side / 2, side / 2], z * 6,
                                        z * 2, z * 4)))
        T = torch.as_tensor(orbit_T(0), device=d)
        o, dd = pg_primary_rays(cam, T, res)
        hits[d] = mesh_mod.intersect(eng.mesh, o, dd)
        out[d] = (eng.render(cam, T, res), eng.render_hybrid(cam, T, res))
    hc, hg = hits[cpu], hits[dev]
    u, w = hc.bary[:, 0], hc.bary[:, 1]
    edge = torch.minimum(torch.minimum(u, w), 1 - u - w) < PG_EDGE_EPS
    diff = hg.face.cpu() != hc.face
    rep = dict(hits=int(torch.isfinite(hc.t).sum()),
               face_diffs=int(diff.sum()),
               face_diffs_off_edge=int((diff & ~edge).sum()))
    ok = (rep["face_diffs_off_edge"] == 0 and rep["face_diffs"]
          <= PG_FACE_FLIP_SHARE * diff.numel())
    for name, i in (("render", 0), ("hybrid", 1)):
        g, c = out[dev][i], out[cpu][i]
        rep[name], ok_f = frames_agree(g, c, golden.TRACE_FLIP_SHARE)
        rep[name]["overflow"] = [bool(g["overflow"]), bool(c["overflow"])]
        ok &= ok_f and not any(rep[name]["overflow"])
    return rep, bool(ok)


def pg_http(viewer, dev, tag, tmp):
    """(d) The viewer's HTTP surface on a loopback port at PG_HTTP_RES (the
    centre crop of the full-width view):
    GET /render in every mode and channel, POST /config, /preset,
    /material, /primitive, /traj (a 2-keyframe video rendered), /state."""
    import io
    import urllib.request
    from PIL import Image
    server = viewer.serve(port=0, blocking=False, host="127.0.0.1")
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        return urllib.request.urlopen(url + path, timeout=300).read()

    def post(path, body):
        req = urllib.request.Request(url + path,
                                     data=json.dumps(body).encode(),
                                     method="POST")
        return json.loads(urllib.request.urlopen(req, timeout=300).read())

    viewer.traj_path = str(tmp / "traj.json")
    viewer.video_path = str(tmp / "traj.mp4")
    viewer.resolution = PG_HTTP_RES
    viewer.fov_deg = pg_fov(PG_HTTP_RES)
    rec = {"render_ms": {}, "resolution": list(PG_HTTP_RES)}
    try:
        q = "/render?yaw={}&pitch={}&radius={}".format(*pg_camera(0))
        for mode in ("trace", "hybrid", "raster"):
            for channel in ("color", "density", "depth"):
                post("/config", {"mode": mode, "channel": channel})
                t0 = time.perf_counter()
                img = np.asarray(Image.open(io.BytesIO(get(q))))
                rec["render_ms"][f"{mode}/{channel}"] = (
                    time.perf_counter() - t0) * 1e3
                if img.shape != (PG_HTTP_RES[1], PG_HTTP_RES[0], 3):
                    fail(f"5c(d): /render {mode}/{channel} gave "
                         f"{img.shape}")
        st = post("/config", {"mode": "trace", "channel": "color",
                              "gamma": 2.2})
        st = post("/preset", {"name": "fast"})
        st = post("/material", {"id": 1, "ior": 1.5})
        st = post("/primitive", {"name": "ball",
                                 "translation": [0.1, -2.2, 0.5]})
        for k in range(2):
            st = post("/traj", dict(zip(("yaw", "pitch", "radius"),
                                        pg_camera(20 * k)), op="add"))
        post("/traj", {"op": "render", "frames": PG_VIDEO_FRAMES})
        t0 = time.time()
        while time.time() - t0 < 300:
            st = json.loads(get("/state"))
            if not st["video_status"].startswith("rendering"):
                break
            time.sleep(0.2)
        rec["video_status"] = st["video_status"]
        rec["video_s"] = time.time() - t0
        ok = (st["config"]["gamma"] == 2.2 and st["config"]["spp"] == 1
              and st["scene"]["materials"][1]["ior"] == 1.5
              and st["scene"]["primitives"]["ball"]["translation"][2] == 0.5
              and len(st["trajectory"]) == 2
              and st["video_status"].startswith("wrote "))
    finally:
        server.shutdown()
        server.server_close()
    print(f"5c(d) HTTP surface: {json.dumps(rec)} {tag}", flush=True)
    if not ok:
        fail(f"5c(d): the HTTP edits or the video went wrong: {st}")
    return rec


def pg_training_gui(dev, tag):
    """(d) TrainingGUI on a full-width Trainer (bench.py's scene, camera
    and Config()) taking PG_GUI_STEPS steps while another thread requests
    frames: every frame finite, /train_status reports the steps."""
    import io
    import threading
    import urllib.request
    from PIL import Image
    from threedgrut_torch.gui import TrainingGUI
    from threedgrut_torch.model.gaussians import bench_scene
    gt = np.zeros((MAIN_RES[1], MAIN_RES[0], 3), np.float32)
    tr, view = train_setup(bench_scene(MAIN_N, seed=0), MAIN_RES, MAIN_CAP,
                           gt, dev)
    gui = TrainingGUI(tr, port=0, resolution=MAIN_RES, host="127.0.0.1")
    url = f"http://127.0.0.1:{gui.server.server_address[1]}"
    frames, errors, stop = [], [], threading.Event()

    def requester():
        k = 0
        while not stop.is_set():
            try:
                img = urllib.request.urlopen(
                    url + "/render?yaw={}&pitch={}&radius={}".format(
                        *pg_camera(k)), timeout=300).read()
                frames.append(np.asarray(Image.open(io.BytesIO(img))))
            except OSError as e:
                errors.append(repr(e))
                return
            k += 1

    worker = threading.Thread(target=requester, daemon=True)
    try:
        worker.start()
        t0 = time.perf_counter()
        for _ in range(PG_GUI_STEPS):
            tr.train_step(view)
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - t0
        time.sleep(0.5)
        stop.set()
        worker.join(timeout=300)
        st = json.loads(urllib.request.urlopen(url + "/train_status",
                                               timeout=60).read())
    finally:
        stop.set()
        gui.close()
    rec = dict(steps=st["step"], frames=len(frames), errors=errors,
               steps_s=steps_s, isect_capacity=gui.proxy.isect_capacity)
    print(f"5c(d) TrainingGUI on a full-width trainer: {json.dumps(rec)} "
          f"{tag}", flush=True)
    if (worker.is_alive() or errors or not frames or st["step"]
            != PG_GUI_STEPS or not all(np.isfinite(f).all() and f.shape
                                       == (MAIN_RES[1], MAIN_RES[0], 3)
                                       for f in frames)):
        fail(f"5c(d): the live viewer failed: {rec}")
    del tr, view
    return rec


def pg_entry(params, tag, tmp):
    """(e) `python -m threedgrut_torch.playground --gs_object <the 1M
    scene as a .ply> --no-serve` on the card."""
    from threedgrut_torch.export.ply import export_ply
    ply = tmp / "scene.ply"
    export_ply(params, str(ply))
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "threedgrut_torch.playground",
                        "--gs_object", str(ply), "--no-serve"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    rec = dict(rc=r.returncode, wall_s=time.time() - t0,
               stdout=r.stdout.strip().splitlines()[-1:])
    print(f"5c(e) the playground entry: {json.dumps(rec)} {tag}",
          flush=True)
    if r.returncode != 0 or "rendered (400, 400, 3)" not in r.stdout:
        fail(f"5c(e): the playground entry failed: {r.stderr[-2000:]}")
    return rec


def playground(params, dev, tag, ptxas):
    """Phase 5c: the playground at full width on phase 5's scene. (a) the
    viewer's modes (trace at 3 bounces, spp 4 with depth of field and the
    a-trous denoiser, hybrid, raster along an orbit of 16 frames), (b)
    card vs CPU at phase 4's scene, (c) M1 against its plain version, (d)
    the HTTP surface and the live training viewer, (e) the entry. Returns
    (records, launches per mode, M1's kernel record, the viewer)."""
    import tempfile
    from threedgrut_torch.model.gaussians import bench_scene
    from threedgrut_torch.ops import cuda_build
    from threedgrut_torch.playground import engine as eng_mod
    from threedgrut_torch.playground.web_viewer import WebViewer
    t_phase = time.time()
    base = phase_start()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_pg_"))
    glb = tmp / "card.glb"
    write_glb(glb)
    sg = playground_scene(dev, glb)
    with torch.no_grad():
        acts = (params.get_positions(), params.get_rotation(),
                params.get_scale(), params.get_density(),
                params.get_features())
    engine = eng_mod.Engine(
        *acts, mesh=sg.mesh(), materials=sg.materials(),
        envmap=sky_envmap(),
        config=eng_mod.EngineConfig(max_bounces=PG_BOUNCES,
                                    candidate_capacity=PG_START_CAPACITY),
        device=dev)
    viewer = WebViewer(engine, resolution=MAIN_RES, fov_deg=PG_FOV_DEG,
                       scene=sg)
    print(f"5c scene: {engine.mesh.num_faces} faces, "
          f"{len(sg.material_specs)} materials, envmap "
          f"{tuple(engine.envmap.shape)}, viewer fov {PG_FOV_DEG:.3f} deg",
          flush=True)
    recs = {}
    with torch.no_grad():
        # The last trace frame's rays at each bounce, for (c).
        with mesh_rays_recorded(PG_BOUNCES) as rays:
            recs["trace"] = pg_mode(viewer, "trace", PG_TRACE_FRAMES, tag)
        recs["trace_spp4_dof_atrous"] = pg_mode(
            viewer, "trace", PG_SPP_FRAMES, tag, res=PG_SPP_RES,
            spp=PG_SPP, use_dof=True, aperture=0.02, focus_z=4.0,
            denoise=True, denoiser="atrous")
        engine.cfg.spp, engine.cfg.use_dof, engine.cfg.denoise = 1, False, \
            False
        # The last hybrid frame's primary and secondary rays, for (c).
        with mesh_rays_recorded(PG_BOUNCES + 1) as hybrid_rays:
            recs["hybrid"] = pg_mode(viewer, "hybrid", PG_HYBRID_FRAMES,
                                     tag)
        recs["raster"] = pg_mode(viewer, "raster", PG_RASTER_FRAMES, tag)
    launches = {}
    for name, r in recs.items():
        mode = r["mode"]
        total = {}
        for counts in r["launches"]:
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        launches[name] = total
        for kname in PG_REQUIRED[mode]:
            if total.get(kname, 0) <= 0:
                fail(f"5c(a): kernel {kname} was not launched in {name}")
    peak_a = phase_peak_gib(base)
    t0 = time.time()
    rep, ok = playground_card_vs_cpu(
        bench_scene(PARITY_N, seed=0, specular_std=0.1), PG_PARITY_SIDE,
        dev, glb)
    print(f"5c(b) playground card vs CPU, {PARITY_N} Gaussians "
          f"{PG_PARITY_SIDE}x{PG_PARITY_SIDE} ({time.time() - t0:.1f} s): "
          f"{json.dumps(rep)}", flush=True)
    if not ok:
        fail("5c(b): the playground on the card disagrees with the CPU")
    m1 = m1_record(viewer, {n: c.get("mesh_intersect", 0)
                            for n, c in launches.items()}, tag, ptxas,
                   rays.calls[1], hybrid_rays.calls[1])
    del rays, hybrid_rays
    with torch.no_grad():
        http = pg_http(viewer, dev, tag, tmp)
    gui = pg_training_gui(dev, tag)
    entry = pg_entry(params, tag, tmp)
    peak = phase_peak_gib(base)
    wall = time.time() - t_phase
    print(f"phase 5c (playground) wall {wall:.1f} s, max_memory_allocated "
          f"{peak:.3f} GiB ((a) {peak_a:.3f}) {tag}", flush=True)
    return (dict(modes=recs, card_vs_cpu=rep, http=http, gui=gui,
                 entry=entry, peak_gib=peak, peak_gib_a=peak_a,
                 wall_s=wall), launches, m1, viewer)


# (f) the allocator's counters read around each run (torch.cuda.memory_stats
# keys): segments held, cudaMalloc and cudaFree calls, retries after a
# failed cudaMalloc (each frees the cache and synchronizes), bytes reserved.
ALLOC_KEYS = ("segment.all.current", "num_device_alloc", "num_device_free",
              "num_alloc_retries", "reserved_bytes.all.current",
              "inactive_split_bytes.all.current")


def alloc_state() -> dict:
    s = torch.cuda.memory_stats()
    return {k: int(s.get(k, 0)) for k in ALLOC_KEYS}


def card_state() -> dict:
    """The card's SM clock (MHz), temperature (C) and power draw (W), as
    nvidia-smi reads them."""
    row = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return dict(zip(("sm_mhz", "temp_c", "power_w"),
                    (float(x) for x in row.split(","))))


def train_after_playground(dev, tag, phase6_ms):
    """5c(f): whether the playground leaves the process slower to train.
    train_main_path's run (phase 6's default trainer) right after phase
    5c, then again after gc and torch.cuda.empty_cache(); for each, the
    allocator's counters over the run and over two more steps (one warm,
    one profiled: device busy time and idle share), the live threads, and
    the card's SM clock and temperature before and after. Returns the
    record."""
    import gc
    import threading
    t0 = time.time()
    rec = dict(phase6_step_ms=phase6_ms)
    for name in ("after_playground", "after_empty_cache"):
        if name == "after_empty_cache":
            gc.collect()
            torch.cuda.empty_cache()
        a0, c0 = alloc_state(), card_state()
        threads = sorted(t.name for t in threading.enumerate())
        tr, view, _, r = train_main_path(dev, tag, mode=name)
        a1 = alloc_state()
        prof = profile_run(lambda: tr.train_step(view), ("train.",))
        a2 = alloc_state()
        rec[name] = dict(
            step_ms=r["step_ms"], alloc_before=a0, threads=threads,
            alloc_over_run={k: a1[k] - a0[k] for k in ALLOC_KEYS},
            alloc_over_two_steps={k: a2[k] - a1[k] for k in ALLOC_KEYS},
            profiled_step={k: prof[k] for k in (
                "wall_ms", "device_busy_ms", "device_idle_share",
                "kernel_launches")},
            card_before=c0, card_after=card_state())
        del tr, view
    rec["wall_s"] = time.time() - t0
    print(f"5c(f) train steps after the playground: {json.dumps(rec)} "
          f"{tag}", flush=True)
    return rec


# ---- phase 6b: densification ---------------------------------------------

COUNT_NAMES = {"gs": ("clone", "split", "prune"),
               "mcmc": ("relocate", "add")}


def densify_config(cfg, method):
    """`cfg` with strategy `method` on the compressed schedule."""
    cfg.strategy.method = method
    for k, v in DENSIFY_SCHEDULE.items():
        setattr(cfg.strategy, k, v)
    return cfg


def kill_share(params, n, seed=0):
    """Give DENSIFY_DEAD_SHARE of the first n particles (a seeded numpy
    choice) opacity DENSIFY_DEAD_OPACITY. Returns how many."""
    idx = np.random.default_rng(seed).choice(
        n, int(round(DENSIFY_DEAD_SHARE * n)), replace=False)
    logit = float(np.log(DENSIFY_DEAD_OPACITY / (1.0 - DENSIFY_DEAD_OPACITY)))
    with torch.no_grad():
        params.density[torch.as_tensor(idx, device=params.density.device)] \
            = logit
    return len(idx)


def copy_gaussians(p, dev):
    from threedgrut_torch.model.gaussians import FIELDS, Gaussians
    return Gaussians(**{f: getattr(p, f).detach().to(dev, copy=True)
                        for f in FIELDS})


def densified_run(tr, view, leg, step_ok, tag, after_step=None):
    """DENSIFY_STEPS Trainer.train_step calls with the trainer's strategy,
    the last with walk_compact_fraction 0 (the dense backward). Prints per
    step the alive count, the strategy's counts, loss, ms (host clock
    around a step ending in a synchronize), overflow, isect capacity and
    launches; fails unless every value is finite and step_ok(the step's
    launches). Returns (rows, the run's launches, the last aux)."""
    from threedgrut_torch.ops import cuda_build
    names = COUNT_NAMES[tr.cfg.strategy.method]
    walk = tr.cfg.render.walk_compact_fraction
    cuda_build.launches.clear()
    rows, aux = [], None
    for k in range(DENSIFY_STEPS):
        if k == DENSIFY_STEPS - 1:
            tr.cfg.render.walk_compact_fraction = 0.0
        cap = tr.isect_capacity
        before = dict(cuda_build.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = tr.train_step(view)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        step = {n: v - before.get(n, 0)
                for n, v in cuda_build.launches.items()
                if v != before.get(n, 0)}
        row = dict(step=k + 1, alive=int(tr.params.num_active()),
                   **{n: int(tr.strategy.counts.get(n, 0)) for n in names},
                   loss=float(aux["terms"]["total"]), ms=ms,
                   overflow=bool(aux["overflow"]), isect_capacity=cap,
                   launches=step)
        print(f"{leg} step {k + 1}: {json.dumps(row)} {tag}", flush=True)
        finite = all(bool(torch.isfinite(x).all()) for x in
                     [aux["pred"], *aux["grads"].values(),
                      *(getattr(tr.params, f) for f in aux["grads"])])
        if not (finite and math.isfinite(row["loss"])):
            fail(f"{leg} step {k + 1}: a value is not finite")
        if not step_ok(step):
            fail(f"{leg} step {k + 1} launched {step}")
        rows.append(row)
        if after_step is not None:
            after_step(k, tr)
    tr.cfg.render.walk_compact_fraction = walk
    return rows, dict(cuda_build.launches), aux


def leg_record(leg, n, capacity, dead, rows, peak, launches, method):
    """A densified leg's summary: its scene, alive counts, the strategy's
    totals, step ms before growth (step 1) and after (median of steps 3
    and 5, which run no event), peak memory and launches."""
    return dict(leg=leg, n=n, capacity=capacity, dead=dead,
                alive=[r["alive"] for r in rows],
                totals={k: sum(r[k] for r in rows)
                        for k in COUNT_NAMES[method]},
                step_ms_before=rows[0]["ms"],
                step_ms_after=float(np.median([rows[2]["ms"],
                                               rows[4]["ms"]])),
                peak_gib=peak, launches=launches)


def strategy_op_ms(tr, view, aux, tag):
    """Each operation of the trainer's strategy as its hooks run it (its
    draws included) on a copy of the trainer's parameters: the CUDA-event
    mean of DENSIFY_TIME_ITERS calls after one. Every operation is a
    masked write over the whole capacity: its work does not depend on how
    many particles move."""
    from threedgrut_torch.optimizers import positions_lr_schedule
    from threedgrut_torch.strategy import gs, mcmc
    strat, g, dev = tr.strategy, tr.generator, tr.device
    cfg = strat.cfg
    p = copy_gaussians(tr.params, dev)
    opt, c = tr.opt_state, p.capacity
    if cfg.method == "gs":
        cam = torch.as_tensor(view.T_to_world, dtype=torch.float32,
                              device=dev)[:3, 3]

        def accumulate(state):
            return gs.accumulate(state, p, aux["pos_grad_norm"], cam,
                                 aux["visibility"], cfg.prune_weight_ema)

        st = accumulate(strat.state)
        ops = {
            "accumulate": lambda: accumulate(st),
            "densify": lambda: gs.densify(
                p, opt, st, torch.randn((c, 3), generator=g, device=dev),
                torch.randn((c, 3), generator=g, device=dev),
                tr.scene_extent, cfg.densify_grad_threshold,
                cfg.densify_scale_threshold, 0.8 * cfg.split_n),
            "prune": lambda: gs.prune(p, cfg.prune_density_threshold),
            "reset": lambda: gs.reset_density(p, cfg.reset_density_value)}
    else:
        thr = cfg.mcmc_opacity_threshold
        n_add = int(0.05 * int(p.num_active()))
        pos_lr = positions_lr_schedule(tr.cfg.optimizer, tr.scene_extent,
                                       tr.global_step)

        def sample():
            return mcmc._sample_sources(g, mcmc.source_probs(p, thr), c)

        ops = {
            "sample_sources": sample,
            "relocate": lambda: mcmc.relocate(p, opt, sample(), thr,
                                              strat.binoms),
            "add": lambda: mcmc.add_gaussians(p, opt, sample(), thr,
                                              strat.binoms, n_add),
            "perturb": lambda: mcmc.perturb(
                p, torch.randn((c, 3), generator=g, device=dev), pos_lr,
                cfg.mcmc_noise_lr)}
    out = {name: cuda_ms(fn, DENSIFY_TIME_ITERS) for name, fn in ops.items()}
    print(f"strategy ops ({cfg.method}, capacity {c}), CUDA-event ms, mean "
          f"of {DENSIFY_TIME_ITERS} after one: {json.dumps(out)} {tag}",
          flush=True)
    return out


def strategy_profile(tr, view, leg, tag):
    """One train step under torch.profiler (after a warm one) with the
    strategy's events due at every step (densify_end far off, frequencies
    1), so that its "strategy.*" spans show each operation of the leg."""
    s = tr.strategy.cfg
    s.densify_end, s.densify_frequency, s.mcmc_add_frequency = 1 << 30, 1, 1
    prof = profile_run(lambda: tr.train_step(view),
                       ("train.", "strategy."))
    print(f"profiled densified train step ({leg}): {json.dumps(prof)} "
          f"{tag}", flush=True)
    if not any(k.startswith("strategy.")
               for k in prof["stage_device_span_ms"]):
        fail(f"{leg}: the profile shows no strategy span")
    return prof


def densify_gut_leg(dev, tag, method):
    """Phase 6b (a) GS and (b) MCMC, on the default 3DGUT step at full
    width: bench.py's scene, camera and zero ground truth, re-padded
    (GS: 1M in DENSIFY_GS_CAP slots; MCMC: DENSIFY_MCMC_N in
    DENSIFY_MCMC_CAP), 5% of it dead, DENSIFY_STEPS steps on the
    compressed schedule. Fails unless every step launched B1 and B2 once,
    every 3DGUT kernel ran, and GS cloned, split and pruned and grew, or
    MCMC relocated, added and held DENSIFY_MCMC_MAX after step 4. Then
    times the strategy's operations and profiles a densified step."""
    from threedgrut_torch.config import Config
    from threedgrut_torch.model.gaussians import (FIELDS, bench_scene,
                                                  padded_fields)
    from threedgrut_torch.ops import cuda_build
    from threedgrut_torch.strategy import gs
    from threedgrut_torch.train import make_strategy
    n, cap = ((MAIN_N, DENSIFY_GS_CAP) if method == "gs"
              else (DENSIFY_MCMC_N, DENSIFY_MCMC_CAP))
    f = bench_scene(n, seed=0)
    fields = padded_fields(*(f[k][:n] for k in FIELDS[:-1]), capacity=cap)
    cfg = densify_config(Config(), method)
    if method == "gs":
        cfg.strategy.densify_scale_threshold = DENSIFY_GS_SCALE
    gt = np.zeros((MAIN_RES[1], MAIN_RES[0], 3), np.float32)
    leg = f"densify {method} (3DGUT)"
    base = phase_start()
    tr, view = train_setup(fields, MAIN_RES, MAIN_CAP, gt, dev, cfg=cfg)
    dead = kill_share(tr.params, n)
    tr.strategy = make_strategy(tr.cfg, cap, dev)

    def set_threshold(k, tr):
        if method == "gs" and k == 0:
            avg = gs.grad_average(tr.strategy.state)[tr.params.alive]
            thr = float(torch.topk(avg, DENSIFY_GS_SOURCES).values[-1])
            tr.strategy.cfg.densify_grad_threshold = thr
            print(f"{leg}: densify_grad_threshold after step 1 = {thr!r} "
                  f"(the {DENSIFY_GS_SOURCES}-th largest average gradient "
                  f"of the alive particles)", flush=True)

    rows, launches, aux = densified_run(
        tr, view, leg, lambda s: (s.get("tile_raster_fwd") == 1
                                  and s.get("tile_raster_bwd") == 1),
        tag, set_threshold)
    peak = phase_peak_gib(base)
    for kname in cuda_build.kernels_of("gut"):
        if launches.get(kname, 0) <= 0:
            fail(f"kernel {kname} was not launched on {leg}")
    rec = leg_record(leg, n, cap, dead, rows, peak, launches, method)
    if min(rec["totals"].values()) <= 0 or (
            rec["alive"][-1] <= n if method == "gs"
            else rec["alive"][3] != DENSIFY_MCMC_MAX):
        fail(f"{leg}: {rec['totals']}, alive {rec['alive']}")
    print(f"{leg}: {json.dumps(rec)} {tag}", flush=True)
    rec["op_ms"] = strategy_op_ms(tr, view, aux, tag)
    rec["profile"] = strategy_profile(tr, view, leg, tag)
    return rec


def densify_grt_leg(dev, tag):
    """Phase 6b (c): preset_mcmc(preset_3dgrt()) (the reference's
    colmap_3dgrt_mcmc app) on bench_grt's 100k scene in DENSIFY_GRT_CAP
    slots, 5% dead, the 3DGRT trainer's view, DENSIFY_STEPS steps on the
    compressed schedule. Fails unless every step launched B7, B8 and B6
    once and nothing else, and MCMC relocated, added and filled the
    capacity by step 6."""
    from threedgrut_torch.config import preset_3dgrt, preset_mcmc
    from threedgrut_torch.ops import cuda_build
    from threedgrut_torch.train import make_strategy
    from threedgrut_torch.trainer import Trainer
    cfg = GRT_CONFIGS[0]
    cfg3 = densify_config(preset_mcmc(preset_3dgrt()), "mcmc")
    cfg3.render.isect_capacity = GRT_TRAIN_ISECT
    cfg3.model.progressive_sh_interval = 0
    leg = "densify mcmc (3DGRT)"
    base = phase_start()
    params, _, _ = grt_bench_scene(cfg["n"], cfg["scales"], dev,
                                   capacity=DENSIFY_GRT_CAP)
    dead = kill_share(params, cfg["n"])
    view = grt_train_view(dev)
    tr = Trainer(cfg3, OneView(view, 4.0), params=params,
                 strategy=make_strategy(cfg3, DENSIFY_GRT_CAP, dev),
                 device=dev)
    want = {n: 1 for n in cuda_build.kernels_of("grt")}
    rows, launches, _ = densified_run(tr, view, leg, lambda s: s == want,
                                      tag)
    peak = phase_peak_gib(base)
    rec = leg_record(leg, cfg["n"], DENSIFY_GRT_CAP, dead, rows, peak,
                     launches, "mcmc")
    if min(rec["totals"].values()) <= 0 \
            or rec["alive"][-1] != DENSIFY_GRT_CAP:
        fail(f"{leg}: {rec['totals']}, alive {rec['alive']}")
    print(f"{leg}: {json.dumps(rec)} {tag}", flush=True)
    return rec


def strategy_card_vs_cpu(pc, dev, seed=0):
    """Each strategy operation (densify, prune, relocate, add_gaussians,
    perturb, reset_density, accumulate) on the card and on the CPU from the
    same state (the CPU's result of the operation before it, copied to the
    card) with the same draws (made on the CPU from a seeded generator and
    copied to the card). pc: Gaussians on the CPU (not changed). Returns
    {operation: report}: `exact` (alive, the densify masks, taken slots and
    sources, the counts and grad_denom equal), `max_abs_diff` of every float
    (parameters, moments, state) and `within` (each float within
    STRATEGY_ATOL + STRATEGY_RTOL |cpu|)."""
    from threedgrut_torch.model.gaussians import FIELDS
    from threedgrut_torch.optimizers import (PARAM_FIELDS, OptimizerConfig,
                                             positions_lr_schedule,
                                             state_from_numpy)
    from threedgrut_torch.strategy import gs, mcmc
    c = pc.capacity
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    m, v = ({f: rng.normal(size=tuple(getattr(pc, f).shape)).astype(
        np.float32) for f in PARAM_FIELDS} for _ in range(2))
    opt = state_from_numpy(m, {f: np.abs(x) for f, x in v.items()}, 5,
                           "cpu")
    state = gs.GSState(
        grad_accum=torch.tensor(rng.exponential(1e-4, c).astype(np.float32)),
        grad_denom=torch.tensor(rng.integers(0, 5, c).astype(np.int32)),
        rolling_vis=torch.tensor(rng.uniform(0.2, 1.0, c).astype(
            np.float32)))
    p = copy_gaussians(pc, "cpu")
    binoms = {"cpu": mcmc.binom_table(51, "cpu"),
              str(dev): mcmc.binom_table(51, dev)}
    extent, thr, sthr = 4.0, 0.005, 0.0075
    gthr = float(np.quantile(gs.grad_average(state)[p.alive].numpy(), 0.9))
    pos_lr = positions_lr_schedule(OptimizerConfig(), extent, 100)

    def densify(p, o, s, d, draws):
        cl, sp = gs.densify_masks(p, s, extent, gthr, sthr)
        take, src = gs._assign_free_slots(cl | sp, ~p.alive)
        o, s, counts = gs.densify(p, o, s, *draws, extent, gthr, sthr, 1.6)
        return o, s, dict(clone_mask=cl, split_mask=sp, take=take,
                          src=torch.where(take, src, -1), **counts)

    def prune(p, o, s, d, draws):
        return o, s, dict(gone=gs.prune(p, thr))

    def relocate(p, o, s, d, draws):
        o, n = mcmc.relocate(p, o, draws[0], thr, binoms[str(d)])
        return o, s, dict(n=n)

    def add(p, o, s, d, draws):
        o, n = mcmc.add_gaussians(p, o, draws[0], thr, binoms[str(d)],
                                  int(0.05 * int(p.num_active())))
        return o, s, dict(n=n)

    def perturb(p, o, s, d, draws):
        mcmc.perturb(p, draws[0], pos_lr, 5e5)
        return o, s, {}

    def reset(p, o, s, d, draws):
        gs.reset_density(p, 0.01)
        return o, s, {}

    def accumulate(p, o, s, d, draws):
        return o, gs.accumulate(s, p, *draws, 0.9), {}

    def sources(p):
        return [mcmc._sample_sources(g, mcmc.source_probs(p, thr), c)]

    def grads(p):
        norm = torch.tensor(rng.exponential(1e-4, c).astype(np.float32))
        norm[torch.tensor(rng.uniform(size=c) < 0.3)] = 0.0
        return [norm, torch.tensor([0.0, -4.0, 1.0]),
                torch.tensor(rng.uniform(size=c) < 0.5)]

    # (name, function, draws, whether the chain goes on from its result:
    # not from prune's, so that relocate still finds the dead particles).
    ops = [("densify", densify,
            lambda p: [torch.randn((c, 3), generator=g) for _ in range(2)],
            True),
           ("prune", prune, lambda p: [], False),
           ("relocate", relocate, sources, True),
           ("add_gaussians", add, sources, True),
           ("perturb", perturb,
            lambda p: [torch.randn((c, 3), generator=g)], True),
           ("reset_density", reset, lambda p: [], True),
           ("accumulate", accumulate, grads, True)]
    report = {}
    for name, fn, draw, carry in ops:
        draws = draw(p)
        before = (copy_gaussians(p, "cpu"), opt, state)
        pd = copy_gaussians(p, dev)
        od = opt._replace(
            exp_avg={k: x.to(dev) for k, x in opt.exp_avg.items()},
            exp_avg_sq={k: x.to(dev) for k, x in opt.exp_avg_sq.items()})
        sd = gs.GSState(*(x.to(dev) for x in dataclasses.astuple(state)))
        od, sd, ints_d = fn(pd, od, sd, dev, [x.to(dev) for x in draws])
        opt, state, ints_c = fn(p, opt, state, torch.device("cpu"), draws)
        ints = [(pd.alive, p.alive), (sd.grad_denom, state.grad_denom)] + [
            (ints_d[k], ints_c[k]) for k in ints_c]
        floats = ([(getattr(pd, f), getattr(p, f)) for f in FIELDS[:-1]]
                  + [(od.exp_avg[f], opt.exp_avg[f]) for f in PARAM_FIELDS]
                  + [(od.exp_avg_sq[f], opt.exp_avg_sq[f])
                     for f in PARAM_FIELDS]
                  + [(sd.grad_accum, state.grad_accum),
                     (sd.rolling_vis, state.rolling_vis)])
        diffs = [((a.detach().cpu() - b.detach()).abs(), b.detach().abs())
                 for a, b in floats]
        report[name] = dict(
            exact=all(torch.equal(a.cpu(), b) for a, b in ints),
            max_abs_diff=max(float(d.max()) for d, _ in diffs),
            within=all(bool((d <= STRATEGY_ATOL + STRATEGY_RTOL * b).all())
                       for d, b in diffs),
            counts={k: int(x.sum()) for k, x in ints_c.items()
                    if k != "src"})
        if not carry:
            p, opt, state = before
    return report


def densification(dev, tag):
    """Phase 6b: the trainer's densification. (d) every strategy operation
    card vs CPU at bench_grt's 100k scene; (a) GS and (b) MCMC on the
    default 3DGUT step at full width; (c) MCMC on the 3DGRT train step;
    (e) the strategy operations' times and a profiled densified step of
    (a) and (b). Returns the legs' records."""
    t0 = time.time()
    cfg = GRT_CONFIGS[0]
    pc, _, _ = grt_bench_scene(cfg["n"], cfg["scales"], "cpu",
                               capacity=DENSIFY_GRT_CAP)
    kill_share(pc, cfg["n"])
    report = strategy_card_vs_cpu(pc, dev)
    print(f"strategy operations card vs CPU ({cfg['n']} particles in "
          f"{DENSIFY_GRT_CAP} slots; floats within {STRATEGY_ATOL} + "
          f"{STRATEGY_RTOL} |cpu|): {json.dumps(report)} {tag}", flush=True)
    bad = [op for op, r in report.items() if not (r["exact"]
                                                  and r["within"])]
    if bad:
        fail(f"strategy operations {bad} on the card disagree with the CPU")
    del pc
    recs = [densify_gut_leg(dev, tag, "gs"), densify_gut_leg(dev, tag, "mcmc"),
            densify_grt_leg(dev, tag)]
    print(f"phase 6b (densification) wall {time.time() - t0:.1f} s",
          flush=True)
    return recs


# ---- phase 6c: data, entry points and eval ------------------------------

# The scenes' sizes (the entry points' widths are the presets'; depth is
# cut: views and iterations). (a) NeRF-synthetic as lego is laid out:
# transforms_{train,test}.json, 800x800 RGBA PNGs, lego's camera_angle_x.
DATA_GT_N = 1_000_000
NERF_RES = 800
NERF_ANGLE_X = 0.6911112
NERF_VIEWS = (24, 8)
NERF_ITERS = 200
# (b) a Mip-NeRF 360-shaped COLMAP scene: one OPENCV camera at 4948x3288
# (small k1, k2, p1, p2), its images_4/ at 1237x822, every 8th image in
# the validation split, points3D drawn from the ground-truth scene.
COLMAP_SIZE = (4948, 3288)
COLMAP_PARAMS = (3300.0, 3300.0, 2474.0, 1644.0, 0.012, -0.0025, 0.0004,
                 -0.0003)
COLMAP_DOWN = 4
COLMAP_IMAGES = 32
COLMAP_POINTS = 100_000
COLMAP_ITERS = 100
# (c) the 3DGRT preset on (a)'s files; (d) the multi-sensor rig.
GRT_ENTRY_ITERS = 20
MS_RES = 800
MS_VIEWS = 12
MS_ITERS = 100


def nerf_schedule(iters):
    """(a)'s GS schedule, compressed into `iters` steps (200: densify at 50,
    100 and 150, a density reset at 150; validation at 100 and 200; a
    checkpoint at 100; a resume of 60 steps from it)."""
    q = iters // 4
    return dict(start=q, freq=q, end=iters, reset=3 * q, val=2 * q,
                ckpt=2 * q, resume=int(0.3 * iters))


def gt_scene(dev):
    """The ground-truth scene of (a) and (b): bench.py's seeded 1M."""
    from threedgrut_torch.model.gaussians import bench_scene, from_numpy
    f = bench_scene(DATA_GT_N, seed=0, specular_std=0.1)
    return f, from_numpy(f, device=dev)


def render_frame(params, cam, T, res, dev, caps):
    """(rgb, opacity) numpy of one frame of the ground-truth scene; caps[0]
    is the capacity to start from, kept grown for the next frame."""
    from threedgrut_torch import api
    with torch.no_grad():
        out, caps[0] = render_retry(api, params, cam, T, res, caps[0], dev)
    return (out.rgb.clamp(0.0, 1.0).cpu().numpy(),
            out.opacity.cpu().numpy())


def sphere_poses(n, radius, seed, z_range=(0.6, 2.2)):
    """n camera-to-world (right-down-front) poses on a ring of the given
    radius around the origin, looking at it, heights drawn from `seed`."""
    from threedgrut_torch.cameras import look_at
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        a = 2.0 * math.pi * (k + rng.uniform(0.0, 0.5)) / n
        eye = np.array([radius * math.cos(a), radius * math.sin(a),
                        rng.uniform(*z_range)], np.float32)
        out.append(look_at(eye, np.zeros(3, np.float32),
                           np.array([0.0, 0.0, 1.0], np.float32)))
    return out


def save_png(path, img) -> None:
    from PIL import Image
    Image.fromarray((np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(
        np.uint8)).save(path, compress_level=1)


def write_nerf_scene(root, params, dev):
    """(a)'s scene on disk: frames of the ground-truth scene as straight-
    alpha RGBA (colour = rgb / opacity, alpha = opacity), poses in the
    right-up-back convention. Returns its wall seconds."""
    from threedgrut_torch.cameras import PinholeCamera
    t0 = time.time()
    f = 0.5 * NERF_RES / math.tan(0.5 * NERF_ANGLE_X)
    cam = PinholeCamera(*(torch.tensor(x, dtype=torch.float32, device=dev)
                          for x in ([f, f], [NERF_RES / 2] * 2, [0.0] * 6,
                                    [0.0] * 2, [0.0] * 4)))
    res, caps = (NERF_RES, NERF_RES), [MAIN_CAP]
    for split, n, seed in (("train", NERF_VIEWS[0], 1),
                           ("test", NERF_VIEWS[1], 2)):
        (root / split).mkdir(parents=True)
        frames = []
        for k, T in enumerate(sphere_poses(n, 4.0, seed)):
            rgb, op = render_frame(params, cam, T, res, dev, caps)
            color = np.where(op[..., None] > 1e-6,
                             rgb / np.maximum(op[..., None], 1e-6), 0.0)
            save_png(root / split / f"r_{k}.png",
                     np.concatenate([color, op[..., None]], -1))
            rub = T.astype(np.float64).copy()
            rub[:3, 1:3] *= -1.0
            frames.append({"file_path": f"./{split}/r_{k}",
                           "transform_matrix": rub.tolist()})
        (root / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": NERF_ANGLE_X, "frames": frames}))
    return time.time() - t0


def write_colmap_scene(root, fields, params, dev):
    """(b)'s scene on disk: sparse/0 (cameras.bin with the OPENCV camera,
    images.bin, points3D.bin of COLMAP_POINTS particles of the ground-truth
    scene with their SH base colours) and images_4/ rendered through the
    loader's own camera model of that camera at 1/4. Returns its wall
    seconds."""
    from threedgrut_torch.cameras import matrix_to_quat
    from threedgrut_torch.constants import SH_C0
    from threedgrut_torch.datasets import colmap
    from threedgrut_torch.datasets.dataset_colmap import _camera_to_model
    from threedgrut_torch.device import tuple_to
    t0 = time.time()
    sparse, images_dir = root / "sparse" / "0", root / f"images_{COLMAP_DOWN}"
    sparse.mkdir(parents=True)
    images_dir.mkdir()
    ccam = colmap.ColmapCamera("OPENCV", *COLMAP_SIZE,
                               np.array(COLMAP_PARAMS, np.float64))
    cam = tuple_to(_camera_to_model(ccam, COLMAP_DOWN), dev)
    res = tuple(-(-s // COLMAP_DOWN) for s in COLMAP_SIZE)
    images, caps = {}, [MAIN_CAP]
    for k, T in enumerate(sphere_poses(COLMAP_IMAGES, 4.5, 3)):
        R = T[:3, :3].T
        q = matrix_to_quat(torch.tensor(R)).numpy().astype(np.float64)
        name = f"frame_{k:04d}.png"
        images[k + 1] = colmap.ColmapImage(
            q, (-R @ T[:3, 3]).astype(np.float64), 1, name)
        save_png(images_dir / name, render_frame(params, cam, T, res, dev,
                                                 caps)[0])
    pick = np.random.default_rng(4).choice(DATA_GT_N, COLMAP_POINTS,
                                           replace=False)
    colmap.write_cameras_bin(str(sparse / "cameras.bin"), {1: ccam})
    colmap.write_images_bin(str(sparse / "images.bin"), images)
    colmap.write_points3d_bin(
        str(sparse / "points3D.bin"), fields["positions"][pick],
        np.clip(fields["features_albedo"][pick] * SH_C0 + 0.5, 0.0, 1.0))
    return time.time() - t0


def run_leg(leg, argv, iters, kernels, tag):
    """threedgrut_torch.train.run(argv) with the launch counts set to 0
    just before and read just after. Fails unless every train step
    launched the forward kernels of `kernels` at least once and each
    backward kernel (B5 and B6 together on the 3DGUT path, whose fused
    backward takes one of them) exactly once. Returns (trainer, test
    summary, launches, record)."""
    from threedgrut_torch import train as train_entry
    from threedgrut_torch.ops import cuda_build
    base = phase_start()
    cuda_build.launches.clear()
    t0 = time.time()
    tr, summary = train_entry.run(argv)
    wall = time.time() - t0
    launches = dict(cuda_build.launches)
    peak = phase_peak_gib(base)
    steps = [s for s in tr.step_times if s["step"] > tr.global_step - iters]
    if len(steps) != iters:
        fail(f"{leg}: {len(steps)} train steps recorded, not {iters}")
    b56 = ("segment_sum_rows", "segment_sum_rows_by_ids")
    gut_path = "tile_raster_fwd" in kernels
    bad = {}
    for k in kernels:
        if gut_path and k in b56:
            continue
        n = launches.get(k, 0)
        if n < iters or (cuda_build.KERNELS[k][2] == "backward"
                         and n != iters):
            bad[k] = n
    if gut_path and sum(launches.get(k, 0) for k in b56) != iters:
        bad["B5 + B6"] = [launches.get(k, 0) for k in b56]
    if bad:
        fail(f"{leg}: in {iters} train steps {bad} (launches {launches})")
    n_views = len(tr.dataset)
    first = [s["data_ms"] for s in steps[:n_views]]
    later = [s["data_ms"] for s in steps[n_views:]]
    rec = dict(leg=leg, wall_s=wall, steps=iters, views=n_views,
               alive_after=int(tr.params.num_active()),
               capacity=tr.params.capacity,
               isect_capacity=tr.isect_capacity,
               step_ms_median_after_first_epoch=float(np.median(
                   [s["step_ms"] for s in steps[n_views:]] or
                   [s["step_ms"] for s in steps])),
               data_ms_first_epoch=float(np.mean(first)),
               data_ms_later=float(np.mean(later)) if later else None,
               events={s["step"]: s["events"] for s in steps
                       if "events" in s},
               test=summary, peak_gib=peak, launches=launches)
    return tr, summary, launches, rec


def check_run_dir(leg, run, ckpts, train_log_steps, val_steps, n_test):
    """The train entry's artifacts in `run`: each checkpoint's .npz and
    .json, metrics.jsonl with the train scalars at `train_log_steps` and
    the validation ones at `val_steps`, TensorBoard events where
    tensorboard imports, the final export (export_last.ply, .ingp, .usdz),
    and test_renders/ with one pred_*.png per test view and the best and
    worst pairs."""
    missing = [f"{c}.{e}" for c in ckpts for e in ("npz", "json")
               if not (run / f"{c}.{e}").exists()]
    missing += [f"export_last.{e}" for e in ("ply", "ingp", "usdz")
                if not (run / f"export_last.{e}").exists()]
    rows = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text()
            .splitlines()]
    tags = {(r["step"], k) for r in rows for k in r if k not in ("t",
                                                                 "step")}
    missing += [f"metrics {t}@{s}" for s in train_log_steps
                for t in ("train/psnr", "train/time_step_ms",
                          "train/time_data_ms")
                if (s, t) not in tags]
    missing += [f"metrics val/psnr@{s}" for s in val_steps
                if (s, "val/psnr") not in tags]
    preds = sorted(p.name for p in (run / "test_renders").glob("pred_*"))
    if len(preds) != n_test:
        missing.append(f"{n_test} test preds (found {len(preds)})")
    for tagname in ("best", "worst"):
        if not list((run / "test_renders").glob(f"{tagname}_psnr_*")):
            missing.append(f"{tagname} images")
    try:
        import torch.utils.tensorboard  # noqa: F401
        tb = True
    except ImportError:
        tb = False
    events = list(run.glob("events.out.tfevents*"))
    if tb and not events:
        missing.append("tensorboard events")
    if missing:
        fail(f"{leg}: missing artifacts {missing}")
    return dict(checkpoints=ckpts, metrics_lines=len(rows),
                tensorboard_events=len(events), test_preds=len(preds),
                export_bytes={e: (run / f"export_last.{e}").stat().st_size
                              for e in ("ply", "ingp", "usdz")})


def exported_frame(leg, tr, run, dev):
    """The train entry's export_last.ply read back through api.load_scene
    onto the card: its alive rows equal the trainer's, and its frame of the
    first test view is within golden.compare of the trainer's parameters'
    frame (the same particles without the dead slots; visibility, over
    other slots, is not compared)."""
    from threedgrut_torch import api, golden
    from threedgrut_torch.export import alive_rows
    t0 = time.perf_counter()
    back = api.load_scene(str(run / "export_last.ply"), device=dev)
    read_s = time.perf_counter() - t0
    want, got = alive_rows(tr.params), alive_rows(back)
    unequal = [k for k in want if not np.array_equal(want[k], got[k])]
    view = tr.val_dataset[0]
    frames = []
    for p in (tr.params, back):
        with torch.no_grad():
            out, _ = render_retry(api, p, view.camera, view.T_to_world,
                                  view.resolution, tr.isect_capacity, dev)
        frames.append(frame_of(out))
    rep, ok = golden.compare(frames[1], frames[0])
    rec = dict(read_s=read_s, alive=int(back.num_active()),
               capacity=back.capacity, unequal=unequal, frame=rep,
               frame_bit_equal=all(torch.equal(frames[0][k], frames[1][k])
                                   for k in golden.FLIP_BOUND))
    if unequal or not ok:
        fail(f"{leg}: export_last.ply read back differs: {json.dumps(rec)}")
    return rec


def render_leg(leg, ckpt, out_dir, dev, kernels, n_views):
    """threedgrut_torch.render's entry on a checkpoint (the test split),
    its launches read around it. Fails unless it rendered every view with
    the forward kernels, wrote one pred_*.png per view, and no view
    overflowed."""
    from threedgrut_torch.ops import cuda_build
    from threedgrut_torch.render import __main__ as render_entry
    cuda_build.launches.clear()
    summary = render_entry.run(["--checkpoint", str(ckpt), "--out-dir",
                                str(out_dir), "--device", str(dev)])
    launches = dict(cuda_build.launches)
    preds = list(out_dir.glob("pred_*.png"))
    fwd = [k for k in kernels if cuda_build.KERNELS[k][2] == "forward"]
    if (summary["n_frames"] != n_views or len(preds) != n_views
            or summary["overflow_views"]
            or any(launches.get(k, 0) < n_views for k in fwd)
            or not math.isfinite(summary["psnr"])):
        fail(f"{leg} render entry: {summary}, {len(preds)} preds, "
             f"launches {launches}")
    return summary, launches


def step_copy(tr, device):
    """A strategy-free trainer on `device` with a copy of `tr`'s parameters
    and Adam state, at its step and capacity, with f32 gradients (as phase
    4's parity)."""
    from threedgrut_torch.optimizers import AdamState
    from threedgrut_torch.trainer import Trainer
    cfg = copy.deepcopy(tr.cfg)
    cfg.render.low_precision_grads = False
    t = Trainer(cfg, tr.dataset, params=copy_gaussians(tr.params, device),
                device=device)
    t.opt_state = AdamState(
        step=tr.opt_state.step,
        exp_avg={k: v.to(device, copy=True)
                 for k, v in tr.opt_state.exp_avg.items()},
        exp_avg_sq={k: v.to(device, copy=True)
                    for k, v in tr.opt_state.exp_avg_sq.items()})
    t.global_step, t.isect_capacity = tr.global_step, tr.isect_capacity
    t.scene_extent = tr.scene_extent
    return t


def entry_step_parity(leg, tr, view, dev, tag):
    """One train step of the trainer that the entry point built, on the
    card and on the CPU from the same parameters, Adam state and view
    (strategy off), within step_agreement's tolerances."""
    t0 = time.time()
    tg, tc = step_copy(tr, dev), step_copy(tr, torch.device("cpu"))
    ag, ac = tg.train_step(view), tc.train_step(view)
    rep_s = time.time() - t0
    rep, ok = step_agreement(tg, ag, tc, ac)
    w, h = view.resolution
    print(f"{leg}: train step card vs CPU at {w}x{h} "
          f"({type(view.camera).__name__}, shutter {int(view.shutter)}), "
          f"{int(tr.params.num_active())} particles ({rep_s:.1f} s): "
          f"{json.dumps(rep)} {tag}", flush=True)
    if not ok or bool(ag["overflow"]):
        fail(f"{leg}: the train step on the card disagrees with the plain "
             f"path at {w}x{h}")
    return rep


def decode_record(paths, n=8):
    """Mean ms to decode one frame (the loader's decoder, no prefetch)
    over the first n of `paths`, and the decoder's name."""
    from threedgrut_torch.datasets import native_loader
    from threedgrut_torch.native import build_error
    loader = native_loader.ImageLoader(n_threads=8)
    loader.decode(str(paths[0]))
    t0 = time.perf_counter()
    for p in paths[:n]:
        loader.decode(str(p))
    ms = (time.perf_counter() - t0) * 1e3 / min(n, len(paths))
    loader.close()
    return dict(decoder=native_loader.decoder_name(), decode_ms=ms,
                native_build_error=(build_error() or "")[:200] or None)


def h2d_ms(view, dev, iters=20):
    """Host ms of the trainer's pageable host-to-device copy of one ground-
    truth frame (torch.as_tensor from numpy), each ended by a
    synchronize."""
    torch.as_tensor(view.rgb_gt, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        torch.as_tensor(view.rgb_gt, dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def data_entry_points(dev, tag, extra=None):
    """Phase 6c: the data, entry-point and eval layer at full width. The
    scenes are written into a temporary directory from the seeded ground
    truth scene and the port's own renders. Legs: (a) the
    nerf_synthetic_3dgut preset through `python -m threedgrut_torch.train`
    on a lego-shaped NeRF scene (GS on a compressed schedule), the render
    entry on its test split, and a resume from its step-100 checkpoint
    that densifies again (C11); (b) colmap_3dgut_mcmc on a Mip-NeRF
    360-shaped COLMAP scene at images_4 (1237x822, OPENCV distortion), and
    one of its train steps card vs CPU; (c) nerf_synthetic_3dgrt on (a)'s
    files and the render entry with the 3DGRT eval overrides; (d) the
    multi-sensor MCMC acceptance run at 800x800, the render entry
    rebuilding its scene, and a fisheye rolling-shutter train step card vs
    CPU. `extra(nerf_dir, runs_dir)`, where given, runs last on (a)'s files
    (phase 6d(c)), outside the phase's wall. Returns the legs' records."""
    import tempfile
    from threedgrut_torch import datasets
    from threedgrut_torch.ops import cuda_build
    from threedgrut_torch.render_eval import Renderer
    t_phase = time.time()
    recs = []
    gut, grt = cuda_build.kernels_of("gut"), cuda_build.kernels_of("grt")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        tmp = Path(tmp)
        fields, params = gt_scene(dev)
        nerf, col, runs = tmp / "nerf", tmp / "colmap", tmp / "runs"
        write_s = write_nerf_scene(nerf, params, dev)
        write_s += write_colmap_scene(col, fields, params, dev)
        del params
        print(f"phase 6c scenes written in {write_s:.1f} s: {nerf} "
              f"({NERF_VIEWS} views, {NERF_RES}x{NERF_RES} RGBA), {col} "
              f"({COLMAP_IMAGES} images at 1/{COLMAP_DOWN} of "
              f"{COLMAP_SIZE}, {COLMAP_POINTS} points)", flush=True)
        dec = decode_record(sorted((nerf / "train").glob("r_*.png")))
        print(f"decode ({NERF_RES}x{NERF_RES} RGBA PNG): {json.dumps(dec)}",
              flush=True)
        dev_arg = ["--device", str(dev)]

        # (a) NeRF-synthetic, GS, as a user runs it on lego.
        sch = nerf_schedule(NERF_ITERS)
        gs_ov = [f"strategy.densify_start={sch['start']}",
                 f"strategy.densify_frequency={sch['freq']}",
                 f"strategy.densify_end={sch['end']}",
                 f"strategy.reset_density_frequency={sch['reset']}"]
        leg = "6c(a) nerf_synthetic_3dgut"
        tr, summ, la, rec = run_leg(leg, dev_arg + [
            "--config-name", "nerf_synthetic_3dgut", f"path={nerf}",
            f"out_dir={runs}", "experiment_name=nerf",
            f"train.iterations={NERF_ITERS}",
            f"train.val_frequency={sch['val']}",
            f"train.checkpoint_iterations=[{sch['ckpt']}]"] + gs_ov,
            NERF_ITERS, gut, tag)
        rec["alive_before"] = 100_000
        rec["artifacts"] = check_run_dir(
            leg, runs / "nerf", [f"ckpt_{sch['ckpt']}", "ckpt_last"],
            list(range(100, NERF_ITERS + 1, 100)),
            list(range(sch["val"], NERF_ITERS + 1, sch["val"])),
            NERF_VIEWS[1])
        rec["export"] = exported_frame(leg, tr, runs / "nerf", dev)
        rec["decode"] = dec
        rec["h2d_ms_per_frame"] = h2d_ms(tr.dataset[0], dev)
        rec["h2d_share_of_step"] = (rec["h2d_ms_per_frame"]
                                    / rec["step_ms_median_after_first_epoch"])
        densify_events = [s for s, e in rec["events"].items() if "clone" in e]
        if densify_events != list(range(sch["start"], NERF_ITERS,
                                        sch["freq"])):
            fail(f"{leg}: densify events at {densify_events}")
        del tr
        ev_summary, ev_launches = render_leg(
            leg, runs / "nerf" / "ckpt_last.npz", tmp / "eval_nerf", dev,
            gut, NERF_VIEWS[1])
        rec["eval"], rec["eval_launches"] = ev_summary, ev_launches
        # The resume (C11): the strategy and its state come back from the
        # checkpoint, and densification goes on.
        ckpt = runs / "nerf" / f"ckpt_{sch['ckpt']}.npz"
        with np.load(ckpt) as data:
            saved = {k: data[k] for k in data.files
                     if k.startswith("strategy/")}
        tr2, _, lr, rec2 = run_leg(leg + " resume", dev_arg + [
            "--config-name", "nerf_synthetic_3dgut", f"path={nerf}",
            f"out_dir={runs}", "experiment_name=nerf_resume",
            f"resume={ckpt}", f"train.iterations={sch['resume']}",
            "train.val_frequency=0"] + gs_ov, sch["resume"], gut, tag)
        resumed_events = {s: e for s, e in rec2["events"].items()
                          if "clone" in e}
        if (type(tr2.strategy).__name__ != "GSStrategy"
                or set(saved) != {"strategy/grad_accum",
                                  "strategy/grad_denom",
                                  "strategy/rolling_vis"}
                or not resumed_events):
            fail(f"{leg} resume: strategy {type(tr2.strategy).__name__}, "
                 f"saved keys {sorted(saved)}, events {rec2['events']}")
        rec["resume"] = dict(from_step=sch["ckpt"], steps=sch["resume"],
                             restored_keys=sorted(saved),
                             densify_events=resumed_events,
                             alive_after=rec2["alive_after"],
                             step_ms=rec2["step_ms_median_after_first_epoch"],
                             launches=lr)
        del tr2
        recs.append(rec)
        print(f"{leg}: {json.dumps(rec)} {tag}", flush=True)

        # (b) COLMAP, MCMC, at images_4 with OPENCV distortion.
        leg = "6c(b) colmap_3dgut_mcmc"
        q = COLMAP_ITERS // 4
        tr, summ, lb, rec = run_leg(leg, dev_arg + [
            "--config-name", "colmap_3dgut_mcmc", f"path={col}",
            f"out_dir={runs}", "experiment_name=colmap",
            f"dataset.downsample_factor={COLMAP_DOWN}",
            f"train.iterations={COLMAP_ITERS}",
            f"train.val_frequency={COLMAP_ITERS}",
            f"strategy.densify_start={q}", f"strategy.mcmc_add_frequency={q}",
            f"strategy.densify_end={COLMAP_ITERS}"], COLMAP_ITERS, gut, tag)
        rec["alive_before"] = COLMAP_POINTS
        rec["resolution"] = list(tr.dataset[0].resolution)
        rec["artifacts"] = check_run_dir(
            leg, runs / "colmap", ["ckpt_last"],
            list(range(100, COLMAP_ITERS + 1, 100)), [COLMAP_ITERS],
            len(tr.val_dataset))
        mcmc_events = sorted(s for s, e in rec["events"].items()
                             if "relocate" in e)
        if mcmc_events != list(range(q, COLMAP_ITERS, q)):
            fail(f"{leg}: MCMC events at {mcmc_events}")
        rec["parity"] = entry_step_parity(leg, tr, tr.dataset[1], dev, tag)
        del tr
        recs.append(rec)
        print(f"{leg}: {json.dumps(rec)} {tag}", flush=True)

        # (c) 3DGRT on (a)'s files, then its eval overrides.
        leg = "6c(c) nerf_synthetic_3dgrt"
        tr, summ, lc, rec = run_leg(leg, dev_arg + [
            "--config-name", "nerf_synthetic_3dgrt", f"path={nerf}",
            f"out_dir={runs}", "experiment_name=grt",
            f"train.iterations={GRT_ENTRY_ITERS}", "train.val_frequency=0"],
            GRT_ENTRY_ITERS, grt, tag)
        rec["alive_before"] = 100_000
        rec["artifacts"] = check_run_dir(leg, runs / "grt", ["ckpt_last"],
                                         [], [], NERF_VIEWS[1])
        del tr
        ckpt = runs / "grt" / "ckpt_last.npz"
        rcfg = Renderer.from_checkpoint(
            str(ckpt), datasets.make("nerf", str(nerf), split="test"),
            device=dev).trainer.cfg.render
        rec["eval_overrides"] = dict(
            min_transmittance=rcfg.min_transmittance,
            density_clamping=rcfg.particle_kernel_density_clamping)
        if rcfg.min_transmittance != 0.03 \
                or not rcfg.particle_kernel_density_clamping:
            fail(f"{leg}: eval overrides {rec['eval_overrides']}")
        rec["eval"], rec["eval_launches"] = render_leg(
            leg, ckpt, tmp / "eval_grt", dev, grt, NERF_VIEWS[1])
        recs.append(rec)
        print(f"{leg}: {json.dumps(rec)} {tag}", flush=True)

        # (d) the multi-sensor MCMC acceptance run at full width.
        leg = "6c(d) multi-sensor nerf_synthetic_3dgut_mcmc"
        tr, summ, ld, rec = run_leg(leg, dev_arg + [
            "--config-name", "nerf_synthetic_3dgut_mcmc",
            "dataset.type=synthetic", "dataset.synthetic_multi_sensor=True",
            f"dataset.synthetic_resolution={MS_RES}",
            f"dataset.synthetic_views={MS_VIEWS}",
            f"train.iterations={MS_ITERS}",
            f"train.val_frequency={MS_ITERS}",
            f"out_dir={runs}", "experiment_name=multi_sensor"],
            MS_ITERS, gut, tag)
        rec["alive_before"] = 100_000
        rec["artifacts"] = check_run_dir(
            leg, runs / "multi_sensor", ["ckpt_last"],
            list(range(100, MS_ITERS + 1, 100)), [MS_ITERS], MS_VIEWS)
        view = tr.dataset[3]
        if type(view.camera).__name__ != "FisheyeCamera" \
                or int(view.shutter) != 1 or view.mask is None:
            fail(f"{leg}: view 3 is not the fisheye rolling-shutter view")
        rec["parity"] = entry_step_parity(leg, tr, view, dev, tag)
        del tr
        rec["eval"], rec["eval_launches"] = render_leg(
            leg, runs / "multi_sensor" / "ckpt_last.npz",
            tmp / "eval_ms", dev, gut, MS_VIEWS)
        recs.append(rec)
        print(f"{leg}: {json.dumps(rec)} {tag}", flush=True)
        extra_s = 0.0
        if extra is not None:
            t_extra = time.time()
            extra(nerf, runs)
            extra_s = time.time() - t_extra
    print(f"phase 6c (data, entry points and eval) wall "
          f"{time.time() - t_phase - extra_s:.1f} s", flush=True)
    return recs


def orbit_T(k: int) -> np.ndarray:
    from threedgrut_torch.cameras import look_at
    a = 0.1 * k
    eye = np.array([4.0 * math.sin(a), -4.0 * math.cos(a), 1.0], np.float32)
    return look_at(eye, np.zeros(3, np.float32),
                   np.array([0.0, 0.0, 1.0], np.float32))


def render_retry(api, params, cam, T, res, cap, dev, **kw):
    """api.render with the trainer's grow-and-retry on overflow."""
    from threedgrut_torch.cameras import pose_from_matrix
    Tt = torch.as_tensor(T, device=dev)
    for _ in range(8):
        out, overflow = api.render(params, cam, pose_from_matrix(Tt), res,
                                   isect_capacity=cap, device=dev, **kw)
        if not bool(overflow):
            return out, cap
        cap *= 2
        print(f"isect overflow: capacity -> {cap}", flush=True)
    fail("overflow persists after 8 doublings")


# ---- phase 6d: multi-device training on the one card -----------------------

# (a) DPTrainer at (1, 1, 1) under NCCL (a world of one) against phase 6's
# Trainer, step by step; (b) meshes of ranks sharing cuda:0 over gloo (NCCL
# takes one rank per card), the steps of each; (c) the train entry's
# --multichip on 6c(a)'s NeRF scene.
MESH_PARITY_STEPS = 6
MESH_STEPS = 3
MESH_WORLDS = {2: ((1, 2, 1), (2, 1, 1)), 4: ((1, 2, 2),)}
MESH_ENTRY_SHAPE = "1,2,1"
MESH_ENTRY_ITERS = 20
# tests/test_parallel.py's tolerance of a mesh gradient: 2e-4 max|g| + 5e-8.
MESH_GRAD_RTOL, MESH_GRAD_ATOL = 2e-4, 5e-8


def mesh_sizes() -> dict:
    """The mesh phase's sizes (passed to its ranks): phase 6's."""
    return dict(n=MAIN_N, res=MAIN_RES, cap=MAIN_CAP, steps=MESH_STEPS)


def mesh_views(dev, res):
    """The data mesh's views: bench.py's camera and orbit_T(2) at `res`,
    zero ground truth (view 0 is the others' only view)."""
    from threedgrut_torch.cameras import example_camera, look_at
    from threedgrut_torch.datasets.protocols import View
    gt = np.zeros((res[1], res[0], 3), np.float32)
    T0 = look_at(np.array([0.0, -4.0, 1.0], np.float32),
                 np.zeros(3, np.float32), np.array([0.0, 0.0, 1.0],
                                                   np.float32))
    return [View(T_to_world=T, camera=example_camera(res, dev),
                 resolution=res, rgb_gt=gt) for T in (T0, orbit_T(2))]


def mesh_config(cap):
    """phase 6's configuration (train_setup's): Config() at capacity `cap`,
    SH degree 3 from the first step."""
    from threedgrut_torch.config import Config
    cfg = Config()
    cfg.render.isect_capacity = cap
    cfg.model.progressive_sh_interval = 0
    return cfg


def state_digest(tr) -> str:
    """A digest of a trainer's parameters and Adam moments, taken on the
    device: per tensor the sums of its 32-bit words and of the words times
    odd position weights (any one changed bit changes it)."""
    import hashlib
    from threedgrut_torch import optimizers
    from threedgrut_torch.model.gaussians import FIELDS
    parts = []
    tensors = ([getattr(tr.params, f) for f in FIELDS]
               + [tr.opt_state.exp_avg[f] for f in optimizers.PARAM_FIELDS]
               + [tr.opt_state.exp_avg_sq[f]
                  for f in optimizers.PARAM_FIELDS])
    with torch.no_grad():
        for t in tensors:
            t = t.detach().contiguous().reshape(-1)
            w = (t.to(torch.int64) if t.dtype == torch.bool
                 else t.view(torch.int32).to(torch.int64))
            k = torch.arange(w.numel(), device=w.device, dtype=torch.int64)
            parts += [w.sum(), (w * (2 * k + 1)).sum()]
            del w, k
    return hashlib.sha256(torch.stack(parts).cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def mesh_reference(tr, views):
    """The single-process gradient of a mesh step from the trainer's current
    parameters: Trainer's step_fn on copies, the mean over `views`."""
    from threedgrut_torch import optimizers
    from threedgrut_torch.trainer import step_fn
    total = None
    for v in views:
        p = copy.deepcopy(tr.params)
        opt = optimizers.AdamState(
            tr.opt_state.step,
            {k: x.clone() for k, x in tr.opt_state.exp_avg.items()},
            {k: x.clone() for k, x in tr.opt_state.exp_avg_sq.items()})
        T, cam, gt, mask, shutter, T_end = tr._view_tensors(v)
        _, aux = step_fn(p, opt, T, cam, gt, mask, tr.scene_extent,
                         v.resolution, tr.active_sh_degree(), tr.cfg,
                         train=True, shutter=shutter, T_end=T_end,
                         isect_capacity=tr.isect_capacity)
        g = aux["grads"]
        total = g if total is None else {f: total[f] + g[f] for f in g}
        del p, opt, aux
    return {f: x / len(views) for f, x in total.items()}


def gloo_cuda_collectives(dev) -> dict:
    """Which torch.distributed collectives gloo takes for tensors on `dev`
    (cuda:0) here: each tried once on a small int32 tensor in a group of its
    own (a 60 s timeout), "ok" or the error's first line."""
    import datetime
    import torch.distributed as dist
    world, rank = dist.get_world_size(), dist.get_rank()
    g = dist.new_group(backend="gloo",
                       timeout=datetime.timedelta(seconds=60))
    x = torch.arange(4 * world, dtype=torch.int32, device=dev) + rank
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=g),
        "broadcast": lambda: dist.broadcast(x.clone(), 0, group=g),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x, group=g),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(world * x.numel(), dtype=x.dtype, device=x.device),
            x, group=g),
        "reduce": lambda: dist.reduce(x.clone(), 0, group=g),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, dtype=x.dtype, device=x.device), x, group=g),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x, group=g),
        "barrier": lambda: dist.barrier(group=g),
    }
    out = {}
    for name, op in ops.items():
        try:
            op()
            sync(dev)
            out[name] = "ok"
        except Exception as e:     # noqa: BLE001 - recorded, not raised
            out[name] = (str(e).strip().splitlines() or ["error"])[0][:160]
    return out


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_rank(rank, shapes, probe, device, sizes):
    """A rank of 6d(b), on cuda:0 beside the others (gloo): bench.py's 1M
    scene, phase 6's configuration and camera (the data mesh's second view
    orbit_T(2)); for each mesh of `shapes` a DPTrainer takes MESH_STEPS
    steps from the scene's parameters. Per step: the host ms after a
    barrier (ranks time-sharing one card), the loss, this rank's launches
    and the tile counts of its B1 and B2 launches (the strip), the state's
    digest; on rank 0 also each field's largest difference from the
    single-process gradient (mesh_reference) and its bound. `probe`: first
    record gloo_cuda_collectives(). `device`: the ranks' device (cuda:0;
    the CPU in a rehearsal); `sizes`: mesh_sizes()."""
    import torch.distributed as dist
    from threedgrut_torch.model.gaussians import bench_scene, from_numpy
    from threedgrut_torch.ops import cuda_build, tile_raster
    from threedgrut_torch.parallel.trainer import DPTrainer
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {"collectives": gloo_cuda_collectives(dev) if probe else None}
    strips = []
    fwd, bwd = tile_raster._launch, tile_raster._launch_backward

    def count_fwd(*a, **k):
        strips.append(("B1", int(a[3].shape[0])))
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        strips.append(("B2", int(a[3].shape[0])))
        return bwd(*a, **k)

    tile_raster._launch, tile_raster._launch_backward = count_fwd, count_bwd
    fields = bench_scene(sizes["n"], seed=0)
    views = mesh_views(dev, sizes["res"])
    for shape in shapes:
        batch = views[:shape[0]]
        tr = DPTrainer(mesh_config(sizes["cap"]), OneView(views[0], 4.0),
                       params=from_numpy(fields, device=dev), device=dev,
                       mesh_shape=shape)
        steps = []
        for k in range(sizes["steps"]):
            step = {}
            if rank == 0:
                ref = mesh_reference(tr, batch)
            dist.barrier()
            strips.clear()
            cuda_build.launches.clear()
            sync(dev)
            t0 = time.perf_counter()
            aux = tr.train_step_batch(batch)
            sync(dev)
            step["ms"] = (time.perf_counter() - t0) * 1e3
            step["launches"] = dict(cuda_build.launches)
            step["strips"] = list(strips)
            step["loss"] = float(aux["terms"]["total"])
            step["overflow"] = bool(aux["overflow"])
            step["finite"] = all(bool(torch.isfinite(g).all())
                                 for g in aux["grads"].values())
            if rank == 0:
                step["grads"] = {
                    f: (float((aux["grads"][f] - ref[f]).abs().max()),
                        MESH_GRAD_RTOL * float(ref[f].abs().max())
                        + MESH_GRAD_ATOL) for f in ref}
                del ref
            step["digest"] = state_digest(tr)
            steps.append(step)
        rec[shape] = dict(steps=steps, coords=tr.mesh.coords, peak_gib=(
            torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else 0.0))
        del tr, aux
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rec


def mesh_one_rank(dev, tag, backend="nccl"):
    """6d(a): DPTrainer at (1, 1, 1) under NCCL (a world of one, its
    collectives run) against phase 6's Trainer.train_step from the same
    parameters, MESH_PARITY_STEPS steps in turns: loss, image, parameters
    and Adam's moments bit-equal after every step; the launch counts of
    the mesh's steps cleared before and read after each."""
    import torch.distributed as dist
    from threedgrut_torch import optimizers
    from threedgrut_torch.model.gaussians import FIELDS, bench_scene, \
        from_numpy
    from threedgrut_torch.ops import cuda_build
    from threedgrut_torch.parallel import multihost
    from threedgrut_torch.parallel.trainer import DPTrainer
    from threedgrut_torch.trainer import Trainer
    fields = bench_scene(MAIN_N, seed=0)
    views = mesh_views(dev, MAIN_RES)
    tr = Trainer(mesh_config(MAIN_CAP), OneView(views[0], 4.0),
                 params=from_numpy(fields, device=dev), device=dev)
    multihost.init_process_group(
        backend, f"127.0.0.1:{multihost.free_port()}", 1, 0)
    launches, ms, tr_ms = {}, [], []
    try:
        dtr = DPTrainer(mesh_config(MAIN_CAP), OneView(views[0], 4.0),
                        params=from_numpy(fields, device=dev), device=dev,
                        mesh_shape=(1, 1, 1))
        for k in range(MESH_PARITY_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = tr.train_step(views[0])
            torch.cuda.synchronize()
            tr_ms.append((time.perf_counter() - t0) * 1e3)
            before = dict(cuda_build.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b = dtr.train_step(views[0])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            step = {n: v - before.get(n, 0)
                    for n, v in cuda_build.launches.items()}
            for n, v in step.items():
                launches[n] = launches.get(n, 0) + v
            same = (float(a["terms"]["total"]) == float(b["terms"]["total"])
                    and torch.equal(a["pred"], b["pred"])
                    and all(torch.equal(getattr(tr.params, f),
                                        getattr(dtr.params, f))
                            for f in FIELDS)
                    and all(torch.equal(tr.opt_state.exp_avg[f],
                                        dtr.opt_state.exp_avg[f])
                            and torch.equal(tr.opt_state.exp_avg_sq[f],
                                            dtr.opt_state.exp_avg_sq[f])
                            for f in optimizers.PARAM_FIELDS))
            print(f"6d(a) step {k + 1}: DPTrainer (1, 1, 1) under NCCL vs "
                  f"Trainer: loss {float(b['terms']['total']):.6f} / "
                  f"{float(a['terms']['total']):.6f}, bit-equal (loss, "
                  f"image, parameters, moments) {same}; mesh step "
                  f"{ms[-1]:.3f} ms (Trainer's {tr_ms[-1]:.3f}), launches "
                  f"{step} {tag}", flush=True)
            if not same:
                fail(f"6d(a): DPTrainer at (1, 1, 1) differs from Trainer "
                     f"at step {k + 1}")
            if step.get("tile_raster_fwd") != 1 \
                    or step.get("tile_raster_bwd") != 1:
                fail(f"6d(a) step {k + 1} launched {step}")
    finally:
        dist.destroy_process_group()
    print(f"6d(a): step ms, median of steps 2-{MESH_PARITY_STEPS}: mesh "
          f"(1, 1, 1) {float(np.median(ms[1:])):.3f}, Trainer "
          f"{float(np.median(tr_ms[1:])):.3f} {tag}", flush=True)
    del tr, dtr
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=ms, trainer_step_ms=tr_ms)


def mesh_ranks(tag, device="cuda:0"):
    """6d(b): the meshes of MESH_WORLDS, each world of processes sharing
    cuda:0 over gloo (multihost.spawn). Fails unless every rank ends every
    step with the same state digest, no step overflows or gives a value
    that is not finite, rank 0's gradients are within MESH_GRAD_RTOL
    max|g| + MESH_GRAD_ATOL of the single-process step's (the mean of the
    two views' at (2, 1, 1)), and every rank launched B1 and B2 once a step
    on a strip of 2,500 / T tiles. Returns {mesh: launches per rank}."""
    from threedgrut_torch.parallel import multihost
    tiles = -(-MAIN_RES[0] // 16) * -(-MAIN_RES[1] // 16)
    launches, probe = {}, True
    for world, shapes in MESH_WORLDS.items():
        t0 = time.time()
        recs = multihost.spawn(mesh_rank, world,
                               args=(shapes, probe, device, mesh_sizes()),
                               backend="gloo", timeout=900)
        wall = time.time() - t0
        if probe:
            print(f"6d(b) gloo on CUDA tensors (torch "
                  f"{torch.__version__}): {json.dumps(recs[0]['collectives'])}",
                  flush=True)
            probe = False
        for shape in shapes:
            strip = tiles // shape[1]
            per_rank = [r[shape] for r in recs]
            for k in range(len(per_rank[0]["steps"])):
                st = [p["steps"][k] for p in per_rank]
                digests = {s["digest"] for s in st}
                g = st[0]["grads"]
                worst = max(d / b for d, b in g.values())
                ok_strips = all(
                    s["strips"] == [("B1", strip), ("B2", strip)]
                    and s["launches"].get("tile_raster_fwd") == 1
                    and s["launches"].get("tile_raster_bwd") == 1
                    for s in st)
                print(f"6d(b) mesh {shape} step {k + 1}: loss "
                      f"{st[0]['loss']:.6f}; ms per rank (ranks "
                      f"time-sharing one card, not a scaling figure) "
                      f"{[round(s['ms'], 3) for s in st]}; gradient vs the "
                      f"single-process step: largest |diff| / bound "
                      f"{worst:.4f} ({json.dumps(g)}); state digests "
                      f"{sorted(digests)}; B1/B2 strips of {strip} tiles "
                      f"{ok_strips}; rank 0 launches {st[0]['launches']} "
                      f"{tag}", flush=True)
                if len(digests) != 1:
                    fail(f"6d(b) {shape} step {k + 1}: the ranks' states "
                         f"differ ({digests})")
                if worst > 1.0:
                    fail(f"6d(b) {shape} step {k + 1}: gradients outside "
                         f"the tolerance ({g})")
                if not ok_strips or any(s["overflow"] or not s["finite"]
                                        for s in st):
                    fail(f"6d(b) {shape} step {k + 1}: strips "
                         f"{[s['strips'] for s in st]}, launches "
                         f"{[s['launches'] for s in st]}, overflow or a "
                         f"value not finite")
            launches[str(shape)] = [
                {n: sum(s["launches"].get(n, 0) for s in p["steps"])
                 for n in p["steps"][0]["launches"]} for p in per_rank]
            print(f"6d(b) mesh {shape}: coords "
                  f"{[p['coords'] for p in per_rank]}, peak memory per "
                  f"rank {[round(p['peak_gib'], 3) for p in per_rank]} GiB",
                  flush=True)
        print(f"6d(b) world of {world} ranks on cuda:0: wall {wall:.1f} s "
              f"(spawn included)", flush=True)
    return launches


def mesh_entry_leg(nerf, runs, tag):
    """6d(c): `python -m threedgrut_torch.train --multichip 1,2,1
    --dist-backend gloo` on 6c(a)'s NeRF scene, MESH_ENTRY_ITERS steps:
    the run ends 0, rank 0 writes the checkpoint, the export and the test
    renders, and each rank's printed launches show B1 and B2 (B2 once a
    step). Returns its record."""
    from threedgrut_torch.ops import cuda_build
    argv = [sys.executable, "-m", "threedgrut_torch.train", "--multichip",
            MESH_ENTRY_SHAPE, "--dist-backend", "gloo", "--device", "cuda",
            "--config-name", "nerf_synthetic_3dgut", f"path={nerf}",
            f"out_dir={runs}", "experiment_name=mesh",
            f"train.iterations={MESH_ENTRY_ITERS}", "train.val_frequency=0"]
    t0 = time.time()
    r = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    wall = time.time() - t0
    out = r.stdout + r.stderr
    if r.returncode != 0:
        print(out[-6000:], flush=True)
        fail(f"6d(c): the --multichip train entry exited {r.returncode}")
    ranks = {int(m.group(1)): json.loads(m.group(3)) for m in re.finditer(
        r"mesh rank (\d+) of (\d+): launches (\{[^{}]*\})", out)}
    steps = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"mesh rank (\d+) of \d+: host step ms median ([\d.]+)", out)}
    run = Path(runs) / "mesh"
    missing = [f for f in ("ckpt_last.npz", "export_last.ply",
                           "export_last.ingp", "export_last.usdz")
               if not (run / f).exists()]
    test = re.search(r"final test: (\{.*\})", out)
    bad = {rk: l for rk, l in ranks.items()
           if l.get("tile_raster_bwd") != MESH_ENTRY_ITERS
           or l.get("tile_raster_fwd", 0) < MESH_ENTRY_ITERS
           or l.get("cull_masks", 0) < MESH_ENTRY_ITERS}
    rec = dict(wall_s=wall, launches=ranks, step_ms_median=steps,
               test=json.loads(test.group(1)) if test else None)
    print(f"6d(c) --multichip {MESH_ENTRY_SHAPE} --dist-backend gloo, "
          f"{MESH_ENTRY_ITERS} steps on 6c(a)'s scene: {json.dumps(rec)}, "
          f"wall {wall:.1f} s {tag}", flush=True)
    if sorted(ranks) != [0, 1] or bad or missing or test is None:
        print(out[-6000:], flush=True)
        fail(f"6d(c): ranks {sorted(ranks)}, launches {bad}, missing "
             f"{missing}, test summary {test is not None}")
    return rec


def multi_device(dev, tag, entry_rec):
    """Phase 6d (its (c) ran at the end of 6c, on 6c(a)'s files: entry_rec).
    Returns {"a": ..., "b": launches per mesh and rank, "c": entry_rec}."""
    t0 = time.time()
    torch.cuda.empty_cache()
    rec = {"a": mesh_one_rank(dev, tag)}
    t_a = time.time() - t0
    rec["b"] = mesh_ranks(tag)
    rec["c"] = entry_rec
    print(f"phase 6d wall: (a) {t_a:.1f} s, (b) {time.time() - t0 - t_a:.1f}"
          f" s, (c) {entry_rec['wall_s']:.1f} s", flush=True)
    return rec


def train_main_path(dev, tag, cfg=None, mode="default"):
    """TRAIN_STEPS Trainer.train_step calls at full width on bench.py's
    scene (no specular), camera, zero ground truth and Config() defaults
    (or `cfg`, named `mode`); the last step takes the dense branch
    (walk_compact_fraction=0, B5). Fails unless every value is finite, no
    step overflows, every step launched B1 and B2 once, the loss falls from
    the first step to the last, and every kernel was launched."""
    from threedgrut_torch.model.gaussians import bench_scene
    from threedgrut_torch.ops import cuda_build
    gt = np.zeros((MAIN_RES[1], MAIN_RES[0], 3), np.float32)
    fields = bench_scene(MAIN_N, seed=0)
    base = phase_start()
    tr, view = train_setup(fields, MAIN_RES, MAIN_CAP, gt, dev, cfg=cfg)
    cuda_build.launches.clear()
    step_ms, losses = [], []
    for k in range(TRAIN_STEPS):
        if k == TRAIN_STEPS - 1:
            tr.cfg.render.walk_compact_fraction = 0.0
        before = dict(cuda_build.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = tr.train_step(view)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(aux["terms"]["total"]))
        step = {n: v - before.get(n, 0)
                for n, v in cuda_build.launches.items()}
        finite = all(bool(torch.isfinite(x).all()) for x in
                     [aux["pred"], *aux["grads"].values(),
                      *(getattr(tr.params, f) for f in aux["grads"])])
        if not (finite and math.isfinite(losses[-1])):
            fail(f"train step {k + 1} ({mode}): a value is not finite")
        if bool(aux["overflow"]):
            fail(f"train step {k + 1} ({mode}) overflowed its capacity")
        if (step.get("tile_raster_fwd") != 1
                or step.get("tile_raster_bwd") != 1):
            fail(f"train step {k + 1} ({mode}) launched {step}")
        print(f"train step {k + 1} ({mode}): loss {losses[-1]:.6f} psnr "
              f"{float(aux['psnr']):.4f} visible "
              f"{int(aux['visibility'].sum())} {step_ms[-1]:.3f} ms "
              f"walk_compact_fraction "
              f"{tr.cfg.render.walk_compact_fraction} overflow False "
              f"{tag}", flush=True)
    tr.cfg.render.walk_compact_fraction = 0.625
    launches = dict(cuda_build.launches)
    peak = phase_peak_gib(base)
    print(f"train main path ({mode}) launches: {launches}", flush=True)
    for kname in cuda_build.kernels_of("gut"):
        if launches.get(kname, 0) <= 0:
            fail(f"kernel {kname} was not launched on the train main path "
                 f"({mode})")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall ({mode}): {losses}")
    ms = float(np.median(step_ms[1:5]))
    rays_s = MAIN_RES[0] * MAIN_RES[1] / (ms / 1e3)
    print(f"train step ms ({mode}, median of steps 2-5): {ms:.3f}; rays/s "
          f"{rays_s:.4e}; max_memory_allocated {peak:.3f} GiB {tag}",
          flush=True)
    print(json.dumps({
        "metric": "rays_per_s_fwd_bwd_1M_gaussians", "value": rays_s,
        "unit": "rays/s/chip", "vs_baseline": rays_s / BASELINE_RAYS_PER_S,
        "backend": "cuda", "device": torch.cuda.get_device_name(0),
        "mode": mode, "n_gaussians": MAIN_N, "resolution": list(MAIN_RES),
        "iters": 4, "isect_capacity": tr.isect_capacity,
        "isect_overflow": False, "step_ms": ms,
        "max_memory_allocated_gib": peak}), flush=True)
    return tr, view, launches, dict(step_ms=ms, rays_per_s=rays_s,
                                    peak_gib=peak)


def b1_agrees(ko, po):
    """B1's tolerance against its plain version: rows 0-5 within 2e-4 +
    1e-4 |plain|, hit counts off by at most 1 on at most 0.1% of the
    pixels. Returns (ok, |kernel - plain|)."""
    d = (ko - po).abs()
    within = bool((d[:, 0:6] <= 2e-4 + 1e-4 * po[:, 0:6].abs()).all())
    dh = d[:, 6]
    hits_ok = float(dh.max()) <= 1 and int((dh > 0).sum()) <= max(
        1, math.floor(1e-3 * dh.numel()))
    return within and hits_ok, d


def b2_agrees(k2, p2):
    """B2's tolerance against its plain version: within 1e-5 x each
    column's max, the same nonzero slots. Returns (ok, |kernel - plain|,
    the column maxima)."""
    d2 = (k2 - p2).abs()
    col = p2.abs().amax(0)
    within = bool((d2 <= 1e-5 * col + 1e-30).all())
    return (torch.equal(k2.abs().sum(1) > 0, p2.abs().sum(1) > 0)
            and within), d2, col


def per_pixel_origins(fwd, g_out, tag):
    """B1 and B2's default legs on the train inputs with every ray's
    origin nudged on its own (1e-5 x a seeded normal draw), so no tile's
    rays share an origin and the kernels take the per-pixel form of the
    pair (the main paths take the per-row one): against their plain
    versions at the default legs' tolerances, and timed (B1 writing the
    live-row mask, B2 re-walking it) beside the shared-origin form, with
    their bounds on the nudged inputs' work (the pair's per-row part once
    per pair there)."""
    from threedgrut_torch.ops import tile_raster
    data, starts, ends, rays = fwd[:4]
    gen = torch.Generator(rays.device).manual_seed(5)
    nudged = rays.clone()
    nudged[:, 0:3] += 1e-5 * torch.randn(rays[:, 0:3].shape,
                                         device=rays.device, generator=gen)
    times = {}
    for form, r in (("shared", rays), ("per_pixel", nudged)):
        f = (data, starts, ends, r) + fwd[4:]
        mask = tile_raster.order_buffer(starts, ends, data.shape[0],
                                        tile_raster.walk_words(0))
        ko, _ = tile_raster._launch(*f, True, False, order=mask)
        times[f"b1_{form}"] = cuda_ms(
            lambda: tile_raster._launch(*f, False, False, order=mask), 10)
        b2_in = f[:4] + (ko, g_out) + f[4:] + (True,)
        k2 = tile_raster._launch_backward(*b2_in, order=mask)
        times[f"b2_{form}"] = cuda_ms(
            lambda: tile_raster._launch_backward(*b2_in, order=mask), 10)
        if form == "shared":
            continue
        stats = {}
        po, _ = tile_raster.tile_composite_plain(*f, True, False,
                                                 stats=stats)
        b1_bound, b2_bound = default_bounds(
            r.shape[0], int(ko[:, 7, 0].sum()), walked_windows(ko, starts),
            stats)
        times.update(b1_per_pixel_bound_ms=b1_bound[0],
                     b2_per_pixel_bound_ms=b2_bound[0])
        ok1, d = b1_agrees(ko, po)
        ok2, d2, _ = b2_agrees(
            k2, tile_raster.tile_composite_backward_plain(*b2_in))
        print(f"per-pixel origins: B1 per-row max |kernel - plain| "
              f"{d.amax(dim=(0, 2)).tolist()}; B2 max |kernel - plain| "
              f"{float(d2.max()):.3e}", flush=True)
        if not (ok1 and ok2):
            fail("B1/B2 with per-pixel origins disagree with their plain "
                 "versions")
    print(f"per-pixel origins vs shared origin (ms): {json.dumps(times)} "
          f"{tag}", flush=True)
    return times


def backward_records(tr, view, launches, tag, ptxas):
    """B2, B5 and B6 against their plain versions on the card, on the
    inputs the train main path gives them: the compositor's output
    cotangent of the loss at full width, B2's per-slot gradients (on B1's
    live-row mask, as the train step runs it; bit-equal to B2 given none,
    whose wrapper runs B1 for it), and the unsorted rows of the dense (B5)
    and compact (B6) branches; then B1 and B2 with per-pixel origins."""
    from threedgrut_torch.model import losses
    from threedgrut_torch.ops import (fused_raster, segment_sum, sorted_gather,
                                      tile_raster)
    from threedgrut_torch.render import gut
    from threedgrut_torch.trainer import render_params, walk_capacity_for
    from threedgrut_torch.cameras import pose_from_matrix
    dev = tr.device
    cap, res = tr.isect_capacity, view.resolution
    cam = view.camera
    pose = pose_from_matrix(torch.as_tensor(view.T_to_world, device=dev))
    gt = torch.as_tensor(view.rgb_gt, device=dev)
    with torch.no_grad():
        _, binning, packed, grid = gut.prepare_packed(
            *render_params(tr.params), cam, pose, res, cap)
        n = packed.shape[0]
        idx = binning.sorted_particle_idx
        data = packed[torch.clamp(idx, max=n - 1).long()]
        rays = gut.packed_world_rays(cam, pose, grid)
    fwd = (data, binning.tile_starts, binning.tile_ends, rays, 2, 1e-4,
           0.0113, 1.0 / 255.0, 0.99, False)
    # As the train step runs them: B1 writes the live-row mask, B2 reads it.
    mask = tile_raster.order_buffer(binning.tile_starts, binning.tile_ends,
                                    cap, tile_raster.walk_words(0))
    out, _ = tile_raster._launch(*fwd, False, False, order=mask)
    stats = {}
    tile_raster.tile_composite_plain(*fwd, True, False, stats=stats)
    o = out.clone().requires_grad_(True)
    img = gut.tile_unpack(o, grid)[:res[1], :res[0]]
    loss, _ = losses.total_loss(img[..., 0:3], gt)
    g_out = torch.autograd.grad(loss, o)[0].contiguous()
    b2_in = fwd[:4] + (out, g_out) + fwd[4:] + (False,)
    records = []

    # B2
    k2 = tile_raster._launch_backward(*b2_in, order=mask)
    same = torch.equal(k2, tile_raster._launch_backward(*b2_in))
    p2 = tile_raster.tile_composite_backward_plain(*b2_in)
    ok, d2, col = b2_agrees(k2, p2)
    print(f"B2: max |kernel - plain| {float(d2.max()):.3e}; per-column "
          f"max |plain| {col.tolist()}; nonzero slots "
          f"{int((k2.abs().sum(1) > 0).sum())} kernel, "
          f"{int((p2.abs().sum(1) > 0).sum())} plain; on the mask "
          f"bit-equal to B2 given none {same}", flush=True)
    if not (ok and same):
        fail("B2 disagrees with its plain version (tolerance 1e-5 x each "
             "column's max, zero pattern exact) or with itself given no "
             "mask")
    walked = int(out[:, 7, 0].sum())
    windows = walked_windows(out, binning.tile_starts)
    ntiles = rays.shape[0]
    b2_bound = default_bounds(ntiles, walked, windows, stats)[1]
    print(f"B2 walked slots {walked}, walked pixel-windows "
          f"{windows * 256}, default-leg work {stats} {tag}", flush=True)
    records.append(dict(
        name="tile_raster_bwd", route="cuda",
        source="threedgrut_torch/csrc/tile_raster_bwd.cu",
        replaces="threedgrut_tpu/ops/pallas/tile_raster.py:1269",
        launches=launches["tile_raster_bwd"], launches_forward=0,
        max_abs_err=float(d2.max()),
        ms=cuda_ms(lambda: tile_raster._launch_backward(*b2_in, order=mask),
                   10),
        plain_ms=cuda_ms(
            lambda: tile_raster.tile_composite_backward_plain(*b2_in), 1,
            warmup=0),
        bound_ms=b2_bound[0], bound_by=b2_bound[1], library_ms=None,
        work=stats, ptxas=leg_ptxas(ptxas, "tile_raster_bwd", False, False)))
    del mask
    records[-1]["origins_ms"] = per_pixel_origins(fwd, g_out, tag)

    # B5: the dense branch's rows, sorted and rounded as in training.
    prec = "bf16" if tr.cfg.render.low_precision_grads else "f32"
    with torch.no_grad():
        _, rows = sorted_gather.sort_rows(idx, k2, prec)
        ends = binning.particle_ends[:n].contiguous()
        ec = torch.clamp(ends, max=cap)
        lengths = torch.diff(ec, prepend=ec.new_zeros(1))
        total = int(ec[-1])
        seg_data, seg_len = rows[:total], lengths.to(torch.int64)
    records.append(sums_record(
        "segment_sum_rows", segment_sum.segment_sum_rows,
        segment_sum.segment_sum_rows_plain, (rows, ends), lengths, total,
        total * 64 + n * 4 + n * 64,
        lambda: torch.segment_reduce(seg_data, "sum", lengths=seg_len,
                                     axis=0, unsafe=True),
        launches["segment_sum_rows"], tag,
        sums_occupancy(ptxas, "B5")))

    # B6: the compact branch's rows.
    wc = walk_capacity_for(tr.cfg, cap)
    walked_rows = fused_raster.compact_walked(out, binning.tile_starts, idx,
                                              k2, wc, n)
    if walked_rows is None:
        fail("the walked windows do not fit walk_capacity at full width")
    with torch.no_grad():
        sid6, rows6 = sorted_gather.sort_rows(*walked_rows, prec)
        lengths6 = torch.bincount(sid6.long(), minlength=n + 1)[:n]
        kept = int((sid6 < n).sum())
        acc = torch.zeros((n + 1, 16), device=dev)
        ids_l = torch.clamp(sid6, max=n).long()
    # Filler rows (id n) fall in no segment and are never read.
    records.append(sums_record(
        "segment_sum_rows_by_ids",
        lambda g, i: segment_sum.segment_sum_rows_by_ids(g, i, n),
        lambda g, i: segment_sum.segment_sum_rows_by_ids_plain(g, i, n),
        (rows6, sid6), lengths6, kept,
        kept * 64 + rows6.shape[0] * 4 + n * 64,
        lambda: acc.index_add_(0, ids_l, rows6),
        launches["segment_sum_rows_by_ids"], tag,
        sums_occupancy(ptxas, "B6")))
    return records


def ptxas_report(reports):
    """{kernel entry (mangled): registers, stack frame, spill store and load
    bytes, static shared memory} from nvcc's -Xptxas -v logs (`reports`,
    as cuda_build.build returns them)."""
    out, entry = {}, None
    for log in reports.values():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
                out[entry] = {}
            elif entry and "bytes stack frame" in line:
                nums = [int(w) for w in line.replace(",", " ").split()
                        if w.isdigit()]
                out[entry].update(stack_frame_bytes=nums[0],
                                  spill_store_bytes=nums[1],
                                  spill_load_bytes=nums[2])
            elif entry and "Used" in line and "registers" in line:
                words = line.replace(",", " ").split()
                out[entry]["registers"] = int(words[words.index("Used") + 1])
                if "smem" in words:
                    out[entry]["static_smem_bytes"] = int(
                        words[words.index("smem") - 2])
    return out


def entry_occupancy(ptxas, occupancy):
    """{kernel: its ptxas report (empty where this run compiled nothing),
    threads per block and the blocks an SM holds at once} for the kernels
    of `occupancy`, a wrapper's blocks_per_sm() ({label: (threads, blocks
    as the CUDA runtime computes them)}; a template instantiation's integer
    arguments follow the name in angle brackets)."""
    reports = {}
    for k, v in ptxas.items():
        m = re.match(r"_Z(\d+)", k)
        if not m:
            continue
        end = m.end() + int(m[1])
        targs = re.match(r"I((?:Li\d+E)+)E", k[end:])
        label = k[m.end():end] + (
            f"<{','.join(re.findall(r'Li(\d+)E', targs[1]))}>"
            if targs else "")
        reports[label] = v
    return {label: dict(reports.get(label, {}), threads=threads,
                        blocks_per_sm=blocks)
            for label, (threads, blocks) in occupancy.items()}


def sums_occupancy(ptxas, which):
    """entry_occupancy of B5's kernel (`which` "B5") or of B6's two
    passes ("B6")."""
    from threedgrut_torch.ops import segment_sum
    occ = segment_sum.blocks_per_sm()
    return entry_occupancy(ptxas, {
        k: v for k, v in occ.items()
        if (k == "segment_sum_rows_kernel") == (which == "B5")})


def leg_ptxas(ptxas, kernel, *legs):
    """The ptxas report of `kernel`'s instantiation whose bool template
    parameters are `legs` (B1/B2: <passes > 0, row termination>; B7/B8:
    <passes > 0>), None where this run compiled nothing."""
    prefix = (f"_Z{len(kernel) + 7}{kernel}_kernelI"
              + "".join(f"Lb{int(bool(x))}E" for x in legs) + "E")
    return next((v for k, v in ptxas.items() if k.startswith(prefix)), None)


def option_records(runs, tag, ptxas):
    """B1 and B2's sorted and row-terminated legs against their plain
    versions on the card, each on the inputs its own train main path gives
    it (`runs`: {mode: (trainer, view, launches, passes, row_termination)}):
    rays row 7 from tiles.row_last_touch for row termination, the output
    cotangent of the loss for B2. B1: rows 0-5 within 2e-4 + 1e-4 |plain|,
    hit counts off by at most 1 on at most 0.1% of the pixels, walked slots
    equal on all but 0.1% of the tiles; B2: within 1e-5 x each column's
    max, the same nonzero slots; each kernel's two launches bit-identical.
    Timed as the train path runs them: B1 writes its walk's record (a
    sorted leg each pixel's compositing order, the row-terminated default
    leg its live-row mask), its B2 reads it (B2 without it runs B1 for it:
    the same gradients, checked). Bounds from this run's work: for a sorted
    leg the pair math of the walked slots (walked_pair_ops), B2's chain and
    reduction of its
    live pairs, B1's 2 operations per compare-exchange of the passes its
    live pixel-windows ran, and the orders' 128 bytes per live
    pixel-window; for the default leg default_bounds. A sorted leg's
    record also holds its 1-pass time (`ms_passes1`) and the network's
    share (`network_ms`, the difference: B1's network; B2 only reads
    another order); every record the instantiation's ptxas report and its
    dynamic shared memory."""
    from threedgrut_torch.cameras import pose_from_matrix
    from threedgrut_torch.model import losses
    from threedgrut_torch.ops import tile_raster, tiles
    from threedgrut_torch.render import gut
    from threedgrut_torch.trainer import render_params
    records = []
    for mode, (tr, view, launches, passes, rowterm) in runs.items():
        dev = tr.device
        cap, res, cam = tr.isect_capacity, view.resolution, view.camera
        pose = pose_from_matrix(torch.as_tensor(view.T_to_world, device=dev))
        gt = torch.as_tensor(view.rgb_gt, device=dev)
        with torch.no_grad():
            proj, binning, packed, grid = gut.prepare_packed(
                *render_params(tr.params), cam, pose, res, cap)
            n = packed.shape[0]
            data = packed[torch.clamp(binning.sorted_particle_idx,
                                      max=n - 1).long()]
            rays = gut.packed_world_rays(cam, pose, grid)
            if rowterm:
                rays[:, 7] = tiles.row_last_touch(binning, proj, grid)
        legs = (passes, rowterm)
        fwd = (data, binning.tile_starts, binning.tile_ends, rays, 2, 1e-4,
               0.0113, 1.0 / 255.0, 0.99, False)
        # B1, with the hit counts (aux_outputs) for the checks and B2's
        # live pairs.
        ko, _ = tile_raster._launch(*fwd, True, False, *legs)
        same = torch.equal(ko, tile_raster._launch(*fwd, True, False,
                                                   *legs)[0])
        stats = {}
        po, _ = tile_raster.tile_composite_plain(*fwd, True, False, *legs,
                                                 stats=stats)
        within, d = b1_agrees(ko, po)
        dh = d[:, 6]
        walk_diff = int((d[:, 7, 0] > 0).sum())
        print(f"B1 {mode}: per-row max |kernel - plain| "
              f"{d.amax(dim=(0, 2)).tolist()}; pixels whose hit count "
              f"differs {int((dh > 0).sum())}; tiles whose walk differs "
              f"{walk_diff}; bit-identical {same}; work {stats}",
              flush=True)
        if not (within and same and walk_diff <= max(
                1, math.floor(1e-3 * ko.shape[0]))):
            fail(f"B1 ({mode}) disagrees with its plain version")
        walked = int(ko[:, 7, 0].sum())
        live = float(ko[:, 6].sum())
        ntiles = rays.shape[0]
        net_ops = FLOP_SWAP * 64 * stats.get("network_passes", 0)
        b1_in = fwd + (False, False) + legs
        # As the train path runs them: B1 writes its walk's record (a
        # sorted leg each live pixel-window's compositing order, 128 bytes;
        # a default leg each walked pixel-window's live-row mask), its B2
        # reads it.
        order = tile_raster.order_buffer(binning.tile_starts,
                                         binning.tile_ends, cap,
                                         tile_raster.walk_words(passes))
        order_bytes = 128 * stats.get("live_pixel_windows", 0)
        if passes:
            b1_bound = bound_ms(ntiles * 8 * 256 * 4 * 2 + ntiles * 8
                                + walked * 64 + order_bytes,
                                walked_pair_ops(rays, ko) + net_ops)
        else:
            b1_bound, b2_bound = default_bounds(
                ntiles, walked, walked_windows(ko, binning.tile_starts),
                stats)
        records.append(dict(
            name=f"tile_raster_fwd[{mode}]", route="cuda",
            source="threedgrut_torch/csrc/tile_raster_fwd.cu",
            replaces="threedgrut_tpu/ops/pallas/tile_raster.py:1171",
            sorted_passes=passes, row_termination=rowterm,
            launches=launches.get("tile_raster_fwd", 0), launches_forward=0,
            max_abs_err=float(d[:, 0:6].max()),
            ms=cuda_ms(lambda: tile_raster._launch(*b1_in, order=order), 10),
            plain_ms=cuda_ms(lambda: tile_raster.tile_composite_plain(
                *b1_in), 1, warmup=0),
            bound_ms=b1_bound[0], bound_by=b1_bound[1], library_ms=None,
            walked_slots=walked, work=stats,
            ptxas=leg_ptxas(ptxas, "tile_raster_fwd", passes > 0, rowterm),
            dynamic_smem_bytes=tile_raster.dynamic_smem(passes)))
        if passes:
            # The same walk with a 1-pass network: what the rest costs.
            one = b1_in[:-2] + (1, rowterm)
            order1 = tile_raster.order_buffer(binning.tile_starts,
                                              binning.tile_ends, cap)
            records[-1]["ms_passes1"] = cuda_ms(
                lambda: tile_raster._launch(*one, order=order1), 10)
            records[-1]["network_ms"] = (records[-1]["ms"]
                                         - records[-1]["ms_passes1"])

        out, _ = tile_raster._launch(*b1_in, order=order)
        o = out.clone().requires_grad_(True)
        img = gut.tile_unpack(o, grid)[:res[1], :res[0]]
        loss, _ = losses.total_loss(img[..., 0:3], gt)
        g_out = torch.autograd.grad(loss, o)[0].contiguous()
        b2_in = fwd[:4] + (out, g_out) + fwd[4:] + (False,) + legs
        k2 = tile_raster._launch_backward(*b2_in, order=order)
        # Without B1's orders B2's wrapper runs B1 for them: the same.
        same = torch.equal(k2, tile_raster._launch_backward(*b2_in))
        p2 = tile_raster.tile_composite_backward_plain(*b2_in)
        within, d2, col = b2_agrees(k2, p2)
        print(f"B2 {mode}: max |kernel - plain| {float(d2.max()):.3e}; "
              f"worst |kernel - plain| / column max "
              f"{float((d2 / col.clamp(min=1e-30)).max()):.3e}; nonzero "
              f"slots {int((k2.abs().sum(1) > 0).sum())} kernel, "
              f"{int((p2.abs().sum(1) > 0).sum())} plain; bit-identical "
              f"{same}", flush=True)
        if not (within and same):
            fail(f"B2 ({mode}) disagrees with its plain version")
        if passes:
            b2_bound = bound_ms(ntiles * 8 * 256 * 4 * 3 + ntiles * 8
                                + walked * 64 * 2 + order_bytes,
                                walked_pair_ops(rays, ko)
                                + (FLOP_CHAIN + FLOP_REDUCE) * live)
        records.append(dict(
            name=f"tile_raster_bwd[{mode}]", route="cuda",
            source="threedgrut_torch/csrc/tile_raster_bwd.cu",
            replaces="threedgrut_tpu/ops/pallas/tile_raster.py:1269",
            sorted_passes=passes, row_termination=rowterm,
            launches=launches.get("tile_raster_bwd", 0), launches_forward=0,
            max_abs_err=float(d2.max()),
            ms=cuda_ms(lambda: tile_raster._launch_backward(
                *b2_in, order=order), 10),
            plain_ms=cuda_ms(
                lambda: tile_raster.tile_composite_backward_plain(*b2_in), 1,
                warmup=0),
            bound_ms=b2_bound[0], bound_by=b2_bound[1], library_ms=None,
            live_pairs=live,
            ptxas=leg_ptxas(ptxas, "tile_raster_bwd", passes > 0, rowterm),
            dynamic_smem_bytes=tile_raster.dynamic_smem(passes, True)))
        if passes:
            out1, _ = tile_raster._launch(*one, order=order1)
            one2 = b2_in[:4] + (out1,) + b2_in[5:-2] + (1, rowterm)
            records[-1]["ms_passes1"] = cuda_ms(
                lambda: tile_raster._launch_backward(*one2, order=order1),
                10)
            records[-1]["network_ms"] = (records[-1]["ms"]
                                         - records[-1]["ms_passes1"])
        print(f"B1/B2 {mode}: walked slots {walked}, live pairs {live:.0f}, "
              f"B1 {records[-2]['ms']:.4f} ms (bound "
              f"{records[-2]['bound_ms']:.4f}), B2 {records[-1]['ms']:.4f} "
              f"ms (bound {records[-1]['bound_ms']:.4f}) {tag}", flush=True)
        for r in records[-2:]:
            print(f"{r['name']}: network_ms {r.get('network_ms')}, ptxas "
                  f"{r['ptxas']}, dynamic smem {r['dynamic_smem_bytes']} B",
                  flush=True)
    return records


def sums_record(name, kernel, plain, args, lengths, n_rows, nbytes, library,
                launches, tag, occupancy):
    """A record of B5 or B6 (`name`) on the rows args[0] against its plain
    version: within segment_sum.f32_sum_bound, the same particles with a
    nonzero sum; times of the kernel, the plain version and `library`, one
    PyTorch call computing the same sums; `occupancy`: its kernels' ptxas
    reports and blocks per SM (entry_occupancy)."""
    from threedgrut_torch.ops import segment_sum
    got, want = kernel(*args), plain(*args)
    bound = segment_sum.f32_sum_bound(
        plain(args[0].abs(), *args[1:]), lengths, want)
    err = float((got - want).abs().max())
    nz_k, nz_p = (got != 0).any(1), (want != 0).any(1)
    nch = args[0].shape[1]
    print(f"{name}: {nch} channels; max |kernel - plain| {err:.3e}; longest "
          f"segment {int(lengths.max())} rows; rows summed {n_rows}; "
          f"particles with a nonzero gradient {int(nz_k.sum())} kernel, "
          f"{int(nz_p.sum())} plain {tag}", flush=True)
    if not bool(((got - want).abs() <= bound).all()):
        fail(f"{name} disagrees with its plain version beyond the f32 "
             f"summation bound")
    if not torch.equal(nz_k, nz_p):
        fail(f"{name}: the particles with a nonzero gradient differ from "
             f"its plain version's")
    b = bound_ms(nbytes, nch * n_rows)
    base = name.split("[")[0]
    return dict(
        name=name, route="cuda", source="threedgrut_torch/csrc/segment_sum.cu",
        replaces=("threedgrut_tpu/ops/pallas/segment_sum.py:202"
                  if base == "segment_sum_rows" else
                  "threedgrut_tpu/ops/pallas/segment_sum.py:96"),
        channels=nch, launches=launches, launches_forward=0, max_abs_err=err,
        ms=cuda_ms(lambda: kernel(*args), 20),
        plain_ms=cuda_ms(lambda: plain(*args), 3),
        bound_ms=b[0], bound_by=b[1], library_ms=cuda_ms(library, 20),
        ptxas=occupancy)


def binning_records(proj, binning, grid, cap, launches, ptxas, tag):
    """B3 and B4 against their plain versions on the card at the main
    path's projection `proj` (tile culling on, as bin_particles runs
    them), bit for bit, timed, with their bounds from this run's counts
    and their kernels' ptxas reports and blocks per SM; then the card's
    full-width TileBinning `binning` against the plain path on the CPU.
    `launches`: (train path's, forward path's) launch counts. Returns the
    two records."""
    from threedgrut_torch.ops import expand, tiles
    total = int(binning.num_intersections)
    n = proj.depth.shape[0]
    b3_in = (proj.tile_min.int().contiguous(),
             proj.tile_max.int().contiguous(), proj.n_tiles.int().contiguous(),
             proj.conic.contiguous(), proj.center.contiguous(),
             proj.max_power.contiguous())
    records = []
    occ = entry_occupancy(ptxas, expand.blocks_per_sm())
    k_out = expand.cull_masks(*b3_in)
    p_out = expand.cull_masks_plain(*b3_in)
    err3 = max(int((a.long() - b.long()).abs().max())
               for a, b in zip(k_out, p_out))
    if err3:
        fail(f"B3 cull_masks differs from its plain version by {err3}")
    bw = b3_in[1][:, 0] - b3_in[0][:, 0]
    bh = b3_in[1][:, 1] - b3_in[0][:, 1]
    tested = int(torch.where((b3_in[2] > 0) & (bw <= 8) & (bh <= 8),
                             bw * bh, 0).sum())
    # bytes the function needs: the six inputs (44 B), the count and the
    # three mask words (16 B). The record B3 writes for B4 is scratch
    # between them, counted apart (record_bytes), not in the bound.
    b3_bound = bound_ms(n * (44 + 16),
                        FLOP_POWER_TEST * tested + FLOP_POWER_PARTICLE * n)
    records.append(dict(
        name="cull_masks", route="cuda",
        source="threedgrut_torch/csrc/cull_masks.cu",
        replaces="threedgrut_tpu/ops/pallas/expand.py:407",
        launches=launches[0]["cull_masks"],
        launches_forward=launches[1]["cull_masks"], max_abs_err=float(err3),
        ms=cuda_ms(lambda: expand.cull_masks(*b3_in), 20),
        plain_ms=cuda_ms(lambda: expand.cull_masks_plain(*b3_in), 3),
        bound_ms=b3_bound[0], bound_by=b3_bound[1], library_ms=None,
        tested_cells=tested, record_bytes=n * 4 * expand.RECORD_WORDS,
        ptxas={k: v for k, v in occ.items() if k == "cull_masks_kernel"}))

    # B4
    counts, record = k_out
    ids_of_rank, ends_rank = tiles.depth_rank(counts, proj.depth)
    b4_in = (ends_rank, ids_of_rank, record, cap, grid, True)
    k4 = expand.expand_keys(*b4_in)
    p4 = expand.expand_keys_plain(*b4_in)
    err4 = max(int((a - b).abs().max()) for a, b in zip(k4, p4))
    if err4:
        fail(f"B4 expand_keys differs from its plain version by {err4}")
    # bytes the function needs: 12 written per slot; the end, the id and
    # the 56 B of per-particle fields (bbox min and max, count, mask words,
    # conic, centre, max power) of every rank that owns a slot below the
    # capacity (the others are never needed). The 64-byte records B4
    # gathers in their place are counted apart (record_bytes).
    c_rank = counts[ids_of_rank.long()]
    live = int(((c_rank > 0) & (ends_rank - c_rank < cap)).sum())
    b4_bound = bound_ms(cap * 12 + live * (8 + 56),
                        FLOP_EXPAND_SLOT * min(total, cap))
    records.append(dict(
        name="expand_keys", route="cuda",
        source="threedgrut_torch/csrc/expand_keys.cu",
        replaces="threedgrut_tpu/ops/pallas/expand.py:265",
        launches=launches[0]["expand_keys"],
        launches_forward=launches[1]["expand_keys"], max_abs_err=float(err4),
        ms=cuda_ms(lambda: expand.expand_keys(*b4_in), 20),
        plain_ms=cuda_ms(lambda: expand.expand_keys_plain(*b4_in), 3),
        bound_ms=b4_bound[0], bound_by=b4_bound[1], library_ms=None,
        live_ranks=live, record_bytes=live * 4 * expand.RECORD_WORDS,
        ptxas={k: v for k, v in occ.items() if k != "cull_masks_kernel"}))
    print(f"B3 {records[-2]['ms']:.4f} ms (bound {b3_bound[0]:.4f}, "
          f"{tested} cells tested), B4 {records[-1]['ms']:.4f} ms (bound "
          f"{b4_bound[0]:.4f}, {live} live ranks of {n}); ptxas {occ} "
          f"{tag}", flush=True)
    del counts, record, k_out, p_out, k4, p4, c_rank

    # TileBinning at full width: card vs the plain path on the CPU.
    bc = tiles.bin_particles(tiles.Projection(*[x.cpu() for x in proj]),
                             grid, cap)
    for fld in tiles.TileBinning._fields:
        if not torch.equal(getattr(binning, fld).cpu(), getattr(bc, fld)):
            fail(f"full-width TileBinning.{fld} differs from the plain path")
    print("full-width TileBinning card == CPU plain path, every field",
          flush=True)
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "threedgrut_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(threedgrut_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from threedgrut_torch import api, golden
    from threedgrut_torch.cameras import example_camera, pose_from_matrix
    from threedgrut_torch.model.gaussians import bench_scene, from_numpy
    from threedgrut_torch.config import Config, preset_3dgut_sorted
    from threedgrut_torch.ops import cuda_build, tile_raster
    from threedgrut_torch.render import gut

    # ---- 1. device -------------------------------------------------------
    device_kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f"[{smi}]"
    print(f"device: {device_kind} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    t_start = time.time()

    # ---- 2. build --------------------------------------------------------
    t0 = time.time()
    reports = cuda_build.build()
    print(f"build: {sorted(reports)} in {time.time() - t0:.1f} s", flush=True)
    for kname, log in reports.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "stack frame" in line:
                print(f"  {kname}: {line.strip()}", flush=True)

    # ---- 3. golden -------------------------------------------------------
    gparams = from_numpy(golden.scene(), device=dev)
    with torch.no_grad():
        gout, _ = render_retry(api, gparams, example_camera(
            golden.RESOLUTION, dev), golden.camera_to_world(),
            golden.RESOLUTION, golden.ISECT_CAPACITY, dev,
            hit_visibility=True)
    rep, ok = golden.compare(gout, golden.load())
    print(f"golden vs JAX reference: {json.dumps(rep)}", flush=True)
    if not ok:
        fail("the card's golden frame is outside the tolerances")
    for mode, kw in golden.SORTED_MODES.items():
        with torch.no_grad():
            sout, _ = render_retry(api, gparams, example_camera(
                golden.RESOLUTION, dev), golden.camera_to_world(),
                golden.RESOLUTION, golden.ISECT_CAPACITY, dev,
                hit_visibility=True, **kw)
        rep, ok = golden.compare(sout, golden.load_sorted(mode))
        print(f"golden ({mode}: {kw}) vs JAX reference: {json.dumps(rep)}",
              flush=True)
        if not ok:
            fail(f"the card's golden frame ({mode}) is outside the "
                 f"tolerances")
    go, gd = golden.grt_rays()
    for flat in (False, True):
        with torch.no_grad():
            gtrace = api.trace(gparams, go, gd, device=dev, flat_cull=flat,
                               **golden.GRT_TRACE_KW)
        rep, ok = golden.compare(gtrace, golden.load_grt())
        print(f"3DGRT golden trace (flat_cull={flat}) vs JAX reference: "
              f"{json.dumps(rep)}", flush=True)
        if bool(gtrace.overflow) or not ok:
            fail(f"the card's 3DGRT golden trace (flat_cull={flat}) is "
                 f"outside the tolerances")

    # ---- 4. parity: kernels (card) vs plain versions (CPU) ---------------
    f100 = bench_scene(PARITY_N, seed=0, specular_std=0.1)
    p_gpu = from_numpy(f100, device=dev)
    p_cpu = from_numpy(f100, device="cpu")
    T0 = orbit_T(0)
    with torch.no_grad():
        for hv in (False, True):
            og, _ = render_retry(api, p_gpu, example_camera(PARITY_RES, dev),
                                 T0, PARITY_RES, PARITY_CAP, dev,
                                 hit_visibility=hv)
            oc, _ = render_retry(api, p_cpu,
                                 example_camera(PARITY_RES, "cpu"), T0,
                                 PARITY_RES, PARITY_CAP, "cpu",
                                 hit_visibility=hv)
            rep, ok = golden.compare(og, oc)
            print(f"api.render card vs CPU, {PARITY_N} Gaussians "
                  f"{PARITY_RES}, hit_visibility={hv}: {json.dumps(rep)}",
                  flush=True)
            if not ok:
                fail("api.render on the card disagrees with the plain path")
    del p_gpu, p_cpu
    train_parity(dev, tag)
    grt_parity(dev, tag)
    grt_train_parity(dev, tag)
    grt_flat_parity(dev, tag)

    # ---- 5. forward main path at full width ------------------------------
    fields = bench_scene(MAIN_N, seed=0, specular_std=0.1)
    fwd_base = phase_start()
    params = from_numpy(fields, device=dev)
    cam = example_camera(MAIN_RES, dev)
    cap = MAIN_CAP
    frames_ms, outs = [], []
    cuda_build.launches.clear()
    with torch.no_grad():
        for k in range(6):
            hv = k == 5
            T = orbit_T(0 if hv else k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, cap = render_retry(api, params, cam, T, MAIN_RES, cap, dev,
                                    hit_visibility=hv)
            torch.cuda.synchronize()
            frames_ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
    fwd_launches = dict(cuda_build.launches)
    fwd_peak_gib = phase_peak_gib(fwd_base)
    print(f"forward main path launches: {fwd_launches}", flush=True)
    for kname in cuda_build.kernels_of("gut", ("forward",)):
        if fwd_launches.get(kname, 0) <= 0:
            fail(f"kernel {kname} was not launched on the forward main path")
    for k, out in enumerate(outs):
        for fld in ("rgb", "opacity", "depth", "transmittance", "hit_count"):
            x = getattr(out, fld)
            if not bool(torch.isfinite(x).all()):
                fail(f"frame {k}: {fld} not finite")
        if tuple(out.rgb.shape) != (MAIN_RES[1], MAIN_RES[0], 3):
            fail(f"frame {k}: rgb shape {tuple(out.rgb.shape)}")
        cover = float((out.opacity > 0.01).float().mean())
        nvis = int(out.visibility.sum())
        if cover <= 0.0 or nvis <= 0:
            fail(f"frame {k}: coverage {cover}, visible {nvis}")
        print(f"frame {k} hit_visibility={k == 5}: {frames_ms[k]:.3f} ms "
              f"coverage {cover:.4f} visible {nvis} "
              f"rgb mean {float(out.rgb.mean()):.5f} {tag}", flush=True)

    # ---- 5b. inference and export at full width ---------------------------
    infer_rec, infer_launches, (infer_scene, infer_pose) = inference_export(
        params, cam, cap, dev, tag)

    # ---- 6. train main path at full width --------------------------------
    tr, view, train_launches, train_rec = train_main_path(dev, tag)
    rowterm_cfg = Config()
    rowterm_cfg.render.row_termination = True
    option_runs = {}
    for mode, cfg, passes, rowterm in (
            ("sorted16", preset_3dgut_sorted(), 16, False),
            ("row_termination", rowterm_cfg, 0, True)):
        tr_m, view_m, launches_m, rec_m = train_main_path(dev, tag, cfg, mode)
        option_runs[mode] = (tr_m, view_m, launches_m, passes, rowterm)
        train_rec[mode] = rec_m

    # ---- 6b. densification: the trainer's strategies ----------------------
    densify_recs = densification(dev, tag)

    # ---- 6c. data, entry points and eval ---------------------------------
    mesh_entry = {}
    data_recs = data_entry_points(
        dev, tag, extra=lambda nerf, runs: mesh_entry.update(
            mesh_entry_leg(nerf, runs, tag)))

    # ---- 6d. multi-device training (its (c) ran on 6c's files) -----------
    mesh_rec = multi_device(dev, tag, mesh_entry)

    # ---- 7. 3DGRT main path: bench_grt's configurations ------------------
    grt_launches, (gp, g_o, g_d, g_inp) = grt_main_path(dev, tag)
    flat_launches, _ = grt_main_path(dev, tag, flat=True)
    grt_launches.update({f"flat_{k}": v for k, v in flat_launches.items()})
    packed_launches, _ = grt_packed_main_path(dev, tag)
    grt_launches.update(packed_launches)

    # ---- 8. 3DGRT train main path: bench_grt's fwd+bwd, the trainer ------
    fb_launches, grt_walk = grt_fwd_bwd_main_path(dev, tag)
    grt_train_launches = {f"fwd_bwd_{k}": v for k, v in fb_launches.items()}
    fb_flat, _ = grt_fwd_bwd_main_path(dev, tag, flat=True)
    grt_train_launches.update({f"fwd_bwd_flat_{k}": v
                               for k, v in fb_flat.items()})
    fb_packed, _ = grt_packed_fwd_bwd(dev, tag)
    grt_train_launches.update({f"fwd_bwd_{k}": v
                               for k, v in fb_packed.items()})
    grt_train_launches["trainer_100k"] = grt_train_main_path(dev, tag)

    # ---- 8b. the flat cull's legs: B9's main path ------------------------
    b9_launches, b9_args, leg_ms = grt_cull_legs(dev, tag)

    # ---- 5c. the playground at full width (after 8b: the phases before
    # keep the order, and the state, their timings were taken in) ---------
    ptxas = ptxas_report(reports)
    pg_rec, pg_launches, m1_rec, pg_viewer = playground(params, dev, tag,
                                                        ptxas)
    pg_rec["train_after"] = train_after_playground(dev, tag,
                                                   train_rec["step_ms"])

    # ---- 9. kernels vs plain versions at the main paths' shapes ----------
    pose = pose_from_matrix(torch.as_tensor(orbit_T(0), device=dev))
    with torch.no_grad():
        acts = (params.get_positions(), params.get_rotation(),
                params.get_scale(), params.get_density(),
                params.get_features())
        proj, binning, data_sorted, grid = gut.prepare(
            *acts, cam, pose, MAIN_RES, cap)
        rays = gut.packed_world_rays(cam, pose, grid)
    total = int(binning.num_intersections)
    print(f"main path: {MAIN_N} Gaussians, {MAIN_RES}, capacity {cap}, "
          f"num_intersections {total}, overflow "
          f"{bool(binning.overflow)} (JAX bench.py records ~2.70M for this "
          f"scene)", flush=True)
    if bool(binning.overflow):
        fail("main path overflowed")
    records = binning_records(proj, binning, grid, cap,
                              (train_launches, fwd_launches), ptxas, tag)

    # B1, without and with emit_flags
    for kname in ("tile_raster_fwd", "tile_raster_bwd"):
        for rowterm in (False, True):
            print(f"ptxas {kname} default leg (row_termination={rowterm}): "
                  f"{leg_ptxas(ptxas, kname, False, rowterm)}", flush=True)
    b1_in = (data_sorted, binning.tile_starts, binning.tile_ends, rays, 2,
             1e-4, 0.0113, 1.0 / 255.0, 0.99, False, True)
    err1, b1_ms, b1_stats = 0.0, {}, {}
    for ef in (False, True):
        ko, kf = tile_raster._launch(*b1_in, ef)
        po, pf = tile_raster.tile_composite_plain(*b1_in, ef,
                                                  stats=b1_stats)
        within, d = b1_agrees(ko, po)
        rows = d.amax(dim=(0, 2)).tolist()
        walked_tiles = int((d[:, 7, 0] > 0).sum())
        print(f"B1 emit_flags={ef}: per-row max |kernel - plain| {rows}; "
              f"tiles whose walk differs {walked_tiles}", flush=True)
        if ef:
            fd = float((kf - pf).abs().max())
            nz = (int((kf > 0).sum()), int((pf > 0).sum()))
            print(f"B1 flags: max diff {fd}, nonzero {nz}", flush=True)
            within &= fd <= 2e-4 and abs(nz[0] - nz[1]) <= max(
                1, math.floor(1e-3 * cap))
        if not within:
            fail(f"B1 emit_flags={ef} outside its tolerances")
        err1 = max(err1, max(rows[0:6]))
        b1_ms[ef] = cuda_ms(lambda: tile_raster._launch(*b1_in, ef), 10)
        b1_ms[("plain", ef)] = cuda_ms(
            lambda: tile_raster.tile_composite_plain(*b1_in, ef), 1)
    walked = int(ko[:, 7, 0].sum())
    windows = walked_windows(ko, binning.tile_starts)
    ntiles = rays.shape[0]
    b1_bound = default_bounds(ntiles, walked, windows, b1_stats, False)[0]
    b1_mask_bound = default_bounds(ntiles, walked, windows, b1_stats)[0]
    # As a train step runs it: writing the live-row mask for B2.
    mask = tile_raster.order_buffer(binning.tile_starts, binning.tile_ends,
                                    cap, tile_raster.walk_words(0))
    b1_ms["mask"] = cuda_ms(
        lambda: tile_raster._launch(*b1_in, False, order=mask), 10)
    del mask
    print(f"B1 walked slots {walked} of {total}, walked pixel-windows "
          f"{windows * 256}, default-leg work {b1_stats}; emit_flags=True "
          f"{b1_ms[True]:.4f} ms (plain {b1_ms[('plain', True)]:.2f} ms), "
          f"writing the live-row mask {b1_ms['mask']:.4f} ms (bound "
          f"{b1_mask_bound[0]:.4f}) {tag}", flush=True)
    records.append(dict(
        name="tile_raster_fwd", route="cuda",
        source="threedgrut_torch/csrc/tile_raster_fwd.cu",
        replaces="threedgrut_tpu/ops/pallas/tile_raster.py:1171",
        launches=train_launches["tile_raster_fwd"],
        launches_forward=fwd_launches["tile_raster_fwd"], max_abs_err=err1,
        ms=b1_ms[False], plain_ms=b1_ms[("plain", False)],
        bound_ms=b1_bound[0], bound_by=b1_bound[1], library_ms=None,
        ms_with_mask=b1_ms["mask"], bound_ms_with_mask=b1_mask_bound[0],
        ms_flags=b1_ms[True], work=b1_stats,
        ptxas=leg_ptxas(ptxas, "tile_raster_fwd", False, False)))

    records += backward_records(tr, view, train_launches, tag, ptxas)
    records += option_records(option_runs, tag, ptxas)
    from threedgrut_torch.render import grt
    with torch.no_grad():
        g_data = grt.gather_candidates(g_inp)
    rec7, b7_runs = grt_record(g_data, g_inp, grt_launches,
                               grt_train_launches, ptxas, tag)
    records.append(rec7)
    records += b8_record(g_data, g_inp, b7_runs, grt_train_launches,
                         grt_walk, ptxas, tag)
    del g_inp, g_data, b7_runs
    records.append(b9_record(b9_args, b9_launches, leg_ms, tag, ptxas))
    del b9_args
    records.append(m1_rec)

    # ---- 10. where a frame's, a train step's and a trace's time goes -----
    def frame():
        with torch.no_grad():
            render_retry(api, params, cam, orbit_T(1), MAIN_RES, cap, dev)

    breakdown = profile_run(frame, ("3dgut.",))
    print(f"profiled frame: {json.dumps(breakdown)} {tag}", flush=True)
    from threedgrut_torch.render import infer
    ibreak = profile_run(lambda: infer.render_compact(
        infer_scene, cam, infer_pose, MAIN_RES, BENCH_CAPC, device=dev),
        ("infer.", "3dgut."))
    print(f"profiled compact frame (bench.py's BENCH_INFER=compact): "
          f"{json.dumps(ibreak)} {tag}", flush=True)
    del infer_scene
    tbreak = profile_run(lambda: tr.train_step(view), ("train.", "3dgut."))
    print(f"profiled train step: {json.dumps(tbreak)} {tag}", flush=True)
    tr_s, view_s = option_runs["sorted16"][:2]
    sbreak = profile_run(lambda: tr_s.train_step(view_s),
                         ("train.", "3dgut."))
    print(f"profiled train step (preset_3dgut_sorted): {json.dumps(sbreak)} "
          f"{tag}", flush=True)

    def trace():
        with torch.no_grad():
            api.trace(gp, g_o, g_d, device=dev,
                      **grt_trace_kw(GRT_CONFIGS[0]))

    gbreak = profile_run(trace, ("3dgrt.",))
    print(f"profiled 3DGRT trace (100k): {json.dumps(gbreak)} {tag}",
          flush=True)
    g_acts = grt_acts(gp)
    fbbreak = profile_run(
        lambda: grt_fwd_bwd(g_acts, g_o, g_d, grt_trace_kw(GRT_CONFIGS[0]),
                            grt_walk, (0, 3)), ("3dgrt.",))
    print(f"profiled 3DGRT fwd+bwd (100k): {json.dumps(fbbreak)} {tag}",
          flush=True)
    del g_acts, gp, g_o, g_d
    cfg1m = GRT_CONFIGS[1]
    p1m, o1m, d1m = grt_bench_scene(cfg1m["n"], cfg1m["scales"], dev)

    def flat_trace():
        with torch.no_grad():
            api.trace(p1m, o1m, d1m, device=dev,
                      **grt_trace_kw(cfg1m, flat=True))

    flbreak = profile_run(flat_trace, ("3dgrt.",))
    print(f"profiled 3DGRT trace (1M, flat cull): {json.dumps(flbreak)} "
          f"{tag}", flush=True)
    pg_break = {}
    pg_viewer.resolution = PG_SMALL_RES
    pg_viewer.fov_deg = PG_FOV_DEG
    for mode in ("hybrid", "trace"):
        pg_viewer.mode = mode
        pg_break[mode] = profile_run(
            lambda: pg_viewer.render_outputs(*pg_camera(1)),
            ("playground.", "3dgrt.", "3dgut."))
        print(f"profiled playground frame ({mode}, 1M, {PG_SMALL_RES}): "
              f"{json.dumps(pg_break[mode])} {tag}", flush=True)
    pg_rec["profile"] = pg_break
    del pg_viewer
    if min(breakdown["device_busy_ms"], ibreak["device_busy_ms"],
           pg_break["hybrid"]["device_busy_ms"],
           pg_break["trace"]["device_busy_ms"],
           tbreak["device_busy_ms"],
           sbreak["device_busy_ms"], gbreak["device_busy_ms"],
           fbbreak["device_busy_ms"], flbreak["device_busy_ms"]) <= 0.0:
        fail("the profiler recorded no device time")

    # The densified steps' launches of each kernel, by leg: the default
    # legs of B1 and B2 (none of their sorted or row-terminated legs), B6
    # at 16 channels on the 3DGUT legs and at 64 on the 3DGRT one.
    for r in records:
        base, _, option = r["name"].partition("[")
        r["launches_densify"] = {
            d["leg"]: (0 if option and not r.get("channels")
                       else d["launches"].get(base, 0))
            for d in densify_recs
            if r.get("channels") != (16 if "3DGRT" in d["leg"] else 64)}
    # Phase 6c's launches of each kernel, by leg: the train entry's run
    # (train steps, validation, the final test renders) and the render
    # entry's; B1/B2's default legs only; B6 at 16 channels on the 3DGUT
    # legs and at 64 on the 3DGRT one.
    for r in records:
        base, _, option = r["name"].partition("[")
        entry = {}
        for d in data_recs:
            if r.get("channels") == (16 if "3dgrt" in d["leg"] else 64):
                continue
            runs = [(d["leg"], d["launches"])]
            if "eval_launches" in d:
                runs.append((d["leg"] + " render", d["eval_launches"]))
            if "resume" in d:
                runs.append((d["leg"] + " resume",
                             d["resume"]["launches"]))
            for run_name, counts in runs:
                entry[run_name] = (0 if option and not r.get("channels")
                                   else counts.get(base, 0))
        r["launches_entry"] = entry
    # Phase 6d's launches of each kernel, by run: (a) the (1, 1, 1) mesh's
    # steps, (b) each mesh rank's steps, (c) each rank of the --multichip
    # entry (training only); B1/B2's default legs only; B6 at 16 channels.
    for r in records:
        base, _, option = r["name"].partition("[")
        runs = {"(1, 1, 1) nccl": mesh_rec["a"]["launches"]}
        for shape, per_rank in mesh_rec["b"].items():
            runs.update({f"{shape} gloo rank {i}": c
                         for i, c in enumerate(per_rank)})
        runs.update({f"entry {MESH_ENTRY_SHAPE} rank {i}": c
                     for i, c in mesh_rec["c"]["launches"].items()})
        r["launches_mesh"] = {
            name: 0 if option or r.get("channels") == 64
            else counts.get(base, 0) for name, counts in runs.items()}
    # Phase 5b's launches of each kernel, by run: B1's default leg in every
    # frame but the frozen ones between refreshes, which run its sorted leg
    # (the "[sorted16]" record); B3 and B4 in every refresh, exact and
    # compact frame and capture_binning.
    for r in records:
        base, _, option = r["name"].partition("[")
        leg = option.rstrip("]") or "default"
        r["launches_infer"] = {run: counts.get(leg, {}).get(base, 0)
                               for run, counts in infer_launches.items()}
    # Phase 5c's launches of each kernel, by mode (every frame of a mode
    # after its first): B1's default leg only.
    for r in records:
        base, _, option = r["name"].partition("[")
        r["launches_playground"] = {
            name: 0 if option else counts.get(base, 0)
            for name, counts in pg_launches.items()}
    for d in data_recs:
        print(f"{d['leg']}: {d['steps']} steps on {d['views']} views, alive "
              f"{d.get('alive_before')} -> {d['alive_after']} in "
              f"{d['capacity']} slots, isect capacity "
              f"{d['isect_capacity']}, step ms (host, median after the "
              f"first epoch) {d['step_ms_median_after_first_epoch']:.3f}, "
              f"data ms first epoch {d['data_ms_first_epoch']:.3f} / later "
              f"{d['data_ms_later']}, test {json.dumps(d['test'])}, eval "
              f"{json.dumps(d.get('eval'))}, max_memory_allocated "
              f"{d['peak_gib']:.3f} GiB, wall {d['wall_s']:.1f} s {tag}",
              flush=True)
    for d in densify_recs:
        print(f"{d['leg']}: alive {d['alive']}, {d['totals']}, step ms "
              f"before growth {d['step_ms_before']:.3f}, after "
              f"{d['step_ms_after']:.3f}, max_memory_allocated "
              f"{d['peak_gib']:.3f} GiB, strategy ops ms "
              f"{json.dumps(d.get('op_ms'))} {tag}", flush=True)
    for r in records:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), launches {r['launches']} {tag}",
              flush=True)
    steady = frames_ms[1:5]
    frame_ms = float(np.median(steady))
    rays_s = MAIN_RES[0] * MAIN_RES[1] / (frame_ms / 1e3)
    print(f"frame ms (median of frames 1-4, hit_visibility=False): "
          f"{frame_ms:.3f}; rays/s {rays_s:.4e}; hit_visibility frame "
          f"{frames_ms[5]:.3f} ms; max_memory_allocated "
          f"{fwd_peak_gib:.3f} GiB {tag}", flush=True)
    print(f"train step ms (median of steps 2-5): {train_rec['step_ms']:.3f}; "
          f"rays/s {train_rec['rays_per_s']:.4e}; max_memory_allocated "
          f"{train_rec['peak_gib']:.3f} GiB {tag}", flush=True)
    for mode in option_runs:
        r = train_rec[mode]
        print(f"train step ms ({mode}, median of steps 2-5): "
              f"{r['step_ms']:.3f}; rays/s {r['rays_per_s']:.4e}; "
              f"max_memory_allocated {r['peak_gib']:.3f} GiB {tag}",
              flush=True)
    for name, r in infer_rec["orbit"].items():
        print(f"inference orbit {name}: ms a frame median "
              f"{r['ms_per_frame_median']:.3f} (mean "
              f"{r['ms_per_frame_mean']:.3f}; refresh "
              f"{r['refresh_ms_median']:.3f}, between "
              f"{r['between_ms_median']:.3f}), PSNR min / mean "
              f"{r.get('psnr_min')} / {r.get('psnr_mean')}, overflow frames "
              f"{r['overflow_frames']} {tag}", flush=True)
    for name, r in pg_rec["modes"].items():
        print(f"playground {name}: ms a frame median {r['ms_median']:.3f} "
              f"(first frame {r['first_frame_ms']:.1f}, grew {r['grown']}), "
              f"candidate capacity {r['candidate_capacity']}, launches a "
              f"frame {r['launches'][-1]} {tag}", flush=True)
    print(f"playground: phase 5c wall {pg_rec['wall_s']:.1f} s, "
          f"max_memory_allocated {pg_rec['peak_gib']:.3f} GiB; idle share "
          f"hybrid {pg_break['hybrid']['device_idle_share']:.3f}, trace "
          f"{pg_break['trace']['device_idle_share']:.3f} {tag}", flush=True)
    print(f"export at 1M: {json.dumps(infer_rec['export'])}; phase 5b "
          f"max_memory_allocated {infer_rec['peak_gib']:.3f} GiB {tag}",
          flush=True)
    print(f"chip_smoke wall {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind, "count": count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
