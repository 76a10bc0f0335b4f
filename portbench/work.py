"""The yardstick of the per-layer metrics: the H100's peaks, the least time
a kernel's work can take on them (bound_ms), and the work of each hand-
written compositor launch and of a whole step, counted from shapes and from
what the binning and the walk hand the kernel. Nothing here runs the
program's plain versions.

Each count names what it reads:
  * rays [T, 8, 256] and the tile or bundle count: shapes;
  * tile_starts: the binning's output;
  * walked slots of a tile, or walked 128-row windows of a bundle (row 7
    of the forward's output) and counted pairs of a ray (row 6 of the 3DGRT
    forward's output): the extent of the list the front-to-back walk needs
    before every pixel of the tile is saturated, which is fixed by the
    inputs and the compositing rule, whatever implements the walk.

The pair counts take every (pixel, walked slot) pair: a pixel that
saturated inside the walked range still counts. They stand in for the
pairs a pixel can still take, which only a plain re-run of the compositor
could count.
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, at the full 700 W: float32 outside the tensor
# cores, HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# Operations per unit of work, read off the kernel sources (csrc/): one
# (pixel, slot) pair of the rasterizer's compositor, of which the per-row
# part is shared by a tile's rays when they share an origin; B7's pair
# math with both gates and the blend per (ray, walked row), and per
# counted pair the SH colour and the accumulation; B8's gradient chain
# and per-row reduction per counted pair.
FLOP_PAIR = 75
FLOP_PAIR_ROW = 18
FLOP_GRT_PAIR = 86
FLOP_GRT_COUNTED = 112
FLOP_GRT_BWD_CHAIN = 280
FLOP_GRT_BWD_REDUCE = 61
# Step work outside the compositors, per unit: the sigma-point projection
# of a particle (7 points through the camera, the 2D mean, covariance and
# conic), its SH colour at degree 3 (48 products and sums, +0.5, clamp),
# Adam on one parameter (two moments, bias correction, the update), and
# the loss at one pixel (five 11-tap separable blurs of 3 channels, the
# SSIM map and L1), its backward taken at twice the forward.
FLOP_UT_PARTICLE = 235
FLOP_SH_PARTICLE = 126
FLOP_ADAM_PARAM = 12
FLOP_LOSS_PIXEL = 700
PARAMS_PER_PARTICLE = 59
CHUNK = 128
PIX = 256


def bound_ms(nbytes: float, flops: float) -> float:
    """The least time the work can take: the larger of bytes over the
    bandwidth and operations over the float32 rate, in ms."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS) * 1e3


def walked_windows(walked: torch.Tensor, tile_starts: torch.Tensor) -> int:
    """128-slot windows a tile's walk of `walked` slots from its start
    covers (each holds B1's 16-byte live-row mask per pixel for B2)."""
    w = walked.long()
    s = tile_starts.long()
    n = torch.where(w > 0, (s + w - 1) // CHUNK - s // CHUNK + 1,
                    torch.zeros_like(w))
    return int(n.sum())


def b1_work(num_tiles: int, walked: torch.Tensor, tile_starts, mask: bool):
    """(bytes, operations) of one B1 launch: rays read and output written,
    the tile ranges, the walked slots' 64-byte rows, the live-row mask
    (`mask`: a train step's forward writes it for B2); the pair math of
    every (pixel, walked slot), its per-row part once per row (a tile's
    rays share one origin: every cell's camera is a global-shutter
    pinhole)."""
    slots = float(walked.double().sum())
    nbytes = (num_tiles * 8 * PIX * 4 * 2 + num_tiles * 8 + slots * 64
              + (16 * PIX * walked_windows(walked, tile_starts)
                 if mask else 0))
    ops = (FLOP_PAIR - FLOP_PAIR_ROW) * PIX * slots + FLOP_PAIR_ROW * slots
    return nbytes, ops


def b2_work(num_tiles: int, walked: torch.Tensor, tile_starts):
    """(bytes, operations) of one B2 launch: rays, forward output and
    cotangent read, the walked rows read and their gradients written, the
    mask read; the pair math of every (pixel, walked slot) (the chain and
    reduction of live pairs are not counted: which pairs live is known only
    to a re-run of the compositor)."""
    slots = float(walked.double().sum())
    nbytes = (num_tiles * 8 * PIX * 4 * 3 + num_tiles * 8 + slots * 64 * 2
              + 16 * PIX * walked_windows(walked, tile_starts))
    ops = (FLOP_PAIR - FLOP_PAIR_ROW) * PIX * slots + FLOP_PAIR_ROW * slots
    return nbytes, ops


def b7_work(num_bundles: int, windows: torch.Tensor, counted: torch.Tensor):
    """(bytes, operations) of one B7 launch: its walked windows' 64-float
    rows, rays read and output written, the window ranges; the pair math of
    every (ray, walked row), and the colour and blend of every counted
    pair."""
    w = float(windows.double().sum())
    c = float(counted.double().sum())
    nbytes = w * CHUNK * 64 * 4 + num_bundles * 8 * PIX * 4 * 2 \
        + num_bundles * 8
    ops = FLOP_GRT_PAIR * CHUNK * PIX * w + FLOP_GRT_COUNTED * c
    return nbytes, ops


def b8_work(num_bundles: int, windows: torch.Tensor, counted: torch.Tensor,
            grad_rows: int):
    """(bytes, operations) of one B8 launch: the walked windows' rows read,
    the [grad_rows, 64] gradient written, rays, output and cotangent read;
    per counted pair the pair math, the gradient chain and the reduction."""
    w = float(windows.double().sum())
    c = float(counted.double().sum())
    nbytes = (w * CHUNK * 64 * 4 + grad_rows * 64 * 4
              + num_bundles * 8 * PIX * 4 * 3 + num_bundles * 8)
    ops = (FLOP_GRT_PAIR + FLOP_GRT_BWD_CHAIN + FLOP_GRT_BWD_REDUCE) * c
    return nbytes, ops


def step_ops(particles: int, capacity: int, pixels: int, train: bool) -> float:
    """Operations of a step or frame outside the compositors: projection
    and SH colour of every particle, and in training the loss, its
    backward and Adam over every parameter of the capacity."""
    ops = (FLOP_UT_PARTICLE + FLOP_SH_PARTICLE) * particles
    if train:
        ops += 3 * FLOP_LOSS_PIXEL * pixels
        ops += FLOP_ADAM_PARAM * PARAMS_PER_PARTICLE * capacity
    return float(ops)


class LaunchRecorder:
    """Wraps the compositors' launch functions while a traced window runs
    and keeps, per launch, what its work count reads: a clone of the walk
    row of the output (one small copy kernel a launch, counted in
    `extra_kernels`). `work()` then sums bytes, operations and bounds per
    kernel."""

    def __init__(self):
        from threedgrut_torch.ops import bundle_trace, tile_raster
        self.mods = (tile_raster, bundle_trace)
        self.saved = {}
        self.records = {"b1": [], "b2": [], "b7": [], "b8": []}
        self.extra_kernels = 0

    def __enter__(self):
        tr, bt = self.mods
        self.saved = {(tr, "_launch"): tr._launch,
                      (tr, "_launch_backward"): tr._launch_backward,
                      (bt, "_launch"): bt._launch,
                      (bt, "_launch_backward"): bt._launch_backward}
        rec, orig = self.records, dict(self.saved)

        def b1(*args, **kw):
            out, flags = orig[(tr, "_launch")](*args, **kw)
            self.extra_kernels += 1
            rec["b1"].append((out.shape[0], out[:, 7, 0].clone(), args[1],
                              kw.get("order") is not None))
            return out, flags

        def b2(*args, **kw):
            grad = orig[(tr, "_launch_backward")](*args, **kw)
            self.extra_kernels += 1
            rec["b2"].append((args[4].shape[0], args[4][:, 7, 0].clone(),
                              args[1]))
            return grad

        def b7(*args, **kw):
            out = orig[(bt, "_launch")](*args, **kw)
            self.extra_kernels += 1
            rec["b7"].append((out.shape[0], out[:, 6:8].clone()))
            return out

        def b8(*args, **kw):
            grad = orig[(bt, "_launch_backward")](*args, **kw)
            self.extra_kernels += 1
            rec["b8"].append((args[4].shape[0], args[4][:, 6:8].clone(),
                              grad.shape[0]))
            return grad

        tr._launch, tr._launch_backward = b1, b2
        bt._launch, bt._launch_backward = b7, b8
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)

    def work(self) -> dict:
        """{kernel: {"launches", "bytes", "ops", "bound_ms"}} summed over
        the recorded launches."""
        out = {}
        for k, recs in self.records.items():
            tot_b = tot_o = tot_ms = 0.0
            for r in recs:
                if k == "b1":
                    b, o = b1_work(r[0], r[1], r[2], r[3])
                elif k == "b2":
                    b, o = b2_work(r[0], r[1], r[2])
                elif k == "b7":
                    b, o = b7_work(r[0], r[1][:, 1, 0], r[1][:, 0])
                else:
                    b, o = b8_work(r[0], r[1][:, 1, 0], r[1][:, 0], r[2])
                tot_b, tot_o = tot_b + b, tot_o + o
                tot_ms += bound_ms(b, o)
            out[k] = dict(launches=len(recs), bytes=tot_b, ops=tot_o,
                          bound_ms=tot_ms)
        return out


def kernel_pattern(kernel: str) -> str:
    """The substring that names a compositor's CUDA kernel in a trace."""
    return {"b1": "tile_raster_fwd_kernel", "b2": "tile_raster_bwd_kernel",
            "b7": "bundle_trace_fwd_kernel",
            "b8": "bundle_trace_bwd_kernel"}[kernel]
