"""Golden outputs from the JAX reference, for holding the port against it
where JAX is not installed (the card's machine), and the tolerances a
rendered frame is held to against any reference frame (`compare`).

`gut_2k_64.npz` holds the JAX package's `api.render` outputs, rendered on
the CPU, for the scene and camera defined here: 2000 Gaussians of the
seeded benchmark scene (SH degree 3, nonzero specular), scales raised 8x so
that splats cover pixels at 64x64, seen from (0, -4, 1). The test
`tests/test_torch_golden.py` renders it again with JAX and checks the stored
file, so it cannot go stale; `python -m tests.test_torch_golden` rewrites it.

`grt_2k_128.npz` holds the JAX package's `api.trace` outputs (3DGRT, the
bundle route with 16 re-sort passes) for the same scene and a 128x128 grid
of rays from (0, -4, 1) in 16x16-tile order: 64 bundles, so the two-level
cull runs (super capacity 1024 < 2000 Gaussians), with no overflow.
Regenerating it runs the Pallas compositor in interpret mode for minutes, so
no test does; the file also stores a hash of the JAX package's sources and
of these inputs, which the same test file checks, and `python -m
tests.test_torch_golden grt` rewrites it.

`gut_sorted_2k_64.npz` holds the JAX package's `api.render` outputs
(hit_visibility=True) of the golden frame in the two modes of SORTED_MODES:
16 re-sort passes (the "sorted" k-buffer mode of preset_3dgut_sorted) and
row termination, under the keys "<mode>/<output>". It stores a provenance
hash as the 3DGRT file does; `python -m tests.test_torch_golden sorted`
rewrites it.

`dp_2x2.npz` holds one step of the JAX package's data-parallel trainer
(parallel/dp.make_dp_train_step with debug_grads) on a (data 2, tile 2,
model 1) mesh of virtual CPU devices, on tests/test_parallel.py's scene
(64 slots, 32x32, views 0 and 1): the step's inputs ("params/<field>",
"T_to_world", "rgb_gt", "scene_extent") and outputs ("grads/<field>",
"loss", "psnr", "pos_grad_norm", "visibility", "overflow"), with a
provenance hash (`dp_provenance`). `python tools/torch_dp_golden.py`
rewrites it.
"""
from __future__ import annotations

import hashlib
import math
from pathlib import Path
from typing import Dict

import numpy as np

from threedgrut_torch.cameras import look_at
from threedgrut_torch.model.gaussians import bench_scene

PATH = Path(__file__).resolve().parent / "gut_2k_64.npz"
GRT_PATH = Path(__file__).resolve().parent / "grt_2k_128.npz"
SORTED_PATH = Path(__file__).resolve().parent / "gut_sorted_2k_64.npz"
DP_PATH = Path(__file__).resolve().parent / "dp_2x2.npz"
# api.render keywords of each mode of the sorted golden file.
SORTED_MODES = {"sorted": dict(sorted_passes=16),
                "rowterm": dict(row_termination=True)}
N = 2000
RESOLUTION = (64, 64)
ISECT_CAPACITY = 1 << 13
OUTPUTS = ("rgb", "opacity", "depth", "transmittance", "hit_count",
           "visibility")

# Largest difference allowed where a threshold flip moved a value (compare).
FLIP_BOUND = {"rgb": 0.05, "opacity": 0.05, "depth": 0.1,
              "transmittance": 0.05}
# compare's share of values allowed to flip, for a whole 3DGRT trace run on
# two devices. The cone cull's arithmetic (activations, means, dot
# products) rounds differently on the card and the CPU, so a particle at a
# cone's margin can enter a bundle's list on one side only (10 of 64
# bundles at bench_grt's 100k scene). It composites nothing itself, but the
# bundle's later candidates move by a row, windows break at other rows, and
# the 16-pass re-sort, bounded to a window, orders some rays' hits
# differently: hit counts move by 1 on ~0.2% of rays there.
TRACE_FLIP_SHARE = 5e-3


def scene() -> Dict[str, np.ndarray]:
    """Raw Gaussian fields of the golden scene (capacity-padded numpy)."""
    f = bench_scene(N, seed=0, specular_std=0.1)
    f["scale"] = f["scale"] + np.float32(np.log(8.0))
    return f


def camera_to_world() -> np.ndarray:
    return look_at(np.array([0.0, -4.0, 1.0], np.float32),
                   np.zeros(3, np.float32),
                   np.array([0.0, 0.0, 1.0], np.float32))


GRT_SIDE = 128
# grt.trace keywords of the 3DGRT golden trace (candidate counts are at
# most 340 per bundle and 930 per super list there).
GRT_TRACE_KW = dict(kernel_degree=4, candidate_capacity=512,
                    super_capacity=1024, flat_capacity=1 << 14,
                    sorted_passes=16)


def grt_rays():
    """(origins, unit directions) [128*128, 3] float32 of the 3DGRT golden
    trace: a pinhole-like grid from (0, -4, 1) looking along +y and slightly
    down, in 16x16-tile (bundle) order."""
    side = GRT_SIDE
    o = np.tile(np.array([[0.0, -4.0, 1.0]], np.float32), (side * side, 1))
    px = (np.arange(side) + 0.5) / side * 0.8 - 0.4
    gx, gy = np.meshgrid(px, px, indexing="xy")
    d = np.stack([gx, np.ones_like(gx), -gy - 0.25], -1).astype(np.float32)
    t = side // 16
    d = d.reshape(t, 16, t, 16, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 3)
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def load_grt() -> Dict[str, np.ndarray]:
    """The stored JAX outputs of the 3DGRT golden trace."""
    with np.load(GRT_PATH) as d:
        return {k: d[k] for k in OUTPUTS}


def load_sorted(mode: str) -> Dict[str, np.ndarray]:
    """The stored JAX outputs of the golden frame in mode `mode` of
    SORTED_MODES (hit_visibility=True render)."""
    with np.load(SORTED_PATH) as d:
        return {k: d[f"{mode}/{k}"] for k in OUTPUTS}


def load_dp() -> Dict[str, np.ndarray]:
    """The stored inputs and outputs of the JAX data-parallel step."""
    with np.load(DP_PATH) as d:
        return {k: d[k] for k in d.files}


def dp_provenance(sources: Path, arrays: Dict[str, np.ndarray],
                  settings: Dict) -> str:
    """sha256 of what the data-parallel golden step was made from: every
    .py file under `sources` (the JAX package's directory; read as bytes),
    the step's input arrays and its settings."""
    h = hashlib.sha256()
    sources = Path(sources)
    for f in sorted(sources.rglob("*.py")):
        h.update(str(f.relative_to(sources)).encode())
        h.update(f.read_bytes())
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    h.update(repr(sorted(settings.items())).encode())
    return h.hexdigest()


def load() -> Dict[str, np.ndarray]:
    """The stored JAX outputs (hit_visibility=True render)."""
    with np.load(PATH) as d:
        return {k: d[k] for k in OUTPUTS}


def compare(got, want, flip_share: float = 1e-3):
    """Differences of the frame `got` against the reference frame `want`
    (objects or dicts with the RenderOutputs fields; tensors on any device
    or arrays) and whether they lie within the port's tolerances. Returns
    (report, ok). `flip_share` (default 0.1%) is the share of values
    allowed to flip, as below; TRACE_FLIP_SHARE for a whole 3DGRT trace
    run on two devices.

    Tolerances and why:
      * rgb, opacity, depth, transmittance: atol 2e-4, rtol 1e-4 on all but
        0.1% of the values (at least one). The port sums colours in another
        order than the reference (sequential or cumprod vs Hillis-Steele
        products and HIGHEST matmuls) and takes exp from another library
        (XLA's or Sleef's on the CPU, CUDA's expf on the card), which moves
        results by ~1e-6 relative.
      * the other 0.1%: a hit whose response or alpha sits at an acceptance
        threshold (response 0.0113, alpha 1/255) can be accepted on one side
        only. Such a hit carries alpha <= 0.0113 and scales the rest of its
        ray by at most 1.1%, so those values stay within FLIP_BOUND (0.1 for
        depth, whose hit distances reach ~5 scene units).
      * hit count: the same flips, and flips of `T > min_transmittance` for
        a contribution of at most ~1e-4, move a pixel's count by 1; allowed
        on at most 0.1% of pixels (at least one), never by more than 1.
      * visibility: the same flips can decide whether a particle contributed
        at all; allowed on at most 0.1% of particles (at least one).
    """
    def field(o, k):
        x = o[k] if isinstance(o, dict) else getattr(o, k)
        x = x.detach().cpu().numpy() if hasattr(x, "detach") else x
        return np.asarray(x)

    def allowed(size):
        return max(1, math.floor(flip_share * size))

    rep, ok = {}, True
    for k, bound in FLIP_BOUND.items():
        a = field(got, k).astype(np.float64)
        b = field(want, k).astype(np.float64)
        d = np.abs(a - b)
        loose = int((d > 2e-4 + 1e-4 * np.abs(b)).sum())
        rep[k] = float(d.max())
        rep[k + "_loose"] = loose
        ok &= loose <= allowed(d.size) and rep[k] <= bound
    dh = np.abs(field(got, "hit_count").astype(np.float64)
                - field(want, "hit_count").astype(np.float64))
    rep["hit_count"] = float(dh.max())
    rep["hit_count_pixels"] = int((dh > 0).sum())
    ok &= rep["hit_count"] <= 1 and rep["hit_count_pixels"] <= allowed(
        dh.size)
    dv = field(got, "visibility") != field(want, "visibility")
    rep["visibility_diff"] = int(dv.sum())
    ok &= rep["visibility_diff"] <= allowed(dv.size)
    return rep, bool(ok)


def rows_agree(got, want, rel_atol: float):
    """Per-particle values (rows: gradients, moments, parameters) of two
    runs: a row is loose where some entry differs by more than rel_atol x
    max|want|. Returns (report, ok); ok allows loose rows on at most 0.1%
    of the rows (at least one), compare()'s allowance for a hit that sits at
    an acceptance threshold on one side only, which moves the gradients of
    the particles it touches."""
    def arr(x):
        x = x.detach().cpu().numpy() if hasattr(x, "detach") else x
        return np.asarray(x, np.float64).reshape(np.shape(x)[0], -1)

    a, b = arr(got), arr(want)
    d = np.abs(a - b)
    bound = rel_atol * float(np.abs(b).max())
    loose = int((d > bound).any(1).sum())
    rep = {"max_abs": float(d.max()), "bound": bound, "loose_rows": loose}
    return rep, loose <= max(1, math.floor(1e-3 * a.shape[0]))


def bundle_lists(flat_idx, valid, win_starts, win_ends):
    """Each bundle's candidate ids (numpy arrays) from the flat layout of a
    cull: the valid rows of its windows [win_starts, win_ends), 128 rows
    each."""
    def arr(x):
        return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                          else x)

    fi, v, ws, we = (arr(x) for x in (flat_idx, valid, win_starts, win_ends))
    return [fi[a * 128:b * 128][v[a * 128:b * 128]] for a, b in
            zip(ws.tolist(), we.tolist())]


def lists_agree(got, want, flip_share: float = 0.0):
    """Two culls' per-bundle candidate lists (sequences of particle ids).
    Ids in one list only are cone-margin flips (see TRACE_FLIP_SHARE); the
    ids both hold must come in the same order, except that a run of
    positions may hold the same ids in another order (equal depths, whose
    ties two culls may break differently: super-list position against
    particle id). Returns (report, ok); ok allows flips and reordered
    positions each on at most `flip_share` of the candidates (0: the lists
    are equal)."""
    flipped = flip_bundles = reordered = bad_runs = total = 0
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        total += len(w)
        common = np.intersect1d(g, w)
        nf = len(g) + len(w) - 2 * len(common)
        flipped += nf
        flip_bundles += nf > 0
        gc, wc = g[np.isin(g, common)], w[np.isin(w, common)]
        diff = np.flatnonzero(gc != wc)
        for run in np.split(diff, np.flatnonzero(np.diff(diff) > 1) + 1):
            if len(run):
                reordered += len(run)
                bad_runs += set(gc[run].tolist()) != set(wc[run].tolist())
    rep = {"bundles": len(want), "candidates": total, "flipped": flipped,
           "bundles_with_flips": flip_bundles, "reordered": reordered,
           "runs_not_permutations": bad_runs}
    allowed = flip_share * total
    ok = (len(got) == len(want) and bad_runs == 0 and flipped <= allowed
          and reordered <= allowed)
    return rep, bool(ok)
