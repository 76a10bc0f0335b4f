"""Build and load the hand-written CUDA kernels of `threedgrut_torch/csrc/`.

Each source is compiled by nvcc for Hopper (sm_90a) into its own plain-C
shared library under `build/` at the repository root and loaded with ctypes.
A build happens on first use only (importing this module builds nothing);
the library name carries a hash of the source and flags, so an edited
source is rebuilt. `build()` compiles several sources at once, one nvcc
process each, all started together.

A kernel is a C entry of one source (`KERNELS`: name -> (source, renderers,
pass)); one source may hold several. Every wrapper that launches a kernel adds one to
`launches[name]` at the launch, so a caller can show that a path really went
through the kernels (`launches.clear()` resets the counts).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# source stem (csrc/<stem>.cu) -> extra nvcc flags. --fmad=false keeps every
# kernel's f32 arithmetic operation for operation that of its plain version:
# the binning kernels' culling and row extents are then bit-identical
# (csrc/tile_power.cuh), and the compositor's per-pair alpha too, so its
# acceptance tests never flip against the plain version on the card, and
# the backward accepts exactly the forward's hits (csrc/tile_pair.cuh).
SOURCES: Dict[str, tuple] = {
    "cull_masks": ("--fmad=false",),
    "expand_keys": ("--fmad=false",),
    "tile_raster_fwd": ("--fmad=false",),
    "tile_raster_bwd": ("--fmad=false",),
    "segment_sum": ("--fmad=false",),
    "bundle_trace_fwd": ("--fmad=false",),
    "bundle_trace_bwd": ("--fmad=false",),
    "stream_compact": ("--fmad=false",),
    "mesh_intersect": ("--fmad=false",),
}
# kernel (its C entry and launch counter) -> (source stem, the renderers
# whose paths launch it: "gut" the tile rasterizer, "grt" the tracer; the
# pass: "forward" in every render, "backward" only in a train step, "cull"
# only in the flat 3DGRT cull's compact_kernel leg, "diagnostic" on no
# path: the tests and chip_smoke.py call it). M1 is the playground's mesh
# test ("mesh"), which replaces no TPU kernel; mesh_intersect_masks is its
# cull alone.
KERNELS: Dict[str, Tuple[str, Tuple[str, ...], str]] = {
    "cull_masks": ("cull_masks", ("gut",), "forward"),              # B3
    "expand_keys": ("expand_keys", ("gut",), "forward"),            # B4
    "tile_raster_fwd": ("tile_raster_fwd", ("gut",), "forward"),    # B1
    "tile_raster_bwd": ("tile_raster_bwd", ("gut",), "backward"),   # B2
    "segment_sum_rows": ("segment_sum", ("gut",), "backward"),      # B5
    "segment_sum_rows_by_ids": ("segment_sum", ("gut", "grt"),
                                "backward"),                        # B6
    "bundle_trace_fwd": ("bundle_trace_fwd", ("grt",), "forward"),  # B7
    "bundle_trace_bwd": ("bundle_trace_bwd", ("grt",), "backward"),  # B8
    "compact_streams": ("stream_compact", ("grt",), "cull"),        # B9
    "mesh_intersect": ("mesh_intersect", ("mesh",), "forward"),     # M1
    "mesh_intersect_masks": ("mesh_intersect", ("mesh",), "diagnostic"),
}


def kernels_of(renderer: str, passes=("forward", "backward")):
    """Names of the kernels that `renderer`'s path launches in `passes`."""
    return [k for k, (_, r, p) in KERNELS.items()
            if renderer in r and p in passes]
_BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: collections.Counter = collections.Counter()
_loaded: Dict[str, ctypes.CDLL] = {}     # source -> library
_declared: set = set()                   # entries whose argtypes are set


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of threedgrut_torch "
                       "are compiled on first use and need the CUDA toolkit")


def _library_path(src: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{src}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(_BASE_FLAGS + SOURCES[src]).encode())
    return BUILD_DIR / f"lib{src}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the sources of the named kernels (default: all) that are not
    built yet, in parallel. Returns {source: nvcc's -Xptxas -v report} for
    those compiled; raises with nvcc's output if any compile fails."""
    srcs = sorted({KERNELS[n][0] for n in (KERNELS if names is None
                                           else names)})
    todo = [s for s in srcs if not _library_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for s in todo:
        tmp = _library_path(s).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_BASE_FLAGS, *SOURCES[s], "-o", str(tmp),
               str(CSRC / f"{s}.cu")]
        procs[s] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for s, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        reports[s] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {s}.cu (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, _library_path(s))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str, argtypes) -> ctypes.CDLL:
    """The loaded library holding kernel `name` (built on first use), with
    its C entry `name` declared as int(argtypes...)."""
    src = KERNELS[name][0]
    lib = _loaded.get(src)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(src)))
        _loaded[src] = lib
    if name not in _declared:
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _declared.add(name)
    return lib


def blocks_per_sm(lib: ctypes.CDLL, entry: str,
                  kernels) -> Dict[str, Tuple[int, int]]:
    """{kernel: (threads per block, blocks an SM of the current device holds
    at once)} for `kernels` ((label, threads) in the order in which the C
    entry `entry` of the loaded library `lib` writes its counts): the
    CUDA runtime's (cudaOccupancyMaxActiveBlocksPerMultiprocessor). The
    entry takes an int array and returns a CUDA error."""
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    out = (ctypes.c_int * len(kernels))()
    err = fn(out)
    if err:
        raise RuntimeError(f"{entry}: occupancy query failed (cudaError "
                           f"{err})")
    return {k: (t, int(b)) for (k, t), b in zip(kernels, out)}


def checked_inputs(*specs):
    """Validate (name, tensor, dtype, shape) kernel inputs before their
    pointers go to C: all on one CUDA device, of the dtype and shape,
    contiguous. Returns the tensors."""
    dev = specs[0][1].device
    for name, t, dtype, shape in specs:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, "
                             f"got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return [t for _, t, _, _ in specs]


def check_aligned(*specs):
    """Raise unless each (name, tensor, bytes) input starts at a multiple
    of `bytes`, as the kernel's vector loads need."""
    for name, t, nbytes in specs:
        if t.data_ptr() % nbytes:
            raise ValueError(f"{name} must start at a multiple of {nbytes} "
                             f"bytes")


def check(name: str, err: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
