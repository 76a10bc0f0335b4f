"""The golden image of threedgrut_torch/golden/ stays what the JAX reference
renders, and the port on the CPU reproduces it and the 3DGRT golden trace.

Run as `python -m tests.test_torch_golden` to rewrite the stored frame, as
`python -m tests.test_torch_golden grt` to rewrite the 3DGRT trace and as
`python -m tests.test_torch_golden sorted` to rewrite the sorted and
row-terminated frames."""
import hashlib
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from threedgrut_tpu import api as japi
from threedgrut_tpu.cameras import PinholeCamera as JPinhole
from threedgrut_tpu.cameras import pose_from_matrix as jpose
from threedgrut_tpu.model.gaussians import Gaussians as JGaussians
from threedgrut_torch import api as tapi
from threedgrut_torch import golden
from threedgrut_torch.cameras import example_camera, pose_from_matrix
from threedgrut_torch.model.gaussians import from_numpy


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch on one intra-op thread for the module (as
    tests/test_torch_grt.py): under the parallel run's load, the plain
    versions' many small ops stall on an 8-thread pool's barriers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def render_golden_jax(**kw):
    """JAX api.render outputs (hit_visibility=True) of the golden scene, with
    api.render keywords `kw`."""
    f = golden.scene()
    params = JGaussians(**{k: jnp.asarray(v) for k, v in f.items()})
    w, h = golden.RESOLUTION
    cam = JPinhole(focal=jnp.asarray([0.9 * w, 0.9 * w], jnp.float32),
                   principal=jnp.asarray([w / 2, h / 2], jnp.float32),
                   radial=jnp.zeros(6), tangential=jnp.zeros(2),
                   thin_prism=jnp.zeros(4))
    out, overflow = japi.render(
        params, cam, jpose(jnp.asarray(golden.camera_to_world())),
        golden.RESOLUTION, isect_capacity=golden.ISECT_CAPACITY,
        hit_visibility=True, **kw)
    assert not bool(overflow)
    return {k: np.asarray(getattr(out, k)) for k in golden.OUTPUTS}


def render_sorted_golden_jax():
    """The golden frame in every mode of golden.SORTED_MODES, keyed
    "<mode>/<output>"."""
    outs = {}
    for mode, kw in golden.SORTED_MODES.items():
        for k, v in render_golden_jax(**kw).items():
            outs[f"{mode}/{k}"] = v
    return outs


def trace_grt_golden_jax():
    """JAX api.trace outputs of the 3DGRT golden trace (Pallas compositor in
    interpret mode: minutes on the CPU)."""
    f = golden.scene()
    params = JGaussians(**{k: jnp.asarray(v) for k, v in f.items()})
    o, d = golden.grt_rays()
    out = japi.trace(params, jnp.asarray(o), jnp.asarray(d),
                     **golden.GRT_TRACE_KW)
    assert not bool(out.overflow)
    return {k: np.asarray(getattr(out, k)) for k in golden.OUTPUTS}


def _sources_and_scene():
    """A sha256 fed with every source file of the JAX package and the golden
    scene."""
    h = hashlib.sha256()
    root = Path(japi.__file__).resolve().parent
    for f in sorted(root.rglob("*.py")):
        h.update(str(f.relative_to(root)).encode())
        h.update(f.read_bytes())
    f = golden.scene()
    for k in sorted(f):
        h.update(k.encode())
        h.update(np.ascontiguousarray(f[k]).tobytes())
    return h


def grt_provenance() -> str:
    """sha256 of what the 3DGRT golden trace was made from: every source
    file of the JAX package (its trace path runs through most of them), the
    scene, the rays and the trace settings. The regenerator stores it in the
    file; a change to any of them makes the stored trace stale."""
    h = _sources_and_scene()
    for a in golden.grt_rays():
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(repr(sorted(golden.GRT_TRACE_KW.items())).encode())
    return h.hexdigest()


def sorted_provenance() -> str:
    """sha256 of what the sorted golden frames were made from: the JAX
    package's sources, the scene, the camera, the resolution, the capacity
    and each mode's keywords."""
    h = _sources_and_scene()
    h.update(np.ascontiguousarray(golden.camera_to_world()).tobytes())
    h.update(repr((golden.RESOLUTION, golden.ISECT_CAPACITY,
                   sorted((k, sorted(v.items()))
                          for k, v in golden.SORTED_MODES.items()))).encode())
    return h.hexdigest()


def test_golden_file_matches_jax():
    """Regenerate with JAX: the stored file is still the reference's output
    (same machine class, same XLA CPU math: 1e-6 absolute)."""
    fresh = render_golden_jax()
    stored = golden.load()
    for k in golden.OUTPUTS:
        assert stored[k].shape == fresh[k].shape, k
        np.testing.assert_allclose(stored[k].astype(np.float32),
                                   fresh[k].astype(np.float32), atol=1e-6,
                                   err_msg=k)
    # A golden frame that shows nothing would hold nothing.
    assert (stored["opacity"] > 0.1).mean() > 0.05


def test_port_matches_golden_on_cpu():
    """The port's plain path reproduces the stored JAX frame, within the
    tolerances of golden.compare."""
    params = from_numpy(golden.scene(), device="cpu")
    T = torch.as_tensor(golden.camera_to_world())
    with torch.no_grad():
        out, overflow = tapi.render(
            params, example_camera(golden.RESOLUTION, "cpu"),
            pose_from_matrix(T), golden.RESOLUTION,
            isect_capacity=golden.ISECT_CAPACITY, hit_visibility=True,
            device="cpu")
    assert not bool(overflow)
    rep, ok = golden.compare(out, golden.load())
    assert ok, rep


@pytest.mark.parametrize("flat_cull", [False, True])
def test_port_matches_grt_golden_on_cpu(flat_cull):
    """The port's trace (plain B7 on the CPU), on the dense and on the flat
    two-level cull, reproduces the stored JAX 3DGRT golden trace within
    golden.compare, and the trace shows much."""
    params = from_numpy(golden.scene(), device="cpu")
    o, d = golden.grt_rays()
    with torch.no_grad():
        out = tapi.trace(params, o, d, device="cpu", flat_cull=flat_cull,
                         **golden.GRT_TRACE_KW)
    assert not bool(out.overflow)
    want = golden.load_grt()
    rep, ok = golden.compare(out, want)
    assert ok, rep
    assert (want["opacity"] > 0.5).mean() > 0.5
    assert want["hit_count"].max() > 16


def test_grt_golden_file_is_current():
    """The stored 3DGRT golden trace was made by this JAX package from these
    inputs (re-tracing it with JAX takes minutes, so its provenance hash
    stands in): rewrite it with `python -m tests.test_torch_golden grt`
    when this fails."""
    with np.load(golden.GRT_PATH) as d:
        stored = str(d["provenance"])
    assert stored == grt_provenance()


@pytest.mark.parametrize("mode", sorted(golden.SORTED_MODES))
def test_port_matches_sorted_golden_on_cpu(mode):
    """The port's plain path reproduces the stored JAX frame in the sorted
    and the row-terminated mode (the flags leg gives the visibility),
    within golden.compare."""
    params = from_numpy(golden.scene(), device="cpu")
    T = torch.as_tensor(golden.camera_to_world())
    with torch.no_grad():
        out, overflow = tapi.render(
            params, example_camera(golden.RESOLUTION, "cpu"),
            pose_from_matrix(T), golden.RESOLUTION,
            isect_capacity=golden.ISECT_CAPACITY, hit_visibility=True,
            device="cpu", **golden.SORTED_MODES[mode])
    assert not bool(overflow)
    rep, ok = golden.compare(out, golden.load_sorted(mode))
    assert ok, rep


def test_sorted_golden_file_is_current():
    """The stored sorted golden frames were made by this JAX package from
    these inputs: rewrite them with `python -m tests.test_torch_golden
    sorted` when this fails. The 16 passes change the frame against the
    default golden frame (else the file would hold nothing new)."""
    with np.load(golden.SORTED_PATH) as d:
        stored = str(d["provenance"])
    assert stored == sorted_provenance()
    d = np.abs(golden.load_sorted("sorted")["rgb"] - golden.load()["rgb"])
    assert d.max() > 1e-3


if __name__ == "__main__":
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    if sys.argv[1:] == ["grt"]:
        path, outs = golden.GRT_PATH, trace_grt_golden_jax()
        outs["provenance"] = np.array(grt_provenance())
    elif sys.argv[1:] == ["sorted"]:
        path, outs = golden.SORTED_PATH, render_sorted_golden_jax()
        outs["provenance"] = np.array(sorted_provenance())
    else:
        path, outs = golden.PATH, render_golden_jax()
    np.savez_compressed(path, **outs)
    print("wrote", path, path.stat().st_size, "bytes")
