"""The forward-render slice end to end: threedgrut_torch.api against
threedgrut_tpu.api on the same scene (512 Gaussians, SH degree 3, 64x64),
both visibility modes and the fused path, with the tolerances of
golden.compare; plus the scene loader, the options that are refused, and
the 3DGRT render's packed culls."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from threedgrut_tpu import api as japi
from threedgrut_tpu.cameras import FisheyeCamera as JFisheye
from threedgrut_tpu.cameras import PinholeCamera as JPinhole
from threedgrut_tpu.cameras import SensorPose as JPose
from threedgrut_tpu.cameras import ShutterType as JShutter
from threedgrut_tpu.cameras import pose_from_matrix as jpose
from threedgrut_tpu.model.gaussians import Gaussians as JGaussians
from threedgrut_torch import api as tapi
from threedgrut_torch import golden
from threedgrut_torch.cameras import (FisheyeCamera, SensorPose, ShutterType,
                                      example_camera, look_at,
                                      pose_from_matrix)
from threedgrut_torch.model.gaussians import FIELDS, bench_scene, from_numpy

RES = (64, 64)
CAP = 1 << 13


def scene():
    f = bench_scene(512, seed=1, specular_std=0.1)
    f["scale"] = f["scale"] + np.float32(np.log(10.0))
    return f


def camera_to_world():
    return look_at(np.array([0.5, -3.5, 1.2], np.float32),
                   np.zeros(3, np.float32),
                   np.array([0.0, 0.0, 1.0], np.float32))


def render_jax(fields, **kw):
    params = JGaussians(**{k: jnp.asarray(v) for k, v in fields.items()})
    w, h = RES
    cam = JPinhole(focal=jnp.asarray([0.9 * w, 0.9 * w], jnp.float32),
                   principal=jnp.asarray([w / 2, h / 2], jnp.float32),
                   radial=jnp.zeros(6), tangential=jnp.zeros(2),
                   thin_prism=jnp.zeros(4))
    return japi.render(params, cam, jpose(jnp.asarray(camera_to_world())),
                       RES, isect_capacity=CAP, **kw)


def render_torch(params, **kw):
    with torch.no_grad():
        return tapi.render(params, example_camera(RES, "cpu"),
                           pose_from_matrix(torch.tensor(camera_to_world())),
                           RES, isect_capacity=CAP, device="cpu", **kw)


@pytest.mark.parametrize("hit_visibility", [False, True])
def test_api_render_matches_jax(hit_visibility):
    f = scene()
    want, want_ovf = render_jax(f, hit_visibility=hit_visibility)
    got, got_ovf = render_torch(from_numpy(f, device="cpu"),
                                hit_visibility=hit_visibility)
    assert not bool(want_ovf) and not bool(got_ovf)
    assert got.rgb.shape == (64, 64, 3) and got.visibility.dtype == torch.bool
    rep, ok = golden.compare(got, want)
    assert ok, rep
    assert float(got.opacity.max()) > 0.5              # the frame shows much
    if hit_visibility:
        # Hit-based visibility refines the projector's: a subset, nonempty.
        proj_vis = render_torch(from_numpy(f, device="cpu"))[0].visibility
        assert not bool((got.visibility & ~proj_vis).any())
        assert 0 < int(got.visibility.sum()) < int(proj_vis.sum())


def test_api_render_options_match_jax():
    """The ported options of gut.render in one frame: a per-ray segment
    bound t_max, an explicit camera-to-world, sub-pixel ray jitter, and
    aux_outputs=False (depth and hit count left at zero)."""
    f = scene()
    rng = np.random.default_rng(9)
    t_max = rng.uniform(3.0, 4.5, (64, 64)).astype(np.float32)
    t_max[::2] = 0.0                                     # unbounded rows
    jitter = rng.uniform(0.2, 0.8, (64, 64, 2)).astype(np.float32)
    T = camera_to_world()
    kw = dict(t_max=t_max, ray_jitter=jitter, aux_outputs=False)
    want, _ = render_jax(f, T_to_world=jnp.asarray(T), aux_gradients=False,
                         **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                            else v for k, v in kw.items()})
    got, _ = render_torch(from_numpy(f, device="cpu"),
                          T_to_world=torch.tensor(T),
                          **{k: torch.tensor(v) if isinstance(v, np.ndarray)
                             else v for k, v in kw.items()})
    rep, ok = golden.compare(got, want)
    assert ok, rep
    assert float(got.depth.abs().max()) == 0.0
    assert float(got.hit_count.abs().max()) == 0.0
    full, _ = render_torch(from_numpy(f, device="cpu"))
    assert float((got.opacity - full.opacity).abs().max()) > 1e-3


def test_api_render_fisheye_rolling_shutter_matches_jax():
    """A fisheye camera (Newton-inverted rays) under a rolling shutter
    (per-pixel slerped poses in packed_world_rays, iterated projection)."""
    f = scene()
    params = JGaussians(**{k: jnp.asarray(v) for k, v in f.items()})
    start = pose_from_matrix(torch.tensor(camera_to_world()))
    q_end = start.q_start + torch.tensor([0.0, 0.02, -0.01, 0.01])
    pose = SensorPose(start.q_start, start.t_start, q_end / q_end.norm(),
                      start.t_start + torch.tensor([0.05, 0.0, -0.02]))
    cam = FisheyeCamera(focal=torch.tensor([30.0, 30.0]),
                        principal=torch.tensor([32.0, 32.0]),
                        radial=torch.tensor([0.05, -0.01, 0.002, 0.0]),
                        max_angle=torch.tensor(1.4))
    want, _ = japi.render(
        params, JFisheye(*(jnp.asarray(x.numpy()) for x in cam)),
        JPose(*(jnp.asarray(x.numpy()) for x in pose)), RES,
        isect_capacity=CAP, shutter=JShutter.ROLLING_TOP_TO_BOTTOM)
    with torch.no_grad():
        got, _ = tapi.render(from_numpy(f, device="cpu"), cam, pose, RES,
                             isect_capacity=CAP, device="cpu",
                             shutter=ShutterType.ROLLING_TOP_TO_BOTTOM)
    rep, ok = golden.compare(got, want)
    assert ok, rep
    assert float(got.opacity.max()) > 0.5


@pytest.mark.parametrize("walk_capacity", [CAP // 2, 256])
def test_walk_capacity_forward_matches_jax(walk_capacity):
    """The fused path (ops/fused_raster.py) renders the frame of the
    two-stage path and of JAX's fused path, within golden.compare."""
    f = scene()
    want, _ = render_jax(f, walk_capacity=walk_capacity)
    got, _ = render_torch(from_numpy(f, device="cpu"),
                          walk_capacity=walk_capacity)
    rep, ok = golden.compare(got, want)
    assert ok, rep
    plain, _ = render_torch(from_numpy(f, device="cpu"))
    for k in ("rgb", "opacity", "depth", "transmittance", "hit_count"):
        assert torch.equal(getattr(got, k), getattr(plain, k)), k


def test_overflow_is_reported_as_data():
    got, overflow = tapi.render(
        from_numpy(scene(), device="cpu"), example_camera(RES, "cpu"),
        pose_from_matrix(torch.tensor(camera_to_world())), RES,
        isect_capacity=256, device="cpu")
    assert bool(overflow)
    assert bool(torch.isfinite(got.rgb).all())


def test_load_scene_reads_the_jax_checkpoint_format(tmp_path):
    f = scene()
    path = tmp_path / "scene.npz"
    np.savez(path, **{f"params/{k}": v for k, v in f.items()})
    j = japi.load_scene(str(path))
    t = tapi.load_scene(str(path), device="cpu")
    for k in FIELDS:
        assert np.array_equal(np.asarray(getattr(j, k)),
                              getattr(t, k).detach().numpy()), k
    with pytest.raises(ValueError, match="unsupported scene format"):
        tapi.load_scene(str(tmp_path / "scene.obj"), device="cpu")


@pytest.mark.parametrize("kw,match", [
    # The sorted and row-terminated legs of the 3DGUT render are ported: a
    # negative pass count is refused, and the tracer takes no row
    # termination.
    (dict(sorted_passes=-1), "sorted_passes"),
    (dict(method="3dgrt", row_termination=True), "row_termination"),
])
def test_unported_options_raise(kw, match):
    err = {"sorted_passes": ValueError,
           "row_termination": TypeError}[match]
    with pytest.raises(err, match=match):
        render_torch(from_numpy(scene(), device="cpu"), **kw)


@pytest.fixture
def one_thread():
    """torch on one intra-op thread: a 3DGRT render on the CPU is many
    small ops, which under the parallel run's load stall on a pool's
    barriers (0.2 s alone, 30 s there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kw", [dict(packed_cull=True),
                                dict(packed_l1=True)])
def test_3dgrt_render_takes_the_packed_culls(one_thread, kw):
    """api.render(method="3dgrt") passes the packed culls to the trace. The
    scene's 16 tile bundles take the single-level cull (the two-level one
    needs 32), which the packed options leave alone: the frame is the
    exact cull's, bit for bit."""
    params = from_numpy(scene(), device="cpu")
    want, want_ovf = render_torch(params, method="3dgrt")
    got, got_ovf = render_torch(params, method="3dgrt", **kw)
    assert bool(got_ovf) == bool(want_ovf)
    for f in ("rgb", "opacity", "depth", "visibility"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert float(got.opacity.max()) > 0.1
