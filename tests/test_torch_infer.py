"""Frame-coherent inference (threedgrut_torch/render/infer.py) against the
JAX package's render/infer.py on the same numpy inputs: tests/test_infer.py's
scene (256 particles, 64x64, capacity 2048) for the compaction, the refresh,
render_compact, capture_binning and render_frozen on a stale binning. The
JAX side runs once per module (its Pallas kernels in interpret mode); one
scene and one resolution throughout, as every new shape costs the JAX side
~20 s of tracing, more than its frozen frame itself.

Tolerances: compaction, visibility and binning exactly equal (the same
census, cumsum and sorts); frames within 2e-6 (test_infer.py's bound for the
compact frame: the same per-pair arithmetic, summed in another order);
render_frozen (B1's sorted leg) within golden.compare."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_cameras import IDENTITY_POSE, make_pinhole
from tests.test_gut_reference import random_scene
from tests.test_torch_grt import single_thread  # noqa: F401 (autouse)
from threedgrut_torch import golden
from threedgrut_torch.cameras import PinholeCamera, SensorPose
from threedgrut_torch.render import gut as tgut
from threedgrut_torch.render import infer as tinfer
from threedgrut_tpu.cameras import SensorPose as JPose
from threedgrut_tpu.render import gut as jgut
from threedgrut_tpu.render import infer as jinfer

RES = (64, 64)
CAP = 2048
THRESHOLDS = (0.0, 1.0 / 255.0, 0.05)
# The frozen frame's camera: the refresh camera moved a little, so that the
# captured binning is stale.
FROZEN_T = (0.03, -0.02, 0.01)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch on one intra-op thread for the module (as
    tests/test_torch_grt.py): under the parallel run's load, the plain
    versions' many small ops stall on an 8-thread pool's barriers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_scene(n=256, seed=5):
    return tuple(np.asarray(x) for x in random_scene(n=n, seed=seed))


def tcam(f, c):
    z = torch.zeros
    return PinholeCamera(torch.tensor([f, f]), torch.tensor([c, c]),
                         z(6), z(2), z(4))


def tpose(t=(0.0, 0.0, 0.0)):
    q = torch.tensor([1.0, 0.0, 0.0, 0.0])
    tt = torch.tensor(t, dtype=torch.float32)
    return SensorPose(q, tt, q, tt)


def jpose(t=(0.0, 0.0, 0.0)):
    return JPose(*(jnp.asarray(x.numpy()) for x in tpose(t)))


def tensors(scene):
    return tuple(torch.tensor(x) for x in scene)


def np_of(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


CAM_J, CAM_T = make_pinhole(f=120.0, cx=32.0, cy=32.0), tcam(120.0, 32.0)


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX output the tests compare with, each computed once."""
    scene = np_scene()
    js = tuple(jnp.asarray(x) for x in scene)
    full, _ = jgut.render(*js, CAM_J, IDENTITY_POSE, RES, CAP,
                          aux_gradients=False, aux_outputs=False)
    runs = {"full": full}
    for t in THRESHOLDS:
        out, ovf, sc = jinfer.refresh(*js, CAM_J, IDENTITY_POSE, RES, CAP,
                                      n_compact=256, visibility_threshold=t)
        comp, covf = jinfer.render_compact(sc, CAM_J, IDENTITY_POSE, RES,
                                           CAP)
        runs[t] = dict(out=out, ovf=ovf, scene=sc, compact=comp, covf=covf)
    runs["capture"] = jinfer.capture_binning(runs[0.0]["scene"], CAM_J,
                                             IDENTITY_POSE, RES, CAP)
    runs["frozen"] = jinfer.render_frozen(runs[0.0]["scene"], runs["capture"],
                                          CAM_J, jpose(FROZEN_T), RES)
    return runs


def torch_scene_of(jscene):
    """A JAX CompactScene as the port's, field by field."""
    return tinfer.CompactScene(*(torch.tensor(np_of(x)) for x in jscene))


def assert_scenes_equal(got, want):
    for name, g, w in zip(tinfer.CompactScene._fields, got, want):
        assert np.array_equal(np_of(g), np_of(w)), name


@pytest.mark.parametrize("n_compact", [8, 5, 4, 300])
def test_compact_visible_matches_jax(n_compact):
    """An explicit visibility mask: the stable order, the dead tail, the
    count and the overflow flag (n_compact 4 < 5 visible); above N the
    scene keeps N rows, as JAX's slice does."""
    scene = np_scene()
    vis = np.zeros(256, bool)
    vis[[3, 7, 100, 200, 255]] = True
    want = jinfer.compact_visible(*(jnp.asarray(x) for x in scene),
                                  jnp.asarray(vis), n_compact)
    got = tinfer.compact_visible(*tensors(scene), torch.tensor(vis),
                                 n_compact, device="cpu")
    assert_scenes_equal(got, want)
    assert got.positions.shape[0] == min(n_compact, 256)
    assert bool(got.overflow) == (n_compact < 5)
    assert got.src_idx.dtype == torch.int32 and got.count.dtype == torch.int32


@pytest.mark.parametrize("t", THRESHOLDS)
def test_refresh_matches_jax(jax_runs, t):
    want = jax_runs[t]
    out, ovf, sc = tinfer.refresh(*tensors(np_scene()), CAM_T, tpose(), RES,
                                  CAP, n_compact=256, visibility_threshold=t,
                                  device="cpu")
    assert not bool(ovf) and not bool(want["ovf"])
    for k in ("rgb", "opacity"):
        np.testing.assert_allclose(np_of(getattr(out, k)),
                                   np_of(getattr(want["out"], k)), atol=2e-6,
                                   err_msg=k)
    assert np.array_equal(np_of(out.visibility),
                          np_of(want["out"].visibility))
    assert_scenes_equal(sc, want["scene"])


def test_render_compact_matches_jax(jax_runs):
    """At the refresh camera the compact frame of each threshold equals
    JAX's; at threshold 0 it equals the full frame (within 2e-6), the
    counts fall as the threshold rises, and the error stays within
    test_infer.py's bound."""
    full, _ = tgut.render(*tensors(np_scene()), CAM_T, tpose(), RES, CAP,
                          aux_gradients=False, aux_outputs=False,
                          device="cpu")
    np.testing.assert_allclose(np_of(full.rgb),
                               np_of(jax_runs["full"].rgb), atol=2e-6)
    counts = []
    for t in THRESHOLDS:
        want = jax_runs[t]
        sc = torch_scene_of(want["scene"])
        out, ovf = tinfer.render_compact(sc, CAM_T, tpose(), RES, CAP,
                                         device="cpu")
        assert not bool(ovf) and not bool(want["covf"])
        for k in ("rgb", "opacity"):
            np.testing.assert_allclose(np_of(getattr(out, k)),
                                       np_of(getattr(want["compact"], k)),
                                       atol=2e-6, err_msg=f"{k} at {t}")
        err = float((out.rgb - full.rgb).abs().max())
        assert err < 200.0 * t + 1e-5, (t, err)
        if t == 0.0:
            np.testing.assert_allclose(np_of(out.opacity),
                                       np_of(full.opacity), atol=2e-6)
        counts.append(int(sc.count))
    assert counts[0] >= counts[1] >= counts[2]
    assert counts[2] < counts[0]


def test_capture_binning_matches_jax(jax_runs):
    want = jax_runs["capture"]
    got = tinfer.capture_binning(torch_scene_of(jax_runs[0.0]["scene"]),
                                 CAM_T, tpose(), RES, CAP, device="cpu")
    for name, g, w in zip(tinfer.FrozenBinning._fields, got, want):
        assert g.dtype in (torch.int32, torch.bool), name
        assert np.array_equal(np_of(g), np_of(w)), name
    assert int(got.tile_ends.max()) > 0


def test_render_frozen_matches_jax(jax_runs):
    """B1's 16-pass sorted leg on a binning captured at the refresh camera
    and reused at a moved one: within golden.compare of JAX's frame."""
    sc = torch_scene_of(jax_runs[0.0]["scene"])
    fb = tinfer.capture_binning(sc, CAM_T, tpose(), RES, CAP, device="cpu")
    out = tinfer.render_frozen(sc, fb, CAM_T, tpose(FROZEN_T), RES,
                               device="cpu")
    frame = lambda o: {k: getattr(o, k) for k in golden.FLIP_BOUND} | {
        "hit_count": o.hit_count, "visibility": np.zeros(0, bool)}
    rep, ok = golden.compare(frame(out), frame(jax_runs["frozen"]))
    assert ok, rep
    assert float(out.opacity.max()) > 0.5
    # The binning is stale: the moved camera's own frame differs.
    fresh, _ = tinfer.render_compact(sc, CAM_T, tpose(FROZEN_T), RES, CAP,
                                     device="cpu")
    assert float((fresh.rgb - out.rgb).abs().max()) > 1e-3


def test_render_frozen_visibility_c5(jax_runs):
    """ROADMAP C5: JAX's render_frozen returns an all-False visibility
    although its frame shows particles; the port runs no census there and
    returns None."""
    want = jax_runs["frozen"]
    assert not bool(np_of(want.visibility).any())
    assert float(np_of(want.opacity).max()) > 0.5
    sc = torch_scene_of(jax_runs[0.0]["scene"])
    fb = tinfer.capture_binning(sc, CAM_T, tpose(), RES, CAP, device="cpu")
    out = tinfer.render_frozen(sc, fb, CAM_T, tpose(), RES, device="cpu")
    assert out.visibility is None
