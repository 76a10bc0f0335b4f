"""The 3DGRT trace slice: threedgrut_torch.render.grt and ops/bundle_trace
against threedgrut_tpu on the same numpy inputs.

Exact: the cone culls (counts, overflow, visibility, candidate sets, and the
candidate order on a depth-separated scene), bundle_morton_order and the six
outputs of flatten_candidates (except where the JAX package's fault C6
applies, which is asserted as a divergence). allclose 1e-6: bounding_radius,
make_super_bundles, pack_rows64 (the same f32 formulas; XLA and torch may
round a few operations differently). The plain B7 against the JAX kernel in
interpret mode: rgb, opacity, transmittance atol 2e-5, depth 1e-4 (sums of
~1e-5-relative terms, Hillis-Steele products there against sequential ones
here), hits and walked windows exact. Traces against JAX's exact ray order
and naive oracle: the same, depth also rtol 2e-5 (hit distances up to ~20).

Three calls reach the JAX compositor (interpret mode, slow), none with a
gradient, at most 4 bundles each; they are shared through module fixtures.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_grt import coherent_rays, separated_scene, surfel_scene
from tests.test_gut_reference import random_scene
from threedgrut_tpu import constants as JC
from threedgrut_tpu import trainer as jtrainer
from threedgrut_tpu.cameras import PinholeCamera as JPinhole
from threedgrut_tpu.config import preset_3dgrt as jpreset_3dgrt
from threedgrut_tpu.model import gaussians as jg
from threedgrut_tpu.ops.pallas import bundle_trace as jbt
from threedgrut_tpu.render import grt as jgrt
from threedgrut_torch import api as tapi
from threedgrut_torch import golden
from threedgrut_torch import optimizers as topt
from threedgrut_torch import trainer as ttrainer
from threedgrut_torch.cameras import PinholeCamera, look_at, pose_from_matrix
from threedgrut_torch.config import preset_3dgrt
from threedgrut_torch.model.gaussians import bench_scene, from_numpy
from threedgrut_torch.ops import bundle_trace
from threedgrut_torch.render import grt

DEG = JC.KERNEL_DEGREE_3DGRT


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch on one intra-op thread for the module. The plain versions run
    many small torch ops; under the parallel test run's load an 8-thread
    intra-op pool spends most of its time waiting on its own barriers (a
    0.2 s test took 25-60 s), one thread does not."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def npy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def tt(*xs):
    return [torch.tensor(np.asarray(x)) for x in xs]


def fanned_rays(nb=32, seed=9, fan=0.08):
    """nb coherent 256-ray bundles fanned over a scene at z ~ 3."""
    rng = np.random.default_rng(seed)
    os_, ds_ = [], []
    for b in range(nb):
        ang = 2 * np.pi * b / nb
        o = np.tile(np.array([0.3 * np.cos(ang), 0.3 * np.sin(ang), -1.0],
                             np.float32), (256, 1))
        d = np.stack([fan * np.cos(ang) + rng.uniform(-0.1, 0.1, 256),
                      fan * np.sin(ang) + rng.uniform(-0.1, 0.1, 256),
                      np.ones(256)], -1).astype(np.float32)
        os_.append(o)
        ds_.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return np.concatenate(os_), np.concatenate(ds_).astype(np.float32)


@pytest.fixture(scope="module")
def cull():
    """A 512-particle scene, 32 fanned bundles (the two super cones see
    390 and 402 particles): numpy inputs of the culls."""
    pos, quat, scale, opa, _ = map(np.asarray,
                                   random_scene(n=512, seed=5, spread=1.5))
    o, d = fanned_rays(fan=0.4)
    radius = np.asarray(jgrt.bounding_radius(jnp.asarray(scale),
                                             jnp.asarray(opa), DEG))
    return dict(pos=pos, scale=scale, opa=opa, radius=radius,
                valid=opa >= JC.MIN_ALPHA, o=o, d=d)


def assert_candidates(jres, tres, exact_order):
    """(cand_idx, counts, overflow, visibility) of JAX and the port: counts,
    overflow and visibility equal; per bundle the same candidate set, in
    the same order when `exact_order`."""
    jci, jcn, jov, jvis = map(npy, jres)
    tci, tcn, tov, tvis = map(npy, tres)
    np.testing.assert_array_equal(tcn, jcn)
    assert bool(tov) == bool(jov)
    np.testing.assert_array_equal(tvis, jvis)
    assert tci.shape == jci.shape and tci.dtype == np.int32
    for b in range(jcn.shape[0]):
        k = int(jcn[b])
        if exact_order:
            np.testing.assert_array_equal(tci[b, :k], jci[b, :k])
        else:
            assert set(tci[b, :k]) == set(jci[b, :k]), b
    assert jcn.sum() > 0


@pytest.mark.parametrize("density_clamping", [False, True])
def test_bounding_radius_matches_jax(cull, density_clamping):
    want = jgrt.bounding_radius(jnp.asarray(cull["scale"]),
                                jnp.asarray(cull["opa"]), DEG,
                                density_clamping=density_clamping)
    got = grt.bounding_radius(*tt(cull["scale"], cull["opa"]), DEG,
                              density_clamping=density_clamping)
    np.testing.assert_allclose(npy(got), npy(want), rtol=1e-6, atol=1e-7)


def test_morton_order_and_super_bundles_match_jax(cull):
    jb = jgrt.make_bundles(jnp.asarray(cull["o"]), jnp.asarray(cull["d"]),
                           256)
    tb = grt.make_bundles(*tt(cull["o"], cull["d"]), 256)
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(npy(a), npy(b), rtol=1e-6, atol=1e-6)
    jperm = jgrt.bundle_morton_order(jb)
    tperm = grt.bundle_morton_order(tb)
    np.testing.assert_array_equal(npy(tperm), npy(jperm))
    assert len(set(npy(tperm))) == 32
    js = jgrt.make_super_bundles(jb, jperm, 16)
    ts = grt.make_super_bundles(tb, tperm, 16)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(npy(a), npy(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("capacity", [64, 24])
def test_bundle_candidates_match_jax(cull, capacity):
    """The single-level cull; capacity 24 overflows (nearest kept)."""
    c = cull
    jb = jgrt.make_bundles(jnp.asarray(c["o"]), jnp.asarray(c["d"]), 256)
    jres = jgrt.bundle_candidates(jnp.asarray(c["pos"]),
                                  jnp.asarray(c["radius"]),
                                  jnp.asarray(c["valid"]), jb, capacity)
    tb = grt.make_bundles(*tt(c["o"], c["d"]), 256)
    tres = grt.bundle_candidates(*tt(c["pos"], c["radius"], c["valid"]), tb,
                                 capacity)
    assert_candidates(jres, tres, exact_order=False)
    assert bool(npy(tres[2])) == (capacity == 24)


@pytest.mark.parametrize("super_capacity,capacity", [(448, 64), (320, 40)])
def test_twolevel_candidates_match_jax(cull, super_capacity, capacity):
    """The two-level cull with N = 512 > super_capacity; (320, 40)
    overflows both levels (nearest kept)."""
    c = cull
    args = (c["pos"], c["radius"], c["valid"], c["o"], c["d"])
    jres = jgrt.bundle_candidates_twolevel(
        *map(jnp.asarray, args), 256, capacity, super_mult=16,
        super_capacity=super_capacity)
    tres = grt.bundle_candidates_twolevel(*tt(*args), 256, capacity,
                                          super_mult=16,
                                          super_capacity=super_capacity)
    assert_candidates(jres, tres, exact_order=False)
    assert bool(npy(tres[2])) == (super_capacity == 320)


@pytest.mark.parametrize("two_level", [False, True])
def test_candidate_order_matches_jax_on_separated_scene(two_level):
    """Depth layers 0.3 apart: no depth ties, so each bundle's candidate
    list must match JAX's element for element."""
    pos, _, scale, opa, _ = map(np.asarray, separated_scene(n=128, seed=21))
    o, d = fanned_rays(seed=22)
    o = o + np.array([0.0, 0.0, 1.0], np.float32)
    radius = np.asarray(jgrt.bounding_radius(jnp.asarray(scale),
                                             jnp.asarray(opa), DEG))
    args = (pos, radius, opa >= JC.MIN_ALPHA)
    if two_level:
        jres = jgrt.bundle_candidates_twolevel(
            *map(jnp.asarray, args + (o, d)), 256, 128, super_capacity=96)
        tres = grt.bundle_candidates_twolevel(*tt(*args, o, d), 256, 128,
                                              super_capacity=96)
    else:
        jres = jgrt.bundle_candidates(
            *map(jnp.asarray, args),
            jgrt.make_bundles(jnp.asarray(o), jnp.asarray(d), 256), 128)
        tres = grt.bundle_candidates(*tt(*args),
                                     grt.make_bundles(*tt(o, d), 256), 128)
    assert_candidates(jres, tres, exact_order=True)
    assert int(npy(tres[1]).max()) > 8


def flatten_both(cand, counts, cap):
    j = jgrt.flatten_candidates(jnp.asarray(cand), jnp.asarray(counts), cap)
    t = grt.flatten_candidates(*tt(cand, counts), cap)
    return [npy(x) for x in j], [npy(x) for x in t]


@pytest.mark.parametrize("case", ["cull", "unit"])
def test_flatten_candidates_matches_jax(cull, case):
    """All six outputs equal: on a two-level cull's lists with a tight
    capacity, and on empty, one-slot, one-window and 1.5-window bundles."""
    if case == "cull":
        c = cull
        ci, cn, ovf, _ = grt.bundle_candidates_twolevel(
            *tt(c["pos"], c["radius"], c["valid"], c["o"], c["d"]), 256,
            64, super_capacity=448)
        assert not bool(ovf)
        cand, counts = npy(ci), npy(cn)
        total = int((-(-counts // 128) * 128).sum())
        cap = total + 256
    else:
        rng = np.random.default_rng(0)
        cand = rng.integers(0, 1000, (4, 256)).astype(np.int32)
        counts = np.array([0, 1, 128, 192], np.int32)
        cap = 8 * 128
    want, got = flatten_both(cand, counts, cap)
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"output {k}")
    assert not bool(got[4]) and got[1].sum() == counts.sum()


def test_flatten_candidates_exact_capacity_keeps_true_rows():
    """ROADMAP C6: counts 200, 100, 0 with flat_capacity = 384, exactly the
    padded total. JAX clips the empty last bundle's start onto window 2 and
    shows 128 valid rows of junk there; the port keeps bundle 1's 100 true
    rows. At capacity 512 the two agree."""
    rng = np.random.default_rng(1)
    cand = rng.integers(0, 5000, (3, 256)).astype(np.int32)
    counts = np.array([200, 100, 0], np.int32)
    want, got = flatten_both(cand, counts, 384)
    fi, valid, ws, we, ovf, wb = got
    assert not bool(ovf) and not bool(want[4])
    np.testing.assert_array_equal(ws, [0, 2, 3])
    np.testing.assert_array_equal(we, [2, 3, 3])
    assert valid[256:].sum() == 100
    np.testing.assert_array_equal(fi[256:356], cand[1, :100])
    np.testing.assert_array_equal(fi[:200], cand[0, :200])
    np.testing.assert_array_equal(wb, [0, 0, 1])
    # The JAX package's divergence, documented rather than matched.
    assert want[1][256:].sum() == 128
    assert not np.array_equal(want[0][256:356], cand[1, :100])
    want, got = flatten_both(cand, counts, 512)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_pack_rows64_matches_jax():
    pos, quat, scale, opa, feats = map(np.asarray, random_scene(n=64, seed=2))
    for k in (16, 4):
        want = jgrt.pack_rows64(*map(jnp.asarray, (pos, quat, scale, opa,
                                                   feats[:, :k])))
        got = grt.pack_rows64(*tt(pos, quat, scale, opa, feats[:, :k]))
        assert tuple(got.shape) == (64, 64)
        np.testing.assert_allclose(npy(got), npy(want), rtol=1e-6,
                                   atol=1e-6)


def layered_scene(n=48, seed=11, spacing=0.3):
    """Particles on depth layers 0.3 apart, 0.05-0.15 in scale: each
    ray meets them in layer order, so the bundle route with any pass count
    composites exactly the ray oracle's order. A third of the coherent
    rays hit, up to 20 particles each."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.4, 0.4, n),
                    2.0 + spacing * np.arange(n)], -1).astype(np.float32)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    scale = (0.1 * rng.uniform(0.5, 1.5, (n, 3))).astype(np.float32)
    opa = rng.uniform(0.3, 0.9, n).astype(np.float32)
    feats = rng.uniform(-0.5, 0.5, (n, 16, 3)).astype(np.float32)
    return pos, quat, scale, opa, feats


def inversion_scene(n=96, seed=31, dz=0.004):
    """Tilted flat pancakes at shuffled near-equal depths: per-ray hit
    order inverts against the bundle order over spans longer than 16
    positions, so 16 odd-even passes leave some rays unsorted."""
    rng = np.random.default_rng(seed)
    z = 2.0 + dz * rng.permutation(n)
    pos = np.stack([rng.uniform(-0.15, 0.15, n), rng.uniform(-0.15, 0.15, n),
                    z], -1).astype(np.float32)
    t = np.where(np.arange(n) % 2 == 0, 0.9, -0.9)
    quat = np.stack([np.cos(t / 2), np.zeros(n), np.sin(t / 2),
                     np.zeros(n)], -1).astype(np.float32)
    scale = np.tile(np.array([[0.5, 0.5, 0.004]], np.float32), (n, 1))
    opa = rng.uniform(0.05, 0.15, n).astype(np.float32)
    feats = rng.uniform(-1.0, 1.0, (n, 16, 3)).astype(np.float32)
    feats[:, 1:] *= 0.1
    return pos, quat, scale, opa, feats


def composite_inputs(scene, o, d, capacity):
    """The compositor's inputs for the port's cull, flatten and gather."""
    pos, quat, scale, opa, feats = tt(*scene)
    o, d = tt(o, d)
    radius = grt.bounding_radius(scale, opa, DEG)
    ci, cn, ovf, _ = grt.bundle_candidates(
        pos, radius, opa >= JC.MIN_ALPHA, grt.make_bundles(o, d, 256),
        capacity)
    assert not bool(ovf)
    fi, valid, ws, we, _, _ = grt.flatten_candidates(ci, cn, 128 * len(cn))
    data = grt.pack_rows64(pos, quat, scale, opa, feats)[fi.long()]
    data[:, 12] *= valid
    rays = torch.cat([o, d, torch.zeros(len(o), 1), torch.ones(len(o), 1)],
                     -1).reshape(-1, 256, 8).transpose(1, 2).contiguous()
    return data, rays, ws, we


@pytest.fixture(scope="module", params=["separated_0", "inversion_16"])
def composite_case(request):
    """Case 1: the depth-separated scene, 1 bundle, 0 passes. Case 2: the
    inversion scene, 2 bundles, 16 passes. Each runs the JAX compositor
    once (interpret mode)."""
    if request.param == "separated_0":
        scene, (o, d), passes = layered_scene(), coherent_rays(), 0
    else:
        scene = inversion_scene()
        o, d = coherent_rays(n=512, seed=7)
        passes = 16
    args = composite_inputs(scene, npy(o), npy(d), 128)
    want = jbt.bundle_composite(*(jnp.asarray(npy(x)) for x in args), DEG,
                                3, JC.MIN_TRANSMITTANCE_3DGRT,
                                sorted_passes=passes)
    return args, passes, npy(want)


def test_bundle_composite_plain_matches_jax(composite_case):
    args, passes, want = composite_case
    got = npy(bundle_trace.bundle_composite_plain(
        *args, DEG, 3, JC.MIN_TRANSMITTANCE_3DGRT, sorted_passes=passes))
    for rows, atol in (([0, 1, 2, 3, 5], 2e-5), ([4], 1e-4)):
        np.testing.assert_allclose(got[:, rows], want[:, rows], atol=atol)
    np.testing.assert_array_equal(got[:, 6:8], want[:, 6:8])
    assert want[:, 3].max() > 0.5 and want[:, 7].min() >= 1
    if passes:
        # The bounded pass count is part of the result: a full sort
        # (128 passes) composites these rays differently.
        full = npy(bundle_trace.bundle_composite_plain(
            *args, DEG, 3, JC.MIN_TRANSMITTANCE_3DGRT, sorted_passes=128))
        assert np.abs(full[:, 0:3] - got[:, 0:3]).max() > 1e-2


def test_bundle_composite_autograd_runs_b8():
    """Differentiating the compositor runs B8 (its plain version here): the
    gradient of data is bundle_composite_backward_plain's for the same
    cotangent; the rays and window ranges get none."""
    data, rays, ws, we = composite_inputs(layered_scene(n=16),
                                          *map(npy, coherent_rays()), 16)
    data.requires_grad_(True)
    rays.requires_grad_(True)
    out = bundle_trace.bundle_composite(data, rays, ws, we, DEG, 3, 1e-3)
    g = torch.tensor(np.random.default_rng(3).normal(
        size=out.shape).astype(np.float32))
    out.backward(g)
    want = bundle_trace.bundle_composite_backward_plain(
        data.detach(), rays.detach(), ws, we, out.detach(), g, DEG, 3, 1e-3)
    assert torch.equal(data.grad, want) and rays.grad is None
    assert float(data.grad.abs().max()) > 0 and not data.grad[:, 13:16].any()


def trace_options(n):
    rng = np.random.default_rng(12)
    return dict(t_max=rng.uniform(3.5, 12.0, n).astype(np.float32),
                initial_transmittance=rng.uniform(0.3, 1.0, n).astype(
                    np.float32))


@pytest.fixture(scope="module")
def jax_traces():
    """JAX's exact ray-order trace (t_max, initial transmittance, normals)
    and naive oracle of the separated scene, and its surfel ray-order
    trace with normals (no Pallas on these paths)."""
    o, d = coherent_rays()
    sep = tuple(map(jnp.asarray, layered_scene()))
    opts = trace_options(256)
    surf = surfel_scene()
    o2, d2 = coherent_rays(seed=16)
    return dict(
        sep=(sep, (o, d)), surf=(surf, (o2, d2)), opts=opts,
        ray=jgrt.trace(*sep, o, d, candidate_capacity=48, order="ray",
                       return_normals=True,
                       **{k: jnp.asarray(v) for k, v in opts.items()}),
        naive=jgrt.trace_naive(*sep, o, d),
        surfel=jgrt.trace(*surf, o2, d2, candidate_capacity=32, order="ray",
                          surfel=True, return_normals=True))


def assert_trace_close(got, want, hits=True):
    for f in ("rgb", "opacity", "transmittance"):
        np.testing.assert_allclose(npy(getattr(got, f)),
                                   npy(getattr(want, f)), atol=2e-5,
                                   err_msg=f)
    np.testing.assert_allclose(npy(got.depth), npy(want.depth), atol=1e-4,
                               rtol=2e-5)
    if hits:
        np.testing.assert_array_equal(npy(got.hit_count),
                                      npy(want.hit_count))


@pytest.mark.parametrize("order", ["bundle", "ray"])
def test_trace_matches_jax_oracles(jax_traces, order):
    """The layered scene: both orders against JAX's naive oracle, and
    with t_max and a per-ray initial transmittance against JAX's ray
    order (normals on the ray order)."""
    (sep, (o, d)), opts = jax_traces["sep"], jax_traces["opts"]
    args = tt(*sep, o, d)
    got = grt.trace(*args, candidate_capacity=48, order=order)
    assert not bool(got.overflow) and got.normal is None
    assert_trace_close(got, jax_traces["naive"])
    got = grt.trace(*args, candidate_capacity=48, order=order,
                    return_normals=order == "ray",
                    **{k: torch.tensor(v) for k, v in opts.items()})
    want = jax_traces["ray"]
    assert_trace_close(got, want)
    np.testing.assert_array_equal(npy(got.visibility), npy(want.visibility))
    assert float(npy(want.transmittance).min()) < 0.25
    assert (npy(want.depth) > 0).mean() > 0.25
    if order == "ray":
        np.testing.assert_allclose(npy(got.normal), npy(want.normal),
                                   atol=2e-5)
        assert np.abs(npy(got.normal)).max() > 0.1


def test_surfel_trace_matches_jax(jax_traces):
    surf, (o, d) = jax_traces["surf"]
    args = tt(*surf, o, d)
    want = jax_traces["surfel"]
    got = grt.trace(*args, candidate_capacity=32, surfel=True,
                    return_normals=True)
    assert_trace_close(got, want)
    np.testing.assert_allclose(npy(got.normal), npy(want.normal), atol=2e-5)
    naive = grt.trace_naive(*args, surfel=True)
    assert_trace_close(naive, want)
    vol = grt.trace_naive(*args)
    assert np.abs(npy(vol.rgb) - npy(want.rgb)).max() > 1e-3


def test_api_trace_pads_and_cuts_rays():
    """api.trace on 300 rays (padded to 512 with inactive rays) equals
    grt.trace on the first 300 of the padded set; inactive rays return
    zeros and their initial transmittance."""
    f = bench_scene(64, seed=4)
    f["scale"] = f["scale"] + np.float32(np.log(6.0))
    params = from_numpy(f, device="cpu")
    o, d = coherent_rays(n=300, seed=3)
    o = npy(o) + np.array([0.0, 0.0, -2.0], np.float32)
    t0 = np.linspace(0.5, 1.0, 300).astype(np.float32)
    got = tapi.trace(params, o, npy(d), device="cpu", candidate_capacity=64,
                     initial_transmittance=t0)
    assert got.rgb.shape == (300, 3) and got.visibility.shape == (4096,)
    acts = [x.detach() for x in (params.get_positions(),
                                 params.get_rotation(), params.get_scale(),
                                 params.get_density(), params.get_features())]
    pad = np.zeros((212, 3), np.float32)
    full = grt.trace(*acts, *tt(np.concatenate([o, pad]),
                                np.concatenate([npy(d), pad])),
                     candidate_capacity=64,
                     initial_transmittance=torch.tensor(
                         np.concatenate([t0, np.full(212, 0.25,
                                                     np.float32)])))
    for f_ in ("rgb", "opacity", "depth", "transmittance", "hit_count"):
        np.testing.assert_array_equal(npy(getattr(got, f_)),
                                      npy(getattr(full, f_))[:300])
    np.testing.assert_array_equal(npy(full.opacity)[300:], 0.0)
    np.testing.assert_array_equal(npy(full.transmittance)[300:], 0.25)
    assert float(npy(got.opacity).max()) > 0.3


RES = (32, 32)
ISECT = 512 * 256


def camera_np():
    w, h = RES
    return dict(focal=np.array([0.9 * w, 0.9 * w], np.float32),
                principal=np.array([w / 2, h / 2], np.float32),
                radial=np.zeros(6, np.float32),
                tangential=np.zeros(2, np.float32),
                thin_prism=np.zeros(4, np.float32))


def eval_scene():
    f = bench_scene(400, seed=6, specular_std=0.1)
    f["scale"] = f["scale"] + np.float32(np.log(8.0))
    return f


def camera_to_world():
    return look_at(np.array([0.4, -3.5, 1.0], np.float32),
                   np.zeros(3, np.float32), np.array([0, 0, 1.0], np.float32))


@pytest.fixture(scope="module")
def jax_eval():
    """One JAX 3DGRT eval step (_step_fn(train=False), preset_3dgrt) at
    32x32 (4 bundles): the JAX compositor's third call."""
    cfg = jpreset_3dgrt()
    cfg.render.isect_capacity = ISECT
    key = jtrainer._register_cfg(cfg)
    f = eval_scene()
    params = jg.Gaussians(**{k: jnp.asarray(v) for k, v in f.items()})
    gt = np.random.default_rng(2).uniform(0, 1, RES[::-1] + (3,)).astype(
        np.float32)
    _, _, aux = jtrainer._step_fn(
        params, None, jnp.asarray(camera_to_world()),
        JPinhole(**{k: jnp.asarray(v) for k, v in camera_np().items()}),
        jnp.asarray(gt), jnp.ones(RES[::-1] + (1,)), None, 4.0, RES, 3, key,
        train=False, isect_capacity=ISECT)
    assert not bool(aux["overflow"])
    return f, gt, {k: npy(v) for k, v in aux.items() if k != "terms"}


def test_api_render_3dgrt_matches_jax(jax_eval):
    """api.render(method="3dgrt") against the JAX eval step's frame (black
    background: the prediction is the rgb), within golden.compare."""
    f, _, want = jax_eval
    with torch.no_grad():
        got, ovf = tapi.render(
            from_numpy(f, device="cpu"),
            PinholeCamera(**{k: torch.tensor(v)
                             for k, v in camera_np().items()}),
            pose_from_matrix(torch.tensor(camera_to_world())), RES,
            method="3dgrt", isect_capacity=ISECT, device="cpu")
    assert not bool(ovf) and got.rgb.shape == (32, 32, 3)
    # The eval step returns no transmittance: both sides use 1 - opacity.
    got = got._replace(transmittance=1.0 - got.opacity)
    rep, ok = golden.compare(got, dict(want, rgb=want["pred"],
                                       transmittance=1.0 - want["opacity"]))
    assert ok, rep
    assert float(got.opacity.max()) > 0.5 and float(got.hit_count.max()) > 4


def test_eval_view_3dgrt_matches_jax(jax_eval):
    """Trainer.eval_view with preset_3dgrt against the JAX eval step:
    prediction, opacity, depth, hit count and visibility within
    golden.compare, PSNR rtol 1e-5."""
    from threedgrut_torch.datasets.protocols import View
    f, gt, want = jax_eval
    cfg = preset_3dgrt()
    cfg.render.isect_capacity = ISECT
    cfg.model.progressive_sh_interval = 0        # SH degree 3, as JAX's
    view = View(T_to_world=camera_to_world(),
                camera=PinholeCamera(**{k: torch.tensor(v)
                                        for k, v in camera_np().items()}),
                resolution=RES, rgb_gt=gt)

    class OneView:
        scene_extent = 4.0

        def __len__(self):
            return 1

        def __getitem__(self, i):
            return view

    tr = ttrainer.Trainer(cfg, OneView(), params=from_numpy(f, device="cpu"),
                          device="cpu")
    aux = tr.eval_view(view)
    assert not bool(aux["overflow"])
    got = dict(rgb=aux["pred"], opacity=aux["opacity"], depth=aux["depth"],
               transmittance=1.0 - aux["opacity"], hit_count=aux["hit_count"],
               visibility=aux["visibility"])
    rep, ok = golden.compare(got, dict(want, rgb=want["pred"],
                                       transmittance=1.0 - want["opacity"]))
    assert ok, rep
    np.testing.assert_allclose(float(aux["psnr"]), float(want["psnr"]),
                               rtol=1e-5)
    assert tr.validate()["psnr"] == pytest.approx(float(aux["psnr"]))


def test_3dgrt_train_step_updates_parameters():
    """A preset_3dgrt train step (the fused compact branch, B8 and B6 at 64
    channels in their plain versions) gives every field a finite gradient,
    nonzero on some particles, and moves them with Adam; the dense branch
    and the gather_rows route give the same step."""
    from threedgrut_torch.ops import fused_raster
    steps = []
    for frac in (0.625, 1.0 / 512, 0.0):
        cfg = preset_3dgrt()
        cfg.render.isect_capacity = ISECT
        cfg.render.walk_compact_fraction = frac
        params = from_numpy(eval_scene(), device="cpu")
        before = {k: getattr(params, k).detach().clone()
                  for k in topt.PARAM_FIELDS}
        fused_raster.branches.clear()
        opt, aux = ttrainer.step_fn(
            params, topt.init(params), torch.tensor(camera_to_world()),
            PinholeCamera(**{k: torch.tensor(v)
                             for k, v in camera_np().items()}),
            torch.zeros(RES[::-1] + (3,)), torch.ones(RES[::-1] + (1,)),
            4.0, RES, 3, cfg, train=True)
        want = {0.625: {"3dgrt.compact": 1}, 0.0: {}}.get(
            frac, {"3dgrt.dense": 1})
        assert dict(fused_raster.branches) == want and opt.step == 1
        assert not bool(aux["overflow"])
        for k, g in aux["grads"].items():
            assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), k
            moved = (getattr(params, k).detach() != before[k]).any(-1)
            assert bool(moved.any()), k
        steps.append(aux)
    for aux in steps[1:]:
        assert float(aux["terms"]["total"]) == float(
            steps[0]["terms"]["total"])
        assert torch.equal(aux["visibility"], steps[0]["visibility"])
        for k, g in aux["grads"].items():
            np.testing.assert_allclose(npy(g), npy(steps[0]["grads"][k]),
                                       rtol=1e-6, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("kw,match", [
    (dict(walk_capacity=1000, flat_capacity=2048), "walk_capacity"),
    (dict(order="sorted"), "order"),
])
def test_unported_trace_options_raise(kw, match):
    """A walk_capacity that is not a multiple of 256 and an unknown order
    are refused (every option of the JAX package's trace is ported; the
    packed culls are tests/test_torch_grt_packed.py's)."""
    sc = tt(*layered_scene(n=8))
    o, d = tt(*coherent_rays())
    with pytest.raises(ValueError, match=match):
        grt.trace(*sc, o, d, candidate_capacity=8, **kw)


def test_inactive_rays_and_tmax_bound_on_bundle_route():
    """Zero-direction rays return zeros; a non-finite t_max is unbounded,
    a finite one cuts the segment (bundle route)."""
    sc = tt(*layered_scene())
    o, d = coherent_rays()
    d = npy(d).copy()
    d[:16] = 0.0
    base = grt.trace(*sc, *tt(npy(o), d), candidate_capacity=48)
    assert float(base.opacity[:16].abs().max()) == 0.0
    assert float(base.transmittance[:16].min()) == 1.0
    tmax = np.full(256, math.inf, np.float32)
    same = grt.trace(*sc, *tt(npy(o), d), candidate_capacity=48,
                     t_max=torch.tensor(tmax))
    np.testing.assert_array_equal(npy(same.rgb), npy(base.rgb))
    cut = grt.trace(*sc, *tt(npy(o), d), candidate_capacity=48,
                    t_max=torch.full((256,), 4.0))
    assert float(cut.depth.max()) < float(base.depth.max())
    assert bool((cut.opacity <= base.opacity + 1e-7).all())
