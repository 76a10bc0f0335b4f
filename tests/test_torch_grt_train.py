"""The 3DGRT train slice: kernel B8 (the bundle compositor's backward),
B6 at 64 channels, the gather's scatter-free backward,
fused_raster.composite_bundles and the 3DGRT train step, against the JAX
package on the same numpy inputs (CPU), and the trainer's repair of C7.

Tolerances and why:
  * plain B8 against the JAX kernel (interpret mode, 16 passes): the set of
    nonzero slot entries exactly; values atol 5e-5 x each column's max
    (f32 sums of 256 rays' chains in another order, the suffix residual
    a_tot - prefix there from triangular matmuls, here from a cumsum).
  * plain B8 against torch autograd of the plain forward, both f64: atol
    1e-10 x max (the same function, differentiated two ways).
  * traces' gradients against jax.grad of JAX's exact ray order: rtol 1e-3,
    atol 1e-4, tangential quaternion components (as
    tests/test_grt.py::test_bundle_kernel_grad_matches_ray_path).
  * the train step against JAX's _step_fn: loss rtol 1e-5; image atol 2e-4;
    gradients (read through the first moment, m = 0.1 g) atol 1e-5 x each
    field's max, as tests/test_torch_train.py's f32 step (sums in another
    order);
    updated parameters atol 1e-6 where |g| clears twice that; visibility
    equal on all but 0.1% of the particles.
  * the compact, dense and gather_rows routes: equal. Each particle's B6
    sum adds the same nonzero rows in the same order (a stable sort of the
    same flat order); the routes differ only by rows that are exactly 0.

Two calls reach the JAX B8 (interpret mode, slow), each on one window of
one bundle: the kernel test and the JAX train step. torch runs on one
intra-op thread here (`single_thread`, tests/test_torch_grt.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_grt import coherent_rays, separated_scene
from tests.test_torch_grt import (DEG, assert_candidates, composite_inputs,
                                  inversion_scene, layered_scene, npy, tt)
from tests.test_torch_grt import single_thread  # noqa: F401 (autouse)
from threedgrut_tpu import constants as JC
from threedgrut_tpu import optimizers as jopt
from threedgrut_tpu import trainer as jtrainer
from threedgrut_tpu.cameras import PinholeCamera as JPinhole
from threedgrut_tpu.config import preset_3dgrt as jpreset_3dgrt
from threedgrut_tpu.model import gaussians as jg
from threedgrut_tpu.ops.pallas import bundle_trace as jbt
from threedgrut_tpu.ops.pallas import segment_sum as jss
from threedgrut_tpu.render import grt as jgrt
from threedgrut_torch import optimizers as topt
from threedgrut_torch import trainer as ttrainer
from threedgrut_torch.cameras import PinholeCamera, look_at
from threedgrut_torch.config import preset_3dgrt
from threedgrut_torch.datasets.protocols import View
from threedgrut_torch.model.gaussians import FIELDS, bench_scene, from_numpy
from threedgrut_torch.ops import bundle_trace, fused_raster, segment_sum
from threedgrut_torch.ops import sorted_gather
from threedgrut_torch.render import grt

MIN_T = JC.MIN_TRANSMITTANCE_3DGRT


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch on one intra-op thread for the module (as
    tests/test_torch_grt.py): under the parallel run's load, the plain
    versions' many small ops stall on an 8-thread pool's barriers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cotangent(shape, seed=0):
    """A random output cotangent; rows 6-7 (hits, walked windows) get none."""
    g = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    g[:, 6:] = 0.0
    return torch.tensor(g)


def test_plain_b8_matches_jax_kernel():
    """One bundle, one window of the inversion scene, 16 passes (some rays'
    hits stay out of order): per-slot [128, 64] gradients against the JAX
    kernel, given the same forward output."""
    o, d = coherent_rays(n=256, seed=7)
    data, rays, ws, we = composite_inputs(inversion_scene(), npy(o), npy(d),
                                          128)
    assert tuple(data.shape) == (128, 64)
    out = bundle_trace.bundle_composite_plain(data, rays, ws, we, DEG, 3,
                                              MIN_T, sorted_passes=16)
    g = cotangent(out.shape)
    want = jbt._backward_windows(
        *(jnp.asarray(npy(x)) for x in (data, rays, ws, we, out, g)),
        degree=DEG, sh_degree=3, min_transmittance=MIN_T,
        min_response=JC.MIN_KERNEL_RESPONSE, min_alpha=JC.MIN_ALPHA,
        max_alpha=JC.MAX_ALPHA, sorted_passes=16)
    want = np.asarray(want).transpose(0, 2, 1).reshape(-1, 64)
    got = npy(bundle_trace.bundle_composite_backward_plain(
        data, rays, ws, we, out, g, DEG, 3, MIN_T, sorted_passes=16))
    np.testing.assert_array_equal(got != 0, want != 0)
    err = np.abs(got - want)
    bound = 5e-5 * np.abs(want).max(0)
    assert (err <= bound).all(), (err / np.maximum(bound, 1e-30)).max()
    assert (got[:, 13:16] == 0).all() and (got != 0).any(1).sum() > 64


@pytest.mark.parametrize("passes", [0, 16])
def test_plain_b8_is_the_gradient_of_plain_b7(passes):
    """f64: plain B8 against torch autograd through the plain forward (two
    bundles of the inversion scene), zero where no walk reached."""
    o, d = coherent_rays(n=512, seed=7)
    data, rays, ws, we = composite_inputs(inversion_scene(), npy(o), npy(d),
                                          128)
    data = torch.cat([data, torch.ones(128, 64)])     # a window never walked
    data, rays = data.double().requires_grad_(True), rays.double()
    out = bundle_trace.bundle_composite_plain(data, rays, ws, we, DEG, 3,
                                              MIN_T, sorted_passes=passes)
    g = cotangent(out.shape, seed=passes).double()
    want, = torch.autograd.grad((out * g).sum(), data)
    got = bundle_trace.bundle_composite_backward_plain(
        data.detach(), rays, ws, we, out.detach(), g, DEG, 3, MIN_T,
        sorted_passes=passes)
    np.testing.assert_allclose(npy(got), npy(want), rtol=0,
                               atol=1e-10 * float(want.abs().max()))
    assert got.dtype == torch.float64 and not got[-128:].any()
    assert int((got != 0).any(1).sum()) > 100


def test_bundle_trace_grads_match_jax_ray_order():
    """The bundle route at 0 passes (plain B7, B8, the gather's sort-and-B6
    backward) against jax.grad of JAX's exact ray order on a depth-
    separated scene, all five post-activation tensors."""
    scene = separated_scene(n=32, seed=12)
    o, d = coherent_rays(seed=13)

    def jloss(*xs):
        out = jgrt.trace(*xs, o, d, candidate_capacity=32, order="ray",
                         sorted_passes=0)
        return (jnp.sum(out.rgb * out.rgb) + jnp.sum(out.opacity)
                + 0.1 * jnp.sum(out.depth))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(*scene)
    xs = [x.requires_grad_(True) for x in tt(*scene)]
    out = grt.trace(*xs, *tt(o, d), candidate_capacity=32, sorted_passes=0)
    loss = ((out.rgb * out.rgb).sum() + out.opacity.sum()
            + 0.1 * out.depth.sum())
    got = torch.autograd.grad(loss, xs)
    q = npy(scene[1])
    for name, a, b in zip(("pos", "quat", "scale", "opa", "feats"), got,
                          want):
        a, b = npy(a), np.asarray(b)
        if name == "quat":
            # Only the tangential part is observable (test_grt.py's note).
            a = a - np.sum(a * q, -1, keepdims=True) * q
            b = b - np.sum(b * q, -1, keepdims=True) * q
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4, err_msg=name)
        assert np.abs(b).max() > 1e-3, name


def test_plain_b6_at_64_channels_matches_pallas_interpret():
    """Sorted ids with gaps, duplicates and filler rows of id n."""
    rng = np.random.default_rng(3)
    n = 256
    ids = np.sort(rng.integers(0, n + 1, 1024)).astype(np.int32)
    g = rng.normal(size=(1024, 64)).astype(np.float32)
    want = np.asarray(jss.segment_sum_rows_by_ids(
        jnp.asarray(g.T.copy()), jnp.asarray(ids), n)).T
    got = segment_sum.segment_sum_rows_by_ids(torch.tensor(g),
                                              torch.tensor(ids), n).numpy()
    assert got.shape == (n, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    absent = np.setdiff1d(np.arange(n), ids)
    assert len(absent) > 0 and not got[absent].any()


def test_gather_rows_backward_matches_jax():
    """gather_rows' backward (stable sort, row gather, B6 at 64 channels)
    against jax.vjp of the JAX gather_rows, repeating ids."""
    from threedgrut_tpu.ops import sorted_gather as jsg
    rng = np.random.default_rng(5)
    n, m = 300, 2048
    table = rng.normal(size=(n, 64)).astype(np.float32)
    idx = rng.integers(0, n, m).astype(np.int32)
    g = rng.normal(size=(m, 64)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda t: jsg.gather_rows(t, jnp.asarray(idx)),
                         jnp.asarray(table))
    p = torch.tensor(table, requires_grad=True)
    out = sorted_gather.gather_rows(p, torch.tensor(idx))
    assert np.array_equal(npy(out), np.asarray(out_j))
    out.backward(torch.tensor(g))
    np.testing.assert_allclose(npy(p.grad), np.asarray(vjp(
        jnp.asarray(g))[0]), rtol=0, atol=1e-4)
    # Ids >= n are dropped by the transpose.
    ids = np.sort(np.r_[idx[:100], np.full(28, n)]).astype(np.int32)
    got = sorted_gather.unsort_gather_segment_sum(
        torch.tensor(ids), torch.ones(128, 64), n)
    assert float(got.sum()) == 100 * 64


def routes_scene():
    """The layered scene seen by 4 bundles whose rays saturate within a
    few of their windows; candidate capacity 48, so each bundle owns
    ceil(count / 128) windows of a 12-window flat layout."""
    o, d = coherent_rays(n=1024, seed=3)
    return tt(*layered_scene(n=48)), tt(o, d)


@pytest.mark.parametrize("route", ["compact", "dense"])
def test_composite_bundles_routes_agree(route):
    """trace with walk_capacity on its compact branch (the walked windows
    fit) and its dense branch (two windows of capacity), against the
    gather_rows route: the same forward and the same gradients of all five
    tensors, exactly."""
    scene, (o, d) = routes_scene()
    wc = 1024 if route == "compact" else 256
    flat = 12 * 128
    grads = {}
    for key, walk in (("gather", None), (route, wc)):
        xs = [x.clone().requires_grad_(True) for x in scene]
        fused_raster.branches.clear()
        out = grt.trace(*xs, o, d, candidate_capacity=48, flat_capacity=flat,
                        walk_capacity=walk)
        loss = out.rgb.sum() + out.opacity.sum() + 0.1 * out.depth.sum()
        grads[key] = (out, torch.autograd.grad(loss, xs))
        want = {} if walk is None else {f"3dgrt.{route}": 1}
        assert dict(fused_raster.branches) == want
    (o1, g1), (o2, g2) = grads["gather"], grads[route]
    for f in ("rgb", "opacity", "depth", "transmittance", "hit_count"):
        assert torch.equal(getattr(o1, f), getattr(o2, f)), f
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    assert float(g1[3].abs().max()) > 0.01


def test_walk_capacity_outside_the_flat_layout_takes_the_gather_route():
    """As the JAX package's trace: walk_capacity >= capF (or 0) composites
    through gather_rows, with its gradients."""
    scene, (o, d) = routes_scene()
    for walk in (0, 12 * 128):
        fused_raster.branches.clear()
        xs = [x.clone().requires_grad_(True) for x in scene]
        out = grt.trace(*xs, o, d, candidate_capacity=48,
                        flat_capacity=12 * 128, walk_capacity=walk)
        g = torch.autograd.grad(out.opacity.sum(), xs[0])[0]
        assert not fused_raster.branches and float(g.abs().max()) > 0


# ---- the 3DGRT train step against JAX's _step_fn ---------------------------

RES = (16, 16)
CAP = 32768          # candidate capacity 128: one window for the bundle


def step_scene():
    f = bench_scene(120, seed=8, specular_std=0.1)
    f["scale"] = f["scale"] + np.float32(np.log(10.0))
    f["density"] = f["density"] + 1.0
    return f


def step_camera_np():
    w, h = RES
    return dict(focal=np.array([0.9 * w, 0.9 * w], np.float32),
                principal=np.array([w / 2, h / 2], np.float32),
                radial=np.zeros(6, np.float32),
                tangential=np.zeros(2, np.float32),
                thin_prism=np.zeros(4, np.float32))


def step_T():
    return look_at(np.array([0.4, -3.5, 1.0], np.float32),
                   np.zeros(3, np.float32), np.array([0, 0, 1.0], np.float32))


def step_gt():
    return np.random.default_rng(2).uniform(0, 1, RES[::-1] + (3,)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_train_step():
    """One JAX 3DGRT train step (_step_fn(train=True), preset_3dgrt) at
    16x16 on 120 particles (one bundle, one window: the second JAX B8
    call), and the eval step's prediction."""
    cfg = jpreset_3dgrt()
    cfg.render.isect_capacity = CAP
    key = jtrainer._register_cfg(cfg)
    f = step_scene()
    params = jg.Gaussians(**{k: jnp.asarray(v) for k, v in f.items()})
    args = (jnp.asarray(step_T()),
            JPinhole(**{k: jnp.asarray(v)
                        for k, v in step_camera_np().items()}),
            jnp.asarray(step_gt()), jnp.ones(RES[::-1] + (1,)),
            jax.random.PRNGKey(0), 4.0, RES, 3, key)
    jp, jo, jaux = jtrainer._step_fn(params, jopt.init(params), *args,
                                     train=True, isect_capacity=CAP)
    _, _, jeval = jtrainer._step_fn(params, None, *args, train=False,
                                    isect_capacity=CAP)
    assert not bool(jaux["overflow"])
    return f, jp, jo, jaux, npy(jeval["pred"])


def test_3dgrt_train_step_matches_jax(jax_train_step):
    """The port's step_fn(train=True) with preset_3dgrt (the fused compact
    branch): loss, image, each field's gradient, the updated parameters and
    moments, and the hit visibility."""
    f, jp, jo, jaux, jpred = jax_train_step
    cfg = preset_3dgrt()
    cfg.render.isect_capacity = CAP
    params = from_numpy(f, device="cpu")
    fused_raster.branches.clear()
    opt, aux = ttrainer.step_fn(
        params, topt.init(params), torch.tensor(step_T()),
        PinholeCamera(**{k: torch.tensor(v)
                         for k, v in step_camera_np().items()}),
        torch.tensor(step_gt()), torch.ones(RES[::-1] + (1,)), 4.0, RES, 3,
        cfg, train=True, isect_capacity=CAP)
    assert dict(fused_raster.branches) == {"3dgrt.compact": 1}
    np.testing.assert_allclose(float(aux["terms"]["total"]),
                               float(jaux["terms"]["total"]), rtol=1e-5)
    np.testing.assert_allclose(npy(aux["pred"]), jpred, rtol=0, atol=2e-4)
    assert opt.step == int(jo.step) == 1
    for k in topt.PARAM_FIELDS:
        m_j = np.asarray(jo.exp_avg[k])
        g_j = m_j / np.float32(0.1)
        atol = 1e-5 * np.abs(g_j).max()
        assert atol > 0, k
        np.testing.assert_allclose(npy(aux["grads"][k]), g_j, rtol=1e-5,
                                   atol=atol, err_msg=k)
        np.testing.assert_allclose(npy(opt.exp_avg[k]), m_j, rtol=1e-5,
                                   atol=0.1 * atol, err_msg=k)
        np.testing.assert_allclose(
            np.sqrt(npy(opt.exp_avg_sq[k]) / np.float32(1e-3)),
            np.sqrt(np.asarray(jo.exp_avg_sq[k]) / np.float32(1e-3)),
            rtol=1e-5, atol=atol, err_msg=k)
        clear = np.abs(g_j) > 2 * atol
        assert clear.any(), k
        np.testing.assert_allclose(
            npy(getattr(params, k))[clear], np.asarray(getattr(jp, k))[clear],
            rtol=1e-5, atol=1e-6, err_msg=k)
    vis_t, vis_j = npy(aux["visibility"]), np.asarray(jaux["visibility"])
    assert (vis_t != vis_j).sum() <= max(1, int(1e-3 * vis_t.size))
    assert 10 < vis_t.sum() <= 120


# ---- C7: the super lists' capacity -----------------------------------------

def c7_scene(n, seed, x_lo):
    """n particles spread over x in [x_lo, 1.5], |y| <= 0.75, z in [2.8,
    3.2], in front of 32 bundles of rays from the origin (a 128x64 grid of
    8x4 16x16 tiles, focal 128 px, looking down +z). With x_lo = -1.5 the
    two super cones (the left and right 4x4 tiles) share them; with 0 the
    right one sees them all."""
    from threedgrut_torch.model.gaussians import padded_fields
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(x_lo, 1.5, n), rng.uniform(-0.75, 0.75, n),
                    rng.uniform(2.8, 3.2, n)], -1).astype(np.float32)
    return padded_fields(
        pos, rng.normal(size=(n, 4)).astype(np.float32),
        np.full((n, 3), np.log(0.04), np.float32),
        np.full((n, 1), 3.0, np.float32),
        rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        np.zeros((n, 45), np.float32))


def c7_rays():
    px = (np.arange(128) + 0.5) / 128 - 0.5
    py = (np.arange(64) + 0.5) / 128 - 0.25
    gx, gy = np.meshgrid(px, py, indexing="xy")
    d = np.stack([gx, gy, np.ones_like(gx)], -1)
    d = d.reshape(4, 16, 8, 16, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return np.zeros_like(d), d


def jax_twolevel(args, capacity):
    """JAX's two-level cull at super_capacity 8192 (jitted: eager dispatch
    of its ops costs seconds)."""
    return jax.jit(functools.partial(
        jgrt.bundle_candidates_twolevel, bundle_size=256, capacity=capacity,
        super_capacity=8192))(*map(jnp.asarray, args))


def cull_inputs(f):
    live = f["alive"]
    pos = f["positions"][live]
    scale = np.exp(f["scale"][live])
    opa = (1.0 / (1.0 + np.exp(-f["density"][live, 0]))).astype(np.float32)
    radius = np.asarray(jgrt.bounding_radius(jnp.asarray(scale),
                                             jnp.asarray(opa), DEG))
    o, d = c7_rays()
    return pos, radius, opa >= JC.MIN_ALPHA, o, d


def test_c7_jax_super_lists_overflow_at_every_capacity():
    """9000 particles, one super cone holding them all: the JAX package's
    two-level cull (super_capacity 8192, what its trainer passes)
    overflows whatever the candidate capacity; the port's super lists at
    the trainer's grown capacity do not."""
    args = cull_inputs(c7_scene(9000, seed=1, x_lo=0.0))
    for cap in (1024, 8192):
        *_, ovf, _ = jax_twolevel(args, cap)
        assert bool(ovf), cap
    kw = ttrainer.grt_super_lists(1 << 19)
    assert kw == dict(super_capacity=16384, two_level_above=8192)
    *_, ovf, _ = grt.bundle_candidates_twolevel(
        *tt(*args), 256, 2048, super_capacity=kw["super_capacity"])
    assert not bool(ovf)


def test_c7_trainer_clears_the_super_list_overflow():
    """The port's Trainer on that scene, preset_3dgrt at capacity 2^18: the
    first steps overflow (the super list of 8192), the capacity doubles
    once, and the next step does not overflow."""
    f = c7_scene(9000, seed=1, x_lo=0.0)
    T = np.eye(4, dtype=np.float32)        # looking down +z, OpenCV axes
    cam = PinholeCamera(focal=torch.tensor([128.0, 128.0]),
                        principal=torch.tensor([64.0, 32.0]),
                        radial=torch.zeros(6), tangential=torch.zeros(2),
                        thin_prism=torch.zeros(4))
    view = View(T_to_world=T, camera=cam, resolution=(128, 64),
                rgb_gt=np.zeros((64, 128, 3), np.float32))

    class OneView:
        scene_extent = 3.0

        def __len__(self):
            return 1

        def __getitem__(self, i):
            return view

    cfg = preset_3dgrt()
    cfg.render.isect_capacity = 1 << 18
    tr = ttrainer.Trainer(cfg, OneView(), params=from_numpy(f, device="cpu"),
                          device="cpu")
    ovf = [bool(tr.train_step(view)["overflow"]) for _ in range(3)]
    assert ovf == [True, True, False] and tr.isect_capacity == 1 << 19


def test_c7_repair_keeps_jax_candidate_lists():
    """Where the JAX package does not overflow, the trainer's super-list
    arguments change no candidate list. Below 8192 particles both run the
    single-level cull: the lists equal JAX's. Above it, with every super
    cone under 8192, both run the two-level cull: the wider super lists
    give the port's lists at JAX's super capacity exactly, and JAX's up to
    particles at a bundle cone's margin (the level-2 test's f32 dot
    products round in another order: one particle of one bundle here)."""
    kw = ttrainer.grt_super_lists(1 << 20)
    args = cull_inputs(c7_scene(4000, seed=2, x_lo=-1.5))
    jres = jax.jit(lambda p, r, v, o, d: jgrt.bundle_candidates(
        p, r, v, jgrt.make_bundles(o, d, 256), 4096))(
            *map(jnp.asarray, args))
    assert not bool(npy(jres[2]))
    assert_candidates(jres, grt.candidate_lists(*tt(*args), 256, 4096, **kw),
                      exact_order=False)

    args = cull_inputs(c7_scene(12000, seed=2, x_lo=-1.5))
    jres = [npy(x) for x in jax_twolevel(args, 4096)]
    got = [npy(x) for x in grt.candidate_lists(*tt(*args), 256, 4096, **kw)]
    base = grt.candidate_lists(*tt(*args), 256, 4096, super_capacity=8192)
    assert_candidates(base, got, exact_order=True)
    assert not bool(jres[2]) and not bool(got[2])
    np.testing.assert_array_equal(got[3], jres[3])
    for b in range(32):
        kg, kj = int(got[1][b]), int(jres[1][b])
        assert len(set(got[0][b, :kg]) ^ set(jres[0][b, :kj])) <= 1, b


# ---- checkpoints of a 3DGRT config ------------------------------------------

def test_checkpoints_resume_across_packages_3dgrt(tmp_path):
    """A preset_3dgrt checkpoint of the JAX Trainer resumes in the port,
    takes a 3DGRT train step, and the port's checkpoint resumes in the JAX
    Trainer: config, parameters, moments and counters."""
    from threedgrut_torch.datasets.dataset_synthetic import SyntheticDataset
    from threedgrut_torch.config import to_dict
    from threedgrut_tpu.config import to_dict as jto_dict
    dataset = SyntheticDataset(num_views=2, resolution=(32, 32),
                               num_gt_gaussians=48, seed=3, device="cpu")
    f = bench_scene(50, seed=9, specular_std=0.1)
    f["scale"] = f["scale"] + np.float32(np.log(10.0))
    rng = np.random.default_rng(10)
    m = {k: rng.normal(size=f[k].shape).astype(np.float32) * 0.01
         for k in topt.PARAM_FIELDS}
    v = {k: np.abs(rng.normal(size=f[k].shape)).astype(np.float32) * 1e-4
         for k in topt.PARAM_FIELDS}
    cfg = jpreset_3dgrt()
    cfg.render.isect_capacity = 1 << 15
    jt = jtrainer.Trainer(cfg, dataclasses.make_dataclass(
        "Extent", [("scene_extent", float)])(3.0),
        params=jg.Gaussians(**{k: jnp.asarray(x) for k, x in f.items()}))
    jt.opt_state = jopt.AdamState(
        step=jnp.int32(7), exp_avg={k: jnp.asarray(x) for k, x in m.items()},
        exp_avg_sq={k: jnp.asarray(x) for k, x in v.items()})
    jt.global_step = 7
    path = jt.save_checkpoint(str(tmp_path / "jax"))

    tr = ttrainer.Trainer.load_checkpoint(path, dataset, device="cpu")
    assert tr.cfg.render.method == "3dgrt"
    assert to_dict(tr.cfg) == jto_dict(cfg)
    assert (tr.global_step, tr.opt_state.step) == (7, 7)
    for k in FIELDS:
        assert np.array_equal(npy(getattr(tr.params, k)), f[k]), k
    aux = tr.train_step(dataset[0])
    assert not bool(aux["overflow"]) and int(aux["visibility"].sum()) > 0
    path2 = tr.save_checkpoint(str(tmp_path / "torch"))

    jt2 = jtrainer.Trainer.load_checkpoint(path2)
    assert jt2.global_step == 8 and int(jt2.opt_state.step) == 8
    assert jt2.cfg.render.method == "3dgrt"
    for k in FIELDS:
        assert np.array_equal(np.asarray(getattr(jt2.params, k)),
                              npy(getattr(tr.params, k))), k
    for k in topt.PARAM_FIELDS:
        assert np.array_equal(np.asarray(jt2.opt_state.exp_avg[k]),
                              npy(tr.opt_state.exp_avg[k])), k
        assert not np.array_equal(npy(tr.opt_state.exp_avg[k]), m[k]), k
