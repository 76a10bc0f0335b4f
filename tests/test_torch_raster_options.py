"""The sorted (k-buffer) and row-terminated legs of kernels B1 and B2 in the
PyTorch port, against the JAX package on the same numpy inputs (CPU; the
JAX Pallas kernels in interpret mode, their calls in module fixtures: the
interpret compile grows with the pass count).

Tolerances and why:
  * row_last_touch: bit-equal, on both legs (the row bits of the binning
    and particle_row_extent) and on a tile inside one 256-slot block that
    takes the JAX package's blockwise fallback. Slot indices are exact
    in f32.
  * plain B1: rows 0-5 atol 2e-4 / rtol 1e-4 (sequential products vs the
    JAX Hillis-Steele ladder, as tests/test_torch_raster.py); hit count off
    by at most 1 on at most one pixel; row 7 (slots walked) and the set of
    flagged slots exact, the flags within atol 2e-4 / rtol 1e-4.
  * plain B2: atol 5e-4 x each column's max |g|, the nonzero slots exactly
    JAX's. tests/test_torch_backward.py holds a 100-particle scene to 1e-4
    for the same reason (the suffix a_tot - prefix, summed in another
    order, divided by 1 - alpha >= 0.01); here a pixel composites up to
    ~400 hits, so the suffix is a difference of sums of that many terms.
    Measured worst: 1.7e-4 (a slot at the 0-pass, t_max case; 7e-5 in the
    others, the 0-pass row-terminated one included).
  * gut.render at 28 passes against the per-ray sorted oracles of both
    packages: rgb atol 3e-5, opacity 2e-5, depth 1e-4
    (tests/test_gut_fast.py's test_sorted_mode_matches_sorted_oracle).
  * one train step with sorted passes and row termination against JAX's
    _step_fn: tests/test_torch_train.py's tolerances (loss rtol 1e-5,
    gradients atol 1e-5 x max, moments, parameters atol 1e-6, visibility
    on all but 0.1% of the particles).

torch runs on one intra-op thread here (`single_thread`,
tests/test_torch_grt.py): the plain versions run many small torch ops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedgrut_tpu import optimizers as jopt
from threedgrut_tpu import trainer as jtrainer
from threedgrut_tpu.cameras import PinholeCamera as JPinhole
from threedgrut_tpu.config import Config as JConfig
from threedgrut_tpu.model import gaussians as jg
from threedgrut_tpu.ops import tiles as jtiles
from threedgrut_tpu.ops.pallas import tile_raster as jtr
from threedgrut_tpu.ops.projection import Projection as JProjection
from threedgrut_tpu.render import gut_reference as jref
from threedgrut_torch import optimizers as topt
from threedgrut_torch import trainer as ttrainer
from threedgrut_torch.cameras import (PinholeCamera, SensorPose, look_at,
                                      pose_from_matrix)
from threedgrut_torch.config import Config, preset_3dgut_sorted
from threedgrut_torch.model import gaussians as tg
from threedgrut_torch.ops import fused_raster
from threedgrut_torch.ops import tile_raster as ttr
from threedgrut_torch.ops import tiles as ttiles
from threedgrut_torch.ops.projection import Projection
from threedgrut_torch.render import gut, gut_reference
from tests.test_cameras import IDENTITY_POSE
from tests.test_gut_fast import inversion_scene
from tests.test_torch_grt import single_thread  # noqa: F401 (autouse)
from tests.test_torch_train import camera_np, small_fields

ARGS = (2, 1e-4, 0.0113, 1.0 / 255.0, 0.99)
RES = (32, 32)
FOCAL = 60.0          # tests/test_gut_fast.py's camera
ONE = torch.tensor([1.0, 0.0, 0.0, 0.0])
IDENTITY = SensorPose(ONE, torch.zeros(3), ONE, torch.zeros(3))


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch on one intra-op thread for the module (as
    tests/test_torch_grt.py): under the parallel run's load, the plain
    versions' many small ops stall on an 8-thread pool's barriers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def J(x):
    return jnp.asarray(np.asarray(x))


def camera(res=RES, f=FOCAL):
    w, h = res
    return PinholeCamera(focal=torch.tensor([f, f]),
                         principal=torch.tensor([w / 2, h / 2]),
                         radial=torch.zeros(6), tangential=torch.zeros(2),
                         thin_prism=torch.zeros(4))


def jcamera(res=RES, f=FOCAL):
    w, h = res
    return JPinhole(focal=jnp.asarray([f, f], jnp.float32),
                    principal=jnp.asarray([w / 2, h / 2], jnp.float32),
                    radial=jnp.zeros(6), tangential=jnp.zeros(2),
                    thin_prism=jnp.zeros(4))


def inversion_inputs(n, cap, seed=21):
    """Packed sorted slots, tile ranges and rays of tests/test_gut_fast.py's
    inversion scene (per-ray hit orders that invert the global depth order)
    through the port's pipeline on the CPU, with its projection and
    binning."""
    acts = [torch.tensor(np.asarray(a)) for a in inversion_scene(n, seed)]
    cam = camera()
    with torch.no_grad():
        proj, binning, data, grid = gut.prepare(*acts, cam, IDENTITY, RES,
                                                cap)
        rays = gut.packed_world_rays(cam, IDENTITY, grid)
    assert not bool(binning.overflow)
    return data, binning, rays, proj, grid


@pytest.fixture(scope="module")
def scene():
    """900 inversion-scene particles (1,521 slots): every tile spans three
    or four windows and the tiles after the first start mid-window."""
    data, binning, rays, _, _ = inversion_inputs(900, 2048)
    s, e = binning.tile_starts, binning.tile_ends
    assert (e - s).min() > 2 * ttr.CHUNK
    assert bool((s[1:] % ttr.CHUNK != 0).any())
    return data, s, e, rays


def bounded(rays, t_max_seed=4):
    """Half the rays bounded to a segment that ends inside the scene."""
    rays = rays.clone()
    rng = np.random.default_rng(t_max_seed)
    t = rng.uniform(2.9, 3.3, rays[:, 6].shape)
    rays[:, 6] = torch.tensor(np.where(rng.random(t.shape) < 0.5, t, 0.0),
                              dtype=torch.float32)
    return rays


def mid_bound(rays, s, e):
    """test_row_termination_truncation_is_per_pixel's hand-shrunk bound:
    every pixel of a tile ends at the tile's midpoint slot, so truncation
    bites and the walk stops early."""
    rays = rays.clone()
    mid = torch.where(e > s, torch.div(s + e, 2, rounding_mode="floor"), -1)
    rays[:, 7] = mid.to(torch.float32)[:, None]
    return rays


# (passes, emit_flags, has_t_max, row_termination)
CASES = [(3, True, False, False), (4, False, True, False),
         (0, True, False, True), (3, False, False, True)]
IDS = ["odd-flags", "even-tmax", "rowterm", "odd-rowterm"]


@pytest.fixture(scope="module")
def jax_runs(scene):
    """JAX _forward and _backward_windows of every case (module fixture:
    one interpret compile each)."""
    data, s, e, rays0 = scene
    g_out = np.random.default_rng(0).normal(size=rays0.shape).astype(
        np.float32)
    runs = {}
    for case in CASES:
        passes, flags, tmax, rowterm = case
        rays = bounded(rays0) if tmax else rays0
        if rowterm:
            rays = mid_bound(rays, s, e)
        out = jtr._forward(J(data), J(s), J(e), J(rays), *ARGS,
                           sorted_passes=passes, has_t_max=tmax,
                           emit_flags=flags, row_termination=rowterm)
        out, fl = out if flags else (out, None)
        grad = np.asarray(jtr._from_windows(jtr._backward_windows(
            J(data), J(s), J(e), J(rays), out, J(g_out), degree=2,
            min_transmittance=1e-4, min_response=0.0113,
            min_alpha=1 / 255.0, max_alpha=0.99, sorted_passes=passes,
            has_t_max=tmax, aux_grads=True, lowprec_grads=False,
            row_termination=rowterm)))
        runs[case] = (rays, np.asarray(out),
                      None if fl is None else np.asarray(fl), g_out, grad)
    return runs


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_b1_options_match_pallas_interpret(scene, jax_runs, case):
    data, s, e, _ = scene
    passes, flags, tmax, rowterm = case
    rays, want, want_flags, _, _ = jax_runs[case]
    got, got_flags = ttr.tile_composite_plain(
        data, s, e, rays, *ARGS, has_t_max=tmax, emit_flags=flags,
        sorted_passes=passes, row_termination=rowterm)
    got = got.numpy()
    np.testing.assert_allclose(got[:, 0:6], want[:, 0:6], atol=2e-4,
                               rtol=1e-4)
    dh = np.abs(got[:, 6] - want[:, 6])
    assert dh.max() <= 1 and (dh > 0).sum() <= 1
    assert np.array_equal(got[:, 7], want[:, 7])
    if flags:
        np.testing.assert_allclose(got_flags.numpy(), want_flags,
                                   atol=2e-4, rtol=1e-4)
        assert np.array_equal(got_flags.numpy() > 0, want_flags > 0)
    walked = got[:, 7, 0]
    if rowterm:
        # The mid bound stops every tile before its range ends.
        assert (walked < (e - s).numpy()).all()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_b2_options_match_pallas_interpret(scene, jax_runs, case):
    data, s, e, _ = scene
    passes, _, tmax, rowterm = case
    rays, want_out, _, g_out, want = jax_runs[case]
    out, _ = ttr.tile_composite_plain(data, s, e, rays, *ARGS,
                                      has_t_max=tmax, sorted_passes=passes,
                                      row_termination=rowterm)
    got = ttr.tile_composite_backward_plain(
        data, s, e, rays, out, torch.tensor(g_out), *ARGS, has_t_max=tmax,
        aux_grads=True, sorted_passes=passes,
        row_termination=rowterm).numpy()
    scale = np.abs(want).max(0) + 1e-30
    assert (np.abs(got - want) <= 5e-4 * scale).all()
    nz = np.abs(got).sum(1) > 0
    assert np.array_equal(nz, np.abs(want).sum(1) > 0)
    assert nz.sum() > 100
    if rowterm:
        # Nothing past a tile's bound gets a gradient.
        for t in range(rays.shape[0]):
            assert not nz[int(rays[t, 7, 0]) + 1:int(e[t])].any()


def test_sorted_passes_change_the_image(scene):
    """The inversion scene really exercises the re-sort: 3 passes move
    pixels against 0 passes."""
    data, s, e, rays = scene
    got0, _ = ttr.tile_composite_plain(data, s, e, rays, *ARGS,
                                       has_t_max=False)
    got3, _ = ttr.tile_composite_plain(data, s, e, rays, *ARGS,
                                       has_t_max=False, sorted_passes=3)
    assert float((got3[:, 0:3] - got0[:, 0:3]).abs().max()) > 1e-3


def row_scene():
    """tests/test_row_termination.py's scene: 400 Gaussians at 64x64 from
    (0, -4, 1), binned by the port (CPU)."""
    rng = np.random.default_rng(0)
    n = 400
    fields = tg.padded_fields(
        rng.normal(0, 0.6, (n, 3)).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
        rng.uniform(np.log(0.01), np.log(0.05), (n, 3)).astype(np.float32),
        np.zeros((n, 1), np.float32),
        rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        np.zeros((n, 45), np.float32), n)
    p = tg.from_numpy(fields, device="cpu")
    T = torch.tensor(look_at(np.array([0., -4., 1.], np.float32),
                             np.zeros(3, np.float32),
                             np.array([0., 0., 1.], np.float32)))
    res = (64, 64)
    with torch.no_grad():
        proj, binning, _, grid = gut.prepare(
            p.get_positions(), p.get_rotation(), p.get_scale(),
            p.get_density(), p.get_features(), camera(res, 0.9 * 64),
            pose_from_matrix(T), res, 4096)
    return proj, binning, grid


def jax_binning(binning):
    return jtiles.TileBinning(*[None if x is None else J(x)
                                for x in binning])


def jax_proj(proj):
    return JProjection(*[J(x) for x in proj])


@pytest.mark.parametrize("leg", ["rowbits", "row_extent"])
def test_row_last_touch_bit_equal_to_jax(leg):
    proj, binning, grid = row_scene()
    if leg == "row_extent":
        binning = binning._replace(sorted_rowbits=None)
    got = ttiles.row_last_touch(binning, proj, grid).numpy()
    want = np.asarray(jtiles.row_last_touch(jax_binning(binning),
                                            jax_proj(proj), grid))
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert (got >= 0).mean() > 0.5
    py0, py1 = ttiles.particle_row_extent(proj)
    jy0, jy1 = jtiles.particle_row_extent(jax_proj(proj))
    assert np.array_equal(py0.numpy(), np.asarray(jy0))
    assert np.array_equal(py1.numpy(), np.asarray(jy1))


def test_row_last_touch_block_interior_fallback():
    """A tile whose slots [100, 110) sit inside block 0 of 256 slots, which
    it owns neither end of, gets its last slot 109 in every row, though its
    footprints reach row 0 only at slot 100: JAX's rule, kept."""
    num_tiles, cap, n = 3, 512, 300
    tile = np.full(cap, num_tiles, np.int32)
    tile[:100], tile[100:110], tile[110:300] = 0, 1, 2
    rng = np.random.default_rng(2)
    y0 = rng.integers(0, 8, cap)
    y1 = np.minimum(y0 + rng.integers(0, 8, cap), 15)
    y0[100], y1[100] = 0, 3          # slot 100 reaches row 0 ...
    y0[101:110], y1[101:110] = 4, 6  # ... the later slots rows 4-6 only
    binning = ttiles.TileBinning(
        sorted_particle_idx=torch.tensor(np.minimum(np.arange(cap), n),
                                         dtype=torch.int32),
        sorted_tile=torch.tensor(tile),
        tile_starts=torch.tensor([0, 100, 110], dtype=torch.int32),
        tile_ends=torch.tensor([100, 110, 300], dtype=torch.int32),
        num_intersections=torch.tensor(300, dtype=torch.int32),
        overflow=torch.tensor(False),
        particle_ends=torch.arange(1, n + 1, dtype=torch.int32),
        particle_counts=torch.ones(n, dtype=torch.int32),
        sorted_rowbits=torch.tensor(y0 * 16 + y1, dtype=torch.int32))
    proj = Projection(*[torch.zeros((n, 2)), torch.ones((n, 3)),
                        torch.ones(n), torch.ones((n, 2)), torch.ones(n),
                        torch.ones(n), torch.ones(n, dtype=torch.bool),
                        torch.zeros((n, 2), dtype=torch.int32),
                        torch.ones((n, 2), dtype=torch.int32),
                        torch.ones(n, dtype=torch.int32)])
    got = ttiles.row_last_touch(binning, proj, (3, 1)).numpy()
    want = np.asarray(jtiles.row_last_touch(jax_binning(binning),
                                            jax_proj(proj), (3, 1)))
    assert np.array_equal(got, want)
    assert (got[1] == 109.0).all()
    assert got[0, 0] == max(s for s in range(100) if y0[s] == 0 <= y1[s])


def test_render_sorted_matches_per_ray_sorted_oracles():
    """gut.render at 28 passes (a full sort of every 24-particle run)
    against the per-ray sorted oracle of the port and of JAX
    (tests/test_gut_fast.py's test_sorted_mode_matches_sorted_oracle)."""
    scene_j = inversion_scene(n=24)
    acts = [torch.tensor(np.asarray(a)) for a in scene_j]
    with torch.no_grad():
        fast, ovf = gut.render(*acts, camera(), IDENTITY, RES, 4096,
                               sorted_passes=28, device="cpu")
        ref = gut_reference.render(*acts, camera(), IDENTITY, RES,
                                   per_ray_sorted=True)
        unsorted = gut_reference.render(*acts, camera(), IDENTITY, RES)
    assert not bool(ovf)
    assert float((ref.rgb - unsorted.rgb).abs().max()) > 1e-3
    jref_out = jref.render(*scene_j, jcamera(), IDENTITY_POSE, RES,
                           per_ray_sorted=True)
    for oracle in (ref, jref_out):
        np.testing.assert_allclose(fast.rgb, np.asarray(oracle.rgb),
                                   atol=3e-5)
        np.testing.assert_allclose(fast.opacity, np.asarray(oracle.opacity),
                                   atol=2e-5)
        np.testing.assert_allclose(fast.depth, np.asarray(oracle.depth),
                                   atol=1e-4)


STEP_RES = (48, 48)
STEP_CAP = 1 << 13
STEP_PASSES = 4


def step_view():
    return look_at(np.array([0.5, -3.0, 1.0], np.float32),
                   np.zeros(3, np.float32), np.array([0, 0, 1.0], np.float32))


@pytest.fixture(scope="module")
def jax_step():
    """JAX _step_fn(train=True) with sorted passes and row termination on
    tests/test_torch_train.py's small scene (module fixture)."""
    fields = small_fields()
    gt = np.random.default_rng(5).uniform(
        0, 1, (STEP_RES[1], STEP_RES[0], 3)).astype(np.float32)
    cfg = JConfig()
    cfg.render.isect_capacity = STEP_CAP
    cfg.render.low_precision_grads = False
    cfg.render.k_buffer_passes = STEP_PASSES
    cfg.render.row_termination = True
    key = jtrainer._register_cfg(cfg)
    params = jg.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()})
    out = jtrainer._step_fn(
        params, jopt.init(params), jnp.asarray(step_view()),
        JPinhole(**{k: jnp.asarray(v) for k, v in camera_np().items()}),
        jnp.asarray(gt), jnp.ones(STEP_RES[::-1] + (1,)),
        jax.random.PRNGKey(0), 4.0, STEP_RES, 3, key, train=True,
        isect_capacity=STEP_CAP)
    return fields, gt, out


def test_train_step_sorted_row_terminated_matches_jax(jax_step):
    """One port step_fn(train=True) with k_buffer_passes and
    row_termination on the fused compact branch against JAX's _step_fn:
    loss, image, gradients, moments, parameters and visibility."""
    fields, gt, (jp, jo, jaux) = jax_step
    cfg = Config()
    cfg.render.isect_capacity = STEP_CAP
    cfg.render.low_precision_grads = False
    cfg.render.k_buffer_passes = STEP_PASSES
    cfg.render.row_termination = True
    tp = tg.from_numpy(fields, device="cpu")
    fused_raster.branches.clear()
    to, taux = ttrainer.step_fn(
        tp, topt.init(tp), torch.tensor(step_view()),
        PinholeCamera(**{k: torch.tensor(v) for k, v in camera_np().items()}),
        torch.tensor(gt), torch.ones(STEP_RES[::-1] + (1,)), 4.0, STEP_RES,
        3, cfg, train=True, isect_capacity=STEP_CAP)
    assert dict(fused_raster.branches) == {"3dgut.compact": 1}
    np.testing.assert_allclose(float(taux["terms"]["total"]),
                               float(jaux["terms"]["total"]), rtol=1e-5)
    np.testing.assert_allclose(float(taux["psnr"]), float(jaux["psnr"]),
                               rtol=1e-5)
    for k in topt.PARAM_FIELDS:
        m_j = np.asarray(jo.exp_avg[k])
        g_j = m_j / np.float32(0.1)
        atol = 1e-5 * np.abs(g_j).max()
        np.testing.assert_allclose(taux["grads"][k].numpy(), g_j, rtol=1e-5,
                                   atol=atol, err_msg=k)
        np.testing.assert_allclose(to.exp_avg[k].numpy(), m_j, rtol=1e-5,
                                   atol=0.1 * atol, err_msg=k)
        np.testing.assert_allclose(
            np.sqrt(to.exp_avg_sq[k].numpy() / np.float32(1e-3)),
            np.sqrt(np.asarray(jo.exp_avg_sq[k]) / np.float32(1e-3)),
            rtol=1e-5, atol=atol, err_msg=k)
        clear = np.abs(g_j) > 2 * atol
        assert clear.any(), k
        np.testing.assert_allclose(
            getattr(tp, k).detach().numpy()[clear],
            np.asarray(getattr(jp, k))[clear], rtol=1e-5, atol=1e-6,
            err_msg=k)
    vis_t = taux["visibility"].numpy()
    vis_j = np.asarray(jaux["visibility"])
    assert (vis_t != vis_j).sum() <= max(1, int(1e-3 * vis_t.size))
    assert 0 < vis_t.sum()


@pytest.mark.parametrize("preset", ["sorted", "row_termination"])
def test_trainer_runs_sorted_and_row_terminated(preset):
    """Trainer(preset_3dgut_sorted()) and a row-terminated Trainer take a
    train step and an eval step (eval_view: the flags leg) on the CPU."""
    from threedgrut_torch.datasets.protocols import View
    from threedgrut_torch.trainer import Trainer
    cfg = preset_3dgut_sorted() if preset == "sorted" else Config()
    cfg.render.row_termination = preset == "row_termination"
    cfg.render.isect_capacity = STEP_CAP
    cfg.model.progressive_sh_interval = 0
    gt = np.random.default_rng(5).uniform(
        0, 1, (STEP_RES[1], STEP_RES[0], 3)).astype(np.float32)
    view = View(T_to_world=step_view(), camera=PinholeCamera(
        **{k: torch.tensor(v) for k, v in camera_np().items()}),
        resolution=STEP_RES, rgb_gt=gt)

    class OneView:
        scene_extent = 4.0

        def __len__(self):
            return 1

        def __getitem__(self, idx):
            return view

    tr = Trainer(cfg, OneView(), params=tg.from_numpy(small_fields(),
                                                      device="cpu"),
                 device="cpu")
    aux = tr.train_step(view)
    assert np.isfinite(float(aux["terms"]["total"]))
    ev = tr.eval_view(view)
    assert np.isfinite(float(ev["psnr"]))
    assert 0 < int(ev["visibility"].sum())
