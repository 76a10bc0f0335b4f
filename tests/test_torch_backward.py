"""Kernel B2 (the compositor backward) and the differentiable render of the
PyTorch port against the JAX package, on the same numpy inputs (CPU; the
JAX Pallas kernels in interpret mode).

Tolerances and why:
  * B2 per-slot gradients: atol 1e-4 x the column's max |g|. The JAX kernel
    takes transmittance as Hillis-Steele products and its prefix sums as a
    ladder, the port in slot order; the suffix a_tot - prefix is then
    divided by 1 - alpha >= 0.01. The slot rows that are nonzero must be
    the same (the walk and the accepted hits are the same).
  * render gradients, f32: atol 1e-5 x the field's max |g| (f32 sums in
    another order; the JAX reference on the CPU reduces particles by a
    cumsum difference); bf16 cotangents (low_precision_grads): atol 1e-3 x
    max, since a slot cotangent that differs in its last f32 bits can round
    to the neighbouring bf16 value (2^-8 relative).
  * the set of particles with a nonzero gradient: equal to JAX's on all but
    0.1% of the particles (golden.compare's allowance for threshold flips).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedgrut_tpu.cameras import PinholeCamera as JPinhole
from threedgrut_tpu.cameras import pose_from_matrix as jpose
from threedgrut_tpu.ops.pallas import tile_raster as jtr
from threedgrut_tpu.render import gut as jgut
from threedgrut_torch.cameras import example_camera, pose_from_matrix
from threedgrut_torch.model.gaussians import from_numpy
from threedgrut_torch.ops import fused_raster
from threedgrut_torch.ops import tile_raster as ttr
from threedgrut_torch.render import gut as tgut
from tests.test_torch_raster import inputs
from tests.test_torch_render import CAP, RES, camera_to_world, scene

ARGS = (2, 1e-4, 0.0113, 1.0 / 255.0, 0.99)


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


@pytest.mark.parametrize("aux_grads,has_t_max,degree", [
    (True, False, 2), (False, False, 2), (True, True, 2),
    (True, False, 3), (False, False, 4)])
def test_plain_b2_matches_pallas_interpret(aux_grads, has_t_max, degree):
    """Kernel degrees 3 and 4 take other branches of the response and its
    derivative than the default 2."""
    args = (degree,) + ARGS[1:]
    data, starts, ends, rays = inputs(seed=3)
    if has_t_max:
        rays = rays.clone()
        rays[:, 6] = torch.tensor(np.random.default_rng(4).uniform(
            2.5, 3.5, rays[:, 6].shape), dtype=torch.float32)
    g_out = np.random.default_rng(0).normal(size=rays.shape).astype(
        np.float32)
    out_t, _ = ttr.tile_composite_plain(data, starts, ends, rays, *args,
                                        has_t_max=has_t_max)
    out_j = jtr._forward(J(data), J(starts), J(ends), J(rays), *args,
                         has_t_max=has_t_max)
    want = np.asarray(jtr._from_windows(jtr._backward_windows(
        J(data), J(starts), J(ends), J(rays), out_j, J(g_out), degree=degree,
        min_transmittance=1e-4, min_response=0.0113, min_alpha=1 / 255.0,
        max_alpha=0.99, sorted_passes=0, has_t_max=has_t_max,
        aux_grads=aux_grads, lowprec_grads=False, row_termination=False)))
    got = ttr.tile_composite_backward_plain(
        data, starts, ends, rays, out_t, torch.tensor(g_out), *args,
        has_t_max=has_t_max, aux_grads=aux_grads).numpy()
    scale = np.abs(want).max(0) + 1e-30
    assert (np.abs(got - want) <= 1e-4 * scale).all()
    nz = np.abs(got).sum(1) > 0
    assert np.array_equal(nz, np.abs(want).sum(1) > 0)
    # Slots past each tile's early exit got exactly 0 (and with unbounded
    # rays, some tile exits early).
    walked = out_t[:, 7, 0].long()
    for t in range(rays.shape[0]):
        s, e = int(starts[t]), int(ends[t])
        assert not nz[s + int(walked[t]):e].any()
    if not has_t_max:
        assert bool((walked < (ends - starts)).any())
    assert nz.sum() > 100


def _jax_grads(acts, tgt, walk_capacity, low_precision, aux):
    w, h = RES
    cam = JPinhole(focal=jnp.asarray([0.9 * w, 0.9 * w], jnp.float32),
                   principal=jnp.asarray([w / 2, h / 2], jnp.float32),
                   radial=jnp.zeros(6), tangential=jnp.zeros(2),
                   thin_prism=jnp.zeros(4))

    def loss(*a):
        out, _ = jgut.render(*a, cam, jpose(jnp.asarray(camera_to_world())),
                             RES, CAP, walk_capacity=walk_capacity,
                             low_precision_grads=low_precision,
                             aux_gradients=aux)
        val = (jnp.mean(jnp.abs(out.rgb - tgt))
               + 0.1 * jnp.mean(out.opacity))
        if aux:
            val = val + 0.01 * jnp.mean(out.depth) + 0.1 * jnp.mean(
                out.transmittance)
        return val

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*[J(a) for a in acts])


def _torch_grads(acts, tgt, walk_capacity, low_precision, aux):
    ta = [torch.tensor(a, requires_grad=True) for a in acts]
    out, _ = tgut.render(*ta, example_camera(RES, "cpu"),
                         pose_from_matrix(torch.tensor(camera_to_world())),
                         RES, CAP, walk_capacity=walk_capacity,
                         low_precision_grads=low_precision,
                         aux_gradients=aux, device="cpu")
    val = ((out.rgb - torch.tensor(tgt)).abs().mean()
           + 0.1 * out.opacity.mean())
    if aux:
        val = (val + 0.01 * out.depth.mean()
               + 0.1 * out.transmittance.mean())
    return [g.numpy() for g in torch.autograd.grad(val, ta)]


def _activations():
    p = from_numpy(scene(), device="cpu")
    with torch.no_grad():
        return [x.numpy() for x in (p.get_positions(), p.get_rotation(),
                                    p.get_scale(), p.get_density(),
                                    p.get_features())]


@pytest.mark.parametrize("walk_capacity,low_precision,aux", [
    (None, False, True),          # two-stage, depth and T in the loss
    (CAP // 2, False, False),     # fused, compact branch (B6)
    (256, False, False),          # fused, dense branch (B5)
    (CAP // 2, True, False),      # fused compact, bf16 cotangents
])
def test_render_gradients_match_jax(walk_capacity, low_precision, aux):
    """All five render inputs (positions, rotations, scales, opacities, SH
    features) on the two-stage path and both branches of the fused one."""
    acts = _activations()
    tgt = np.random.default_rng(5).uniform(
        0, 1, (RES[1], RES[0], 3)).astype(np.float32)
    want = _jax_grads(acts, tgt, walk_capacity, low_precision, aux)
    got = _torch_grads(acts, tgt, walk_capacity, low_precision, aux)
    tol = 1e-3 if low_precision else 1e-5
    names = ("positions", "quats", "scales", "opacities", "features")
    nz_got = np.zeros(acts[0].shape[0], bool)
    nz_want = np.zeros(acts[0].shape[0], bool)
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max(),
                                   err_msg=name)
        nz_got |= np.abs(a.reshape(a.shape[0], -1)).sum(1) > 0
        nz_want |= np.abs(b.reshape(b.shape[0], -1)).sum(1) > 0
    assert (nz_got != nz_want).sum() <= max(1, int(1e-3 * nz_got.size))
    assert 0 < nz_got.sum() < nz_got.size    # some particles get nothing


def test_fused_path_matches_two_stage():
    """composite_particles against sorted_gather + tile_composite in the
    port alone: the forward bit for bit, gradients on both branches to f32
    reassociation (rtol 1e-5, atol 1e-6 x max)."""
    acts = _activations()
    tgt = torch.tensor(np.random.default_rng(6).uniform(
        0, 1, (RES[1], RES[0], 3)).astype(np.float32))
    pose = pose_from_matrix(torch.tensor(camera_to_world()))
    cam = example_camera(RES, "cpu")
    results = {}
    for wc in (None, CAP // 2, 256):
        ta = [torch.tensor(a, requires_grad=True) for a in acts]
        out, _ = tgut.render(*ta, cam, pose, RES, CAP, walk_capacity=wc,
                             aux_gradients=False, device="cpu")
        loss = ((out.rgb - tgt) ** 2).mean() + 0.1 * out.opacity.mean()
        results[wc] = (out, torch.autograd.grad(loss, ta))
    base_out, base_g = results[None]
    # The compact branch really ran: the walked windows fit in CAP // 2.
    with torch.no_grad():
        _, binning, data, grid = tgut.prepare(
            *[torch.tensor(a) for a in acts], cam, pose, RES, CAP)
        rays = tgut.packed_world_rays(cam, pose, grid)
        fwd, _ = ttr.tile_composite(data, binning.tile_starts,
                                    binning.tile_ends, rays, *ARGS[:2])
    _, cnt = fused_raster.walked_window_mask(fwd, binning.tile_starts,
                                             CAP // ttr.CHUNK)
    assert 2 < int(cnt) <= CAP // 2 // ttr.CHUNK
    for wc in (CAP // 2, 256):
        out, g = results[wc]
        for f in ("rgb", "opacity", "depth", "transmittance"):
            assert torch.equal(getattr(out, f), getattr(base_out, f)), f
        for a, b in zip(g, base_g):
            torch.testing.assert_close(a, b, rtol=1e-5,
                                       atol=1e-6 * float(b.abs().max()))


def test_differentiating_hit_visibility_raises():
    acts = [torch.tensor(a, requires_grad=True) for a in _activations()]
    out, _ = tgut.render(*acts, example_camera(RES, "cpu"),
                         pose_from_matrix(torch.tensor(camera_to_world())),
                         RES, CAP, hit_visibility=True, device="cpu")
    with pytest.raises(ValueError, match="eval-only"):
        out.rgb.sum().backward()


def test_aux_outputs_off_needs_aux_gradients_off():
    acts = [torch.tensor(a, requires_grad=True) for a in _activations()]
    args = (example_camera(RES, "cpu"),
            pose_from_matrix(torch.tensor(camera_to_world())), RES, CAP)
    for wc in (None, CAP // 2):
        with pytest.raises(ValueError, match="aux_grads=False"):
            tgut.render(*acts, *args, aux_outputs=False, walk_capacity=wc,
                        device="cpu")
    out, _ = tgut.render(*acts, *args, aux_outputs=False,
                         aux_gradients=False, device="cpu")
    out.rgb.sum().backward()
    assert float(acts[0].grad.abs().max()) > 0.0
