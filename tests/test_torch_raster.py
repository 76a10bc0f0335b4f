"""Kernel B1 (the tile compositor forward) of the PyTorch port: its plain
version against the JAX Pallas kernel run in interpret mode, on the same
packed slots and rays (32x32 frame, 4 tiles, capacity 512 = 4 windows).

Tolerance: rows 0-5 atol 2e-4 / rtol 1e-4 (sequential products vs the JAX
Hillis-Steele ladder); hit count off by at most 1 on at most one pixel;
row 7 (slots walked before the early exit) and the flagged slots exact.
Its backward (B2) against jax.vjp of the JAX compositor."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from threedgrut_tpu.ops.pallas import tile_raster as jtr
from threedgrut_torch.cameras import SensorPose, example_camera
from threedgrut_torch.ops import tile_raster as ttr
from threedgrut_torch.render import gut

RES = (32, 32)


def inputs(seed, n=100):
    """Packed sorted slots, tile ranges and rays of a dense random scene in
    front of an identity camera, from the port's own pipeline (CPU)."""
    rng = np.random.default_rng(seed)
    pos = torch.tensor(rng.uniform(-1.8, 1.8, (n, 3)) * [1, 1, 0.3]
                       + [0, 0, 3.0], dtype=torch.float32)
    q = torch.tensor(rng.normal(size=(n, 4)), dtype=torch.float32)
    q = q / q.norm(dim=-1, keepdim=True)
    s = torch.tensor(np.exp(rng.normal(size=(n, 3)) * 0.3 - 0.6),
                     dtype=torch.float32)
    opa = torch.tensor(rng.uniform(0.9, 0.99, n), dtype=torch.float32)
    feats = torch.tensor(rng.normal(size=(n, 16, 3)) * 0.3,
                         dtype=torch.float32)
    one = torch.tensor([1.0, 0.0, 0.0, 0.0])
    pose = SensorPose(one, torch.zeros(3), one, torch.zeros(3))
    cam = example_camera(RES, "cpu")
    with torch.no_grad():
        _, binning, data_sorted, grid = gut.prepare(pos, q, s, opa, feats,
                                                    cam, pose, RES, 512)
        rays = gut.packed_world_rays(cam, pose, grid)
    assert not bool(binning.overflow)
    return data_sorted, binning.tile_starts, binning.tile_ends, rays


@pytest.mark.parametrize("emit_flags", [False, True])
@pytest.mark.parametrize("has_t_max,degree", [(False, 2), (True, 2),
                                              (False, 4)])
def test_plain_b1_matches_pallas_interpret(emit_flags, has_t_max, degree):
    data, starts, ends, rays = inputs(seed=3)
    if has_t_max:
        # Bound half the rays to a segment that ends inside the scene.
        t = torch.tensor(np.random.default_rng(4).uniform(
            2.5, 3.2, rays[:, 6].shape), dtype=torch.float32)
        rays = rays.clone()
        rays[:, 6] = torch.where(torch.rand(t.shape, generator=torch
                                            .Generator().manual_seed(5))
                                 < 0.5, t, torch.zeros_like(t))
    args = (degree, 1e-4, 0.0113, 1.0 / 255.0, 0.99)
    want = jtr._forward(jnp.asarray(data.numpy()),
                        jnp.asarray(starts.numpy()),
                        jnp.asarray(ends.numpy()), jnp.asarray(rays.numpy()),
                        *args, has_t_max=has_t_max, emit_flags=emit_flags)
    got, flags = ttr.tile_composite_plain(data, starts, ends, rays, *args,
                                          has_t_max=has_t_max,
                                          emit_flags=emit_flags)
    if emit_flags:
        want, want_flags = want
        np.testing.assert_allclose(flags.numpy(), np.asarray(want_flags),
                                   atol=2e-4, rtol=1e-4)
        assert np.array_equal(flags.numpy() > 0, np.asarray(want_flags) > 0)
    want = np.asarray(want)
    got = got.numpy()
    np.testing.assert_allclose(got[:, 0:6], want[:, 0:6], atol=2e-4,
                               rtol=1e-4)
    dh = np.abs(got[:, 6] - want[:, 6])
    assert dh.max() <= 1 and (dh > 0).sum() <= 1
    assert np.array_equal(got[:, 7], want[:, 7])
    if not has_t_max:
        # The scene exercises early exit: a tile stopped before its end.
        assert (got[:, 7, 0] < (ends - starts).numpy()).any()


def test_tile_composite_backward_matches_jax():
    """Autograd through the port's tile_composite (its backward is B2,
    here its plain version) against jax.vjp of the JAX package's
    tile_composite on the same slots, rays and output cotangent. Tolerance:
    atol 1e-4 x each column's max |g| (test_torch_backward.py says why)."""
    data, starts, ends, rays = inputs(seed=6, n=64)
    g_out = np.random.default_rng(7).normal(size=rays.shape).astype(
        np.float32)
    args = (2, 1e-4, 0.0113, 1.0 / 255.0, 0.99)
    _, vjp = jax.vjp(lambda d: jtr.tile_composite(
        d, jnp.asarray(starts.numpy()), jnp.asarray(ends.numpy()),
        jnp.asarray(rays.numpy()), *args, has_t_max=False),
        jnp.asarray(data.numpy()))
    want = np.asarray(vjp(jnp.asarray(g_out))[0])
    d = data.clone().requires_grad_(True)
    out, _ = ttr.tile_composite(d, starts, ends, rays, *args,
                                has_t_max=False)
    out.backward(torch.tensor(g_out))
    got = d.grad.numpy()
    scale = np.abs(want).max(0) + 1e-30
    assert (np.abs(got - want) <= 1e-4 * scale).all()
    assert np.array_equal(np.abs(got).sum(1) > 0, np.abs(want).sum(1) > 0)
    assert (np.abs(got).sum(1) > 0).sum() > 20
