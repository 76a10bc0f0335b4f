"""Binning of the PyTorch port against the JAX package: the plain versions
of kernels B3 (cull masks) and B4 (key expansion) and the whole
bin_particles, all exact. The JAX Pallas kernels run in interpret mode, as
tests/test_binning.py runs them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedgrut_tpu.ops import tiles as jtiles
from threedgrut_tpu.ops.pallas import expand as jex
from threedgrut_torch.ops import expand as tex
from threedgrut_torch.ops import tiles as ttiles
from tests.test_binning import make_proj


def cull_inputs(n, seed):
    """Like tests/test_binning.py: dead particles (n_tiles 0, bbox nonzero),
    non-maskable bboxes (> 8x8) and culling-heavy conics."""
    rng = np.random.default_rng(seed)
    tmin = rng.integers(0, 40, (n, 2)).astype(np.int32)
    w = rng.integers(1, 12, (n,))
    h = rng.integers(1, 12, (n,))
    tmax = np.stack([tmin[:, 0] + w, tmin[:, 1] + h], -1).astype(np.int32)
    ntiles = (w * h).astype(np.int32)
    ntiles[rng.random(n) < 0.3] = 0
    conic = np.abs(rng.normal(0.05, 0.03, (n, 3))).astype(np.float32)
    conic[:, 1] *= 0.2
    center = rng.uniform(0, 40 * 16.0, (n, 2)).astype(np.float32)
    max_power = rng.uniform(0.2, 4.0, n).astype(np.float32)
    return tmin, tmax, ntiles, conic, center, max_power


def test_cull_masks_plain_matches_jax(monkeypatch):
    args = cull_inputs(jex._CM_BLK * 2, seed=17)
    counts, record = tex.cull_masks(*(torch.tensor(a) for a in args))
    got = [counts.numpy()] + list(tex.unpack_record(record).masks.T.numpy())
    jargs = [jnp.asarray(a) for a in args]
    with monkeypatch.context() as m:
        m.setenv("THREEDGRUT_CULLMASK", "xla")
        xla = jex.cull_masks(*jargs, True)
    pallas = jex.cull_masks_pallas(*jargs)          # interpret mode here
    for i, name in enumerate(("counts", "m0", "m1", "m2")):
        assert np.array_equal(got[i], np.asarray(xla[i])), name
        assert np.array_equal(got[i], np.asarray(pallas[i])), name
    assert got[0].sum() < args[2].sum()              # culling happened


@pytest.mark.parametrize("m", [0, 1, 5, 23, 24, 47, 63])
def test_select_nth_set_bit(m):
    rng = np.random.default_rng(m)
    bits = rng.random((256, 64)) < 0.4
    bits[:, m] = True
    words = [sum((bits[:, lo + i].astype(np.int64) << i) for i in range(wd))
             .astype(np.int32) for lo, wd in ((0, 24), (24, 24), (48, 16))]
    r = np.minimum(rng.integers(0, 64, 256), bits.sum(1) - 1).astype(np.int32)
    a = np.asarray(jex.select_nth_set_bit(*(jnp.asarray(w) for w in words),
                                          jnp.asarray(r)))
    b = tex.select_nth_set_bit(*(torch.tensor(w) for w in words),
                               torch.tensor(r)).numpy()
    assert np.array_equal(a, b)


def jax_expand_keys(proj, masks, cap, grid, cull):
    """The JAX expand_keys kernel (interpret mode) on the rank-compacted
    attribute table built exactly as tiles._bin_particles_pallas builds it."""
    counts, m0, m1, m2 = (jnp.asarray(m) for m in masks)
    n = counts.shape[0]
    has = counts > 0
    idx = jnp.arange(n, dtype=jnp.int32)
    rank_key = jnp.where(has, proj.depth, jnp.finfo(jnp.float32).max)
    _, ids_of_rank = jax.lax.sort((rank_key, idx), num_keys=1)
    attrs = jnp.concatenate([
        proj.tile_min.astype(jnp.float32),
        (proj.tile_max[:, 0] - proj.tile_min[:, 0])[:, None].astype(
            jnp.float32),
        counts[:, None].astype(jnp.float32), m0[:, None].astype(jnp.float32),
        proj.conic, proj.center, proj.max_power[:, None],
        m1[:, None].astype(jnp.float32), m2[:, None].astype(jnp.float32),
    ], axis=-1)
    a_rank = attrs[ids_of_rank]
    counts_rank = a_rank[:, 3].astype(jnp.int32)
    ends_rank = jnp.cumsum(counts_rank)
    starts_rank = (ends_rank - counts_rank).astype(jnp.float32)
    a_rank = jnp.concatenate([a_rank, starts_rank[:, None],
                              ids_of_rank.astype(jnp.float32)[:, None],
                              jnp.ones((n, 1), jnp.float32)], axis=-1)
    m_pad = max(512, -(-n // 256) * 256)
    a_rank = jnp.concatenate([a_rank, jnp.zeros((m_pad - n, 16))])
    ends_pad = jnp.concatenate([ends_rank,
                                jnp.broadcast_to(ends_rank[-1:],
                                                 (m_pad - n,))])
    return jex.expand_keys(a_rank.T, ends_pad.astype(jnp.int32), cap, grid,
                           cull, pid_sentinel=n)


@pytest.mark.parametrize("n,cull,cap", [(700, True, 2048),
                                        (700, False, 2048),
                                        (2000, True, 1024)])
def test_expand_keys_plain_matches_jax(n, cull, cap):
    grid = (6, 5)
    proj = make_proj(n, 3, dead_frac=0.0 if cap == 1024 else 0.4)
    tp = ttiles.Projection(*(torch.tensor(np.asarray(x)) for x in proj))
    counts, record = tex.cull_masks(tp.tile_min, tp.tile_max, tp.n_tiles,
                                    tp.conic, tp.center, tp.max_power, cull)
    masks = torch.cat([counts[None], tex.unpack_record(record).masks.T])
    ids_of_rank, ends_rank = ttiles.depth_rank(counts, tp.depth)
    got = tex.expand_keys(ends_rank, ids_of_rank, record, cap, grid, cull)
    want = jax_expand_keys(proj, masks.numpy(), cap, grid, cull)
    if cap == 1024:
        assert int(ends_rank[-1]) > cap              # the overflow case
    for name, a, b in zip(("tile_key", "pid", "rowbits"), got, want):
        assert np.array_equal(a.numpy(), np.asarray(b)), name


@pytest.mark.parametrize("n,seed,cull,cap", [
    (700, 3, True, 4096), (700, 7, False, 4096), (513, 11, True, 4096),
    (2000, 5, True, 1024)])
def test_bin_particles_matches_jax_xla(n, seed, cull, cap):
    """Every TileBinning field equals _bin_particles_xla's, including
    num_intersections, overflow and the truncation past capacity."""
    grid = (6, 5)
    proj = make_proj(n, seed, dead_frac=0.0 if cap == 1024 else 0.4)
    want = jtiles._bin_particles_xla(proj, grid, cap, cull)
    got = ttiles.bin_particles(
        ttiles.Projection(*(torch.tensor(np.asarray(x)) for x in proj)),
        grid, cap, cull)
    for f in jtiles.TileBinning._fields:
        assert np.array_equal(np.asarray(getattr(want, f)),
                              getattr(got, f).numpy()), f
    assert bool(got.overflow) == (cap == 1024)


def test_bin_particles_rejects_oversized_ids():
    tp = ttiles.Projection(*(torch.tensor(np.asarray(x))
                             for x in make_proj(4, 0)))
    with pytest.raises(ValueError):
        ttiles.bin_particles(tp, (6, 5), 1 << 24)
