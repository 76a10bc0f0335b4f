"""The properties of the sorted mode's odd-even network and walk that B1's
and B2's sorted legs (csrc/tile_raster_fwd.cu, tile_raster_bwd.cu) rely on,
held on the plain versions (ops/tile_raster.py) on adversarial windows:

  * rows pinned at -3.4e38 before a tile's range never move, and no row of
    the tile passes them, so the kernels start compositing at position lo;
  * a pixel that stops after two quiet passes (the kernels' early stop) has
    the keys and rows of all `passes` passes;
  * T_before never grows along a pixel's compositing order, so the kernels
    stop a walk at the first T_before <= min_transmittance.

Exact comparisons: the network only moves values."""
import numpy as np
import pytest
import torch

from threedgrut_torch.ops import tile_raster as tr

CHUNK = tr.CHUNK


def windows(kind: str, lanes: int = 8, seed: int = 0, presort=False):
    """[lanes, CHUNK] keys of one window per lane: rows [lo, hi) of the
    tile (hit_t >= 0), the rest pinned at -/+BIG. Kinds: reverse order,
    runs of ties, random, and random with +inf keys (a hit_t that
    overflowed). `presort` sorts the tile's keys of every other lane, and
    swaps one pair back in every fourth (lanes that stop after 2 passes or
    a few)."""
    rng = np.random.default_rng(seed)
    key = np.empty((lanes, CHUNK), np.float32)
    los = rng.integers(0, 64, lanes)
    his = np.minimum(los + rng.integers(2, CHUNK, lanes), CHUNK)
    for b in range(lanes):
        lo, hi = int(los[b]), int(his[b])
        n = hi - lo
        if kind == "reverse":
            v = np.linspace(9.0, 1.0, n)
        elif kind == "ties":
            v = np.repeat(rng.integers(0, 5, (n + 2) // 3), 3)[:n]
        elif kind == "random":
            v = rng.uniform(0.0, 10.0, n)
        else:
            v = rng.uniform(0.0, 10.0, n)
            v[rng.random(n) < 0.1] = np.inf
        if presort and b % 2 == 0:
            v = np.sort(v)
            if b % 4 == 2:
                v[[0, 1]] = v[[1, 0]]
        key[b, :lo] = -tr.BIG
        key[b, lo:hi] = v
        key[b, hi:] = tr.BIG
    return torch.tensor(key), los, his


KINDS = ["reverse", "ties", "random", "inf"]


@pytest.mark.parametrize("passes", [1, 2, 16, 70])
@pytest.mark.parametrize("kind", KINDS)
def test_pinned_rows_before_the_tile_stay_put(kind, passes):
    key, los, _ = windows(kind)
    pos = torch.arange(CHUNK).expand(key.shape)
    _, (rows,) = tr.oddeven_passes(key, [pos], passes)
    for b, lo in enumerate(los):
        assert torch.equal(rows[b, :lo], torch.arange(int(lo)))
        assert bool((rows[b, lo:] >= int(lo)).all())


@pytest.mark.parametrize("passes", [16, 70])
@pytest.mark.parametrize("kind", KINDS)
def test_two_quiet_passes_stop_is_exact(kind, passes):
    """Each lane run for the passes the kernels run it (tr._passes_run)
    ends where all `passes` passes end."""
    key, _, _ = windows(kind, seed=1, presort=True)
    pos = torch.arange(CHUNK).expand(key.shape)
    activity = []
    want_key, (want_rows,) = tr.oddeven_passes(key, [pos], passes, activity)
    run = tr._passes_run([a[:, None] for a in activity], passes)[:, 0]
    assert bool((run < passes).any())
    for b in range(key.shape[0]):
        k, (r,) = tr.oddeven_passes(key[b:b + 1], [pos[b:b + 1]],
                                    int(run[b]))
        assert torch.equal(k, want_key[b:b + 1])
        assert torch.equal(r, want_rows[b:b + 1])


@pytest.mark.parametrize("passes", [1, 16])
def test_transmittance_before_never_grows_in_compositing_order(passes):
    """`_window_weights` on a window of 8 tiles whose alphas run up to
    max_alpha: along each pixel's compositing order T_before is
    non-increasing, so once it is at or below min_transmittance it stays
    there."""
    rng = np.random.default_rng(2)
    tiles = 8
    S = np.zeros((tiles, CHUNK, 16), np.float32)
    a = np.linalg.qr(rng.normal(size=(tiles, CHUNK, 3, 3)))[0]
    S[..., 0:9] = (a / rng.uniform(0.2, 0.6, (tiles, CHUNK, 1, 3))).reshape(
        tiles, CHUNK, 9)
    S[..., 9:11] = rng.uniform(-0.3, 0.3, (tiles, CHUNK, 2))
    S[..., 11] = rng.uniform(-3.0, 3.0, (tiles, CHUNK))
    S[..., 12] = rng.uniform(0.05, 1.0, (tiles, CHUNK))
    rays = np.zeros((tiles, 8, tr.PIX), np.float32)
    pix = np.arange(tr.PIX)
    rays[:, 0] = (pix % 16 - 7.5) * 0.03
    rays[:, 1] = (pix // 16 - 7.5) * 0.03
    rays[:, 2] = -10.0
    rays[:, 5] = 1.0
    s = torch.tensor(rng.integers(0, 40, tiles))
    e = s + torch.tensor(rng.integers(40, CHUNK - 40, tiles))
    rows = torch.arange(CHUNK).expand(tiles, CHUNK)
    _, _, t_before, _, w, pos = tr._window_weights(
        torch.tensor(S), torch.tensor(rays), rows, s, e,
        torch.ones(tiles, tr.PIX), None, 2, 1e-4, 0.0113, 1.0 / 255.0,
        0.99, False, passes)
    ordered = torch.gather(t_before, 1, pos)
    assert bool((ordered[:, 1:] <= ordered[:, :-1]).all())
    assert bool((ordered[:, -1] <= 1e-4).any())
    assert bool((w > 0).any())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_order_buffer_gives_every_walked_window_its_own_step(seed):
    """tr.order_buffer: tile t's k-th window at step win_base[t] + k, the
    steps of all tiles distinct and inside the buffer, for disjoint tile
    ranges of any length (empty ones too), sized without a host sync; the
    tiles' launch order heaviest first."""
    rng = np.random.default_rng(seed)
    cap, tiles = CHUNK * 40, 300
    cuts = np.sort(rng.integers(0, cap + 1, 2 * tiles)).reshape(tiles, 2)
    s = torch.tensor(cuts[:, 0], dtype=torch.int32)
    e = torch.tensor(cuts[:, 1], dtype=torch.int32)
    words, base, order = tr.order_buffer(s, e, cap)
    assert words.dtype == torch.int32 and base.dtype == torch.int32
    assert torch.equal(order, tr.heaviest_first(e - s))
    steps = []
    for t in range(tiles):
        if e[t] > s[t]:
            n = (int(e[t]) - 1) // CHUNK + 1 - int(s[t]) // CHUNK
            steps += range(int(base[t]), int(base[t]) + n)
    assert len(set(steps)) == len(steps)
    assert min(steps) >= 0 and max(steps) < words.shape[0]
