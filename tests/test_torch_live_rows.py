"""The live-row mask of B1's and B2's default legs (0 sorted passes, with
and without row termination), held on the plain versions
(ops/tile_raster.py) on tiny scenes. No JAX.

B1's default legs write, when a backward follows, one bit per (pixel,
walked row): set where the pixel took the row (w > 0). B2 re-walks those
bits instead of evaluating every pair again. Here:

  * the plain mask (live_rows_plain) has one set bit per hit (out row 6)
    and marks exactly the rows a sequential walk of each pixel takes;
  * the plain backward given the mask equals the plain backward without
    it, bit for bit (aux_grads on and off);
  * the default legs' work counts (tile_composite_plain's `stats`) equal a
    brute-force count of the same sequential walk, with the tile's rays
    sharing one origin and with each ray's origin its own;
  * the mask's words round-trip, and the mask has a step of its own for
    every walked window, like the sorted legs' compositing orders;
  * B1 and B2 launch their tiles heaviest first.

Exact comparisons throughout: the mask only selects rows."""
import numpy as np
import pytest
import torch

from threedgrut_torch.cameras import example_camera, look_at, pose_from_matrix
from threedgrut_torch.model.gaussians import bench_scene, from_numpy
from threedgrut_torch.ops import tile_raster as tr
from threedgrut_torch.ops import tiles
from threedgrut_torch.render import gut

CHUNK, PIX = tr.CHUNK, tr.PIX
MIN_T = 1e-4
LEGS = ["default", "rowterm"]


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch on one intra-op thread for the module, as in
    tests/test_torch_grt.py: under the parallel test run's load the plain
    versions' many small ops stall an 8-thread intra-op pool (this file
    took 920 s there, 6 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene():
    """2000 large, dense particles at 64x48 (12 tiles): most pixels
    saturate, whole warps saturate mid-window and some tiles stop before
    their range ends. Returns {leg: B1's inputs}, rays row 7 from
    tiles.row_last_touch for the row-terminated leg, every origin nudged
    on its own (no tile's rays share one) for "per_pixel"."""
    fields = bench_scene(2000, seed=2, specular_std=0.1)
    fields["scale"] = fields["scale"] + np.float32(np.log(10.0))
    fields["density"] = fields["density"] + np.float32(3.0)
    T = look_at(np.array([0.3, -4.0, 1.0], np.float32),
                np.zeros(3, np.float32), np.array([0, 0, 1.0], np.float32))
    res = (64, 48)
    p = from_numpy(fields, device="cpu")
    cam = example_camera(res, "cpu")
    pose = pose_from_matrix(torch.tensor(T))
    with torch.no_grad():
        proj, binning, data, grid = gut.prepare(
            p.get_positions(), p.get_rotation(), p.get_scale(),
            p.get_density(), p.get_features(), cam, pose, res, 1 << 15)
        rays = gut.packed_world_rays(cam, pose, grid)
    assert not bool(binning.overflow)
    touch = rays.clone()
    touch[:, 7] = tiles.row_last_touch(binning, proj, grid)
    nudged = rays.clone()
    nudged[:, 0:3] += 1e-5 * torch.randn(
        rays[:, 0:3].shape, generator=torch.Generator().manual_seed(5))
    return {leg: (data, binning.tile_starts, binning.tile_ends, r, 2, MIN_T,
                  0.0113, 1.0 / 255.0, 0.99, False)
            for leg, r in (("default", rays), ("rowterm", touch),
                           ("per_pixel", nudged))}


def sequential_walk(fwd, rowterm):
    """Each pixel's walk, one slot at a time over 256 lanes, as the kernels
    run it: T_before rounded from the running product (torch.cumprod's
    double accumulation on the CPU), a row taken where alpha > 0 and
    T_before > min_T (and, with row termination, the row at or before lt);
    the tile stops after the first window at whose end no pixel can go on.
    Returns (taken [cap, PIX] bool, pixel-live [cap, PIX] bool, walked
    [cap] bool)."""
    data, starts, ends, rays = fwd[:4]
    cap = data.shape[0]
    taken = np.zeros((cap, PIX), bool)
    px_live = np.zeros((cap, PIX), bool)
    walked = np.zeros(cap, bool)
    for t, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        if e <= s:
            continue
        q = tr._tile_pairs(data[s:e], rays[t], *fwd[4:5], *fwd[6:10])
        alpha = q["alpha"].numpy()
        lt = rays[t, 7].numpy() if rowterm else None
        prod = np.ones(PIX, np.float64)
        if rowterm and not (lt >= (s // CHUNK) * CHUNK).any():
            continue
        for k in range(s, e):
            t_before = prod.astype(np.float32)
            a = alpha[k - s]
            live = t_before > MIN_T
            if rowterm:
                a = np.where(k <= lt, a, np.float32(0.0))
                live &= k <= lt
            px_live[k] = live
            taken[k] = (a > 0) & (t_before > MIN_T)
            walked[k] = True
            prod = prod * (np.float32(1.0) - a).astype(np.float64)
            if (k + 1) % CHUNK == 0 or k + 1 == e:
                go = prod.astype(np.float32) > MIN_T
                if rowterm:
                    go &= lt >= k + 1
                if not go.any():
                    break
    return taken, px_live, walked


def mask_rows(words, win_base, starts, ends, cap):
    """The set bits of mask words [steps, CHUNK // 32, PIX] as rows [cap,
    PIX] bool, by each tile's slots."""
    rows = torch.zeros((cap, PIX), dtype=torch.bool)
    for t, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        if e > s:
            b = int(win_base[t])
            rows[s:e] = tr.unpack_rows(words[b:b + tr._windows(s, e)], s, e)
    return rows


@pytest.mark.parametrize("leg", LEGS)
def test_live_rows_popcount_is_the_hit_count(scene, leg):
    fwd = scene[leg]
    rowterm = leg == "rowterm"
    out, _ = tr.tile_composite_plain(*fwd, True, False, 0, rowterm)
    words, win_base = tr.live_rows_plain(*fwd, rowterm)
    assert words.shape == (fwd[0].shape[0] // CHUNK + fwd[3].shape[0],
                           CHUNK // 32, PIX)
    bits = mask_rows(words, win_base, fwd[1], fwd[2], fwd[0].shape[0])
    hits = torch.zeros_like(out[:, 6])
    for t, (s, e) in enumerate(zip(fwd[1].tolist(), fwd[2].tolist())):
        hits[t] = bits[s:e].sum(0).to(torch.float32)
    assert torch.equal(hits, out[:, 6])
    assert float(out[:, 6].sum()) > 1000


@pytest.mark.parametrize("leg", LEGS)
def test_live_rows_are_the_rows_a_sequential_walk_takes(scene, leg):
    fwd = scene[leg]
    rowterm = leg == "rowterm"
    words, win_base = tr.live_rows_plain(*fwd, rowterm)
    got = mask_rows(words, win_base, fwd[1], fwd[2], fwd[0].shape[0])
    taken, _, _ = sequential_walk(fwd, rowterm)
    assert np.array_equal(got.numpy(), taken)


@pytest.mark.parametrize("aux_grads", [True, False])
@pytest.mark.parametrize("leg", LEGS)
def test_backward_on_the_mask_is_bitwise_the_plain_one(scene, leg,
                                                      aux_grads):
    fwd = scene[leg]
    rowterm = leg == "rowterm"
    out, _ = tr.tile_composite_plain(*fwd, True, False, 0, rowterm)
    g_out = torch.randn(out.shape,
                        generator=torch.Generator().manual_seed(3))
    args = fwd[:4] + (out, g_out) + fwd[4:] + (aux_grads, 0, rowterm)
    want = tr.tile_composite_backward_plain(*args)
    mask = tr.live_rows_plain(*fwd, rowterm)
    got = tr.tile_composite_backward_plain(*args, mask=mask)
    assert torch.equal(got, want)
    assert int((want != 0).any(1).sum()) > 1000
    # A mask missing rows gives other gradients: it carries the walk.
    thin = (mask[0] & 0x55555555, mask[1])
    assert not torch.equal(
        tr.tile_composite_backward_plain(*args, mask=thin), want)


def test_backward_refuses_a_mask_with_sorted_passes(scene):
    fwd = scene["default"]
    out, _ = tr.tile_composite_plain(*fwd)
    mask = tr.live_rows_plain(*fwd)
    with pytest.raises(ValueError, match="default legs"):
        tr.tile_composite_backward_plain(*fwd[:4], out, out, *fwd[4:],
                                         True, 16, False, mask=mask)


@pytest.mark.parametrize("leg", LEGS + ["per_pixel"])
def test_default_stats_match_a_brute_force_count(scene, leg):
    fwd = scene[leg]
    rowterm = leg == "rowterm"
    stats = {}
    out, _ = tr.tile_composite_plain(*fwd, True, False, 0, rowterm,
                                     stats=stats)
    taken, px_live, walked = sequential_walk(fwd, rowterm)
    assert int(walked.sum()) == int(out[:, 7, 0].sum())
    # The pair's per-row part: once per row of a tile whose 256 origins
    # are bitwise equal, once per pixel elsewhere.
    shared = np.zeros(walked.shape, bool)
    for t, (s, e) in enumerate(zip(fwd[1].tolist(), fwd[2].tolist())):
        o = fwd[3][t, 0:3].numpy().view(np.int32)
        shared[s:e] = bool((o == o[:, :1]).all())
    shared = shared[walked]
    taken, px_live = taken[walked], px_live[walked]
    warps = (-1, PIX // 32, 32)

    def parts(rows):
        return int(np.where(shared, rows.any(1), rows.sum(1)).sum())

    want = {
        "pixel_live_pairs": int(px_live.sum()),
        "live_pairs": int(taken.sum()),
        "warp_live_rows": int(taken.reshape(warps).any(-1).sum()),
        "saturated_warp_rows": int((~px_live).reshape(warps).all(-1).sum()),
        "row_parts": parts(px_live),
        "live_row_parts": parts(taken),
    }
    assert stats == want
    # The scene exercises every count: saturated warps, a walk that stops
    # before some tile's range ends, and both forms of the per-row part.
    assert want["saturated_warp_rows"] > 1000
    assert 0 < want["live_pairs"] < want["pixel_live_pairs"]
    assert int(walked.sum()) < int((fwd[2] - fwd[1]).sum())
    if leg == "per_pixel":
        assert not shared.any()
        assert want["row_parts"] == want["pixel_live_pairs"]
    else:
        assert shared.all()
        assert 0 < want["row_parts"] < want["pixel_live_pairs"] // 32


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_words_round_trip(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        s = int(rng.integers(0, 4 * CHUNK))
        e = s + int(rng.integers(1, 3 * CHUNK))
        taken = torch.tensor(rng.random((e - s, PIX)) < 0.5)
        words = tr.pack_rows(taken, s, e)
        assert words.dtype == torch.int32
        assert words.shape == (tr._windows(s, e), CHUNK // 32, PIX)
        assert torch.equal(tr.unpack_rows(words, s, e), taken)
    # Bit 31 (row 31 of a word) is the int32 sign bit.
    one = torch.zeros((CHUNK, PIX), dtype=torch.bool)
    one[31, 0] = True
    assert int(tr.pack_rows(one, 0, CHUNK)[0, 0, 0]) == -2**31


def test_mask_buffer_gives_every_walked_window_its_own_step(scene):
    """The default legs' mask takes the sorted legs' layout (win_base) with
    CHUNK / 32 words a step; forward_order sizes it by the leg, and only
    off the CPU and for a backward."""
    data, s, e, rays = scene["default"][:4]
    words, base, order = tr.order_buffer(s, e, data.shape[0],
                                         tr.walk_words(0))
    orders, obase, _ = tr.order_buffer(s, e, data.shape[0],
                                       tr.walk_words(16))
    assert words.shape[1:] == (CHUNK // 32, PIX)
    assert orders.shape[1:] == (CHUNK // 4, PIX)
    assert torch.equal(base, obase) and words.shape[0] == orders.shape[0]
    assert torch.equal(order, tr.heaviest_first(e - s))
    steps = [int(base[t]) + k for t in range(s.shape[0])
             for k in range(tr._windows(int(s[t]), int(e[t])))]
    assert len(set(steps)) == len(steps) and max(steps) < words.shape[0]
    assert tr.forward_order(data, s, e, rays, 0, True) is None   # the CPU
    meta = [x.to("meta") for x in (data, s, e, rays)]
    assert tr.forward_order(*meta, 0, False) is None
    for passes in (0, 16):
        buf = tr.forward_order(*meta, passes, True)[0]
        assert tuple(buf.shape) == (data.shape[0] // CHUNK + s.shape[0],
                                    tr.walk_words(passes), PIX)


def test_default_legs_launch_the_heaviest_tiles_first(scene):
    s, e = scene["default"][1:3]
    work = e - s
    order = tr.heaviest_first(work)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(s.shape[0]))
    assert bool((work[order.long()][1:] <= work[order.long()][:-1]).all())
