"""The CUDA kernels of threedgrut_torch against their plain versions, on the
card. Marked `cuda`: without a card and nvcc every test skips (the fixture
decides, at run time). Nothing here imports JAX, so the file runs where JAX
is not installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: B3 and B4 exact (--fmad=false, same f32 operations; also on
the binning edge cases of b4_edge_case, in both culling modes); B1 rows
0-5 atol 2e-4 / rtol 1e-4 (colour sums in another order), hit counts, the
walked slots and the flagged slots exact (same per-pair alpha and the same
sequential transmittance); whole frames card vs CPU within golden.compare.
B2: atol 1e-5 x each column's max (the same per-pixel values, summed over
the tile's pixels in another order), the nonzero slots exactly equal. B5,
B6: within segment_sum.f32_sum_bound (sequential f32 sums against the
plain f64 ones); B6 at both widths also bit-equal to each segment's rows
added in row order in f32 on the host. B7: rows 0-5 atol 2e-4 / rtol 1e-4 (the same per-pair
alpha; products and colour sums in another order), hit counts off by at
most 1 on at most 0.1% of the rays and walked windows equal on all but
0.1% of the bundles (a T_before at min_transmittance may flip); traces and
3DGRT frames card vs CPU within golden.compare. B8 against its plain
version on the card's own forward output: the nonzero slot rows equal,
values atol 1e-4 x each column's max (the same per-ray chains, summed over
the bundle's rays in another order, the suffix residual from a sequential
prefix here and a cumsum there), bit-identical across two launches; B8
on the orders B7 wrote bit-equal to B8 whose wrapper runs B7 for them,
and B7 writing orders bit-equal to B7 writing none. B6 at
64 channels: within f32_sum_bound. A 3DGRT train step card vs CPU: loss
rtol 1e-4, gradients within golden.rows_agree(1e-4), bit-identical on the
card across two runs. B1 and B2 with sorted passes and row termination:
the default legs' tolerances, and two launches bit-identical. B1's
default legs' live-row mask bit-equal to live_rows_plain's on every walked
window, B2 on it bit-equal to B2 given none, and both legs with per-pixel
origins (no tile's rays share one) at the default legs' tolerances. B9 exact
(a copy; also against its plain three-pass mirror on edge cases) and
bit-identical across launches; the flat cull's legs card vs
CPU within golden.lists_agree at TRACE_FLIP_SHARE (cone-margin flips).
Inference card vs CPU (chip_smoke.infer_card_vs_cpu): frames within
golden.compare, compacted ids up to census flips on 0.1% of the visible
count, frozen binnings exactly equal; a scene exported and read back
onto the card bit-equal, its frame bit for bit. M1 (the playground's mesh
closest-hit) bit-equal to its plain version, its cull's masks equal to
the plain cull's; the playground's frames card
vs CPU within golden.compare's value rule at TRACE_FLIP_SHARE."""
import os
import shutil

import numpy as np
import pytest
import torch

from threedgrut_torch import api, golden
from threedgrut_torch.cameras import example_camera, look_at, pose_from_matrix
from threedgrut_torch.model.gaussians import bench_scene, from_numpy
from threedgrut_torch.ops import (bundle_trace, cuda_build, expand,
                                  segment_sum, stream_compact, tile_raster,
                                  tiles)
from threedgrut_torch.render import grt, gut

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def scene(n, res, device):
    """(params, camera, pose) of a seeded scene seen from (0.3, -4, 1)."""
    fields = bench_scene(n, seed=2, specular_std=0.1)
    fields["scale"] = fields["scale"] + np.float32(np.log(4.0))
    T = look_at(np.array([0.3, -4.0, 1.0], np.float32),
                np.zeros(3, np.float32), np.array([0, 0, 1.0], np.float32))
    return (from_numpy(fields, device=device), example_camera(res, device),
            pose_from_matrix(torch.tensor(T, device=device)))


def prepared(device, n=20_000, res=(256, 192), cap=1 << 18):
    p, cam, pose = scene(n, res, device)
    with torch.no_grad():
        proj, binning, data, grid = gut.prepare(
            p.get_positions(), p.get_rotation(), p.get_scale(),
            p.get_density(), p.get_features(), cam, pose, res, cap)
        rays = gut.packed_world_rays(cam, pose, grid)
    return proj, binning, data, grid, rays


def b3_inputs(proj):
    return (proj.tile_min.int().contiguous(), proj.tile_max.int().contiguous(),
            proj.n_tiles.int().contiguous(), proj.conic.contiguous(),
            proj.center.contiguous(), proj.max_power.contiguous())


def test_cull_masks_kernel_matches_plain(dev):
    proj = prepared(dev)[0]
    args = b3_inputs(proj)
    before = cuda_build.launches["cull_masks"]
    got = expand.cull_masks(*args)
    assert cuda_build.launches["cull_masks"] == before + 1
    for a, b in zip(got, expand.cull_masks_plain(*args)):
        assert torch.equal(a, b)
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("cap", [1 << 18, 4096])
def test_expand_keys_kernel_matches_plain(dev, cap):
    proj, _, _, grid, _ = prepared(dev)
    counts, record = expand.cull_masks(*b3_inputs(proj))
    ids_of_rank, ends_rank = tiles.depth_rank(counts, proj.depth)
    b4 = (ends_rank, ids_of_rank, record, cap, grid, True)
    for a, b in zip(expand.expand_keys(*b4), expand.expand_keys_plain(*b4)):
        assert torch.equal(a, b)


# B3's and B4's edge cases (b4_edge_case)
B4_CASES = ["below", "above", "total0", "n1", "big", "singles",
            "zero-inside"]


def b4_edge_case(dev, name):
    """(B3's inputs, depths, an order of ranks or None, capacity, tile
    grid) of a binning edge case on a 24 x 16 tile grid, seeded:
    "below" and "above" 1,500 particles (30% with no tile) at a capacity
    below the total and above it (not a multiple of 256); "total0" no
    particle with a tile; "n1" one particle; "big" one particle whose
    20 x 15-tile bbox (unmaskable) owns 300 slots among 39 small ones;
    "singles" 700 particles of one tile each, centred in it, so that
    every 256-slot window holds exactly 256 single-slot ranks; and
    "zero-inside" 4,000 particles, 80% with no tile, ranked in a random
    order instead of by depth, so that zero-count ranks lie inside the
    list and a window's slots span more than 256 ranks."""
    rng = np.random.default_rng(B4_CASES.index(name))
    gx, gy = 24, 16
    n = {"n1": 1, "big": 40, "singles": 700, "zero-inside": 4000}.get(
        name, 1500)
    size = 2 if name == "zero-inside" else 8
    tmin = np.stack([rng.integers(0, gx - size, n),
                     rng.integers(0, gy - size, n)], -1)
    wh = rng.integers(1, size + 1, (n, 2))
    if name == "singles":
        wh[:] = 1
    if name == "big":
        tmin[0], wh[0] = (2, 1), (20, 15)
    tmax = tmin + wh
    ntiles = wh[:, 0] * wh[:, 1]
    dead = {"below": 0.3, "above": 0.3, "total0": 1.0, "zero-inside": 0.8}
    ntiles[rng.random(n) < dead.get(name, 0.0)] = 0
    conic = np.abs(rng.normal(0.02, 0.015, (n, 3)))
    conic[:, 1] *= rng.choice([-0.3, 0.3], n)
    center = (tmin + rng.uniform(0, 1, (n, 2)) * wh) * 16.0
    if name == "singles":
        center = (tmin + 0.5) * 16.0
    max_power = rng.uniform(0.5, 6.0, n)
    t = lambda x, dt: torch.tensor(np.asarray(x, dt), device=dev)
    b3 = (t(tmin, np.int32), t(tmax, np.int32), t(ntiles, np.int32),
          t(conic, np.float32), t(center, np.float32),
          t(max_power, np.float32))
    depth = t(rng.uniform(1.0, 9.0, n), np.float32)
    order = (t(rng.permutation(n), np.int32) if name == "zero-inside"
             else None)
    cap = {"below": 2048, "above": 30000, "total0": 1024, "n1": 512,
           "big": 1024, "singles": 1024, "zero-inside": 2048}[name]
    return b3, depth, order, cap, (gx, gy)


def b4_args(case, counts, record, tile_culling):
    """expand_keys' arguments for b4_edge_case's `case` on B3's outputs:
    ranks by tiles.depth_rank, or in the case's own order."""
    _, depth, order, cap, grid = case
    if order is None:
        ids_of_rank, ends_rank = tiles.depth_rank(counts, depth)
    else:
        ids_of_rank = order
        ends_rank = torch.cumsum(counts[order.long()], 0, dtype=torch.int32)
    return ends_rank, ids_of_rank, record, cap, grid, tile_culling


@pytest.mark.parametrize("tile_culling", [True, False])
@pytest.mark.parametrize("name", B4_CASES)
def test_binning_kernels_on_edge_cases(dev, name, tile_culling):
    """B3 (counts and records) and B4 bit-equal to their plain versions on
    b4_edge_case, in both culling modes."""
    case = b4_edge_case(dev, name)
    got = expand.cull_masks(*case[0], tile_culling=tile_culling)
    for a, b in zip(got, expand.cull_masks_plain(*case[0],
                                                 tile_culling=tile_culling)):
        assert torch.equal(a, b)
    args = b4_args(case, *got, tile_culling)
    before = cuda_build.launches["expand_keys"]
    k = expand.expand_keys(*args)
    assert cuda_build.launches["expand_keys"] == before + 1
    for a, b in zip(k, expand.expand_keys_plain(*args)):
        assert torch.equal(a, b)


def test_bin_particles_card_matches_cpu(dev):
    proj, binning, _, grid, _ = prepared(dev)
    want = tiles.bin_particles(tiles.Projection(*[x.cpu() for x in proj]),
                               grid, 1 << 18)
    for f in tiles.TileBinning._fields:
        assert torch.equal(getattr(binning, f).cpu(), getattr(want, f)), f


@pytest.mark.parametrize("emit_flags", [False, True])
def test_tile_raster_kernel_matches_plain(dev, emit_flags):
    _, binning, data, _, rays = prepared(dev)
    args = (data, binning.tile_starts, binning.tile_ends, rays, 2, 1e-4,
            0.0113, 1.0 / 255.0, 0.99, False, True, emit_flags)
    ko, kf = tile_raster._launch(*args)
    po, pf = tile_raster.tile_composite_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(ko[:, 0:6], po[:, 0:6], atol=2e-4, rtol=1e-4)
    assert torch.equal(ko[:, 6:8], po[:, 6:8])
    if emit_flags:
        assert torch.equal(kf > 0, pf > 0)
        torch.testing.assert_close(kf, pf, atol=2e-4, rtol=1e-4)


# (sorted_passes, row termination: None, "touch" (tiles.row_last_touch) or
# "mid" (every pixel of a tile ends at its midpoint slot), emit_flags)
OPTION_CASES = [(16, None, False), (16, None, True), (0, "touch", False),
                (0, "mid", True), (16, "mid", False)]
OPTION_IDS = ["sorted16", "sorted16-flags", "rowterm", "rowterm-mid-flags",
              "sorted16-rowterm-mid"]


def option_inputs(dev, rowterm):
    """prepared()'s scene with rays row 7 filled for row termination."""
    proj, binning, data, grid, rays = prepared(dev)
    if rowterm == "touch":
        rays[:, 7] = tiles.row_last_touch(binning, proj, grid)
    elif rowterm == "mid":
        s, e = binning.tile_starts, binning.tile_ends
        mid = torch.where(e > s, torch.div(s + e, 2, rounding_mode="floor"),
                          -1)
        rays[:, 7] = mid.to(torch.float32)[:, None]
    return binning, data, rays


@pytest.mark.parametrize("passes,rowterm,emit_flags", OPTION_CASES,
                         ids=OPTION_IDS)
def test_tile_raster_option_legs_match_plain(dev, passes, rowterm,
                                             emit_flags):
    """B1's sorted and row-terminated legs against the plain version on the
    card: the same tolerances as the default leg (the same per-pair alpha,
    keys and products in the same order), the flagged slots exact; two
    launches bit-identical."""
    binning, data, rays = option_inputs(dev, rowterm)
    args = (data, binning.tile_starts, binning.tile_ends, rays, 2, 1e-4,
            0.0113, 1.0 / 255.0, 0.99, False, True, emit_flags, passes,
            rowterm is not None)
    ko, kf = tile_raster._launch(*args)
    ko2, kf2 = tile_raster._launch(*args)
    po, pf = tile_raster.tile_composite_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(ko, ko2)
    torch.testing.assert_close(ko[:, 0:6], po[:, 0:6], atol=2e-4, rtol=1e-4)
    assert torch.equal(ko[:, 6:8], po[:, 6:8])
    if emit_flags:
        assert torch.equal(kf, kf2)
        assert torch.equal(kf > 0, pf > 0)
        torch.testing.assert_close(kf, pf, atol=2e-4, rtol=1e-4)
    if rowterm == "mid":
        walked = ko[:, 7, 0]
        span = (binning.tile_ends - binning.tile_starts).to(walked.dtype)
        assert bool((walked < span)[span > 2 * tile_raster.CHUNK].all())


@pytest.mark.parametrize("passes,rowterm,emit_flags", OPTION_CASES,
                         ids=OPTION_IDS)
def test_tile_raster_bwd_option_legs_match_plain(dev, passes, rowterm,
                                                 emit_flags):
    """B2's sorted and row-terminated legs against the plain version on the
    card (the default leg's tolerance, nonzero slots exact), two launches
    bit-identical."""
    del emit_flags
    binning, data, rays = option_inputs(dev, rowterm)
    fwd = (data, binning.tile_starts, binning.tile_ends, rays, 2, 1e-4,
           0.0113, 1.0 / 255.0, 0.99, False, True, False)
    legs = (passes, rowterm is not None)
    out, _ = tile_raster._launch(*fwd, *legs)
    g_out = torch.randn(out.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    args = fwd[:4] + (out, g_out) + fwd[4:10] + (True,) + legs
    got = tile_raster._launch_backward(*args)
    again = tile_raster._launch_backward(*args)
    want = tile_raster.tile_composite_backward_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got.abs().sum(1) > 0, want.abs().sum(1) > 0)
    scale = want.abs().amax(0) + 1e-30
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
    assert int((got.abs().sum(1) > 0).sum()) > 1000


def walked_steps(out, tile_starts, win_base, steps):
    """The steps [steps] bool of an order_buffer that B1's walk wrote: tile
    t's windows that its walked slots (out row 7) touch."""
    w = out[:, 7, 0].long().cpu()
    s = tile_starts.long().cpu()
    n = torch.where(w > 0, (s + w - 1) // tile_raster.CHUNK
                    - s // tile_raster.CHUNK + 1, torch.zeros_like(w))
    mask = torch.zeros(steps, dtype=torch.bool)
    for t, b in enumerate(win_base.tolist()):
        mask[b:b + int(n[t])] = True
    return mask


@pytest.mark.parametrize("rowterm", [None, "touch", "mid"])
def test_b1_live_rows_match_plain(dev, rowterm):
    """B1's default legs write each walked pixel-window's live-row mask
    bit-equal to the plain version's, and writing it leaves B1's output
    bitwise as it is."""
    binning, data, rays = option_inputs(dev, rowterm)
    fwd = (data, binning.tile_starts, binning.tile_ends, rays, 2, 1e-4,
           0.0113, 1.0 / 255.0, 0.99, False)
    legs = (0, rowterm is not None)
    mask = tile_raster.order_buffer(binning.tile_starts, binning.tile_ends,
                                    data.shape[0], tile_raster.walk_words(0))
    ko, _ = tile_raster._launch(*fwd, True, False, *legs, order=mask)
    assert torch.equal(ko, tile_raster._launch(*fwd, True, False, *legs)[0])
    words, base = tile_raster.live_rows_plain(*fwd, legs[1])
    assert torch.equal(mask[1], base)
    steps = walked_steps(ko, binning.tile_starts, base, words.shape[0])
    assert int(steps.sum()) > 10
    assert torch.equal(mask[0].cpu()[steps], words.cpu()[steps])
    # One bit per hit.
    po, _ = tile_raster.tile_composite_plain(*fwd, True, False, *legs)
    torch.testing.assert_close(ko[:, 0:6], po[:, 0:6], atol=2e-4, rtol=1e-4)
    assert torch.equal(ko[:, 6:8], po[:, 6:8])


@pytest.mark.parametrize("aux_grads", [True, False])
@pytest.mark.parametrize("rowterm", [None, "mid"])
def test_b2_on_the_live_rows_equals_b2_given_none(dev, rowterm, aux_grads):
    binning, data, rays = option_inputs(dev, rowterm)
    fwd = (data, binning.tile_starts, binning.tile_ends, rays, 2, 1e-4,
           0.0113, 1.0 / 255.0, 0.99, False)
    legs = (0, rowterm is not None)
    mask = tile_raster.order_buffer(binning.tile_starts, binning.tile_ends,
                                    data.shape[0], tile_raster.walk_words(0))
    out, _ = tile_raster._launch(*fwd, True, False, *legs, order=mask)
    g_out = torch.randn(out.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(2))
    args = fwd[:4] + (out, g_out) + fwd[4:] + (aux_grads,) + legs
    before = dict(cuda_build.launches)
    got = tile_raster._launch_backward(*args, order=mask)
    assert cuda_build.launches["tile_raster_fwd"] == before.get(
        "tile_raster_fwd", 0)
    want = tile_raster._launch_backward(*args)     # runs B1 for its mask
    assert cuda_build.launches["tile_raster_fwd"] == before.get(
        "tile_raster_fwd", 0) + 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int((got.abs().sum(1) > 0).sum()) > 1000


@pytest.mark.parametrize("rowterm", [None, "touch"])
def test_default_legs_with_per_pixel_origins_match_plain(dev, rowterm):
    """Rays of one origin per pixel (as a rolling shutter gives) take the
    per-pixel form of the pair in both kernels: the default legs'
    tolerances against the plain versions."""
    binning, data, rays = option_inputs(dev, rowterm)
    gen = torch.Generator(dev).manual_seed(4)
    rays[:, 0:3] += 1e-5 * torch.randn(rays[:, 0:3].shape, device=dev,
                                       generator=gen)
    assert bool((rays[:, 0, 1:] != rays[:, 0, :1]).any(1).all())
    fwd = (data, binning.tile_starts, binning.tile_ends, rays, 2, 1e-4,
           0.0113, 1.0 / 255.0, 0.99, False, True, False, 0,
           rowterm is not None)
    ko, _ = tile_raster._launch(*fwd)
    po, _ = tile_raster.tile_composite_plain(*fwd)
    torch.testing.assert_close(ko[:, 0:6], po[:, 0:6], atol=2e-4, rtol=1e-4)
    assert torch.equal(ko[:, 6:8], po[:, 6:8])
    g_out = torch.randn(ko.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    args = fwd[:4] + (ko, g_out) + fwd[4:10] + (True,) + fwd[12:]
    got = tile_raster._launch_backward(*args)
    want = tile_raster.tile_composite_backward_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.abs().sum(1) > 0, want.abs().sum(1) > 0)
    scale = want.abs().amax(0) + 1e-30
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
    assert int((got.abs().sum(1) > 0).sum()) > 1000


def network_windows(dev):
    """Constructed windows for the sorted legs' network: particles spread
    along z (hit_t is about a ray's distance to a particle's depth), tiles
    (start, end) = (37, 187) (pinned rows at both ends of window 0 and
    window 1), (187, 300) (starts inside window 1), (300, 300) (empty) and
    (384, 640) (two whole windows). Tile 0's particles are isotropic, in
    reverse depth order (every pass needed); tile 1's come in runs of
    three identical rows but for their colour (equal keys: ties); tile 3's
    are anisotropic, in a random order. Even pixels look along about +z
    from z = -10, odd pixels along about -z from z = +10: the one sees a
    tile's rows reversed, the other in order, so the lanes of a warp stop
    after different pass counts. Row termination, where asked, ends every
    pixel at its tile's midpoint slot."""
    rng = np.random.default_rng(7)
    cap, tiles_se = 768, [(37, 187), (187, 300), (300, 300), (384, 640)]
    z = np.zeros(cap, np.float32)
    z[37:187] = np.linspace(3.0, -3.0, 150)
    z[187:300] = np.repeat(np.linspace(-2.0, 2.0, 38), 3)[:113]
    z[384:640] = rng.uniform(-3.0, 3.0, 256)
    rows = np.zeros((cap, 16), np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(cap, 3, 3)))
    a = q / rng.uniform(0.4, 0.8, (cap, 1, 3))
    a[:384] = np.eye(3) / 0.6
    rows[:, 0:9] = a.reshape(cap, 9)
    rows[:, 9] = rng.uniform(-0.3, 0.3, cap)
    rows[:, 10] = rng.uniform(-0.3, 0.3, cap)
    rows[:, 11] = z
    rows[:, 12] = np.where(rng.random(cap) < 0.05, 0.3, 0.03)
    rows[187:300, 9:11] = np.repeat(rows[187:300:3, 9:11], 3, 0)[:113]
    rows[:, 13:16] = rng.random((cap, 3))
    rays = np.zeros((len(tiles_se), 8, 256), np.float32)
    pix = np.arange(256)
    flip = pix % 2 == 1
    d = np.stack([(pix % 16 - 7.5) * 0.01, (pix // 16 - 7.5) * 0.01,
                  np.where(flip, -1.0, 1.0)])
    rays[:, 0] = (pix % 16 - 7.5) * 0.04
    rays[:, 1] = (pix // 16 - 7.5) * 0.04
    rays[:, 2] = np.where(flip, 10.0, -10.0)
    rays[:, 3:6] = d / np.linalg.norm(d, axis=0)
    starts = torch.tensor([s for s, _ in tiles_se], dtype=torch.int32,
                          device=dev)
    ends = torch.tensor([e for _, e in tiles_se], dtype=torch.int32,
                        device=dev)
    mid = [float((s + e) // 2) if e > s else -1.0 for s, e in tiles_se]
    return (torch.tensor(rows, device=dev), starts, ends,
            torch.tensor(rays, device=dev), torch.tensor(mid, device=dev))


@pytest.mark.parametrize("passes", [1, 2, 16, 70])
@pytest.mark.parametrize("rowterm,emit_flags", [(False, False),
                                                (False, True), (True, False)],
                         ids=["plain", "flags", "rowterm-mid"])
def test_sorted_legs_on_constructed_windows(dev, passes, rowterm,
                                            emit_flags):
    """B1's and B2's sorted legs against the plain versions on
    network_windows (reverse order, ties, pinned rows at both ends, lanes
    stopping at different passes), 70 passes being more than the 64 rows a
    half-window holds: the default legs' tolerances, hit counts, walked
    slots and the nonzero slots exact, two launches bit-identical."""
    data, starts, ends, rays, mid = network_windows(dev)
    if rowterm:
        rays[:, 7] = mid[:, None]
    fwd = (data, starts, ends, rays, 2, 1e-4, 0.0113, 1.0 / 255.0, 0.99,
           False, True, emit_flags, passes, rowterm)
    ko, kf = tile_raster._launch(*fwd)
    ko2, kf2 = tile_raster._launch(*fwd)
    po, pf = tile_raster.tile_composite_plain(*fwd)
    assert torch.equal(ko, ko2)
    torch.testing.assert_close(ko[:, 0:6], po[:, 0:6], atol=2e-4, rtol=1e-4)
    assert torch.equal(ko[:, 6:8], po[:, 6:8])
    assert float(po[:, 6].sum()) > 0
    if emit_flags:
        assert torch.equal(kf, kf2)
        assert torch.equal(kf > 0, pf > 0)
        torch.testing.assert_close(kf, pf, atol=2e-4, rtol=1e-4)
    g_out = torch.randn(ko.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(1))
    b2 = fwd[:4] + (ko, g_out) + fwd[4:10] + (True, passes, rowterm)
    got = tile_raster._launch_backward(*b2)
    again = tile_raster._launch_backward(*b2)
    want = tile_raster.tile_composite_backward_plain(*b2)
    assert torch.equal(got, again)
    assert torch.equal(got.abs().sum(1) > 0, want.abs().sum(1) > 0)
    scale = want.abs().amax(0) + 1e-30
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
    assert int((want.abs().sum(1) > 0).sum()) > 100
    # As in a train step: B1 writes its compositing orders, B2 reads them.
    order = tile_raster.order_buffer(starts, ends, data.shape[0])
    assert torch.equal(tile_raster._launch(*fwd, order=order)[0], ko)
    assert torch.equal(tile_raster._launch_backward(*b2, order=order), got)


def test_wrappers_reject_bad_shapes(dev):
    proj, binning, data, _, rays = prepared(dev, n=2000, cap=1 << 14)
    args = list(b3_inputs(proj))
    args[3] = args[3][:, :2].contiguous()                # conic [N, 2]
    with pytest.raises(ValueError, match="conic"):
        expand.cull_masks(*args)
    with pytest.raises(ValueError, match="tile_ends"):
        tile_raster._launch(data, binning.tile_starts,
                            binning.tile_ends[:-1].contiguous(), rays, 2,
                            1e-4, 0.0113, 1.0 / 255.0, 0.99, False, True,
                            False)


@pytest.mark.parametrize("hit_visibility", [False, True])
def test_api_render_card_matches_cpu(dev, hit_visibility):
    res = (128, 96)
    frames = []
    for device in (dev, "cpu"):
        cuda_build.launches.clear()
        p, cam, pose = scene(5000, res, device)
        with torch.no_grad():
            out, ovf = api.render(p, cam, pose, res, isect_capacity=1 << 16,
                                  device=device,
                                  hit_visibility=hit_visibility)
        assert not bool(ovf)
        frames.append(out)
        if device == dev:
            assert set(cuda_build.launches) == {
                "cull_masks", "expand_keys", "tile_raster_fwd"}
    rep, ok = golden.compare(*frames)
    assert ok, rep


@pytest.mark.parametrize("aux_grads,degree", [(True, 2), (False, 2),
                                              (True, 3), (False, 4)])
def test_tile_raster_bwd_kernel_matches_plain(dev, aux_grads, degree):
    _, binning, data, _, rays = prepared(dev)
    fwd = (data, binning.tile_starts, binning.tile_ends, rays, degree, 1e-4,
           0.0113, 1.0 / 255.0, 0.99, False, True, False)
    out, _ = tile_raster._launch(*fwd)
    g_out = torch.randn(out.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    args = fwd[:4] + (out, g_out) + fwd[4:10] + (aux_grads,)
    before = cuda_build.launches["tile_raster_bwd"]
    got = tile_raster._launch_backward(*args)
    assert cuda_build.launches["tile_raster_bwd"] == before + 1
    want = tile_raster.tile_composite_backward_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.abs().sum(1) > 0, want.abs().sum(1) > 0)
    scale = want.abs().amax(0) + 1e-30
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
    assert int((got.abs().sum(1) > 0).sum()) > 1000


def test_segment_sum_kernels_match_plain(dev):
    gen = torch.Generator(dev).manual_seed(1)
    n, cap = 5000, 40_000
    counts = torch.randint(0, 12, (n,), device=dev, generator=gen)
    counts[7] = 3000                                   # one long segment
    ends = torch.cumsum(counts, 0).to(torch.int32)
    g = torch.randn((cap, 16), device=dev, generator=gen)
    for e in (ends, torch.clamp(ends + 20_000, max=2**30)):   # overflow
        got = segment_sum.segment_sum_rows(g, e)
        want = segment_sum.segment_sum_rows_plain(g, e)
        ec = torch.clamp(e, max=cap)
        lengths = torch.diff(ec, prepend=ec.new_zeros(1))
        bound = segment_sum.f32_sum_bound(
            segment_sum.segment_sum_rows_plain(g.abs(), e), lengths, want)
        assert bool(((got - want).abs() <= bound).all())
    ids = torch.sort(torch.randint(0, n + 50, (cap,), device=dev,
                                   generator=gen).to(torch.int32)).values
    got = segment_sum.segment_sum_rows_by_ids(g, ids, n)
    want = segment_sum.segment_sum_rows_by_ids_plain(g, ids, n)
    lengths = torch.bincount(ids.long(), minlength=n + 50)[:n]
    bound = segment_sum.f32_sum_bound(
        segment_sum.segment_sum_rows_by_ids_plain(g.abs(), ids, n), lengths,
        want)
    assert bool(((got - want).abs() <= bound).all())
    assert cuda_build.launches["segment_sum_rows"] >= 2
    assert cuda_build.launches["segment_sum_rows_by_ids"] >= 1


@pytest.mark.parametrize("walk_compact_fraction", [0.625, 0.0])
def test_train_step_card_matches_cpu(dev, walk_compact_fraction):
    """One train step on the card (kernels) and on the CPU (plain versions)
    from the same parameters: loss, gradients (atol 1e-4 x max, f32 sums in
    another order, on all but 0.1% of the particles: golden.rows_agree),
    and the particles with nonzero gradients."""
    from threedgrut_torch import optimizers, trainer
    from threedgrut_torch.config import Config
    cfg = Config()
    cfg.render.isect_capacity = 1 << 16
    cfg.render.low_precision_grads = False
    cfg.render.walk_compact_fraction = walk_compact_fraction
    res = (128, 96)
    gt = np.random.default_rng(0).uniform(0, 1, (96, 128, 3)).astype(
        np.float32)
    results = []
    for device in (dev, "cpu"):
        cuda_build.launches.clear()
        p, cam, pose = scene(5000, res, device)
        T = torch.tensor(look_at(np.array([0.3, -4.0, 1.0], np.float32),
                                 np.zeros(3, np.float32),
                                 np.array([0, 0, 1.0], np.float32)),
                         device=device)
        _, aux = trainer.step_fn(p, optimizers.init(p), T, cam,
                                 torch.tensor(gt, device=device),
                                 torch.ones((96, 128, 1), device=device),
                                 4.0, res, 3, cfg, train=True)
        results.append(aux)
        if device == dev:
            want = "segment_sum_rows" + (
                "_by_ids" if walk_compact_fraction else "")
            assert cuda_build.launches["tile_raster_bwd"] == 1
            assert cuda_build.launches[want] == 1
    card, cpu = results
    torch.testing.assert_close(card["terms"]["total"].cpu(),
                               cpu["terms"]["total"], rtol=1e-4, atol=0)
    for k, g in cpu["grads"].items():
        rep, ok = golden.rows_agree(card["grads"][k], g, 1e-4)
        assert ok, (k, rep)
    # CPU exp is Sleef's, the card's CUDA's: a hit at an acceptance
    # threshold may flip (golden.compare's 0.1% allowance).
    flips = int((card["visibility"].cpu() != cpu["visibility"]).sum())
    assert flips <= max(1, int(1e-3 * cpu["visibility"].numel()))


@pytest.mark.parametrize("sorted_passes", [0, 16])
def test_train_step_frees_b1_record_before_the_unsort(dev, monkeypatch,
                                                      sorted_passes):
    """A train step's B1 writes one walk record (the live-row mask without
    passes, a word per 32 rows; the compositing orders with them), its B2
    reads it, and the backward drops it before the unsort; a frame writes
    none."""
    import weakref
    from threedgrut_torch import optimizers, trainer
    from threedgrut_torch.config import Config
    from threedgrut_torch.ops import fused_raster
    made = []
    order_buffer = tile_raster.order_buffer

    def tracked(*args, **kw):
        buf = order_buffer(*args, **kw)
        made.append((weakref.ref(buf[0]), buf[0].shape[1]))
        return buf

    alive_at_unsort = []
    unsort = fused_raster.unsort_segment_sum

    def checked(*args, **kw):
        alive_at_unsort.append([ref() is not None for ref, _ in made])
        return unsort(*args, **kw)

    monkeypatch.setattr(tile_raster, "order_buffer", tracked)
    monkeypatch.setattr(fused_raster, "unsort_segment_sum", checked)
    res = (128, 96)
    p, cam, pose = scene(5000, res, dev)
    with torch.no_grad():
        api.render(p, cam, pose, res, isect_capacity=1 << 16, device=dev,
                   sorted_passes=sorted_passes)
    assert made == []
    cfg = Config()
    cfg.render.isect_capacity = 1 << 16
    cfg.render.k_buffer_passes = sorted_passes
    T = torch.tensor(look_at(np.array([0.3, -4.0, 1.0], np.float32),
                             np.zeros(3, np.float32),
                             np.array([0, 0, 1.0], np.float32)), device=dev)
    gt = torch.zeros((96, 128, 3), device=dev)
    cuda_build.launches.clear()
    trainer.step_fn(p, optimizers.init(p), T, cam, gt,
                    torch.ones((96, 128, 1), device=dev), 4.0, res, 3, cfg,
                    train=True)
    assert cuda_build.launches["tile_raster_fwd"] == 1
    assert cuda_build.launches["tile_raster_bwd"] == 1
    assert [w for _, w in made] == [tile_raster.walk_words(sorted_passes)]
    assert alive_at_unsort == [[False]]


def grt_scene(device, n=20_000, side=128):
    """bench_grt's seeded scene at n Gaussians as parameters, and its
    side x side ray grid from (0, 0, -4) in 16x16-tile order."""
    rng = np.random.default_rng(0)
    pos = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    s = np.exp(rng.uniform(np.log(0.01), np.log(0.05), (n, 3)))
    feats = np.zeros((n, 16, 3), np.float32)
    feats[:, 0] = rng.uniform(-1, 1, (n, 3))
    from threedgrut_torch.model.gaussians import from_arrays
    params = from_arrays(pos, q, np.log(s).astype(np.float32),
                         np.zeros((n, 1), np.float32), feats[:, 0],
                         feats[:, 1:].reshape(n, 45), device=device)
    px = (np.arange(side) + 0.5) / side * 0.8 - 0.4
    gx, gy = np.meshgrid(px, px, indexing="xy")
    d = np.stack([gx, gy, np.ones_like(gx)], -1).astype(np.float32)
    t = side // 16
    d = d.reshape(t, 16, t, 16, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.array([[0.0, 0.0, -4.0]], np.float32), (side * side, 1))
    return params, o, d


def grt_inputs(dev, passes):
    params, o, d = grt_scene(dev)
    acts = [x.detach() for x in (params.get_positions(),
                                 params.get_rotation(), params.get_scale(),
                                 params.get_density(), params.get_features())]
    o, d = torch.tensor(o, device=dev), torch.tensor(d, device=dev)
    with torch.no_grad():
        radius = grt.bounding_radius(acts[2], acts[3], 4)
        ci, cn, ovf, _ = grt.bundle_candidates_twolevel(
            acts[0], radius, acts[3] >= 1.0 / 255.0, o, d, 256, 2048,
            super_capacity=8192)
        assert not bool(ovf)
        fi, valid, ws, we, _, _ = grt.flatten_candidates(
            ci, cn, 128 * int((-(-cn // 128)).sum()))
        data = grt.pack_rows64(*acts)[fi.long()]
        data[:, 12] *= valid
    rays = torch.cat([o, d, torch.zeros_like(o[:, :2])], -1)
    rays[:, 7] = 1.0
    rays = rays.reshape(-1, 256, 8).transpose(1, 2).contiguous()
    return (data, rays, ws, we, 4, 3, 1e-3, 0.0113, 1.0 / 255.0, 0.99,
            passes)


def assert_b7_close(k, p):
    torch.testing.assert_close(k[:, 0:6], p[:, 0:6], atol=2e-4, rtol=1e-4)
    dh = (k[:, 6] - p[:, 6]).abs()
    assert float(dh.max()) <= 1
    assert int((dh > 0).sum()) <= max(1, int(1e-3 * dh.numel()))
    dw = int((k[:, 7, 0] != p[:, 7, 0]).sum())
    assert dw <= max(1, int(1e-3 * k.shape[0]))


@pytest.mark.parametrize("passes", [0, 16])
def test_bundle_trace_kernel_matches_plain(dev, passes):
    args = grt_inputs(dev, passes)
    before = cuda_build.launches["bundle_trace_fwd"]
    k = bundle_trace._launch(*args)
    assert cuda_build.launches["bundle_trace_fwd"] == before + 1
    p = bundle_trace.bundle_composite_plain(*args)
    torch.cuda.synchronize()
    assert_b7_close(k, p)
    assert float(k[:, 3].max()) > 0.5 and float(k[:, 7].min()) >= 1


def test_bundle_trace_kernel_edge_cases(dev):
    """A zero-window bundle writes its initial transmittance and zeros;
    inactive rays (zero direction) composite nothing; a bound t_max cuts."""
    data, rays, ws, we, *rest = grt_inputs(dev, 16)
    we = we.clone()
    we[3] = ws[3]
    rays = rays.clone()
    rays[5, 7] = 0.5
    rays[4, 3:6, :32] = 0.0
    rays[6, 6] = 4.5
    k = bundle_trace._launch(data, rays, ws, we, *rest)
    p = bundle_trace.bundle_composite_plain(data, rays, ws, we, *rest)
    torch.cuda.synchronize()
    assert_b7_close(k, p)
    assert float(k[3, [0, 1, 2, 3, 4, 6, 7]].abs().max()) == 0.0
    assert torch.equal(k[3, 5], rays[3, 7])
    assert float(k[4, 3, :32].abs().max()) == 0.0


def test_api_trace_card_matches_cpu(dev):
    frames = []
    for device in (dev, "cpu"):
        cuda_build.launches.clear()
        params, o, d = grt_scene(device)
        with torch.no_grad():
            out = api.trace(params, o, d, device=device,
                            candidate_capacity=2048, super_capacity=8192)
        assert not bool(out.overflow)
        frames.append(out)
        if device == dev:
            assert dict(cuda_build.launches) == {"bundle_trace_fwd": 1}
    rep, ok = golden.compare(*frames)
    assert ok, rep


def test_api_render_3dgrt_card_matches_cpu(dev):
    res = (128, 96)
    frames = []
    for device in (dev, "cpu"):
        p, cam, pose = scene(5000, res, device)
        with torch.no_grad():
            out, ovf = api.render(p, cam, pose, res, method="3dgrt",
                                  isect_capacity=1 << 18, device=device)
        assert not bool(ovf)
        frames.append(out)
    rep, ok = golden.compare(*frames)
    assert ok, rep


def test_grt_golden_trace_on_the_card(dev):
    params = from_numpy(golden.scene(), device=dev)
    o, d = golden.grt_rays()
    with torch.no_grad():
        out = api.trace(params, o, d, device=dev, **golden.GRT_TRACE_KW)
    assert not bool(out.overflow)
    rep, ok = golden.compare(out, golden.load_grt())
    assert ok, rep



def b8_inputs(dev, passes):
    """B8's inputs at grt_inputs' shapes: the card's forward output and a
    seeded cotangent (rows 6-7 get none)."""
    args = grt_inputs(dev, passes)
    out = bundle_trace._launch(*args)
    gen = torch.Generator(dev).manual_seed(passes)
    g = torch.randn(out.shape, device=dev, generator=gen)
    g[:, 6:] = 0.0
    return args[:4] + (out, g) + args[4:]


def assert_b8_close(k, p):
    nz_k, nz_p = (k != 0).any(1), (p != 0).any(1)
    assert torch.equal(nz_k, nz_p)
    col = p.abs().amax(0)
    assert bool(((k - p).abs() <= 1e-4 * col + 1e-30).all())
    assert int(nz_k.sum()) > 1000 and not k[:, 13:16].any()


@pytest.mark.parametrize("passes", [0, 16])
def test_bundle_trace_bwd_kernel_matches_plain(dev, passes):
    args = b8_inputs(dev, passes)
    before = cuda_build.launches["bundle_trace_bwd"]
    k = bundle_trace._launch_backward(*args)
    assert cuda_build.launches["bundle_trace_bwd"] == before + 1
    p = bundle_trace.bundle_composite_backward_plain(*args)
    torch.cuda.synchronize()
    assert_b8_close(k, p)
    assert torch.equal(bundle_trace._launch_backward(*args), k)
    # Windows no walk reached are exact zeros.
    data, _, ws, we, out = args[:5]
    walked = torch.zeros(data.shape[0] // 128, dtype=torch.bool, device=dev)
    for b in range(ws.shape[0]):
        lo = int(ws[b])
        walked[lo:lo + int(out[b, 7, 0])] = True
    assert not k.view(-1, 128, 64)[~walked].any()


def edge_case(args):
    """grt_inputs' args with the edge cases of
    test_bundle_trace_kernel_edge_cases: an empty bundle, an initial
    transmittance < 1, inactive rays and a bound t_max."""
    data, rays, ws, we, *rest = args
    we = we.clone()
    we[3] = ws[3]
    rays = rays.clone()
    rays[5, 7] = 0.5
    rays[4, 3:6, :32] = 0.0
    rays[6, 6] = 4.5
    return (data, rays, ws, we, *rest)


@pytest.mark.parametrize("passes", [1, 16, 70])
def test_bundle_trace_orders_leave_the_output_bitwise(dev, passes):
    """B7 writing its compositing orders gives bit for bit the output of B7
    writing none; each live ray-window's order is a permutation of the
    window's rows."""
    args = grt_inputs(dev, passes)
    order = bundle_trace.order_buffer(args[0])
    order.fill_(-1)
    k = bundle_trace._launch(*args, order=order)
    assert torch.equal(k, bundle_trace._launch(*args))
    ws = args[2].long()
    rows = bundle_trace.order_bytes(order[ws]) & (bundle_trace.HIT - 1)
    assert torch.equal(rows.sort(1).values,
                       torch.arange(128, device=dev)[None, :, None].expand(
                           rows.shape))


@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("passes", [0, 1, 2, 16, 70])
def test_bundle_trace_bwd_rewalks_b7_orders(dev, passes, edges):
    """B8 on the orders its B7 wrote equals B8 whose wrapper runs B7 first
    (bit for bit) and its plain version (assert_b8_close), at 0-70 passes
    and on the edge cases."""
    args = grt_inputs(dev, passes)
    if edges:
        args = edge_case(args)
    order = bundle_trace.order_buffer(args[0]) if passes else None
    out = bundle_trace._launch(*args, order=order)
    gen = torch.Generator(dev).manual_seed(passes)
    g = torch.randn(out.shape, device=dev, generator=gen)
    g[:, 6:] = 0.0
    bargs = args[:4] + (out, g) + args[4:]
    before = dict(cuda_build.launches)
    k = bundle_trace._launch_backward(*bargs, order=order)
    k2 = bundle_trace._launch_backward(*bargs)
    torch.cuda.synchronize()
    assert cuda_build.launches["bundle_trace_bwd"] == before.get(
        "bundle_trace_bwd", 0) + 2
    assert cuda_build.launches["bundle_trace_fwd"] == before.get(
        "bundle_trace_fwd", 0) + (1 if passes else 0)
    assert torch.equal(k, k2)
    assert_b8_close(k, bundle_trace.bundle_composite_backward_plain(*bargs))


def test_bundle_trace_wrappers_reject_bad_orders(dev):
    args = grt_inputs(dev, 16)
    good = bundle_trace.order_buffer(args[0])
    bad = [good[1:], good.float(), good.to(torch.int64),
           good.reshape(-1, 64, 128), good.cpu()]
    for b in bad:
        with pytest.raises((ValueError, TypeError)):
            bundle_trace._launch(*args, order=b)
    with pytest.raises(ValueError):
        bundle_trace._launch(*args[:-1], 0, order=good)
    out = bundle_trace._launch(*args, order=good)
    bargs = args[:4] + (out, torch.zeros_like(out)) + args[4:]
    for b in bad:
        with pytest.raises((ValueError, TypeError)):
            bundle_trace._launch_backward(*bargs, order=b)


def test_trace_writes_orders_only_for_a_backward(dev, monkeypatch):
    """A no-grad trace (of parameters that require a gradient, as in a
    trainer's evaluation) allocates no order buffer; a differentiable one
    (the fused route and bundle_composite's) allocates one, which its
    backward re-walks without running B7 again."""
    made = []
    real = bundle_trace.order_buffer
    monkeypatch.setattr(bundle_trace, "order_buffer",
                        lambda data: made.append(1) or real(data))
    params, o, d = grt_scene(dev)
    o, d = torch.tensor(o, device=dev), torch.tensor(d, device=dev)
    acts = [x.detach() for x in (params.get_positions(),
                                 params.get_rotation(), params.get_scale(),
                                 params.get_density(), params.get_features())]
    kw = dict(candidate_capacity=2048, super_capacity=8192)
    for walk in (256, None):
        xs = [a.clone().requires_grad_(True) for a in acts]
        with torch.no_grad():
            out = grt.trace(*xs, o, d, walk_capacity=walk, **kw)
        assert not made and not bool(out.overflow)
    for walk in (256, None):
        made.clear()
        xs = [a.clone().requires_grad_(True) for a in acts]
        cuda_build.launches.clear()
        out = grt.trace(*xs, o, d, walk_capacity=walk, **kw)
        out.rgb.sum().backward()
        assert made == [1]
        assert cuda_build.launches["bundle_trace_fwd"] == 1
        assert cuda_build.launches["bundle_trace_bwd"] == 1


def test_segment_sum_by_ids_64_channels_matches_plain(dev):
    gen = torch.Generator(dev).manual_seed(2)
    n, m = 5000, 60_000
    ids = torch.sort(torch.randint(0, n + 50, (m,), device=dev,
                                   generator=gen).to(torch.int32)).values
    ids[1000:4000] = int(ids[1000])                     # one long segment
    ids = torch.sort(ids).values
    g = torch.randn((m, 64), device=dev, generator=gen)
    before = cuda_build.launches["segment_sum_rows_by_ids"]
    got = segment_sum.segment_sum_rows_by_ids(g, ids, n)
    assert cuda_build.launches["segment_sum_rows_by_ids"] == before + 1
    want = segment_sum.segment_sum_rows_by_ids_plain(g, ids, n)
    lengths = torch.bincount(ids.long(), minlength=n + 50)[:n]
    bound = segment_sum.f32_sum_bound(
        segment_sum.segment_sum_rows_by_ids_plain(g.abs(), ids, n), lengths,
        want)
    assert got.shape == (n, 64)
    assert bool(((got - want).abs() <= bound).all())
    with pytest.raises(ValueError, match="F in"):
        segment_sum.segment_sum_rows_by_ids(g[:, :24].contiguous(), ids, n)


def sequential_sums(g, ids, n):
    """[n, F] f32 sums of each particle's rows in row order, from 0, on the
    host: np.cumsum in float32 adds one row after the other."""
    g, ids = g.cpu().numpy(), ids.cpu().numpy()
    out = np.zeros((n, g.shape[1]), np.float32)
    lo = np.searchsorted(ids, np.arange(n + 1), side="left")
    for p in np.nonzero(lo[1:] > lo[:-1])[0]:
        rows = np.concatenate([np.zeros((1, g.shape[1]), np.float32),
                               g[lo[p]:lo[p + 1]]])
        out[p] = np.cumsum(rows, axis=0, dtype=np.float32)[-1]
    return out


def b6_ids(case, n, rng):
    """Sorted int32 ids of one B6 case (the test's docstring)."""
    if case == "gaps":            # absent particles, fillers n and n + 3
        ids = np.r_[rng.choice(n, n // 3, replace=False).repeat(
            rng.integers(1, 9, n // 3)), np.full(300, n), np.full(40, n + 3)]
    elif case == "one_particle":
        ids = np.full(3000, 17)
    elif case == "long":          # a 5,000-row segment among short ones
        ids = np.r_[rng.integers(0, n, 4000), np.full(5000, n // 2)]
    else:                         # no rows
        ids = np.zeros(0)
    return np.sort(ids).astype(np.int32)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("nch", [16, 64])
@pytest.mark.parametrize("case", ["gaps", "one_particle", "long", "empty"])
def test_segment_sum_by_ids_is_the_sequential_f32_sum(dev, case, nch,
                                                      offset):
    """B6 at both widths equals, bit for bit, each particle's rows added in
    row order in float32 on the host (ids with gaps, ids >= n, one particle
    holding every row, a 5,000-row segment, no rows at all), on two
    launches; with `offset` 1 the rows are a contiguous view one float into
    its storage, off the 16-byte boundary the vector loads need (the walk
    at one channel a thread)."""
    rng = np.random.default_rng(nch + len(case))
    n = 2000
    ids = torch.tensor(b6_ids(case, n, rng), device=dev)
    m = ids.shape[0]
    buf = torch.empty(offset + m * nch, dtype=torch.float32, device=dev)
    g = buf[offset:].view(m, nch)
    g.copy_(torch.tensor(rng.normal(size=(m, nch)).astype(np.float32)))
    assert g.is_contiguous()
    if m:                         # (an empty tensor's data_ptr is 0)
        assert (g.data_ptr() % 16 != 0) == (offset == 1)
    before = cuda_build.launches["segment_sum_rows_by_ids"]
    got = segment_sum.segment_sum_rows_by_ids(g, ids, n)
    again = segment_sum.segment_sum_rows_by_ids(g, ids, n)
    assert cuda_build.launches["segment_sum_rows_by_ids"] == before + 2
    want = sequential_sums(g, ids, n)
    torch.cuda.synchronize()
    assert got.shape == (n, nch)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                  want.view(np.int32))
    assert torch.equal(got, again)


def b9_edge_case(dev, seed):
    """B9 inputs with every edge the passes meet: 12 windows, segments
    [0, 0) (empty), [1, 2) (one window), [2, 5) (window 3 all hits),
    [6, 9) (stream 5 without a hit) and [9, 9); windows 0, 5, 9, 10 and 11
    lie in no segment. Bases from each stream's CHUNK-padded count; every
    third stream's limit one window short (its last kept hit lies inside
    an input window), and a flat capacity two windows below the total (a
    cap_w below the last streams' limits and bases)."""
    rng = np.random.default_rng(seed)
    nws = 12
    ws = np.array([0, 1, 2, 6, 9], np.int32)
    we = np.array([0, 2, 5, 9, 9], np.int32)
    bits = np.zeros(nws * 128, np.int64)
    for s in range(16):
        bits |= (rng.random(nws * 128) < 0.6).astype(np.int64) << s
    bits[3 * 128:4 * 128] = 0xFFFF
    bits[6 * 128:9 * 128] &= ~(1 << 5)
    counts = np.array([[((bits[a * 128:b * 128] >> s) & 1).sum()
                        for s in range(16)] for a, b in zip(ws, we)])
    pad_w = -(-counts.reshape(-1) // 128)
    base = (np.cumsum(pad_w) - pad_w).astype(np.int32)
    lim = base + pad_w
    lim[::3] = base[::3] + np.maximum(pad_w[::3] - 1, 0)
    cap = (int(pad_w.sum()) - 2) * 128
    t = lambda x: torch.tensor(x, device=dev)
    return (t(rng.integers(0, 1 << 24, nws * 128).astype(np.int32)),
            t(bits.astype(np.int32)),
            t(rng.uniform(1, 9, (nws, 16, 128)).astype(np.float32)), t(ws),
            t(we), t(base), t(lim.astype(np.int32)), cap)


@pytest.mark.parametrize("seed", [3, 4])
def test_compact_streams_kernel_edge_cases(dev, seed):
    """B9 equals its plain version and the plain three-pass mirror bit for
    bit on b9_edge_case, and two launches are bit-identical."""
    args = b9_edge_case(dev, seed)
    before = cuda_build.launches["compact_streams"]
    k = stream_compact.compact_streams(*args)
    k2 = stream_compact.compact_streams(*args)
    assert cuda_build.launches["compact_streams"] == before + 2
    p = stream_compact.compact_streams_plain(*args)
    # (imported here: that module imports this one's cases)
    from tests.test_torch_compaction_passes import compact_streams_passes
    m = [x.to(dev) for x in compact_streams_passes(
        *[x.cpu() if torch.is_tensor(x) else x for x in args])]
    torch.cuda.synchronize()
    for a, b, c, d in zip(k, k2, p, m):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
    written = int((k[1] < stream_compact.FILL_DEPTH).sum())
    assert 0 < written < args[-1]


def test_blocks_per_sm_come_from_the_runtime(dev):
    """B3's, B4's, B5's, B6's and B9's occupancy queries name every kernel
    of their sources, each with its block size and 1 to 32 blocks an SM
    holds."""
    for mod, n in ((segment_sum, 5), (stream_compact, 3), (expand, 3)):
        occ = mod.blocks_per_sm()
        assert len(occ) == n
        for threads, blocks in occ.values():
            assert threads in (256, 512) and 1 <= blocks <= 32


@pytest.mark.parametrize("walk_compact_fraction", [0.625, 0.0])
def test_3dgrt_train_step_card_matches_cpu(dev, walk_compact_fraction):
    """One preset_3dgrt train step on the card (B7, B8, B6 at 64 channels)
    and on the CPU from the same parameters; the card's gradients are
    bit-identical across two runs."""
    from threedgrut_torch import optimizers, trainer
    from threedgrut_torch.config import preset_3dgrt
    cfg = preset_3dgrt()
    cfg.render.isect_capacity = 1 << 18
    cfg.render.walk_compact_fraction = walk_compact_fraction
    res = (128, 96)
    gt = np.random.default_rng(0).uniform(0, 1, (96, 128, 3)).astype(
        np.float32)
    results = []
    for device in (dev, dev, "cpu"):
        cuda_build.launches.clear()
        p, cam, pose = scene(5000, res, device)
        T = torch.tensor(look_at(np.array([0.3, -4.0, 1.0], np.float32),
                                 np.zeros(3, np.float32),
                                 np.array([0, 0, 1.0], np.float32)),
                         device=device)
        _, aux = trainer.step_fn(p, optimizers.init(p), T, cam,
                                 torch.tensor(gt, device=device),
                                 torch.ones((96, 128, 1), device=device),
                                 4.0, res, 3, cfg, train=True)
        assert not bool(aux["overflow"])
        results.append(aux)
        if device == dev:
            assert dict(cuda_build.launches) == {
                "bundle_trace_fwd": 1, "bundle_trace_bwd": 1,
                "segment_sum_rows_by_ids": 1}
    card, again, cpu = results
    for k, g in card["grads"].items():
        assert torch.equal(g, again["grads"][k]), k
    torch.testing.assert_close(card["terms"]["total"].cpu(),
                               cpu["terms"]["total"], rtol=1e-4, atol=0)
    for k, g in cpu["grads"].items():
        rep, ok = golden.rows_agree(card["grads"][k], g, 1e-4)
        assert ok, (k, rep)
    flips = int((card["visibility"].cpu() != cpu["visibility"]).sum())
    assert flips <= max(1, int(1e-3 * cpu["visibility"].numel()))


def b9_case(dev, seed, truncate):
    """B9 inputs on `dev`: 24 segments of 0-12 windows (dense, sparse and
    empty ones), bases from each stream's CHUNK-padded count; `truncate`:
    limits one window short of the padded counts on every other stream and
    a flat capacity 3 windows below the total, so the last streams' bases
    lie past it."""
    rng = np.random.default_rng(seed)
    wins = rng.integers(0, 13, 24)
    wins[3] = 0
    nws = int(wins.sum())
    dens = np.repeat(rng.choice([0.9, 0.3, 0.02], 24), wins * 128)
    bits = np.zeros(nws * 128, np.int64)
    for s in range(16):
        bits |= (rng.random(nws * 128) < dens).astype(np.int64) << s
    ws = (np.cumsum(wins) - wins).astype(np.int32)
    we = np.cumsum(wins).astype(np.int32)
    counts = np.array([[((bits[a * 128:b * 128] >> s) & 1).sum()
                        for s in range(16)] for a, b in zip(ws, we)])
    pad_w = -(-counts.reshape(-1) // 128)
    base = (np.cumsum(pad_w) - pad_w).astype(np.int32)
    lim = base + pad_w
    cap = (int(pad_w.sum()) + 1) * 128
    if truncate:
        lim[::2] = base[::2] + np.maximum(pad_w[::2] - 1, 0)
        cap = (int(pad_w.sum()) - 3) * 128
    t = lambda x: torch.tensor(x, device=dev)
    return (t(rng.integers(0, 1 << 24, nws * 128).astype(np.int32)),
            t(bits.astype(np.int32)),
            t(rng.uniform(1, 9, (nws, 16, 128)).astype(np.float32)), t(ws),
            t(we), t(base), t(lim.astype(np.int32)), cap)


@pytest.mark.parametrize("truncate", [False, True])
def test_compact_streams_kernel_matches_plain(dev, truncate):
    """B9 equals its plain version exactly, two launches are bit-identical,
    and each launch is counted."""
    args = b9_case(dev, 7 + truncate, truncate)
    before = cuda_build.launches["compact_streams"]
    k = stream_compact.compact_streams(*args)
    k2 = stream_compact.compact_streams(*args)
    assert cuda_build.launches["compact_streams"] == before + 2
    p = stream_compact.compact_streams_plain(*args)
    torch.cuda.synchronize()
    for a, b, c in zip(k, k2, p):
        assert torch.equal(a, b) and torch.equal(a, c)
    written = int((k[1] < stream_compact.FILL_DEPTH).sum())
    assert 0 < written < args[-1]


def test_flat_cull_legs_card_match_cpu(dev):
    """The flat cull's three legs on the card against the same legs on the
    CPU (grt_scene at 20k Gaussians, 64 bundles): per-bundle lists within
    golden.lists_agree at TRACE_FLIP_SHARE (a cone-margin particle may
    enter a list on one device only; the flips are shown); on the card the
    B9 leg equals the member-sort leg exactly and launches B9 once."""
    legs = {"expand_sort": {}, "member_sort": dict(expand_sort=False),
            "compact_kernel": dict(compact_kernel=True)}
    lists = {}
    for device in (dev, "cpu"):
        params, o, d = grt_scene(device)
        acts = [x.detach() for x in (params.get_positions(),
                                     params.get_scale(),
                                     params.get_density())]
        o = torch.tensor(o, device=device)
        d = torch.tensor(d, device=device)
        with torch.no_grad():
            radius = grt.bounding_radius(acts[1], acts[2], 4)
            for leg, kw in legs.items():
                cuda_build.launches.clear()
                out = grt.bundle_candidates_twolevel_flat(
                    acts[0], radius, acts[2] >= 1.0 / 255.0, o, d, 256, 2048,
                    super_capacity=8192, super_flat_capacity=1 << 15,
                    flat_capacity=1 << 17, **kw)
                assert not bool(out[4])
                if device == dev:
                    assert dict(cuda_build.launches) == (
                        {"compact_streams": 1} if kw.get("compact_kernel")
                        else {})
                lists[(device, leg)] = golden.bundle_lists(*out[:4])
    rep, ok = golden.lists_agree(lists[(dev, "compact_kernel")],
                                 lists[(dev, "member_sort")])
    assert ok, rep
    for leg in legs:
        rep, ok = golden.lists_agree(lists[(dev, leg)], lists[("cpu", leg)],
                                     golden.TRACE_FLIP_SHARE)
        print(f"flat cull {leg} card vs CPU: {rep}")
        assert ok, (leg, rep)


@pytest.mark.parametrize("seed", [0, 1])
def test_strategy_ops_card_match_cpu(dev, seed):
    """Every densification operation (densify, prune, relocate,
    add_gaussians, perturb, reset_density, accumulate) on the card against
    the CPU from the same state and draws: chip_smoke phase 6b (d) at 20k
    particles in 24,576 slots. Masks, taken slots, sources, counts and
    grad_denom exact; floats within chip_smoke's STRATEGY_ATOL +
    STRATEGY_RTOL |cpu|."""
    import chip_smoke
    pc, _, _ = chip_smoke.grt_bench_scene(20_000, (0.01, 0.05), "cpu",
                                          side=16, capacity=24_576)
    chip_smoke.kill_share(pc, 20_000, seed)
    rep = chip_smoke.strategy_card_vs_cpu(pc, dev, seed)
    for op, r in rep.items():
        assert r["exact"] and r["within"], (op, r)
    assert rep["densify"]["counts"]["take"] > 0
    assert rep["densify"]["counts"]["clone"] > 0
    assert rep["densify"]["counts"]["split"] > 0
    assert rep["relocate"]["counts"]["n"] >= 1000   # clones of the dead too
    assert rep["add_gaussians"]["counts"]["n"] > 0


@pytest.mark.parametrize("method", ["gs", "mcmc"])
def test_trainer_densifies_on_the_card(dev, method):
    """A Trainer with GSStrategy or MCMCStrategy on the card at 20k
    particles in 24,576 slots, 5% dead: 6 steps on chip_smoke's compressed
    schedule (events at steps 2, 4 and 6; GS with the gradient threshold at
    the 1000th largest average after step 1 and chip_smoke's scale
    threshold). Every step launches B1 and B2 once, every value stays
    finite, and the scene densifies: GS clones, splits, prunes the dead
    share and grows; MCMC relocates the dead share and grows by 5%."""
    import chip_smoke
    from threedgrut_torch.config import Config
    from threedgrut_torch.datasets.protocols import View
    from threedgrut_torch.model.gaussians import FIELDS, padded_fields
    from threedgrut_torch.strategy import gs
    from threedgrut_torch.train import make_strategy
    from threedgrut_torch.trainer import Trainer
    n, cap, res = 20_000, 24_576, (256, 192)
    f = bench_scene(n, seed=2)
    fields = padded_fields(*(f[k][:n] for k in FIELDS[:-1]), capacity=cap)
    cfg = chip_smoke.densify_config(Config(), method)
    cfg.render.isect_capacity = 1 << 18
    cfg.model.progressive_sh_interval = 0
    cfg.strategy.densify_scale_threshold = chip_smoke.DENSIFY_GS_SCALE
    T = look_at(np.array([0.3, -4.0, 1.0], np.float32),
                np.zeros(3, np.float32), np.array([0, 0, 1.0], np.float32))
    view = View(T_to_world=T, camera=example_camera(res, dev),
                resolution=res, rgb_gt=np.zeros((res[1], res[0], 3),
                                                np.float32))
    tr = Trainer(cfg, chip_smoke.OneView(view, 4.0),
                 params=from_numpy(fields, device=dev), device=dev)
    dead = chip_smoke.kill_share(tr.params, n)
    tr.strategy = make_strategy(tr.cfg, cap, dev)

    def set_threshold(k, tr):
        if k == 0 and method == "gs":
            avg = gs.grad_average(tr.strategy.state)[tr.params.alive]
            tr.strategy.cfg.densify_grad_threshold = float(
                torch.topk(avg, 1000).values[-1])

    rows, launches, _ = chip_smoke.densified_run(
        tr, view, f"densify {method}",
        lambda s: (s.get("tile_raster_fwd") == 1
                   and s.get("tile_raster_bwd") == 1), "[test]",
        set_threshold)
    alive = [r["alive"] for r in rows]
    if method == "gs":
        assert rows[1]["prune"] >= dead and rows[1]["clone"] > 0
        assert rows[1]["split"] > 0 and alive[-1] > n
    else:
        assert rows[1]["relocate"] == dead
        assert alive[1] == int(1.05 * n) and alive[-1] > alive[1]


@pytest.mark.parametrize("seed", [2, 7])
def test_inference_card_matches_cpu(dev, seed):
    """chip_smoke phase 5b (c) at 20,000 particles, 256x192: infer.refresh
    on the card against the CPU (compacted id sets equal up to census flips
    on 0.1% of the visible count), capture_binning of one compacted scene
    exactly equal on both, render_compact and render_frozen (B1's sorted
    leg on a binning captured two orbit frames earlier) within
    golden.compare; the frozen frame's visibility is None."""
    import chip_smoke
    fields = bench_scene(20_000, seed=seed, specular_std=0.1)
    fields["scale"] = fields["scale"] + np.float32(np.log(4.0))
    rep, ok = chip_smoke.infer_card_vs_cpu(
        fields, (256, 192), 1 << 18, dev, chip_smoke.orbit_deg_T(0),
        chip_smoke.orbit_deg_T(chip_smoke.INFER_STALE_FRAME))
    assert ok, rep
    assert rep["visible"] > 1000 and not rep["capture_unequal_fields"]


def test_export_round_trip_on_the_card(dev, tmp_path):
    """A scene on the card written as .ply and .ingp and read back through
    api.load_scene onto the card: the alive rows and mask bit-equal, and
    the frame bit for bit (the kernels are deterministic; dead slots carry
    opacity 0 whatever their other values)."""
    from threedgrut_torch.export import alive_rows
    from threedgrut_torch.export.ingp import export_ingp
    from threedgrut_torch.export.ply import export_ply
    p, cam, pose = scene(20_000, (256, 192), dev)
    with torch.no_grad():
        want, _ = api.render(p, cam, pose, (256, 192),
                             isect_capacity=1 << 18, device=dev)
    for name, write in (("s.ply", export_ply), ("s.ingp", export_ingp)):
        write(p, str(tmp_path / name))
        back = api.load_scene(str(tmp_path / name), device=dev)
        assert back.positions.device.type == "cuda"
        assert torch.equal(back.alive, p.alive)
        want_rows, got_rows = alive_rows(p), alive_rows(back)
        for f, x in want_rows.items():
            assert np.array_equal(got_rows[f], x), (name, f)
        with torch.no_grad():
            got, _ = api.render(back, cam, pose, (256, 192),
                                isect_capacity=1 << 18, device=dev)
        for f in golden.OUTPUTS:
            assert torch.equal(getattr(got, f), getattr(want, f)), (name, f)


def test_mesh_intersect_kernel_matches_plain(dev, tmp_path):
    """M1 against its plain version on the card, bit for bit (the same f32
    expressions, each rounded: --fmad=false; the cull drops only faces no
    ray of a block can hit): phase 5c's meshes (mirror floor, glass
    icosphere of 1,280 faces, the .glb card) under a 256x192 grid of the
    full-width camera and 4,096 random rays; the bounce-2 and bounce-3 rays
    of a trace frame of that scene at 20,000 particles over the whole view
    at 256x256 (reflections off the floor, rays inside and leaving the
    ball; the trace keeps a stopped ray's direction) and the hybrid's
    secondary rays there (zero directions where a ray stops); an
    all-inactive block and a partial last block; rays through the shared
    diagonal of a quad with integer corners and a duplicated face (exact
    ties: the lowest face wins), also with the duplicates tiles apart in a
    mesh of 20,488 faces (an icosphere of subdivision 5 between them: the
    kernel's loop over shared-memory tiles); a mesh of no face. The cull's
    masks (the diagnostic entry) equal block_face_masks_plain's exactly,
    each launch counted."""
    import chip_smoke
    from threedgrut_torch.ops import mesh_intersect as mi
    from threedgrut_torch.playground import engine as eng_mod
    from threedgrut_torch.playground import mesh as mesh_mod
    chip_smoke.write_glb(tmp_path / "card.glb")
    sg = chip_smoke.playground_scene(dev, tmp_path / "card.glb")
    mesh = sg.mesh()
    tri = mi.triangles(mesh.vertices, mesh.faces)
    f = 0.9 * 800
    cam = example_camera((256, 192), dev)._replace(
        focal=torch.tensor([f, f], device=dev))
    T = torch.as_tensor(chip_smoke.orbit_T(0), device=dev)
    o, d = chip_smoke.pg_primary_rays(cam, T, (256, 192))
    p = from_numpy(bench_scene(20_000, seed=2, specular_std=0.1), device=dev)
    eng = eng_mod.Engine(
        p.get_positions(), p.get_rotation(), p.get_scale(), p.get_density(),
        p.get_features(), mesh=mesh, materials=sg.materials(),
        envmap=chip_smoke.sky_envmap(),
        config=eng_mod.EngineConfig(max_bounces=3,
                                    candidate_capacity=1 << 14),
        device=dev)
    # The trace frame sees the whole of the full-width view at 256x256.
    wide = example_camera((256, 256), dev)._replace(
        focal=torch.tensor([0.9 * 256] * 2, device=dev))
    with torch.no_grad(), chip_smoke.mesh_rays_recorded(3) as rec:
        eng.render(wide, T, (256, 256))
    (o2, d2), (o3, d3) = rec.calls[1], rec.calls[2]
    with torch.no_grad(), chip_smoke.mesh_rays_recorded(4) as rec:
        eng.render_hybrid(wide, T, (256, 256))
    os_, ds = rec.calls[1]          # the secondary rays, 0 where none
    live = int((ds != 0).any(-1).sum())
    assert 1000 < live < ds.shape[0], live
    rng = np.random.default_rng(0)
    ro = torch.tensor(rng.normal(0, 2, (4096, 3)), dtype=torch.float32,
                      device=dev)
    rd = torch.nn.functional.normalize(torch.tensor(
        rng.normal(size=(4096, 3)), dtype=torch.float32, device=dev), dim=-1)
    po, pd = o[:1000].contiguous(), d[:1000].clone()
    pd[256:512] = 0.0                       # block 1 all inactive
    v = torch.tensor([[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]],
                     dtype=torch.float32, device=dev)
    faces = torch.tensor([[0, 1, 2], [0, 2, 3], [3, 2, 0], [0, 1, 2]],
                         dtype=torch.int32, device=dev)
    quad = mi.triangles(v, faces)
    ball = mesh_mod.make_icosphere([0.0, 0.0, 6.0], 1.0, subdivisions=5,
                                   device=dev)
    big = torch.cat([quad, mi.triangles(ball.vertices, ball.faces),
                     quad]).contiguous()
    assert big.shape[0] == 20_488
    xs = torch.tensor([-0.5, -0.25, 0.0, 0.25, 0.5, 0.75], device=dev)
    to = torch.stack([xs, xs, torch.zeros_like(xs)], -1)
    td = torch.tensor([[0.0, 0.0, 1.0]], device=dev).expand(6, 3)
    cases = [(o, d, tri), (ro, rd, tri), (o2, d2, tri), (o3, d3, tri),
             (os_, ds, tri), (po, pd, tri), (to, td.contiguous(), quad),
             (to, td.contiguous(), big), (o, d, big), (ro, rd, big),
             (ro, rd, tri[:0].contiguous())]
    n0 = cuda_build.launches["mesh_intersect"]
    m0 = cuda_build.launches["mesh_intersect_masks"]
    for i, (a, b, t) in enumerate(cases):
        got = mi.closest_hits(a, b, t)
        want = mi.closest_hits_plain(a, b, t)
        for x, y in zip(got, want):
            assert torch.equal(x, y), i
        masks = mi.block_face_masks(a, b, t)
        assert masks.dtype == torch.bool
        assert torch.equal(masks, mi.block_face_masks_plain(a, b, t)), i
    assert cuda_build.launches["mesh_intersect"] == n0 + len(cases)
    assert cuda_build.launches["mesh_intersect_masks"] == m0 + len(cases)
    assert torch.isfinite(got[0]).sum() == 0
    assert torch.isfinite(mi.closest_hits(o, d, tri)[0]).sum() > 1000
    assert torch.isfinite(mi.closest_hits(os_, ds, tri)[0]).sum() > 100
    for t in (quad, big):
        assert mi.closest_hits(to, td.contiguous(), t)[1].tolist() == [0] * 6
    masks = mi.block_face_masks(po, pd, tri)
    assert masks.shape == (4, tri.shape[0])
    assert not bool(masks[1].any()) and bool(masks[3].any())
    # The cull has teeth at the full-width camera's tiles.
    assert float(mi.block_face_masks(o, d, tri).float().mean()) < 0.1


def test_playground_frames_card_match_cpu(dev, tmp_path):
    """chip_smoke phase 5c (b) at 20,000 particles on a 64x64 grid:
    Engine.render and render_hybrid on the card against the CPU (primary
    mesh faces equal off the edges; frames within golden.compare's value
    rule at the trace's flip share)."""
    import chip_smoke
    chip_smoke.write_glb(tmp_path / "card.glb")
    fields = bench_scene(20_000, seed=2, specular_std=0.1)
    rep, ok = chip_smoke.playground_card_vs_cpu(fields, 64, dev,
                                                tmp_path / "card.glb")
    assert ok, rep
    assert rep["hits"] > 100
