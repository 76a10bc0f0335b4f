"""The CUDA kernels of threedgrut_torch against their plain versions, on the
card. Marked `cuda`: without a card and nvcc every test skips (the fixture
decides, at run time). Nothing here imports JAX, so the file runs where JAX
is not installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: B3 and B4 exact (--fmad=false, same f32 operations); B1 rows
0-5 atol 2e-4 / rtol 1e-4 (colour sums in another order), hit counts, the
walked slots and the flagged slots exact (same per-pair alpha and the same
sequential transmittance); whole frames card vs CPU within golden.compare.
B2: atol 1e-5 x each column's max (the same per-pixel values, summed over
the tile's pixels in another order), the nonzero slots exactly equal. B5,
B6: within segment_sum.f32_sum_bound (sequential f32 sums against the
plain f64 ones)."""
import os
import shutil

import numpy as np
import pytest
import torch

from threedgrut_torch import api, golden
from threedgrut_torch.cameras import example_camera, look_at, pose_from_matrix
from threedgrut_torch.model.gaussians import bench_scene, from_numpy
from threedgrut_torch.ops import (cuda_build, expand, segment_sum,
                                  tile_raster, tiles)
from threedgrut_torch.render import gut

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
    assert torch.equal(got, expand.cull_masks_plain(*args))
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("cap", [1 << 18, 4096])
def test_expand_keys_kernel_matches_plain(dev, cap):
    proj, _, _, grid, _ = prepared(dev)
    args = b3_inputs(proj)
    masks = expand.cull_masks(*args)
    ids_of_rank, ends_rank = tiles.depth_rank(masks[0], proj.depth)
    b4 = (ends_rank, ids_of_rank, args[0], args[1], masks, args[3], args[4],
          args[5], cap, grid, True)
    for a, b in zip(expand.expand_keys(*b4), expand.expand_keys_plain(*b4)):
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
