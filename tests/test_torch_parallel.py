"""Multi-device training of the port (threedgrut_torch.parallel) on the CPU
over gloo: the mesh layout and its refusals, the gathers' bits, the (1, 1,
1) mesh bit-equal to Trainer.train_step, tile and model meshes against the
single-device gradient and a (2, 2, 1) mesh against the JAX package's
data-parallel step (golden/dp_2x2.npz, written by tools/torch_dp_golden.py;
no JAX call here), replication bit for bit across ranks, the one-step-late
capacity growth, DPTrainer end to end, ROADMAP C18 (densification
accumulates per view) and C19 (the mesh step is the single-device step; a
3DGRT configuration is refused), and my_view_indices against the JAX
package's schedule.

Gradients are held to tests/test_parallel.py's tolerance, 2e-4 max|g| +
5e-8 per field. The world of 4 ranks runs once for the module
(tests/torch_dp_workers.four_ranks: every 4-rank scenario in turn); the (1,
1, 1) mesh runs in this process over a gloo group of one.
"""
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests import torch_dp_workers as W
from threedgrut_torch import golden
from threedgrut_torch.config import preset_3dgrt, preset_3dgut_sorted
from threedgrut_torch.parallel import dp, multihost
from threedgrut_torch.parallel.trainer import DPTrainer, row_seed
from threedgrut_torch.strategy import gs
from threedgrut_torch.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ds():
    return W.dataset()


@pytest.fixture(scope="module")
def fields(ds):
    return W.initial_fields(ds)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's records of tests/torch_dp_workers.four_ranks."""
    out = str(tmp_path_factory.mktemp("dp_run"))
    return multihost.spawn(W.four_ranks, 4, args=(out,), backend="gloo",
                           timeout=240, threads=1)


@pytest.fixture
def world_of_one():
    """A gloo process group of this process alone."""
    assert not dist.is_initialized()
    multihost.init_process_group("gloo",
                                 f"127.0.0.1:{multihost.free_port()}", 1, 0,
                                 timeout_s=60)
    yield
    dist.destroy_process_group()


def assert_grads_close(got, want, label=""):
    for f, w in want.items():
        w = np.asarray(w)
        scale = max(1e-6, float(np.abs(w).max()))
        np.testing.assert_allclose(np.asarray(got[f]), w,
                                   atol=2e-4 * scale + 5e-8,
                                   err_msg=f"{label} {f}")


def single_view(ds, fields, cfg, view):
    """One Trainer.train_step from `fields` on `view`: (trainer, aux)."""
    tr = Trainer(cfg, ds, params=W.params_of(fields), device="cpu")
    return tr, tr.train_step(view)


# ---- layout ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 4, 1), (1, 2, 2),
                                   (2, 2, 1), (2, 3, 2)])
def test_rank_layout_is_jax_row_major(shape):
    """Rank r's (d, t, m) is its place in the JAX package's
    arange(n).reshape(n // (T M), T, M); every axis group lists the ranks
    that differ along that axis only, in rank order."""
    n = int(np.prod(shape))
    grid = np.arange(n).reshape(shape)
    for r in range(n):
        assert grid[dp.coords_of(r, shape)] == r
    for axis, name in enumerate(dp.AXES):
        want = sorted(np.moveaxis(grid, axis, -1).reshape(
            -1, shape[axis]).tolist())
        assert sorted(dp._group_members(shape, name)) == want
    rows = dp._group_members(shape, "row")
    assert rows == grid.reshape(shape[0], -1).tolist()


def test_mesh_refusals():
    """The mesh's ValueErrors: a world of one cannot hold 2 ranks; the
    tiles must divide by the tile axis and the capacity by the model axis
    (the JAX package's asserts)."""
    with pytest.raises(ValueError, match="needs 2 processes"):
        dp.make_mesh(2, 1, 1)
    with pytest.raises(ValueError, match="at least 1"):
        dp.make_mesh(1, 0, 1)
    shard = dp.RankShard(dp.Mesh((1, 3, 2), 0, {g: None for g in dp.GROUPS}))
    with pytest.raises(ValueError, match="do not divide by the tile axis 3"):
        shard.local_tiles(4)
    assert shard.local_tiles(6) == slice(0, 2)
    with pytest.raises(ValueError, match="capacity 63 does not divide"):
        shard.local_particles((torch.zeros(63, 3),))
    with pytest.raises(ValueError, match="one view a step"):
        multihost.host_local_batch(shard.mesh, [])


def test_gather_keeps_bits_and_backward_is_local():
    """The int32 gather on one process returns every dtype's bits (-0.0,
    a NaN payload, int64, bool); the differentiable gather's backward is
    this rank's slice."""
    nan = torch.tensor([0x7FC01234], dtype=torch.int32).view(torch.float32)
    xs = [torch.cat([torch.tensor([-0.0, 1e-40]), nan]),
          torch.tensor([-3, 1 << 40]), torch.tensor([True, False])]
    for x, y in zip(xs, dp.all_gather(xs, None, 1, 0)):
        assert y.shape == (1,) + x.shape and y.dtype == x.dtype
        assert torch.equal(y[0].view(torch.uint8)
                           if x.dtype == torch.float32 else y[0],
                           x.view(torch.uint8)
                           if x.dtype == torch.float32 else x)
    x = torch.randn(3, 2, requires_grad=True)
    y = dp.gather_slices(x, None, 1, 0)
    (y * 2).sum().backward()
    assert torch.equal(x.grad, torch.full((3, 2), 2.0))


def test_gather_across_ranks_keeps_bits(ranks):
    """Four ranks' -0.0, NaN payloads, int64 and bool come back bit for bit,
    the same on every rank."""
    for r, rec in enumerate(ranks):
        odd, ints, flags = rec["gather"]
        for k in range(4):
            assert np.signbit(odd[k, 0]) and odd[k, 0] == 0.0
            assert odd[k, 1] == k and odd[k, 2] == np.float32(1e-40)
            assert odd[k, 3:].view(np.int32)[0] == 0x7FC01234 + k
            assert ints[k].tolist() == [k - 2, 1 << 40]
            assert flags[k].tolist() == [k % 2 == 0, True]
        for a, b in zip(rec["gather"], ranks[0]["gather"]):
            assert a.tobytes() == b.tobytes()


# ---- (1, 1, 1): the single-device step, bit for bit -----------------------

@pytest.mark.parametrize("preset", [None, preset_3dgut_sorted],
                         ids=["default", "sorted16"])
def test_one_rank_mesh_is_trainer_bit_for_bit(world_of_one, ds, fields,
                                              preset):
    """DPTrainer at (1, 1, 1) over a gloo group of one, 3 steps, equals
    Trainer.train_step bit for bit: loss, prediction, parameters and Adam's
    moments. With preset_3dgut_sorted its 16 re-sort passes are honoured
    (ROADMAP C19: the JAX package's mesh step always runs its plain 3DGUT
    render, threedgrut_tpu/parallel/dp.py:117-155, so it trains without
    them)."""
    cfg = W.config(preset)
    tr = Trainer(cfg, ds, params=W.params_of(fields), device="cpu")
    dtr = DPTrainer(cfg, ds, params=W.params_of(fields), device="cpu",
                    mesh_shape=(1, 1, 1))
    assert dtr.mesh.groups["row"] is not None
    for k in range(3):
        a = tr.train_step(ds[k])
        b = dtr.train_step(ds[k])
        assert float(a["terms"]["total"]) == float(b["terms"]["total"])
        assert torch.equal(a["pred"], b["pred"])
        assert torch.equal(a["visibility"], b["visibility"])
        assert torch.equal(a["pos_grad_norm"], b["view_pos_grad_norm"][0])
    assert W.digest(W.state_of(tr)) == W.digest(W.state_of(dtr))
    if preset is not None:
        plain = Trainer(W.config(), ds, params=W.params_of(fields),
                        device="cpu")
        for k in range(3):
            plain.train_step(ds[k])
        assert W.digest(W.state_of(plain)) != W.digest(W.state_of(dtr))


def test_mesh_refuses_3dgrt_before_any_group():
    """ROADMAP C19: a 3DGRT configuration on the mesh is a ValueError naming
    the method and the mesh, raised before a process group is needed (a
    (2, 1, 1) mesh in a process with none would raise another error)."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match=r"'3dgrt'.*\(2, 1, 1\)"):
        DPTrainer(preset_3dgrt(), None, mesh_shape=(2, 1, 1), device="cpu")
    with pytest.raises(ValueError, match="3DGUT"):
        dp.check_supported(preset_3dgrt(), (1, 1, 1))


# ---- the 4-rank world ------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 4, 1), (1, 2, 2)])
def test_tile_and_model_meshes_match_single_device(ranks, ds, fields,
                                                  shape):
    """One step on view 0: every rank's reduced gradients are the
    single-device gradients (within the tolerance), bit-equal across the
    ranks, as are the loss and the parameters after Adam."""
    _, aux = single_view(ds, fields, W.config(), ds[0])
    want = {k: v.numpy() for k, v in aux["grads"].items()}
    recs = [r[shape] for r in ranks]
    assert sorted(r["coords"] for r in recs) == [
        dp.coords_of(k, shape) for k in range(4)]
    for r in recs:
        assert_grads_close(r["grads"], want, str(shape))
        assert not r["overflow"]
        np.testing.assert_allclose(r["loss"], float(aux["terms"]["total"]),
                                   rtol=1e-6)
        assert r["digest"] == recs[0]["digest"]
        for f in want:
            assert r["grads"][f].tobytes() == recs[0]["grads"][f].tobytes()


def test_data_mesh_matches_jax_golden(ranks):
    """(2, 2, 1) on views 0 and 1 against the JAX package's step on the same
    mesh (dp_2x2.npz): gradients within the tolerance, loss and PSNR,
    visibility and the overflow flag; the gradient is the mean over the
    views (JAX's loss / (B T M) with summed gather transposes)."""
    g = golden.load_dp()
    for r in ranks:
        rec = r["golden"]
        assert_grads_close(rec["grads"], {k.split("/", 1)[1]: g[k]
                                          for k in g if k.startswith("grads/")},
                           "golden")
        np.testing.assert_allclose(rec["loss"], float(g["loss"]), rtol=1e-5)
        np.testing.assert_allclose(rec["psnr"], float(g["psnr"]), rtol=1e-5)
        np.testing.assert_array_equal(rec["visibility"], g["visibility"])
        assert rec["overflow"] == bool(g["overflow"]) is False
        assert rec["digest"] == ranks[0]["golden"]["digest"]


def test_data_mesh_is_the_mean_of_single_view_steps(ranks, ds):
    """(2, 2, 1): the reduced gradient is the mean of the two views'
    single-device gradients, each view's norm and visibility those of its
    single-view step."""
    g = golden.load_dp()
    gf = {k.split("/", 1)[1]: g[k] for k in g if k.startswith("params/")}
    views = W.golden_views(ds, g)
    singles = [single_view(ds, gf, W.golden_config(), v)[1] for v in views]
    mean = {f: ((singles[0]["grads"][f] + singles[1]["grads"][f]) / 2).numpy()
            for f in singles[0]["grads"]}
    rec = ranks[0]["golden"]
    assert_grads_close(rec["grads"], mean, "mean")
    for i, s in enumerate(singles):
        n = s["pos_grad_norm"].numpy()
        np.testing.assert_allclose(rec["view_pos_grad_norm"][i], n,
                                   rtol=1e-5, atol=2e-4 * n.max())
        np.testing.assert_array_equal(rec["view_visibility"][i],
                                      s["visibility"].numpy())


def test_gs_accumulates_per_view(ranks, ds):
    """ROADMAP C18, decided per view: after a (2, 2, 1) step with GS, the
    accumulator equals two single-view accumulations from the same
    parameters (each view's own norm, camera and visibility). The JAX
    rule (threedgrut_tpu/parallel/dp.py:195, trainer.py:103-107: the norm
    of the batch gradient, once, weighted by view 0's camera), computed
    here from the same gradients, differs."""
    g = golden.load_dp()
    gf = {k.split("/", 1)[1]: g[k] for k in g if k.startswith("params/")}
    rec = ranks[0]["golden"]
    after = W.params_of(dict(gf, positions=rec["positions"]))
    views = W.golden_views(ds, g)
    cams = [torch.as_tensor(v.T_to_world)[:3, 3] for v in views]
    want = gs.init_state(64, "cpu")
    for v, cam in zip(views, cams):
        aux = single_view(ds, gf, W.golden_config(), v)[1]
        want = gs.accumulate(want, after, aux["pos_grad_norm"], cam,
                             aux["visibility"])
    got = rec["strategy"]
    np.testing.assert_allclose(got["strategy/grad_accum"],
                               want.grad_accum.numpy(), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_array_equal(got["strategy/grad_denom"],
                                  want.grad_denom.numpy())
    np.testing.assert_array_equal(got["strategy/rolling_vis"],
                                  want.rolling_vis.numpy())
    jax_rule = gs.accumulate(
        gs.init_state(64, "cpu"), after,
        torch.linalg.norm(torch.as_tensor(rec["grads"]["positions"]), dim=-1),
        cams[0], torch.as_tensor(rec["visibility"]))
    assert int(jax_rule.grad_denom.sum()) < int(want.grad_denom.sum())
    assert not np.allclose(jax_rule.grad_accum.numpy(),
                           want.grad_accum.numpy(), rtol=1e-2)
    for r in ranks:
        for k, v in r["golden"]["strategy"].items():
            assert v.tobytes() == got[k].tobytes(), k


def test_overflow_grows_capacity_one_step_late(ranks):
    """Splats over every tile at capacity 128: the flag, ORed over the mesh,
    doubles the capacity one step late (after step 2) and not again for
    step 2, which ran at the old capacity (Trainer's rule); at 256 the
    steps fit. Alike on every rank."""
    for r in ranks:
        o = r["overflow"]
        assert o["flags"] == [True, True, False, False]
        assert o["capacities"] == [128, 256, 256, 256]
        assert o["digest"] == ranks[0]["overflow"]["digest"]


def test_dp_trainer_end_to_end(ranks):
    """DPTrainer.run at (2, 2, 1) with GS densification, a checkpoint at step
    6 (written by rank 0), validation, and a resume from it that restores
    the strategy's state and trains to step 8; every rank ends with the
    same bits, after densification and after the resume."""
    e = ranks[0]["e2e"]
    assert e["step"] == 8 and np.isfinite(e["psnr_after"])
    assert e["alive_after"] > e["alive_before"]
    assert "ckpt_6.npz" in e["ckpt"] and "ckpt_last.npz" in e["ckpt"]
    assert e["resumed_at"] == 6 and e["resumed_step"] == 8
    assert e["resumed_accum"] > 0.0
    for r in ranks:
        assert r["e2e"]["digest"] == e["digest"]
        assert r["e2e"]["resumed_digest"] == e["resumed_digest"]
        assert r["e2e"]["psnr_after"] == e["psnr_after"]


# ---- multihost helpers -----------------------------------------------------

def jax_schedule(num_views, batch_size, step, seed, pid, nproc):
    """threedgrut_tpu/parallel/multihost.py:222-234 in numpy."""
    rng = np.random.default_rng(seed * 100003 + step // max(num_views, 1))
    perm = rng.permutation(num_views)
    rows = [int(perm[(step * batch_size + i) % num_views])
            for i in range(batch_size)]
    per = batch_size // nproc
    return rows[pid * per:(pid + 1) * per]


@pytest.mark.parametrize("num_views,batch,nproc", [(4, 2, 2), (7, 4, 2),
                                                   (100, 8, 4), (3, 3, 1)])
def test_my_view_indices_is_the_jax_schedule(num_views, batch, nproc):
    """Every process's slice of every step's views, as the JAX package
    computes them; with a mesh, a data row's slice."""
    for step in (0, 1, num_views - 1, 5 * num_views + 3):
        for seed in (0, 7):
            for pid in range(nproc):
                assert multihost.my_view_indices(
                    num_views, batch, step, seed, process_index=pid,
                    process_count=nproc) == jax_schedule(
                        num_views, batch, step, seed, pid, nproc)
            shape = (nproc, 2, 1)
            for r in range(2 * nproc):
                mesh = dp.Mesh(shape, r, {})
                assert multihost.my_view_indices(
                    num_views, batch, step, seed, mesh=mesh) == \
                    jax_schedule(num_views, batch, step, seed,
                                 dp.coords_of(r, shape)[0], nproc)


def test_row_seeds_and_golden_provenance():
    """Each data row draws from its own seed (row 0 the run's); the golden
    step's file is current: made from these JAX sources and inputs by
    tools/torch_dp_golden.py (rerun it when this fails)."""
    seeds = {row_seed(3, r) for r in range(4)}
    assert len(seeds) == 4 and row_seed(3, 0) == 3
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_dp_golden", ROOT / "tools" / "torch_dp_golden.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    g = golden.load_dp()
    inputs = {k: g[k] for k in g
              if k.startswith("params/") or k in ("T_to_world", "rgb_gt",
                                                  "scene_extent")}
    assert str(g["provenance"]) == golden.dp_provenance(
        ROOT / "threedgrut_tpu", inputs, tool.SETTINGS)
    assert float(np.abs(g["grads/positions"]).max()) > 0.0
