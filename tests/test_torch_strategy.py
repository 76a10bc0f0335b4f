"""Densification in the port (threedgrut_torch/strategy) against the JAX
package's strategies (threedgrut_tpu/strategy) on tiny capacity-padded
layouts, on the CPU.

The JAX functions draw their randomness inside; the port's take the draws
as arguments. Each test rebuilds the JAX side's draws from the same key
exactly as the JAX function makes them and hands them to the port's pure
function: for densify `k1, k2 = jax.random.split(key)` then
`normal(k1, (C, 3))` and `normal(k2, (C, 3))`; for relocate and
add_gaussians `mcmc._sample_sources(key, probs, (C,))`; for perturb
`normal(key, positions.shape)`. No JAX train step runs here.

Tolerance: masks, alive, taken slots, sources and integer state exactly;
floats within rtol 1e-5, atol 1e-6 (the same f32 operations; rotation
products, pow, exp and log may differ by an ulp between the two
libraries)."""
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedgrut_tpu import optimizers as jopt
from threedgrut_tpu import trainer as jtrainer
from threedgrut_tpu.config import Config as JConfig
from threedgrut_tpu.model import gaussians as jg
from threedgrut_tpu.strategy import base as jbase
from threedgrut_tpu.strategy import gs as jgs
from threedgrut_tpu.strategy import mcmc as jmcmc
from threedgrut_torch import optimizers as topt
from threedgrut_torch import trainer as ttrainer
from threedgrut_torch.config import Config
from threedgrut_torch.datasets.dataset_synthetic import SyntheticDataset
from threedgrut_torch.model import gaussians as tg
from threedgrut_torch.strategy import base as tbase
from threedgrut_torch.strategy import gs as tgs
from threedgrut_torch.strategy import mcmc as tmcmc

RTOL, ATOL = 1e-5, 1e-6
FLOAT_FIELDS = [f for f in tg.FIELDS if f != "alive"]


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    """torch on one intra-op thread: many small ops, under the parallel
    test run's load."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_fields(n=40, cap=64, seed=0):
    """Raw padded fields of n particles with varied scales and opacities."""
    rng = np.random.default_rng(seed)
    return tg.padded_fields(
        rng.normal(0, 1.0, (n, 3)).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
        np.log(rng.uniform(0.005, 0.1, (n, 3))).astype(np.float32),
        rng.normal(0, 2.0, (n, 1)).astype(np.float32),
        rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        rng.normal(0, 0.1, (n, 45)).astype(np.float32), cap)


def moments(fields, seed=1):
    rng = np.random.default_rng(seed)
    m = {k: rng.normal(size=fields[k].shape).astype(np.float32)
         for k in topt.PARAM_FIELDS}
    v = {k: np.abs(rng.normal(size=fields[k].shape)).astype(np.float32)
         for k in topt.PARAM_FIELDS}
    return m, v


def both(fields, seed=1):
    """(JAX params, JAX AdamState, port params, port AdamState), equal."""
    m, v = moments(fields, seed)
    jp = jg.Gaussians(**{k: jnp.asarray(x) for k, x in fields.items()})
    jo = jopt.AdamState(step=jnp.int32(3),
                        exp_avg={k: jnp.asarray(x) for k, x in m.items()},
                        exp_avg_sq={k: jnp.asarray(x) for k, x in v.items()})
    tp = tg.from_numpy(fields, device="cpu")
    to = topt.state_from_numpy(m, v, 3, "cpu")
    return jp, jo, tp, to


def npy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_params_equal(tp, jp):
    assert np.array_equal(npy(tp.alive), npy(jp.alive))
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(npy(getattr(tp, f)), npy(getattr(jp, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


def assert_opt_equal(to, jo):
    for k in topt.PARAM_FIELDS:
        assert np.array_equal(npy(to.exp_avg[k]), npy(jo.exp_avg[k])), k
        assert np.array_equal(npy(to.exp_avg_sq[k]),
                              npy(jo.exp_avg_sq[k])), k


def gs_states(cap, seed=2, frac_high=0.3):
    rng = np.random.default_rng(seed)
    accum = rng.uniform(0, 1e-3, cap).astype(np.float32)
    accum[rng.uniform(size=cap) < frac_high] *= 100.0
    denom = rng.integers(0, 4, cap).astype(np.int32)
    vis = rng.uniform(0.2, 1.0, cap).astype(np.float32)
    return (jgs.GSState(grad_accum=jnp.asarray(accum),
                        grad_denom=jnp.asarray(denom),
                        rolling_vis=jnp.asarray(vis)),
            tgs.GSState(grad_accum=torch.tensor(accum),
                        grad_denom=torch.tensor(denom),
                        rolling_vis=torch.tensor(vis)))


def assert_state_equal(ts, js):
    for f in dataclasses.fields(js):
        a, b = npy(getattr(ts, f.name)), npy(getattr(js, f.name))
        assert a.dtype == b.dtype, f.name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f.name)
        else:
            assert np.array_equal(a, b), f.name


# ---- GS ------------------------------------------------------------------

def test_accumulate_matches_jax():
    f = make_fields()
    jp, _, tp, _ = both(f)
    js, ts = gs_states(64)
    rng = np.random.default_rng(5)
    for _ in range(3):
        norm = rng.uniform(0, 1e-3, 64).astype(np.float32)
        norm[rng.uniform(size=64) < 0.3] = 0.0
        vis = rng.uniform(size=64) < 0.5
        cam = rng.normal(0, 3, 3).astype(np.float32)
        js = jgs.accumulate(js, jp, jnp.asarray(norm), jnp.asarray(cam),
                            jnp.asarray(vis), 0.9)
        ts = tgs.accumulate(ts, tp, torch.tensor(norm), torch.tensor(cam),
                            torch.tensor(vis), 0.9)
    assert_state_equal(ts, js)


@pytest.mark.parametrize("n_need,n_free", [(5, 20), (20, 5), (0, 10),
                                           (10, 0), (64, 0), (7, 7)])
def test_assign_free_slots_matches_jax(n_need, n_free):
    rng = np.random.default_rng(n_need * 100 + n_free)
    cap = 64
    free = np.zeros(cap, bool)
    free[rng.permutation(cap)[:n_free]] = True
    need = np.zeros(cap, bool)
    need[rng.permutation(np.flatnonzero(~free))[:n_need]] = True
    jt, jsrc = jgs._assign_free_slots(jnp.asarray(need), jnp.asarray(free))
    tt, tsrc = tgs._assign_free_slots(torch.tensor(need), torch.tensor(free))
    take = npy(jt)
    assert np.array_equal(npy(tt), take)
    assert take.sum() == min(n_need, n_free)
    assert np.array_equal(npy(tsrc)[take], npy(jsrc)[take])
    assert np.array_equal(npy(tsrc)[take],
                          np.flatnonzero(need)[:take.sum()])


def densify_draws(key, cap):
    k1, k2 = jax.random.split(key)
    return (torch.tensor(np.asarray(jax.random.normal(k1, (cap, 3)))),
            torch.tensor(np.asarray(jax.random.normal(k2, (cap, 3)))))


@pytest.mark.parametrize("seed", [0, 1])
def test_densify_matches_jax(seed):
    """Clones and splits with free slots for all of them: the port equals
    JAX (C8 does not arise)."""
    f = make_fields(n=40, cap=64, seed=seed)
    jp, jo, tp, to = both(f)
    js, ts = gs_states(64, seed=seed + 10)
    key = jax.random.PRNGKey(seed)
    extent, gthr, sthr = 1.5, 2e-3, 0.05
    jp2, jo2, js2 = jgs.densify(jp, jo, js, key, jnp.float32(extent), gthr,
                                sthr, 1.6)
    n1, n2 = densify_draws(key, 64)
    to2, ts2, counts = tgs.densify(tp, to, ts, n1, n2, extent, gthr, sthr,
                                   1.6)
    assert_params_equal(tp, jp2)
    assert_opt_equal(to2, jo2)
    assert_state_equal(ts2, js2)
    added = int(jp2.num_active()) - int(jp.num_active())
    assert int(counts["clone"]) > 0 and int(counts["split"]) > 0
    assert int(counts["clone"]) + int(counts["split"]) == added


def test_densify_c8_splits_only_sources_with_a_slot():
    """ROADMAP C8 at exhausted capacity: 8 alive particles in a capacity of
    9, three of them large with a high gradient. JAX moves and shrinks all
    three split sources and adds one particle; the port splits only the
    source that got the free slot, and the other two keep their values and
    moments. Both reset the state."""
    f = make_fields(n=8, cap=9, seed=3)
    f["scale"][:8] = np.log(0.001)
    f["scale"][[1, 4, 6]] = np.log(0.5)
    jp, jo, tp, to = both(f)
    grad = np.zeros(9, np.float32)
    grad[[1, 4, 6]] = 1.0
    js = jgs.GSState(grad_accum=jnp.asarray(grad),
                     grad_denom=jnp.ones(9, jnp.int32),
                     rolling_vis=jnp.ones(9))
    ts = tgs.GSState(grad_accum=torch.tensor(grad),
                     grad_denom=torch.ones(9, dtype=torch.int32),
                     rolling_vis=torch.ones(9))
    key = jax.random.PRNGKey(4)
    jp2, jo2, js2 = jgs.densify(jp, jo, js, key, jnp.float32(1.0), 2e-4,
                                0.01, 1.6)
    n1, n2 = densify_draws(key, 9)
    to2, ts2, counts = tgs.densify(tp, to, ts, n1, n2, 1.0, 2e-4, 0.01, 1.6)

    shrunk = np.log(0.5) - np.log(1.6)
    j_scale, t_scale = npy(jp2.scale), npy(tp.scale)
    # JAX: every split source moved and shrunk, one particle added.
    assert int(jp2.num_active()) == 9
    np.testing.assert_allclose(j_scale[[1, 4, 6]], shrunk, rtol=RTOL)
    for i in (1, 4, 6):
        assert not np.allclose(npy(jp2.positions)[i], f["positions"][i])
        assert float(jo2.exp_avg["positions"][i, 0]) == 0.0
    # The port: only source 1 (the first, which got slot 8) is split.
    assert int(tp.num_active()) == 9
    assert (int(counts["split"]), int(counts["clone"])) == (1, 0)
    np.testing.assert_allclose(t_scale[[1, 8]], shrunk, rtol=RTOL)
    for i in (4, 6):
        assert np.array_equal(t_scale[i], f["scale"][i])
        assert np.array_equal(npy(tp.positions)[i], f["positions"][i])
        for k in topt.PARAM_FIELDS:
            assert np.array_equal(npy(to2.exp_avg[k])[i],
                                  npy(to.exp_avg[k])[i])
    # Where the two agree (the slotted source and the new slot), equal.
    for fld in FLOAT_FIELDS:
        np.testing.assert_allclose(npy(getattr(tp, fld))[[1, 8]],
                                   npy(getattr(jp2, fld))[[1, 8]],
                                   rtol=RTOL, atol=ATOL, err_msg=fld)
    for k in topt.PARAM_FIELDS:
        assert not npy(to2.exp_avg[k])[[1, 8]].any()
    assert_state_equal(ts2, js2)


def test_prune_matches_jax():
    f = make_fields()
    f["density"][:5] = -8.0
    jp, jo, tp, _ = both(f)
    js, _ = gs_states(64)
    jp2, _, _ = jgs.prune(jp, jo, js, 0.005)
    gone = tgs.prune(tp, 0.005)
    assert_params_equal(tp, jp2)
    assert int(gone) == int(jp.num_active()) - int(jp2.num_active()) >= 5


def test_prune_scale_matches_jax():
    f = make_fields()
    f["scale"][0] = np.log(5.0)
    jp, _, tp, _ = both(f)
    cam_pos = np.array([[0.0, 0.0, -5.0], [4.0, 0.0, 0.0]], np.float32)
    cam_fwd = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0]], np.float32)
    jp2 = jgs.prune_scale(jp, jnp.asarray(cam_pos), jnp.asarray(cam_fwd),
                          jnp.float32(100.0), 1.0)
    tgs.prune_scale(tp, torch.tensor(cam_pos), torch.tensor(cam_fwd), 100.0,
                    1.0)
    assert_params_equal(tp, jp2)
    assert not bool(tp.alive[0])
    assert 0 < int(tp.num_active()) < 40


def test_prune_weight_matches_jax():
    f = make_fields()
    jp, _, tp, _ = both(f)
    js, ts = gs_states(64)
    jp2 = jgs.prune_weight(jp, js, 0.5)
    tgs.prune_weight(tp, ts, 0.5)
    assert_params_equal(tp, jp2)
    assert 0 < int(tp.num_active()) < 40


def test_density_decay_and_reset_match_jax():
    f = make_fields()
    jp, _, tp, _ = both(f)
    jp2 = jgs.reset_density(jgs.decay_density(jp, 0.9), 0.01)
    tgs.decay_density(tp, 0.9)
    tgs.reset_density(tp, 0.01)
    assert_params_equal(tp, jp2)
    assert float(tp.density.detach().max()) <= math.log(0.01 / 0.99) + 1e-6


def test_zero_opt_slots_matches_jax():
    f = make_fields()
    _, jo, _, to = both(f)
    mask = np.random.default_rng(6).uniform(size=64) < 0.3
    jo2 = jbase.zero_opt_slots(jo, jnp.asarray(mask))
    to2 = tbase.zero_opt_slots(to, torch.tensor(mask))
    assert_opt_equal(to2, jo2)
    assert to2.step == 3
    # A new state: the old one is not written into.
    assert float(to.exp_avg["positions"][mask].abs().sum()) > 0


# ---- MCMC ----------------------------------------------------------------

def test_binom_table_matches_jax():
    assert np.array_equal(npy(tmcmc.binom_table(51, "cpu")),
                          npy(jmcmc.binom_table(51)))


def relocation_kernel(opacity, scale, ratio, binoms):
    """Direct python port of compute_relocation_kernel (as in
    tests/test_strategy.py)."""
    ops, scs = [], []
    for m in range(len(opacity)):
        n = int(ratio[m])
        op = 1.0 - (1.0 - opacity[m]) ** (1.0 / n)
        denom = sum(binoms[i - 1, k] * ((-1.0) ** k) / math.sqrt(k + 1)
                    * op ** (k + 1) for i in range(1, n + 1)
                    for k in range(i))
        ops.append(op)
        scs.append(opacity[m] / denom * scale[m])
    return np.asarray(ops), np.asarray(scs)


def test_relocation_correction_matches_jax_and_kernel():
    rng = np.random.default_rng(0)
    opacity = rng.uniform(0.01, 0.9, 24).astype(np.float32)
    scale = rng.uniform(0.01, 1.0, (24, 3)).astype(np.float32)
    ratio = rng.integers(1, 12, 24).astype(np.int32)
    jb = jmcmc.binom_table(51)
    jop, jsc = jmcmc.relocation_correction(
        jnp.asarray(opacity), jnp.asarray(scale), jnp.asarray(ratio), jb, 51)
    top, tsc = tmcmc.relocation_correction(
        torch.tensor(opacity), torch.tensor(scale), torch.tensor(ratio),
        tmcmc.binom_table(51, "cpu"), 51)
    np.testing.assert_allclose(npy(top), npy(jop), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(npy(tsc), npy(jsc), rtol=RTOL, atol=ATOL)
    kop, ksc = relocation_kernel(opacity.astype(np.float64), scale, ratio,
                                 npy(jb))
    np.testing.assert_allclose(npy(top), kop, rtol=1e-5)
    np.testing.assert_allclose(npy(tsc), ksc, rtol=1e-4)


def mcmc_sources(jp, key, thr=0.005):
    """The JAX functions' own source draw, as indices."""
    opacity = jp.get_density()
    live = jp.alive & (opacity > thr)
    src = jmcmc._sample_sources(key, jnp.where(live, opacity, 0.0),
                                (jp.capacity,))
    return torch.tensor(np.asarray(src), dtype=torch.int64)


@pytest.mark.parametrize("seed", [0, 1])
def test_relocate_matches_jax(seed):
    f = make_fields(seed=seed)
    f["density"][[0, 3, 7, 11, 12]] = -8.0
    jp, jo, tp, to = both(f)
    key = jax.random.PRNGKey(seed + 20)
    jp2, jo2 = jmcmc.relocate(jp, jo, key, 0.005, jmcmc.binom_table(51))
    src = mcmc_sources(jp, key)
    to2, n = tmcmc.relocate(tp, to, src, 0.005, tmcmc.binom_table(51, "cpu"))
    assert_params_equal(tp, jp2)
    assert_opt_equal(to2, jo2)
    dead = np.flatnonzero(f["alive"] & (f["density"][:, 0]
                                        <= math.log(0.005 / 0.995)))
    assert int(n) == len(dead) >= 5 and int(tp.num_active()) == 40
    # The relocated slots sit on live sources.
    live = np.setdiff1d(np.arange(40), dead)
    assert np.isin(npy(tp.positions)[dead, 0], f["positions"][live, 0]).all()


@pytest.mark.parametrize("n_add", [3, 17, 30])
def test_add_gaussians_matches_jax(n_add):
    f = make_fields()
    f["density"][[2, 5]] = -8.0
    jp, jo, tp, to = both(f)
    key = jax.random.PRNGKey(n_add)
    jp2, jo2 = jmcmc.add_gaussians(jp, jo, key, 0.005, jmcmc.binom_table(51),
                                   jnp.int32(n_add))
    src = mcmc_sources(jp, key)
    to2, n = tmcmc.add_gaussians(tp, to, src, 0.005,
                                 tmcmc.binom_table(51, "cpu"), n_add)
    assert_params_equal(tp, jp2)
    assert_opt_equal(to2, jo2)
    assert int(n) == min(n_add, 24) == int(tp.num_active()) - 40


def test_perturb_matches_jax():
    f = make_fields()
    f["density"][[0, 1]] = -8.0
    jp, _, tp, _ = both(f)
    key = jax.random.PRNGKey(9)
    pos_lr = 1e-3
    jp2 = jmcmc.perturb(jp, key, jnp.float32(pos_lr), 5e5)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (64, 3))))
    tmcmc.perturb(tp, noise, pos_lr, 5e5)
    assert_params_equal(tp, jp2)
    delta = np.abs(npy(tp.positions) - f["positions"]).sum(-1)
    assert delta[0] > 0 and not delta[40:].any()


# ---- the schedules: stand-in trainers on both sides ------------------------

SCHEDULE = dict(densify_start=2, densify_end=9, densify_frequency=2,
                reset_density_frequency=4, prune_weight_frequency=3,
                prune_weight_start=2, density_decay_frequency=5,
                mcmc_add_frequency=3)


def stand_in(side, fields, step):
    if side == "jax":
        p = jg.Gaussians(**{k: jnp.asarray(x) for k, x in fields.items()})
        return types.SimpleNamespace(params=p, opt_state=jopt.init(p),
                                     key=jax.random.PRNGKey(0),
                                     scene_extent=1.0, global_step=step)
    p = tg.from_numpy(fields, device="cpu")
    return types.SimpleNamespace(params=p, opt_state=topt.init(p),
                                 generator=torch.Generator().manual_seed(0),
                                 scene_extent=1.0, global_step=step)


def record_events(monkeypatch, module, names, log, results):
    for name in names:
        def stub(*args, _name=name, **kw):
            log.append(_name)
            return results(_name, args)
        monkeypatch.setattr(module, name, stub)


def test_gs_schedule_matches_jax(monkeypatch):
    jcfg, tcfg = JConfig().strategy, Config().strategy
    for k, v in SCHEDULE.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    names = ("accumulate", "densify", "prune", "prune_weight",
             "reset_density", "decay_density")
    jlog, tlog = [], []

    def jres(name, a):
        return {"accumulate": lambda: a[0],
                "densify": lambda: a[:3], "prune": lambda: a[:3]}.get(
                    name, lambda: a[0])()

    def tres(name, a):
        return {"accumulate": lambda: a[0],
                "densify": lambda: (a[1], a[2], {}),
                "prune": lambda: torch.tensor(0)}.get(name, lambda: None)()

    record_events(monkeypatch, jgs, names, jlog, jres)
    record_events(monkeypatch, tgs, names, tlog, tres)
    f = make_fields(n=8, cap=16)
    js, ts = jgs.GSStrategy(jcfg, 16), tgs.GSStrategy(tcfg, 16, "cpu")
    view = types.SimpleNamespace(T_to_world=np.eye(4, dtype=np.float32))
    aux = {"pos_grad_norm": None, "visibility": None}
    events = {}
    for step in list(range(0, 13)) + [3000, 12000, 15000]:
        for side, strat, log in (("jax", js, jlog), ("torch", ts, tlog)):
            log.clear()
            t = stand_in(side, f, step)
            strat.post_backward(t, view, aux)
            strat.post_optimizer_step(t, view, aux)
            events.setdefault(step, []).append(list(log))
        assert events[step][0] == events[step][1], (step, events[step])
    fired = {s for s, (e, _) in events.items() if "densify" in e}
    assert fired == {2, 4, 6, 8}
    assert {s for s, (e, _) in events.items()
            if "reset_density" in e} == {4, 8}
    assert {s for s, (e, _) in events.items()
            if "accumulate" in e} == set(events)   # prune_weight is on


def test_mcmc_schedule_matches_jax(monkeypatch):
    jcfg, tcfg = JConfig().strategy, Config().strategy
    for k, v in SCHEDULE.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    jlog, tlog = [], []
    record_events(monkeypatch, jmcmc, ("relocate", "add_gaussians",
                                       "perturb"), jlog,
                  lambda n, a: a[0] if n == "perturb" else a[:2])
    record_events(monkeypatch, tmcmc, ("relocate", "add_gaussians",
                                       "perturb"), tlog,
                  lambda n, a: None if n == "perturb"
                  else (a[1], torch.tensor(0)))
    f = make_fields(n=40, cap=64)
    f["density"][:40] = 3.0
    js = jmcmc.MCMCStrategy(jcfg, jopt.OptimizerConfig(), 64)
    ts = tmcmc.MCMCStrategy(tcfg, topt.OptimizerConfig(), 64, "cpu")
    fired = []
    for step in range(0, 13):
        for side, strat, log in (("jax", js, jlog), ("torch", ts, tlog)):
            log.clear()
            strat.post_optimizer_step(stand_in(side, f, step), None, None)
        assert jlog == tlog, (step, jlog, tlog)
        if "relocate" in tlog:
            fired.append(step)
            assert tlog == ["relocate", "add_gaussians", "perturb"]
    assert fired == [3, 6]


def test_mcmc_skips_moves_with_no_live_particle():
    """Every opacity at or below the threshold: torch.multinomial would
    raise, so relocation and growth are skipped; the noise still runs."""
    cfg = Config().strategy
    cfg.densify_start, cfg.mcmc_add_frequency = 2, 2
    f = make_fields(n=40, cap=64)
    f["density"][:40] = -8.0
    t = stand_in("torch", f, 4)
    strat = tmcmc.MCMCStrategy(cfg, topt.OptimizerConfig(), 64, "cpu")
    strat.post_optimizer_step(t, None, None)
    assert strat.counts == {}
    assert np.array_equal(npy(t.params.alive), f["alive"])
    assert np.array_equal(npy(t.params.density), f["density"])
    assert not np.array_equal(npy(t.params.positions), f["positions"])


# ---- the Trainer with a strategy -------------------------------------------

@pytest.fixture(scope="module")
def dataset():
    return SyntheticDataset(num_views=4, resolution=(32, 32),
                            num_gt_gaussians=24, seed=5, device="cpu")


def strategy_trainer(dataset, method):
    cfg = Config()
    cfg.render.isect_capacity = 1 << 12
    cfg.strategy.method = method
    cfg.strategy.densify_start = 2
    cfg.strategy.densify_frequency = 5
    cfg.strategy.mcmc_add_frequency = 5
    cfg.strategy.reset_density_frequency = 1000
    # The tiny scene's gradients lie below the default 2e-4.
    cfg.strategy.densify_grad_threshold = 1e-6
    params = tg.init_from_points(np.asarray(dataset.scene[0]), capacity=64,
                                 device="cpu")
    strat = (tgs.GSStrategy(cfg.strategy, 64, "cpu") if method == "gs" else
             tmcmc.MCMCStrategy(cfg.strategy, cfg.optimizer, 64, "cpu"))
    return ttrainer.Trainer(cfg, dataset, params=params, strategy=strat,
                            device="cpu")


@pytest.mark.parametrize("method", ["gs", "mcmc"])
def test_trainer_densifies(dataset, method):
    tr = strategy_trainer(dataset, method)
    grown = []
    for _ in range(12):
        aux = tr.train_step(dataset[tr.global_step % len(dataset)])
        assert np.isfinite(float(aux["terms"]["total"]))
        grown.append(int(tr.params.num_active()))
    for f in tg.FIELDS[:-1]:
        assert bool(torch.isfinite(getattr(tr.params, f)).all()), f
    if method == "gs":
        assert grown[-1] > 24 and grown[0] == 24
    else:
        # 5% a growth event (int(1.05 * 24) = 25), at steps 5 and 10.
        assert grown[3] == 24 and grown[4] == 25 and grown[-1] == 26


def test_checkpoint_strategy_state_across_packages(tmp_path, dataset):
    """strategy/<field> keys: a JAX checkpoint with a GSStrategy's state
    resumes in the port, and the port's resumes in JAX."""
    f = make_fields(n=24, cap=64)
    cfg = JConfig()
    cfg.render.isect_capacity = 1 << 12
    jstrat = jgs.GSStrategy(cfg.strategy, 64)
    js, _ = gs_states(64, seed=11)
    jstrat.state = js
    jt = jtrainer.Trainer(cfg, dataclasses.make_dataclass(
        "Extent", [("scene_extent", float)])(2.0),
        params=jg.Gaussians(**{k: jnp.asarray(x) for k, x in f.items()}),
        strategy=jstrat)
    path = jt.save_checkpoint(str(tmp_path / "jax"))

    tstrat = tgs.GSStrategy(Config().strategy, 64, "cpu")
    tt = ttrainer.Trainer.load_checkpoint(path, dataset, device="cpu",
                                          strategy=tstrat)
    assert tt.strategy is tstrat
    for fld in ("grad_accum", "grad_denom", "rolling_vis"):
        assert np.array_equal(npy(getattr(tstrat.state, fld)),
                              npy(getattr(js, fld))), fld
    assert tstrat.state.grad_denom.dtype == torch.int32
    tstrat.state.grad_accum += 1.0
    path2 = tt.save_checkpoint(str(tmp_path / "torch"))

    jstrat2 = jgs.GSStrategy(cfg.strategy, 64)
    jt2 = jtrainer.Trainer.load_checkpoint(path2, dataset=None,
                                           strategy=jstrat2)
    assert jt2.strategy is jstrat2
    for fld in ("grad_accum", "grad_denom", "rolling_vis"):
        a, b = npy(getattr(jstrat2.state, fld)), npy(getattr(tstrat.state,
                                                             fld))
        assert a.dtype == b.dtype and np.array_equal(a, b), fld
