"""The packed 3DGRT culls: threedgrut_torch.render.grt's
bundle_candidates_twolevel_packed, the packed_l1 branch of
bundle_candidates_twolevel and resolve_packed, against threedgrut_tpu on the
same numpy inputs (plain XLA on the JAX side: no Pallas call).

Exact: counts, overflow, visibility and every bundle's candidate set (after
the super-list positions are resolved to particle ids), also against the
exact two-level cull's sets. The order within a list follows quantized
depth, and a ulp of depth between XLA and torch may move a candidate across
a bucket edge: it is held within golden.lists_agree at TRACE_FLIP_SHARE
(runs of reordered positions must be permutations), and element for element
on test_grt.py's depth-separated scene. The port's packed traces on that
scene are bit-equal to its exact trace, as the JAX package's are
(tests/test_grt.py::test_packed_cull_matches_exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_grt import separated_scene
from tests.test_gut_reference import random_scene
from threedgrut_tpu import constants as JC
from threedgrut_tpu.render import grt as jgrt
from threedgrut_torch import golden
from threedgrut_torch.render import grt

DEG = JC.KERNEL_DEGREE_3DGRT


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch on one intra-op thread for the module (as
    tests/test_torch_grt.py): many small ops under the parallel run's load
    stall on a pool's barriers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
# The JAX culls jitted (one compile per shape instead of one per eager op).
J_PACKED = jax.jit(jgrt.bundle_candidates_twolevel_packed,
                   static_argnums=(5, 6), static_argnames=("super_capacity",))
J_TWOLEVEL = jax.jit(jgrt.bundle_candidates_twolevel, static_argnums=(5, 6),
                     static_argnames=("super_capacity", "packed_l1"))


def npy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def tt(*xs):
    return [torch.tensor(np.asarray(x)) for x in xs]


def separated_rays(seed=22):
    """tests/test_grt.py::test_packed_cull_matches_exact's 32 bundles: one
    origin, directions fanned over the depth-separated layers."""
    rng = np.random.default_rng(seed)
    os_, ds_ = [], []
    for b in range(32):
        o = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (256, 1))
        d = np.stack([0.02 * (b % 6) + rng.uniform(-0.15, 0.15, 256),
                      0.02 * (b // 6) + rng.uniform(-0.15, 0.15, 256),
                      np.ones(256)], -1).astype(np.float32)
        os_.append(o)
        ds_.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return np.concatenate(os_), np.concatenate(ds_)


def fanned_rays(nb=32, seed=9, fan=0.4):
    """nb coherent bundles fanned over a scene at z ~ 3 (as
    tests/test_torch_grt.py's)."""
    rng = np.random.default_rng(seed)
    os_, ds_ = [], []
    for b in range(nb):
        ang = 2 * np.pi * b / nb
        o = np.tile(np.array([0.3 * np.cos(ang), 0.3 * np.sin(ang), -1.0],
                             np.float32), (256, 1))
        d = np.stack([fan * np.cos(ang) + rng.uniform(-0.1, 0.1, 256),
                      fan * np.sin(ang) + rng.uniform(-0.1, 0.1, 256),
                      np.ones(256)], -1).astype(np.float32)
        os_.append(o)
        ds_.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return np.concatenate(os_), np.concatenate(ds_).astype(np.float32)


def cull_inputs(scene, rays):
    pos, _, scale, opa, _ = map(np.asarray, scene)
    radius = np.asarray(jgrt.bounding_radius(jnp.asarray(scale),
                                             jnp.asarray(opa), DEG))
    return (pos, radius, opa >= JC.MIN_ALPHA) + tuple(rays)


# (scene, rays, super_capacity, capacity, order exact): the separated
# scene of test_grt.py:494-524 (128 particles on layers 0.3 apart; its super
# lists of 64 overflow, and keep the nearest, which no depth tie makes
# ambiguous there) and test_torch_grt.py's 512-particle scene under 32
# fanned bundles (no list overflows).
CASES = {
    "separated": (lambda: separated_scene(n=128, seed=21), separated_rays,
                  64, 128, True),
    "random": (lambda: random_scene(n=512, seed=5, spread=1.5), fanned_rays,
               448, 64, False),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    scene, rays, s_cap, cap, exact = CASES[request.param]
    args = cull_inputs(scene(), rays())
    return dict(name=request.param, args=args, s_cap=s_cap, cap=cap,
                exact=exact)


def resolved_lists(cand_local, counts, sup_idx, sup_of):
    """Each bundle's candidate particle ids, in list order."""
    cl, cn, si, so = map(npy, (cand_local, counts, sup_idx, sup_of))
    return [si[so[b]][cl[b, :cn[b]]] for b in range(cn.shape[0])]


def dense_lists(cand_idx, counts):
    ci, cn = npy(cand_idx), npy(counts)
    return [ci[b, :cn[b]] for b in range(cn.shape[0])]


def assert_lists(got, want, exact):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert sorted(g.tolist()) == sorted(w.tolist()), b
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f"bundle {b}")
    rep, ok = golden.lists_agree(got, want, golden.TRACE_FLIP_SHARE)
    assert ok and rep["flipped"] == 0, rep


def test_packed_cull_matches_jax(case):
    """bundle_candidates_twolevel_packed: counts, overflow, visibility and
    sup_of equal; the super lists (over their hits) and the resolved
    candidate lists hold JAX's sets, in JAX's order on the separated
    scene."""
    a = case["args"]
    j = J_PACKED(
        *map(jnp.asarray, a), 256, case["cap"],
        super_capacity=case["s_cap"])
    t = grt.bundle_candidates_twolevel_packed(
        *tt(*a), 256, case["cap"], super_capacity=case["s_cap"])
    jn, tn = [npy(x) for x in j], [npy(x) for x in t]
    np.testing.assert_array_equal(tn[1], jn[1])
    assert bool(tn[2]) == bool(jn[2]) == (case["name"] == "separated")
    np.testing.assert_array_equal(tn[3], jn[3])
    np.testing.assert_array_equal(tn[5], jn[5])
    assert tn[0].dtype == tn[4].dtype == tn[5].dtype == np.int32
    assert tn[0].shape == jn[0].shape and tn[4].shape == jn[4].shape
    assert_lists(resolved_lists(*t[:2], *t[4:]),
                 resolved_lists(*j[:2], *j[4:]), case["exact"])
    assert tn[1].sum() > 0


def test_packed_cull_sets_equal_exact_cull(case):
    """The packed cull's resolved lists hold the exact two-level cull's
    candidate sets, bundle for bundle."""
    a = tt(*case["args"])
    t = grt.bundle_candidates_twolevel_packed(
        *a, 256, case["cap"], super_capacity=case["s_cap"])
    e = grt.bundle_candidates_twolevel(*a, 256, case["cap"],
                                       super_capacity=case["s_cap"])
    np.testing.assert_array_equal(npy(t[1]), npy(e[1]))
    np.testing.assert_array_equal(npy(t[3]), npy(e[3]))
    assert_lists(resolved_lists(*t[:2], *t[4:]), dense_lists(e[0], e[1]),
                 case["exact"])


def test_packed_l1_matches_jax(case):
    """The packed_l1 branch of bundle_candidates_twolevel (level 1 sorted
    on packed keys, level 2 exact): JAX's sets and order (within
    lists_agree), and the exact cull's sets."""
    a = case["args"]
    kw = dict(super_capacity=case["s_cap"])
    j = J_TWOLEVEL(*map(jnp.asarray, a), 256,
                                        case["cap"], packed_l1=True, **kw)
    t = grt.bundle_candidates_twolevel(*tt(*a), 256, case["cap"],
                                       packed_l1=True, **kw)
    e = grt.bundle_candidates_twolevel(*tt(*a), 256, case["cap"], **kw)
    np.testing.assert_array_equal(npy(t[1]), npy(j[1]))
    assert bool(npy(t[2])) == bool(npy(j[2]))
    np.testing.assert_array_equal(npy(t[3]), npy(j[3]))
    assert_lists(dense_lists(t[0], t[1]), dense_lists(j[0], j[1]),
                 case["exact"])
    assert_lists(dense_lists(t[0], t[1]), dense_lists(e[0], e[1]),
                 case["exact"])


def test_resolve_packed_matches_flatten_of_resolved_lists(case):
    """resolve_packed on the flat layout of super-list positions equals the
    flat layout of the resolved lists: ids, valid, windows."""
    a = tt(*case["args"])
    cl, cn, _, _, sup_idx, sup_of = grt.bundle_candidates_twolevel_packed(
        *a, 256, case["cap"], super_capacity=case["s_cap"])
    cap_f = 64 * 128
    fl, valid, ws, we, ovf, wb = grt.flatten_candidates(cl, cn, cap_f)
    got = grt.resolve_packed(fl, valid, wb, sup_idx, sup_of)
    ids = torch.gather(sup_idx[sup_of.long()], 1,
                       torch.clamp(cl, max=sup_idx.shape[1] - 1).long())
    want = grt.flatten_candidates(ids.to(torch.int32), cn, cap_f)
    assert got.dtype == torch.int32 and not bool(ovf)
    assert torch.equal(got, want[0])
    for x, y in zip((valid, ws, we), want[1:4]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kw", [dict(packed_cull=True),
                                dict(packed_l1=True),
                                dict(packed_cull=True, packed_l1=True)])
def test_packed_traces_bit_equal_exact_trace(kw):
    """On the depth-separated scene (no quantization bucket holds two
    candidates of a ray) the packed traces composite the same rows in the
    same order as the exact cull: outputs, overflow, visibility and counts
    bit-equal (the JAX package's test_packed_cull_matches_exact)."""
    sc = tt(*separated_scene(n=128, seed=21))
    o, d = tt(*separated_rays())
    base = dict(candidate_capacity=128, super_capacity=64, order="bundle",
                sorted_passes=8, flat_capacity=4096)
    exact = grt.trace(*sc, o, d, **base)
    packed = grt.trace(*sc, o, d, **base, **kw)
    for f in ("rgb", "opacity", "depth", "transmittance", "hit_count",
              "overflow", "visibility", "counts"):
        assert torch.equal(getattr(packed, f), getattr(exact, f)), f
    assert float(exact.opacity.max()) > 0.1


def test_packed_l1_on_the_ray_route():
    """The ray route (order="ray") takes packed_l1, and ignores
    packed_cull as the JAX package does: the same frame as its exact
    cull."""
    sc = tt(*separated_scene(n=128, seed=21))
    o, d = tt(*separated_rays())
    base = dict(candidate_capacity=128, super_capacity=64, order="ray")
    exact = grt.trace(*sc, o, d, **base)
    for kw in (dict(packed_l1=True), dict(packed_cull=True)):
        got = grt.trace(*sc, o, d, **base, **kw)
        for f in ("rgb", "opacity", "depth", "visibility", "counts"):
            assert torch.equal(getattr(got, f), getattr(exact, f)), (kw, f)


def test_packed_trace_differentiable():
    """A packed fwd+bwd (the fused route's walked compaction): gradients
    equal the exact cull's on the separated scene, where the composited
    rows and their order are the same."""
    base = dict(candidate_capacity=128, super_capacity=64, order="bundle",
                sorted_passes=8, flat_capacity=4096, walk_capacity=2048)
    grads = []
    for kw in ({}, dict(packed_cull=True)):
        sc = [x.requires_grad_(True)
              for x in tt(*separated_scene(n=128, seed=21))]
        o, d = tt(*separated_rays())
        out = grt.trace(*sc, o, d, **base, **kw)
        (out.rgb.square().sum() + out.opacity.sum()).backward()
        grads.append([x.grad for x in sc])
    for ge, gp in zip(*grads):
        torch.testing.assert_close(gp, ge, rtol=1e-6, atol=1e-9)
    assert bool((grads[0][3] != 0).any())


@pytest.mark.parametrize("n,super_capacity,match", [
    ((1 << 20) + 1, 8192, "2\\^20"),
    ((1 << 18) + 2, (1 << 18) + 1, "2\\^18"),
])
def test_packed_cull_refuses_what_its_keys_cannot_hold(n, super_capacity,
                                                       match):
    """The JAX package's asserts (n <= 2^20, super lists <= 2^18) are
    ValueErrors here, raised before any work."""
    pos = torch.zeros((n, 3))
    o, d = tt(*separated_rays())
    with pytest.raises(ValueError, match=match):
        grt.bundle_candidates_twolevel_packed(
            pos, torch.ones(n), torch.ones(n, dtype=torch.bool), o, d, 256,
            128, super_capacity=super_capacity)


def test_packed_cull_reorders_as_jax_on_bench_grt_scene():
    """tools/bench_grt.py's 100k scene through the central 128x128 rays of
    its grid (64 bundles; chip_smoke.grt_bench_scene), where the lists are
    long: the port's packed lists are the JAX package's (within
    golden.lists_agree at TRACE_FLIP_SHARE: a cone-margin hit may flip, and
    a ulp of depth move a bucket), hold the port's exact cull's sets, and
    reorder the same share of its positions against the exact cull as the
    JAX package's do (quantized depth: the design, which is why chip_smoke
    measures the packed frames against the exact cull's instead of holding
    them to it)."""
    import chip_smoke
    cfg = chip_smoke.GRT_CONFIGS[0]
    params, o, d = chip_smoke.grt_bench_scene(cfg["n"], cfg["scales"], "cpu",
                                              crop=128)
    acts = chip_smoke.grt_acts(params)
    dn, active = grt._rays_unit(d)
    p, radius, valid, d_safe = grt._cull_inputs(acts[0], acts[2], acts[3],
                                                dn, active, 4, False)
    args = [npy(x) for x in (p, radius, valid, o, d_safe)]
    kw = dict(super_capacity=cfg["super_cap"])
    t = grt.bundle_candidates_twolevel_packed(*tt(*args), 256, cfg["cand"],
                                              **kw)
    j = J_PACKED(*map(jnp.asarray, args), 256,
                                               cfg["cand"], **kw)
    e = grt.bundle_candidates_twolevel(*tt(*args), 256, cfg["cand"], **kw)
    assert not bool(t[2]) and not bool(j[2]) and not bool(e[2])
    got, want = resolved_lists(*t[:2], *t[4:]), resolved_lists(*j[:2],
                                                                *j[4:])
    exact = dense_lists(e[0], e[1])
    rep, ok = golden.lists_agree(got, want, golden.TRACE_FLIP_SHARE)
    assert ok, rep
    for g, x in zip(got, exact):
        assert sorted(g.tolist()) == sorted(x.tolist())
    port, _ = golden.lists_agree(got, exact, 1.0)
    ref, _ = golden.lists_agree(want, exact, 1.0)
    assert port["candidates"] > 50_000
    assert 0.05 < port["reordered"] / port["candidates"] < 0.5
    assert abs(port["reordered"] - ref["reordered"]) <= rep["reordered"] \
        + 2 * rep["flipped"] + 2
