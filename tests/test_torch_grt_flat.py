"""The flat 3DGRT cull and kernel B9: threedgrut_torch.render.grt's
bundle_candidates_twolevel_flat and ops/stream_compact against
threedgrut_tpu on the same numpy inputs.

Exact: the three legs of the flat cull (flat ids where valid, valid,
window ranges, overflow, visibility; the B9 leg per caller bundle), the
ID-order super lists under truncation, the plain B9 against the JAX kernel
in interpret mode (ids as integers, depths by value), and the port's flat
trace against its dense two-level trace (rgb, opacity, depth, hit counts,
visibility). Gradients of the two culls within rtol 5e-3, atol 5e-6 x max
(tests/test_grt.py's tolerance for the JAX package's own flat cull: the
same slot rows at other flat positions, summed per particle in another
order). A 3DGRT fwd+bwd run twice is bit-identical (the per-particle sums
are deterministic).

The JAX flat cull runs eagerly (its first call ~20 s, then ~2-10 s a leg)
and B9 in interpret mode (~6 s a case): each is called once, through
module fixtures.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_gut_reference import random_scene
from tests.test_torch_compaction_passes import compact_streams_passes
from tests.test_torch_grt import DEG, npy, tt
from tests.test_torch_grt import single_thread  # noqa: F401 (autouse)
from threedgrut_tpu import constants as JC
from threedgrut_tpu.ops.pallas import stream_compact as jsc
from threedgrut_tpu.render import grt as jgrt
from threedgrut_torch import golden
from threedgrut_torch.ops import fused_raster, stream_compact
from threedgrut_torch.render import grt

CHUNK = 128
LEGS = {"expand_sort": {}, "member_sort": dict(expand_sort=False),
        "compact_kernel": dict(compact_kernel=True)}


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch on one intra-op thread for the module (as
    tests/test_torch_grt.py): under the parallel run's load, the plain
    versions' many small ops stall on an 8-thread pool's barriers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flat_rays(nb=32, seed=24):
    """tests/test_grt.py's flat-cull rays: nb bundles of 256 from (0, 0,
    -1), fanned on a 6-wide grid."""
    rng = np.random.default_rng(seed)
    os_, ds_ = [], []
    for b in range(nb):
        os_.append(np.tile(np.array([0.0, 0.0, -1.0], np.float32), (256, 1)))
        d = np.stack([0.03 * (b % 6) + rng.uniform(-0.2, 0.2, 256),
                      0.03 * (b // 6) + rng.uniform(-0.2, 0.2, 256),
                      np.ones(256)], -1).astype(np.float32)
        ds_.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return np.concatenate(os_), np.concatenate(ds_)


@pytest.fixture(scope="module")
def flat_case():
    """tests/test_grt.py's 96-particle, 32-bundle flat-cull scene: its
    numpy cull inputs and JAX's bundle_candidates_twolevel_flat on each
    leg (capacity and super capacity 192, flat capacity 8192)."""
    pos, quat, scale, opa, feats = map(np.asarray, random_scene(n=96,
                                                                seed=23))
    o, d = flat_rays()
    radius = np.asarray(jgrt.bounding_radius(jnp.asarray(scale),
                                             jnp.asarray(opa), DEG))
    inputs = (pos, radius, opa >= JC.MIN_ALPHA, o, d)
    kw = dict(capacity=192, super_capacity=192, flat_capacity=8192)
    jax_out = {
        leg: [npy(x) for x in jgrt.bundle_candidates_twolevel_flat(
            *map(jnp.asarray, inputs), 256, **kw, **lkw)]
        for leg, lkw in LEGS.items()}
    return dict(scene=(pos, quat, scale, opa, feats), inputs=inputs, kw=kw,
                jax=jax_out)


def bundle_lists(out):
    """Each bundle's candidate ids, through its windows and `valid`."""
    return golden.bundle_lists(*out[:4])


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_flat_cull_matches_jax(flat_case, leg):
    """Each leg of the port's flat cull equals JAX's: window ranges,
    overflow, visibility and per-bundle candidate sequences exactly; the
    flat ids and valid mask as arrays too on the two sort legs (the B9
    leg's arrangement is compared per caller bundle, as
    tests/test_grt.py's compact-kernel test does)."""
    want = flat_case["jax"][leg]
    got = [npy(x) for x in grt.bundle_candidates_twolevel_flat(
        *tt(*flat_case["inputs"]), 256, **flat_case["kw"], **LEGS[leg])]
    assert got[0].dtype == np.int32 and got[1].dtype == bool
    for k in (2, 3, 5):
        np.testing.assert_array_equal(got[k], want[k])
    assert not bool(got[4]) and not bool(want[4])
    lists_g, lists_w = bundle_lists(got), bundle_lists(want)
    for b, (g, w) in enumerate(zip(lists_g, lists_w)):
        np.testing.assert_array_equal(g, w, err_msg=f"bundle {b}")
    assert sum(len(x) for x in lists_w) > 1000
    if leg != "compact_kernel":
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0][want[1]], want[0][want[1]])


def test_flat_legs_match_dense_twolevel(flat_case):
    """The three legs give each caller bundle the dense two-level cull's
    candidates in its order (no overflow here)."""
    inputs = tt(*flat_case["inputs"])
    kw = flat_case["kw"]
    ci, counts, ovf, vis = grt.bundle_candidates_twolevel(
        *inputs, 256, kw["capacity"], super_capacity=kw["super_capacity"])
    for leg, lkw in LEGS.items():
        out = [npy(x) for x in grt.bundle_candidates_twolevel_flat(
            *inputs, 256, **kw, **lkw)]
        assert bool(out[4]) == bool(ovf)
        np.testing.assert_array_equal(out[5], npy(vis))
        for b, got in enumerate(bundle_lists(out)):
            np.testing.assert_array_equal(
                got, npy(ci[b, :int(counts[b])]), err_msg=f"{leg} {b}")


def b9_case(seed, wins_per_seg, density, truncate):
    """Random B9 inputs: gid [nws*128] int32, bits, depth [nws, 16, 128],
    segment windows, (segment, stream) bases from CHUNK-padded counts and
    limits. `density` per segment. `truncate`: limits one window short of
    each stream's padded count and a flat capacity two windows below the
    total (the last streams' bases lie past it)."""
    rng = np.random.default_rng(seed)
    nws = sum(wins_per_seg)
    gid = rng.integers(0, 1 << 20, nws * CHUNK).astype(np.int32)
    seg_ws = np.cumsum([0] + list(wins_per_seg))[:-1].astype(np.int32)
    seg_we = np.cumsum(wins_per_seg).astype(np.int32)
    dens = np.repeat(np.asarray(density), np.asarray(wins_per_seg) * CHUNK)
    bits = np.zeros(nws * CHUNK, np.int64)
    for s in range(16):
        bits |= (rng.random(nws * CHUNK) < dens).astype(np.int64) << s
    depth = rng.uniform(1.0, 9.0, (nws, 16, CHUNK)).astype(np.float32)
    counts = np.array([[((bits[a * CHUNK:b * CHUNK] >> s) & 1).sum()
                        for s in range(16)]
                       for a, b in zip(seg_ws, seg_we)]).reshape(-1)
    pad_w = -(-counts // CHUNK)
    base_w = (np.cumsum(pad_w) - pad_w).astype(np.int32)
    lim_w = base_w + pad_w
    total_w = int(pad_w.sum())
    cap = (total_w + 2) * CHUNK
    if truncate:
        lim_w = base_w + np.maximum(pad_w - 1, 0)
        cap = (total_w - 2) * CHUNK
    return (gid, bits.astype(np.int32), depth, seg_ws, seg_we, base_w,
            lim_w.astype(np.int32), cap)


B9_CASES = {
    # Dense (many windows a stream), empty, sparse (residual-only streams)
    # and medium segments.
    "dense_sparse": (1, (4, 0, 3, 1), (0.9, 0.5, 0.02, 0.3), False),
    "truncated": (3, (3, 3, 2), (0.5, 0.6, 0.5), True),
}


@pytest.fixture(scope="module", params=sorted(B9_CASES))
def b9(request):
    """A B9 case and JAX's compact_streams on it (interpret mode)."""
    case = b9_case(*B9_CASES[request.param])
    gid, bits, depth, seg_ws, seg_we, base_w, lim_w, cap = case
    nws = depth.shape[0]
    vals = np.zeros((nws, 24, CHUNK), np.float32)
    vals[:, 0] = gid.reshape(nws, CHUNK)
    vals[:, 1] = bits.reshape(nws, CHUNK)
    vals[:, 2:18] = depth
    out = np.asarray(jsc.compact_streams(
        jnp.asarray(vals), jnp.asarray(seg_ws), jnp.asarray(seg_we),
        jnp.asarray(base_w), cap, 16, lim_w=jnp.asarray(lim_w)))
    return case, out


def test_compact_streams_plain_matches_jax(b9):
    """The plain B9 equals the JAX kernel bit for bit: ids as integers,
    depths (3.4e38 where nothing was written) by value; the truncated case
    keeps each stream's first hits."""
    case, want = b9
    gid, dep = stream_compact.compact_streams(
        *tt(*case[:-1]), case[-1])
    assert gid.dtype == torch.int32 and gid.shape == (case[-1],)
    np.testing.assert_array_equal(npy(gid), want[0].astype(np.int64))
    np.testing.assert_array_equal(npy(dep), want[1])
    written = int((npy(dep) < stream_compact.FILL_DEPTH).sum())
    assert 0 < written < case[-1]


def test_compact_streams_passes_match_jax(b9):
    """The plain mirror of B9's kernel (count, scan, write over windows)
    equals the JAX kernel bit for bit on the same cases."""
    case, want = b9
    gid, dep = compact_streams_passes(*tt(*case[:-1]), case[-1])
    np.testing.assert_array_equal(npy(gid), want[0].astype(np.int64))
    np.testing.assert_array_equal(npy(dep), want[1])


def test_super_lists_expand_matches_jax():
    """ID-order super lists under per-super truncation (tests/test_grt.py's
    case: 2 supers of ~48 hits each, s_cap 16): all six outputs equal
    JAX's, each super keeps its 16 lowest ids, and the caller's flag
    (counts1 > s_cap) is set by the flat cull."""
    rng = np.random.default_rng(41)
    ns, n, s_cap, capS = 2, 96, 16, 256
    hit1 = rng.random((ns, n)) < 0.5
    counts1 = hit1.sum(1).astype(np.int32)
    assert counts1.max() > s_cap
    want = [npy(x) for x in jgrt._super_lists_expand(
        jnp.asarray(hit1), jnp.asarray(counts1), s_cap, capS)]
    got = [npy(x) for x in grt._super_lists_expand(
        *tt(hit1, counts1), s_cap, capS)]
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"output {k}")
    fs, vs, ws, we = got[:4]
    for s in range(ns):
        kept = fs[ws[s] * CHUNK:we[s] * CHUNK][vs[ws[s] * CHUNK:we[s] * CHUNK]]
        np.testing.assert_array_equal(kept, np.nonzero(hit1[s])[0][:s_cap])


def exact_capacity_inputs():
    """One super of two windows and 16 members; member 0 hits slots
    0-199, member 1 slots 0-99, the rest nothing: the layout is 256 + 128
    rows, exactly a flat capacity of 384, followed by 14 empty bundles."""
    rng = np.random.default_rng(5)
    hits = np.zeros((16, 256), bool)                  # [member, slot]
    hits[0, :200] = True
    hits[1, :100] = True
    cols = rng.uniform(1, 5, (16, 256)).astype(np.float32)

    def windows(x):                                   # -> [nws, m, 128]
        return np.ascontiguousarray(
            x.reshape(16, 2, CHUNK).transpose(1, 0, 2))
    hit2, t_ax = windows(hits), windows(cols)
    counts2 = np.zeros((1, 16), np.int64)
    counts2[0, :2] = (200, 100)
    flat_sup = np.arange(256, dtype=np.int32) + 1000
    return hit2, t_ax, counts2, flat_sup


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_flat_layout_exact_capacity_keeps_true_rows(leg):
    """ROADMAP C3: with the flat total exactly at flat_capacity and
    trailing empty bundles, every leg marks only the 300 true rows valid,
    each bundle's ids in depth order. JAX's _flat_pairs_expand_sort gives
    the last window the empty bundles' valid end (128 valid rows there
    instead of 100)."""
    hit2, t_ax, counts2, flat_sup = exact_capacity_inputs()
    hit2_t, t_ax_t, counts2_t, flat_sup_t = tt(hit2, t_ax, counts2, flat_sup)
    win_sup = torch.zeros(2, dtype=torch.int32)
    ws, we = torch.tensor([0], dtype=torch.int32), torch.tensor(
        [2], dtype=torch.int32)
    if leg == "expand_sort":
        out = grt._flat_pairs_expand_sort(flat_sup_t, hit2_t, t_ax_t,
                                          win_sup, counts2_t, 256, 384)
    elif leg == "member_sort":
        out = grt._flat_member_sort(flat_sup_t, hit2_t, t_ax_t, win_sup, ws,
                                    counts2_t, 256, 384)
    else:
        out = grt._flat_compact(flat_sup_t, hit2_t, t_ax_t, ws, we,
                                counts2_t, 256, 384)
    fi, valid, wst, wen, ovf = map(npy, out)
    assert not bool(ovf) and valid.sum() == 300
    np.testing.assert_array_equal(np.nonzero(valid)[0], np.concatenate(
        [np.arange(200), np.arange(256, 356)]))
    cols = t_ax.transpose(1, 0, 2).reshape(16, 256)
    for b, (lo, n) in enumerate(((0, 200), (256, 100))):
        order = np.argsort(cols[b, :n], kind="stable")
        np.testing.assert_array_equal(fi[lo:lo + n], flat_sup[order])
    np.testing.assert_array_equal(wst[:3], [0, 2, 3])
    np.testing.assert_array_equal(wen[:3], [2, 3, 3])
    if leg == "expand_sort":
        # (member, super) order is the caller order here: one super.
        hit2_j = jnp.asarray(hit2.transpose(0, 2, 1))
        cum = np.concatenate([np.zeros((1, 16), np.int32), np.cumsum(
            hit2.sum(-1), 0).astype(np.int32)])
        t_ax_j = jnp.asarray(t_ax.transpose(0, 2, 1))
        jout = jgrt._flat_pairs_expand_sort(
            jnp.asarray(flat_sup), hit2_j, t_ax_j,
            jnp.zeros(2, jnp.int32), jnp.zeros(1, jnp.int32), jnp.asarray(cum),
            jnp.asarray(counts2.astype(np.int32)), 256, 384, 16, 1, 16,
            jnp.arange(16, dtype=jnp.int32), jnp.asarray(False),
            jnp.zeros(4, bool))
        jvalid = npy(jout[1])
        assert jvalid[256:].sum() == CHUNK      # the divergence
        np.testing.assert_array_equal(npy(jout[0])[valid], fi[valid])


def trace_inputs(flat_case):
    pos, quat, scale, opa, feats = tt(*flat_case["scene"])
    o, d = tt(*flat_case["inputs"][3:])
    # two_level_above=0: the two-level culls at 96 particles.
    kw = dict(candidate_capacity=128, super_capacity=128, sorted_passes=8,
              flat_capacity=8192, two_level_above=0)
    return (pos, quat, scale, opa, feats, o, d), kw


def fwd_bwd(scene, kw, **more):
    """trace + loss sum(rgb^2) + sum(opacity); gradients of all five
    tensors."""
    xs = [x.clone().requires_grad_(True) for x in scene[:5]]
    out = grt.trace(*xs, *scene[5:], **kw, **more)
    loss = (out.rgb ** 2).sum() + out.opacity.sum()
    return out, torch.autograd.grad(loss, xs)


@pytest.mark.parametrize("walk_capacity", [None, 4096])
def test_flat_trace_matches_dense_trace(flat_case, walk_capacity):
    """trace(flat_cull=True) equals trace(flat_cull=False) bit for bit in
    every output, on the gather route and the walked route
    (fused_raster.composite_bundles); gradients within rtol 5e-3, atol
    5e-6 x max."""
    scene, kw = trace_inputs(flat_case)
    dense, g0 = fwd_bwd(scene, kw, walk_capacity=walk_capacity)
    flat, g1 = fwd_bwd(scene, kw, walk_capacity=walk_capacity,
                       flat_cull=True, super_flat_capacity=4096)
    for f in ("rgb", "opacity", "depth", "transmittance", "hit_count",
              "visibility", "overflow"):
        assert torch.equal(getattr(flat, f), getattr(dense, f)), f
    assert not bool(flat.overflow) and float(flat.opacity.detach().max()) > 0.5
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(npy(a), npy(b), rtol=5e-3,
                                   atol=5e-6 * float(b.abs().max()))


@pytest.mark.parametrize("flat_cull", [False, True])
def test_grt_fwd_bwd_repeats_bit_for_bit(flat_case, flat_cull):
    """ROADMAP P2: the same 3DGRT fwd+bwd (plain B7 and B8, the walked
    route's compact branch) run twice on the same inputs gives the same
    gradients bit for bit, on the dense and the flat cull."""
    scene, kw = trace_inputs(flat_case)
    runs = []
    for _ in range(2):
        fused_raster.branches.clear()
        out, grads = fwd_bwd(scene, kw, walk_capacity=4096,
                             flat_cull=flat_cull)
        assert dict(fused_raster.branches) == {"3dgrt.compact": 1}
        runs.append(grads)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
        assert bool((a != 0).any())


def test_bench_grt_100k_super_flat_total():
    """tools/bench_grt.py's 100k scene (its seeded draws in its order,
    512x512 jittered rays from (0, 0, -4)): the JAX package's level-1
    super counts have the CHUNK-padded total 521,984, the super flat total
    chip_smoke holds the card to (bench_grt's comment records 913,408 for
    its probe, which its own probe code does not give for this scene), and
    the port's are within 0.1% of it."""
    n, side = 100_000, 512
    rng = np.random.default_rng(0)
    pos = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    rng.normal(size=(n, 4))
    scale = np.exp(rng.uniform(np.log(0.01), np.log(0.05),
                               (n, 3))).astype(np.float32)
    rng.uniform(-1, 1, (n, 3))
    px = (np.arange(side) + 0.5) / side * 0.8 - 0.4
    gx, gy = np.meshgrid(px, px, indexing="xy")
    jit = rng.uniform(-0.4 / side, 0.4 / side, (2,) + gx.shape)
    d = np.stack([gx + jit[0], gy + jit[1], np.ones_like(gx)],
                 -1).astype(np.float32)
    t = side // 16
    d = d.reshape(t, 16, t, 16, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = np.tile(np.array([[0.0, 0.0, -4.0]], np.float32), (side * side, 1))
    opa = np.full((n,), 0.5, np.float32)
    radius = np.asarray(jgrt.bounding_radius(jnp.asarray(scale),
                                             jnp.asarray(opa), DEG))
    counts = []
    for g, (p, r, od, dd) in ((jgrt, map(jnp.asarray, (pos, radius, o, d))),
                              (grt, tt(pos, radius, o, d))):
        b = g.make_bundles(od, dd, 256)
        sup = g.make_super_bundles(b, g.bundle_morton_order(b), 16)
        hit1 = g._cone_hit(p, r, jnp.asarray(opa >= JC.MIN_ALPHA)
                           if g is jgrt else tt(opa >= JC.MIN_ALPHA)[0],
                           sup)[0]
        counts.append(npy(hit1).sum(1))
    totals = [int((-(-c // CHUNK) * CHUNK).sum()) for c in counts]
    assert totals[0] == 521_984 and int(counts[0].max()) == 22_092
    # Cone-margin particles (ROADMAP, tolerated divergences) may move a
    # count by a few; chip_smoke's 0.1% holds.
    assert np.abs(counts[1] - counts[0]).max() <= 2
    assert abs(totals[1] - totals[0]) <= 1e-3 * totals[0]
