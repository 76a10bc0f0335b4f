"""The properties of B7's odd-even network and of its compositing orders
that the redesigned bundle compositor (csrc/bundle_trace_fwd.cu,
bundle_trace_bwd.cu) relies on, held on the plain versions
(ops/bundle_trace.py):

  * B7's keys (hit_t where alpha > 0, else 3.4e38), stopped after an odd
    and an even pass in a row that swap nothing (the kernel's stop), end
    with exactly the keys and rows of all `passes` passes;
  * an order byte's hit bit is set exactly where the sorted key is below
    3.4e38, and its other seven bits are the row at that position;
  * a backward that re-walks the forward's orders (what B8 does) gives
    bit for bit the gradients of a backward that sorts for itself.

Exact comparisons: the network only moves values, and both backwards run
the same arithmetic on the same permutation. Only threedgrut_torch is
imported."""
import numpy as np
import pytest
import torch

from threedgrut_torch import constants as C
from threedgrut_torch.ops import bundle_trace as bt
from threedgrut_torch.ops import tile_raster as tr
from threedgrut_torch.render import grt

CHUNK, PIX, BIG = bt.CHUNK, bt.PIX, bt.BIG
DEG = C.KERNEL_DEGREE_3DGRT
MIN_T = C.MIN_TRANSMITTANCE_3DGRT
F32_MAX = float(np.finfo(np.float32).max)


def b7_keys(kind: str, lanes: int = 8, seed: int = 0):
    """[lanes, CHUNK] keys in B7's form: rows without a hit at BIG,
    interleaved with hits. Kinds: hits in reverse order, runs of tied
    hit_t, random hit_t, and random with hits whose hit_t reaches BIG
    (BIG itself, the f32 maximum and +inf). Every other lane is sorted
    whole, and every fourth one pair swapped back (lanes that stop after
    two passes or a few)."""
    rng = np.random.default_rng(seed)
    key = np.full((lanes, CHUNK), BIG, np.float32)
    for b in range(lanes):
        hit = rng.random(CHUNK) < rng.uniform(0.2, 0.9)
        n = int(hit.sum())
        if kind == "reverse":
            v = np.linspace(9.0, 1.0, n)
        elif kind == "ties":
            v = np.repeat(rng.integers(0, 5, (n + 2) // 3), 3)[:n]
        elif kind == "random":
            v = rng.uniform(0.0, 10.0, n)
        else:
            v = rng.uniform(0.0, 10.0, n)
            v[rng.random(n) < 0.15] = rng.choice([BIG, F32_MAX, np.inf])
        key[b, hit] = v
        if b % 2 == 0:
            key[b] = np.sort(key[b])
            if b % 4 == 2:
                key[b, [0, 1]] = key[b, [1, 0]]
    return torch.tensor(key)


KINDS = ["reverse", "ties", "random", "at_big"]


@pytest.mark.parametrize("passes", [1, 2, 16, 70])
@pytest.mark.parametrize("kind", KINDS)
def test_b7_keys_two_quiet_passes_stop_is_exact(kind, passes):
    """Each lane run for the passes the kernel's network runs it
    (tile_raster._passes_run) ends where all `passes` passes end."""
    key = b7_keys(kind, seed=passes)
    pos = torch.arange(CHUNK).expand(key.shape)
    activity = []
    want_key, (want_rows,) = tr.oddeven_passes(key, [pos], passes, activity)
    run = tr._passes_run([a[:, None] for a in activity], passes)[:, 0]
    if passes >= 16:
        assert bool((run < passes).any())
    for b in range(key.shape[0]):
        k, (r,) = tr.oddeven_passes(key[b:b + 1], [pos[b:b + 1]],
                                    int(run[b]))
        assert torch.equal(k, want_key[b:b + 1])
        assert torch.equal(r, want_rows[b:b + 1])


@pytest.mark.parametrize("kind", KINDS)
def test_order_byte_hit_bit_is_key_below_big(kind):
    """order_words/order_bytes round trip: each byte is the row at its
    position, with HIT exactly where the sorted key is < BIG (ties with BIG
    and keys above it carry no hit)."""
    key = b7_keys(kind, lanes=4, seed=3)
    pos = torch.arange(CHUNK).expand(key.shape)
    key_s, (pos_s,) = tr.oddeven_passes(key, [pos], 16)
    key_s = key_s[..., None].expand(-1, -1, PIX)
    pos_s = pos_s[..., None].expand(-1, -1, PIX)
    words = bt.order_words(key_s, pos_s)
    assert words.dtype == torch.int32
    assert tuple(words.shape) == (4, CHUNK // 4, PIX)
    b = bt.order_bytes(words)
    assert torch.equal(b & (bt.HIT - 1), pos_s)
    assert torch.equal((b & bt.HIT) != 0, key_s < BIG)
    if kind == "at_big":
        assert bool(((key_s >= BIG) & (key_s < np.inf)).any())


def bundle_scene(n=240, seed=31, dz=0.004):
    """Tilted flat pancakes at shuffled near-equal depths (each ray's hits
    come out of the bundle's depth order over long spans) in two bundles of
    coherent rays: the compositor's inputs, two windows per bundle."""
    rng = np.random.default_rng(seed)
    z = 2.0 + dz * rng.permutation(n)
    pos = np.stack([rng.uniform(-0.25, 0.25, n), rng.uniform(-0.25, 0.25, n),
                    z], -1).astype(np.float32)
    t = np.where(np.arange(n) % 2 == 0, 0.9, -0.9)
    quat = np.stack([np.cos(t / 2), np.zeros(n), np.sin(t / 2),
                     np.zeros(n)], -1).astype(np.float32)
    scale = np.tile(np.array([[0.05, 0.05, 0.004]], np.float32), (n, 1))
    opa = rng.uniform(0.1, 0.4, n).astype(np.float32)
    feats = rng.uniform(-1.0, 1.0, (n, 16, 3)).astype(np.float32)
    feats[:, 1:] *= 0.1
    o = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (2 * PIX, 1))
    d = np.stack([rng.uniform(-0.05, 0.05, 2 * PIX),
                  rng.uniform(-0.05, 0.05, 2 * PIX),
                  np.ones(2 * PIX)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pos, quat, scale, opa, feats, o, d = (
        torch.tensor(x) for x in (pos, quat, scale, opa, feats, o, d))
    radius = grt.bounding_radius(scale, opa, DEG)
    ci, cn, ovf, _ = grt.bundle_candidates(
        pos, radius, opa >= C.MIN_ALPHA, grt.make_bundles(o, d, PIX), n)
    assert not bool(ovf) and int(cn.min()) > CHUNK
    fi, valid, ws, we, _, _ = grt.flatten_candidates(
        ci, cn, CHUNK * int((-(-cn // CHUNK)).sum()))
    data = grt.pack_rows64(pos, quat, scale, opa, feats)[fi.long()]
    data[:, 12] *= valid
    rays = torch.cat([o, d, torch.zeros(len(o), 1), torch.ones(len(o), 1)],
                     -1).reshape(-1, PIX, 8).transpose(1, 2).contiguous()
    return data, rays, ws, we


@pytest.fixture(scope="module")
def scene():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield bundle_scene()
    torch.set_num_threads(threads)


def edge_rays(rays, ws, we):
    """The scene's rays with a bound t_max on half of bundle 0's rays, an
    initial transmittance of 0.3 on bundle 1, and a third, empty bundle."""
    rays = rays.clone()
    rays[0, 6, :128] = 3.0
    rays[1, 7] = 0.3
    rays = torch.cat([rays, rays[:1]])
    ws = torch.cat([ws, ws[:1]])
    return rays, ws, torch.cat([we, ws[:1]])


@pytest.mark.parametrize("passes", [1, 2, 16, 70])
def test_forward_orders_hit_bits_are_the_sorted_keys(scene, passes):
    """The plain forward's orders of each bundle's first window: the rows of
    its network and HIT exactly where the sorted key is < BIG; the output
    is that of a forward that writes none."""
    data, rays, ws, we = scene
    args = (data, rays, ws, we, DEG, 3, MIN_T)
    order = bt.order_buffer(data)
    out = bt.bundle_composite_plain(*args, sorted_passes=passes, order=order)
    assert torch.equal(out, bt.bundle_composite_plain(
        *args, sorted_passes=passes))
    S = data.reshape(-1, CHUNK, 64)[ws.long()]
    _, _, _, _, _, _, pos_s, key_s = bt._window_weights(
        S, rays, rays[:, 7], DEG, MIN_T, C.MIN_KERNEL_RESPONSE, C.MIN_ALPHA,
        C.MAX_ALPHA, passes)
    b = bt.order_bytes(order[ws.long()])
    assert torch.equal(b & (bt.HIT - 1), pos_s)
    assert torch.equal((b & bt.HIT) != 0, key_s < BIG)
    assert bool((key_s < BIG).any()) and bool((key_s >= BIG).any())


@pytest.mark.parametrize("passes", [1, 2, 16, 70])
@pytest.mark.parametrize("edges", [False, True])
def test_backward_on_forward_orders_is_bitwise_the_sorting_one(scene,
                                                               passes,
                                                               edges):
    """bundle_composite_backward_plain re-walking the plain forward's
    orders equals it sorting for itself, bit for bit (also with t_max,
    an initial transmittance < 1 and an empty bundle)."""
    data, rays, ws, we = scene
    if edges:
        rays, ws, we = edge_rays(rays, ws, we)
    args = (data, rays, ws, we, DEG, 3, MIN_T)
    order = bt.order_buffer(data)
    out = bt.bundle_composite_plain(*args, sorted_passes=passes, order=order)
    g = torch.tensor(np.random.default_rng(passes).normal(
        size=out.shape).astype(np.float32))
    g[:, 6:] = 0.0
    bargs = (data, rays, ws, we, out, g, DEG, 3, MIN_T)
    want = bt.bundle_composite_backward_plain(*bargs, sorted_passes=passes)
    got = bt.bundle_composite_backward_plain(*bargs, sorted_passes=passes,
                                             order=order)
    assert torch.equal(got, want)
    assert int((got != 0).any(1).sum()) > 100
    if edges:
        assert float(out[2, [0, 1, 2, 3, 4, 6, 7]].abs().max()) == 0.0


def test_plain_versions_refuse_bad_orders(scene):
    data, rays, ws, we = scene
    args = (data, rays, ws, we, DEG, 3, MIN_T)
    with pytest.raises(ValueError):
        bt.bundle_composite_plain(*args, order=bt.order_buffer(data))
    with pytest.raises(ValueError):
        bt.bundle_composite_plain(*args, sorted_passes=16,
                                  order=bt.order_buffer(data)[1:])
    with pytest.raises(ValueError):
        bt.bundle_composite_plain(*args, sorted_passes=16,
                                  order=bt.order_buffer(data).float())


def test_forward_order_only_for_a_backward_on_the_card(scene):
    data, rays, _, _ = scene
    assert bt.forward_order(data, rays, 16, True) is None     # the CPU
    meta = torch.device("meta")
    d, r = data.to(meta), rays.to(meta)
    assert bt.forward_order(d, r, 0, True) is None
    assert bt.forward_order(d, r, 16, False) is None
    assert tuple(bt.forward_order(d, r, 16, True).shape) == (
        data.shape[0] // CHUNK, CHUNK // 4, PIX)
