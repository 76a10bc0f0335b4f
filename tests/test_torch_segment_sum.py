"""Kernels B5 and B6 (the per-particle segment sums) and the scatter-free
gradient of the slot gather, against the JAX package on the same numpy
inputs (CPU; the JAX Pallas kernels in interpret mode, as
tests/test_binning.py and tests/test_sorted_gather.py run them).

Tolerances and why: the plain versions sum in f64 and round once, the JAX
kernels sum f32 on a (simulated) matrix unit and the JAX CPU path by a
cumsum difference, so sums of up to 600 N(0, 1) rows agree to atol 1e-4;
bf16 cotangents round identically on both sides (to nearest even), so the
bf16 legs keep the same tolerance. Dropped rows (tail ids, ids >= n) and
empty segments are exact zeros.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedgrut_tpu.ops import fused_raster as jfr
from threedgrut_tpu.ops import sorted_gather as jsg
from threedgrut_tpu.ops.pallas import segment_sum as jss
from threedgrut_torch.ops import fused_raster as tfr
from threedgrut_torch.ops import segment_sum as tss
from threedgrut_torch.ops import sorted_gather as tsg


def b5_case(seed=0, n=512, cap=4096, f=16):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 7, n)
    counts[5] = 0
    counts[100:110] = 0
    counts[200] = 600          # a segment over several 256-slot windows
    ends = np.cumsum(counts).astype(np.int32)
    total = int(ends[-1])
    g = np.zeros((cap, f), np.float32)
    g[:total] = rng.normal(size=(total, f)).astype(np.float32)
    g[total:] = 100.0          # junk past the real slots is never read
    return g, ends, total


@pytest.mark.parametrize("overflow", [False, True])
def test_plain_b5_matches_pallas_interpret(overflow):
    g, ends, total = b5_case()
    if overflow:
        ends = ends.copy()
        ends[-256:] += 700      # past the capacity: clamped to it
        g[total:] = np.random.default_rng(1).normal(
            size=g[total:].shape).astype(np.float32)
    want = np.asarray(jss.segment_sum_rows(jnp.asarray(g.T.copy()),
                                           jnp.asarray(ends))).T
    got = tss.segment_sum_rows(torch.tensor(g), torch.tensor(ends)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert not got[5].any() and not got[100:110].any()


def test_plain_b6_matches_pallas_interpret():
    """Sorted ids with gaps, duplicates and filler rows of id >= n."""
    rng = np.random.default_rng(7)
    n, cap, f = 512, 1024, 16
    ids = np.sort(rng.choice(np.r_[rng.integers(0, n, 200),
                                   np.full(56, n), np.full(8, n + 3)],
                             cap)).astype(np.int32)
    g = rng.normal(size=(cap, f)).astype(np.float32)
    want = np.asarray(jss.segment_sum_rows_by_ids(
        jnp.asarray(g.T.copy()), jnp.asarray(ids), n)).T
    got = tss.segment_sum_rows_by_ids(torch.tensor(g), torch.tensor(ids),
                                      n).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    absent = np.setdiff1d(np.arange(n), ids)
    assert len(absent) > 0 and not got[absent].any()


def gather_case(seed=0, n=20, cap=64, overflow=False):
    """Expansion-order particle per slot, tail slots of id n, shuffled into
    a 'sorted' order (tests/test_sorted_gather.py's case)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 5, n).astype(np.int32)
    ends = np.cumsum(counts).astype(np.int32)
    total = int(ends[-1])
    if overflow:
        cap = max(8, total - 6)
    pidx = np.full(cap, n, np.int32)
    for p in range(n):
        s, e = ends[p] - counts[p], min(ends[p], cap)
        pidx[s:min(e, cap)] = p
    perm = rng.permutation(cap)
    sorted_idx = pidx[perm]
    packed = rng.normal(size=(n, 16)).astype(np.float32)
    g = rng.normal(size=(cap, 16)).astype(np.float32)
    return packed, sorted_idx, ends, counts, g


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("grad_precision", ["f32", "bf16"])
def test_sorted_gather_backward_matches_jax(overflow, grad_precision):
    """The port's autograd backward of sorted_gather (stable sort + B5)
    against jax.vjp of the JAX sorted_gather, tail rows (id n) carrying
    nonzero cotangents that both must drop; and the forward gather."""
    for seed in range(3):
        packed, sorted_idx, ends, counts, g = gather_case(seed,
                                                          overflow=overflow)
        out_j, vjp = jax.vjp(
            lambda p: jsg.sorted_gather(p, jnp.asarray(sorted_idx),
                                        jnp.asarray(ends),
                                        jnp.asarray(counts), grad_precision),
            jnp.asarray(packed))
        want = np.asarray(vjp(jnp.asarray(g))[0])
        p = torch.tensor(packed, requires_grad=True)
        out = tsg.sorted_gather(p, torch.tensor(sorted_idx),
                                torch.tensor(ends), grad_precision)
        assert np.array_equal(out.detach().numpy(), np.asarray(out_j))
        out.backward(torch.tensor(g))
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=1e-4)
        # The tail rows' cotangents went nowhere: the last particle's
        # gradient is the sum of its own slots only.
        last = len(packed) - 1
        own = sorted_idx == last
        ref = g[own].astype(np.float64).sum(0)
        if grad_precision == "bf16":
            ref = torch.tensor(g[own]).to(torch.bfloat16).double().sum(0)
        np.testing.assert_allclose(p.grad.numpy()[last], ref, rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("grad_precision", ["f32", "bf16"])
def test_unsort_segment_sum_by_ids_matches_jax(grad_precision):
    """The compacted leg (ends=None -> B6) against JAX's unsort_segment_sum
    on a row subset with filler ids n."""
    rng = np.random.default_rng(3)
    n, m = 300, 2048
    ids = rng.integers(0, n + 1, m).astype(np.int32)     # id n: filler
    g = rng.normal(size=(m, 16)).astype(np.float32)
    want = np.asarray(jsg.unsort_segment_sum(
        jnp.asarray(ids), [jnp.asarray(g[:, i]) for i in range(16)], n,
        ends=None, grad_precision=grad_precision))
    got = tsg.unsort_segment_sum(torch.tensor(ids), torch.tensor(g), n,
                                 grad_precision=grad_precision).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_walked_window_mask_matches_jax():
    """Union of per-tile walked windows from row 7, tiles sharing boundary
    windows, empty tiles and tiles that walked nothing."""
    rng = np.random.default_rng(11)
    nt, nw = 40, 64
    sizes = rng.integers(0, 400, nt)
    sizes[[3, 17]] = 0
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    starts = np.minimum(starts, nw * 128)
    walked = np.minimum(rng.integers(0, 300, nt), sizes)
    out = np.zeros((nt, 8, 256), np.float32)
    out[:, 7, :] = walked[:, None]
    wm_j, cnt_j = jfr.walked_window_mask(jnp.asarray(out),
                                         jnp.asarray(starts), nw)
    wm_t, cnt_t = tfr.walked_window_mask(torch.tensor(out),
                                         torch.tensor(starts), nw)
    assert np.array_equal(wm_t.numpy(), np.asarray(wm_j))
    assert int(cnt_t) == int(cnt_j) and 0 < int(cnt_t) < nw
