"""The index logic of B6's and B9's kernels, through plain mirrors of
their passes kept here, on the CPU (no JAX): B6's first pass
(`segment_starts`, each particle's first row) against torch.searchsorted
and walked into the host's sequential sums, and B9's three passes
(`window_counts`, `window_places`, `window_write`) against
`compact_streams_plain`, on the edge cases that
tests/test_torch_kernels_cuda.py runs on the card. All exact: the mirrors
compute integer placements. (The B9 mirror against JAX's kernel is
tests/test_torch_grt_flat.py's, on its interpret-mode fixture.)
"""
from typing import Tuple

import numpy as np
import pytest
import torch

from tests.test_torch_kernels_cuda import b6_ids, b9_case, b9_edge_case
from threedgrut_torch.ops import segment_sum, stream_compact

CHUNK = stream_compact.CHUNK
SKIP = 2 ** 31 - 1      # a window's first slot for a stream it writes none of


def segment_starts(ids_sorted: torch.Tensor, n: int) -> torch.Tensor:
    """B6's first pass: [n + 1] int32 starts, starts[p] the first row whose
    id is >= p (m where there is none), so particle p's rows are
    [starts[p], starts[p + 1]). As the kernel computes it: row boundary r
    in [0, m] (between ids[r - 1], -1 at r = 0, and ids[r], n at r = m,
    both clamped to [-1, n]) is the start of every p in between."""
    ids = ids_sorted.to(torch.int64)
    prev = torch.cat([ids.new_full((1,), -1), ids]).clamp(-1, n)
    cur = torch.cat([ids, ids.new_full((1,), n)]).clamp(-1, n)
    runs = (cur - prev).clamp(min=0)
    rows = torch.arange(ids.shape[0] + 1, dtype=torch.int32)
    return torch.repeat_interleave(rows, runs)


def window_counts(bits: torch.Tensor, n_streams: int) -> torch.Tensor:
    """B9's pass 1: [nws, n_streams] int32, each stream's hits in each
    window."""
    b = bits.reshape(-1, CHUNK).to(torch.int64)
    streams = torch.arange(n_streams)
    return ((b[:, None, :] >> streams[None, :, None]) & 1).sum(2).to(
        torch.int32)


def window_places(counts, seg_ws, seg_we, base_w, lim_w,
                  flat_capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B9's pass 2: per window and stream (o = segment * n_streams +
    stream), the first output slot, base_w[o] * 128 plus the exclusive
    cumsum of the stream's counts over the segment's earlier windows, and
    the limit min(lim_w[o], flat_capacity / 128) * 128 ([nws, n_streams]
    int64 each). A window without a hit of the stream, whose first slot is
    at the limit already, or in no segment gets the first slot SKIP."""
    nws, n_streams = counts.shape
    first = torch.full((nws, n_streams), SKIP, dtype=torch.int64)
    limit = torch.zeros((nws, n_streams), dtype=torch.int64)
    cap_w = flat_capacity // CHUNK
    for sp, (w0, w1) in enumerate(zip(seg_ws.tolist(), seg_we.tolist())):
        w1 = min(w1, nws)
        if w1 <= w0:
            continue
        o = slice(sp * n_streams, (sp + 1) * n_streams)
        c = counts[w0:w1].to(torch.int64)
        at = base_w[o].to(torch.int64) * CHUNK + torch.cumsum(c, 0) - c
        hi = torch.clamp(lim_w[o].to(torch.int64), max=cap_w) * CHUNK
        limit[w0:w1] = hi.clamp(min=0)
        first[w0:w1] = torch.where((c > 0) & (at < hi), at, SKIP)
    return first, limit


def window_write(gid, bits, depth, first, limit, flat_capacity: int):
    """B9's pass 3: hit j of stream s in window w goes to first[w, s] plus
    its rank among the window's hits of s, iff that lies below
    limit[w, s]."""
    nws, n_streams = depth.shape[0], depth.shape[1]
    out_gid = torch.zeros(flat_capacity, dtype=torch.int32)
    out_dep = torch.full((flat_capacity,), stream_compact.FILL_DEPTH,
                         dtype=torch.float32)
    streams = torch.arange(n_streams)
    sel = ((bits.reshape(nws, 1, CHUNK).to(torch.int64)
            >> streams[None, :, None]) & 1).bool()         # [nws, S, 128]
    dst = first[:, :, None] + torch.cumsum(sel, 2) - 1
    w, s, j = (sel & (dst < limit[:, :, None])).nonzero(as_tuple=True)
    d = dst[w, s, j]
    out_gid[d] = gid.reshape(nws, CHUNK)[w, j]
    out_dep[d] = depth[w, s, j]
    return out_gid, out_dep


def compact_streams_passes(gid, bits, depth, seg_ws, seg_we, base_w, lim_w,
                           flat_capacity: int):
    """The kernel's three passes chained, on CPU tensors: equal to
    compact_streams_plain, and like it refusing overlapping segments."""
    stream_compact.check_disjoint(seg_ws, seg_we)
    counts = window_counts(bits, depth.shape[1])
    first, limit = window_places(counts, seg_ws, seg_we, base_w, lim_w,
                                 flat_capacity)
    return window_write(gid, bits, depth, first, limit, flat_capacity)


B6_CASES = ["gaps", "one_particle", "long", "empty"]


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch on one intra-op thread, as in tests/test_torch_live_rows.py:
    under the parallel test run's load many small ops stall a larger
    intra-op pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", B6_CASES)
def test_segment_starts_are_lower_bounds(case):
    """starts[p] = the first row whose id is >= p, for every p <= n."""
    n = 2000
    ids = torch.tensor(b6_ids(case, n, np.random.default_rng(len(case))))
    got = segment_starts(ids, n)
    want = torch.searchsorted(ids, torch.arange(n + 1, dtype=torch.int32))
    assert got.dtype == torch.int32 and got.shape == (n + 1,)
    assert torch.equal(got, want.to(torch.int32))


def test_segment_starts_of_unclamped_ids():
    """Ids past n and a gap before the first id: the boundaries clamp to
    [-1, n], so every entry has exactly one row boundary."""
    ids = torch.tensor([3, 3, 7, 9, 9, 12, 40], dtype=torch.int32)
    got = segment_starts(ids, 10)
    assert got.tolist() == [0, 0, 0, 0, 2, 2, 2, 2, 3, 3, 5]


@pytest.mark.parametrize("case", B6_CASES)
def test_segments_from_starts_give_the_plain_sums(case):
    """Walking [starts[p], starts[p + 1]) in row order in float32 stays
    within segment_sum.f32_sum_bound of the plain B6 (an f64 sum rounded
    once), with the same particles nonzero; rows with id >= n are read by
    no segment."""
    n = 2000
    rng = np.random.default_rng(7 + len(case))
    ids = torch.tensor(b6_ids(case, n, rng))
    g = torch.tensor(rng.normal(size=(ids.shape[0], 16)).astype(np.float32))
    starts = segment_starts(ids, n)
    assert int(starts[-1]) == int((ids < n).sum())
    rows, st = g.numpy(), starts.tolist()
    walked = np.zeros((n, 16), np.float32)
    for p in range(n):
        for r in range(st[p], st[p + 1]):
            walked[p] = walked[p] + rows[r]
    walked = torch.tensor(walked)
    plain = segment_sum.segment_sum_rows_by_ids_plain(g, ids, n)
    lengths = (starts[1:] - starts[:-1]).to(torch.int64)
    bound = segment_sum.f32_sum_bound(
        segment_sum.segment_sum_rows_by_ids_plain(g.abs(), ids, n), lengths,
        plain)
    assert bool(((walked - plain).abs() <= bound).all())
    assert torch.equal((walked != 0).any(1), lengths > 0)


def b9_inputs(name):
    if name.startswith("edge"):
        return b9_edge_case("cpu", int(name[-1]))
    return b9_case("cpu", 7 + (name == "truncated"), name == "truncated")


B9_NAMES = ["edge3", "edge4", "full", "truncated"]


@pytest.mark.parametrize("name", B9_NAMES)
def test_compact_streams_passes_match_plain(name):
    """The three passes give compact_streams_plain's output bit for bit:
    empty and one-window segments, windows in no segment, an all-hit
    window, a stream without a hit, limits inside a window, a flat
    capacity below the limits."""
    args = b9_inputs(name)
    want = stream_compact.compact_streams_plain(*args)
    got = compact_streams_passes(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    written = int((got[1] < stream_compact.FILL_DEPTH).sum())
    assert 0 < written < args[-1]


@pytest.mark.parametrize("name", B9_NAMES)
def test_window_counts_and_places(name):
    """Pass 1 counts each stream's hits per window. Pass 2 gives a stream's
    first slot in a window of segment sp as base_w * 128 plus its hits in
    the segment's earlier windows, and its limit min(lim_w, cap_w) * 128;
    SKIP where the window has no hit of the stream, the first slot is at
    the limit, or the window lies in no segment."""
    gid, bits, depth, ws, we, base, lim, cap = b9_inputs(name)
    nws = depth.shape[0]
    counts = window_counts(bits, 16)
    b = bits.numpy().astype(np.int64).reshape(nws, 128)
    want = np.stack([((b >> s) & 1).sum(1) for s in range(16)], 1)
    np.testing.assert_array_equal(counts.numpy(), want)
    first, limit = window_places(counts, ws, we, base,
                                                      lim, cap)
    skip = SKIP
    want_first = np.full((nws, 16), skip, np.int64)
    want_limit = np.zeros((nws, 16), np.int64)
    for sp, (a, e) in enumerate(zip(ws.tolist(), we.tolist())):
        o = slice(16 * sp, 16 * sp + 16)
        hi = np.maximum(np.minimum(lim[o].numpy(), cap // 128) * 128, 0)
        at = base[o].numpy().astype(np.int64) * 128
        for w in range(a, e):
            want_limit[w] = hi
            keep = (want[w] > 0) & (at < hi)
            want_first[w] = np.where(keep, at, skip)
            at = at + want[w]
    np.testing.assert_array_equal(first.numpy(), want_first)
    np.testing.assert_array_equal(limit.numpy(), want_limit)
    if name.startswith("edge"):
        outside = [0, 5, 9, 10, 11]
        assert (first[outside] == skip).all() and counts[outside].sum() > 0


def test_window_write_skips_windows_in_no_segment():
    """Hits in a window outside every segment are never written."""
    gid, bits, depth, ws, we, base, lim, cap = b9_edge_case("cpu", 3)
    gid = gid.reshape(-1, 128).clone()
    outside = [0, 5, 9, 10, 11]
    gid[outside] = -7                        # no real particle id
    counts = window_counts(bits, 16)
    first, limit = window_places(counts, ws, we, base,
                                                      lim, cap)
    got = window_write(gid.reshape(-1), bits, depth,
                                            first, limit, cap)
    assert int(counts[outside].sum()) > 0
    assert not bool((got[0] == -7).any())


@pytest.mark.parametrize("spans", [[(0, 3), (2, 5)], [(4, 8), (0, 2),
                                                      (5, 6)]])
def test_overlapping_segments_are_refused(spans):
    """Segments that share a window break the kernel's one segment per
    window: the plain version, the CPU path of compact_streams, and the
    mirror refuse them, so both paths keep one contract. Empty segments
    may sit anywhere."""
    gid, bits, depth, *_ = b9_edge_case("cpu", 3)
    ws = torch.tensor([a for a, _ in spans] + [3], dtype=torch.int32)
    we = torch.tensor([b for _, b in spans] + [3], dtype=torch.int32)
    base = torch.arange(16 * ws.shape[0], dtype=torch.int32)
    args = (gid, bits, depth, ws, we, base, base + 1, 128 * base.shape[0])
    for fn in (stream_compact.compact_streams,
               stream_compact.compact_streams_plain, compact_streams_passes):
        with pytest.raises(ValueError, match="disjoint"):
            fn(*args)
    ok = (gid, bits, depth, ws[-1:], we[-1:], base[:16], base[:16] + 1,
          128 * 16)
    assert stream_compact.compact_streams(*ok)[0].shape == (128 * 16,)
