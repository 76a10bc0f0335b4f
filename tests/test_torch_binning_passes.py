"""The index logic of B3's and B4's kernels, through plain mirrors of their
passes kept here, on the CPU (no JAX): B4's window pass (`window_ranks`,
each 256-slot window's first rank) against torch.searchsorted, and its
expansion by windows (`expand_windows`: the ranks a window stages, the
records of only those that own one of its slots, the search in the staged
ends, and the global search of a slot whose rank lies past them) bit for
bit against expand_keys_plain; B3's flat cell loop with the particle's
part of the power test hoisted (`cull_masks_flat`) against
cull_masks_plain; and the record's layout, in the plain versions and in
the kernels' header. On the edge cases that tests/test_torch_kernels_cuda.py
runs on the card (b4_edge_case). All exact."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_kernels_cuda import B4_CASES, b4_args, b4_edge_case
from threedgrut_torch.ops import expand
from threedgrut_torch.ops.expand import power_reciprocals
from threedgrut_torch.ops.projection import tile_min_power_response

W = expand.WINDOW
UNWRITTEN = -1          # a window entry the first pass leaves alone
HEADER = (Path(expand.__file__).resolve().parents[1] / "csrc"
          / "tile_power.cuh")


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch on one intra-op thread, as in tests/test_torch_live_rows.py:
    under the parallel test run's load many small ops stall a larger
    intra-op pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def window_ranks(ends_rank: torch.Tensor, cap: int) -> torch.Tensor:
    """B4's first pass: [ceil(cap / 256)] int64 first ranks. The thread of
    rank r, which owns slots [ends[r-1], ends[r]), writes r into every
    window whose first slot it owns below cap; windows whose first slot
    lies at or past min(total, cap) stay UNWRITTEN."""
    ends = ends_rank.to(torch.int64)
    n = ends.shape[0]
    first = torch.full((-(-cap // W),), UNWRITTEN, dtype=torch.int64)
    lo = torch.cat([ends.new_zeros(1), ends[:-1]])
    hi = torch.clamp(ends, max=cap)
    w0 = (lo + W - 1) // W
    k = torch.clamp((hi + W - 1) // W - w0, min=0)
    ranks = torch.repeat_interleave(torch.arange(n), k)
    wins = (w0[ranks] + torch.arange(int(k.sum()))
            - (torch.cumsum(k, 0) - k)[ranks])
    assert wins.unique().numel() == wins.numel()    # one writer a window
    first[wins] = ranks
    return first


def expand_windows(ends_rank, ids_of_rank, record, cap: int, tile_grid,
                   tile_culling: bool):
    """B4's second pass, a window of 256 slots at a time: a window whose
    first slot lies past the total keeps the tail values; otherwise it
    stages ranks first[w] .. first[w] + 255 (below N) and the records of
    those that own a slot of the window (others hold garbage), finds each
    slot's rank in the staged ends, or, past them, by a global search,
    and computes the slot with expand.slot_keys. Returns (tile_key, pid,
    rowbits) and the number of slots that took the global search."""
    gx, gy = tile_grid
    n = ends_rank.shape[0]
    ends = ends_rank.to(torch.int64)
    total = int(ends[-1]) if n else 0
    first = window_ranks(ends_rank, cap)
    out = [torch.full((cap,), v, dtype=torch.int32)
           for v in (gx * gy, n, 15)]
    wide = 0
    for w in range(first.shape[0]):
        s0 = w * W
        if s0 >= total:
            continue
        pa = int(first[w])
        staged = min(W, n - pa)
        e = ends[pa:pa + staged]
        e_prev = torch.cat([ends[pa - 1:pa] if pa else ends.new_zeros(1),
                            e[:-1]])
        owner = (e_prev < s0 + W) & (e_prev < e)
        p_s = torch.full((staged,), -1, dtype=torch.int64)
        p_s[owner] = ids_of_rank[pa:pa + staged][owner].to(torch.int64)
        rec_s = torch.full((staged, expand.RECORD_WORDS), -123456789,
                           dtype=torch.int32)
        rec_s[owner] = record[p_s[owner]]
        s = torch.arange(s0, min(s0 + W, cap, total))
        k = torch.searchsorted(e, s, right=True)
        found = k < staged
        assert bool(owner[k[found]].all())          # only owners are read
        r = (torch.searchsorted(ends[pa + staged:], s[~found], right=True)
             + pa + staged)
        wide += int((~found).sum())
        end = torch.empty_like(s)
        p = torch.empty_like(s)
        end[found], p[found] = e[k[found]], p_s[k[found]]
        end[~found] = ends[r]
        p[~found] = ids_of_rank[r].to(torch.int64)
        rec = torch.empty((s.shape[0], expand.RECORD_WORDS),
                          dtype=torch.int32)
        rec[found] = rec_s[k[found]]
        rec[~found] = record[p[~found]]
        keys = expand.slot_keys(s.to(torch.int32), end.to(torch.int32), p,
                                expand.unpack_record(rec), tile_grid,
                                tile_culling)
        for o, v in zip(out, keys):
            o[s] = v
    return tuple(out), wide


def hoisted_power(txy, conic, center, rcp):
    """csrc/tile_power.cuh's tile_min_power: the particle's 16 a, 16 b,
    16 c and reciprocals computed once, dxy * c taken as +-(16 c)."""
    ts = 16.0
    ca, cb, cc = conic.unbind(-1)
    mx, my = center.unbind(-1)
    a16, b16, c16 = ts * ca, ts * cb, ts * cc
    tminx, tminy = ts * txy[..., 0], ts * txy[..., 1]
    tmaxx, tmaxy = tminx + ts, tminy + ts
    offx, offy = tminx - mx, tminy - my
    la_x, la_y = (offx > 0.0).float(), (offy > 0.0).float()
    nir_x = la_x + (mx > tmaxx).float()
    nir_y = la_y + (my > tmaxy).float()
    outside = (nir_x + nir_y) > 0.0
    px = tmaxx + (tminx - tmaxx) * la_x
    py = tmaxy + (tminy - tmaxy) * la_y
    pos_x, pos_y = offx >= 0.0, offy >= 0.0
    dxy_x = torch.where(pos_x, ts, -ts)
    dxy_y = torch.where(pos_y, ts, -ts)
    dfx, dfy = mx - px, my - py
    xa, xb = torch.where(pos_x, a16, -a16), torch.where(pos_x, b16, -b16)
    yb, yc = torch.where(pos_y, b16, -b16), torch.where(pos_y, c16, -c16)
    t_x = nir_y * torch.clamp((xa * dfx + xb * dfy) * rcp[..., 0], 0.0, 1.0)
    t_y = nir_x * torch.clamp((yb * dfx + yc * dfy) * rcp[..., 1], 0.0, 1.0)
    dx = mx - (px + t_x * dxy_x)
    dy = my - (py + t_y * dxy_y)
    power = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    return torch.where(outside, power, torch.zeros_like(power))


def cull_masks_flat(tile_min, tile_max, n_tiles, conic, center, max_power):
    """B3's culled counts and 64-bit masks as its kernel computes them: one
    flat loop over the bbox's bw * bh cells, cell j at (j % bw, j // bw),
    the power test hoisted."""
    bw = tile_max[:, 0] - tile_min[:, 0]
    bh = tile_max[:, 1] - tile_min[:, 1]
    cells = torch.where((bw > 0) & (bh > 0), bw * bh, 0)
    rcp = power_reciprocals(conic)
    mask = torch.zeros(n_tiles.shape[0], dtype=torch.int64)
    for j in range(64):
        dx = j % torch.clamp(bw, min=1)
        dy = j // torch.clamp(bw, min=1)
        txy = torch.stack([tile_min[:, 0].float() + dx.float(),
                           tile_min[:, 1].float() + dy.float()], -1)
        ok = (j < cells) & (hoisted_power(txy, conic, center, rcp)
                            < max_power)
        mask |= ok.to(torch.int64) << j
    maskable = (bw <= 8) & (bh <= 8)
    count = torch.tensor([bin(m & (2 ** 64 - 1)).count("1")
                          for m in mask.tolist()],
                         dtype=torch.int32)
    count = torch.where(n_tiles <= 0, 0,
                        torch.where(maskable, count, n_tiles))
    mask = torch.where((n_tiles > 0) & maskable, mask, 0)
    return count, mask


def as_mask(words: torch.Tensor) -> torch.Tensor:
    """The 64-bit masks of [N, 3] 24/24/16-bit mask words."""
    w = words.to(torch.int64)
    return w[:, 0] | (w[:, 1] << 24) | (w[:, 2] << 48)


def case_inputs(name, tile_culling=True):
    case = b4_edge_case("cpu", name)
    counts, record = expand.cull_masks_plain(*case[0],
                                             tile_culling=tile_culling)
    return case, counts, record, b4_args(case, counts, record, tile_culling)


@pytest.mark.parametrize("name", B4_CASES)
def test_window_ranks_are_searchsorted(name):
    """Every window whose first slot lies below min(total, cap) gets the
    rank searchsorted(ends_rank, 256 w, right=True); the others none."""
    _, _, _, (ends_rank, _, _, cap, _, _) = case_inputs(name)
    first = window_ranks(ends_rank, cap)
    total = int(ends_rank[-1])
    w = torch.arange(first.shape[0])
    live = w * W < min(total, cap)
    want = torch.searchsorted(ends_rank, (w * W).to(torch.int32),
                              right=True)
    assert torch.equal(first[live], want[live])
    assert bool((first[~live] == UNWRITTEN).all())
    assert int(live.sum()) == -(-min(total, cap) // W)


@pytest.mark.parametrize("tile_culling", [True, False])
@pytest.mark.parametrize("name", B4_CASES)
def test_window_expansion_matches_plain(name, tile_culling):
    """The two passes give expand_keys_plain's outputs bit for bit: below
    and above the total (a capacity not a multiple of 256), total 0, one
    particle, a particle owning 300 slots, windows of 256 single-slot
    ranks, and zero-count ranks inside the list."""
    _, counts, _, args = case_inputs(name, tile_culling)
    got, _ = expand_windows(*args)
    want = expand.expand_keys_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    total, cap = int(counts.sum()), args[3]
    assert (total > cap) == (name == "below")
    if name == "total0":
        assert bool((got[1] == counts.shape[0]).all())


@pytest.mark.parametrize("name", B4_CASES)
def test_global_search_only_past_the_staged_ranks(name):
    """Under tiles.depth_rank (zero-count ranks last) no slot leaves the
    256 staged ranks; with zero-count ranks inside the list some do, and
    their global search gives the plain version's answer (above)."""
    _, _, _, args = case_inputs(name)
    _, wide = expand_windows(*args)
    if name == "zero-inside":
        assert wide > 0
    else:
        assert wide == 0
    if name == "singles":                   # 256 single-slot ranks a window
        ends = args[0]
        assert torch.equal(ends[:2 * W], torch.arange(1, 2 * W + 1,
                                                      dtype=torch.int32))


@pytest.mark.parametrize("name", B4_CASES)
def test_flat_cell_loop_matches_plain_masks(name):
    """B3's flat loop with the hoisted power test gives cull_masks_plain's
    counts and mask words bit for bit."""
    case, counts, record, _ = case_inputs(name)
    want = expand.unpack_record(record)
    count, mask = cull_masks_flat(*case[0])
    assert torch.equal(count, counts) and torch.equal(count, want.count)
    assert torch.equal(mask, as_mask(want.masks))


def test_hoisted_power_is_bit_equal():
    """tile_min_power with the particle's part computed once (+-16 c as a
    negation) equals tile_min_power_response bit for bit, on tiles on
    every side of the centre, corners at the centre and conics of both
    signs of b."""
    rng = np.random.default_rng(3)
    n = 20000
    txy = torch.tensor(rng.integers(0, 30, (n, 2)), dtype=torch.float32)
    center = torch.tensor(rng.uniform(0, 480, (n, 2)), dtype=torch.float32)
    center[::7] = txy[::7] * 16.0                 # a corner on the centre
    conic = torch.tensor(np.abs(rng.normal(0.02, 0.02, (n, 3))) + 1e-4,
                         dtype=torch.float32)
    conic[:, 1] *= torch.tensor(rng.choice([-0.5, 0.5], n),
                                dtype=torch.float32)
    rcp = power_reciprocals(conic)
    a = hoisted_power(txy, conic, center, rcp)
    b = tile_min_power_response(txy, conic, center)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int((b > 0).sum()) > n // 2


@pytest.mark.parametrize("tile_culling", [True, False])
def test_record_round_trip(tile_culling):
    """The plain B3's record holds each particle's bbox min, clamped width,
    count, mask words, conic, centre and max power bit for bit, the row
    half-extent and the power reciprocals as computed from them; packing
    its fields gives it back."""
    case, counts, record, _ = case_inputs("big", tile_culling)
    tmin, tmax, ntiles, conic, center, mp = case[0]
    f = expand.unpack_record(record)
    assert record.dtype == torch.int32
    assert record.shape == (counts.shape[0], expand.RECORD_WORDS)
    assert torch.equal(f.tile_min, tmin)
    assert torch.equal(f.bbox_w, torch.clamp(tmax[:, 0] - tmin[:, 0],
                                             min=1))
    assert torch.equal(f.count, counts)
    if not tile_culling:
        assert torch.equal(counts, ntiles) and not bool(f.masks.any())
    for got, want in ((f.conic, conic), (f.center, center),
                      (f.max_power, mp),
                      (f.e_dy, expand.row_half_extent(conic, mp)),
                      (f.rcp, power_reciprocals(conic))):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    again = expand.pack_record(f._asdict())
    assert torch.equal(again, record)


def test_record_layout_matches_the_kernels_header():
    """expand.RECORD names the words of csrc/tile_power.cuh's RecordWord
    enum, which B3 writes and B4 reads."""
    enum = dict(re.findall(r"(REC_\w+) = (\d+)", HEADER.read_text()))
    assert int(enum.pop("REC_WORDS")) == expand.RECORD_WORDS
    header = sorted(int(v) for v in enum.values())
    assert header == list(range(expand.RECORD_WORDS))
    firsts = {"tile_min": "REC_TMIN_X", "bbox_w": "REC_BW",
              "count": "REC_COUNT", "masks": "REC_M0", "conic": "REC_CA",
              "center": "REC_MX", "max_power": "REC_MAX_POWER",
              "e_dy": "REC_E_DY", "rcp": "REC_RCP_X"}
    for name, at, words in expand.RECORD:
        assert int(enum[firsts[name]]) == at, name
    assert sum(words for _, _, words in expand.RECORD) == len(header)
