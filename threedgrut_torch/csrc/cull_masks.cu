// B3: count-time per-tile cull masks and the per-particle record of B4.
//
// Replaces: threedgrut_tpu/ops/pallas/expand.py cull_masks_pallas
// (_cull_masks_kernel), reached through expand.cull_masks from
// tiles.bin_particles.
//
// For every particle whose tile bbox fits 8x8 tiles, test each bbox cell with
// the tile-min power response and keep the surviving count and the 64-bit
// survival mask (cell j = dy * bbox_w + dx, stored as 24/24/16-bit words).
// Particles with a larger bbox keep their dense bbox count and mask 0 (B4
// culls them slot by slot); particles with n_tiles == 0 get count 0. With
// tile culling off every particle keeps count n_tiles and mask 0. Outputs:
// the counts [N] (the binning's cumsum and depth rank read them) and the
// particle's record [N, 16] (tile_power.cuh RecordWord: bbox, count, mask,
// conic, centre, max power, row half-extent and the power test's two
// reciprocals), which B4 gathers once per depth rank as two 32-byte
// sectors instead of the ~10 sectors of the separate fields.
//
// Bound on this card: bytes, 44 read and 16 written (count and mask
// words) per particle (60 MB at 1M particles, ~0.018 ms at 3.35 TB/s)
// against ~42 operations per tested cell (2.9 cells per particle at 1M).
// The 64-byte record is scratch for B4 and not part of that bound: its
// 64 MB of writes (~0.019 ms more) are what B4's gathers save.
// Design: one thread per particle, vector loads of the bbox pairs and the
// centre; the particle's part of the power test (tile_power.cuh TilePower:
// the two reciprocals and the +-16 products) and the row half-extent
// computed once, so the loop over the bbox cells (one flat loop over
// bw * bh, no masked work for small footprints) holds no division; the
// block's records staged in shared memory and written as one contiguous
// 16 KB run of 16-byte stores (each thread storing its own 64-byte record
// took ~10% longer).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_power.cuh"

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
cull_masks_kernel(const int2* __restrict__ tile_min,
                  const int2* __restrict__ tile_max,
                  const int* __restrict__ n_tiles,
                  const float* __restrict__ conic,
                  const float2* __restrict__ center,
                  const float* __restrict__ max_power, int n,
                  int tile_culling, int* __restrict__ counts,
                  int4* __restrict__ record) {
    // The block's records, staged for coalesced stores; particle t's
    // quarter k sits at 4 t + ((k + t) & 3), so that both the per-thread
    // writes and the block-wide reads spread over the banks.
    __shared__ int4 rec_s[4 * THREADS];
    const int t = threadIdx.x;
    const int i0 = blockIdx.x * THREADS;
    const int i = i0 + t;
    if (i < n) {
        int nt = n_tiles[i];
        int2 tmin = tile_min[i], tmax = tile_max[i];
        int bw = tmax.x - tmin.x;
        int bh = tmax.y - tmin.y;
        float ca = conic[3 * i], cb = conic[3 * i + 1];
        float cc = conic[3 * i + 2];
        float2 c = center[i];
        float mp = max_power[i];
        TilePower q = tile_power(ca, cb, cc, c.x, c.y, rcp_256(ca),
                                 rcp_256(cc));
        int count = nt;
        uint64_t mask = 0;
        if (tile_culling && nt <= 0) {
            count = 0;
        } else if (tile_culling && bw <= 8 && bh <= 8) {
            int cells = (bw > 0 && bh > 0) ? bw * bh : 0;
            float fx = (float)tmin.x, fy = (float)tmin.y;
            int dx = 0, dy = 0;
            for (int j = 0; j < cells; ++j) {
                if (tile_min_power(fx + (float)dx, fy + (float)dy, q) < mp)
                    mask |= 1ull << j;
                if (++dx == bw) {
                    dx = 0;
                    ++dy;
                }
            }
            count = __popcll(mask);
        }
        counts[i] = count;
        rec_s[4 * t + (t & 3)] = make_int4(tmin.x, tmin.y, bw < 1 ? 1 : bw,
                                           count);
        rec_s[4 * t + ((1 + t) & 3)] = make_int4(
            (int)(mask & 0xFFFFFFull), (int)((mask >> 24) & 0xFFFFFFull),
            (int)((mask >> 48) & 0xFFFFull), __float_as_int(ca));
        rec_s[4 * t + ((2 + t) & 3)] = make_int4(
            __float_as_int(cb), __float_as_int(cc), __float_as_int(c.x),
            __float_as_int(c.y));
        rec_s[4 * t + ((3 + t) & 3)] = make_int4(
            __float_as_int(mp),
            __float_as_int(row_half_extent(ca, cb, cc, mp)),
            __float_as_int(q.rcp_x), __float_as_int(q.rcp_y));
    }
    __syncthreads();
    const int words = 4 * min(THREADS, n - i0);
    int4* out = record + 4 * (size_t)i0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        int j = k * THREADS + t;           // quarter j % 4 of particle j / 4
        if (j < words) {
            int p = j >> 2;
            out[j] = rec_s[4 * p + (((j & 3) + p) & 3)];
        }
    }
}

extern "C" int cull_masks(const void* tile_min, const void* tile_max,
                          const void* n_tiles, const void* conic,
                          const void* center, const void* max_power, int n,
                          int tile_culling, void* counts, void* record,
                          void* stream) {
    if (n > 0) {
        cull_masks_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                            (cudaStream_t)stream>>>(
            (const int2*)tile_min, (const int2*)tile_max,
            (const int*)n_tiles, (const float*)conic, (const float2*)center,
            (const float*)max_power, n, tile_culling, (int*)counts,
            (int4*)record);
    }
    return (int)cudaGetLastError();
}

// Blocks of THREADS threads an SM holds at once, as the CUDA runtime
// computes them (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into
// out[0]. Returns a CUDA error, 0 on success.
extern "C" int cull_masks_blocks_per_sm(int* out) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], (const void*)cull_masks_kernel, THREADS, 0);
}
