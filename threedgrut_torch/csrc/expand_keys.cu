// B4: per-slot key expansion of the tile binning.
//
// Replaces: threedgrut_tpu/ops/pallas/expand.py expand_keys (_kernel),
// reached through tiles._bin_particles_pallas.
//
// Slot s < cap belongs to the depth rank r whose segment
// [ends_rank[r-1], ends_rank[r]) holds it (searchsorted side="right"). Its
// local index picks the local-th surviving bbox cell of the rank's particle
// (the n-th set bit of B3's mask; the identity for particles without a
// mask), which gives the tile; the tile-min power test is re-run, and the
// tile-local footprint row extent y0 * 16 + y1 is packed for the
// row-termination bound. Slots past the true total get pid N and rowbits
// 15; culled or unowned slots get the sentinel tile num_tiles.
//
// Bound on this card: bytes. 12 written per slot, 4 + 4 read per rank
// (ends_rank, ids_of_rank) and the 56 B of per-particle fields (bbox,
// count and mask, conic, centre, max power) of every live rank (at 1M
// particles 35 MB + 59 MB, ~0.028 ms at 3.35 TB/s). This kernel reads
// those fields as the 64-byte record (B3, tile_power.cuh) of each live
// rank's particle, gathered in depth order, i.e. at random.
// The parent kernel ran a ~20-step binary search of ends_rank per slot and
// gathered ~10 separate 32-byte sectors per slot; this one does neither:
//  - a first pass (window_ranks_kernel, one thread per four ranks) writes
//    each 256-slot window's first rank, so no slot searches global
//    memory;
//  - one block per window stages the window's ranks (at most 256 own its
//    slots when every rank between two owners owns a slot, as under
//    tiles.depth_rank, where zero-count ranks sit only at the end): their
//    ends, particle ids and records, each record one aligned 64-byte
//    gather, only for the ranks that own a slot of the window, into
//    shared memory (struct of arrays, no bank conflicts);
//  - each slot then finds its rank by an 8-step search in shared memory
//    and takes every per-particle value, the row half-extent and the power
//    test's reciprocals included, from the record: per slot remain the
//    n-th set bit, the tile, the power re-test (no division), the row
//    extent's floor/ceil/clip and three coalesced stores.
// A slot whose rank lies past the staged 256 (zero-count ranks inside the
// list) takes a global binary search and reads its record itself: the
// contract is that of the plain version, any non-decreasing ends_rank.
// A block of 256 threads, eight to an SM; windows of 256 slots taken by
// 128 or 64 threads (more windows in flight, shared memory permitting)
// ran slower, as did ranks writing their slots' owners into shared memory
// in place of the search.
// Compiled with --fmad=false so the power re-test and the row extent are
// bit-identical to the plain version (see tile_power.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_power.cuh"

constexpr int WIN = 256;     // slots of a window = threads of a block

// Position (0..63) of the (r+1)-th set bit of `m`; r < popcount(m).
__device__ __forceinline__ int select_nth_set_bit(uint64_t m, int r) {
    int base = 0;
    for (int width = 32; width >= 1; width >>= 1) {
        uint64_t low = m & ((1ull << width) - 1ull);
        int c = __popcll(low);
        if (r >= c) {
            base += width;
            r -= c;
            m >>= width;
        } else {
            m = low;
        }
    }
    return base;
}

// jnp.clip(x, 0, 15) with NaN passing through.
__device__ __forceinline__ float clip015(float x) {
    if (x != x) return x;
    return x < 0.0f ? 0.0f : (x > 15.0f ? 15.0f : x);
}

// Pass 1: first[w] = the rank owning slot w * WIN, for every window whose
// first slot lies below min(total, cap). Rank r owns [ends[r-1], ends[r]).
// A thread takes four ranks, by one 16-byte load where ends_rank is
// aligned to it (a third faster than a rank a thread).
__global__ void __launch_bounds__(WIN)
window_ranks_kernel(const int* __restrict__ ends_rank, int n, int cap,
                    int aligned, int* __restrict__ first) {
    const int r0 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
    if (r0 >= n) return;
    int e[4];
    if (aligned && r0 + 3 < n) {
        int4 v = *(const int4*)(ends_rank + r0);
        e[0] = v.x;
        e[1] = v.y;
        e[2] = v.z;
        e[3] = v.w;
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) e[k] = r0 + k < n ? ends_rank[r0 + k] : 0;
    }
    int lo = r0 > 0 ? ends_rank[r0 - 1] : 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if (r0 + k >= n) break;
        const int hi = min(e[k], cap);
        for (int w = (lo + WIN - 1) / WIN; w * WIN < hi; ++w)
            first[w] = r0 + k;
        lo = e[k];
    }
}

__device__ __forceinline__ void store_slot(int s, int end, int p,
                                           const int* f, int gx,
                                           int num_tiles, int tile_culling,
                                           int* __restrict__ tile_key,
                                           int* __restrict__ pid_out,
                                           int* __restrict__ rowbits_out) {
    int local = s - (end - f[REC_COUNT]);
    uint64_t m = (uint64_t)(uint32_t)f[REC_M0]
                 | ((uint64_t)(uint32_t)f[REC_M1] << 24)
                 | ((uint64_t)(uint32_t)f[REC_M2] << 48);
    int cell = m == 0 ? local : select_nth_set_bit(m, local);
    int bw = f[REC_BW];
    int ty = f[REC_TMIN_Y] + cell / bw;
    int tx = f[REC_TMIN_X] + cell % bw;
    float my = __int_as_float(f[REC_MY]);
    bool valid = true;
    if (tile_culling) {
        TilePower q = tile_power(
            __int_as_float(f[REC_CA]), __int_as_float(f[REC_CB]),
            __int_as_float(f[REC_CC]), __int_as_float(f[REC_MX]), my,
            __int_as_float(f[REC_RCP_X]), __int_as_float(f[REC_RCP_Y]));
        valid = tile_min_power((float)tx, (float)ty, q)
                < __int_as_float(f[REC_MAX_POWER]);
    }
    tile_key[s] = valid ? ty * gx + tx : num_tiles;
    pid_out[s] = p;
    // Tile-local footprint row extent (expand.py _kernel, same formula).
    float e_dy = __int_as_float(f[REC_E_DY]);
    float ty_pix = (float)ty * 16.0f;
    float y0 = clip015(floorf(my - e_dy) - 1.0f - ty_pix);
    float y1 = clip015(ceilf(my + e_dy) + 1.0f - ty_pix);
    rowbits_out[s] = (int)(y0 * 16.0f + y1);
}

// Pass 2: one block per window of WIN slots, one thread per slot.
__global__ void __launch_bounds__(WIN)
expand_keys_kernel(const int* __restrict__ ends_rank,
                   const int* __restrict__ ids_of_rank,
                   const int4* __restrict__ record,
                   const int* __restrict__ first, int n, int cap, int gx,
                   int num_tiles, int tile_culling,
                   int* __restrict__ tile_key, int* __restrict__ pid_out,
                   int* __restrict__ rowbits_out) {
    __shared__ int ends_s[WIN];
    __shared__ int ids_s[WIN];
    __shared__ int rec_s[REC_WORDS][WIN];
    const int t = threadIdx.x;
    const int s0 = blockIdx.x * WIN;
    const int s = s0 + t;
    const int total = n > 0 ? ends_rank[n - 1] : 0;
    if (s0 >= total) {               // the whole window is past the total
        if (s < cap) {
            tile_key[s] = num_tiles;
            pid_out[s] = n;
            rowbits_out[s] = 15;
        }
        return;
    }
    const int pa = first[blockIdx.x];
    const int staged = min(WIN, n - pa);
    if (t < staged) {
        int r = pa + t;
        int e = ends_rank[r];
        int e_prev = r > 0 ? ends_rank[r - 1] : 0;
        ends_s[t] = e;
        if (e_prev < s0 + WIN && e_prev < e) {  // owns a slot of the window
            int p = ids_of_rank[r];
            ids_s[t] = p;
            const int4* rec = record + 4 * (size_t)p;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                int4 v = rec[k];
                rec_s[4 * k][t] = v.x;
                rec_s[4 * k + 1][t] = v.y;
                rec_s[4 * k + 2][t] = v.z;
                rec_s[4 * k + 3][t] = v.w;
            }
        }
    }
    __syncthreads();
    if (s >= cap) return;
    if (s >= total) {
        tile_key[s] = num_tiles;
        pid_out[s] = n;
        rowbits_out[s] = 15;
        return;
    }
    int f[REC_WORDS];
    int end, p;
    if (ends_s[staged - 1] > s) {
        // First staged rank with ends > s (searchsorted side="right").
        int lo = 0, hi = staged - 1;
        while (lo < hi) {
            int mid = (lo + hi) >> 1;
            if (ends_s[mid] <= s) lo = mid + 1; else hi = mid;
        }
        end = ends_s[lo];
        p = ids_s[lo];
#pragma unroll
        for (int k = 0; k < REC_WORDS; ++k) f[k] = rec_s[k][lo];
    } else {
        // Past the staged ranks: zero-count ranks inside the list.
        int lo = pa + staged, hi = n - 1;
        while (lo < hi) {
            int mid = (lo + hi) >> 1;
            if (ends_rank[mid] <= s) lo = mid + 1; else hi = mid;
        }
        end = ends_rank[lo];
        p = ids_of_rank[lo];
        const int4* rec = record + 4 * (size_t)p;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            int4 v = rec[k];
            f[4 * k] = v.x;
            f[4 * k + 1] = v.y;
            f[4 * k + 2] = v.z;
            f[4 * k + 3] = v.w;
        }
    }
    store_slot(s, end, p, f, gx, num_tiles, tile_culling, tile_key, pid_out,
               rowbits_out);
}

extern "C" int expand_keys(const void* ends_rank, const void* ids_of_rank,
                           const void* record, int n, int cap, int gx,
                           int num_tiles, int tile_culling, void* first,
                           void* tile_key, void* pid, void* rowbits,
                           void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (cap > 0 && n > 0) {
        window_ranks_kernel<<<(n + 4 * WIN - 1) / (4 * WIN), WIN, 0, st>>>(
            (const int*)ends_rank, n, cap, ((uintptr_t)ends_rank & 15) == 0,
            (int*)first);
    }
    if (cap > 0) {
        expand_keys_kernel<<<(cap + WIN - 1) / WIN, WIN, 0, st>>>(
            (const int*)ends_rank, (const int*)ids_of_rank,
            (const int4*)record, (const int*)first, n, cap, gx, num_tiles,
            tile_culling, (int*)tile_key, (int*)pid, (int*)rowbits);
    }
    return (int)cudaGetLastError();
}

// Blocks of WIN threads an SM holds at once, as the CUDA runtime computes
// them (cudaOccupancyMaxActiveBlocksPerMultiprocessor), of the window pass
// and the expansion, into out[0..1]. Returns a CUDA error, 0 on success.
extern "C" int expand_keys_blocks_per_sm(int* out) {
    const void* kernels[] = {(const void*)window_ranks_kernel,
                             (const void*)expand_keys_kernel};
    for (int i = 0; i < 2; ++i) {
        const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[i], kernels[i], WIN, 0);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
