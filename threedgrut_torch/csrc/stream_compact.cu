// B9: 16-way stream compaction of the flat 3DGRT cull (the member
// partition of bundle_candidates_twolevel_flat's compact_kernel leg).
//
// Replaces: threedgrut_tpu/ops/pallas/stream_compact.py compact_streams
// (body _kernel). Per segment sp (a super's flat list, windows
// [seg_ws[sp], seg_we[sp]) of CHUNK = 128 slots) and stream s (one of its
// 16 member bundles), the k-th slot of the segment whose mask bit s is set
// (in slot order) is written to output slot base_w[sp*16+s]*128 + k, as its
// (gid, member-s depth), iff that slot lies below
// min(lim_w[sp*16+s], cap_w)*128. So each stream keeps its first hits in
// super-list order; overflow is the caller's flag. Slots never written keep
// what the wrapper filled in: gid 0, depth 3.4e38. The output ranges of the
// streams must be disjoint (the caller's CHUNK-padded exclusive cumsum),
// and so must the segments' window ranges (the flat layout's).
//
// Bound on this card: bytes. Each segment slot's gid and mask are read
// (8 B), each hit's depth (4 B) and each kept hit's output written (8 B).
// A block per segment, each stream's warp walking the segment's windows
// with a cursor in a register, would keep 64 of 132 SMs busy at the 1M
// flat cull, each warp on a chain of ~2,240 dependent ballot steps (on an
// H100 such a B9 took 17x this one's time, golden/digest.py --time). So
// three passes whose grids cover windows: every SM works and no chain is
// longer than a window.
//   1. count (`window_counts_kernel`, a warp per window): each stream's
//      hits in the window, as byte counters (each lane's 4 slots spread
//      a nibble of mask bits to 4 bytes), summed over the warp by 4
//      __reduce_add_sync;
//   2. place (`window_places_kernel`, a block per (segment, stream), 512
//      windows a step): the exclusive scan of the stream's counts over the
//      segment's windows, plus base_w*128, is the stream's first output
//      slot in the window; stored with the stream's limit
//      min(lim_w, cap_w)*128. A window without a hit of the stream, or
//      whose first slot is at the limit already, or in no segment (pass 1
//      marks every window so), gets the first slot SKIP;
//   3. write (`window_write_kernel`, a warp per window): for each stream
//      whose first slot lies below its limit, a hit's rank by a ballot
//      plus the first slot places it; it is written iff below the limit.
//      A window with nothing to write returns after one load.
// What bounds the write is the depth reads: a hit's 4 bytes bring in the
// 32-byte sector around them, and a stream's hits are sparse along its
// row (digest.py counts the sectors). Loading a group of 2-16 streams'
// depths at once (more registers, fewer warps) and storing a stream's
// hits of a window with one store per 32 hits were both slower.
// Pass 2 stores the segment's base and limit per (window, stream) so that
// pass 3 needs no dependent load for them. The placement is exact integer
// arithmetic (no atomics, no cursor), so the output is the plain
// version's, bit for bit, on every launch. The TPU kernel ranked with a
// triangular matmul and routed with one-hot matmuls on its matrix unit,
// staging each stream's window in VMEM; here ranks are ballots and every
// hit is stored directly.
//
// Inputs: gid [nws*128] int32 (particle id per super slot), bits [nws*128]
// int32 (16-bit member mask), depth [nws, 16, 128] f32 (each member's axis
// depth per slot: a stream's row of a window is read coalesced). Scratch
// (the wrapper's, [nws*32] int32): limit and first [nws*16] each, entry
// w*16 + s.
#include <cuda_runtime.h>
#include <limits.h>

#define CHUNK 128
#define STREAMS 16
#define FULL 0xffffffffu
#define WARPS 8          // windows per block of the count and write passes
#define PLACE_WARPS 16   // a place block's warps: 512 windows a step
#define SKIP INT_MAX     // a first slot no limit reaches

// Bits 0-3 of x to bits 0, 8, 16 and 24 (the copies x << 7k do not
// overlap, so the product has no carries).
__device__ __forceinline__ unsigned nibble_to_bytes(unsigned x) {
    return (x * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(WARPS * 32)
window_counts_kernel(const int* __restrict__ bits, int nws,
                     int* __restrict__ limit, int* __restrict__ first) {
    const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (w >= nws) return;                     // warp-uniform
    // Byte s & 3 of word s >> 2 counts stream s's hits: at most 4 a lane,
    // at most 128 over the warp, so no byte overflows into the next.
    unsigned acc[STREAMS / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int c = 0; c < CHUNK / 32; ++c) {
        const unsigned b = (unsigned)bits[(long long)w * CHUNK + c * 32 + lane];
#pragma unroll
        for (int q = 0; q < STREAMS / 4; ++q)
            acc[q] += nibble_to_bytes((b >> (4 * q)) & 0xFu);
    }
    unsigned mine = 0;                        // lane s keeps stream s's
#pragma unroll
    for (int q = 0; q < STREAMS / 4; ++q) {
        const unsigned tot = __reduce_add_sync(FULL, acc[q]);
        if ((lane >> 2) == q) mine = (tot >> (8 * (lane & 3))) & 0xFFu;
    }
    if (lane < STREAMS) {
        limit[(long long)w * STREAMS + lane] = (int)mine;  // the count, for now
        first[(long long)w * STREAMS + lane] = SKIP;       // in no segment
    }
}

// Block (sp, s): stream s of segment sp, PLACE_WARPS * 32 windows a step.
__global__ void __launch_bounds__(PLACE_WARPS * 32)
window_places_kernel(const int* __restrict__ seg_ws,
                     const int* __restrict__ seg_we,
                     const int* __restrict__ base_w,
                     const int* __restrict__ lim_w, int cap_w, int nws,
                     int* __restrict__ limit, int* __restrict__ first) {
    __shared__ int warp_sum[PLACE_WARPS];
    const int sp = blockIdx.x, s = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int o = sp * STREAMS + s;
    const int w0 = seg_ws[sp], w1 = min(seg_we[sp], nws);
    const long long hi = (long long)min(lim_w[o], cap_w) * CHUNK;
    const int lim = (int)max(hi, 0ll);
    long long at = (long long)base_w[o] * CHUNK;   // the step's first slot
    for (int step = w0; step < w1; step += PLACE_WARPS * 32) {
        const int w = step + threadIdx.x;
        const long long e = (long long)w * STREAMS + s;
        const int v = w < w1 ? limit[e] : 0;     // the window's count
        int inc = v;                             // inclusive, in the warp
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc += y;
        }
        if (lane == 31) warp_sum[warp] = inc;
        __syncthreads();
        int before = 0, total = 0;               // earlier warps', all
#pragma unroll
        for (int k = 0; k < PLACE_WARPS; ++k) {
            const int x = warp_sum[k];
            before += k < warp ? x : 0;
            total += x;
        }
        if (w < w1) {
            const long long d = at + before + inc - v;
            limit[e] = lim;
            first[e] = v > 0 && d < hi ? (int)d : SKIP;
        }
        at += total;
        __syncthreads();                         // warp_sum is reused
    }
}

__global__ void __launch_bounds__(WARPS * 32)
window_write_kernel(const int* __restrict__ gid, const int* __restrict__ bits,
                    const float* __restrict__ depth, int nws,
                    const int* __restrict__ limit,
                    const int* __restrict__ first,
                    int* __restrict__ out_gid,
                    float* __restrict__ out_depth) {
    const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (w >= nws) return;                     // warp-uniform
    // Lane s < 16: stream s's first output slot for the window and its
    // limit (SKIP: no hit to write).
    int dst = SKIP, hi = 0;
    if (lane < STREAMS) {
        dst = first[(long long)w * STREAMS + lane];
        hi = limit[(long long)w * STREAMS + lane];
    }
    unsigned todo = __ballot_sync(FULL, dst < hi);
    if (!todo) return;
    const unsigned below = (1u << lane) - 1u;
    int b[CHUNK / 32], g[CHUNK / 32];
#pragma unroll
    for (int c = 0; c < CHUNK / 32; ++c) {
        b[c] = bits[(long long)w * CHUNK + c * 32 + lane];
        g[c] = gid[(long long)w * CHUNK + c * 32 + lane];
    }
    for (; todo; todo &= todo - 1) {
        const int s = __ffs(todo) - 1;
        int at = __shfl_sync(FULL, dst, s);
        const int lim = __shfl_sync(FULL, hi, s);
        const float* drow = depth + ((long long)w * STREAMS + s) * CHUNK;
        // Every slot first, then the four chunks' depth loads, then the
        // stores: a load placed after a store waits for it, and four
        // dependent load latencies a stream made the pass ~1.5x slower.
        int k[CHUNK / 32];
        float d[CHUNK / 32];
#pragma unroll
        for (int c = 0; c < CHUNK / 32; ++c) {
            const bool hit = (b[c] >> s) & 1;
            const unsigned ballot = __ballot_sync(FULL, hit);
            const int kk = at + __popc(ballot & below);
            k[c] = hit && kk < lim ? kk : -1;
            at += __popc(ballot);
        }
#pragma unroll
        for (int c = 0; c < CHUNK / 32; ++c)
            if (k[c] >= 0) d[c] = drow[c * 32 + lane];
#pragma unroll
        for (int c = 0; c < CHUNK / 32; ++c)
            if (k[c] >= 0) {
                out_gid[k[c]] = g[c];
                out_depth[k[c]] = d[c];
            }
    }
}

extern "C" int compact_streams(const void* gid, const void* bits,
                               const void* depth, const void* seg_ws,
                               const void* seg_we, const void* base_w,
                               const void* lim_w, int n_seg, int nws,
                               int cap_w, void* scratch, void* out_gid,
                               void* out_depth, void* stream) {
    if (n_seg <= 0 || nws <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    int* limit = (int*)scratch;
    int* first = limit + (long long)nws * STREAMS;
    const int grid = (nws + WARPS - 1) / WARPS;
    window_counts_kernel<<<grid, WARPS * 32, 0, st>>>((const int*)bits, nws,
                                                      limit, first);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    window_places_kernel<<<dim3(n_seg, STREAMS), PLACE_WARPS * 32, 0, st>>>(
        (const int*)seg_ws, (const int*)seg_we, (const int*)base_w,
        (const int*)lim_w, cap_w, nws, limit, first);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    window_write_kernel<<<grid, WARPS * 32, 0, st>>>(
        (const int*)gid, (const int*)bits, (const float*)depth, nws, limit,
        first, (int*)out_gid, (float*)out_depth);
    return (int)cudaGetLastError();
}

// Blocks an SM holds at once, as the CUDA runtime computes them
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), of the count, place and
// write kernels at their launches' block sizes, into out[0..2]. Returns a
// CUDA error, 0 on success.
extern "C" int compact_streams_blocks_per_sm(int* out) {
    const void* kernels[] = {(const void*)window_counts_kernel,
                             (const void*)window_places_kernel,
                             (const void*)window_write_kernel};
    const int threads[] = {WARPS * 32, PLACE_WARPS * 32, WARPS * 32};
    for (int i = 0; i < 3; ++i) {
        const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[i], kernels[i], threads[i], 0);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
