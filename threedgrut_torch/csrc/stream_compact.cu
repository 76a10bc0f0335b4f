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
// streams must be disjoint (the caller's CHUNK-padded exclusive cumsum).
//
// Design: one block per segment, one warp per stream (16 warps). A warp
// walks its segment's windows in 32-slot steps; each step is one ballot of
// its mask bit, whose popcount below a lane gives that lane's rank and
// whose popcount advances the warp's cursor (a register). No atomics and
// no shared memory: launches are bit-identical. A warp stops once its
// cursor reaches its limit. The TPU kernel ranked with a triangular matmul
// and routed with one-hot matmuls on its matrix unit, staging each stream's
// window in VMEM; here ranks are ballots and every hit is stored directly.
//
// Inputs: gid [nws*128] int32 (particle id per super slot), bits [nws*128]
// int32 (16-bit member mask), depth [nws, 16, 128] f32 (each member's axis
// depth per slot: a warp reads its row of a window coalesced).
//
// Bound on this card: bytes. Each segment slot's gid and mask are read
// (8 B; the 16 warps share them through L1), each hit's depth (4 B) and
// each kept hit's output (8 B). At bench_grt's shapes there are only 64
// segments: 64 of 132 SMs work, each on a serial walk of its windows.
#include <cuda_runtime.h>

#define CHUNK 128
#define STREAMS 16
#define FULL 0xffffffffu

__global__ void __launch_bounds__(STREAMS * 32)
compact_streams_kernel(const int* __restrict__ gid,
                       const int* __restrict__ bits,
                       const float* __restrict__ depth,
                       const int* __restrict__ seg_ws,
                       const int* __restrict__ seg_we,
                       const int* __restrict__ base_w,
                       const int* __restrict__ lim_w, int cap_w,
                       int* __restrict__ out_gid,
                       float* __restrict__ out_depth) {
    const int sp = blockIdx.x;
    const int s = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    const int w0 = seg_ws[sp], w1 = seg_we[sp];
    const int o = sp * STREAMS + s;
    const long long hi = (long long)min(lim_w[o], cap_w) * CHUNK;
    long long dst = (long long)base_w[o] * CHUNK;   // the stream's cursor
    // dst is the same in every lane, so the loop (and each ballot) is
    // warp-uniform.
    for (int w = w0; w < w1 && dst < hi; ++w) {
#pragma unroll
        for (int c = 0; c < CHUNK / 32; ++c) {
            const int j = c * 32 + lane;
            const long long slot = (long long)w * CHUNK + j;
            const bool hit = (bits[slot] >> s) & 1;
            const unsigned ballot = __ballot_sync(FULL, hit);
            const long long d = dst + __popc(ballot & below);
            if (hit && d < hi) {
                out_gid[d] = gid[slot];
                out_depth[d] = depth[((long long)w * STREAMS + s) * CHUNK + j];
            }
            dst += __popc(ballot);
        }
    }
}

extern "C" int compact_streams(const void* gid, const void* bits,
                               const void* depth, const void* seg_ws,
                               const void* seg_we, const void* base_w,
                               const void* lim_w, int n_seg, int cap_w,
                               void* out_gid, void* out_depth, void* stream) {
    if (n_seg > 0) {
        compact_streams_kernel<<<n_seg, STREAMS * 32, 0,
                                 (cudaStream_t)stream>>>(
            (const int*)gid, (const int*)bits, (const float*)depth,
            (const int*)seg_ws, (const int*)seg_we, (const int*)base_w,
            (const int*)lim_w, cap_w, (int*)out_gid, (float*)out_depth);
    }
    return (int)cudaGetLastError();
}
