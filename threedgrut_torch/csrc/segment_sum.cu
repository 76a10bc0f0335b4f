// B5 and B6: deterministic per-particle sums of cotangent rows over
// contiguous segments (the scatter-free transpose of the slot gather).
//
// Replaces: threedgrut_tpu/ops/pallas/segment_sum.py segment_sum_rows (B5,
// entry segment_sum_rows: segment p is [min(ends[p-1], cap),
// min(ends[p], cap))) and segment_sum_rows_by_ids (B6, entry
// segment_sum_rows_by_ids: segment p is the run of rows whose sorted id
// equals p, found by two lower_bound searches inside the kernel; ids >= n
// fall in no segment and are dropped).
//
// Rows are [m, NCH] row-major, already grouped by particle (a stable sort
// by id); the output is [n, NCH]. B5 takes the 3DGUT packed row (NCH = 16);
// B6 is instantiated for 16 (3DGUT) and 64 channels (the 3DGRT candidate
// row). One thread per (particle, channel) adds its segment's rows in order,
// so neighbouring threads read neighbouring channels of one row (64- or
// 256-byte runs) and every sum is the same sequential f32 sum on every run:
// no atomics, deterministic. The TPU kernel reduced 256-slot windows with
// one-hot matmuls on its matrix unit; here the sum is a plain loop. B6's two
// binary searches (log2(m) dependent loads) are run by the first lane of
// each particle's group within a warp (16 lanes at 16 channels; each of the
// two warps of a particle at 64) and broadcast to the group.
//
// Bound on this card: bytes. Each row is read once (4 NCH B) and each
// output written once (4 NCH B per particle, plus the 4-byte ends or ids);
// one add per element. A few particles cover many tiles or bundles, so
// their long segments are walked by one thread each and set the tail of the
// kernel.
#include <cuda_runtime.h>

#define NCH 16           // B5's row width
#define FULL 0xffffffffu

__global__ void segment_sum_rows_kernel(const float* __restrict__ g,
                                        const int* __restrict__ ends,
                                        int cap, int n,
                                        float* __restrict__ out) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)n * NCH) return;
    const int p = (int)(t / NCH), c = (int)(t % NCH);
    const int lo = p > 0 ? min(ends[p - 1], cap) : 0;
    const int hi = min(ends[p], cap);
    float s = 0.0f;
    for (int r = lo; r < hi; ++r) s = s + g[(size_t)r * NCH + c];
    out[t] = s;
}

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int lo,
                                           int hi, int x) {
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (a[mid] < x) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

template <int W>
__global__ void segment_sum_rows_by_ids_kernel(const float* __restrict__ g,
                                               const int* __restrict__ ids,
                                               int m, int n,
                                               float* __restrict__ out) {
    // The grid covers whole warps (blocks of 256 threads), so every lane
    // reaches the shuffles below. A particle's W channels are one group of
    // min(W, 32) lanes per warp it spans.
    constexpr int GROUP = W < 32 ? W : 32;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int p = (int)(t / W), c = (int)(t % W);
    int lo = 0, hi = 0;
    if (c % GROUP == 0 && p < n) {
        lo = lower_bound(ids, 0, m, p);
        hi = lower_bound(ids, lo, m, p + 1);
    }
    lo = __shfl_sync(FULL, lo, 0, GROUP);
    hi = __shfl_sync(FULL, hi, 0, GROUP);
    if (p >= n) return;
    float s = 0.0f;
    for (int r = lo; r < hi; ++r) s = s + g[(size_t)r * W + c];
    out[t] = s;
}

static int grid_for(int n, int nch) {
    const long long threads = (long long)n * nch;
    return (int)((threads + 255) / 256);
}

extern "C" int segment_sum_rows(const void* g, const void* ends, int cap,
                                int n, void* out, void* stream) {
    if (n > 0) {
        segment_sum_rows_kernel<<<grid_for(n, NCH), 256, 0,
                                  (cudaStream_t)stream>>>(
            (const float*)g, (const int*)ends, cap, n, (float*)out);
    }
    return (int)cudaGetLastError();
}

// nch: 16 or 64 (the wrapper refuses other widths).
extern "C" int segment_sum_rows_by_ids(const void* g, const void* ids, int m,
                                       int n, int nch, void* out,
                                       void* stream) {
    if (nch != 16 && nch != 64) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        const dim3 grid(grid_for(n, nch));
        cudaStream_t s = (cudaStream_t)stream;
        if (nch == 16)
            segment_sum_rows_by_ids_kernel<16><<<grid, 256, 0, s>>>(
                (const float*)g, (const int*)ids, m, n, (float*)out);
        else
            segment_sum_rows_by_ids_kernel<64><<<grid, 256, 0, s>>>(
                (const float*)g, (const int*)ids, m, n, (float*)out);
    }
    return (int)cudaGetLastError();
}
