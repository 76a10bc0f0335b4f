// B5 and B6: deterministic per-particle sums of cotangent rows over
// contiguous segments (the scatter-free transpose of the slot gather).
//
// Replaces: threedgrut_tpu/ops/pallas/segment_sum.py segment_sum_rows (B5,
// entry segment_sum_rows: segment p is [min(ends[p-1], cap),
// min(ends[p], cap))) and segment_sum_rows_by_ids (B6, entry
// segment_sum_rows_by_ids: segment p is the run of rows whose sorted id
// equals p; ids >= n fall in no segment and are dropped).
//
// Rows are [m, NCH] row-major, already grouped by particle (a stable sort
// by id); the output is [n, NCH]. B5 takes the 3DGUT packed row (NCH = 16);
// B6 is instantiated for 16 (3DGUT) and 64 channels (the 3DGRT candidate
// row). A thread adds its segment's rows in order for one channel (B5, B6
// at 64: VEC_64) or four (B6 at 16: VEC_16, one 16-byte load a row), so
// neighbouring threads read neighbouring channels of one row and every sum
// is the same sequential f32 sum on every run: no atomics, deterministic.
// The TPU kernel reduced 256-slot windows with one-hot matmuls on its
// matrix unit; here the sum is a plain loop (`segment_walk`).
//
// Bound on this card: bytes. Each row is read once (4 NCH B) and each
// output written once (4 NCH B per particle, plus the 4-byte ends or ids);
// one add per element. For B6 the latency of finding a segment matters
// more than bytes: two lower_bound searches of the ids per particle would
// put ~2 x log2(m) dependent loads before its first row (on an H100 such
// a B6 took 3-5x this one's time, golden/digest.py --time). So a first
// pass (`segment_starts_kernel`, one thread per row boundary, reading the
// ids once and coalesced) writes starts[p] = lower_bound(ids, p) for every
// p <= n: the row r with min(ids[r-1], n) < p <= min(ids[r], n) writes
// them all (a long gap by its whole warp, 32 entries a step). Each entry
// has exactly one writer, so there are no atomics. The walk then reads
// (starts[p], starts[p+1]) like B5 reads its ends. The pass is a kernel of
// its own because the walk needs every start written (a grid-wide order);
// the C entry launches both, on one stream.
//
// A particle's long segment (hundreds of rows for a particle in many
// walked bundles) is walked by its own threads alone, one dependent load
// latency per batch of ROW_BATCH rows, loaded before they are added in
// order. At 64 channels that tail sets the time: one channel a thread
// keeps a batch's loads in flight, where with four channels a thread
// (4 registers a row) ptxas kept only ~2 rows in flight. At 16 channels
// the segments are short and four channels a thread, a quarter of the
// threads, is faster.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int NCH = 16;          // B5's row width
constexpr unsigned FULL = 0xffffffffu;
constexpr int ROW_BATCH = 16;    // rows loaded before they are added (in order)
constexpr int VEC_16 = 4;        // B6's channels per thread at 16 channels
constexpr int VEC_64 = 1;        // and at 64
constexpr int THREADS = 256;     // every kernel's block

static int grid_for(long long threads) {
    return (int)((threads + THREADS - 1) / THREADS);
}

// V consecutive floats at p (4 V-byte aligned), loaded or stored at once
// (V 4: one 16-byte access; V 1: one float).
template <int V> struct Vec { float x[V]; };
template <int V>
__device__ __forceinline__ Vec<V> load_vec(const float* __restrict__ p) {
    Vec<V> v;
    if constexpr (V == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        v.x[0] = t.x; v.x[1] = t.y; v.x[2] = t.z; v.x[3] = t.w;
    } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v.x[i] = p[i];
    }
    return v;
}
template <int V>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const Vec<V>& v) {
    if constexpr (V == 4) {
        *reinterpret_cast<float4*>(p) =
            make_float4(v.x[0], v.x[1], v.x[2], v.x[3]);
    } else {
#pragma unroll
        for (int i = 0; i < V; ++i) p[i] = v.x[i];
    }
}

// The sums of columns [c, c + V) of rows [lo, hi) of the [*, W] rows g,
// each column's added one row after the other from 0.
template <int W, int V>
__device__ __forceinline__ Vec<V> segment_walk(const float* __restrict__ g,
                                               int lo, int hi, int c) {
    Vec<V> s;
#pragma unroll
    for (int i = 0; i < V; ++i) s.x[i] = 0.0f;
    int r = lo;
    for (; r + ROW_BATCH <= hi; r += ROW_BATCH) {
        Vec<V> v[ROW_BATCH];
#pragma unroll
        for (int k = 0; k < ROW_BATCH; ++k)
            v[k] = load_vec<V>(g + (size_t)(r + k) * W + c);
#pragma unroll
        for (int k = 0; k < ROW_BATCH; ++k)
#pragma unroll
            for (int i = 0; i < V; ++i) s.x[i] = s.x[i] + v[k].x[i];
    }
    for (; r < hi; ++r) {
        const Vec<V> v = load_vec<V>(g + (size_t)r * W + c);
#pragma unroll
        for (int i = 0; i < V; ++i) s.x[i] = s.x[i] + v.x[i];
    }
    return s;
}

__global__ void segment_sum_rows_kernel(const float* __restrict__ g,
                                        const int* __restrict__ ends,
                                        int cap, int n,
                                        float* __restrict__ out) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)n * NCH) return;
    const int p = (int)(t / NCH), c = (int)(t % NCH);
    const int lo = p > 0 ? min(ends[p - 1], cap) : 0;
    const int hi = min(ends[p], cap);
    out[t] = segment_walk<NCH, 1>(g, lo, hi, c).x[0];
}

// Thread r in [0, m] writes starts[p] = r for p in (prev, cur], prev =
// ids[r-1] (-1 at r = 0) and cur = ids[r] (n at r = m), both clamped to
// [-1, n]. Ranges longer than a warp are written by the whole warp.
__global__ void segment_starts_kernel(const int* __restrict__ ids, int m,
                                      int n, int* __restrict__ starts) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31;
    int lo = 0, hi = 0;                       // the entries [lo, hi)
    if (t <= m) {
        const int r = (int)t;
        const int prev = r > 0 ? min(max(ids[r - 1], -1), n) : -1;
        const int cur = r < m ? min(max(ids[r], -1), n) : n;
        lo = prev + 1;
        hi = max(cur + 1, lo);
    }
    const bool alone = hi - lo <= 32;
    if (alone)
        for (int p = lo; p < hi; ++p) starts[p] = (int)t;
    unsigned wide = __ballot_sync(FULL, !alone);
    while (wide) {
        const int src = __ffs(wide) - 1;
        wide &= wide - 1;
        const int a = __shfl_sync(FULL, lo, src);
        const int b = __shfl_sync(FULL, hi, src);
        const int r = __shfl_sync(FULL, (int)t, src);
        for (int p = a + lane; p < b; p += 32) starts[p] = r;
    }
}

// Thread t sums channels [V c, V c + V) of particle p (t = p W / V + c).
template <int W, int V>
__global__ void segment_sum_rows_by_ids_kernel(const float* __restrict__ g,
                                               const int* __restrict__ starts,
                                               int n,
                                               float* __restrict__ out) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)n * (W / V)) return;
    const int p = (int)(t / (W / V)), c = (int)(t % (W / V)) * V;
    store_vec<V>(out + (size_t)p * W + c,
                 segment_walk<W, V>(g, starts[p], starts[p + 1], c));
}

template <int W, int V>
static void launch_walk(const float* g, const int* starts, int n, float* out,
                        cudaStream_t s) {
    // Rows are 4 W-byte aligned when g is: the vector loads need g and out
    // on 4 V-byte boundaries (a view into a tensor may not be).
    if (((uintptr_t)g | (uintptr_t)out) % (4 * V) == 0)
        segment_sum_rows_by_ids_kernel<W, V>
            <<<grid_for((long long)n * (W / V)), THREADS, 0, s>>>(
                g, starts, n, out);
    else
        segment_sum_rows_by_ids_kernel<W, 1>
            <<<grid_for((long long)n * W), THREADS, 0, s>>>(
                g, starts, n, out);
}


extern "C" int segment_sum_rows(const void* g, const void* ends, int cap,
                                int n, void* out, void* stream) {
    if (n > 0) {
        segment_sum_rows_kernel<<<grid_for((long long)n * NCH), THREADS, 0,
                                  (cudaStream_t)stream>>>(
            (const float*)g, (const int*)ends, cap, n, (float*)out);
    }
    return (int)cudaGetLastError();
}

// nch: 16 or 64 (the wrapper refuses other widths). starts: [n + 1] int32
// scratch, written by the first pass and read by the second.
extern "C" int segment_sum_rows_by_ids(const void* g, const void* ids, int m,
                                       int n, int nch, void* starts,
                                       void* out, void* stream) {
    if (nch != 16 && nch != 64) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        segment_starts_kernel<<<grid_for((long long)m + 1), THREADS, 0, s>>>(
            (const int*)ids, m, n, (int*)starts);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        if (nch == 16)
            launch_walk<16, VEC_16>((const float*)g, (const int*)starts, n,
                                    (float*)out, s);
        else
            launch_walk<64, VEC_64>((const float*)g, (const int*)starts, n,
                                    (float*)out, s);
    }
    return (int)cudaGetLastError();
}

// Blocks of THREADS threads an SM holds at once, as the CUDA runtime
// computes them (cudaOccupancyMaxActiveBlocksPerMultiprocessor), of B5's
// kernel, B6's first pass and B6's walk <16, VEC_16>, <16, 1> and <64, VEC_64>,
// into out[0..4]. Returns a CUDA error, 0 on success.
extern "C" int segment_sum_blocks_per_sm(int* out) {
    const void* kernels[] = {
        (const void*)segment_sum_rows_kernel,
        (const void*)segment_starts_kernel,
        (const void*)segment_sum_rows_by_ids_kernel<16, VEC_16>,
        (const void*)segment_sum_rows_by_ids_kernel<16, 1>,
        (const void*)segment_sum_rows_by_ids_kernel<64, VEC_64>};
    for (int i = 0; i < 5; ++i) {
        const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[i], kernels[i], THREADS, 0);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
