// B7 forward: the 3DGRT bundle compositor.
//
// Replaces: threedgrut_tpu/ops/pallas/bundle_trace.py _forward
// (_forward_kernel), reached through bundle_composite and grt.trace's
// default "bundle" route.
//
// One block per bundle, one thread per ray (256). The bundle's windows
// [win_starts[b], win_ends[b]) of 128 candidate rows (64 floats each, 32 KB)
// are loaded one at a time into shared memory and read as broadcasts. Per
// (ray, row): pair_eval (tile_pair.cuh, the 3DGUT pair math, fields 0-12 of
// the row) plus the two gates of intersectCustomParticle, v.u < 0 (in front
// of the origin) and g <= 9 (canonical slab); alpha is 0 where not accepted.
// The gates, the SH basis and the colour live in bundle_pair.cuh, shared
// with the backward (B8), which must see exactly these hits.
//
// Per ray and window the semantics are the JAX kernel's: keys hit_t
// (alpha > 0) or 3.4e38 go through exactly `passes` passes of odd-even
// transposition (pass i: pairs (j, j+1), j = i mod 2, swap on key[j+1] <
// key[j]); the exclusive product of 1 - alpha in that order gives
// T_before = carry * excl; a row with T_before > min_T adds w = alpha *
// T_before to rgb (SH colour along the ray, max(0, coeffs . basis + 0.5)),
// opacity, depth (w hit_t) and hits (w > 0); the carry becomes min(carry,
// min over those rows of T_before (1 - alpha)). Alpha is taken only where
// the sorted key is < 3.4e38: a hit whose hit_t reaches 3.4e38 composites
// nothing. The block stops after the first window that leaves no ray with
// carry > min_T (__syncthreads_or); row 7 is the number of windows walked.
// A ray whose carry is already <= min_T skips the window: none of its rows
// can count, and its carry cannot change.
//
// Two legs, a compile-time template parameter:
//  * passes == 0: the network is the identity, and each ray composites its
//    window in row order, one pair evaluation per row, the basis in
//    registers.
//  * SORTED (passes > 0): the network runs in registers
//    (tile_pair.cuh oddeven_network_regs: 128 keys, the row indices four
//    bytes to a word, every position a compile-time constant, stopping
//    after an odd and an even quiet pass in a row, which is exact).
//    Columns of a dynamic shared buffer (the ray index fastest: no bank
//    conflicts) hold, per ray, the gated alpha of each row ([128][256],
//    128 KB), the keys of a quarter of the window on their way into
//    registers, later the order words ([32][256], 32 KB), and the ray
//    ([7][256], reloaded where needed instead of held beside the 160
//    network registers): 167 KB, 199 KB with the window. Each row's pair is
//    evaluated once, in row order and four rows per trip, for its alpha and
//    its key. Compositing then walks the sorted positions (unrolled: the
//    keys are registers) and reads alpha by row from the column and hit_t
//    from the sorted key; it adds opacity, depth and hits, keeps each
//    counted row's weight in the alpha column, and stops at the first
//    T_before <= min_T (exact: T_before never grows, as 0 <= alpha <= 1).
//    A rolled loop then adds the counted rows' colours in the same order,
//    each sum in the order of the single loop it replaces, so the outputs
//    are bit for bit those of the one-loop form. Given `order` (a
//    differentiable forward whose backward will run), each live
//    ray-window's compositing order goes there, a word per four positions
//    at [g][word][ray] for the absolute window g, each byte a row index
//    with its top bit set where the sorted key is < 3.4e38: B8 re-walks it
//    and runs no network. 255 registers and 199 KB leave one block (8
//    warps) per SM.
//
// Bound on this card: ~80 f32 operations per (live ray, walked row) for the
// pair math and gates and 6 for the compositing step (67 TFLOP/s), plus
// ~110 for the colour and sums per counted pair and 2 per compare-exchange
// of the passes each live ray-window runs; device memory sees 32 KB per
// walked window, 16 KB of rays and output per bundle and, with `order`, 128
// bytes per live ray-window.
#include "bundle_pair.cuh"

#define QUARTER (CHUNK / 4)  // rows of keys the sorted leg stages at a time

namespace {

struct Acc {
    float r, g, b, opa, dep, hits, tmin;
};

// One row in compositing order: T_before = carry * p; counted rows add
// their weight; p accumulates the product.
__device__ __forceinline__ void composite_row(
        const float* q, float alpha, float hit_t, float carry,
        float min_transmittance, const float* bs, int nbasis, float& p,
        Acc& a) {
    const float one_m = 1.0f - alpha;
    const float t_before = carry * p;
    if (t_before > min_transmittance) {
        const float w = alpha * t_before;
        if (w > 0.0f) {
            float c[3];
            raw_colours(q, bs, nbasis, c);
            a.r += w * fmaxf(c[0], 0.0f);
            a.g += w * fmaxf(c[1], 0.0f);
            a.b += w * fmaxf(c[2], 0.0f);
            a.opa += w;
            a.dep += w * hit_t;
            a.hits += 1.0f;
        }
        a.tmin = fminf(a.tmin, t_before * one_m);
    }
    p *= one_m;
}

// The hit bits of order word i: bit 7 of byte b where key[4 i + b] < BIG.
__device__ __forceinline__ unsigned hit_bits(const float (&key)[CHUNK],
                                             int i) {
    unsigned h = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
        h |= key[4 * i + b] < BIG ? HIT << (8 * b) : 0u;
    return h;
}

// The sorted leg's window for one live ray: Acc of the window, the sorted
// order written to `ord` (may be null).
__device__ __forceinline__ Acc sorted_window(
        const float* rows, float* acol, float* kcol, const float* rcol,
        unsigned* ord, float carry, int degree, int sh_degree,
        float min_transmittance, float min_response, float min_alpha,
        float max_alpha, int passes) {
    float key[CHUNK];
    unsigned idx[CHUNK / 4];
    // Alpha by row into its column and the keys, a quarter of the window
    // at a time through `kcol`, into registers.
#pragma unroll
    for (int h = 0; h < 4; ++h) {
        {
            const Ray ray = stashed_ray(rcol);
#pragma unroll 4
            for (int i = h * QUARTER; i < (h + 1) * QUARTER; ++i) {
                float hit_t;
                const float alpha = row_alpha(rows + i * ROW64, ray, degree,
                                              min_response, min_alpha,
                                              max_alpha, &hit_t);
                acol[i * PIX] = alpha;
                kcol[(i - h * QUARTER) * PIX] = alpha > 0.0f ? hit_t : BIG;
            }
        }
#pragma unroll
        for (int i = 0; i < QUARTER; ++i)
            key[h * QUARTER + i] = kcol[i * PIX];
    }
    window_rows_init(idx);
    oddeven_network_regs(key, idx, passes);
    // The order words with their hit bits: in `kcol` for the colour loop
    // below, and in `ord` for B8.
    unsigned* icol = reinterpret_cast<unsigned*>(kcol);
#pragma unroll
    for (int i = 0; i < CHUNK / 4; ++i) {
        const unsigned word = idx[i] | hit_bits(key, i);
        icol[i * PIX] = word;
        if (ord != nullptr) ord[i * PIX] = word;
    }
    // Compositing order: opacity, depth, hits and the carry; each counted
    // row's weight replaces its alpha in the column (each row is read once).
    Acc a = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, BIG};
    float prod = 1.0f;
    int kend = CHUNK;
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
        const float t_before = carry * prod;
        if (!(t_before > min_transmittance)) {
            kend = k;
            break;
        }
        float one_m = 1.0f;
        if (key[k] < BIG) {
            float* ak = acol + window_row(idx, k) * PIX;
            const float alpha = *ak;
            one_m = 1.0f - alpha;
            const float w = alpha * t_before;
            if (w > 0.0f) {
                a.opa += w;
                a.dep += w * key[k];
                a.hits += 1.0f;
            }
            *ak = w;
        }
        a.tmin = fminf(a.tmin, t_before * one_m);
        prod *= one_m;
    }
    // The counted rows' colours, in the same order.
    const Ray ray = stashed_ray(rcol);
    float bs[16];
    sh_basis(ray.dx, ray.dy, ray.dz, sh_degree, bs);
    const int nbasis = (sh_degree + 1) * (sh_degree + 1);
    for (int k = 0; k < kend; ++k) {
        const unsigned b = (icol[(k >> 2) * PIX] >> (8 * (k & 3))) & 0xffu;
        if (!(b & HIT)) continue;
        const int row = (int)(b & 0x7fu);
        const float w = acol[row * PIX];
        if (w > 0.0f) {
            float c[3];
            raw_colours(rows + row * ROW64, bs, nbasis, c);
            a.r += w * fmaxf(c[0], 0.0f);
            a.g += w * fmaxf(c[1], 0.0f);
            a.b += w * fmaxf(c[2], 0.0f);
        }
    }
    return a;
}

}  // namespace

template <bool SORTED>
__global__ void __launch_bounds__(PIX)
bundle_trace_fwd_kernel(const float* __restrict__ data,
                        const int* __restrict__ win_starts,
                        const int* __restrict__ win_ends,
                        const float* __restrict__ rays,
                        float* __restrict__ out,
                        unsigned* __restrict__ order, int num_windows,
                        int degree, int sh_degree, float min_transmittance,
                        float min_response, float min_alpha, float max_alpha,
                        int passes) {
    __shared__ __align__(16) float rows[CHUNK * ROW64];
    // The sorted leg's columns (ray index fastest): alpha by row
    // [CHUNK][PIX], the keys of a quarter window, then the order words
    // [QUARTER][PIX], and the ray [7][PIX].
    extern __shared__ float win[];

    const int bnd = blockIdx.x;
    const int p = threadIdx.x;
    const float* rb = rays + (size_t)bnd * 8 * PIX;
    float carry = rb[7 * PIX + p];
    float* acol = win + p;
    float* kcol = win + CHUNK * PIX + p;
    float* rcol = win + (CHUNK + QUARTER) * PIX + p;
    Ray ray;
    float bs[16];
    int nbasis = 0;
    if constexpr (SORTED) {
        stash_ray(rcol, load_ray(rb, p));
    } else {
        ray = load_ray(rb, p);
        sh_basis(ray.dx, ray.dy, ray.dz, sh_degree, bs);
        nbasis = (sh_degree + 1) * (sh_degree + 1);
    }

    const int w0 = min(max(win_starts[bnd], 0), num_windows);
    const int w1 = min(max(win_ends[bnd], w0), num_windows);
    Acc tot = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    int g = w0;
    while (g < w1) {
        // Cooperative load of the window: 2048 float4, eight per thread.
        const float4* src = reinterpret_cast<const float4*>(
            data + (size_t)g * CHUNK * ROW64);
        float4* dst = reinterpret_cast<float4*>(rows);
#pragma unroll
        for (int i = 0; i < CHUNK * ROW64 / 4 / PIX; ++i)
            dst[p + i * PIX] = src[p + i * PIX];
        __syncthreads();

        if (carry > min_transmittance) {
            Acc a;
            if constexpr (SORTED) {
                unsigned* ord = order == nullptr
                                    ? nullptr
                                    : order + (size_t)g * (CHUNK / 4) * PIX
                                          + p;
                a = sorted_window(rows, acol, kcol, rcol, ord, carry, degree,
                                  sh_degree, min_transmittance, min_response,
                                  min_alpha, max_alpha, passes);
            } else {
                a = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, BIG};
                float prod = 1.0f;
                for (int r = 0; r < CHUNK; ++r) {
                    const float* q = rows + r * ROW64;
                    float hit_t;
                    const float alpha = row_alpha(q, ray, degree,
                                                  min_response, min_alpha,
                                                  max_alpha, &hit_t);
                    composite_row(q, alpha, hit_t, carry, min_transmittance,
                                  bs, nbasis, prod, a);
                }
            }
            tot.r += a.r;
            tot.g += a.g;
            tot.b += a.b;
            tot.opa += a.opa;
            tot.dep += a.dep;
            tot.hits += a.hits;
            carry = fminf(a.tmin, carry);
        }
        // The barrier also keeps `rows` until every thread is done with it.
        const int alive = __syncthreads_or(carry > min_transmittance);
        ++g;
        if (!alive) break;
    }

    float* o = out + (size_t)bnd * 8 * PIX;
    o[0 * PIX + p] = tot.r;
    o[1 * PIX + p] = tot.g;
    o[2 * PIX + p] = tot.b;
    o[3 * PIX + p] = tot.opa;
    o[4 * PIX + p] = tot.dep;
    o[5 * PIX + p] = carry;
    o[6 * PIX + p] = tot.hits;
    o[7 * PIX + p] = (float)(g - w0);
}

// The sorted leg's dynamic shared buffer: alpha by row [CHUNK][PIX], a
// quarter window of keys (then the order words) [QUARTER][PIX] and the rays
// [7][PIX] (167 KB).
constexpr int SORTED_SMEM = (CHUNK + QUARTER + 7) * PIX * (int)sizeof(float);

// `order` (passes > 0, may be null): [num_windows, CHUNK / 4, PIX] words
// that receive each live ray-window's compositing order, for B8.
extern "C" int bundle_trace_fwd(const void* data, const void* win_starts,
                                const void* win_ends, const void* rays,
                                void* out, void* order, int num_bundles,
                                int num_windows, int degree, int sh_degree,
                                float min_transmittance, float min_response,
                                float min_alpha, float max_alpha, int passes,
                                void* stream) {
    if (num_bundles <= 0) return (int)cudaGetLastError();
    if (passes > 0) {
        const cudaError_t err = cudaFuncSetAttribute(
            bundle_trace_fwd_kernel<true>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, SORTED_SMEM);
        if (err != cudaSuccess) return (int)err;
        bundle_trace_fwd_kernel<true><<<num_bundles, PIX, SORTED_SMEM,
                                        (cudaStream_t)stream>>>(
            (const float*)data, (const int*)win_starts, (const int*)win_ends,
            (const float*)rays, (float*)out, (unsigned*)order, num_windows,
            degree, sh_degree, min_transmittance, min_response, min_alpha,
            max_alpha, passes);
    } else {
        if (order != nullptr) return (int)cudaErrorInvalidValue;
        bundle_trace_fwd_kernel<false><<<num_bundles, PIX, 0,
                                         (cudaStream_t)stream>>>(
            (const float*)data, (const int*)win_starts, (const int*)win_ends,
            (const float*)rays, (float*)out, nullptr, num_windows, degree,
            sh_degree, min_transmittance, min_response, min_alpha, max_alpha,
            0);
    }
    return (int)cudaGetLastError();
}

// Dynamic shared memory (bytes) of a launch with `passes`.
extern "C" int bundle_trace_fwd_smem(int passes) {
    return passes > 0 ? SORTED_SMEM : 0;
}
