// B8: the backward of the 3DGRT bundle compositor (B7).
//
// Replaces: threedgrut_tpu/ops/pallas/bundle_trace.py _backward_windows
// (_backward_kernel), reached through bundle_composite's _bwd_rule and the
// fused walked-window backward (ops/fused_raster.py composite_bundles).
//
// Blocks of one thread per ray (256), the forward's shape: a block takes
// bundles one after another (an atomic counter hands them out) and re-walks
// each bundle's windows, loading each 128-row window (32 KB) into shared
// memory, and stops where the forward stopped
// (__syncthreads_or(carry > min_transmittance) after a window). Every pair
// goes through the forward's definitions (bundle_pair.cuh, tile_pair.cuh);
// with --fmad=false both kernels see the same alpha, colour and
// transmittance, so a ray's weight w > 0 here iff it was > 0 in B7.
//
// Per ray, the suffix sum_{k after j} w_k q_k (q = colour . dC + hit_t dD +
// dO, colour clamped at 0) is the residual a_tot - prefix_j, with a_tot
// rebuilt from the forward's rows 0-4 and the prefix running over the ray's
// COMPOSITING order (the `passes` odd-even re-sort of the window, as in B7)
// across all the windows walked. Then
//   d_alpha = T_before q_j - (suffix + dT t_final) / max(1 - alpha, 1e-6)
// chains through alpha = min(opacity resp(g), max_alpha) (only where
// alpha_raw < max_alpha), g = |v x u|^2 / |v|^2 and hit_t = |v.u| / |v|^2 to
// du, dv in the exact cross-product form, and to the 64 per-slot row
// entries: dA[r][k] = du_r (o - mean)_k + dv_r d_k (9), dmean_k = -sum_r
// A[r][k] sum_rays du_r (3), dopacity = resp d_alpha, rows 13-15 exactly 0,
// and the SH rows basis_k w dC_c [raw colour_c > 0] (48; rows past
// (sh_degree + 1)^2 are 0). Rays with w == 0 contribute exactly 0.
//
// Layout. The sum over a row's 256 rays needs every ray at the same row, but
// each ray finds its suffix walking its own compositing order, so the
// window takes two passes. Pass A walks the ray's order once and, for each
// counted row (w > 0), stores w and d_alpha by ROW in the block's slot of
// an L2-resident scratch ([slot][row][ray] float2; a slot per resident
// block, 256 KB) and a flag byte (counted, and the three colour gates) in a
// column of dynamic shared memory ([128][256] bytes, 32 KB, zeroed per live
// ray-window); rows past the walk's end are never stored. With passes > 0
// (SORTED) the order is the one B7 wrote for this ray and window (`order`,
// a word per four positions, a row index per byte with its top bit set
// where the sorted key is < 3.4e38): pass A runs no network, evaluates a
// pair only at those positions, and stops at the first T_before <= min_T
// (exact: T_before never grows, as 0 <= alpha <= 1). Without passes it
// walks the rows in order. Pass B, in row order, reads each row's flags,
// re-evaluates pair_eval for the row's counted rays, forms the 64 values
// and sums them over the block in a fixed order: a transposing warp
// butterfly (62 shuffles leave each lane with two fields' warp sums; a warp
// with no live lane skips it), then the 8 warps' partials in order through
// shared memory, SUB rows at a time, one thread per (row, field) for the
// write. Each window belongs to one bundle, so each gradient row is written
// once by one block: no atomics in the sums, bit-identical on every run.
// The wrapper zeroes the output; windows the walk never reached stay
// exactly 0. At most 128 registers and 72 KB of shared memory leave two
// blocks (16 warps) per SM.
//
// Bound on this card: operations against 67 TFLOP/s f32. The pair math,
// gates and compositing step (~86, as B7) wherever the walk evaluates a
// pair (every live (ray, row) without passes, only the live hits on B7's
// orders); per counted pair (w > 0) the gradient chain (~280: the colour
// and suffix ~120, the pair chain ~110, the 48 SH products and 3 gates)
// and the 61 adds that sum its row over the bundle. Device memory sees 32
// KB read per walked window, the [capF, 64] output written once (the zero
// fill included), 24 KB of rays, forward output and cotangent per bundle
// and, with passes, 128 bytes of order per live ray-window (the scratch's 8
// bytes per counted pair stay in L2). Pass A's walk is serial per ray, and
// pass B's butterfly runs for every row some lane of a warp counted, so the
// kernel is bound by instruction issue.
#include "bundle_pair.cuh"

#define SUB 4            // rows per cross-warp reduction batch
#define FULL 0xffffffffu

static_assert(SUB * ROW64 == PIX, "one thread per (row, field) of a batch");

namespace {

// Sum 64 values over the 32 lanes of a warp. On return lane l holds, in v[0]
// and v[1], the warp sums of fields f and f + 1, f = 32 b4 + 16 b3 + 8 b2 +
// 4 b1 + 2 b0 (bk = bit k of l).
__device__ __forceinline__ void warp_sum64(float v[ROW64], int lane) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        const bool up = lane & 16;
        const float send = up ? v[i] : v[i + 32];
        const float keep = up ? v[i + 32] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, 16);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        const bool up = lane & 8;
        const float send = up ? v[i] : v[i + 16];
        const float keep = up ? v[i + 16] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, 8);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const bool up = lane & 4;
        const float send = up ? v[i] : v[i + 8];
        const float keep = up ? v[i + 8] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, 4);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const bool up = lane & 2;
        const float send = up ? v[i] : v[i + 4];
        const float keep = up ? v[i + 4] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const bool up = lane & 1;
        const float send = up ? v[i] : v[i + 2];
        const float keep = up ? v[i + 2] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, 1);
    }
}

// The 64 gradient entries of one counted pair (w > 0) of row q.
__device__ __forceinline__ void pair_grads(
        const float* q, const Ray& ray, const float* bs, int nbasis,
        float w, float d_alpha, unsigned char gates, float dCr, float dCg,
        float dCb, float dD, int degree, float min_response, float min_alpha,
        float max_alpha, float v[ROW64]) {
    const Pair s = pair_eval(q, ray, degree, min_response, min_alpha,
                             max_alpha, 1);
    const bool unclamped = s.alpha_raw < max_alpha;
    const float d_resp = unclamped ? q[12] * d_alpha : 0.0f;
    const float d_opa = unclamped ? s.resp * d_alpha : 0.0f;
    const float d_g = d_resp * kernel_response_grad(s.g, s.resp, degree);
    const float d_hit = w * dD;
    const float sgn = (float)((s.vdotu > 0.0f) - (s.vdotu < 0.0f));
    const float d_m = sgn * s.inv_vsq * d_hit;
    const float d_crsq = d_g * s.inv_vsq;
    const float d_vsq = (-s.g * s.inv_vsq) * d_g
                        + (-s.hit_t * s.inv_vsq) * d_hit;
    const float crxv0 = s.cy * s.vz - s.cz * s.vy;
    const float crxv1 = s.cz * s.vx - s.cx * s.vz;
    const float crxv2 = s.cx * s.vy - s.cy * s.vx;
    const float uxcr0 = s.uy * s.cz - s.uz * s.cy;
    const float uxcr1 = s.uz * s.cx - s.ux * s.cz;
    const float uxcr2 = s.ux * s.cy - s.uy * s.cx;
    const float du[3] = {2.0f * d_crsq * crxv0 + d_m * s.vx,
                         2.0f * d_crsq * crxv1 + d_m * s.vy,
                         2.0f * d_crsq * crxv2 + d_m * s.vz};
    const float dv[3] = {
        2.0f * d_crsq * uxcr0 + d_m * s.ux + 2.0f * d_vsq * s.vx,
        2.0f * d_crsq * uxcr1 + d_m * s.uy + 2.0f * d_vsq * s.vy,
        2.0f * d_crsq * uxcr2 + d_m * s.uz + 2.0f * d_vsq * s.vz};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        v[3 * r + 0] = du[r] * s.w0x + dv[r] * ray.dx;
        v[3 * r + 1] = du[r] * s.w0y + dv[r] * ray.dy;
        v[3 * r + 2] = du[r] * s.w0z + dv[r] * ray.dz;
        v[9 + r] = du[r];                 // summed, then -A^T sum du
    }
    v[12] = d_opa;
    const float wd[3] = {(gates & 1) ? w * dCr : 0.0f,
                         (gates & 2) ? w * dCg : 0.0f,
                         (gates & 4) ? w * dCb : 0.0f};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int k = 0; k < 16; ++k)
            v[16 + 16 * c + k] = k < nbasis ? bs[k] * wd[c] : 0.0f;
    }
}

}  // namespace

template <bool SORTED>
__global__ void __launch_bounds__(PIX, 2)
bundle_trace_bwd_kernel(const float* __restrict__ data,
                        const int* __restrict__ win_starts,
                        const int* __restrict__ win_ends,
                        const float* __restrict__ rays,
                        const float* __restrict__ fwd,
                        const float* __restrict__ gout,
                        const unsigned* __restrict__ order,
                        float2* __restrict__ scratch,
                        int* __restrict__ next_bundle,
                        float* __restrict__ grad, int num_bundles,
                        int num_windows, int degree, int sh_degree,
                        float min_transmittance, float min_response,
                        float min_alpha, float max_alpha) {
    __shared__ __align__(16) float rows[CHUNK * ROW64];
    __shared__ float part[PIX / 32][SUB][ROW64];
    __shared__ int taken;
    // Pass A's flag bytes (ray index fastest): byte r & 3 of word
    // [r >> 2][PIX] for row r; bit 3 counted, bits 0-2 the colour gates.
    extern __shared__ unsigned flags[];

    const int p = threadIdx.x;
    const int lane = p & 31, warp = p >> 5;
    unsigned* fcol = flags + p;
    // This block's slot of the scratch: w and d_alpha by [row][ray].
    float2* scol = scratch + (size_t)blockIdx.x * CHUNK * PIX + p;

    for (;;) {
        if (p == 0) taken = atomicAdd(next_bundle, 1);
        __syncthreads();
        const int bnd = taken;
        if (bnd >= num_bundles) break;
        const float* rb = rays + (size_t)bnd * 8 * PIX;
        const float* fo = fwd + (size_t)bnd * 8 * PIX;
        const float* go = gout + (size_t)bnd * 8 * PIX;
        const Ray ray = load_ray(rb, p);
        float carry = rb[7 * PIX + p];
        float bs[16];
        sh_basis(ray.dx, ray.dy, ray.dz, sh_degree, bs);
        const int nbasis = (sh_degree + 1) * (sh_degree + 1);
        const float dCr = go[0 * PIX + p], dCg = go[1 * PIX + p],
                    dCb = go[2 * PIX + p], dO = go[3 * PIX + p],
                    dD = go[4 * PIX + p], dT = go[5 * PIX + p];
        const float t_final = fo[5 * PIX + p];
        const float a_tot = fo[0 * PIX + p] * dCr + fo[1 * PIX + p] * dCg
                            + fo[2 * PIX + p] * dCb + fo[3 * PIX + p] * dO
                            + fo[4 * PIX + p] * dD;
        float prefix = 0.0f;

        const int w0 = min(max(win_starts[bnd], 0), num_windows);
        const int w1 = min(max(win_ends[bnd], w0), num_windows);
        int g = w0;
        while (g < w1) {
            const float4* src = reinterpret_cast<const float4*>(
                data + (size_t)g * CHUNK * ROW64);
            float4* dst = reinterpret_cast<float4*>(rows);
#pragma unroll
            for (int i = 0; i < CHUNK * ROW64 / 4 / PIX; ++i)
                dst[p + i * PIX] = src[p + i * PIX];
            __syncthreads();

            // Pass A: the forward's walk of this ray, in compositing order.
            const bool ray_live = carry > min_transmittance;
            if (ray_live) {
#pragma unroll
                for (int i = 0; i < CHUNK / 4; ++i) fcol[i * PIX] = 0u;
                const unsigned* ord =
                    SORTED ? order + (size_t)g * (CHUNK / 4) * PIX + p
                           : nullptr;
                float prod = 1.0f, tmin = BIG;
                unsigned word = 0u;
                for (int k = 0; k < CHUNK; ++k) {
                    const float t_before = carry * prod;
                    if (!(t_before > min_transmittance)) break;
                    int r = k;
                    if constexpr (SORTED) {
                        if ((k & 3) == 0) word = __ldg(ord + (k >> 2) * PIX);
                        const unsigned b = (word >> (8 * (k & 3))) & 0xffu;
                        if (!(b & HIT)) {
                            // alpha 0: the product stands, and
                            // T_before (1 - 0) = T_before.
                            tmin = fminf(tmin, t_before);
                            continue;
                        }
                        r = (int)(b & 0x7fu);
                    }
                    const float* q = rows + r * ROW64;
                    float hit_t;
                    const float alpha = row_alpha(q, ray, degree,
                                                  min_response, min_alpha,
                                                  max_alpha, &hit_t);
                    const float one_m = 1.0f - alpha;
                    const float w = alpha * t_before;
                    if (w > 0.0f) {
                        float c[3];
                        raw_colours(q, bs, nbasis, c);
                        const float qj = fmaxf(c[0], 0.0f) * dCr
                                         + fmaxf(c[1], 0.0f) * dCg
                                         + fmaxf(c[2], 0.0f) * dCb
                                         + hit_t * dD + dO;
                        prefix = prefix + w * qj;
                        const float suffix = a_tot - prefix;
                        const float inv_one_m = 1.0f / fmaxf(one_m, 1e-6f);
                        const float d_alpha = t_before * qj
                                              - suffix * inv_one_m
                                              - dT * t_final * inv_one_m;
                        scol[r * PIX] = make_float2(w, d_alpha);
                        reinterpret_cast<unsigned char*>(
                            fcol + (r >> 2) * PIX)[r & 3] =
                            (unsigned char)(8 | (c[0] > 0.0f)
                                            | ((c[1] > 0.0f) << 1)
                                            | ((c[2] > 0.0f) << 2));
                    }
                    tmin = fminf(tmin, t_before * one_m);
                    prod *= one_m;
                }
                carry = fminf(tmin, carry);
            }

            // Pass B: row order, the 64 entries summed over the bundle's
            // rays.
            for (int kb = 0; kb < CHUNK; kb += SUB) {
                for (int j = 0; j < SUB; ++j) {
                    const int r = kb + j;
                    float v[ROW64];
#pragma unroll
                    for (int i = 0; i < ROW64; ++i) v[i] = 0.0f;
                    const unsigned f =
                        ray_live ? (fcol[(r >> 2) * PIX] >> (8 * (r & 3)))
                                       & 0xffu
                                 : 0u;
                    const bool live = f & 8u;
                    if (live) {
                        const float2 wd = scol[r * PIX];
                        pair_grads(rows + r * ROW64, ray, bs, nbasis, wd.x,
                                   wd.y, (unsigned char)(f & 7u), dCr, dCg,
                                   dCb, dD, degree, min_response, min_alpha,
                                   max_alpha, v);
                    }
                    if (__any_sync(FULL, live)) {
                        warp_sum64(v, lane);
                        const int fl = 32 * ((lane >> 4) & 1)
                                       + 16 * ((lane >> 3) & 1)
                                       + 8 * ((lane >> 2) & 1)
                                       + 4 * ((lane >> 1) & 1)
                                       + 2 * (lane & 1);
                        part[warp][j][fl] = v[0];
                        part[warp][j][fl + 1] = v[1];
                    } else {
                        part[warp][j][lane] = 0.0f;
                        part[warp][j][lane + 32] = 0.0f;
                    }
                }
                __syncthreads();
                {
                    // Cross-warp sums in warp order; one thread per (row,
                    // field).
                    const int j = p / ROW64, fl = p % ROW64;
                    float val;
                    if (fl >= 9 && fl < 12) {
                        // dmean_k = -sum_r A[r][k] sum_rays du_r
                        const float* q = rows + (kb + j) * ROW64;
                        float su[3];
                        for (int r = 0; r < 3; ++r) {
                            su[r] = part[0][j][9 + r];
                            for (int i = 1; i < PIX / 32; ++i)
                                su[r] = su[r] + part[i][j][9 + r];
                        }
                        const int k = fl - 9;
                        val = -(q[k] * su[0] + q[3 + k] * su[1]
                                + q[6 + k] * su[2]);
                    } else {
                        val = part[0][j][fl];
                        for (int i = 1; i < PIX / 32; ++i)
                            val = val + part[i][j][fl];
                    }
                    grad[((size_t)g * CHUNK + kb + j) * ROW64 + fl] = val;
                }
                __syncthreads();
            }
            // The walk stops exactly where the forward's did.
            const int alive = __syncthreads_or(carry > min_transmittance);
            ++g;
            if (!alive) break;
        }
        // Every thread has read `taken` before the next bundle is taken.
        __syncthreads();
    }
}

// Pass A's flag bytes: [CHUNK][PIX] (32 KB of dynamic shared memory).
constexpr int FLAG_SMEM = CHUNK * PIX;

template <bool SORTED>
static cudaError_t prepare_bwd() {
    return cudaFuncSetAttribute(bundle_trace_bwd_kernel<SORTED>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                FLAG_SMEM);
}

// The blocks of a launch, and so the scratch slots it needs: the blocks the
// card holds at once (at most num_bundles). Negative: a CUDA error.
extern "C" int bundle_trace_bwd_slots(int num_bundles, int passes) {
    cudaError_t err = passes > 0 ? prepare_bwd<true>() : prepare_bwd<false>();
    int per_sm = 0, dev = 0, sms = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm,
            passes > 0 ? bundle_trace_bwd_kernel<true>
                       : bundle_trace_bwd_kernel<false>,
            PIX, FLAG_SMEM);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return -(int)err;
    const int slots = per_sm * sms < num_bundles ? per_sm * sms : num_bundles;
    return slots > 1 ? slots : 1;
}

// `order` (passes > 0): the compositing orders B7 wrote for this forward
// ([num_windows, CHUNK / 4, PIX] words). `scratch`: [slots, CHUNK, PIX]
// float2, slots from bundle_trace_bwd_slots; `next_bundle`: one int, 0.
extern "C" int bundle_trace_bwd(const void* data, const void* win_starts,
                                const void* win_ends, const void* rays,
                                const void* fwd, const void* gout,
                                const void* order, void* scratch,
                                void* next_bundle, void* grad,
                                int num_bundles, int slots, int num_windows,
                                int degree, int sh_degree,
                                float min_transmittance, float min_response,
                                float min_alpha, float max_alpha, int passes,
                                void* stream) {
    if (num_bundles <= 0) return (int)cudaGetLastError();
    if (slots <= 0 || (passes > 0 && order == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaError_t err =
        passes > 0 ? prepare_bwd<true>() : prepare_bwd<false>();
    if (err != cudaSuccess) return (int)err;
    auto kernel = passes > 0 ? bundle_trace_bwd_kernel<true>
                             : bundle_trace_bwd_kernel<false>;
    kernel<<<slots, PIX, FLAG_SMEM, (cudaStream_t)stream>>>(
        (const float*)data, (const int*)win_starts, (const int*)win_ends,
        (const float*)rays, (const float*)fwd, (const float*)gout,
        (const unsigned*)order, (float2*)scratch, (int*)next_bundle,
        (float*)grad, num_bundles, num_windows, degree, sh_degree,
        min_transmittance, min_response, min_alpha, max_alpha);
    return (int)cudaGetLastError();
}
