// B1 forward: the 3DGUT tile compositor.
//
// Replaces: threedgrut_tpu/ops/pallas/tile_raster.py _forward
// (_forward_kernel), reached through tile_composite and gut.render; with
// `flags` non-null it is the emit_flags leg used by hit_visibility.
//
// One block per 16x16 tile, one thread per pixel (the tile_pack order). The
// tile's depth-sorted slots [start, end) are walked in batches aligned to
// absolute 128-slot windows, as the JAX windows are: the block loads a
// window's 128 rows of 16 floats (8 KB) into shared memory, then each thread
// composites the rows in order with the exact 3D ray-space response
//   u = A (o - mean), v = A d, g = |v x u|^2 / |v|^2,
//   alpha = min(opacity * resp(g), max_alpha),
// accepted if resp > min_response, alpha > min_alpha and the hit lies in the
// ray's segment (pair_eval in tile_pair.cuh, shared with the backward B2);
// while T > min_transmittance it adds w = alpha * T to rgb,
// opacity, depth (w |v.u| / |v|^2) and the hit count, then T *= 1 - alpha.
// After each window the block stops once no pixel has T > min_transmittance;
// row 7 reports the slots walked (the JAX kernel's `walked`).
//
// With flags, every in-range slot of a walked window gets the max of w over
// the tile's 256 pixels (warp shuffles, then shared memory). Slot ranges of
// tiles are disjoint, so there are no races; the wrapper pre-zeroes flags and
// slots past the early exit stay 0.
//
// Two legs are compile-time template parameters, so the default (0 passes,
// no row termination) compiles to the loop above and nothing else:
//  * SORTED (passes > 0, the "sorted" k-buffer mode): per pixel and window,
//    the keys (tile_pair.cuh pair_hit_t: hit_t of every row of the tile,
//    rows of other tiles pinned) go through the odd-even network, and the
//    pixel composites its window in that order: T_before = carry * (the
//    product of 1 - alpha before it), counted while T_before > min_T; the
//    carry becomes min(carry, min over counted rows of T_before (1 - alpha)).
//    A pixel whose carry is already <= min_T skips the window. The network
//    runs in registers (oddeven_network_regs: 128 keys, the row indices
//    packed four to a word). Per pixel, columns of a dynamic shared buffer
//    (the pixel index fastest: no bank conflicts) hold the gated alpha of
//    each row of the tile ([128][256], 128 KB), computed first while no key
//    is held, then the keys of half a window at a time on their way into
//    registers ([64][256]), and the pixel's ray ([7][256], reloaded where
//    needed instead of held beside the 160 network registers): 199 KB. The
//    pair is evaluated once per row for the keys' hit_t and once for alpha,
//    in row order and four rows per trip; compositing reads alpha there and
//    hit_t from the sorted keys. It starts at the tile's first row lo
//    (rows before it are pinned at -BIG and never move) and stops at the
//    first T_before <= min_T (exact: T_before never grows). Given `order`
//    (the train step's forward), it writes each pixel-window's compositing
//    order there, a word per four positions, for B2. A slot's flag
//    is the max of its row's weight over the pixels (atomicMax on the bits
//    of a non-negative float in shared memory: the max does not depend on
//    the order).
//  * ROWTERM (row_termination): rays row 7 holds each pixel's last-touch
//    slot lt; alpha is 0 past it (keys unchanged). The tile starts only if
//    some lt >= 128 w0, and stops after window g unless some pixel has
//    T > min_T and lt >= 128 (g + 1). A pixel whose lt lies before the
//    tile's first row of the window composites nothing there.
//
// Bound on this card: ~60 f32 operations per (pixel, walked slot) against
// 67 TFLOP/s; the rows come from shared memory as broadcasts, device memory
// sees only 64 bytes per walked slot. Design: no prefix scans (the TPU
// kernel's Hillis-Steele ladder and triangular matmuls existed only because
// its vector unit cannot run a per-pixel sequential loop); the sequential
// per-pixel recurrence is the cheapest exact form on a SIMT core. The sorted
// leg adds the keys' pair math and, per pass run, 2 operations for each of
// the 64 compare-exchanges; the pass count each pixel runs depends on how
// far its hits are out of row order. Its 255 registers and 199 KB of shared
// memory leave one block of 256 threads (8 warps) per SM.
#include "tile_pair.cuh"

#define HALF (CHUNK / 2)  // rows of keys the sorted leg stages at a time

template <bool SORTED, bool ROWTERM>
__global__ void __launch_bounds__(PIX)
tile_raster_fwd_kernel(const float* __restrict__ data,
                       const int* __restrict__ starts,
                       const int* __restrict__ ends,
                       const float* __restrict__ rays,
                       float* __restrict__ out, float* __restrict__ flags,
                       unsigned* __restrict__ order,
                       const int* __restrict__ win_base,
                       int degree, float min_transmittance,
                       float min_response, float min_alpha, float max_alpha,
                       int has_t_max, int aux_outputs, int passes) {
    __shared__ __align__(16) float rows[CHUNK * ROW_F];
    __shared__ float warp_max[PIX / 32][CHUNK];
    __shared__ unsigned int row_max[CHUNK];

    const int t = blockIdx.x;
    const int p = threadIdx.x;
    const int lane = p & 31, warp = p >> 5;
    const float* rt = rays + (size_t)t * 8 * PIX;
    const Ray ray = load_ray(rt, p);
    const float lt = ROWTERM ? rt[7 * PIX + p] : 0.0f;

    const int start = starts[t], end = ends[t];
    const int w0 = start / CHUNK;
    const int w1 = end > start ? (end - 1) / CHUNK + 1 : w0;

    // The sorted leg's columns of its dynamic shared buffer (the pixel index
    // fastest: no bank conflicts): gated alpha by row [CHUNK][PIX], the keys
    // of half a window [HALF][PIX] and the ray [7][PIX].
    extern __shared__ float win[];
    float* acol = win + p;
    float* kcol = win + CHUNK * PIX + p;
    float* rcol = win + (CHUNK + HALF) * PIX + p;
    if constexpr (SORTED) stash_ray(rcol, ray);

    float T = 1.0f, r = 0.0f, gcol = 0.0f, b = 0.0f, opa = 0.0f, dep = 0.0f,
          hits = 0.0f;
    int g = w0;
    bool walk = true;
    if constexpr (ROWTERM) walk = __syncthreads_or(lt >= (float)(w0 * CHUNK));
    while (walk && g < w1) {
        // Cooperative load of the window: 512 float4, two per thread.
        const float4* src = reinterpret_cast<const float4*>(
            data + (size_t)g * CHUNK * ROW_F);
        float4* dst = reinterpret_cast<float4*>(rows);
        dst[p] = src[p];
        dst[p + PIX] = src[p + PIX];
        if (SORTED && p < CHUNK) row_max[p] = 0u;
        __syncthreads();

        const int base = g * CHUNK;
        const int lo = max(start, base) - base;
        const int hi = min(end, base + CHUNK) - base;
        if constexpr (SORTED) {
            bool go = T > min_transmittance;
            if constexpr (ROWTERM) go = go && (float)(base + lo) <= lt;
            if (go) {
                // The gated alphas of the tile's rows first, while no key is
                // held, then their keys, half a window at a time through
                // `kcol`. Rows before lo keep their positions (their pinned
                // key -BIG is below every key) and are never read; rows at
                // or past hi composite nothing. Four rows per trip give
                // each warp independent pairs to issue.
                {
                    const Ray ray = stashed_ray(rcol);
#pragma unroll 4
                    for (int i = lo; i < hi; ++i) {
                        const Pair s = pair_eval(rows + i * ROW_F, ray, degree,
                                                 min_response, min_alpha,
                                                 max_alpha, has_t_max);
                        float alpha = s.accept ? s.alpha : 0.0f;
                        if (ROWTERM && (float)(base + i) > lt) alpha = 0.0f;
                        acol[i * PIX] = alpha;
                    }
                    for (int i = hi; i < CHUNK; ++i) acol[i * PIX] = 0.0f;
                }
                float key[CHUNK];
                unsigned idx[CHUNK / 4];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    {
                        const Ray ray = stashed_ray(rcol);
                        const int e = min(hi, h * HALF + HALF);
#pragma unroll 4
                        for (int i = max(lo, h * HALF); i < e; ++i)
                            kcol[(i - h * HALF) * PIX] = pair_hit_t(
                                rows + i * ROW_F, ray, degree, min_response,
                                min_alpha, max_alpha, has_t_max);
                    }
#pragma unroll
                    for (int i = 0; i < HALF; ++i) {
                        const int row = h * HALF + i;
                        key[row] = row < lo ? -BIG
                                   : row >= hi ? BIG : kcol[i * PIX];
                    }
                }
                window_rows_init(idx);
                oddeven_network_regs(key, idx, passes);
                if (order != nullptr) {
                    // The compositing order, for B2 to re-walk: step
                    // win_base[t] + (g - w0), one word per four positions.
                    unsigned* o = order
                                  + (size_t)(win_base[t] + g - w0)
                                        * (CHUNK / 4) * PIX
                                  + p;
#pragma unroll
                    for (int i = 0; i < CHUNK / 4; ++i) o[i * PIX] = idx[i];
                }
                // Compositing order from position lo (positions before it
                // hold pinned rows: prod stays exactly 1 and their
                // T_before (1 - alpha) = T, which the carry's min below
                // includes). After the network key[k] is the hit_t of row
                // idx[k] (a row of the tile wherever w > 0). Once
                // T_before <= min_T it stays so (T_before never grows), and
                // no later row changes the sums or the carry.
                float prod = 1.0f, tmin = BIG;
#pragma unroll
                for (int k = 0; k < CHUNK; ++k) {
                    if (k < lo) continue;
                    const float t_before = T * prod;
                    if (!(t_before > min_transmittance)) break;
                    const int row = window_row(idx, k);
                    const float alpha = acol[row * PIX];
                    const float one_m = 1.0f - alpha;
                    const float w = alpha * t_before;
                    if (w > 0.0f) {
                        const float* q = rows + row * ROW_F;
                        r += w * q[13];
                        gcol += w * q[14];
                        b += w * q[15];
                        opa += w;
                        if (aux_outputs) {
                            dep += w * key[k];
                            hits += 1.0f;
                        }
                        if (flags != nullptr)
                            atomicMax(&row_max[row], __float_as_uint(w));
                    }
                    tmin = fminf(tmin, t_before * one_m);
                    prod *= one_m;
                }
                T = fminf(tmin, T);
            }
        } else {
            for (int k = lo; k < hi; ++k) {
                const float* q = rows + k * ROW_F;
                const Pair s = pair_eval(q, ray, degree, min_response,
                                         min_alpha, max_alpha, has_t_max);
                float w = 0.0f;
                bool take = s.accept && T > min_transmittance;
                if constexpr (ROWTERM) take = take && (float)(base + k) <= lt;
                if (take) {
                    w = s.alpha * T;
                    r += w * q[13];
                    gcol += w * q[14];
                    b += w * q[15];
                    opa += w;
                    if (aux_outputs) {
                        dep += w * s.hit_t;
                        hits += 1.0f;
                    }
                    T *= 1.0f - s.alpha;
                }
                if (flags != nullptr) {
                    float m = w;
                    for (int off = 16; off > 0; off >>= 1)
                        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
                    if (lane == 0) warp_max[warp][k] = m;
                }
            }
        }
        // The barrier also keeps `rows` and the flag buffers until every
        // thread is done with them: the next window writes them only after
        // its load.
        bool more = T > min_transmittance;
        if constexpr (ROWTERM) more = more && lt >= (float)((g + 1) * CHUNK);
        const int alive = __syncthreads_or(more);
        if (flags != nullptr && p >= lo && p < hi) {
            float m;
            if constexpr (SORTED) {
                m = __uint_as_float(row_max[p]);
            } else {
                m = warp_max[0][p];
                for (int i = 1; i < PIX / 32; ++i)
                    m = fmaxf(m, warp_max[i][p]);
            }
            flags[base + p] = m;
        }
        ++g;
        if (!alive) break;
    }

    float* o = out + (size_t)t * 8 * PIX;
    o[0 * PIX + p] = r;
    o[1 * PIX + p] = gcol;
    o[2 * PIX + p] = b;
    o[3 * PIX + p] = opa;
    o[4 * PIX + p] = dep;
    o[5 * PIX + p] = T;
    o[6 * PIX + p] = hits;
    o[7 * PIX + p] = (float)(min(max(g * CHUNK, start), end) - start);
}

// The sorted leg's dynamic shared buffer: gated alphas [CHUNK][PIX], the keys
// of half a window [HALF][PIX] and the rays [7][PIX] (199 KB).
constexpr int SORTED_SMEM = (CHUNK + HALF + 7) * PIX * (int)sizeof(float);

template <bool SORTED, bool ROWTERM>
static int launch_fwd(const void* data, const void* starts, const void* ends,
                      const void* rays, void* out, void* flags, void* order,
                      const void* win_base, int num_tiles, int degree,
                      float min_transmittance, float min_response,
                      float min_alpha, float max_alpha, int has_t_max,
                      int aux_outputs, int passes, cudaStream_t stream) {
    const int dyn = SORTED ? SORTED_SMEM : 0;
    if (SORTED) {
        const cudaError_t err = cudaFuncSetAttribute(
            tile_raster_fwd_kernel<SORTED, ROWTERM>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
        if (err != cudaSuccess) return (int)err;
    }
    tile_raster_fwd_kernel<SORTED, ROWTERM><<<num_tiles, PIX, dyn, stream>>>(
        (const float*)data, (const int*)starts, (const int*)ends,
        (const float*)rays, (float*)out, (float*)flags, (unsigned*)order,
        (const int*)win_base, degree, min_transmittance, min_response,
        min_alpha, max_alpha, has_t_max, aux_outputs, passes);
    return (int)cudaGetLastError();
}

// `order` (sorted legs, may be null): [steps, CHUNK / 4, PIX] words that
// receive each walked window's compositing order at step win_base[t] +
// (window - first window of tile t), for B2.
extern "C" int tile_raster_fwd(const void* data, const void* starts,
                               const void* ends, const void* rays, void* out,
                               void* flags, void* order, const void* win_base,
                               int num_tiles, int degree,
                               float min_transmittance, float min_response,
                               float min_alpha, float max_alpha,
                               int has_t_max, int aux_outputs, int passes,
                               int row_termination, void* stream) {
    if (num_tiles <= 0) return (int)cudaGetLastError();
    auto fn = passes > 0 ? (row_termination ? launch_fwd<true, true>
                                            : launch_fwd<true, false>)
                         : (row_termination ? launch_fwd<false, true>
                                            : launch_fwd<false, false>);
    return fn(data, starts, ends, rays, out, flags, order, win_base,
              num_tiles, degree, min_transmittance, min_response, min_alpha,
              max_alpha, has_t_max, aux_outputs, passes,
              (cudaStream_t)stream);
}

// Dynamic shared memory (bytes) of a launch with `passes`.
extern "C" int tile_raster_fwd_smem(int passes) {
    return passes > 0 ? SORTED_SMEM : 0;
}
