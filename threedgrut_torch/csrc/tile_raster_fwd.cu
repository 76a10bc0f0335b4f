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
// The default leg (walk_rows) does only the work its output needs: a pixel
// evaluates a pair only while it can still take the row, and a warp whose
// 32 pixels are all past that point leaves the window. Where the tile's 256
// rays share one origin (bitwise; every global-shutter camera), the per-row
// part of the pair (w0 = o - mean, u = A w0: 18 of its operations) is
// computed once per row at the window's load into shared memory
// (hoist_rows: from the values the load brings into registers, gathered by
// shuffles), instead of once per (pixel, row). Given `order` (a backward
// follows), it writes each pixel's live-row mask of each walked window
// there: CHUNK / 32 words, bit k of word j set where row 32 j + k was taken
// (w > 0), for B2. The wrapper launches the tiles heaviest first.
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
// Bound on this card: ~75 f32 operations per pair a pixel must evaluate
// (while it can take rows) against 67 TFLOP/s; the rows come from shared
// memory as broadcasts, device memory sees only 64 bytes per walked slot
// (and 16 bytes per pixel-window of the mask). Design: no prefix scans (the
// TPU kernel's Hillis-Steele ladder and triangular matmuls existed only
// because its vector unit cannot run a per-pixel sequential loop); the
// sequential per-pixel recurrence is the cheapest exact form on a SIMT
// core. The sorted leg adds the keys' pair math and, per pass run, 2
// operations for each of the 64 compare-exchanges; the pass count each
// pixel runs depends on how far its hits are out of row order. Its 255
// registers and 199 KB of shared memory leave one block of 256 threads (8
// warps) per SM.
#include "tile_pair.cuh"

#define HALF (CHUNK / 2)  // rows of keys the sorted leg stages at a time

// The default legs' per-row RowU of a window, in shared memory as two
// float4 a row (read as broadcasts), its computation at the window's load
// (hoist_rows), and the block's test that every ray of the tile has pixel
// 0's origin, bit for bit.
struct RowUPacked {
    float4 a, b;  // (w0x, w0y, w0z, ux), (uy, uz, -, -)
};

__device__ __forceinline__ void store_row_u(RowUPacked* dst, const RowU& h) {
    dst->a = make_float4(h.w0x, h.w0y, h.w0z, h.ux);
    dst->b = make_float4(h.uy, h.uz, 0.0f, 0.0f);
}

__device__ __forceinline__ RowU load_row_u(const RowUPacked* src) {
    const float4 a = src->a, b = src->b;
    return RowU{a.x, a.y, a.z, a.w, b.x, b.y};
}

// One row's RowU from the float4 `a` of each lane: lanes 4i, 4i + 1 and
// 4i + 2 hold floats 0-3, 4-7 and 8-11 of the row, and lane 4i stores it.
__device__ __forceinline__ void hoist_row(RowUPacked* dst, float4 a, int p,
                                          const Ray& r) {
    float q[12] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int h = 1; h < 3; ++h) {
        q[4 * h + 0] = __shfl_down_sync(0xffffffffu, a.x, h);
        q[4 * h + 1] = __shfl_down_sync(0xffffffffu, a.y, h);
        q[4 * h + 2] = __shfl_down_sync(0xffffffffu, a.z, h);
        q[4 * h + 3] = __shfl_down_sync(0xffffffffu, a.w, h);
    }
    if ((p & 3) == 0) store_row_u(dst, row_u(q, r.ox, r.oy, r.oz));
}

// The window's rows' RowU, from the float4s p and p + PIX of the window
// that thread p loads (`a`, `c`: rows p / 4 and CHUNK / 2 + p / 4), with
// no load of its own. All threads of the block take part.
__device__ __forceinline__ void hoist_rows(RowUPacked* hrow, float4 a,
                                           float4 c, int p, const Ray& r) {
    hoist_row(hrow + (p >> 2), a, p, r);
    hoist_row(hrow + CHUNK / 2 + (p >> 2), c, p, r);
}

__device__ __forceinline__ bool tile_shares_origin(const float* ray,
                                                   const Ray& r) {
    const bool same = __float_as_uint(r.ox) == __float_as_uint(ray[0 * PIX])
                      && __float_as_uint(r.oy)
                             == __float_as_uint(ray[1 * PIX])
                      && __float_as_uint(r.oz)
                             == __float_as_uint(ray[2 * PIX]);
    return __syncthreads_and(same) != 0;
}

// Per-pixel sums of the walk.
struct Acc {
    float T, r, g, b, opa, dep, hits;
};

// The default leg's walk of one window's rows [lo, hi) (rows of the tile,
// in slot order). A pixel evaluates a pair only while it can take the row
// (T > min_T and, with row termination, the row at or before its lt): a
// warp whose 32 pixels are all past that point is done with the window,
// since neither condition comes back. Taken rows set their bit of the
// pixel's live-row mask, one word per 32 rows (`lm`, the words of this
// pixel and window, written when a backward follows). With HOIST the rows'
// w0 and u come from `hrow` (the tile's rays share one origin).
template <bool ROWTERM, bool HOIST>
__device__ __forceinline__ void walk_rows(
    const float* rows, const RowUPacked* hrow, const Ray& ray, float lt,
    int base, int lo, int hi, int lane, float* warp_max_w, float* flags,
    unsigned* lm, int degree, float min_transmittance, float min_response,
    float min_alpha, float max_alpha, int has_t_max, int aux_outputs,
    Acc& a) {
    int k = lo, stop = hi;
#pragma unroll 1
    for (int j = 0; j < CHUNK / 32; ++j) {
        unsigned bits = 0u;
        const int kb = min(hi, 32 * j + 32);
        for (; k < kb; ++k) {
            bool px = a.T > min_transmittance;
            if constexpr (ROWTERM) px = px && (float)(base + k) <= lt;
            if (!__any_sync(0xffffffffu, px)) {
                stop = k;  // every pixel of the warp is done with the window
                k = hi;
                break;
            }
            float w = 0.0f;
            if (px) {
                const float* q = rows + k * ROW_F;
                const Pair s =
                    HOIST ? pair_from_u(q, load_row_u(hrow + k), ray, degree,
                                        min_response, min_alpha, max_alpha,
                                        has_t_max)
                          : pair_eval(q, ray, degree, min_response,
                                      min_alpha, max_alpha, has_t_max);
                if (s.accept) {
                    w = s.alpha * a.T;
                    a.r += w * q[13];
                    a.g += w * q[14];
                    a.b += w * q[15];
                    a.opa += w;
                    if (aux_outputs) {
                        a.dep += w * s.hit_t;
                        a.hits += 1.0f;
                    }
                    a.T *= 1.0f - s.alpha;
                    bits |= 1u << (k & 31);
                }
            }
            if (flags != nullptr) {
                float m = w;
                for (int off = 16; off > 0; off >>= 1)
                    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
                if (lane == 0) warp_max_w[k] = m;
            }
        }
        if (lm != nullptr) lm[j * PIX] = bits;
    }
    if (flags != nullptr) {
        // The rows a finished warp skipped: its weights there are 0.
        for (int i = stop + lane; i < hi; i += 32) warp_max_w[i] = 0.0f;
    }
}

template <bool SORTED, bool ROWTERM>
__global__ void __launch_bounds__(PIX)
tile_raster_fwd_kernel(const float* __restrict__ data,
                       const int* __restrict__ starts,
                       const int* __restrict__ ends,
                       const float* __restrict__ rays,
                       float* __restrict__ out, float* __restrict__ flags,
                       unsigned* __restrict__ order,
                       const int* __restrict__ win_base,
                       const int* __restrict__ tile_order,
                       int degree, float min_transmittance,
                       float min_response, float min_alpha, float max_alpha,
                       int has_t_max, int aux_outputs, int passes) {
    __shared__ __align__(16) float rows[CHUNK * ROW_F];
    __shared__ float warp_max[PIX / 32][CHUNK];
    __shared__ unsigned int row_max[CHUNK];
    // The default leg's per-row w0 and u of a window, where the tile's rays
    // share one origin.
    __shared__ RowUPacked hrow[SORTED ? 1 : CHUNK];

    // Tile of this block: heaviest first, in the wrapper's order.
    const int t = tile_order[blockIdx.x];
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
    const bool hoist = !SORTED && tile_shares_origin(rt, ray);

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
        const float4 va = src[p], vc = src[p + PIX];
        dst[p] = va;
        dst[p + PIX] = vc;
        if (SORTED && p < CHUNK) row_max[p] = 0u;
        if (hoist) hoist_rows(hrow, va, vc, p, ray);
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
            // The live-row mask's words of this pixel and window: step
            // win_base[t] + (g - w0), CHUNK / 32 words.
            unsigned* lm = order == nullptr
                               ? nullptr
                               : order + (size_t)(win_base[t] + g - w0)
                                             * (CHUNK / 32) * PIX + p;
            Acc acc{T, r, gcol, b, opa, dep, hits};
            if (hoist)
                walk_rows<ROWTERM, true>(
                    rows, hrow, ray, lt, base, lo, hi, lane, warp_max[warp],
                    flags, lm, degree, min_transmittance, min_response,
                    min_alpha, max_alpha, has_t_max, aux_outputs, acc);
            else
                walk_rows<ROWTERM, false>(
                    rows, hrow, ray, lt, base, lo, hi, lane, warp_max[warp],
                    flags, lm, degree, min_transmittance, min_response,
                    min_alpha, max_alpha, has_t_max, aux_outputs, acc);
            T = acc.T;
            r = acc.r;
            gcol = acc.g;
            b = acc.b;
            opa = acc.opa;
            dep = acc.dep;
            hits = acc.hits;
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
                      const void* win_base, const void* tile_order,
                      int num_tiles, int degree, float min_transmittance,
                      float min_response, float min_alpha, float max_alpha,
                      int has_t_max, int aux_outputs, int passes,
                      cudaStream_t stream) {
    const int dyn = SORTED ? SORTED_SMEM : 0;
    if (tile_order == nullptr) return (int)cudaErrorInvalidValue;
    if (SORTED) {
        const cudaError_t err = cudaFuncSetAttribute(
            tile_raster_fwd_kernel<SORTED, ROWTERM>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
        if (err != cudaSuccess) return (int)err;
    }
    tile_raster_fwd_kernel<SORTED, ROWTERM><<<num_tiles, PIX, dyn, stream>>>(
        (const float*)data, (const int*)starts, (const int*)ends,
        (const float*)rays, (float*)out, (float*)flags, (unsigned*)order,
        (const int*)win_base, (const int*)tile_order, degree,
        min_transmittance, min_response, min_alpha, max_alpha, has_t_max,
        aux_outputs, passes);
    return (int)cudaGetLastError();
}

// `tile_order`: the tile of each block, the wrapper's heaviest-first
// order.
// `order` (may be null): the walk record that B2 re-walks, at step
// win_base[t] + (window - first window of tile t) for each walked window:
// the sorted legs' compositing orders ([steps, CHUNK / 4, PIX] words), the
// default legs' live-row masks ([steps, CHUNK / 32, PIX] words).
extern "C" int tile_raster_fwd(const void* data, const void* starts,
                               const void* ends, const void* rays, void* out,
                               void* flags, void* order, const void* win_base,
                               const void* tile_order, int num_tiles,
                               int degree, float min_transmittance,
                               float min_response, float min_alpha,
                               float max_alpha, int has_t_max,
                               int aux_outputs, int passes,
                               int row_termination, void* stream) {
    if (num_tiles <= 0) return (int)cudaGetLastError();
    auto fn = passes > 0 ? (row_termination ? launch_fwd<true, true>
                                            : launch_fwd<true, false>)
                         : (row_termination ? launch_fwd<false, true>
                                            : launch_fwd<false, false>);
    return fn(data, starts, ends, rays, out, flags, order, win_base,
              tile_order, num_tiles, degree, min_transmittance, min_response,
              min_alpha, max_alpha, has_t_max, aux_outputs, passes,
              (cudaStream_t)stream);
}

// Dynamic shared memory (bytes) of a launch with `passes`.
extern "C" int tile_raster_fwd_smem(int passes) {
    return passes > 0 ? SORTED_SMEM : 0;
}
