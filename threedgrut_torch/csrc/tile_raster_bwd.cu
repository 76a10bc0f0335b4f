// B2: the backward of the 3DGUT tile compositor.
//
// Replaces: threedgrut_tpu/ops/pallas/tile_raster.py _backward_kernel,
// reached through _backward_windows and _bwd_rule (and the fused walked-
// window backward, ops/fused_raster.py).
//
// One block per 16x16 tile, one thread per pixel, the forward's shape
// (tile_raster_fwd.cu): the block re-walks the windows the forward walked,
// loading each absolute 128-slot window (8 KB) into shared memory, and stops
// where the forward stopped (__syncthreads_or(T > min_transmittance) after a
// window). Every pair goes through the forward's pair math (tile_pair.cuh);
// with --fmad=false both kernels accept the same hits with the same alpha and
// the same sequential T, so a pixel's weight w > 0 here iff it was > 0 there.
// The default leg reads which rows each pixel took from the live-row mask
// B1 wrote (`order`: a bit per row, rewalk_rows) and evaluates a pair only
// there: a row no pixel of a warp took costs that warp nothing but its
// share of the zeros. It evaluates too few pairs for B1's per-row w0 and u
// to pay (measured slower with them, PERF.md). Without a mask the wrapper
// runs B1 to write it; the wrapper launches the tiles heaviest first.
//
// Per pixel, the suffix sum_{k>j} w_k q_k (q = rgb . dC + hit_t dD + dO) is
// the residual a_tot - prefix_j, with a_tot rebuilt from the forward's
// outputs (rgb . dC + opacity dO + depth dD), as the TPU kernel does. Then
//   d_alpha = T_before q_j - (suffix + dT t_final) / max(1 - alpha, 1e-6)
// chains through alpha = min(opacity resp(g), max_alpha) and
// g = |v x u|^2 / |v|^2 (and hit_t = |v.u| / |v|^2 when aux_grads) to
// du, dv in the exact cross-product form (the triple-product shortcut
// cancels for near-axis anisotropic particles), and to the 16 per-slot row
// entries: dA[r][k] = du_r (o - mean)_k + dv_r d_k, sum du_r (for dmean),
// dopacity and w dC. Pixels with w == 0 contribute exactly 0.
//
// The 16 values of a slot are summed over the tile's 256 pixels in a fixed
// order: a transposing warp butterfly (16 shuffles leave each lane pair with
// one field's warp sum), then the 8 warps' partials in order through shared
// memory, 32 slots at a time. Each slot belongs to exactly one tile, so each
// gradient row is written once by one block: no atomics, deterministic. The
// wrapper zeroes the output; slots the walk never reached stay exactly 0.
// All arithmetic is f32 (the TPU's bf16 gradient matmuls were an economy of
// its matrix unit; the bf16 rounding of the cotangents lives in the unsort).
//
// Two legs are compile-time template parameters, so the default (0 passes,
// no row termination) compiles to the walk above and nothing else:
//  * SORTED (passes > 0): each pixel's suffix runs in its own re-sorted
//    order, but a slot's 16 values sum over all 256 pixels at that row, so
//    a window takes two passes (B8's design). The order is the one B1's
//    network gave this pixel and window: B1 writes it (`order`, a word per
//    four positions) and B2 reads it, so the network and its keys run once
//    per train step. For each part of the window (43 rows): pass A replays
//    B1's walk per pixel in compositing order and stores by ROW index w and
//    d_alpha of the part's rows in columns of dynamic shared memory
//    ([43][256] each, the pixel index fastest: no bank conflicts); pass B
//    goes row by row over the tile's rows of the part, re-evaluates the
//    pair for the pixels with w > 0, chains and reduces exactly as the
//    default leg does. A whole window's w and d_alpha (256 KB) would not
//    fit in the 227 KB a block may have; halves (128 KB) would leave one
//    block of 8 warps per SM, thirds (86 KB, 110 KB with the static
//    buffers) leave two. Only the last part's walk runs to the end (the
//    carry and the prefix); an earlier one stops once it has stored its
//    rows. A walk starts at the tile's first row lo (positions before it
//    hold pinned rows) and stops at the first T_before <= min_T (exact:
//    T_before never grows; later rows keep w = 0).
//  * ROWTERM: alpha is 0 past each pixel's last touch lt (rays row 7); the
//    walk starts and stops where B1's does.
//
// Bound on this card: operations against 67 TFLOP/s f32. The default leg
// needs the pair math (~75 operations), the gradient chain (~108) and the
// 16 adds that sum its row over the tile only for a live pair (w > 0), and
// a warp with no live lane skips them (the sorted legs still evaluate the
// pair for every (pixel, walked slot) in pass A). Device memory sees 64
// bytes read and 64 written per walked slot, 24 KB per tile and the mask's
// 16 bytes per pixel-window. The walk is serial per pixel, so the kernel is
// bound by instruction issue.
#include "tile_pair.cuh"

#define SUB 32           // slots per cross-warp reduction batch
#define FULL 0xffffffffu
// Rows of a sorted window per pass A store: three parts (43, 43, 42 rows),
// whose w and d_alpha (86 KB) leave room for two blocks per SM.
#define PART 43

// Sum 16 values over the 32 lanes of a warp. On return lane l holds, in
// v[0], the warp sum of field 8*b4 + 4*b3 + 2*b2 + b1 (bk = bit k of l).
__device__ __forceinline__ void warp_sum16(float v[16], int lane) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const bool up = lane & 16;
        const float send = up ? v[i] : v[i + 8];
        const float keep = up ? v[i + 8] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const bool up = lane & 8;
        const float send = up ? v[i] : v[i + 4];
        const float keep = up ? v[i + 4] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, 8);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const bool up = lane & 4;
        const float send = up ? v[i] : v[i + 2];
        const float keep = up ? v[i + 2] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, 4);
    }
    {
        const bool up = lane & 2;
        const float send = up ? v[0] : v[1];
        const float keep = up ? v[1] : v[0];
        v[0] = keep + __shfl_xor_sync(FULL, send, 2);
    }
    v[0] = v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

// Cross-warp sums of a batch of kn slots (rows kb .. kb + kn - 1 of the
// window at `base`) in warp order, one thread per (slot, field), written to
// their gradient rows.
__device__ __forceinline__ void block_sums(float (*part)[SUB][ROW_F],
                                           const float* rows, int kb, int kn,
                                           int base, int p,
                                           float* __restrict__ grad) {
    for (int idx = p; idx < kn * ROW_F; idx += PIX) {
        const int j = idx / ROW_F, f = idx % ROW_F;
        float val;
        if (f >= 9 && f < 12) {
            // dmean_k = -sum_r A[r][k] sum_pix du_r
            const float* q = rows + (kb + j) * ROW_F;
            float su[3];
            for (int r = 0; r < 3; ++r) {
                su[r] = part[0][j][9 + r];
                for (int i = 1; i < PIX / 32; ++i)
                    su[r] = su[r] + part[i][j][9 + r];
            }
            const int k = f - 9;
            val = -(q[k] * su[0] + q[3 + k] * su[1] + q[6 + k] * su[2]);
        } else {
            val = part[0][j][f];
            for (int i = 1; i < PIX / 32; ++i) val = val + part[i][j][f];
        }
        grad[(size_t)(base + kb + j) * ROW_F + f] = val;
    }
}

// The 16 per-slot entries of a live pair (w > 0) of row q: the chain of
// d_alpha through alpha, g and hit_t to du, dv, and on to the row's fields.
__device__ __forceinline__ void slot_grads(const float* q, const Pair& s,
                                           const Ray& ray, float w,
                                           float d_alpha, float dCr,
                                           float dCg, float dCb, float dD,
                                           int degree, float max_alpha,
                                           int aux_grads, float v[ROW_F]) {
    const bool unclamped = s.alpha_raw < max_alpha;
    const float d_resp = unclamped ? q[12] * d_alpha : 0.0f;
    const float d_opa = unclamped ? s.resp * d_alpha : 0.0f;
    const float d_g = d_resp * kernel_response_grad(s.g, s.resp, degree);
    const float d_crsq = d_g * s.inv_vsq;
    float d_vsq = (-s.g * s.inv_vsq) * d_g;
    float d_m = 0.0f;
    if (aux_grads) {
        const float d_hit = w * dD;
        const float sgn = (float)((s.vdotu > 0.0f) - (s.vdotu < 0.0f));
        d_m = sgn * s.inv_vsq * d_hit;
        d_vsq = d_vsq + (-s.hit_t * s.inv_vsq) * d_hit;
    }
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
        v[9 + r] = du[r];
    }
    v[12] = d_opa;
    v[13] = w * dCr;
    v[14] = w * dCg;
    v[15] = w * dCb;
}

// One batch's 16 values per lane (zero where the pixel's pair is not live)
// summed over the warp into part[warp][j].
__device__ __forceinline__ void warp_part(float v[ROW_F], bool live, int lane,
                                          float* part_wj) {
    if (__any_sync(FULL, live)) {
        warp_sum16(v, lane);
        if ((lane & 1) == 0) {
            const int f = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4
                          + ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
            part_wj[f] = v[0];
        }
    } else if (lane < ROW_F) {
        part_wj[lane] = 0.0f;
    }
}

// Rows [kb, ke) of a 32-row word of a window, as bits of that word.
__device__ __forceinline__ unsigned word_rows(int kb, int ke, int j) {
    const int a = kb - 32 * j, e = ke - 32 * j;
    const unsigned upto = e >= 32 ? 0xffffffffu : (1u << e) - 1u;
    return upto & ~((1u << a) - 1u);
}

// The default leg's re-walk of one window's rows [lo, hi) on B1's live-row
// mask (`lm`: this pixel's CHUNK / 32 words of the window), 32 rows (one
// mask word) per reduction batch. The rows some lane of the warp took
// (the OR of the warp's words) run the taken branch of the forward's walk:
// T_before, w, the prefix, T *= 1 - alpha and, for w > 0, d_alpha and the
// chain; a lane whose bit is clear there leaves T and the prefix as they
// are. The other rows of the batch get the zeros the reduction gives a row
// no lane of the warp counted, without evaluating a pair.
__device__ __forceinline__ void rewalk_rows(
    const float* rows, const Ray& ray, const unsigned* lm, int base, int lo,
    int hi, int p, int lane, float (*part)[SUB][ROW_F],
    float* __restrict__ grad, float a_tot,
    float dCr, float dCg, float dCb, float dO, float dD, float dT,
    float t_final, int degree, float min_response, float min_alpha,
    float max_alpha, int has_t_max, int aux_grads, float& T,
    float& prefix) {
    const int warp = p >> 5;
    for (int j = lo >> 5; j <= (hi - 1) >> 5; ++j) {
        const int kb = max(lo, 32 * j), ke = min(hi, 32 * j + 32);
        const unsigned bits = lm[j * PIX];
        float* pw = &part[warp][0][0];
        for (int i = lane; i < (ke - kb) * ROW_F; i += 32) pw[i] = 0.0f;
        __syncwarp();
        for (unsigned m = __reduce_or_sync(FULL, bits) & word_rows(kb, ke, j);
             m != 0u; m &= m - 1u) {
            const int k = 32 * j + __ffs(m) - 1;
            const float* q = rows + k * ROW_F;
            float v[ROW_F];
#pragma unroll
            for (int i = 0; i < ROW_F; ++i) v[i] = 0.0f;
            bool live = false;
            if ((bits >> (k & 31)) & 1u) {
                const Pair s = pair_eval(q, ray, degree, min_response,
                                         min_alpha, max_alpha, has_t_max);
                const float t_before = T;
                const float w = s.alpha * T;
                float qj = q[13] * dCr + q[14] * dCg + q[15] * dCb;
                qj = aux_grads ? qj + s.hit_t * dD + dO : qj + dO;
                prefix = prefix + w * qj;
                T *= 1.0f - s.alpha;
                live = w > 0.0f;
                if (live) {
                    const float suffix = a_tot - prefix;
                    const float inv_one_m =
                        1.0f / fmaxf(1.0f - s.alpha, 1e-6f);
                    float d_alpha = t_before * qj - suffix * inv_one_m;
                    if (aux_grads)
                        d_alpha = d_alpha - dT * t_final * inv_one_m;
                    slot_grads(q, s, ray, w, d_alpha, dCr, dCg, dCb, dD,
                               degree, max_alpha, aux_grads, v);
                }
            }
            warp_part(v, live, lane, part[warp][k - kb]);
        }
        __syncthreads();
        block_sums(part, rows, kb, ke - kb, base, p, grad);
        __syncthreads();
    }
}

// The default legs are held to four blocks per SM (64 registers, 16 bytes
// of spills: 3-5% faster than three blocks at 80 registers, PERF.md); the
// sorted legs' shared buffer allows two blocks whatever their registers.
template <bool SORTED, bool ROWTERM>
__global__ void __launch_bounds__(PIX, SORTED ? 1 : 4)
tile_raster_bwd_kernel(const float* __restrict__ data,
                       const int* __restrict__ starts,
                       const int* __restrict__ ends,
                       const float* __restrict__ rays,
                       const float* __restrict__ fwd,
                       const float* __restrict__ gout,
                       const unsigned* __restrict__ order,
                       const int* __restrict__ win_base,
                       const int* __restrict__ tile_order,
                       float* __restrict__ grad, int degree,
                       float min_transmittance, float min_response,
                       float min_alpha, float max_alpha, int has_t_max,
                       int aux_grads) {
    __shared__ __align__(16) float rows[CHUNK * ROW_F];
    __shared__ float part[PIX / 32][SUB][ROW_F];

    // Tile of this block: heaviest first, in the wrapper's order.
    const int t = tile_order[blockIdx.x];
    const int p = threadIdx.x;
    const int lane = p & 31, warp = p >> 5;
    const float* rt = rays + (size_t)t * 8 * PIX;
    const Ray ray = load_ray(rt, p);
    const float lt = ROWTERM ? rt[7 * PIX + p] : 0.0f;
    const float* fo = fwd + (size_t)t * 8 * PIX;
    const float* go = gout + (size_t)t * 8 * PIX;
    const float dCr = go[0 * PIX + p], dCg = go[1 * PIX + p],
                dCb = go[2 * PIX + p], dO = go[3 * PIX + p];
    const float dD = aux_grads ? go[4 * PIX + p] : 0.0f;
    const float dT = aux_grads ? go[5 * PIX + p] : 0.0f;
    const float t_final = fo[5 * PIX + p];
    float a_tot = fo[0 * PIX + p] * dCr + fo[1 * PIX + p] * dCg
                  + fo[2 * PIX + p] * dCb + fo[3 * PIX + p] * dO;
    if (aux_grads) a_tot = a_tot + fo[4 * PIX + p] * dD;

    const int start = starts[t], end = ends[t];
    const int w0 = start / CHUNK;
    const int w1 = end > start ? (end - 1) / CHUNK + 1 : w0;

    // The sorted leg's columns of its dynamic shared buffer (the pixel index
    // fastest: no bank conflicts): w and d_alpha of a part of a window by
    // row, [PART][PIX] each.
    extern __shared__ float win[];
    float* wgt = win + p;
    float* dal = win + PART * PIX + p;

    float T = 1.0f, prefix = 0.0f;
    int g = w0;
    bool walk = true;
    if constexpr (ROWTERM) walk = __syncthreads_or(lt >= (float)(w0 * CHUNK));
    while (walk && g < w1) {
        const float4* src = reinterpret_cast<const float4*>(
            data + (size_t)g * CHUNK * ROW_F);
        float4* dst = reinterpret_cast<float4*>(rows);
        dst[p] = src[p];
        dst[p + PIX] = src[p + PIX];
        __syncthreads();

        const int base = g * CHUNK;
        const int lo = max(start, base) - base;
        const int hi = min(end, base + CHUNK) - base;
        if constexpr (SORTED) {
            bool go_px = T > min_transmittance;
            if constexpr (ROWTERM) go_px = go_px && (float)(base + lo) <= lt;
            // B1's compositing order of this pixel and window (written
            // where B1's pixel ran it: exactly where go_px holds here).
            const unsigned* ord =
                order + (size_t)(win_base[t] + g - w0) * (CHUNK / 4) * PIX + p;
            // Each part of the window: pass A, B1's walk of this pixel in
            // compositing order storing w and d_alpha of the part's rows;
            // pass B, the part's rows of the tile in order, summed over the
            // pixels. The last part walked walks to the end and gives the
            // carry and the prefix; an earlier one stops once it has
            // stored its rows.
            const float prefix0 = prefix;
            float t_next = T;
            const int h_first = lo / PART;
            const int h_last = (hi - 1) / PART;
            for (int h = h_first; h <= h_last; ++h) {
                const int h_lo = max(lo, h * PART);
                const int h_hi = min(hi, h * PART + PART);
                if (go_px) {
                    for (int i = h_lo; i < h_hi; ++i)
                        wgt[(i - h * PART) * PIX] = 0.0f;
                    int todo = h < h_last ? h_hi - h_lo : CHUNK;
                    prefix = prefix0;
                    float prod = 1.0f, tmin = BIG;
                    // From position lo: before it stand pinned rows, where
                    // prod stays exactly 1 and T_before (1 - alpha) = T,
                    // which the carry's min below includes.
                    for (int k = lo; k < CHUNK && todo > 0; ++k) {
                        const float t_before = T * prod;
                        if (!(t_before > min_transmittance)) break;
                        const int row = (int)((__ldg(ord + (k >> 2) * PIX)
                                               >> (8 * (k & 3))) & 0xffu);
                        const float* q = rows + row * ROW_F;
                        float alpha = 0.0f, hit_t = 0.0f;
                        if (row >= lo && row < hi) {
                            const Pair s = pair_eval(q, ray, degree,
                                                     min_response, min_alpha,
                                                     max_alpha, has_t_max);
                            alpha = s.accept ? s.alpha : 0.0f;
                            if (ROWTERM && (float)(base + row) > lt)
                                alpha = 0.0f;
                            hit_t = s.hit_t;
                        }
                        const float one_m = 1.0f - alpha;
                        const float w = alpha * t_before;
                        float d_alpha = 0.0f;
                        if (w > 0.0f) {
                            float qj = q[13] * dCr + q[14] * dCg + q[15] * dCb;
                            qj = aux_grads ? qj + hit_t * dD + dO : qj + dO;
                            prefix = prefix + w * qj;
                            const float suffix = a_tot - prefix;
                            const float inv_one_m =
                                1.0f / fmaxf(one_m, 1e-6f);
                            d_alpha = t_before * qj - suffix * inv_one_m;
                            if (aux_grads)
                                d_alpha = d_alpha - dT * t_final * inv_one_m;
                        }
                        tmin = fminf(tmin, t_before * one_m);
                        prod *= one_m;
                        if (row >= h_lo && row < h_hi) {
                            wgt[(row - h * PART) * PIX] = w;
                            dal[(row - h * PART) * PIX] = d_alpha;
                            if (h < h_last) --todo;
                        }
                    }
                    if (h == h_last) t_next = fminf(tmin, T);
                }
                // Pass B: the part's rows of the tile in order, summed over
                // the pixels.
                for (int kb = h_lo; kb < h_hi; kb += SUB) {
                    const int kn = min(h_hi - kb, SUB);
                    for (int j = 0; j < kn; ++j) {
                        const int row = kb + j;
                        const float* q = rows + row * ROW_F;
                        float v[ROW_F];
#pragma unroll
                        for (int i = 0; i < ROW_F; ++i) v[i] = 0.0f;
                        const float w =
                            go_px ? wgt[(row - h * PART) * PIX] : 0.0f;
                        const bool live = w > 0.0f;
                        if (live) {
                            const Pair s = pair_eval(q, ray, degree,
                                                     min_response, min_alpha,
                                                     max_alpha, has_t_max);
                            slot_grads(q, s, ray, w,
                                       dal[(row - h * PART) * PIX], dCr, dCg,
                                       dCb, dD, degree, max_alpha, aux_grads,
                                       v);
                        }
                        warp_part(v, live, lane, part[warp][j]);
                    }
                    __syncthreads();
                    block_sums(part, rows, kb, kn, base, p, grad);
                    __syncthreads();
                }
            }
            T = t_next;
        } else {
            // B1's live-row mask of this pixel and window: step
            // win_base[t] + (g - w0), CHUNK / 32 words.
            const unsigned* lm =
                order + (size_t)(win_base[t] + g - w0) * (CHUNK / 32) * PIX
                + p;
            rewalk_rows(rows, ray, lm, base, lo, hi, p, lane, part, grad,
                        a_tot, dCr, dCg, dCb, dO, dD, dT, t_final, degree,
                        min_response, min_alpha, max_alpha, has_t_max,
                        aux_grads, T, prefix);
        }
        // The walk stops exactly where the forward's did.
        bool more = T > min_transmittance;
        if constexpr (ROWTERM) more = more && lt >= (float)((g + 1) * CHUNK);
        const int alive = __syncthreads_or(more);
        ++g;
        if (!alive) break;
    }
}

// The sorted leg's dynamic shared buffer: w and d_alpha of a part of a
// window (43 KB each).
constexpr int SORTED_SMEM = 2 * PART * PIX * (int)sizeof(float);

template <bool SORTED, bool ROWTERM>
static int launch_bwd(const void* data, const void* starts, const void* ends,
                      const void* rays, const void* fwd, const void* gout,
                      const void* order, const void* win_base,
                      const void* tile_order, void* grad, int num_tiles,
                      int degree, float min_transmittance,
                      float min_response, float min_alpha, float max_alpha,
                      int has_t_max, int aux_grads, cudaStream_t stream) {
    const int dyn = SORTED ? SORTED_SMEM : 0;
    if (order == nullptr || win_base == nullptr || tile_order == nullptr)
        return (int)cudaErrorInvalidValue;
    if (SORTED) {
        const cudaError_t err = cudaFuncSetAttribute(
            tile_raster_bwd_kernel<SORTED, ROWTERM>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
        if (err != cudaSuccess) return (int)err;
    }
    tile_raster_bwd_kernel<SORTED, ROWTERM><<<num_tiles, PIX, dyn, stream>>>(
        (const float*)data, (const int*)starts, (const int*)ends,
        (const float*)rays, (const float*)fwd, (const float*)gout,
        (const unsigned*)order, (const int*)win_base, (const int*)tile_order,
        (float*)grad, degree,
        min_transmittance, min_response, min_alpha, max_alpha, has_t_max,
        aux_grads);
    return (int)cudaGetLastError();
}

// `tile_order`: the tile of each block, the wrapper's heaviest-first
// order.
// `order` and `win_base`: the walk record that B1 wrote for this walk
// (tile_raster_fwd.cu): the sorted legs' compositing orders, the default
// legs' live-row masks.
extern "C" int tile_raster_bwd(const void* data, const void* starts,
                               const void* ends, const void* rays,
                               const void* fwd, const void* gout,
                               const void* order, const void* win_base,
                               const void* tile_order, void* grad,
                               int num_tiles, int degree,
                               float min_transmittance, float min_response,
                               float min_alpha, float max_alpha,
                               int has_t_max, int aux_grads, int passes,
                               int row_termination, void* stream) {
    if (num_tiles <= 0) return (int)cudaGetLastError();
    auto fn = passes > 0 ? (row_termination ? launch_bwd<true, true>
                                            : launch_bwd<true, false>)
                         : (row_termination ? launch_bwd<false, true>
                                            : launch_bwd<false, false>);
    return fn(data, starts, ends, rays, fwd, gout, order, win_base,
              tile_order, grad, num_tiles, degree, min_transmittance,
              min_response, min_alpha, max_alpha, has_t_max, aux_grads,
              (cudaStream_t)stream);
}

// Dynamic shared memory (bytes) of a launch with `passes`.
extern "C" int tile_raster_bwd_smem(int passes) {
    return passes > 0 ? SORTED_SMEM : 0;
}
