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
// Bound on this card: ~60 f32 operations per (pixel, walked slot) against
// 67 TFLOP/s; the rows come from shared memory as broadcasts, device memory
// sees only 64 bytes per walked slot. Design: no prefix scans (the TPU
// kernel's Hillis-Steele ladder and triangular matmuls existed only because
// its vector unit cannot run a per-pixel sequential loop); the sequential
// per-pixel recurrence is the cheapest exact form on a SIMT core.
#include "tile_pair.cuh"

__global__ void __launch_bounds__(PIX)
tile_raster_fwd_kernel(const float* __restrict__ data,
                       const int* __restrict__ starts,
                       const int* __restrict__ ends,
                       const float* __restrict__ rays,
                       float* __restrict__ out, float* __restrict__ flags,
                       int degree, float min_transmittance,
                       float min_response, float min_alpha, float max_alpha,
                       int has_t_max, int aux_outputs) {
    __shared__ __align__(16) float rows[CHUNK * ROW_F];
    __shared__ float warp_max[PIX / 32][CHUNK];

    const int t = blockIdx.x;
    const int p = threadIdx.x;
    const int lane = p & 31, warp = p >> 5;
    const Ray ray = load_ray(rays + (size_t)t * 8 * PIX, p);

    const int start = starts[t], end = ends[t];
    const int w0 = start / CHUNK;
    const int w1 = end > start ? (end - 1) / CHUNK + 1 : w0;

    float T = 1.0f, r = 0.0f, gcol = 0.0f, b = 0.0f, opa = 0.0f, dep = 0.0f,
          hits = 0.0f;
    int g = w0;
    while (g < w1) {
        // Cooperative load of the window: 512 float4, two per thread.
        const float4* src = reinterpret_cast<const float4*>(
            data + (size_t)g * CHUNK * ROW_F);
        float4* dst = reinterpret_cast<float4*>(rows);
        dst[p] = src[p];
        dst[p + PIX] = src[p + PIX];
        __syncthreads();

        const int base = g * CHUNK;
        const int lo = max(start, base) - base;
        const int hi = min(end, base + CHUNK) - base;
        for (int k = lo; k < hi; ++k) {
            const float* q = rows + k * ROW_F;
            const Pair s = pair_eval(q, ray, degree, min_response, min_alpha,
                                     max_alpha, has_t_max);
            float w = 0.0f;
            if (s.accept && T > min_transmittance) {
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
        // The barrier also keeps `rows` and `warp_max` until every thread is
        // done with them: the next window writes them only after its load.
        const int alive = __syncthreads_or(T > min_transmittance);
        if (flags != nullptr && p >= lo && p < hi) {
            float m = warp_max[0][p];
            for (int i = 1; i < PIX / 32; ++i) m = fmaxf(m, warp_max[i][p]);
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

extern "C" int tile_raster_fwd(const void* data, const void* starts,
                               const void* ends, const void* rays, void* out,
                               void* flags, int num_tiles, int degree,
                               float min_transmittance, float min_response,
                               float min_alpha, float max_alpha,
                               int has_t_max, int aux_outputs, void* stream) {
    if (num_tiles > 0) {
        tile_raster_fwd_kernel<<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
            (const float*)data, (const int*)starts, (const int*)ends,
            (const float*)rays, (float*)out, (float*)flags, degree,
            min_transmittance, min_response, min_alpha, max_alpha, has_t_max,
            aux_outputs);
    }
    return (int)cudaGetLastError();
}
