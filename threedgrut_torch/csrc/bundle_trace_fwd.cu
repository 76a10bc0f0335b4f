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
// min over those rows of T_before (1 - alpha)). The block stops after the
// first window that leaves no ray with carry > min_T (__syncthreads_or);
// row 7 is the number of windows walked.
//
// Design. Shared memory cannot hold every ray's 128 keys and payloads (the
// 256 rays of a bundle would need 160 KB, more than a block should take for
// one bundle), so each thread keeps its ray's keys and their row indices in
// a per-thread array in local memory (640 B). With passes > 0 it computes
// the 128 keys, runs the network there, and composites in the sorted order
// (recomputing alpha for the rows that hit). With passes == 0 the network
// is the identity and the ray composites in row order directly. A ray whose
// carry is already <= min_T skips the window: none of its rows can count,
// and its carry cannot change. The local-memory network dominates the
// kernel's time at 16 passes (PERF.md): a faster network is open work.
//
// Bound on this card: ~80 f32 operations per (live ray, walked row) for the
// pair math and gates and 6 for the compositing step (67 TFLOP/s), plus
// ~110 for the colour and sums per counted pair and ~2 x 64 x passes per
// out-of-order ray-window for the network; device memory sees 32 KB per
// walked window and 16 KB of rays and output per bundle.
#include "bundle_pair.cuh"

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

}  // namespace

__global__ void __launch_bounds__(PIX)
bundle_trace_fwd_kernel(const float* __restrict__ data,
                        const int* __restrict__ win_starts,
                        const int* __restrict__ win_ends,
                        const float* __restrict__ rays,
                        float* __restrict__ out, int num_windows, int degree,
                        int sh_degree, float min_transmittance,
                        float min_response, float min_alpha, float max_alpha,
                        int passes) {
    __shared__ __align__(16) float rows[CHUNK * ROW64];

    const int bnd = blockIdx.x;
    const int p = threadIdx.x;
    const float* rb = rays + (size_t)bnd * 8 * PIX;
    const Ray ray = load_ray(rb, p);
    float carry = rb[7 * PIX + p];
    float bs[16];
    sh_basis(ray.dx, ray.dy, ray.dz, sh_degree, bs);
    const int nbasis = (sh_degree + 1) * (sh_degree + 1);

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
            Acc a = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, BIG};
            float prod = 1.0f;
            if (passes == 0) {
                for (int r = 0; r < CHUNK; ++r) {
                    const float* q = rows + r * ROW64;
                    float hit_t;
                    const float alpha = row_alpha(q, ray, degree,
                                                  min_response, min_alpha,
                                                  max_alpha, &hit_t);
                    composite_row(q, alpha, hit_t, carry, min_transmittance,
                                  bs, nbasis, prod, a);
                }
            } else {
                float key[CHUNK];
                unsigned char idx[CHUNK];
                for (int r = 0; r < CHUNK; ++r) {
                    float hit_t;
                    const float alpha = row_alpha(rows + r * ROW64, ray,
                                                  degree, min_response,
                                                  min_alpha, max_alpha,
                                                  &hit_t);
                    key[r] = alpha > 0.0f ? hit_t : BIG;
                    idx[r] = (unsigned char)r;
                }
                for (int i = 0; i < passes; ++i) {
                    for (int j = i & 1; j < CHUNK - 1; j += 2) {
                        const float ka = key[j], kb = key[j + 1];
                        if (kb < ka) {
                            key[j] = kb;
                            key[j + 1] = ka;
                            const unsigned char t = idx[j];
                            idx[j] = idx[j + 1];
                            idx[j + 1] = t;
                        }
                    }
                }
                for (int k = 0; k < CHUNK; ++k) {
                    const float* q = rows + idx[k] * ROW64;
                    float hit_t = 0.0f, alpha = 0.0f;
                    if (key[k] < BIG)
                        alpha = row_alpha(q, ray, degree, min_response,
                                          min_alpha, max_alpha, &hit_t);
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

extern "C" int bundle_trace_fwd(const void* data, const void* win_starts,
                                const void* win_ends, const void* rays,
                                void* out, int num_bundles, int num_windows,
                                int degree, int sh_degree,
                                float min_transmittance, float min_response,
                                float min_alpha, float max_alpha, int passes,
                                void* stream) {
    if (num_bundles > 0) {
        bundle_trace_fwd_kernel<<<num_bundles, PIX, 0,
                                  (cudaStream_t)stream>>>(
            (const float*)data, (const int*)win_starts, (const int*)win_ends,
            (const float*)rays, (float*)out, num_windows, degree, sh_degree,
            min_transmittance, min_response, min_alpha, max_alpha, passes);
    }
    return (int)cudaGetLastError();
}
