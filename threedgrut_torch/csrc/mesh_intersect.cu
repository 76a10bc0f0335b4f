// M1: mesh closest-hit, the playground's ray x triangle test
// (Moller-Trumbore) with the closest hit of every ray.
//
// Replaces no TPU kernel: the JAX package's threedgrut_tpu/playground/
// mesh.py intersect (:186-272) is XLA, a dense [R, 4096] ray x face test
// per chunk of faces inside a lax.scan. Eager PyTorch cannot keep that one
// broadcast at the playground's width (640,000 rays: each [R, 4096, 3] f32
// temporary is 31 GB), and the engine calls it once per bounce and once per
// hybrid frame; in the reference system this per-ray loop is OptiX's job.
//
// One thread per ray, 256 rays a block. The faces (p0, e1 = p1 - p0,
// e2 = p2 - p0: the wrapper's [F, 9] f32) are staged through shared memory
// TILE at a time, as nine rows of TILE floats; every thread of the block
// reads the same face at once (a broadcast). Each thread keeps a running
// best (t, face, u, w) and visits faces in ascending order with a strict
// `<`, which is the JAX function's tie-break (argmin inside a chunk, then
// a strict `<` across chunks: the lowest face index of the least t wins).
// Each expression is JAX's, in its order (h = d x e2, a = e1 . h, s = o -
// p0, u = (s . h) / a, q = s x e1, w = (d . q) / a, t = (e2 . q) / a, dot
// products summed left to right); built with --fmad=false, so the outputs
// are the plain version's (ops/mesh_intersect.py) bit for bit.
//
// Why CUDA and not Triton: the work is a per-ray loop over a staged tile of
// faces with a running argmin carried in registers across tiles, a
// sequential scan per lane that Triton's block model would express as a
// [rays, faces] block plus a reduction per tile, with the tie-break
// re-derived from two argmins.
//
// Bound on this card: operations. Each ray x face pair needs the full test
// (56 f32 operations, counted in chip_smoke.py's FLOP_MESH_PAIR); the bytes
// (24 B in and 16 B out a ray, 36 B a face) are tiny beside it. The test is
// branch-free: a pair's result is a select, so a warp never diverges.
#include <cuda_runtime.h>
#include <math.h>

#define THREADS 256
#define TILE 256

__global__ void __launch_bounds__(THREADS)
mesh_intersect_kernel(const float* __restrict__ rays_o,
                      const float* __restrict__ rays_d,
                      const float* __restrict__ tri, int n_rays, int n_faces,
                      float t_min, float* __restrict__ out_t,
                      int* __restrict__ out_face, float* __restrict__ out_u,
                      float* __restrict__ out_w) {
    __shared__ float f[9][TILE];
    const int r = blockIdx.x * THREADS + threadIdx.x;
    const bool live = r < n_rays;
    float o0 = 0.f, o1 = 0.f, o2 = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f;
    if (live) {
        o0 = rays_o[3 * r + 0]; o1 = rays_o[3 * r + 1];
        o2 = rays_o[3 * r + 2];
        d0 = rays_d[3 * r + 0]; d1 = rays_d[3 * r + 1];
        d2 = rays_d[3 * r + 2];
    }
    float best_t = INFINITY, best_u = 0.f, best_w = 0.f;
    int best_face = -1;
    for (int base = 0; base < n_faces; base += TILE) {
        const int nt = min(TILE, n_faces - base);
        __syncthreads();
        for (int i = threadIdx.x; i < nt * 9; i += THREADS) {
            f[i % 9][i / 9] = tri[(long long)base * 9 + i];
        }
        __syncthreads();
        for (int j = 0; j < nt; ++j) {
            const float p0 = f[0][j], p1 = f[1][j], p2 = f[2][j];
            const float a0 = f[3][j], a1 = f[4][j], a2 = f[5][j];  // e1
            const float b0 = f[6][j], b1 = f[7][j], b2 = f[8][j];  // e2
            const float h0 = d1 * b2 - d2 * b1;
            const float h1 = d2 * b0 - d0 * b2;
            const float h2 = d0 * b1 - d1 * b0;
            const float a = a0 * h0 + a1 * h1 + a2 * h2;
            const bool nondegenerate = fabsf(a) > 1e-9f;
            const float inv_a = 1.0f / (nondegenerate ? a : 1.0f);
            const float s0 = o0 - p0, s1 = o1 - p1, s2 = o2 - p2;
            const float u = (s0 * h0 + s1 * h1 + s2 * h2) * inv_a;
            const float q0 = s1 * a2 - s2 * a1;
            const float q1 = s2 * a0 - s0 * a2;
            const float q2 = s0 * a1 - s1 * a0;
            const float w = (d0 * q0 + d1 * q1 + d2 * q2) * inv_a;
            const float t = (b0 * q0 + b1 * q1 + b2 * q2) * inv_a;
            const bool better = nondegenerate && u >= 0.f && w >= 0.f &&
                                u + w <= 1.f && t > t_min && t < best_t;
            best_t = better ? t : best_t;
            best_u = better ? u : best_u;
            best_w = better ? w : best_w;
            best_face = better ? base + j : best_face;
        }
    }
    if (live) {
        out_t[r] = best_t;
        out_face[r] = best_face;
        out_u[r] = best_u;
        out_w[r] = best_w;
    }
}

// rays_o, rays_d [n_rays, 3] f32; tri [n_faces, 9] f32 (p0, e1, e2).
// Outputs [n_rays]: t (inf on a miss), face (-1), u and w (0). Returns a
// CUDA error, 0 on success.
extern "C" int mesh_intersect(const void* rays_o, const void* rays_d,
                              const void* tri, int n_rays, int n_faces,
                              float t_min, void* out_t, void* out_face,
                              void* out_u, void* out_w, void* stream) {
    if (n_rays <= 0) return (int)cudaGetLastError();
    const int grid = (n_rays + THREADS - 1) / THREADS;
    mesh_intersect_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)rays_o, (const float*)rays_d, (const float*)tri, n_rays,
        n_faces, t_min, (float*)out_t, (int*)out_face, (float*)out_u,
        (float*)out_w);
    return (int)cudaGetLastError();
}
