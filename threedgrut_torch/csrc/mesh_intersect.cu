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
// One block takes 256 consecutive rays: the engine hands M1 its rays in
// 16x16 pixel tiles, so a block's rays are a narrow bundle, or a bundle
// reflected off one patch of a surface. In one launch a block
//   1. reduces the box of the origins and the box of the directions of its
//      live rays (d != 0: a ray of zero direction has h = d x e2 = 0, so
//      a = 0 and none of its pairs can hit). A block with no live ray
//      writes misses and returns; a live ray with a non-finite component
//      makes the block keep every face;
//   2. stages the faces (p0, e1 = p1 - p0, e2 = p2 - p0: the wrapper's
//      [F, 9] f32) TILE at a time into shared memory with 16-byte loads,
//      and culls them: each thread evaluates a face's pair test over the
//      two boxes in interval arithmetic (`face_survives`), and drops the
//      face when the intervals prove that the test fails for every ray;
//   3. compacts the survivors' indices into a list in ascending order
//      (warp ballots, then a prefix over the ballot words);
//   4. runs the exact pair test (`pair_test`) of every ray against the
//      list only, all lanes over the same face at once (a warp-uniform
//      loop over a shared-memory broadcast), keeping a running best (t,
//      face, u, w) with a strict `<`.
// Tiles follow one another in ascending face order, so the lowest face
// index of the least t wins, as in the JAX function (argmin inside a
// chunk, then a strict `<` across chunks).
//
// Why the cull is exact: the pair test is a fixed sequence of f32
// operations (h = d x e2, a = e1 . h, s = o - p0, u = (s . h) / a,
// q = s x e1, w = (d . q) / a, t = (e2 . q) / a, dot products summed left
// to right), each rounded to nearest (built with --fmad=false). Every
// operation is monotone in each argument: a sum or difference directly, a
// product through its four corner products, 1/a on an interval of one
// sign; and rounding to nearest is monotone. So evaluating the same
// sequence on intervals, rounding each endpoint to nearest, encloses the
// value that every ray of the block computes for that face. A NaN endpoint
// (inf - inf, 0 x inf) propagates (nmin/nmax) and keeps the face; a ray
// whose own values hold a NaN cannot hit. The survivors then hold every
// face that any ray of the block hits, and the exact test over them gives
// the brute force's outputs (ops/mesh_intersect.py closest_hits_plain) bit
// for bit. mesh_intersect_masks, steps 1-3 only, writes each block's kept
// faces for the tests.
//
// Bound on this card: operations. The cull costs 50 f32 operations per
// block and face up to the a tests and 159 more where a keeps one sign
// (chip_smoke.py's FLOP_MESH_CULL_A, FLOP_MESH_CULL_REST), the exact test
// 56 per surviving pair (FLOP_MESH_PAIR); the bytes (24 B in and 16 B out
// a ray, 36 B a face) are small beside them. --fmad=false halves the f32
// rate (no fused multiply-adds), which the brute force (every ray x every
// face) could not get round; the cull removes most pairs instead. The
// IEEE division stays per surviving pair.
//
// Why CUDA and not Triton: the block-wide reduction, the cull, the ballot
// compaction into an ordered list and a per-lane loop over that list with
// a running argmin in registers are one kernel here; Triton's block model
// has no warp ballots or shared-memory lists and would express the exact
// test as a [rays, faces] block plus a reduction per tile.
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#define THREADS 256
#define WARPS (THREADS / 32)
// Faces a tile: phase 5c's 1,284 fit in one. A multiple of THREADS (the
// cull's rounds) and of 4 (a tile starts on a 16-byte boundary).
#define TILE 1536
#define WORDS (TILE / 32)
#define FULL 0xffffffffu
// The staged faces [TILE][9] and the survivors' list [TILE] (61,440 B:
// dynamic shared memory, above the static 48 KB).
constexpr int SMEM = TILE * 9 * (int)sizeof(float) + TILE * (int)sizeof(int);
static_assert(WORDS <= 64, "the prefix takes two ballot words a lane");
static_assert(TILE % THREADS == 0 && TILE % 4 == 0, "tile shape");

struct Iv {
    float lo, hi;
};

// min and max that return a NaN operand (as torch.minimum/maximum do).
__device__ __forceinline__ float nmin(float a, float b) {
    return (a < b || isnan(a)) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
    return (a > b || isnan(a)) ? a : b;
}
__device__ __forceinline__ Iv iv_add(Iv x, Iv y) {
    return {x.lo + y.lo, x.hi + y.hi};
}
__device__ __forceinline__ Iv iv_sub(Iv x, Iv y) {
    return {x.lo - y.hi, x.hi - y.lo};
}
__device__ __forceinline__ Iv iv_subc(Iv x, float c) {
    return {x.lo - c, x.hi - c};
}
__device__ __forceinline__ Iv iv_mulc(Iv x, float c) {
    const float p = x.lo * c, q = x.hi * c;
    return {nmin(p, q), nmax(p, q)};
}
__device__ __forceinline__ Iv iv_mul(Iv x, Iv y) {
    const float p = x.lo * y.lo, q = x.lo * y.hi;
    const float r = x.hi * y.lo, s = x.hi * y.hi;
    return {nmin(nmin(p, q), nmin(r, s)), nmax(nmax(p, q), nmax(r, s))};
}

// False when no ray with origin in o[3] and direction in d[3] can pass the
// pair test with face f (p0, e1, e2): the test's own expressions, in its
// order, on intervals. ops/mesh_intersect.py block_face_masks_plain is the
// same in torch operations.
__device__ __forceinline__ bool face_survives(const float* f, const Iv* o,
                                              const Iv* d, float t_min) {
    const float p0 = f[0], p1 = f[1], p2 = f[2];
    const float a0 = f[3], a1 = f[4], a2 = f[5];  // e1
    const float b0 = f[6], b1 = f[7], b2 = f[8];  // e2
    const Iv h0 = iv_sub(iv_mulc(d[1], b2), iv_mulc(d[2], b1));
    const Iv h1 = iv_sub(iv_mulc(d[2], b0), iv_mulc(d[0], b2));
    const Iv h2 = iv_sub(iv_mulc(d[0], b1), iv_mulc(d[1], b0));
    const Iv a = iv_add(iv_add(iv_mulc(h0, a0), iv_mulc(h1, a1)),
                        iv_mulc(h2, a2));
    // |a| <= 1e-9 for every ray: degenerate everywhere.
    if (a.lo >= -1e-9f && a.hi <= 1e-9f) return false;
    // Some ray may have |a| <= 1e-9, or a near 0: u, w, t are unbounded.
    if (!(a.lo > 1e-9f || a.hi < -1e-9f)) return true;
    const Iv inv_a = {1.0f / a.hi, 1.0f / a.lo};  // 1/a falls on one sign
    const Iv s0 = iv_subc(o[0], p0), s1 = iv_subc(o[1], p1),
             s2 = iv_subc(o[2], p2);
    const Iv u = iv_mul(
        iv_add(iv_add(iv_mul(s0, h0), iv_mul(s1, h1)), iv_mul(s2, h2)),
        inv_a);
    const Iv q0 = iv_sub(iv_mulc(s1, a2), iv_mulc(s2, a1));
    const Iv q1 = iv_sub(iv_mulc(s2, a0), iv_mulc(s0, a2));
    const Iv q2 = iv_sub(iv_mulc(s0, a1), iv_mulc(s1, a0));
    const Iv w = iv_mul(
        iv_add(iv_add(iv_mul(d[0], q0), iv_mul(d[1], q1)), iv_mul(d[2], q2)),
        inv_a);
    const Iv t = iv_mul(
        iv_add(iv_add(iv_mulc(q0, b0), iv_mulc(q1, b1)), iv_mulc(q2, b2)),
        inv_a);
    // Each comparison is false on a NaN: a NaN keeps the face.
    return !(u.hi < 0.f || w.hi < 0.f || u.lo + w.lo > 1.f ||
             t.hi <= t_min);
}

// The exact test of one ray against face f (index `face`), folded into the
// ray's running best. The expressions of the JAX function, in its order.
__device__ __forceinline__ void pair_test(const float* f, int face, float o0,
                                          float o1, float o2, float d0,
                                          float d1, float d2, float t_min,
                                          float& best_t, float& best_u,
                                          float& best_w, int& best_face) {
    const float p0 = f[0], p1 = f[1], p2 = f[2];
    const float a0 = f[3], a1 = f[4], a2 = f[5];  // e1
    const float b0 = f[6], b1 = f[7], b2 = f[8];  // e2
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
    best_face = better ? face : best_face;
}

// MASKS false: M1 (steps 1-4). MASKS true: steps 1-3, each kept face of
// block b set to 1 in mask[b, F] (zeroed by the caller).
template <bool MASKS>
__global__ void __launch_bounds__(THREADS)
mesh_intersect_kernel(const float* __restrict__ rays_o,
                      const float* __restrict__ rays_d,
                      const float* __restrict__ tri, int n_rays, int n_faces,
                      float t_min, float* __restrict__ out_t,
                      int* __restrict__ out_face, float* __restrict__ out_u,
                      float* __restrict__ out_w,
                      unsigned char* __restrict__ mask) {
    extern __shared__ float4 smem4[];
    float* fs = reinterpret_cast<float*>(smem4);  // [TILE][9]
    int* list = reinterpret_cast<int*>(fs + TILE * 9);
    __shared__ float red[WARPS][12];
    __shared__ unsigned words[WORDS];
    __shared__ int word_base[WORDS];
    __shared__ int n_keep;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int r = blockIdx.x * THREADS + threadIdx.x;
    const bool in = r < n_rays;
    float o0 = 0.f, o1 = 0.f, o2 = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f;
    if (in) {
        o0 = rays_o[3 * r + 0]; o1 = rays_o[3 * r + 1];
        o2 = rays_o[3 * r + 2];
        d0 = rays_d[3 * r + 0]; d1 = rays_d[3 * r + 1];
        d2 = rays_d[3 * r + 2];
    }
    // 1. The boxes of the live rays' origins and directions.
    const bool live = in && (d0 != 0.f || d1 != 0.f || d2 != 0.f);
    const bool finite = isfinite(o0) && isfinite(o1) && isfinite(o2) &&
                        isfinite(d0) && isfinite(d1) && isfinite(d2);
    const bool good = live && finite;
    const int any_live = __syncthreads_or(live);
    const int keep_all = __syncthreads_or(live && !finite);
    if (!any_live) {  // block-uniform
        if (!MASKS && in) {
            out_t[r] = INFINITY;
            out_face[r] = -1;
            out_u[r] = 0.f;
            out_w[r] = 0.f;
        }
        return;
    }
    float box[12] = {o0, o1, o2, d0, d1, d2, o0, o1, o2, d0, d1, d2};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        box[k] = good ? box[k] : INFINITY;
        box[6 + k] = good ? box[6 + k] : -INFINITY;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
            box[k] = fminf(box[k], __shfl_xor_sync(FULL, box[k], off));
            box[6 + k] =
                fmaxf(box[6 + k], __shfl_xor_sync(FULL, box[6 + k], off));
        }
    }
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < 12; ++k) red[warp][k] = box[k];
    }
    __syncthreads();
    Iv ob[3], db[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        float olo = red[0][k], ohi = red[0][6 + k];
        float dlo = red[0][3 + k], dhi = red[0][9 + k];
        for (int i = 1; i < WARPS; ++i) {
            olo = fminf(olo, red[i][k]);
            ohi = fmaxf(ohi, red[i][6 + k]);
            dlo = fminf(dlo, red[i][3 + k]);
            dhi = fmaxf(dhi, red[i][9 + k]);
        }
        ob[k] = {olo, ohi};
        db[k] = {dlo, dhi};
    }

    float best_t = INFINITY, best_u = 0.f, best_w = 0.f;
    int best_face = -1;
    for (int base = 0; base < n_faces; base += TILE) {
        const int nt = min(TILE, n_faces - base);
        __syncthreads();  // the last tile's faces and list are done with
        // 2. Stage the tile (16-byte loads: base * 9 floats is a multiple
        // of 4, and the wrapper checks that tri is 16-byte aligned) ...
        const float4* g4 =
            reinterpret_cast<const float4*>(tri + (long long)base * 9);
        const int n4 = nt * 9 / 4;
        for (int i = threadIdx.x; i < n4; i += THREADS) smem4[i] = g4[i];
        for (int i = 4 * n4 + threadIdx.x; i < nt * 9; i += THREADS)
            fs[i] = tri[(long long)base * 9 + i];
        __syncthreads();
        // ... and cull it, one face a thread a round.
        for (int j0 = 0; j0 < nt; j0 += THREADS) {
            const int j = j0 + threadIdx.x;
            const bool keep =
                j < nt && (keep_all || face_survives(fs + 9 * j, ob, db,
                                                     t_min));
            const unsigned bits = __ballot_sync(FULL, keep);
            if (lane == 0) words[(j0 >> 5) + warp] = bits;
        }
        __syncthreads();
        // 3. The survivors' list in ascending order: each ballot word's
        // offset (warp 0, two words a lane), then each survivor's slot.
        const int nw = (nt + 31) >> 5;
        if (warp == 0) {
            const int c0 = lane < nw ? __popc(words[lane]) : 0;
            const int c1 = lane + 32 < nw ? __popc(words[lane + 32]) : 0;
            int s0 = c0, s1 = c1;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const int x0 = __shfl_up_sync(FULL, s0, off);
                const int x1 = __shfl_up_sync(FULL, s1, off);
                if (lane >= off) {
                    s0 += x0;
                    s1 += x1;
                }
            }
            const int total0 = __shfl_sync(FULL, s0, 31);
            if (lane < nw) word_base[lane] = s0 - c0;
            if (lane + 32 < nw) word_base[lane + 32] = total0 + s1 - c1;
            if (lane == 31) n_keep = total0 + s1;
        }
        __syncthreads();
        for (int j0 = 0; j0 < nt; j0 += THREADS) {
            const int j = j0 + threadIdx.x;
            const int wi = (j0 >> 5) + warp;
            const unsigned bits = words[wi];
            if (j < nt && ((bits >> lane) & 1u))
                list[word_base[wi] + __popc(bits & ((1u << lane) - 1u))] = j;
        }
        __syncthreads();
        const int nk = n_keep;
        if (MASKS) {
            for (int k = threadIdx.x; k < nk; k += THREADS)
                mask[(long long)blockIdx.x * n_faces + base + list[k]] = 1;
        } else {
            // 4. The exact test over the list, every lane on the same face.
            for (int k = 0; k < nk; ++k) {
                const int j = list[k];
                pair_test(fs + 9 * j, base + j, o0, o1, o2, d0, d1, d2,
                          t_min, best_t, best_u, best_w, best_face);
            }
        }
    }
    if (!MASKS && in) {
        out_t[r] = best_t;
        out_face[r] = best_face;
        out_u[r] = best_u;
        out_w[r] = best_w;
    }
}

// The kernel's ceiling of dynamic shared memory, set once for each device
// (an attribute of the function on the current device), not every launch.
template <bool MASKS>
static cudaError_t set_smem_once() {
    static std::atomic<unsigned long long> done{0};  // a bit a device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(mesh_intersect_kernel<MASKS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
    return err;
}

template <bool MASKS>
static int launch(const void* rays_o, const void* rays_d, const void* tri,
                  int n_rays, int n_faces, float t_min, void* out_t,
                  void* out_face, void* out_u, void* out_w, void* mask,
                  void* stream) {
    if (n_rays <= 0) return (int)cudaGetLastError();
    const cudaError_t err = set_smem_once<MASKS>();
    if (err != cudaSuccess) return (int)err;
    const int grid = (n_rays + THREADS - 1) / THREADS;
    mesh_intersect_kernel<MASKS><<<grid, THREADS, SMEM,
                                   (cudaStream_t)stream>>>(
        (const float*)rays_o, (const float*)rays_d, (const float*)tri, n_rays,
        n_faces, t_min, (float*)out_t, (int*)out_face, (float*)out_u,
        (float*)out_w, (unsigned char*)mask);
    return (int)cudaGetLastError();
}

// rays_o, rays_d [n_rays, 3] f32; tri [n_faces, 9] f32 (p0, e1, e2),
// 16-byte aligned. Outputs [n_rays]: t (inf on a miss), face (-1), u and w
// (0). Returns a CUDA error, 0 on success.
extern "C" int mesh_intersect(const void* rays_o, const void* rays_d,
                              const void* tri, int n_rays, int n_faces,
                              float t_min, void* out_t, void* out_face,
                              void* out_u, void* out_w, void* stream) {
    return launch<false>(rays_o, rays_d, tri, n_rays, n_faces, t_min, out_t,
                         out_face, out_u, out_w, nullptr, stream);
}

// Steps 1-3 of mesh_intersect: mask [ceil(n_rays / 256), n_faces] uint8,
// zeroed by the caller, gets a 1 for each face that block keeps. For the
// tests; no path calls it.
extern "C" int mesh_intersect_masks(const void* rays_o, const void* rays_d,
                                    const void* tri, int n_rays, int n_faces,
                                    float t_min, void* mask, void* stream) {
    return launch<true>(rays_o, rays_d, tri, n_rays, n_faces, t_min, nullptr,
                        nullptr, nullptr, nullptr, mask, stream);
}
