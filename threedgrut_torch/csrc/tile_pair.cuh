// The per-(pixel, slot) pair math of the 3DGUT tile compositor, shared by
// the forward (tile_raster_fwd.cu, kernel B1) and the backward
// (tile_raster_bwd.cu, kernel B2).
//
// Port of threedgrut_tpu/ops/pallas/tile_raster.py _pair_quantities and
// _alpha_from_raw. Both kernels are compiled with --fmad=false and evaluate
// a pair through this one definition, so the backward accepts exactly the
// hits the forward accepted and re-derives exactly its alpha and its
// sequential transmittance. Its `w > 0` masks then put gradients on exactly
// the slots that composited, and nowhere else.
#pragma once
#include <cuda_runtime.h>

#define CHUNK 128
#define ROW_F 16
#define PIX 256
#define BIG 3.4e38f   // a pinned sort key

// Generalized-Gaussian response exp(s_n g^(n/2)) (ops/particles.py
// kernel_response; scales from constants.GG_SCALE).
__device__ __forceinline__ float kernel_response(float g, int degree) {
    switch (degree) {
        case 0: return fmaxf(1.0f + -0.329630334487f * sqrtf(fmaxf(g, 1e-12f)), 0.0f);
        case 1: return expf(-1.5f * sqrtf(fmaxf(g, 1e-12f)));
        case 2: return expf(-0.5f * g);
        case 3: return expf(-0.166666666667f * g * sqrtf(fmaxf(g, 1e-12f)));
        case 4: return expf(-0.0555555555556f * g * g);
        case 5: return expf(-0.0185185185185f * g * g * sqrtf(fmaxf(g, 1e-12f)));
        default: {  // 8
            float g2 = g * g;
            return expf(-0.000685871056241f * g2 * g2);
        }
    }
}

// dr/dg given r = kernel_response(g) (tile_raster.py
// _response_and_grad_coeff).
__device__ __forceinline__ float kernel_response_grad(float g, float r,
                                                      int degree) {
    switch (degree) {
        case 0: {
            const float s = -0.329630334487f;
            const float sq = sqrtf(fmaxf(g, 1e-12f));
            return r > 0.0f ? 0.5f * s / sq : 0.0f;
        }
        case 1: return r * -1.5f * 0.5f / sqrtf(fmaxf(g, 1e-12f));
        case 2: return r * -0.5f;
        case 3: return r * -0.166666666667f * 1.5f * sqrtf(fmaxf(g, 1e-12f));
        case 4: return r * -0.0555555555556f * 2.0f * g;
        case 5: return r * -0.0185185185185f * 2.5f * g * sqrtf(fmaxf(g, 1e-12f));
        default: return r * -0.000685871056241f * 4.0f * (g * g) * g;
    }
}

struct Ray {
    float ox, oy, oz, dx, dy, dz, tmax;
};

// Pixel p's ray of a packed [8, PIX] tile block (rows 0-2 origin, 3-5
// direction, 6 t_max).
__device__ __forceinline__ Ray load_ray(const float* ray, int p) {
    return Ray{ray[0 * PIX + p], ray[1 * PIX + p], ray[2 * PIX + p],
               ray[3 * PIX + p], ray[4 * PIX + p], ray[5 * PIX + p],
               ray[6 * PIX + p]};
}

// Pixel p's ray kept in a sorted leg's shared column (rows 0-6 of a [., PIX]
// block, `col` already offset by p): reloaded where it is needed rather than
// held in registers beside the network's 160.
__device__ __forceinline__ void stash_ray(float* col, const Ray& r) {
    col[0 * PIX] = r.ox;
    col[1 * PIX] = r.oy;
    col[2 * PIX] = r.oz;
    col[3 * PIX] = r.dx;
    col[4 * PIX] = r.dy;
    col[5 * PIX] = r.dz;
    col[6 * PIX] = r.tmax;
}

__device__ __forceinline__ Ray stashed_ray(const float* col) {
    return Ray{col[0 * PIX], col[1 * PIX], col[2 * PIX], col[3 * PIX],
               col[4 * PIX], col[5 * PIX], col[6 * PIX]};
}

struct Pair {
    float w0x, w0y, w0z;  // o - mean
    float ux, uy, uz;     // u = A (o - mean)
    float vx, vy, vz;     // v = A d
    float cx, cy, cz;     // v x u
    float inv_vsq;        // 1 / max(|v|^2, 1e-24)
    float g;              // |v x u|^2 / |v|^2
    float resp;           // kernel response
    float alpha_raw;      // resp * opacity
    float alpha;          // min(alpha_raw, max_alpha)
    float vdotu;
    float hit_t;          // |v . u| / |v|^2
    bool accept;          // response, alpha and segment tests
};

// The part of a pair that depends on the row and the ray's origin only:
// w0 = o - mean and u = A w0. Where every ray of a tile starts at one
// origin (any global-shutter camera), B1's default legs compute it once per
// row of a window instead of once per (pixel, row).
struct RowU {
    float w0x, w0y, w0z;  // o - mean
    float ux, uy, uz;     // u = A (o - mean)
};

__device__ __forceinline__ RowU row_u(const float* q, float ox, float oy,
                                      float oz) {
    RowU h;
    h.w0x = ox - q[9];
    h.w0y = oy - q[10];
    h.w0z = oz - q[11];
    h.ux = q[0] * h.w0x + q[1] * h.w0y + q[2] * h.w0z;
    h.uy = q[3] * h.w0x + q[4] * h.w0y + q[5] * h.w0z;
    h.uz = q[6] * h.w0x + q[7] * h.w0y + q[8] * h.w0z;
    return h;
}

// One slot row q (16 floats: A row-major, mean, opacity, rgb) against one
// ray, given the row's RowU for the ray's origin. The transmittance test
// (T > min_transmittance) is the caller's.
__device__ __forceinline__ Pair pair_from_u(const float* q, const RowU& h,
                                            const Ray& r, int degree,
                                            float min_response,
                                            float min_alpha, float max_alpha,
                                            int has_t_max) {
    Pair s;
    s.w0x = h.w0x;
    s.w0y = h.w0y;
    s.w0z = h.w0z;
    s.ux = h.ux;
    s.uy = h.uy;
    s.uz = h.uz;
    s.vx = q[0] * r.dx + q[1] * r.dy + q[2] * r.dz;
    s.vy = q[3] * r.dx + q[4] * r.dy + q[5] * r.dz;
    s.vz = q[6] * r.dx + q[7] * r.dy + q[8] * r.dz;
    s.cx = s.vy * s.uz - s.vz * s.uy;
    s.cy = s.vz * s.ux - s.vx * s.uz;
    s.cz = s.vx * s.uy - s.vy * s.ux;
    const float crsq = s.cx * s.cx + s.cy * s.cy + s.cz * s.cz;
    const float vsq = s.vx * s.vx + s.vy * s.vy + s.vz * s.vz;
    s.inv_vsq = 1.0f / fmaxf(vsq, 1e-24f);
    s.g = crsq * s.inv_vsq;
    s.resp = kernel_response(s.g, degree);
    s.alpha_raw = s.resp * q[12];
    s.alpha = fminf(s.alpha_raw, max_alpha);
    s.vdotu = s.vx * s.ux + s.vy * s.uy + s.vz * s.uz;
    s.hit_t = fabsf(s.vdotu) * s.inv_vsq;
    const bool in_segment = !has_t_max || r.tmax <= 0.0f || s.hit_t <= r.tmax;
    s.accept = s.resp > min_response && s.alpha > min_alpha && in_segment;
    return s;
}

// The same for a ray of its own origin: with --fmad=false the two forms
// give the same bits.
__device__ __forceinline__ Pair pair_eval(const float* q, const Ray& r,
                                          int degree, float min_response,
                                          float min_alpha, float max_alpha,
                                          int has_t_max) {
    return pair_from_u(q, row_u(q, r.ox, r.oy, r.oz), r, degree,
                       min_response, min_alpha, max_alpha, has_t_max);
}

// The sorted mode's re-sort of one pixel's window (tile_raster.py
// _oddeven_sort) in registers: `passes` passes of odd-even transposition over
// the CHUNK keys, pass i comparing positions (j, j + 1) with j = i mod 2 and
// swapping where key[j + 1] < key[j] (strict: stable on ties); the row
// indices follow their keys. Every position is a compile-time constant (both
// parities unrolled, a pair of passes per trip), so key[] stays in 128
// registers and idx[] in 32, four row indices (bytes) to a word, byte k & 3
// of word k >> 2 for position k. A pixel stops once an odd and an even pass
// in a row swapped nothing: its keys then stand still under every later
// pass, so the result is that of all `passes` passes.
__device__ __forceinline__ int window_row(const unsigned (&idx)[CHUNK / 4],
                                          int k) {
    return (int)((idx[k >> 2] >> (8 * (k & 3))) & 0xffu);
}

__device__ __forceinline__ void window_rows_init(unsigned (&idx)[CHUNK / 4]) {
#pragma unroll
    for (int w = 0; w < CHUNK / 4; ++w) idx[w] = 0x03020100u + 0x04040404u * w;
}

// Compare-exchange of positions (j, j + 1), j a compile-time constant once
// the caller's loop is unrolled; returns whether it swapped. The indices
// move by a byte permute whose selector is the identity unless it swaps.
__device__ __forceinline__ bool oddeven_cmpx(float (&key)[CHUNK],
                                             unsigned (&idx)[CHUNK / 4],
                                             int j) {
    const float ka = key[j], kb = key[j + 1];
    const bool s = kb < ka;
    key[j] = s ? kb : ka;
    key[j + 1] = s ? ka : kb;
    const int w = j >> 2, b = j & 3;
    if (b < 3) {
        const unsigned sel = b == 0 ? 0x3201u : b == 1 ? 0x3120u : 0x2310u;
        idx[w] = __byte_perm(idx[w], 0u, s ? sel : 0x3210u);
    } else {
        const unsigned lo = idx[w], hi = idx[w + 1];
        idx[w] = __byte_perm(lo, hi, s ? 0x4210u : 0x3210u);
        idx[w + 1] = __byte_perm(lo, hi, s ? 0x7653u : 0x7654u);
    }
    return s;
}

template <int PARITY>
__device__ __forceinline__ bool oddeven_pass(float (&key)[CHUNK],
                                             unsigned (&idx)[CHUNK / 4]) {
    bool swapped = false;
#pragma unroll
    for (int j = PARITY; j < CHUNK - 1; j += 2)
        swapped |= oddeven_cmpx(key, idx, j);
    return swapped;
}

__device__ __forceinline__ void oddeven_network_regs(
    float (&key)[CHUNK], unsigned (&idx)[CHUNK / 4], int passes) {
    int quiet = 0;
    for (int i = 0; i < passes; i += 2) {
        quiet = oddeven_pass<0>(key, idx) ? 0 : quiet + 1;
        if (quiet == 2 || i + 1 == passes) break;
        quiet = oddeven_pass<1>(key, idx) ? 0 : quiet + 1;
        if (quiet == 2) break;
    }
}

// Sort key of a row of the tile in a sorted-mode window: its hit_t,
// accepted or not (rows before the tile's range are pinned at -BIG and rows
// after it at BIG by the caller, so neighbour tiles and padding stay put).
__device__ __forceinline__ float pair_hit_t(const float* q, const Ray& ray,
                                            int degree, float min_response,
                                            float min_alpha, float max_alpha,
                                            int has_t_max) {
    return pair_eval(q, ray, degree, min_response, min_alpha, max_alpha,
                     has_t_max).hit_t;
}
