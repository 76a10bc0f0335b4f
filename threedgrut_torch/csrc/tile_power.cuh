// What the cull-mask (B3) and key-expansion (B4) kernels share: the
// tile-min power response, the approximate minimum Gaussian power over one
// 16x16 tile (reference gutProjector.cuh:49-78; threedgrut_tpu/ops/
// projection.py tile_min_power_response), and the per-particle record that
// B3 writes and B4 reads.
//
// EXACTNESS: every operation below is written in the order of the JAX
// package's expression, and both kernels are compiled with --fmad=false, so
// no multiply-add is contracted. Each float result is then the correctly
// rounded result of the same IEEE operation as on the CPU, and the `<`
// culling decisions match the plain PyTorch versions (and JAX) bit for bit.
// The parts that depend only on the particle (TilePower) are computed once
// per particle: each is the same IEEE operation on the same operands, and
// (-16) * c is -(16 * c) bit for bit (round to nearest is sign-symmetric).
#pragma once

#include <stdint.h>

// The record: 16 32-bit words (64 B, two 32-byte sectors) per particle, in
// particle order (ops/expand.py RECORD names the same words). Floats are
// stored as their bits.
enum RecordWord {
    REC_TMIN_X = 0, REC_TMIN_Y = 1,   // tile bbox min
    REC_BW = 2,                       // bbox width in tiles, at least 1
    REC_COUNT = 3,                    // surviving tile count
    REC_M0 = 4, REC_M1 = 5, REC_M2 = 6,  // survival mask, 24/24/16 bits
    REC_CA = 7, REC_CB = 8, REC_CC = 9,  // conic
    REC_MX = 10, REC_MY = 11,         // centre
    REC_MAX_POWER = 12,
    REC_E_DY = 13,                    // footprint row half-extent
    REC_RCP_X = 14, REC_RCP_Y = 15,   // 1 / (256 ca), 1 / (256 cc)
    REC_WORDS = 16
};

// jnp.clip / torch.clamp to [0, 1], NaN passing through as they do.
__device__ __forceinline__ float clip01(float x) {
    if (x != x) return x;
    return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// jnp.maximum(x, lo) with NaN passing through.
__device__ __forceinline__ float nan_max(float x, float lo) {
    if (x != x) return x;
    return x > lo ? x : lo;
}

// The footprint's row half-extent sqrt(2 mp ca / det) (1e9 for a
// degenerate conic), the expand.py _kernel formula.
__device__ __forceinline__ float row_half_extent(float ca, float cb, float cc,
                                                 float mp) {
    float det = ca * cc - cb * cb;
    return det > 1e-12f
        ? sqrtf(nan_max(2.0f * mp * ca, 0.0f) / nan_max(det, 1e-12f))
        : 1e9f;
}

// The particle's part of the power test: conic (ca, cb, cc), centre
// (mx, my), 16 ca, 16 cb, 16 cc and the two reciprocals.
struct TilePower {
    float ca, cb, cc, mx, my, a16, b16, c16, rcp_x, rcp_y;
};

__device__ __forceinline__ TilePower tile_power(float ca, float cb, float cc,
                                                float mx, float my,
                                                float rcp_x, float rcp_y) {
    const float ts = 16.0f;
    return TilePower{ca, cb, cc, mx, my, ts * ca, ts * cb, ts * cc, rcp_x,
                     rcp_y};
}

__device__ __forceinline__ float rcp_256(float c) {
    return 1.0f / (256.0f * c);
}

// Power of the particle `q` at the point of tile (tx, ty) closest to its
// centre; 0 when the centre lies inside the tile.
__device__ __forceinline__ float tile_min_power(float tx, float ty,
                                                const TilePower& q) {
    const float ts = 16.0f;
    float tminx = ts * tx, tminy = ts * ty;
    float tmaxx = tminx + ts, tmaxy = tminy + ts;
    float offx = tminx - q.mx, offy = tminy - q.my;
    float la_x = offx > 0.0f ? 1.0f : 0.0f;
    float la_y = offy > 0.0f ? 1.0f : 0.0f;
    float nir_x = la_x + (q.mx > tmaxx ? 1.0f : 0.0f);
    float nir_y = la_y + (q.my > tmaxy ? 1.0f : 0.0f);
    bool outside = (nir_x + nir_y) > 0.0f;
    float px = tmaxx + (tminx - tmaxx) * la_x;
    float py = tmaxy + (tminy - tmaxy) * la_y;
    bool pos_x = offx >= 0.0f, pos_y = offy >= 0.0f;
    float dxy_x = pos_x ? ts : -ts;
    float dxy_y = pos_y ? ts : -ts;
    float dfx = q.mx - px, dfy = q.my - py;
    // dxy_x * ca, dxy_x * cb, dxy_y * cb, dxy_y * cc
    float xa = pos_x ? q.a16 : -q.a16, xb = pos_x ? q.b16 : -q.b16;
    float yb = pos_y ? q.b16 : -q.b16, yc = pos_y ? q.c16 : -q.c16;
    float t_x = nir_y * clip01((xa * dfx + xb * dfy) * q.rcp_x);
    float t_y = nir_x * clip01((yb * dfx + yc * dfy) * q.rcp_y);
    float dx = q.mx - (px + t_x * dxy_x);
    float dy = q.my - (py + t_y * dxy_y);
    float power = 0.5f * (q.ca * dx * dx + q.cc * dy * dy) + q.cb * dx * dy;
    return outside ? power : 0.0f;
}
