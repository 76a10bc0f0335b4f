// The per-(ray, candidate row) quantities of the 3DGRT bundle compositor,
// shared by its forward (bundle_trace_fwd.cu, kernel B7) and its backward
// (bundle_trace_bwd.cu, kernel B8).
//
// Port of threedgrut_tpu/ops/pallas/bundle_trace.py _sh_basis_rows,
// _grt_gates and _pair_colors. Both kernels are compiled with --fmad=false
// and evaluate a pair through these definitions (and tile_pair.cuh's
// pair_eval), so the backward sees exactly the forward's alpha, colour and
// transmittance, and its `w > 0` masks put gradients on exactly the pairs
// that composited.
#pragma once
#include "tile_pair.cuh"

#define ROW64 64
// The hit bit of a byte of B7's compositing orders, which B8 re-walks: set
// where the sorted key is < BIG (the other 7 bits are the row).
#define HIT 0x80u

// Per-ray SH basis (bundle_trace.py _sh_basis_rows); entries past
// (sh_degree + 1)^2 are 0.
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         int sh_degree, float* bs) {
#pragma unroll
    for (int i = 0; i < 16; ++i) bs[i] = 0.0f;
    bs[0] = 0.28209479177387814f;
    if (sh_degree >= 1) {
        bs[1] = -0.4886025119029199f * y;
        bs[2] = 0.4886025119029199f * z;
        bs[3] = -0.4886025119029199f * x;
    }
    if (sh_degree >= 2) {
        const float xx = x * x, yy = y * y, zz = z * z;
        bs[4] = 1.0925484305920792f * x * y;
        bs[5] = -1.0925484305920792f * y * z;
        bs[6] = 0.31539156525252005f * (2.0f * zz - xx - yy);
        bs[7] = -1.0925484305920792f * x * z;
        bs[8] = 0.5462742152960396f * (xx - yy);
        if (sh_degree >= 3) {
            bs[9] = -0.5900435899266435f * y * (3.0f * xx - yy);
            bs[10] = 2.890611442640554f * x * y * z;
            bs[11] = -0.4570457994644658f * y * (4.0f * zz - xx - yy);
            bs[12] = 0.3731763325901154f * z * (2.0f * zz - 3.0f * xx
                                                - 3.0f * yy);
            bs[13] = -0.4570457994644658f * x * (4.0f * zz - xx - yy);
            bs[14] = 1.445305721320277f * z * (xx - yy);
            bs[15] = -0.5900435899266435f * x * (xx - 3.0f * yy);
        }
    }
}

// Alpha of row q for the ray: pair_eval's acceptance and both gates.
__device__ __forceinline__ float row_alpha(const float* q, const Ray& ray,
                                           int degree, float min_response,
                                           float min_alpha, float max_alpha,
                                           float* hit_t) {
    const Pair s = pair_eval(q, ray, degree, min_response, min_alpha,
                             max_alpha, 1);
    *hit_t = s.hit_t;
    const bool ok = s.accept && s.vdotu < 0.0f && s.g <= 9.0f;
    return ok ? s.alpha : 0.0f;
}

// Raw SH colour of row q along the ray, coeffs . basis + 0.5 per channel,
// before the clamp at 0.
__device__ __forceinline__ void raw_colours(const float* q, const float* bs,
                                            int nbasis, float* c) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        const float* k = q + 16 + 16 * ch;
        float s = 0.0f;
        // Unrolled with static indices, so bs stays in registers.
#pragma unroll
        for (int i = 0; i < 16; ++i)
            if (i < nbasis) s += k[i] * bs[i];
        c[ch] = s + 0.5f;
    }
}
