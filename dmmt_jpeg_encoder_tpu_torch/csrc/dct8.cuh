// 8-point DCT device functions shared by the phase-1 and plane-DCT kernels.
//
// The float32 roundings are those of the JAX reference as XLA's CPU backend
// compiles it (see ops/fma.py and ops/dct.py): explicitly rounded
// __fmul_rn / __fadd_rn / __fsub_rn everywhere, __fmaf_rn exactly where XLA
// fuses a single-use product into the add that consumes it. The library is
// built with --fmad=false, so nvcc contracts nothing on its own.
//
// - arai8: the Arai-Agui-Nakajima butterfly (src/cosine_transform/arai.rs
//   op order) with the six fused products of ops/dct.arai_butterfly
//   (ROADMAP C1), on eight registers or on eight strided values; the
//   constants come from ops/fused_arai.kernel_constants.
// - contract8: the 8-term contraction of the matmul DCTs (DMMT_P1=mxu and
//   fused1, the SIMPLE and SEPARATED variants; ops/dct.contract8): term n
//   goes to accumulator n mod 4, the first term of each a plain product,
//   combined as (a0 + a1) + (a2 + a3).
// - split8 and contract8_split: the bf16x3 contraction of DMMT_P1_PREC=high
//   (ops/mxu_dct.dot_p1) for the matmul DCTs of DMMT_P1=mxu and fused1;
//   contract_row: one output of either contraction, the weights from the
//   launch's parameters (mxu_dct.cu, fused_phase1.cu).
// - round_half_away / round_away, div_by_int: the quantizer's rounding and
//   the plane DCTs' division by an 8-bit table entry (plane_dct.cu and
//   mxu_dct.cu compile the same source).
//
// Device functions cannot be shared between the library's separately
// compiled sources (no relocatable device code), hence this header.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dmmt {

// Layout of the float32 constants array (ops/fused_arai.kernel_constants).
enum {
    K_Y0, K_Y1, K_Y2, K_LEVEL_SHIFT, K_SCALE,
    K_CB0, K_CB1, K_CB2, K_CR0, K_CR1, K_CR2,
    K_A1, K_A2, K_A3, K_A4, K_A5,
    K_S0,
    K_COUNT = K_S0 + 8,
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// One 8-point AAN pass over eight values held in registers, in place.
__device__ __forceinline__ void arai8(float (&x)[8], const float* k) {
    const float v00 = x[0], v01 = x[1], v02 = x[2], v03 = x[3];
    const float v04 = x[4], v05 = x[5], v06 = x[6], v07 = x[7];

    const float v10 = add(v00, v07), v11 = add(v01, v06), v12 = add(v02, v05);
    const float v13 = add(v03, v04), v14 = sub(v03, v04), v15 = sub(v02, v05);
    const float v16 = sub(v01, v06), v17 = sub(v00, v07);

    const float v20 = add(v10, v13), v21 = add(v11, v12), v22 = sub(v11, v12);
    const float v23 = sub(v10, v13), v24 = sub(-v14, v15), v25 = add(v15, v16);
    const float v26 = add(v16, v17);

    const float v30 = add(v20, v21), v31 = sub(v20, v21), v32 = add(v22, v23);

    const float m = mul(add(v24, v26), k[K_A5]);
    const float v44 = fmadd(-v24, k[K_A2], -m), v46 = fmadd(v26, k[K_A4], -m);

    const float v52 = fmadd(v32, k[K_A1], v23), v53 = fmadd(-v32, k[K_A1], v23);
    const float v55 = fmadd(v25, k[K_A3], v17), v57 = fmadd(-v25, k[K_A3], v17);

    const float v64 = add(v44, v57), v65 = add(v55, v46);
    const float v66 = sub(v55, v46), v67 = sub(v57, v44);

    x[0] = mul(v30, k[K_S0 + 0]);
    x[1] = mul(v65, k[K_S0 + 1]);
    x[2] = mul(v52, k[K_S0 + 2]);
    x[3] = mul(v67, k[K_S0 + 3]);
    x[4] = mul(v31, k[K_S0 + 4]);
    x[5] = mul(v64, k[K_S0 + 5]);
    x[6] = mul(v53, k[K_S0 + 6]);
    x[7] = mul(v66, k[K_S0 + 7]);
}

// The same pass over x[0], x[step], ..., x[7*step], in place.
__device__ inline void arai8(float* x, int step, const float* k) {
    float v[8];
    for (int i = 0; i < 8; ++i) v[i] = x[i * step];
    arai8(v, k);
    for (int i = 0; i < 8; ++i) x[i * step] = v[i];
}

// sum_n x[n] * w[n] over eight values, in XLA's CPU order.
__device__ __forceinline__ float contract8(const float (&x)[8], const float* w) {
    float a0 = mul(x[0], w[0]), a1 = mul(x[1], w[1]), a2 = mul(x[2], w[2]), a3 = mul(x[3], w[3]);
    a0 = fmadd(x[4], w[4], a0);
    a1 = fmadd(x[5], w[5], a1);
    a2 = fmadd(x[6], w[6], a2);
    a3 = fmadd(x[7], w[7], a3);
    return add(add(a0, a1), add(a2, a3));
}

// Eight values split into bf16 halves, held as floats: hi = bf16(x), lo =
// bf16(x - hi) (x - hi is exact), both rounded to nearest even.
struct Split8 {
    float hi[8];
    float lo[8];
};

__device__ __forceinline__ float bf16_rn(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ Split8 split8(const float (&x)[8]) {
    Split8 s;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        s.hi[n] = bf16_rn(x[n]);
        s.lo[n] = bf16_rn(sub(x[n], s.hi[n]));
    }
    return s;
}

// sum_n x[n] * w[n] over eight bf16 values held as floats, in the order of
// XLA's CPU dot of bf16 operands with a float32 result on a host with
// AVX512-BF16 (VDPBF16PS adds the odd product of each pair, then the even
// one): from 0, n = 1, 0, 3, 2, 5, 4, 7, 6. A bf16 x bf16 product is exact
// in float32, so each fma rounds only its add. VDPBF16PS flushes denormal
// inputs and results to zero, which CUDA's fma (the library is built
// without -ftz) does not; the two differ only where a value falls below
// 2^-126. None does here: C's entries lie in 0.097..0.49 and their lo
// halves in 3.7e-5..9.5e-4, and the planes hold level-shifted samples in
// units of 1 / maxval (maxval < 2^16) and their 8-term sums, whose lo
// halves are 0 or many binades above 2^-126.
__device__ __forceinline__ float chain8_pairs(const float* x, const float* w) {
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < 8; p += 2) {
        s = fmadd(x[p + 1], w[p + 1], s);
        s = fmadd(x[p], w[p], s);
    }
    return s;
}

// hi(x).hi(w) + (lo(x).hi(w) + hi(x).lo(w)): ops/mxu_dct.dot_p1's
// contraction of one output (IEEE addition is commutative, so it is the
// same sum whichever operand is the matrix)
__device__ __forceinline__ float contract8_split(const Split8& x, const float* w_hi, const float* w_lo) {
    return add(chain8_pairs(x.hi, w_hi), add(chain8_pairs(x.lo, w_hi), chain8_pairs(x.hi, w_lo)));
}

// Output `row` of a matmul DCT pass over x, the weights from the launch's
// parameters m: C [8][8] (row k = frequency) in m.c, contracted by
// contract8; or, where M::SPLIT (DMMT_P1_PREC=high), C's bf16 halves in
// m.hi and m.lo, contracted by contract8_split with x's halves xs.
template <typename M>
__device__ __forceinline__ float contract_row(const float (&x)[8], const Split8& xs, const M& m, int row) {
    float w[8];
    if constexpr (M::SPLIT) {
        float lo[8];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            w[n] = m.hi[row * 8 + n];
            lo[n] = m.lo[row * 8 + n];
        }
        return contract8_split(xs, w, lo);
    } else {
#pragma unroll
        for (int n = 0; n < 8; ++n) w[n] = m.c[row * 8 + n];
        return contract8(x, w);
    }
}

// sign(x) * floor(|x| + 0.5), then int16
__device__ __forceinline__ short round_half_away(float x) {
    const float a = floorf(add(fabsf(x), 0.5f));
    return static_cast<short>(static_cast<int>(x > 0.0f ? a : (x < 0.0f ? -a : 0.0f)));
}

// sign(y) * floor(|y| + 0.5), then int16: round_half_away for every float,
// NaN and infinities included
__device__ __forceinline__ short round_away(float y) {
    return static_cast<short>(static_cast<int>(copysignf(floorf(add(fabsf(y), 0.5f)), y)));
}

// x / q for q an integer in 1..255, rq = __fdiv_rn(1, q): the rounded
// quotient x * rq, corrected twice by its exact residual. Rounded by
// round_away, it gives __fdiv_rn's coefficient for every finite x
// (mxu_dct.cu's div_check_kernel); non-finite x give x * rq, which is x / q
// there.
__device__ __forceinline__ float div_by_int(float x, float q, float rq) {
    const float y0 = mul(x, rq);
    const float y1 = fmadd(fmadd(-q, y0, x), rq, y0);
    const float y2 = fmadd(fmadd(-q, y1, x), rq, y1);
    return fabsf(y0) < INFINITY ? y2 : y0;
}

}  // namespace dmmt
