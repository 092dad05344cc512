// Fused phase 1 with the matmul DCT (DMMT_P1=fused1) on Hopper: integer
// RGB -> int16 quantized coefficient planes in one launch.
//
// Replaces: dmmt_jpeg_encoder_tpu/ops/fused_phase1.py : fused_phase1 (the
// Pallas kernel that runs normalize, color, subsample and a kron(I, C) MXU
// DCT on 128-row tiles). What it computes, per pixel, as the JAX reference
// (fused_phase1_reference) does under XLA's CPU backend:
//
//   x * (1 / maxval)              one float32 divide, then a multiply
//   color sums                    fma(b, w2, fma(r, w0, g * w1)), as phase 1
//   luma                          (sum - 128/255) * 255
//   chroma subsample              P420 (fma(tl, 255, bl * 255)
//                                       + fma(tr, 255, br * 255)) * 0.25
//                                 P422 fma(l, 255, r * 255) * 0.5
//                                 P444 sum * 255
//   C X C^T per 8x8 group         contract8 (dct8.cuh), column pass first
//   / q, round half away from zero, int16
//
// into a luma plane [PH, PW] and Cb/Cr planes [PH / v, PW / h] of the image
// padded black to its MCU multiple. Padding is done in the integer domain:
// a sample past H or W reads as 0, and 0 * (1 / maxval) is exactly 0.0.
//
// Bound on the H100: 3 bytes in (6 for 16-bit samples) and 3 bytes of
// int16 out per pixel at P420 (24.9 MB each way at 4K, 0.0149 ms at 3.35
// TB/s), against ~70 operations per pixel, mostly the two 8-term
// contractions per coefficient and the quantizing division, so the float32
// pipes come close behind the bytes. Design, the phase-1 kernel's
// (phase1.cu) with the matmul DCT:
// - one CTA of 128 threads owns a 2048-pixel strip along an MCU row, loaded
//   as 16-byte chunks into shared memory (strip.cuh: any width, any
//   alignment);
// - each thread converts one subsample unit (a 2x2 quad, a pair or a
//   pixel) at a time, so the full-resolution chroma stays in registers;
//   luma and the subsampled chroma go to shared 8 x 8 blocks with a row
//   pitch of 9 floats, so that both passes are free of bank conflicts;
// - the column pass (a thread per block column) and then the row pass (a
//   thread per block row) each hold their eight values in registers and
//   sum in contract8's order; the color constants and the DCT matrix come
//   as the launch's parameters, so the contractions read them as
//   constant-bank operands, with no loads;
// - the row pass divides by the thread's row of the quantization tables
//   (held in registers: a thread keeps one row v), rounds, and writes the
//   block row's 8 coefficients to the plane with one 16-byte store.
// Every rounding is the reference's: __fmul_rn / __fadd_rn / __fsub_rn
// and __fmaf_rn exactly where XLA fuses, one reciprocal of maxval by
// __fdiv_rn, the quantizing division by __fdiv_rn; / 4 and / 2 are exact
// multiplies by 0.25 and 0.5.
//
// DMMT_P1_PREC=high (ops/mxu_dct.dot_p1) is a template arm on the type of
// the constants parameter: SplitConsts holds C's bf16 halves, rounded on
// the host (ops/mxu_dct.DCT_SPLIT), and both passes split their eight
// values (dct8.cuh split8) and sum each output as three chains in the pair
// order of XLA's CPU bf16 dot (contract8_split), on the luma and the
// subsampled chroma blocks alike. No tensor cores: the order of their bf16
// sums is not specified. The color math, the pair sums, the division and
// the rounding are the other arm's; the split arm does about three times
// its DCT arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "dct8.cuh"
#include "strip.cuh"

namespace {

using namespace dmmt;

// The color constants (ops/fused_arai.kernel_constants) and the DCT matrix
// C [8][8] (row k = frequency), passed by value.
struct Consts {
    static constexpr bool SPLIT = false;
    float k[K_COUNT];
    float c[64];
};

// The same with C's bf16 halves (DMMT_P1_PREC=high).
struct SplitConsts {
    static constexpr bool SPLIT = true;
    float k[K_COUNT];
    float hi[64];
    float lo[64];
};

__device__ __forceinline__ unsigned pack2(short lo, short hi) {
    return static_cast<unsigned short>(lo) | (static_cast<unsigned>(static_cast<unsigned short>(hi)) << 16);
}

template <int HR, int VR, typename T, typename P>
__global__ void __launch_bounds__(STRIP_THREADS) phase1_mm_kernel(
    const T* __restrict__ rgb, int height, int width, int padded_w, int strips_x, float maxval,
    const __grid_constant__ P p, const float* __restrict__ q_luma,
    const float* __restrict__ q_chroma, short* __restrict__ out_y, short* __restrict__ out_cb,
    short* __restrict__ out_cr) {
    using G = Strip<HR, VR, T>;
    constexpr int EB = static_cast<int>(sizeof(T));
    constexpr int CW = G::SW / HR;   // subsampled chroma columns of the strip
    __shared__ float s_blk[G::NB][8][BLOCK_PITCH];                  // luma blocks, then Cb, Cr
    __shared__ __align__(16) unsigned char s_raw[G::MH * G::RAW_PITCH];

    const int tid = threadIdx.x;
    const int my = blockIdx.x / strips_x, sx = blockIdx.x % strips_x;
    const int row0 = my * G::MH, col0 = sx * G::SW;
    const int n_px = min(G::SW, width - col0);                 // pixels of the strip inside W

    // 1. the strip's rows into shared memory; the thread's row v of both
    //    quantization tables into registers (row i % 8 of every block row
    //    it takes in the row pass: i = tid + a multiple of 128)
    if (n_px > 0) load_strip_rows<G>(s_raw, rgb, height, width, row0, col0, n_px);
    const int v = tid % 8;
    float ql[8], qc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
        ql[u] = __ldg(q_luma + v * 8 + u);
        qc[u] = __ldg(q_chroma + v * 8 + u);
    }
    const float inv = __fdiv_rn(1.0f, maxval);
    __syncthreads();

    // 2. normalize, color-convert and subsample, one unit of HR x VR pixels
    //    at a time: luma to its block, the unit's chroma pair sum to the
    //    subsampled blocks
    const float sc = p.k[K_SCALE];
#pragma unroll
    for (int uu = 0; uu < G::UNITS; ++uu) {
        const int un = tid + uu * STRIP_THREADS, cy = un / CW, cx = un % CW;
        float cb[VR][HR], cr[VR][HR];
#pragma unroll
        for (int dy = 0; dy < VR; ++dy) {
            const int ly = cy * VR + dy;
            const unsigned char* raw = strip_row<G>(s_raw, rgb, width, row0, col0, ly);
#pragma unroll
            for (int dx = 0; dx < HR; ++dx) {
                const int lx = cx * HR + dx;
                float px[3] = {0.0f, 0.0f, 0.0f};
                if (row0 + ly < height && lx < n_px) {
#pragma unroll
                    for (int ch = 0; ch < 3; ++ch)
                        px[ch] = mul(static_cast<float>(*reinterpret_cast<const T*>(raw + (lx * 3 + ch) * EB)),
                                     inv);
                }
                const float r = px[0], g = px[1], b = px[2];
                s_blk[(ly / 8) * G::NBX + lx / 8][ly % 8][lx % 8] =
                    mul(sub(fmadd(b, p.k[K_Y2], fmadd(r, p.k[K_Y0], mul(g, p.k[K_Y1]))),
                            p.k[K_LEVEL_SHIFT]),
                        p.k[K_SCALE]);
                cb[dy][dx] = fmadd(b, p.k[K_CB2], fmadd(r, p.k[K_CB0], mul(g, p.k[K_CB1])));
                cr[dy][dx] = fmadd(b, p.k[K_CR2], fmadd(r, p.k[K_CR0], mul(g, p.k[K_CR1])));
            }
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const float(&src)[VR][HR] = c ? cr : cb;
            float s;
            if (HR == 1 && VR == 1) {
                s = mul(src[0][0], sc);
            } else if (VR == 1) {
                s = mul(fmadd(src[0][0], sc, mul(src[0][HR - 1], sc)), 0.5f);
            } else {
                const float left = fmadd(src[0][0], sc, mul(src[VR - 1][0], sc));
                const float right = fmadd(src[0][HR - 1], sc, mul(src[VR - 1][HR - 1], sc));
                s = mul(add(left, right), 0.25f);
            }
            s_blk[G::NL + c * G::S + cx / 8][cy][cx % 8] = s;
        }
    }
    __syncthreads();

    // 3. column pass (along y) in registers, one thread per block column
#pragma unroll
    for (int ii = 0; ii < G::ITEMS; ++ii) {
        const int i = tid + ii * STRIP_THREADS, blk = i / 8, u = i % 8;
        float x[8];
#pragma unroll
        for (int y = 0; y < 8; ++y) x[y] = s_blk[blk][y][u];
        Split8 split;
        if constexpr (P::SPLIT) split = split8(x);
#pragma unroll
        for (int k = 0; k < 8; ++k) s_blk[blk][k][u] = contract_row(x, split, p, k);
    }
    __syncthreads();

    // 4. row pass (along x) in registers, / q, round, one thread per block
    //    row v; the row's 8 coefficients go to the plane in one store
    const int cw_plane = padded_w / HR;
#pragma unroll
    for (int ii = 0; ii < G::ITEMS; ++ii) {
        const int blk = (tid + ii * STRIP_THREADS) / 8;
        const bool luma = blk < G::NL;
        int col;
        short* dst;
        if (luma) {
            col = col0 + (blk % G::NBX) * 8;
            dst = out_y + static_cast<size_t>(row0 + (blk / G::NBX) * 8 + v) * padded_w + col;
        } else {
            const int c = (blk - G::NL) / G::S;
            col = col0 / HR + ((blk - G::NL) % G::S) * 8;
            dst = (c ? out_cr : out_cb) + static_cast<size_t>(my * 8 + v) * cw_plane + col;
        }
        if (col >= (luma ? padded_w : cw_plane)) continue;   // past the plane's padded width
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = s_blk[blk][v][u];
        Split8 split;
        if constexpr (P::SPLIT) split = split8(x);
        unsigned w[4];
#pragma unroll
        for (int u = 0; u < 8; u += 2) {
            const short lo =
                round_half_away(__fdiv_rn(contract_row(x, split, p, u), luma ? ql[u] : qc[u]));
            const short hi =
                round_half_away(__fdiv_rn(contract_row(x, split, p, u + 1), luma ? ql[u + 1] : qc[u + 1]));
            w[u / 2] = pack2(lo, hi);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
}

template <int HR, int VR, typename T, typename P>
cudaError_t launch(const void* rgb, int height, int width, float maxval, const P& p,
                   const float* q_luma, const float* q_chroma, short* out_y, short* out_cb,
                   short* out_cr, cudaStream_t stream) {
    using G = Strip<HR, VR, T>;
    if ((reinterpret_cast<uintptr_t>(out_y) | reinterpret_cast<uintptr_t>(out_cb) |
         reinterpret_cast<uintptr_t>(out_cr)) & 15)
        return cudaErrorMisalignedAddress;
    const int mcus_x = (width + G::MW - 1) / G::MW;
    const int mcus_y = (height + G::MH - 1) / G::MH;
    const int strips_x = (mcus_x + G::S - 1) / G::S;
    const long long grid = static_cast<long long>(strips_x) * mcus_y;
    if (grid < 1 || grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    phase1_mm_kernel<HR, VR, T, P><<<static_cast<unsigned>(grid), STRIP_THREADS, 0, stream>>>(
        static_cast<const T*>(rgb), height, width, mcus_x * G::MW, strips_x, maxval, p, q_luma,
        q_chroma, out_y, out_cb, out_cr);
    return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch_rates(int hr, int vr, const void* rgb, int height, int width, float maxval,
                           const P& p, const float* q_luma, const float* q_chroma,
                           short* out_y, short* out_cb, short* out_cr, cudaStream_t stream) {
    if (hr == 2 && vr == 2)
        return launch<2, 2, T>(rgb, height, width, maxval, p, q_luma, q_chroma, out_y, out_cb,
                               out_cr, stream);
    if (hr == 2 && vr == 1)
        return launch<2, 1, T>(rgb, height, width, maxval, p, q_luma, q_chroma, out_y, out_cb,
                               out_cr, stream);
    if (hr == 1 && vr == 1)
        return launch<1, 1, T>(rgb, height, width, maxval, p, q_luma, q_chroma, out_y, out_cb,
                               out_cr, stream);
    return cudaErrorInvalidValue;
}

// the element type's arm of dispatch_rates
template <typename P>
int dispatch(const void* rgb, int elem_bytes, int height, int width, int hr, int vr, float maxval,
             const P& p, const float* q_luma, const float* q_chroma, short* out_y, short* out_cb,
             short* out_cr, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (elem_bytes == 1)
        err = dispatch_rates<uint8_t>(hr, vr, rgb, height, width, maxval, p, q_luma, q_chroma,
                                      out_y, out_cb, out_cr, s);
    else if (elem_bytes == 2)
        err = dispatch_rates<uint16_t>(hr, vr, rgb, height, width, maxval, p, q_luma, q_chroma,
                                       out_y, out_cb, out_cr, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rgb: [height, width, 3] uint8 (elem_bytes 1) or uint16 (elem_bytes 2),
// unpadded, any alignment. consts_host: float32 [K_COUNT] and c_host:
// float32 [8, 8] DCT-II matrix, both in host memory (copied into the
// launch's parameters before this returns). q_luma/q_chroma: float32 [64]
// raster, in device memory. out_y: int16 [PH, PW]; out_cb/out_cr: int16
// [PH / vr, PW / hr] (PH, PW: the MCU-padded size); all three 16-byte
// aligned.
extern "C" int dmmt_phase1_mm(const void* rgb, int elem_bytes, int height, int width, int hr,
                              int vr, float maxval, const float* consts_host, const float* c_host,
                              const float* q_luma, const float* q_chroma, short* out_y,
                              short* out_cb, short* out_cr, void* stream) {
    if (!consts_host || !c_host) return static_cast<int>(cudaErrorInvalidValue);
    Consts p;
    memcpy(p.k, consts_host, sizeof(p.k));
    memcpy(p.c, c_host, sizeof(p.c));
    return dispatch(rgb, elem_bytes, height, width, hr, vr, maxval, p, q_luma, q_chroma, out_y,
                    out_cb, out_cr, stream);
}

// The same with DMMT_P1_PREC=high's split contractions: c_hi_host and
// c_lo_host, float32 [8, 8] in host memory, are C's bf16 halves
// (ops/mxu_dct.DCT_SPLIT).
extern "C" int dmmt_phase1_mm_split(const void* rgb, int elem_bytes, int height, int width, int hr,
                                    int vr, float maxval, const float* consts_host,
                                    const float* c_hi_host, const float* c_lo_host,
                                    const float* q_luma, const float* q_chroma, short* out_y,
                                    short* out_cb, short* out_cr, void* stream) {
    if (!consts_host || !c_hi_host || !c_lo_host) return static_cast<int>(cudaErrorInvalidValue);
    SplitConsts p;
    memcpy(p.k, consts_host, sizeof(p.k));
    memcpy(p.hi, c_hi_host, sizeof(p.hi));
    memcpy(p.lo, c_lo_host, sizeof(p.lo));
    return dispatch(rgb, elem_bytes, height, width, hr, vr, maxval, p, q_luma, q_chroma, out_y,
                    out_cb, out_cr, stream);
}
