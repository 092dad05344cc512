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
//   C X C^T per 8x8 group         contract8, column pass first (dct8.cuh)
//   / q, round half away from zero, int16
//
// into a luma plane [PH, PW] and Cb/Cr planes [PH / v, PW / h] of the image
// padded black to its MCU multiple. Padding is done in the integer domain:
// a read past H or W yields 0, and 0 * (1 / maxval) is exactly 0.0.
//
// Bound on the H100: 3 or 6 bytes of pixels in and 2 + 4 / (h v) bytes of
// coefficients out per pixel, against ~100 operations per pixel, so it is
// bandwidth-bound. Design: one CTA per tile of one MCU row height (8 v rows)
// x 128 columns; pixels are read once, and the color planes, the
// subsampled chroma and both DCT passes stay in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dct8.cuh"

namespace {

using namespace dmmt;

constexpr int TILE_W = 128;
constexpr int THREADS = 128;

template <int HR, int VR, typename T>
__global__ void __launch_bounds__(THREADS) phase1_mm_kernel(
    const T* __restrict__ rgb, int height, int width, int padded_w, int tiles_x, float maxval,
    const float* __restrict__ consts, const float* __restrict__ c,
    const float* __restrict__ q_luma, const float* __restrict__ q_chroma,
    short* __restrict__ out_y, short* __restrict__ out_cb, short* __restrict__ out_cr) {
    constexpr int MH = 8 * VR, LD = TILE_W + 1, CW = TILE_W / HR, CLD = CW + 1;
    __shared__ float s_k[K_COUNT];
    __shared__ float s_c[64];
    __shared__ float s_q[2][64];
    __shared__ float s_y[MH * LD];
    __shared__ float s_sum[2][MH][TILE_W];   // Cb, Cr color sums before * 255
    __shared__ float s_sub[2][8 * CLD];      // subsampled Cb, Cr

    const int tid = threadIdx.x;
    for (int i = tid; i < K_COUNT; i += THREADS) s_k[i] = consts[i];
    for (int i = tid; i < 64; i += THREADS) {
        s_c[i] = c[i];
        s_q[0][i] = q_luma[i];
        s_q[1][i] = q_chroma[i];
    }
    __syncthreads();
    const float* k = s_k;
    const float inv = __fdiv_rn(1.0f, maxval);
    const int row0 = (blockIdx.x / tiles_x) * MH, col0 = (blockIdx.x % tiles_x) * TILE_W;
    const int valid = min(TILE_W, padded_w - col0);

    // 1. load, normalize, color-convert
    for (int i = tid; i < MH * TILE_W; i += THREADS) {
        const int ly = i / TILE_W, lx = i % TILE_W;
        const int row = row0 + ly, col = col0 + lx;
        float r = 0.0f, g = 0.0f, b = 0.0f;
        if (row < height && col < width) {
            const T* px = rgb + (static_cast<size_t>(row) * width + col) * 3;
            r = mul(static_cast<float>(px[0]), inv);
            g = mul(static_cast<float>(px[1]), inv);
            b = mul(static_cast<float>(px[2]), inv);
        }
        s_y[ly * LD + lx] = mul(sub(fmadd(b, k[K_Y2], fmadd(r, k[K_Y0], mul(g, k[K_Y1]))),
                                    k[K_LEVEL_SHIFT]), k[K_SCALE]);
        s_sum[0][ly][lx] = fmadd(b, k[K_CB2], fmadd(r, k[K_CB0], mul(g, k[K_CB1])));
        s_sum[1][ly][lx] = fmadd(b, k[K_CR2], fmadd(r, k[K_CR0], mul(g, k[K_CR1])));
    }
    __syncthreads();

    // 2. chroma scale + pair-sum subsample (vertical pairs, then horizontal)
    const float sc = k[K_SCALE];
    for (int i = tid; i < 2 * 8 * CW; i += THREADS) {
        const int ch = i / (8 * CW), cy = (i / CW) % 8, cx = i % CW;
        float(*src)[TILE_W] = s_sum[ch];
        float v;
        if (HR == 1 && VR == 1) {
            v = mul(src[cy][cx], sc);
        } else if (VR == 1) {
            v = mul(fmadd(src[cy][2 * cx], sc, mul(src[cy][2 * cx + 1], sc)), 0.5f);
        } else {
            const int y0 = 2 * cy, x0 = 2 * cx;
            const float left = fmadd(src[y0][x0], sc, mul(src[y0 + 1][x0], sc));
            const float right = fmadd(src[y0][x0 + 1], sc, mul(src[y0 + 1][x0 + 1], sc));
            v = mul(add(left, right), 0.25f);
        }
        s_sub[ch][cy * CLD + cx] = v;
    }
    __syncthreads();

    // 3. matmul DCT, quantize, store
    matmul_dct_quant_tile(s_y, MH, TILE_W, LD, s_c, s_q[0],
                          out_y + static_cast<size_t>(row0) * padded_w + col0, padded_w, valid);
    const int cw_plane = padded_w / HR;
    const size_t c_off = static_cast<size_t>(row0 / VR) * cw_plane + col0 / HR;
    matmul_dct_quant_tile(s_sub[0], 8, CW, CLD, s_c, s_q[1], out_cb + c_off, cw_plane, valid / HR);
    matmul_dct_quant_tile(s_sub[1], 8, CW, CLD, s_c, s_q[1], out_cr + c_off, cw_plane, valid / HR);
}

template <int HR, int VR, typename T>
cudaError_t launch(const void* rgb, int height, int width, float maxval, const float* consts,
                   const float* c, const float* q_luma, const float* q_chroma, short* out_y,
                   short* out_cb, short* out_cr, cudaStream_t stream) {
    const int padded_w = (width + 8 * HR - 1) / (8 * HR) * (8 * HR);
    const int padded_h = (height + 8 * VR - 1) / (8 * VR) * (8 * VR);
    const int tiles_x = (padded_w + TILE_W - 1) / TILE_W;
    phase1_mm_kernel<HR, VR, T><<<tiles_x * (padded_h / (8 * VR)), THREADS, 0, stream>>>(
        static_cast<const T*>(rgb), height, width, padded_w, tiles_x, maxval, consts, c, q_luma,
        q_chroma, out_y, out_cb, out_cr);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rates(int hr, int vr, const void* rgb, int height, int width, float maxval,
                           const float* consts, const float* c, const float* q_luma,
                           const float* q_chroma, short* out_y, short* out_cb, short* out_cr,
                           cudaStream_t stream) {
    if (hr == 2 && vr == 2)
        return launch<2, 2, T>(rgb, height, width, maxval, consts, c, q_luma, q_chroma, out_y,
                               out_cb, out_cr, stream);
    if (hr == 2 && vr == 1)
        return launch<2, 1, T>(rgb, height, width, maxval, consts, c, q_luma, q_chroma, out_y,
                               out_cb, out_cr, stream);
    if (hr == 1 && vr == 1)
        return launch<1, 1, T>(rgb, height, width, maxval, consts, c, q_luma, q_chroma, out_y,
                               out_cb, out_cr, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// rgb: [height, width, 3] uint8 (elem_bytes 1) or uint16 (elem_bytes 2),
// unpadded. consts: float32 [K_COUNT]. c: float32 [8, 8] DCT-II matrix.
// q_luma/q_chroma: float32 [64] raster. out_y: int16 [PH, PW];
// out_cb/out_cr: int16 [PH / vr, PW / hr] (PH, PW: the MCU-padded size).
extern "C" int dmmt_phase1_mm(const void* rgb, int elem_bytes, int height, int width, int hr,
                              int vr, float maxval, const float* consts, const float* c,
                              const float* q_luma, const float* q_chroma, short* out_y,
                              short* out_cb, short* out_cr, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (elem_bytes == 1)
        err = dispatch_rates<uint8_t>(hr, vr, rgb, height, width, maxval, consts, c, q_luma,
                                      q_chroma, out_y, out_cb, out_cr, s);
    else if (elem_bytes == 2)
        err = dispatch_rates<uint16_t>(hr, vr, rgb, height, width, maxval, consts, c, q_luma,
                                       q_chroma, out_y, out_cb, out_cr, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
