// Phase 1 of the JPEG encode on Hopper: integer RGB -> int16 zigzag blocks.
//
// Replaces: dmmt_jpeg_encoder_tpu/ops/fused_arai.py : fused_arai_phase1
// (Pallas kernel _make_kernel), whose output is bit-identical to the JAX
// package's default `plane` phase 1. This kernel additionally folds in the
// zigzag reorder and the P420 quad entangle (pipeline.plane_to_zigzag_blocks),
// so it writes finished [N, 64] blocks: luma in MCU order, Cb/Cr in raster
// block order. DC DPCM stays a shifted subtract in torch afterwards.
//
// Per pixel: true f32 division by maxval -> YCbCr (reference expression
// order) -> Average subsample ((tl + bl) + tr) + br then / 4, or (l + r) / 2
// -> Arai 8-point DCT on rows, then columns (reference op order) -> / q ->
// round half away from zero -> int16. The float32 roundings are those of
// the JAX reference as XLA's CPU backend compiles it: XLA lets LLVM fuse a
// single-use product into the add that consumes it, so the reference rounds
// once at those points (the color sums, the chroma scale inside the
// subsample adds, and six of the Arai products; see ops/fma.py and the
// docstrings of ops/color.py, ops/geometry.py, ops/dct.py). This kernel
// calls __fmaf_rn exactly there and explicitly rounded __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn everywhere else, and the library is
// built with --fmad=false so nvcc contracts nothing on its own. All
// constants arrive as float32 values computed by the torch package, not
// retyped here. The Arai pass and the rounding live in dct8.cuh, shared
// with the plane DCT kernel (plane_dct.cu).
//
// Bound on the H100: about 5 bytes of device memory per pixel (3 B in,
// 2 B of int16 out for luma plus a quarter for each chroma plane) against
// ~150 flops per pixel, so it is bandwidth-bound. Design: one CTA owns
// MCUS_PER_CTA whole MCUs; pixels are read once, and every float32
// intermediate (color planes, subsampled chroma, both DCT passes) stays in
// shared memory. Padding is done in the integer domain: a read past H or W
// yields 0, and 0 / maxval is exactly 0.0, matching the reference's black
// padding of the normalized image.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dct8.cuh"

namespace {

using namespace dmmt;

constexpr int MCUS_PER_CTA = 4;
constexpr int THREADS = 128;

// raster index -> zigzag position (inverse of the ZIGZAG scan table)
__constant__ int kInvZigzag[64] = {
     0,  1,  5,  6, 14, 15, 27, 28,
     2,  4,  7, 13, 16, 26, 29, 42,
     3,  8, 12, 17, 25, 30, 41, 43,
     9, 11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54,
    20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61,
    35, 36, 48, 49, 57, 58, 62, 63,
};

template <int HR, int VR, typename T>
__global__ void __launch_bounds__(THREADS) phase1_kernel(
    const T* __restrict__ rgb, int height, int width, int mcus_x, int n_mcu,
    float maxval, const float* __restrict__ consts,
    const float* __restrict__ q_luma, const float* __restrict__ q_chroma,
    short* __restrict__ out_y, short* __restrict__ out_cb, short* __restrict__ out_cr) {
    constexpr int MW = 8 * HR, MH = 8 * VR, LPM = HR * VR, NB = LPM + 2;
    __shared__ float s_k[K_COUNT];
    __shared__ float s_q[2][64];
    __shared__ float s_y[MCUS_PER_CTA][MH][MW];
    __shared__ float s_chroma[MCUS_PER_CTA][2][MH][MW];   // full-resolution Cb, Cr before * 255
    __shared__ float s_sub[MCUS_PER_CTA][2][8][8];        // subsampled Cb, Cr blocks

    const int tid = threadIdx.x;
    for (int i = tid; i < K_COUNT; i += THREADS) s_k[i] = consts[i];
    for (int i = tid; i < 64; i += THREADS) {
        s_q[0][i] = q_luma[i];
        s_q[1][i] = q_chroma[i];
    }
    __syncthreads();
    const float* k = s_k;
    const int mcu0 = blockIdx.x * MCUS_PER_CTA;

    // 1. load, normalize, color-convert
    for (int i = tid; i < MCUS_PER_CTA * MH * MW; i += THREADS) {
        const int m = i / (MH * MW), ly = (i / MW) % MH, lx = i % MW;
        const int mcu = mcu0 + m;
        if (mcu >= n_mcu) continue;
        const int row = (mcu / mcus_x) * MH + ly, col = (mcu % mcus_x) * MW + lx;
        float r = 0.0f, g = 0.0f, b = 0.0f;
        if (row < height && col < width) {
            const T* px = rgb + (static_cast<size_t>(row) * width + col) * 3;
            r = __fdiv_rn(static_cast<float>(px[0]), maxval);
            g = __fdiv_rn(static_cast<float>(px[1]), maxval);
            b = __fdiv_rn(static_cast<float>(px[2]), maxval);
        }
        s_y[m][ly][lx] = mul(sub(fmadd(b, k[K_Y2], fmadd(r, k[K_Y0], mul(g, k[K_Y1]))),
                                 k[K_LEVEL_SHIFT]), k[K_SCALE]);
        s_chroma[m][0][ly][lx] = fmadd(b, k[K_CB2], fmadd(r, k[K_CB0], mul(g, k[K_CB1])));
        s_chroma[m][1][ly][lx] = fmadd(b, k[K_CR2], fmadd(r, k[K_CR0], mul(g, k[K_CR1])));
    }
    __syncthreads();

    // 2. chroma scale + subsample: ((tl + bl) + tr) + br / 4 or (l + r) / 2,
    //    with the scale by 255 fused into the adds (ops/geometry.subsample_scaled)
    const float sc = k[K_SCALE];
    for (int i = tid; i < MCUS_PER_CTA * 2 * 64; i += THREADS) {
        const int m = i / 128, c = (i / 64) % 2, cy = (i / 8) % 8, cx = i % 8;
        float(*src)[MW] = s_chroma[m][c];
        float v;
        if (HR == 1 && VR == 1) {
            v = mul(src[cy][cx], sc);
        } else if (VR == 1) {
            v = __fdiv_rn(fmadd(src[cy][2 * cx], sc, mul(src[cy][2 * cx + 1], sc)), 2.0f);
        } else {
            const int y0 = 2 * cy, x0 = 2 * cx;
            v = __fdiv_rn(fmadd(src[y0 + 1][x0 + 1], sc,
                              fmadd(src[y0][x0 + 1], sc, fmadd(src[y0][x0], sc, mul(src[y0 + 1][x0], sc)))),
                          4.0f);
        }
        s_sub[m][c][cy][cx] = v;
    }
    __syncthreads();

    // 3. row pass (along x), one thread per block row
    for (int i = tid; i < MCUS_PER_CTA * NB * 8; i += THREADS) {
        const int m = i / (NB * 8), blk = (i / 8) % NB, r = i % 8;
        float* row = blk < LPM ? &s_y[m][(blk / HR) * 8 + r][(blk % HR) * 8]
                               : &s_sub[m][blk - LPM][r][0];
        arai8(row, 1, k);
    }
    __syncthreads();

    // 4. column pass (along y), quantize, zigzag store; one thread per column
    for (int i = tid; i < MCUS_PER_CTA * NB * 8; i += THREADS) {
        const int m = i / (NB * 8), blk = (i / 8) % NB, u = i % 8;
        const int mcu = mcu0 + m;
        if (mcu >= n_mcu) continue;
        float* col;
        int step;
        short* out;
        if (blk < LPM) {
            col = &s_y[m][(blk / HR) * 8][(blk % HR) * 8 + u];
            step = MW;
            out = out_y + (static_cast<size_t>(mcu) * LPM + blk) * 64;
        } else {
            col = &s_sub[m][blk - LPM][0][u];
            step = 8;
            out = (blk == LPM ? out_cb : out_cr) + static_cast<size_t>(mcu) * 64;
        }
        arai8(col, step, k);
        const float* q = s_q[blk < LPM ? 0 : 1];
        for (int v = 0; v < 8; ++v) {
            out[kInvZigzag[v * 8 + u]] = round_half_away(__fdiv_rn(col[v * step], q[v * 8 + u]));
        }
    }
}

template <int HR, int VR, typename T>
cudaError_t launch(const void* rgb, int height, int width, float maxval, const float* consts,
                   const float* q_luma, const float* q_chroma, short* out_y, short* out_cb,
                   short* out_cr, cudaStream_t stream) {
    const int mcus_x = (width + 8 * HR - 1) / (8 * HR);
    const int mcus_y = (height + 8 * VR - 1) / (8 * VR);
    const int n_mcu = mcus_x * mcus_y;
    const int grid = (n_mcu + MCUS_PER_CTA - 1) / MCUS_PER_CTA;
    phase1_kernel<HR, VR, T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(rgb), height, width, mcus_x, n_mcu, maxval, consts, q_luma,
        q_chroma, out_y, out_cb, out_cr);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rates(int hr, int vr, const void* rgb, int height, int width, float maxval,
                           const float* consts, const float* q_luma, const float* q_chroma,
                           short* out_y, short* out_cb, short* out_cr, cudaStream_t stream) {
    if (hr == 2 && vr == 2)
        return launch<2, 2, T>(rgb, height, width, maxval, consts, q_luma, q_chroma, out_y,
                               out_cb, out_cr, stream);
    if (hr == 2 && vr == 1)
        return launch<2, 1, T>(rgb, height, width, maxval, consts, q_luma, q_chroma, out_y,
                               out_cb, out_cr, stream);
    if (hr == 1 && vr == 1)
        return launch<1, 1, T>(rgb, height, width, maxval, consts, q_luma, q_chroma, out_y,
                               out_cb, out_cr, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// rgb: [height, width, 3] uint8 (elem_bytes 1) or uint16 (elem_bytes 2),
// unpadded. consts: float32 [K_COUNT]. q_luma/q_chroma: float32 [64] raster.
// out_y: int16 [n_mcu * hr * vr, 64]; out_cb/out_cr: int16 [n_mcu, 64].
extern "C" int dmmt_phase1(const void* rgb, int elem_bytes, int height, int width, int hr,
                           int vr, float maxval, const float* consts, const float* q_luma,
                           const float* q_chroma, short* out_y, short* out_cb, short* out_cr,
                           void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (elem_bytes == 1)
        err = dispatch_rates<uint8_t>(hr, vr, rgb, height, width, maxval, consts, q_luma,
                                      q_chroma, out_y, out_cb, out_cr, s);
    else if (elem_bytes == 2)
        err = dispatch_rates<uint16_t>(hr, vr, rgb, height, width, maxval, consts, q_luma,
                                       q_chroma, out_y, out_cb, out_cr, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
