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
// built with --fmad=false so nvcc contracts nothing on its own. Two
// operations are written otherwise with the same result: 8-bit samples are
// normalized by a 256-entry table of __fdiv_rn(v, maxval) (the same
// division, made once per CTA), and the subsample's / 4 and / 2 are
// __fmul_rn by 0.25 and 0.5 (both round the same real number). All
// constants arrive as float32 values computed by the torch package, not
// retyped here. The Arai pass and the rounding live in dct8.cuh, shared
// with the plane DCT kernel (plane_dct.cu).
//
// Bound on the H100: 3 bytes in (6 for 16-bit samples) and 3 bytes of
// int16 out per pixel at P420 against ~40 operations per pixel, so bytes:
// 24.9 MB each way at 4K, 0.0149 ms at 3.35 TB/s. Design: one CTA of 128
// threads owns a strip of 2048 pixels along an MCU row, loaded as 16-byte
// chunks into shared memory (strip.cuh, shared with the fused matmul phase
// 1: any width, any alignment). Each thread then converts 16 pixels, one
// subsample unit (a 2x2 quad, a pair or a pixel) at a time, so the
// full-resolution chroma stays in registers; luma and the subsampled
// chroma go to shared 8 x 8 blocks with a row pitch of 9 floats, which
// makes the row pass (a thread per block row) and the column pass (a
// thread per block column, its eight values in registers) free of bank
// conflicts; every thread has 3, 4 or 6 rows and columns. The column pass
// quantizes into a shared int16 staging copy of the strip's blocks in
// zigzag order, and the CTA writes
// it with 16-byte stores: a strip's MCUs are consecutive, so its luma
// blocks, its Cb blocks and its Cr blocks are three contiguous ranges of
// the outputs. Padding is done in the integer domain: a sample past H or W
// reads as 0, and 0 / maxval is exactly 0.0, matching the reference's black
// padding of the normalized image.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dct8.cuh"
#include "strip.cuh"

namespace {

using namespace dmmt;

constexpr int THREADS = STRIP_THREADS;
constexpr int PITCH = BLOCK_PITCH;

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
    const T* __restrict__ rgb, int height, int width, int mcus_x, int strips_x,
    float maxval, const float* __restrict__ consts,
    const float* __restrict__ q_luma, const float* __restrict__ q_chroma,
    short* __restrict__ out_y, short* __restrict__ out_cb, short* __restrict__ out_cr) {
    using G = Strip<HR, VR, T>;
    constexpr int EB = static_cast<int>(sizeof(T));
    // raw rows, later the int16 blocks
    constexpr int IO_BYTES = (G::MH * G::RAW_PITCH > G::NB * 128) ? G::MH * G::RAW_PITCH : G::NB * 128;
    static_assert(IO_BYTES % 16 == 0, "16-byte rows");
    __shared__ float s_k[K_COUNT];
    __shared__ float s_q[2][64];
    __shared__ float s_lut[256];                               // 8-bit samples / maxval
    __shared__ int s_zz[64];                                   // kInvZigzag, read per lane
    __shared__ float s_blk[G::NB][8][PITCH];                   // luma blocks, then Cb, Cr
    __shared__ __align__(16) unsigned char s_io[IO_BYTES];

    const int tid = threadIdx.x;
    const int my = blockIdx.x / strips_x, sx = blockIdx.x % strips_x;
    const int row0 = my * G::MH, col0 = sx * G::SW;
    const int n_px = min(G::SW, width - col0);                 // pixels of the strip inside W

    // 1. the strip's rows into shared memory, 16 bytes at a time
    if (n_px > 0) load_strip_rows<G>(s_io, rgb, height, width, row0, col0, n_px);
    for (int i = tid; i < K_COUNT; i += THREADS) s_k[i] = consts[i];
    for (int i = tid; i < 64; i += THREADS) {
        s_q[0][i] = q_luma[i];
        s_q[1][i] = q_chroma[i];
        s_zz[i] = kInvZigzag[i];
    }
    if (EB == 1)
        for (int i = tid; i < 256; i += THREADS) s_lut[i] = __fdiv_rn(static_cast<float>(i), maxval);
    __syncthreads();
    const float* k = s_k;

    // 2. normalize, color-convert and subsample, one unit of HR x VR pixels
    //    at a time: luma to its block, the unit's chroma average to the
    //    subsampled blocks (scale by 255 fused into the adds,
    //    ops/geometry.subsample_scaled)
    const float sc = k[K_SCALE];
    constexpr int CW = G::SW / HR;   // subsampled chroma columns of the strip
#pragma unroll
    for (int uu = 0; uu < G::UNITS; ++uu) {
        const int u = tid + uu * THREADS, cy = u / CW, cx = u % CW;
        float cb[VR][HR], cr[VR][HR];
#pragma unroll
        for (int dy = 0; dy < VR; ++dy) {
            const int ly = cy * VR + dy;
            const unsigned char* raw = strip_row<G>(s_io, rgb, width, row0, col0, ly);
#pragma unroll
            for (int dx = 0; dx < HR; ++dx) {
                const int lx = cx * HR + dx;
                float px[3] = {0.0f, 0.0f, 0.0f};
                if (row0 + ly < height && lx < n_px) {
#pragma unroll
                    for (int ch = 0; ch < 3; ++ch) {
                        const T v = *reinterpret_cast<const T*>(raw + (lx * 3 + ch) * EB);
                        px[ch] = EB == 1 ? s_lut[v] : __fdiv_rn(static_cast<float>(v), maxval);
                    }
                }
                const float r = px[0], g = px[1], b = px[2];
                s_blk[(ly / 8) * G::NBX + lx / 8][ly % 8][lx % 8] =
                    mul(sub(fmadd(b, k[K_Y2], fmadd(r, k[K_Y0], mul(g, k[K_Y1]))), k[K_LEVEL_SHIFT]),
                        k[K_SCALE]);
                cb[dy][dx] = fmadd(b, k[K_CB2], fmadd(r, k[K_CB0], mul(g, k[K_CB1])));
                cr[dy][dx] = fmadd(b, k[K_CR2], fmadd(r, k[K_CR0], mul(g, k[K_CR1])));
            }
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const float(&src)[VR][HR] = c ? cr : cb;
            float v;
            if (HR == 1 && VR == 1) {
                v = mul(src[0][0], sc);
            } else if (VR == 1) {
                v = mul(fmadd(src[0][0], sc, mul(src[0][HR - 1], sc)), 0.5f);
            } else {
                v = mul(fmadd(src[VR - 1][HR - 1], sc,
                              fmadd(src[0][HR - 1], sc, fmadd(src[0][0], sc, mul(src[VR - 1][0], sc)))),
                        0.25f);
            }
            s_blk[G::NL + c * G::S + cx / 8][cy][cx % 8] = v;
        }
    }
    __syncthreads();

    // 3. row pass (along x), one thread per block row
#pragma unroll
    for (int ii = 0; ii < G::ITEMS; ++ii) {
        const int i = tid + ii * THREADS;
        arai8(&s_blk[i / 8][i % 8][0], 1, k);
    }
    __syncthreads();

    // 4. column pass (along y) in registers, quantize, zigzag into the int16
    //    staging copy: [S * LPM luma blocks in MCU order][S Cb][S Cr]
    short* s_out = reinterpret_cast<short*>(s_io);
#pragma unroll
    for (int ii = 0; ii < G::ITEMS; ++ii) {
        const int i = tid + ii * THREADS, blk = i / 8, u = i % 8;
        int out_blk = blk;
        if (blk < G::NL) {
            const int by = blk / G::NBX, bx = blk % G::NBX;
            out_blk = (bx / HR) * G::LPM + by * HR + bx % HR;
        }
        float col[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) col[v] = s_blk[blk][v][u];
        arai8(col, k);
        const float* q = s_q[blk < G::NL ? 0 : 1];
#pragma unroll
        for (int v = 0; v < 8; ++v)
            s_out[out_blk * 64 + s_zz[v * 8 + u]] = round_half_away(__fdiv_rn(col[v], q[v * 8 + u]));
    }
    __syncthreads();

    // 5. the strip's MCUs that exist, as three contiguous runs of 16-byte stores
    const int n_mcu = min(G::S, mcus_x - sx * G::S);
    const size_t mcu0 = static_cast<size_t>(my) * mcus_x + sx * G::S;
    const int4* src = reinterpret_cast<const int4*>(s_io);
    const int n_luma = n_mcu * G::LPM * 8, n_chroma = n_mcu * 8;   // int4s
    int4* dst_y = reinterpret_cast<int4*>(out_y + mcu0 * G::LPM * 64);
    int4* dst_cb = reinterpret_cast<int4*>(out_cb + mcu0 * 64);
    int4* dst_cr = reinterpret_cast<int4*>(out_cr + mcu0 * 64);
    for (int i = tid; i < n_luma + 2 * n_chroma; i += THREADS) {
        if (i < n_luma) {
            dst_y[i] = src[i];
        } else if (i < n_luma + n_chroma) {
            dst_cb[i - n_luma] = src[G::NL * 8 + i - n_luma];
        } else {
            dst_cr[i - n_luma - n_chroma] = src[(G::NL + G::S) * 8 + i - n_luma - n_chroma];
        }
    }
}

template <int HR, int VR, typename T>
cudaError_t launch(const void* rgb, int height, int width, float maxval, const float* consts,
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
    phase1_kernel<HR, VR, T><<<static_cast<unsigned>(grid), THREADS, 0, stream>>>(
        static_cast<const T*>(rgb), height, width, mcus_x, strips_x, maxval, consts, q_luma,
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
// unpadded, any alignment. consts: float32 [K_COUNT]. q_luma/q_chroma:
// float32 [64] raster. out_y: int16 [n_mcu * hr * vr, 64]; out_cb/out_cr:
// int16 [n_mcu, 64]; all three 16-byte aligned.
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
