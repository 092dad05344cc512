// Matmul DCT + quantize of one float32 plane (DMMT_P1=mxu, and the SIMPLE
// and SEPARATED DCT variants) on Hopper.
//
// Replaces: dmmt_jpeg_encoder_tpu/ops/mxu_dct.py : plane_dct_quant_mxu (the
// Pallas kernel that multiplies 128-row tiles by block-diagonal kron(I16, C)
// matrices on the MXU). What it computes: on every 8x8 group X of an [H, W]
// plane, C X C^T, then / q[v][u] and round half away from zero, into an
// int16 plane of the same layout. The JAX reference's bits are those of
// XLA's CPU backend; contract8 (dct8.cuh) reproduces its summation order,
// column pass (over y) first. No tensor cores: TF32 would change the bits.
//
// Bound on the H100: 6 bytes per element (4 in, 2 out) against 32
// operations per element (two 8-term contractions, an fma counting two),
// so it is bandwidth-bound. Design: one CTA per tile of 8 rows x 128
// columns, read once into shared memory, both passes and the quantizer in
// shared memory (dct8.cuh matmul_dct_quant_tile), C and q in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dct8.cuh"

namespace {

using namespace dmmt;

constexpr int TILE_W = 128;
constexpr int LD = TILE_W + 1;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) plane_dct_mm_kernel(
    const float* __restrict__ plane, int height, int width, int tiles_x,
    const float* __restrict__ c, const float* __restrict__ q, short* __restrict__ out) {
    __shared__ float s_c[64];
    __shared__ float s_q[64];
    __shared__ float s[8 * LD];
    const int tid = threadIdx.x;
    for (int i = tid; i < 64; i += THREADS) {
        s_c[i] = c[i];
        s_q[i] = q[i];
    }
    const int row0 = (blockIdx.x / tiles_x) * 8, col0 = (blockIdx.x % tiles_x) * TILE_W;
    const int valid = min(TILE_W, width - col0);
    for (int i = tid; i < 8 * TILE_W; i += THREADS) {
        const int r = i / TILE_W, col = i % TILE_W;
        s[r * LD + col] = col < valid ? plane[static_cast<size_t>(row0 + r) * width + col0 + col] : 0.0f;
    }
    __syncthreads();
    matmul_dct_quant_tile(s, 8, TILE_W, LD, s_c, s_q, out + static_cast<size_t>(row0) * width + col0,
                          width, valid);
}

}  // namespace

// plane: float32 [height, width], both multiples of 8. c: float32 [8, 8]
// DCT-II matrix (ops/dct.dct_matrix). q: float32 [64] raster.
// out: int16 [height, width].
extern "C" int dmmt_plane_dct_mm(const float* plane, int height, int width, const float* c,
                                 const float* q, short* out, void* stream) {
    if (height % 8 || width % 8 || height <= 0 || width <= 0) return cudaErrorInvalidValue;
    const int tiles_x = (width + TILE_W - 1) / TILE_W;
    plane_dct_mm_kernel<<<tiles_x * (height / 8), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        plane, height, width, tiles_x, c, q, out);
    return static_cast<int>(cudaGetLastError());
}
