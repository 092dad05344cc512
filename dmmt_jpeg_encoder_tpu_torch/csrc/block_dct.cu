// DCT x zigzag x quantize of 8x8 blocks as one [N, 64] @ M[64, 64] product
// (DCTVariant.FUSED) on Hopper.
//
// Replaces: dmmt_jpeg_encoder_tpu/ops/fused.py : fused_dct_quantize_zigzag
// (the Pallas kernel that multiplies 512-block tiles by the resident 64x64
// matrix on the MXU). What it computes: out[n, j] = round(sum_i x[n, i] *
// M[i, j]) to int16, half away from zero, where M folds the 2-D DCT, the
// zigzag permutation and 1 / q (built on the host by ops/fused.fused_matrix,
// exactly as the JAX package builds it). The JAX reference's product is
// XLA's CPU dot, which sums each output as one sequential fma chain over
// i = 0..63, the first term a plain product; this kernel computes that chain.
// No tensor cores: TF32 would change the bits.
//
// Bound on the H100: 64 fmas (128 operations) per output against 6 bytes
// (4 in, 2 out) per output, so it is operation-bound (~0.024 ms at 4K).
// Design: one CTA per tile of 32 blocks; the tile and M sit in shared
// memory (8 KB + 16 KB); each thread owns one output column j and walks
// every other block of the tile, so a warp reads one broadcast x value and
// 32 consecutive M values per step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dct8.cuh"

namespace {

using namespace dmmt;

constexpr int TILE_N = 32;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) block_dct_zz_kernel(
    const float* __restrict__ blocks, long long n, const float* __restrict__ m,
    short* __restrict__ out) {
    __shared__ float s_m[64 * 64];
    __shared__ float s_x[TILE_N * 64];
    const int tid = threadIdx.x;
    const long long n0 = static_cast<long long>(blockIdx.x) * TILE_N;
    const int rows = static_cast<int>(min(static_cast<long long>(TILE_N), n - n0));
    for (int i = tid; i < 64 * 64; i += THREADS) s_m[i] = m[i];
    for (int i = tid; i < rows * 64; i += THREADS) s_x[i] = blocks[n0 * 64 + i];
    __syncthreads();
    const int j = tid % 64;
    for (int r = tid / 64; r < rows; r += THREADS / 64) {
        const float* x = s_x + r * 64;
        float acc = mul(x[0], s_m[j]);
        for (int i = 1; i < 64; ++i) acc = fmadd(x[i], s_m[i * 64 + j], acc);
        out[(n0 + r) * 64 + j] = round_half_away(acc);
    }
}

}  // namespace

// blocks: float32 [n, 64] (row-major 8x8 blocks). m: float32 [64, 64].
// out: int16 [n, 64] zigzag.
extern "C" int dmmt_block_dct_zz(const float* blocks, long long n, const float* m, short* out,
                                 void* stream) {
    if (n <= 0) return n == 0 ? 0 : cudaErrorInvalidValue;
    const long long grid = (n + TILE_N - 1) / TILE_N;
    block_dct_zz_kernel<<<static_cast<unsigned>(grid), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        blocks, n, m, out);
    return static_cast<int>(cudaGetLastError());
}
