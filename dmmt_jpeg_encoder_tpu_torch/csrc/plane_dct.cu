// Arai DCT + quantize of one float32 plane (DMMT_P1=pallas) on Hopper.
//
// Replaces: dmmt_jpeg_encoder_tpu/ops/pallas_dct.py : plane_dct_quant (the
// Pallas kernel that runs the Arai chain on dense phase rolls of a plane).
// What it computes is the default `plane` phase 1's DCT stage
// (pipeline.plane_dct_quant): on every 8x8 group of an [H, W] plane, the
// Arai pass along x (rows), then along y (columns), then / q[v][u] and round
// half away from zero, into an int16 plane of the same layout. Its bits
// equal the plane path's: the same arai8 (dct8.cuh) as the phase-1 kernel.
//
// Bound on the H100: 6 bytes per element (4 in, 2 out) against ~13
// operations per element, so it is bandwidth-bound. Design: one CTA per
// tile of 8 rows x 128 columns (16 groups), read once into shared memory
// (coalesced), row pass with one thread per group row, column pass with one
// thread per column, each quantized coefficient written once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dct8.cuh"

namespace {

using namespace dmmt;

constexpr int TILE_W = 128;
constexpr int LD = TILE_W + 1;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) plane_dct_kernel(
    const float* __restrict__ plane, int height, int width, int tiles_x,
    const float* __restrict__ consts, const float* __restrict__ q, short* __restrict__ out) {
    __shared__ float s_k[K_COUNT];
    __shared__ float s_q[64];
    __shared__ float s[8 * LD];
    const int tid = threadIdx.x;
    for (int i = tid; i < K_COUNT; i += THREADS) s_k[i] = consts[i];
    for (int i = tid; i < 64; i += THREADS) s_q[i] = q[i];
    const int row0 = (blockIdx.x / tiles_x) * 8, col0 = (blockIdx.x % tiles_x) * TILE_W;
    const int valid = min(TILE_W, width - col0);
    for (int i = tid; i < 8 * TILE_W; i += THREADS) {
        const int r = i / TILE_W, c = i % TILE_W;
        s[r * LD + c] = c < valid ? plane[static_cast<size_t>(row0 + r) * width + col0 + c] : 0.0f;
    }
    __syncthreads();
    // row pass (along x): one thread per (row, 8-column group)
    for (int i = tid; i < 8 * (TILE_W / 8); i += THREADS) {
        const int r = i % 8, g = i / 8;
        if (g * 8 < valid) arai8(&s[r * LD + g * 8], 1, s_k);
    }
    __syncthreads();
    // column pass (along y), / q, round: one thread per column
    for (int c = tid; c < valid; c += THREADS) {
        arai8(&s[c], LD, s_k);
        short* o = out + static_cast<size_t>(row0) * width + col0 + c;
        for (int v = 0; v < 8; ++v) {
            o[static_cast<size_t>(v) * width] =
                round_half_away(__fdiv_rn(s[v * LD + c], s_q[v * 8 + c % 8]));
        }
    }
}

}  // namespace

// plane: float32 [height, width], both multiples of 8. consts: float32
// [K_COUNT] (ops/fused_arai.kernel_constants). q: float32 [64] raster.
// out: int16 [height, width].
extern "C" int dmmt_plane_dct(const float* plane, int height, int width, const float* consts,
                              const float* q, short* out, void* stream) {
    if (height % 8 || width % 8 || height <= 0 || width <= 0) return cudaErrorInvalidValue;
    const int tiles_x = (width + TILE_W - 1) / TILE_W;
    plane_dct_kernel<<<tiles_x * (height / 8), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        plane, height, width, tiles_x, consts, q, out);
    return static_cast<int>(cudaGetLastError());
}
