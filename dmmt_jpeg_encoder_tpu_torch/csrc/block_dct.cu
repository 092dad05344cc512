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
// No tensor cores: their products sum in another order, and TF32 would
// change the bits.
//
// Bound on the H100: 64 fmas (128 operations) per output against 6 bytes
// (4 in, 2 out) per output: operation-bound at the FFMA rate, with the
// bytes close behind (~0.024 ms and ~0.022 ms at 4K).
// Design, so that the FFMA pipe and not shared memory sets the pace:
// - persistent CTAs, as many as the card holds at once (SMs x resident
//   CTAs), each walking tiles of TILE blocks; M is loaded into shared
//   memory once per CTA, each row's columns laid out so that a thread's
//   eight contiguous output columns are two float4 reads that a warp
//   serves without a bank conflict;
// - the next tile is copied with cp.async (16 bytes a thread, one commit
//   group per tile) into the second of two shared buffers while the
//   current one is computed; rows are padded to XS floats so that a warp's
//   float4 reads of its four blocks fall in distinct banks;
// - each thread holds a register tile of 4 blocks x 8 columns, 32
//   independent accumulators: per four steps of i it reads 4 float4 of x
//   and 8 float4 of M for 128 FFMAs;
// - each thread writes its eight int16 outputs of a block as one 16-byte
//   streaming store.
// On the H100 (PERF.md) the FFMA issue rate sets the time: builds with 8 x 8
// register tiles, warp-uniform M reads, 64-block tiles or register-
// prefetched fragments ran no faster, and a probe build with the shared
// loads taken out of the i loop only slightly faster.
// Every output keeps the reference's chain: a plain product for i = 0, then
// __fmaf_rn for i = 1..63 in ascending order, then the rounding. The tiling
// changes which thread computes an output, never the order of its terms.
// Pointers that are not 16-byte aligned take 4-byte copies and scalar
// stores; the arithmetic is the same.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dct8.cuh"

namespace {

using namespace dmmt;

constexpr int THREADS = 256;                           // row groups x 8 column groups
constexpr int ROW_GROUPS = THREADS / 8;
constexpr int BPT = 4;                                 // blocks per thread
constexpr int MIN_CTAS = 2;                            // resident CTAs per SM the registers allow
constexpr int TILE = BPT * ROW_GROUPS;                 // blocks per tile
constexpr int XS = 68;                                 // shared row stride of a tile, floats
constexpr int SMEM_M = 64 * 64;                        // floats
constexpr int SMEM_X = TILE * XS;                      // floats per tile buffer
constexpr size_t SMEM_BYTES = (SMEM_M + 2 * SMEM_X) * sizeof(float);
constexpr int MAX_DEVICES = 64;
static_assert(XS % 4 == 0 && (XS / 4) % 2 == 1, "rows 16-byte aligned, float4 reads conflict-free");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait for every commit group of this thread but the newest
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start copying the rows of tile t that exist into buf (rows past n are
// left as they are: their outputs are never stored).
__device__ __forceinline__ void load_tile(float* buf, const float* blocks, long long n, long long t,
                                          bool aligned) {
    const long long n0 = t * TILE;
    const int rows = static_cast<int>(min(static_cast<long long>(TILE), n - n0));
    const float* src = blocks + n0 * 64;
    if (aligned) {
        for (int q = threadIdx.x; q < rows * 16; q += THREADS)
            cp_async16(buf + (q >> 4) * XS + (q & 15) * 4, src + q * 4);
    } else {
        for (int q = threadIdx.x; q < rows * 64; q += THREADS)
            cp_async4(buf + (q >> 6) * XS + (q & 63), src + q);
    }
}

__device__ __forceinline__ float lane(const float4& v, int s) {
    return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

// Steps i = 4k .. 4k + 3 of the chains of a thread's 4 x 8 outputs. xs: the
// thread's first block row in the tile; m4: M in shared memory as float4.
template <bool FIRST>
__device__ __forceinline__ void steps4(float (&acc)[BPT][8], const float* xs, const float4* m4, int k,
                                       int cg) {
    float4 xv[BPT];
#pragma unroll
    for (int r = 0; r < BPT; ++r) xv[r] = *reinterpret_cast<const float4*>(xs + r * ROW_GROUPS * XS + 4 * k);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        const int i = 4 * k + s;
        const float4 lo = m4[i * 16 + cg], hi = m4[i * 16 + 8 + cg];
        const float mv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int r = 0; r < BPT; ++r) {
            const float x = lane(xv[r], s);
#pragma unroll
            for (int c = 0; c < 8; ++c)
                acc[r][c] = (FIRST && s == 0) ? mul(x, mv[c]) : fmadd(x, mv[c], acc[r][c]);
        }
    }
}

__device__ __forceinline__ int pack2(short a, short b) {
    return static_cast<int>(static_cast<unsigned>(static_cast<unsigned short>(a)) |
                            (static_cast<unsigned>(static_cast<unsigned short>(b)) << 16));
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS) block_dct_zz_kernel(
    const float* __restrict__ blocks, long long n, const float* __restrict__ m,
    short* __restrict__ out, bool aligned) {
    extern __shared__ float4 smem[];
    float* s_m = reinterpret_cast<float*>(smem);
    float* s_x = s_m + SMEM_M;
    const int tid = threadIdx.x;
    const int cg = tid & 7, rg = tid >> 3;
    const long long n_tiles = (n + TILE - 1) / TILE;
    long long tile = blockIdx.x;
    // column j = 8g + c of each row of M goes to 4g + c (c < 4) or to
    // 32 + 4g + c - 4 (c >= 4): thread cg reads float4 cg and 8 + cg
    for (int e = tid; e < 64 * 64; e += THREADS) {
        const int i = e >> 6, g = (e & 63) >> 3, c = e & 7;
        s_m[i * 64 + (c < 4 ? 4 * g + c : 28 + 4 * g + c)] = m[e];
    }
    load_tile(s_x, blocks, n, tile, aligned);  // the grid never exceeds the tiles
    cp_async_commit();
    const float4* m4 = reinterpret_cast<const float4*>(s_m);
    for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
        const long long next = tile + gridDim.x;
        if (next < n_tiles) load_tile(s_x + (buf ^ 1) * SMEM_X, blocks, n, next, aligned);
        cp_async_commit();
        cp_async_wait_all_but_newest();
        __syncthreads();
        const float* xs = s_x + buf * SMEM_X + rg * XS;
        float acc[BPT][8];
        steps4<true>(acc, xs, m4, 0, cg);
#pragma unroll 5
        for (int k = 1; k < 16; ++k) steps4<false>(acc, xs, m4, k, cg);
        const long long n0 = tile * TILE;
#pragma unroll
        for (int r = 0; r < BPT; ++r) {
            const long long b = n0 + rg + r * ROW_GROUPS;
            if (b >= n) continue;
            short v[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) v[c] = round_half_away(acc[r][c]);
            short* o = out + b * 64 + cg * 8;
            if (aligned) {
                __stcs(reinterpret_cast<int4*>(o),
                       make_int4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7])));
            } else {
#pragma unroll
                for (int c = 0; c < 8; ++c) o[c] = v[c];
            }
        }
        __syncthreads();  // every thread is done with buf before it is refilled
    }
}

// CTAs the card holds at once (SMs x resident CTAs), per device; sets the
// kernel's shared-memory limit on first use. 0 on failure.
int resident_ctas(int dev) {
    static int cached[MAX_DEVICES] = {0};
    if (dev >= 0 && dev < MAX_DEVICES && cached[dev] > 0) return cached[dev];
    int sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(block_dct_zz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_BYTES)) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_dct_zz_kernel, THREADS,
                                                      SMEM_BYTES) != cudaSuccess ||
        per_sm < 1)
        return 0;
    if (dev >= 0 && dev < MAX_DEVICES) cached[dev] = sms * per_sm;
    return sms * per_sm;
}

}  // namespace

// blocks: float32 [n, 64] (row-major 8x8 blocks). m: float32 [64, 64].
// out: int16 [n, 64] zigzag.
extern "C" int dmmt_block_dct_zz(const float* blocks, long long n, const float* m, short* out,
                                 void* stream) {
    if (n <= 0) return n == 0 ? 0 : cudaErrorInvalidValue;
    int dev = 0;
    const cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int ctas = resident_ctas(dev);
    if (ctas < 1) {
        const cudaError_t last = cudaGetLastError();
        return static_cast<int>(last != cudaSuccess ? last : cudaErrorInvalidConfiguration);
    }
    const long long tiles = (n + TILE - 1) / TILE;
    const unsigned grid = static_cast<unsigned>(tiles < ctas ? tiles : ctas);
    const bool aligned = ((reinterpret_cast<uintptr_t>(blocks) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    block_dct_zz_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        blocks, n, m, out, aligned);
    return static_cast<int>(cudaGetLastError());
}
