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
// Bound on the H100: 6 bytes per element (4 in, 2 out: 74.6 MB for the 4K
// frame's luma and stacked chroma planes, 0.0223 ms at 3.35 TB/s) against
// about 18 operations per element (two Arai passes, the division, the
// rounding). As in mxu_dct.cu, the arithmetic overlaps the memory traffic
// only as far as enough warps are resident, so registers per group decide
// the speed. Design: two threads per 8x8 group, everything in registers
// (mxu_dct.cu's layout, turned for the row pass first).
// - Thread 2g + h of the grid takes rows 4h..4h+3 of group g whole: two
//   16-byte loads per row (a warp's two loads of a row cover 512 contiguous
//   bytes), the row pass on its 4 rows, then the pair swaps half of its
//   results with 16 shuffles so that thread h holds columns 4h..4h+3 whole,
//   and runs the column pass on them, / q and the rounding, with one 8-byte
//   store of 4 int16 per row (the pair writes the row's 16 bytes). There is
//   no shared-memory exchange and no barrier in the group's work. Each
//   thread issues its loads before the CTA's one barrier (the table's
//   setup), so they are in flight while q is read.
// - The Arai constants (ops/fused_arai.kernel_constants) come as a launch
//   parameter (__grid_constant__), so both passes read them as
//   constant-bank operands, with no loads and nothing staged per CTA.
// - q stays in device memory (the wrapper's table is a device tensor, of
//   uint8 as the encoder's tables come, or float32); each CTA reads it once
//   into shared memory as float32, with its reciprocals 1 / q
//   (__fdiv_rn). When every q is an integer in 1..255 (every table the
//   encoder makes), x / q is div_by_int (dct8.cuh), whose coefficient
//   equals __fdiv_rn's for every finite x (mxu_dct.cu's div_check_kernel
//   counts the differences over all finite float32 x and q = 1..255, and
//   chip_smoke.py requires none). Any other table takes __fdiv_rn.
// - A plane whose base is not 16-byte aligned takes 4-byte loads (a uniform
//   template arm); rows are 32-byte multiples (W % 8 == 0), so the base
//   decides. The output is allocated by the wrapper, 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dct8.cuh"

namespace {

using namespace dmmt;

constexpr int THREADS = 128;   // 64 groups per CTA
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned pack2(short lo, short hi) {
    return static_cast<unsigned short>(lo) | (static_cast<unsigned>(static_cast<unsigned short>(hi)) << 16);
}

// The constants array (K_Y0 .. K_S0 + 7), passed by value.
struct Constants {
    float k[K_COUNT];
};

// / q, rounding and the stores of the thread's columns u = 4h + j
// (col[j][v]: the coefficient (v, u) after both passes), one 8-byte store
// per row.
template <bool FAST>
__device__ __forceinline__ void quantize_store(const float (&col)[4][8], int h, const float* s_q,
                                               const float* s_rq, short* dst, int width) {
#pragma unroll
    for (int v = 0; v < 8; ++v) {
        const float4 qv = *reinterpret_cast<const float4*>(s_q + v * 8 + 4 * h);
        const float q[4] = {qv.x, qv.y, qv.z, qv.w};
        float rq[4];
        if (FAST) {
            const float4 r = *reinterpret_cast<const float4*>(s_rq + v * 8 + 4 * h);
            rq[0] = r.x; rq[1] = r.y; rq[2] = r.z; rq[3] = r.w;
        }
        short s[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            s[j] = round_away(FAST ? div_by_int(col[j][v], q[j], rq[j]) : __fdiv_rn(col[j][v], q[j]));
        *reinterpret_cast<uint2*>(dst + static_cast<size_t>(v) * width) =
            make_uint2(pack2(s[0], s[1]), pack2(s[2], s[3]));
    }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) plane_dct_kernel(
    const float* __restrict__ plane, int width, int groups_x, long long n_groups,
    const __grid_constant__ Constants c, const void* __restrict__ q, int q_uint8,
    short* __restrict__ out) {
    __shared__ __align__(16) float s_q[64];
    __shared__ __align__(16) float s_rq[64];
    const int tid = threadIdx.x;
    const long long g = (static_cast<long long>(blockIdx.x) * THREADS + tid) >> 1;
    const int h = tid & 1;
    const bool live = g < n_groups;
    const long long band = live ? g / groups_x : 0;
    const size_t corner =
        live ? static_cast<size_t>(band) * 8 * width + static_cast<size_t>(g - band * groups_x) * 8 : 0;

    // rows 4h..4h+3 of the group, in flight while the CTA reads q
    float x[4][8];
    const float* src = plane + corner + static_cast<size_t>(4 * h) * width;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float* row = src + static_cast<size_t>(i) * width;
        if (!live) {
#pragma unroll
            for (int j = 0; j < 8; ++j) x[i][j] = 0.0f;
        } else if (VEC) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(row));
            const float4 b = __ldg(reinterpret_cast<const float4*>(row + 4));
            x[i][0] = a.x; x[i][1] = a.y; x[i][2] = a.z; x[i][3] = a.w;
            x[i][4] = b.x; x[i][5] = b.y; x[i][6] = b.z; x[i][7] = b.w;
        } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) x[i][j] = __ldg(row + j);
        }
    }

    bool fast_entry = true;
    if (tid < 64) {
        const float qv = q_uint8 ? static_cast<float>(static_cast<const uint8_t*>(q)[tid])
                                 : static_cast<const float*>(q)[tid];
        s_q[tid] = qv;
        s_rq[tid] = __fdiv_rn(1.0f, qv);
        fast_entry = qv == floorf(qv) && qv >= 1.0f && qv <= 255.0f;
    }
    const bool fast = __syncthreads_and(fast_entry);  // uniform over the CTA
    const unsigned pair_mask = __ballot_sync(FULL, live);  // whole pairs
    if (!live) return;

    // row pass (along x) on the thread's rows
#pragma unroll
    for (int i = 0; i < 4; ++i) arai8(x[i], c.k);

    // the pair swaps halves: thread h keeps columns 4h..4h+3 of its rows and
    // receives the same columns of its partner's rows; col[j][v] is row v
    // of column 4h + j
    float col[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float keep = h ? x[i][4 + j] : x[i][j];
            const float give = h ? x[i][j] : x[i][4 + j];
            const float got = __shfl_xor_sync(pair_mask, give, 1);
            col[j][i] = h ? got : keep;
            col[j][4 + i] = h ? keep : got;
        }
    }

    // column pass (along y) on the thread's columns
#pragma unroll
    for (int j = 0; j < 4; ++j) arai8(col[j], c.k);

    short* dst = out + corner + 4 * h;
    if (fast)
        quantize_store<true>(col, h, s_q, s_rq, dst, width);
    else
        quantize_store<false>(col, h, s_q, s_rq, dst, width);
}

}  // namespace

// plane: float32 [height, width], both multiples of 8, any 4-byte alignment.
// c_host: float32 [K_COUNT] (ops/fused_arai.kernel_constants) in host
// memory, copied into the launch's parameters before this returns. q: [64]
// raster in device memory, uint8 (q_uint8 = 1) or float32 (q_uint8 = 0).
// out: int16 [height, width], 16-byte aligned.
extern "C" int dmmt_plane_dct(const float* plane, int height, int width, const float* c_host,
                              const void* q, int q_uint8, short* out, void* stream) {
    if (height % 8 || width % 8 || height <= 0 || width <= 0 || !c_host || !q || !out)
        return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(out) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
    Constants c;
    for (int i = 0; i < K_COUNT; ++i) c.k[i] = c_host[i];
    const int groups_x = width / 8;
    const long long n_groups = static_cast<long long>(height / 8) * groups_x;
    const long long grid = (2 * n_groups + THREADS - 1) / THREADS;
    if (grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if ((reinterpret_cast<uintptr_t>(plane) & 15) == 0)
        plane_dct_kernel<true><<<static_cast<unsigned>(grid), THREADS, 0, s>>>(
            plane, width, groups_x, n_groups, c, q, q_uint8, out);
    else
        plane_dct_kernel<false><<<static_cast<unsigned>(grid), THREADS, 0, s>>>(
            plane, width, groups_x, n_groups, c, q, q_uint8, out);
    return static_cast<int>(cudaGetLastError());
}
