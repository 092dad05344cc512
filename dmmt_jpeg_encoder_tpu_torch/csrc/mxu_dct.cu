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
// Bound on the H100: 6 bytes per element (4 in, 2 out: 74.6 MB for the 4K
// frame's luma and stacked chroma planes, 0.0223 ms at 3.35 TB/s) against
// about 35 instructions per element (two 8-term contractions of 11 each,
// the division, the rounding). The arithmetic overlaps the memory traffic
// only as far as enough warps are resident, so registers per group decide
// the speed. Design: two threads per 8x8 group, everything in registers.
// - Thread 2g + h of the grid takes columns 4h..4h+3 of group g: one
//   16-byte load per row (a warp's load covers 512 contiguous bytes of a
//   row), the column pass on its 4 columns, then the pair swaps half of
//   its column-pass results with 16 shuffles so that thread h holds rows
//   4h..4h+3 whole, and runs the row pass on them. A thread holds half a
//   group (72 registers, where a whole group takes 102), so an SM holds
//   more warps, and the arithmetic of one group takes half as long; there
//   is no shared-memory exchange and no barrier in the group's work. Each
//   thread issues its loads before the CTA's one barrier (the table's
//   setup), so they are in flight while q is read.
// - The DCT matrix C comes as a launch parameter (__grid_constant__), so
//   both contractions read their weights as constant-bank operands, with
//   no loads.
// - DMMT_P1_PREC=high (ops/mxu_dct.dot_p1, the JAX reference's bf16x3
//   split) is a template arm on the type of that parameter: SplitMatrix
//   holds C's bf16 halves, rounded on the host (ops/mxu_dct.DCT_SPLIT).
//   Each thread splits its plane values before the column pass and its
//   rows before the row pass (dct8.cuh split8) and computes each output
//   as three chains in the pair order of XLA's CPU bf16 dot
//   (contract8_split). No tensor cores: the order of their bf16 sums is
//   not specified, and these bits need this one. The arm does about three
//   times the arithmetic of the other, with the same layout, division and
//   rounding.
// - q stays in device memory (the wrapper's table is a device tensor, of
//   uint8 as the encoder's tables come, or float32); each CTA reads it once
//   into shared memory as float32, with its reciprocals 1 / q
//   (__fdiv_rn). When every q is an integer in 1..255 (every table the
//   encoder makes), x / q is dct8.cuh's div_by_int: x * (1 / q) refined
//   by two fma corrections by the exact residual x - q y, which, rounded,
//   gives __fdiv_rn's coefficient for every finite x (div_check_kernel
//   below counts the differences over all finite float32 x and q = 1..255,
//   and chip_smoke.py requires none; for |x| >= 0.25 the quotients
//   themselves are equal);
//   non-finite x take x * (1 / q), which is x / q there. Any other table
//   takes __fdiv_rn.
// - The row pass rounds half away from zero as copysign(floor(|y| + 0.5),
//   y), which equals dct8.cuh's round_half_away for every float, and writes
//   each output row of 8 int16 as one 16-byte store.
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

// The DCT matrix C [8][8] (row k = frequency), passed by value.
struct Matrix {
    static constexpr bool SPLIT = false;
    float c[64];
};

// C's bf16 halves (DMMT_P1_PREC=high), passed by value.
struct SplitMatrix {
    static constexpr bool SPLIT = true;
    float hi[64];
    float lo[64];
};

// q and 1 / q in shared memory, row v at v * 8 + (v / 4) * 4: the two rows
// a thread pair reads at once (v and v + 4) sit in different banks
__device__ __forceinline__ int q_index(int v) { return v * 8 + (v / 4) * 4; }

__device__ __forceinline__ unsigned pack2(short lo, short hi) {
    return static_cast<unsigned short>(lo) | (static_cast<unsigned>(static_cast<unsigned short>(hi)) << 16);
}

// The row pass of the thread's rows v = 4h + i (rows[i]: the whole row
// after the column pass), / q, rounding, one 16-byte store per row.
template <bool FAST, typename M>
__device__ __forceinline__ void row_pass(const float (&rows)[4][8], int h, const M& m,
                                         const float* s_q, const float* s_rq, short* dst, int width) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int v = 4 * h + i;
        const float4 qa = *reinterpret_cast<const float4*>(s_q + q_index(v));
        const float4 qb = *reinterpret_cast<const float4*>(s_q + q_index(v) + 4);
        const float q[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        float rq[8];
        if (FAST) {
            const float4 ra = *reinterpret_cast<const float4*>(s_rq + q_index(v));
            const float4 rb = *reinterpret_cast<const float4*>(s_rq + q_index(v) + 4);
            rq[0] = ra.x; rq[1] = ra.y; rq[2] = ra.z; rq[3] = ra.w;
            rq[4] = rb.x; rq[5] = rb.y; rq[6] = rb.z; rq[7] = rb.w;
        }
        Split8 split;
        if constexpr (M::SPLIT) split = split8(rows[i]);
        unsigned w[4];
#pragma unroll
        for (int u = 0; u < 8; u += 2) {
            short s[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const float t = contract_row(rows[i], split, m, u + k);
                s[k] = round_away(FAST ? div_by_int(t, q[u + k], rq[u + k]) : __fdiv_rn(t, q[u + k]));
            }
            w[u / 2] = pack2(s[0], s[1]);
        }
        *reinterpret_cast<uint4*>(dst + static_cast<size_t>(v) * width) = make_uint4(w[0], w[1], w[2], w[3]);
    }
}

template <bool VEC, typename M>
__global__ void __launch_bounds__(THREADS) plane_dct_mm_kernel(
    const float* __restrict__ plane, int width, int groups_x, long long n_groups,
    const __grid_constant__ M m, const void* __restrict__ q, int q_uint8,
    short* __restrict__ out) {
    __shared__ __align__(16) float s_q[68];
    __shared__ __align__(16) float s_rq[68];
    const int tid = threadIdx.x;
    const long long g = (static_cast<long long>(blockIdx.x) * THREADS + tid) >> 1;
    const int h = tid & 1;
    const bool live = g < n_groups;
    const long long band = live ? g / groups_x : 0;
    const size_t corner =
        live ? static_cast<size_t>(band) * 8 * width + static_cast<size_t>(g - band * groups_x) * 8 : 0;

    // columns 4h..4h+3 of the group's 8 rows, in flight while the CTA
    // reads q
    float x[8][4];
    const float* src = plane + corner + 4 * h;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
        const float* row = src + static_cast<size_t>(y) * width;
        if (!live) {
#pragma unroll
            for (int j = 0; j < 4; ++j) x[y][j] = 0.0f;
        } else if (VEC) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(row));
            x[y][0] = a.x; x[y][1] = a.y; x[y][2] = a.z; x[y][3] = a.w;
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) x[y][j] = __ldg(row + j);
        }
    }

    bool fast_entry = true;
    if (tid < 64) {
        const float qv = q_uint8 ? static_cast<float>(static_cast<const uint8_t*>(q)[tid])
                                 : static_cast<const float*>(q)[tid];
        s_q[q_index(tid / 8) + tid % 8] = qv;
        s_rq[q_index(tid / 8) + tid % 8] = __fdiv_rn(1.0f, qv);
        fast_entry = qv == floorf(qv) && qv >= 1.0f && qv <= 255.0f;
    }
    const bool fast = __syncthreads_and(fast_entry);  // uniform over the CTA
    const unsigned pair_mask = __ballot_sync(FULL, live);  // whole pairs
    if (!live) return;

    // column pass (over y) on the thread's columns: t[v][4h + j]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        float col[8];
#pragma unroll
        for (int y = 0; y < 8; ++y) col[y] = x[y][j];
        Split8 split;
        if constexpr (M::SPLIT) split = split8(col);
#pragma unroll
        for (int v = 0; v < 8; ++v) x[v][j] = contract_row(col, split, m, v);
    }

    // the pair swaps halves: thread h keeps rows 4h..4h+3 of its columns and
    // receives the same rows of its partner's columns
    float rows[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float keep = h ? x[4 + i][j] : x[i][j];
            const float give = h ? x[i][j] : x[4 + i][j];
            const float got = __shfl_xor_sync(pair_mask, give, 1);
            rows[i][j] = h ? got : keep;
            rows[i][4 + j] = h ? keep : got;
        }
    }

    short* dst = out + corner;
    if (fast)
        row_pass<true>(rows, h, m, s_q, s_rq, dst, width);
    else
        row_pass<false>(rows, h, m, s_q, s_rq, dst, width);
}

// The check behind div_by_int and round_away (dct8.cuh, shared with
// plane_dct.cu): for every float32 bit pattern in [lo_bits, hi_bits), with
// both signs, and every q in 1..255, counts[0] the quotients that differ
// from __fdiv_rn(x, q) and counts[1] the coefficients that differ from
// round_half_away(__fdiv_rn(x, q)).
__global__ void __launch_bounds__(256) div_check_kernel(unsigned lo_bits, unsigned hi_bits,
                                                        unsigned long long* counts) {
    unsigned long long quotients = 0, coefficients = 0;
    for (unsigned long long i = blockIdx.x * 256ull + threadIdx.x; i < hi_bits - lo_bits;
         i += gridDim.x * 256ull) {
        const float a = __uint_as_float(lo_bits + static_cast<unsigned>(i));
        for (int qi = 1; qi <= 255; ++qi) {
            const float q = static_cast<float>(qi), rq = __fdiv_rn(1.0f, q);
#pragma unroll
            for (int sign = 0; sign < 2; ++sign) {
                const float x = sign ? -a : a;
                const float want = __fdiv_rn(x, q), got = div_by_int(x, q, rq);
                quotients += __float_as_uint(want) != __float_as_uint(got);
                coefficients += round_half_away(want) != round_away(got);
            }
        }
    }
    atomicAdd(counts, quotients);
    atomicAdd(counts + 1, coefficients);
}

template <typename M>
cudaError_t launch(const float* plane, int height, int width, const M& m, const void* q, int q_uint8,
                   short* out, cudaStream_t s) {
    if (height % 8 || width % 8 || height <= 0 || width <= 0) return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(out) & 15) return cudaErrorMisalignedAddress;
    const int groups_x = width / 8;
    const long long n_groups = static_cast<long long>(height / 8) * groups_x;
    const long long grid = (2 * n_groups + THREADS - 1) / THREADS;
    if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(plane) & 15) == 0)
        plane_dct_mm_kernel<true, M><<<static_cast<unsigned>(grid), THREADS, 0, s>>>(
            plane, width, groups_x, n_groups, m, q, q_uint8, out);
    else
        plane_dct_mm_kernel<false, M><<<static_cast<unsigned>(grid), THREADS, 0, s>>>(
            plane, width, groups_x, n_groups, m, q, q_uint8, out);
    return cudaGetLastError();
}

}  // namespace

// counts: uint64 [2], zeroed; see div_check_kernel.
extern "C" int dmmt_plane_dct_mm_div_check(unsigned lo_bits, unsigned hi_bits,
                                           unsigned long long* counts, void* stream) {
    if (hi_bits <= lo_bits) return static_cast<int>(cudaErrorInvalidValue);
    div_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(lo_bits, hi_bits, counts);
    return static_cast<int>(cudaGetLastError());
}

// plane: float32 [height, width], both multiples of 8, any 4-byte alignment.
// c_host: float32 [8, 8] DCT matrix (ops/dct.dct_matrix) in host memory,
// copied into the launch's parameters before this returns. q: [64] raster
// in device memory, uint8 (q_uint8 = 1) or float32 (q_uint8 = 0).
// out: int16 [height, width], 16-byte aligned.
extern "C" int dmmt_plane_dct_mm(const float* plane, int height, int width, const float* c_host,
                                 const void* q, int q_uint8, short* out, void* stream) {
    if (!c_host) return static_cast<int>(cudaErrorInvalidValue);
    Matrix m;
    for (int i = 0; i < 64; ++i) m.c[i] = c_host[i];
    return static_cast<int>(launch(plane, height, width, m, q, q_uint8, out, static_cast<cudaStream_t>(stream)));
}

// The same with DMMT_P1_PREC=high's split contractions: c_hi_host and
// c_lo_host, float32 [8, 8] in host memory, are C's bf16 halves
// (ops/mxu_dct.DCT_SPLIT).
extern "C" int dmmt_plane_dct_mm_split(const float* plane, int height, int width,
                                       const float* c_hi_host, const float* c_lo_host, const void* q,
                                       int q_uint8, short* out, void* stream) {
    if (!c_hi_host || !c_lo_host) return static_cast<int>(cudaErrorInvalidValue);
    SplitMatrix m;
    for (int i = 0; i < 64; ++i) {
        m.hi[i] = c_hi_host[i];
        m.lo[i] = c_lo_host[i];
    }
    return static_cast<int>(launch(plane, height, width, m, q, q_uint8, out, static_cast<cudaStream_t>(stream)));
}
