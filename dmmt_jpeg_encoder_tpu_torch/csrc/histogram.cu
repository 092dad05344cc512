// Weighted per-group symbol histograms on Hopper.
//
// Replaces: dmmt_jpeg_encoder_tpu/ops/pallas_histogram.py :
// pallas_histogram (Pallas kernel _hist_kernel, the one-group form) and
// pallas_histogram_grouped (_hist_kernel_grouped). For each group g of M
// int32 symbols with int32 weights: out[g, s] = sum of the weights of the
// entries whose symbol is s. A symbol outside [0, n_bins) counts nowhere,
// as the TPU kernel's per-bin compare drops it. Counts are exact int32,
// wrapping as the plain version's int64 sum does when cast back (one 8K AC
// bin can pass 2^24, so nothing is counted in float32).
//
// Bound on the H100: reading 8 bytes (symbol + weight) per entry (99.5 MB
// for the 4K frame's four calls, 0.0297 ms at 3.35 TB/s); a compare and,
// for a nonzero weight, one shared-memory atomic per entry. The TPU kernel
// swept each tile once per bin with masked f32 reduces, because Mosaic has
// no scatter. Design:
// - a persistent grid (the CTAs the card holds at once, no more than the
//   work needs) shared out over the groups, grid.y the group; each thread
//   issues UNROLL 16-byte loads of symbols and as many of weights before it
//   counts any of them, the first step's before the CTA's barrier;
// - a row whose base is not 16-byte aligned (G > 1 with M % 4 != 0, or a
//   view) counts its first entries up to the boundary, and any last
//   entries past the whole quads, one per thread; where symbols and weights
//   are not aligned alike, every entry takes 4-byte loads (a uniform
//   template arm);
// - each warp counts into its own histogram in shared memory, skipping
//   weight 0 and symbols out of range; each CTA sums its warps' bins and
//   adds each nonzero bin to the output once. Up to 16 bins (the DC
//   calls, whose categories crowd into a few bins, so that a warp's lanes
//   would serialize on one shared atomic), each lane keeps its own
//   counters, at (bin, lane) so that a warp's 32 lanes hit 32 banks, and
//   adds to them without atomics;
// - no zero fill: the first CTA to take a ticket zeroes the output while
//   the others count and raises a flag, and the others add only once the
//   flag is up. The ticket count and an epoch live in a 16-byte state that
//   the wrapper keeps per stream (calls on one stream run in turn); the
//   last CTA to take a ticket resets the count and moves the epoch on.
//   The protocol and the state are block_hist.cu's: each call leaves the
//   state ready for the next on its stream, of either kernel.
// Integer atomics make the result independent of the order in which warps
// and CTAs finish.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_CTAS = 2;               // resident CTAs per SM the launch bounds ask for
constexpr int MAX_BINS = 256;
constexpr int SMALL_BINS = 16;            // up to this many bins, a counter per lane
static_assert(WARPS == SMALL_BINS, "one warp sums each small bin");
constexpr int UNROLL = 4;                 // 16-byte loads of symbols (and of weights) per thread and step
constexpr int STEP = THREADS * UNROLL;    // quads (4 entries) per CTA and step

// One entry into the warp's histogram h: per bin, or (SMALL) per bin and
// lane. Sums wrap modulo 2^32, as the atomics do.
template <bool SMALL>
__device__ __forceinline__ void count(unsigned* h, int lane, int s, int w, int n_bins) {
    if (w == 0 || static_cast<unsigned>(s) >= static_cast<unsigned>(n_bins)) return;
    if (SMALL)
        h[s * 32 + lane] += static_cast<unsigned>(w);
    else
        atomicAdd(&h[s], static_cast<unsigned>(w));
}

// Four consecutive entries: one 16-byte load, or four 4-byte loads.
template <bool VEC>
__device__ __forceinline__ int4 load4(const int* p) {
    if (VEC) return __ldg(reinterpret_cast<const int4*>(p));
    return make_int4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

template <bool VEC, bool SMALL>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
histogram_kernel(const int* __restrict__ symbols, const int* __restrict__ weights, long long m,
                 int n_bins, unsigned long long* __restrict__ state, int* __restrict__ out) {
    constexpr int PER_WARP = SMALL ? SMALL_BINS * 32 : MAX_BINS;
    __shared__ unsigned s_hist[WARPS * PER_WARP];
    __shared__ unsigned s_ticket, s_epoch;
    const int tid = threadIdx.x, lane = tid & 31;
    const long long g = blockIdx.y;
    const int* sym = symbols + g * m;
    const int* wt = weights + g * m;
    // entries before the row's first 16-byte boundary, whole quads, the rest
    const long long head =
        VEC ? min(m, static_cast<long long>(((16 - (reinterpret_cast<uintptr_t>(sym) & 15)) & 15) >> 2)) : 0;
    const long long n_quads = (m - head) >> 2;
    const long long tail = m - head - 4 * n_quads;
    const int* qs = sym + head;
    const int* qw = wt + head;
    const long long step = static_cast<long long>(gridDim.x) * STEP;
    unsigned* flag = reinterpret_cast<unsigned*>(state + 1);

    int4 s4[UNROLL], w4[UNROLL];
    auto load = [&](long long base) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long q = base + u * THREADS;
            s4[u] = w4[u] = make_int4(0, 0, 0, 0);
            if (q < n_quads) {
                s4[u] = load4<VEC>(qs + 4 * q);
                w4[u] = load4<VEC>(qw + 4 * q);
            }
        }
    };

    long long base = static_cast<long long>(blockIdx.x) * STEP + tid;
    load(base);
    // a ticket and the call's epoch; the last CTA to take a ticket resets
    // the count and moves the epoch on for the next call
    if (tid == 0) {
        const unsigned long long t = atomicAdd(state, 1ull);
        s_ticket = static_cast<unsigned>(t);
        s_epoch = static_cast<unsigned>(t >> 32);
        if (s_ticket == gridDim.x * gridDim.y - 1)
            atomicExch(state, static_cast<unsigned long long>(s_epoch + 1) << 32);
    }
    for (int i = tid; i < WARPS * PER_WARP; i += THREADS) s_hist[i] = 0u;
    __syncthreads();
    const unsigned ready = s_epoch + 1;
    if (s_ticket == 0) {   // the first CTA zeroes the output, then raises the flag
        const long long n_out = static_cast<long long>(gridDim.y) * n_bins;
        for (long long i = tid; i < n_out; i += THREADS) out[i] = 0;
        __threadfence();
        __syncthreads();
        if (tid == 0) atomicExch(flag, ready);
    }
    unsigned* h = s_hist + (tid >> 5) * PER_WARP;
    if (blockIdx.x == 0) {   // the row's head and tail, fewer than 4 entries each
        if (tid < head) count<SMALL>(h, lane, __ldg(sym + tid), __ldg(wt + tid), n_bins);
        if (tid >= 4 && tid - 4 < tail) {
            const long long i = m - tail + (tid - 4);
            count<SMALL>(h, lane, __ldg(sym + i), __ldg(wt + i), n_bins);
        }
    }
    for (; base < n_quads; base += step) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            count<SMALL>(h, lane, s4[u].x, w4[u].x, n_bins);
            count<SMALL>(h, lane, s4[u].y, w4[u].y, n_bins);
            count<SMALL>(h, lane, s4[u].z, w4[u].z, n_bins);
            count<SMALL>(h, lane, s4[u].w, w4[u].w, n_bins);
        }
        if (base + step < n_quads) load(base + step);
    }
    __syncthreads();

    // the CTA's totals (SMALL: warp b sums bin b over warps, then lanes)
    unsigned seen = tid == 0 ? *reinterpret_cast<volatile unsigned*>(flag) : ready;
    const int bin = SMALL ? tid >> 5 : tid;
    unsigned total = 0;
    if (bin < n_bins)
#pragma unroll
        for (int w = 0; w < WARPS; ++w) total += s_hist[w * PER_WARP + (SMALL ? bin * 32 + lane : bin)];
    if (SMALL) total = __reduce_add_sync(0xFFFFFFFFu, total);
    // into the output, once the first CTA has zeroed it
    while (seen != ready) seen = *reinterpret_cast<volatile unsigned*>(flag);
    __syncthreads();
    __threadfence();
    if (bin < n_bins && total && (!SMALL || lane == 0))
        atomicAdd(reinterpret_cast<unsigned*>(out) + g * n_bins + bin, total);
}

}  // namespace

// symbols, weights: int32 [n_groups, m] (any 4-byte alignment); out: int32
// [n_groups, n_bins], written whole (no fill needed). state: 16 bytes
// (8-aligned), zeroed before its first call, kept between calls (a ticket
// count and an epoch, then the flag of the epoch whose output is zeroed);
// calls that share a state must run in turn (one stream).
extern "C" int dmmt_histogram_grouped(const int* symbols, const int* weights, int n_groups,
                                      long long m, int n_bins, unsigned long long* state, int* out,
                                      void* stream) {
    if (n_groups < 1 || n_groups > 65535 || m < 0 || n_bins < 1 || n_bins > MAX_BINS || !state ||
        !out || (m > 0 && (!symbols || !weights)) ||
        ((reinterpret_cast<uintptr_t>(symbols) | reinterpret_cast<uintptr_t>(weights)) & 3) ||
        (reinterpret_cast<uintptr_t>(state) & 7))
        return static_cast<int>(cudaErrorInvalidValue);
    // CTAs the card holds at once, per device (read once)
    static int resident[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (resident[dev] == 0) {
        int sms = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, histogram_kernel<true, false>,
                                                                THREADS, 0);
        if (err != cudaSuccess) return static_cast<int>(err);
        resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
    }
    long long ctas = (m / 4 + STEP - 1) / STEP;
    const long long cap = resident[dev] / n_groups;
    if (ctas > cap) ctas = cap;
    if (ctas < 1) ctas = 1;
    const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(n_groups));
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = ((reinterpret_cast<uintptr_t>(symbols) ^ reinterpret_cast<uintptr_t>(weights)) & 15) == 0;
    auto kernel = vec ? (n_bins <= SMALL_BINS ? histogram_kernel<true, true> : histogram_kernel<true, false>)
                      : (n_bins <= SMALL_BINS ? histogram_kernel<false, true> : histogram_kernel<false, false>);
    kernel<<<grid, THREADS, 0, s>>>(symbols, weights, m, n_bins, state, out);
    return static_cast<int>(cudaGetLastError());
}
