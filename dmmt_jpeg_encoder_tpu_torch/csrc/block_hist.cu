// DC-category and AC (run, category) symbol histograms on Hopper.
//
// Replaces: dmmt_jpeg_encoder_tpu/ops/pallas_block_hist.py :
// fused_block_histograms (Pallas kernel _kernel). Same semantics as
// entropy.categorize.symbol_histograms (reference:
// src/...transformer/categorize.rs:132-151, symbol_counting.rs:55-74):
// over [64] int16 zigzag blocks (DC already DPCM'd),
// dc[category(DC)] += 1; for every nonzero AC at position p with previous
// nonzero (or DC slot) at q: ac[((p-q-1) & 15) << 4 | category] += 1 and
// ac[0xF0] += (p-q-1) >> 4 (ZRLs); ac[0x00] += 1 when the last nonzero AC
// sits before position 63, that is when position 63 is zero (EOB). The
// blocks come as up to two segments (the chroma call counts Cb and Cr
// into one pair of histograms without concatenating them), each a pointer
// and a count of the blocks to count.
//
// Bound on the H100: reading 128 bytes per block (24.9 MB at 4K, 0.0074 ms
// at 3.35 TB/s); the counting is a few integer operations per coefficient,
// but in a photograph the nonzero ACs crowd into positions 1-15, so the
// work per block is uneven across any fixed split of its positions, and
// the counting, not the bytes, sets the time. Design:
// - eight lanes share a block, each loading 8 consecutive coefficients as
//   one 16-byte load (2-byte loads where a segment is not 16-byte aligned,
//   a uniform branch), so a warp holds 4 blocks; a warp step takes UNROLL
//   such groups, and the next step's loads are issued before this step's
//   counting;
// - two butterfly stages of shuffles among the 8 lanes regroup the block
//   so that lane g holds the position pairs 16k + 8 (g & 1) + 2 (g >> 1)
//   (+ 1), k = 0..3: positions 0-15 fall one pair to a lane;
// - the lanes build the block's 64-bit nonzero mask (3 shuffles); each lane
//   then counts its 8 positions in an unrolled, predicated pass, a
//   nonzero's run being the distance to the highest set bit below it;
// - each warp counts into its own histogram in shared memory; ZRLs and
//   EOBs are counted in registers and added once per warp;
// - a persistent grid (the CTAs the card holds at once) walks the blocks;
//   the first CTA to take a ticket zeroes the output while the others
//   count and raises a flag, and each CTA adds its warps' summed nonzero
//   bins to the output once the flag is up, so no call needs a zero fill
//   or a last pass. The ticket count and an epoch live in a 16-byte state
//   that the wrapper keeps per stream (calls on one stream run in turn);
//   the last CTA to take a ticket resets the count and moves the epoch on.
// Integer counts make the result independent of the order in which warps
// and CTAs finish.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_CTAS = 2;        // resident CTAs per SM the launch bounds ask for
constexpr int UNROLL = 2;          // 4-block groups per warp and step
constexpr int BINS = 16 + 256;     // dc, then ac
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int category(int v) { return 32 - __clz(v < 0 ? -v : v); }

// Zigzag positions 8g .. 8g + 7 of a block: one 16-byte load, or eight
// 2-byte loads where the segments are not 16-byte aligned.
__device__ __forceinline__ int4 load8(const short* p, bool aligned) {
    if (aligned) return __ldg(reinterpret_cast<const int4*>(p));
    int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        w[i] = static_cast<int>(static_cast<unsigned short>(__ldg(p + 2 * i)) |
                                (static_cast<unsigned>(static_cast<unsigned short>(__ldg(p + 2 * i + 1))) << 16));
    return make_int4(w[0], w[1], w[2], w[3]);
}

// One butterfly stage among a block's 8 lanes: swap lane bit `lbit` (of g)
// with slot bit `sbit` of the 4 words the lane holds.
__device__ __forceinline__ void exchange(int (&w)[4], int g, int lbit, int sbit) {
    const bool up = (g >> lbit) & 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        if (j & (1 << sbit)) continue;
        const int jj = j | (1 << sbit);
        const int got = __shfl_xor_sync(FULL, up ? w[j] : w[jj], 1 << lbit);
        if (up) w[j] = got;
        else w[jj] = got;
    }
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
block_hist_kernel(const short* __restrict__ a, long long n_a, const short* __restrict__ b,
                  long long n_b, unsigned long long* __restrict__ state, int* __restrict__ out) {
    __shared__ int s_hist[WARPS][BINS];
    __shared__ unsigned s_ticket, s_epoch;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane & 7;        // the lane's eighth of its block
    const int sub = lane >> 3;     // its block of the warp's 4
    const long long groups_a = (n_a + 3) / 4, groups = groups_a + (n_b + 3) / 4;
    const long long first = (static_cast<long long>(blockIdx.x) * WARPS + warp) * UNROLL;
    const long long step = static_cast<long long>(gridDim.x) * WARPS * UNROLL;
    unsigned* flag = reinterpret_cast<unsigned*>(state + 1);
    const bool aligned = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;

    // the lane's 16 bytes (zigzag positions 8g .. 8g + 7) of groups q0 ..
    // q0 + UNROLL - 1; bit u of the result says whether group q0 + u holds
    // the lane's block
    auto load = [&](long long q0, int4 (&x)[UNROLL]) {
        unsigned on = 0;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long q = q0 + u;
            const bool in_a = q < groups_a;
            const long long blk = (in_a ? q : q - groups_a) * 4 + sub;
            x[u] = make_int4(0, 0, 0, 0);
            if (q < groups && blk < (in_a ? n_a : n_b)) {
                x[u] = load8((in_a ? a : b) + blk * 64 + 8 * g, aligned);
                on |= 1u << u;
            }
        }
        return on;
    };

    int4 x[UNROLL];
    unsigned on = load(first, x);
    // a ticket and the call's epoch; the last CTA to take a ticket resets
    // the count and moves the epoch on for the next call
    if (tid == 0) {
        const unsigned long long t = atomicAdd(state, 1ull);
        s_ticket = static_cast<unsigned>(t);
        s_epoch = static_cast<unsigned>(t >> 32);
        if (s_ticket == gridDim.x - 1) atomicExch(state, static_cast<unsigned long long>(s_epoch + 1) << 32);
    }
    for (int i = tid; i < WARPS * BINS; i += THREADS) (&s_hist[0][0])[i] = 0;
    __syncthreads();
    const unsigned ready = s_epoch + 1;
    if (s_ticket == 0) {   // the first CTA zeroes the output, then raises the flag
        for (int i = tid; i < BINS; i += THREADS) out[i] = 0;
        __threadfence();
        __syncthreads();
        if (tid == 0) atomicExch(flag, ready);
    }
    int* h = s_hist[warp];
    int zrl = 0, eob = 0;
    for (long long q = first; q < groups; q += step) {   // warp-uniform
        int4 next[UNROLL];
        const unsigned on_next = load(q + step, next);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            // spread the block over its lanes: after two butterfly stages
            // lane g's word k holds zigzag positions p0 + 2k * 8 .. + 1,
            // p0 = 8 (g & 1) + 2 (g >> 1), so that the dense low positions
            // (0-15) fall one pair to a lane
            int w[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
            exchange(w, g, 2, 1);
            exchange(w, g, 1, 0);
            const int p0 = 8 * (g & 1) + 2 * (g >> 1);
            // the block's nonzero mask, positions 0-31 and 32-63 (the DC's
            // bit cleared)
            unsigned lo = 0, hi = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const unsigned v = static_cast<unsigned>(w[k]);
                const unsigned bits = ((v & 0xFFFFu) != 0) | (((v >> 16) != 0) << 1);
                if (k < 2) lo |= bits << (16 * k + p0);
                else hi |= bits << (16 * (k - 2) + p0);
            }
            if (g == 0) lo &= ~1u;
#pragma unroll
            for (int d = 1; d < 8; d <<= 1) {
                lo |= __shfl_xor_sync(FULL, lo, d);
                hi |= __shfl_xor_sync(FULL, hi, d);
            }
            if (!(on >> u & 1)) continue;
            if (g == 0) atomicAdd(&h[category(static_cast<short>(w[0] & 0xFFFF))], 1);
            if (g == 7 && !(hi >> 31)) ++eob;   // position 63: g 7, word 3, high half
            // each nonzero AC: its run is the distance to the highest set
            // bit below it (0, the DC's slot, when there is none)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int p = 16 * k + p0 + half;
                    if (!(((k < 2 ? lo : hi) >> (p & 31)) & 1)) continue;
                    int prev;
                    if (k < 2) {
                        const unsigned below = lo & ((1u << p) - 1);
                        prev = below ? 31 - __clz(below) : 0;
                    } else {
                        const unsigned below = hi & ((1u << (p - 32)) - 1);
                        prev = below ? 63 - __clz(below) : (lo ? 31 - __clz(lo) : 0);
                    }
                    const int run = p - prev - 1;
                    const int v = half ? (w[k] >> 16) : static_cast<short>(w[k] & 0xFFFF);
                    atomicAdd(&h[16 + (((run & 15) << 4) | category(v))], 1);
                    zrl += run >> 4;
                }
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) x[u] = next[u];
        on = on_next;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        zrl += __shfl_xor_sync(FULL, zrl, d);
        eob += __shfl_xor_sync(FULL, eob, d);
    }
    if (lane == 0) {
        atomicAdd(&h[16 + 0xF0], zrl);
        atomicAdd(&h[16 + 0x00], eob);
    }
    __syncthreads();

    // the CTA's totals into the output, once the first CTA has zeroed it
    unsigned seen = tid == 0 ? *reinterpret_cast<volatile unsigned*>(flag) : ready;
    int t[(BINS + THREADS - 1) / THREADS];
#pragma unroll
    for (int r = 0; r * THREADS < BINS; ++r) {
        const int i = tid + r * THREADS;
        t[r] = 0;
        if (i < BINS)
#pragma unroll
            for (int w = 0; w < WARPS; ++w) t[r] += s_hist[w][i];
    }
    while (seen != ready) seen = *reinterpret_cast<volatile unsigned*>(flag);
    __syncthreads();
    __threadfence();
#pragma unroll
    for (int r = 0; r * THREADS < BINS; ++r)
        if (tid + r * THREADS < BINS && t[r]) atomicAdd(&out[tid + r * THREADS], t[r]);
}

}  // namespace

// Counts the first n_a int16 [64] blocks at a and the first n_b at b (b may
// be null when n_b is 0) into out int32 [272]: dc [16], then ac [256].
// state: 16 bytes (8-aligned), zeroed before its first call, kept between
// calls (a ticket count and an epoch, then the flag of the epoch whose
// output is zeroed); calls that share a state must run in turn (one
// stream).
extern "C" int dmmt_block_hist(const short* a, long long n_a, const short* b, long long n_b,
                               unsigned long long* state, int* out, void* stream) {
    if (n_a < 0 || n_b < 0 || (n_b > 0 && !b) || (n_a > 0 && !a) || !state || !out ||
        ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 1) ||
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
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_hist_kernel, THREADS, 0);
        if (err != cudaSuccess) return static_cast<int>(err);
        resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
    }
    const long long groups = (n_a + 3) / 4 + (n_b + 3) / 4;
    long long ctas = (groups + WARPS * UNROLL - 1) / (WARPS * UNROLL);
    if (ctas > resident[dev]) ctas = resident[dev];
    if (ctas < 1) ctas = 1;
    block_hist_kernel<<<static_cast<int>(ctas), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        a, n_a, b, n_b, state, out);
    return static_cast<int>(cudaGetLastError());
}
