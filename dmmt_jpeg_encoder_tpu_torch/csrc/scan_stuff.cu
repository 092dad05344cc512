// JPEG byte stuffing on Hopper, behind the scan pack: packed words ->
// the final entropy-coded bytes, in the word buffer's own tail.
//
// Replaces no TPU kernel: the JAX package stuffs on the host
// (bitstream/device_pack.py : finalize_scan_bytes), and so did the port.
// Here the stream the scan pack wrote (uint32 words in memory byte order,
// total_bits of them) is 1-padded (the bits after total_bits in the last
// byte set, reference encoder.rs:267) and stuffed (a 0x00 after every
// 0xFF, segment_marker_injector.rs:14-30) into the tail of the same
// buffer, so the host fetches final bytes and only copies them.
//
// Layout of one row of row_bytes bytes (a word buffer, or one image's row
// of a slab's [B, n_words] buffer), which bitstream/scan_stuff.py's
// tail_layout mirrors:
//   [0, n_bytes)              the packed stream, n_bytes = ceil(total_bits / 8)
//   [start, start + length)   the stuffed stream, start = n_bytes rounded up to 16
//   [state_off, row_bytes)    int64: n_cap chunk states, the chunk counter,
//                             and last the stuffed length (-1: the tail was
//                             too short, the host stuffs the raw stream)
// n_cap = ceil((row_bytes / 2) / CHUNK) and state_off = row_bytes - 8 *
// (n_cap + 2). The stuffed stream must end by state_off; where even the
// raw length does not fit there, no chunk runs (so n_bytes <= row_bytes /
// 2 and at most n_cap chunks), and where the stuffed one does not, the
// chunks whose output would pass state_off write nothing. A word buffer
// holds the worst case of 64 words a block, about 100 times a photograph's
// stream, so the tail is short only for a stream of some 16 bits a pixel.
// The row must be zero past the stream (the scan pack's zero fill of the
// whole buffer): chunks OR the words they share.
//
// Bound on the H100: the stream read once and the stuffed stream written
// once, ~2 x 0.53 MB at 4K (0.0003 ms at 3.35 TB/s), ~2 x 30 MB for a
// 21600x21600 tile (0.018 ms). One launch of a fixed grid sized for the
// buffer's capacity (at most GRID CTAs a row) that takes CHUNK-byte chunks
// from a counter until the stream (total_bits, read on the device) ends,
// so a replay needs no host value: most CTAs of a capture sized for the
// worst case take no chunk. A chunk's output offset is the sum of the
// stuffed lengths of the chunks before it, by decoupled look-back as in
// scan_pack.cu: a CTA publishes its chunk's length, then one warp sums
// the lengths and prefixes of the chunks before it, 32 at a time. Each
// thread reads 16 bytes as four words and counts their 0xFF bytes; a
// block scan of the counts places every thread's bytes in a shared-memory
// copy of the chunk's output words, which the CTA stores with plain
// coalesced stores inside and atomicOr on the first and last word, which
// the neighbouring chunks share. Offsets are int64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BYTES = 16;                        // stream bytes a thread reads
constexpr int CHUNK = THREADS * BYTES;           // stream bytes a chunk
constexpr int OUT_WORDS = (2 * CHUNK + 3) / 4 + 1;  // a chunk's output words, at most
constexpr int GRID = 512;                        // CTAs a row, at most
constexpr unsigned FULL = 0xFFFFFFFFu;

constexpr unsigned long long AGGREGATE = 1ull << 62, INCLUSIVE = 2ull << 62;
constexpr unsigned long long VALUE = (1ull << 62) - 1;

__host__ __device__ __forceinline__ long long chunk_states(long long row_bytes) {
    return (row_bytes / 2 + CHUNK - 1) / CHUNK;
}

__global__ void __launch_bounds__(THREADS)
stuff_kernel(unsigned char* __restrict__ buf, long long row_bytes,
             const long long* __restrict__ total_bits) {
    __shared__ unsigned s_out[OUT_WORDS];
    __shared__ int s_warp[WARPS];
    __shared__ long long s_chunk, s_base;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    unsigned char* row = buf + blockIdx.y * row_bytes;
    unsigned* words = reinterpret_cast<unsigned*>(row);
    const long long n_cap = chunk_states(row_bytes);
    const long long state_off = row_bytes - 8 * (n_cap + 2);
    unsigned long long* state = reinterpret_cast<unsigned long long*>(row + state_off);
    long long* length = reinterpret_cast<long long*>(row + row_bytes - 8);

    const long long bits = total_bits[blockIdx.y];
    const long long n_bytes = (bits + 7) >> 3;
    const long long start = (n_bytes + 15) & ~15ll;
    if (start + n_bytes > state_off) {  // the tail cannot hold even the raw stream
        if (blockIdx.x == 0 && tid == 0) *length = -1;
        return;
    }
    const long long n_chunks = (n_bytes + CHUNK - 1) / CHUNK;
    if (n_chunks == 0) {
        if (blockIdx.x == 0 && tid == 0) *length = 0;
        return;
    }
    const int pad = static_cast<int>(n_bytes * 8 - bits);

    while (true) {
        if (tid == 0) s_chunk = static_cast<long long>(atomicAdd(&state[n_cap], 1ull));
        __syncthreads();
        const long long chunk = s_chunk;
        if (chunk >= n_chunks) return;  // uniform

        // 1. this thread's bytes (those past the stream absent), padded, and
        //    their stuffed length
        const long long first = chunk * CHUNK + static_cast<long long>(tid) * BYTES;
        const int valid = static_cast<int>(n_bytes - first < 0 ? 0
                                           : n_bytes - first > BYTES ? BYTES : n_bytes - first);
        unsigned w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = 4 * k < valid ? words[(first >> 2) + k] : 0u;
        if (valid > 0 && first + valid == n_bytes && pad) {  // the stream's last byte
            const int j = valid - 1;
            w[j >> 2] |= ((1u << pad) - 1) << (8 * (j & 3));
        }
        int count = valid;
#pragma unroll
        for (int j = 0; j < BYTES; ++j)
            count += j < valid && ((w[j >> 2] >> (8 * (j & 3))) & 0xFF) == 0xFF;

        // 2. the threads' offsets in the chunk (a block scan), the chunk's length
        int inc = count;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc += y;
        }
        if (lane == 31) s_warp[warp] = inc;
        __syncthreads();
        int before = 0, total = 0;
#pragma unroll
        for (int i = 0; i < WARPS; ++i) {
            before += i < warp ? s_warp[i] : 0;
            total += s_warp[i];
        }
        const int off = before + inc - count;

        // 3. the chunk's offset in the stuffed stream: decoupled look-back (warp 0)
        if (warp == 0) {
            long long base = 0;
            if (chunk == 0) {
                if (lane == 0) atomicExch(&state[0], INCLUSIVE | static_cast<unsigned long long>(total));
            } else {
                if (lane == 0)
                    atomicExch(&state[chunk], AGGREGATE | static_cast<unsigned long long>(total));
                long long k = chunk - 1;  // the window's newest chunk; lane l reads chunk k - l
                while (true) {
                    const long long i = k - lane;
                    unsigned long long st = INCLUSIVE;  // before chunk 0: a prefix of 0
                    if (i >= 0) st = *reinterpret_cast<volatile unsigned long long*>(&state[i]);
                    const unsigned inclusive = __ballot_sync(FULL, (st & INCLUSIVE) != 0);
                    const unsigned waiting = __ballot_sync(FULL, st == 0);
                    const int last = inclusive ? __ffs(inclusive) - 1 : 31;
                    const unsigned needed = last == 31 ? FULL : (2u << last) - 1;
                    if (waiting & needed) continue;  // a chunk up to the first prefix has not published
                    long long v = lane <= last ? static_cast<long long>(st & VALUE) : 0;
#pragma unroll
                    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
                    base += v;
                    if (inclusive) break;
                    k -= 32;
                }
                if (lane == 0)
                    atomicExch(&state[chunk], INCLUSIVE | static_cast<unsigned long long>(base + total));
            }
            if (lane == 0) {
                s_base = base;
                if (chunk == n_chunks - 1)
                    *length = start + base + total <= state_off ? base + total : -1;
            }
        }
        __syncthreads();

        // 4. the chunk's output words in shared memory, then out
        const long long at = start + s_base;       // the chunk's first output byte
        const bool fits = at + total <= state_off;  // uniform
        const int lead = static_cast<int>(at & 3);
        const int n_out = (lead + total + 3) / 4;
        if (fits) {
            for (int i = tid; i < n_out; i += THREADS) s_out[i] = 0;
            __syncthreads();
            unsigned char* out = reinterpret_cast<unsigned char*>(s_out) + lead + off;
            for (int j = 0; j < valid; ++j) {
                const unsigned b = (w[j >> 2] >> (8 * (j & 3))) & 0xFF;
                *out++ = static_cast<unsigned char>(b);
                if (b == 0xFF) ++out;  // the stuffed 0x00: already zero
            }
            __syncthreads();
            unsigned* dst = words + (at >> 2);
            for (int i = tid; i < n_out; i += THREADS) {
                const unsigned v = s_out[i];
                if (i == 0 || i == n_out - 1) {
                    if (v) atomicOr(&dst[i], v);  // shared with the neighbouring chunks
                } else {
                    dst[i] = v;
                }
            }
        }
        __syncthreads();  // s_out and s_chunk are reused by the next chunk
    }
}

}  // namespace

// buf: n_images rows of row_bytes bytes (row_bytes a multiple of 8, the
// rows 8-byte aligned), each a scan pack's word buffer, zero past its
// stream; total_bits: int64 [n_images], on the device. Writes each row's
// stuffed stream and length into its tail (see the layout above).
extern "C" int dmmt_scan_stuff(unsigned char* buf, int n_images, long long row_bytes,
                               const long long* total_bits, void* stream) {
    if (n_images < 1 || n_images > 65535 || row_bytes < 8 || row_bytes % 8 ||
        reinterpret_cast<uintptr_t>(buf) % 8 || row_bytes - 8 * (chunk_states(row_bytes) + 2) < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long n_cap = chunk_states(row_bytes);
    const dim3 grid(static_cast<unsigned>(n_cap < GRID ? (n_cap < 1 ? 1 : n_cap) : GRID),
                    static_cast<unsigned>(n_images));
    stuff_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(buf, row_bytes,
                                                                          total_bits);
    return static_cast<int>(cudaGetLastError());
}
