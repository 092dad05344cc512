// Emission triples -> big-endian 32-bit stream words on Hopper.
//
// Replaces: dmmt_jpeg_encoder_tpu/bitstream/pallas_pack.py :
// pallas_pack_words, both of its Pallas kernels: _fragment_kernel (each
// block's emissions placed into a private 72-word fragment, pre-shifted by
// the block's bit phase) and _merge_kernel (a sequential monotone merge of
// the fragments into the stream). Contract as device_pack.pack_to_words:
// emission e of block b holds lens[b, e] (0..32) bits of values[b, e]
// (right-aligned) at stream bit boff[b] + offs[b, e], most significant bit
// first; words are the logical big-endian uint32 words (int32 bit
// patterns), before the byte swap to memory order. Pieces that land at or
// past word n_words are dropped, as the TPU wrapper's scatter drops them.
// boff is nondecreasing and the blocks' bit ranges are disjoint (block b's
// emissions lie in [boff[b], boff[b + 1])), so OR equals the TPU kernel's
// add, and the result does not depend on the order of the threads.
//
// Bound on the H100: reading every slot's length (272 bytes a block: 52.9
// MB of the 4K frame's 84 MB), the values and offsets only in the 32-byte
// sectors that hold a live slot (lens > 0; most AC slots are empty), boff,
// and writing the words once; chip_smoke.py counts these on its inputs.
// The fragment/merge split existed only because Mosaic has no scatter.
// Design (the scan-pack kernel's tile machinery, csrc/scan_pack.cu):
// - one CTA per tile of 32 consecutive blocks (small tiles keep many CTAs
//   in flight through the tile's two dependent rounds of loads); boff is
//   nondecreasing, so the tile owns the contiguous bit range [boff[first
//   block], boff[first block of the next tile]), the last tile's end being
//   boff[N - 1] + block_bits[N - 1], which that tile also writes as the
//   stream's total bit count (so the wrapper runs no kernel of its own
//   around the launch but the zero fill);
// - 272 threads (17 x 16): thread t reads 16-byte chunk t % 17 of the
//   length rows of blocks t / 17 and t / 17 + 16, both loads issued before
//   it looks at either; a chunk with a live slot loads its values and
//   offsets as one 16-byte load each, so empty chunks cost no more reads;
// - each live slot's one or two word pieces are ORed into a shared-memory
//   window of the tile's words (pieces of one thread that fall in the same
//   word are ORed in a register first); after one barrier the window goes
//   to the stream once, coalesced plain stores for its interior words and
//   a global atomicOr only for its first and last word, which the
//   neighbouring tiles may share;
// - a tile whose range exceeds the window (TILE_WORDS: blocks near the
//   2048-bit worst case, or a gap between images wider than the window)
//   ORs every piece straight into device memory instead; that branch is
//   uniform over the CTA and both arms are exact.
// Rows that are not 16-byte aligned take 4-byte loads (a uniform template
// arm). Offsets are int64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLOTS = 68;                    // 1 DC + 63 AC + 3 ZRL + 1 EOB per block
constexpr int CHUNKS = SLOTS / 4;            // 16-byte chunks of a block's row
constexpr int ROWS = 16;                     // blocks per pass of the CTA
constexpr int THREADS = CHUNKS * ROWS;       // 272
constexpr int PASSES = 2;
constexpr int TILE = ROWS * PASSES;          // blocks per CTA
constexpr int TILE_WORDS = 1024;             // the shared word window

// a 16-byte chunk of a row: four consecutive slots
template <bool VEC>
__device__ __forceinline__ int4 load4(const int* p) {
    if (VEC) return __ldg(reinterpret_cast<const int4*>(p));
    return make_int4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// Word pieces of one thread, ORed in a register while they fall in one
// word, then into the tile's shared window (or, outside it, the stream).
struct Pieces {
    unsigned* window;    // null: every piece straight into the stream
    long long first, count;
    unsigned* words;
    long long n_words;
    long long w = -1;
    unsigned x = 0;

    __device__ __forceinline__ void flush() const {
        if (x == 0) return;
        if (window && w >= first && w < first + count)
            atomicOr(&window[w - first], x);
        else if (w < n_words)
            atomicOr(&words[w], x);
    }
    __device__ __forceinline__ void put(long long word, unsigned bits) {
        if (word != w) {
            flush();
            w = word;
            x = 0;
        }
        x |= bits;
    }
    // `len` (1..32) bits of val, right-aligned, at stream bit pos
    __device__ __forceinline__ void emit(long long pos, int len, unsigned val) {
        const long long w0 = pos >> 5;
        const int end = static_cast<int>(pos & 31) + len;  // <= 63
        if (end <= 32) {
            put(w0, val << (32 - end));
        } else {
            // spill is in 1..31, so neither shift reaches 32 (undefined in C)
            const int spill = end - 32;
            put(w0, val >> spill);
            put(w0 + 1, val << (32 - spill));
        }
    }
};

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
pack_kernel(const int* __restrict__ values, const int* __restrict__ lens,
            const int* __restrict__ offs, const long long* __restrict__ boff,
            const int* __restrict__ block_bits, long long n_blocks, unsigned* __restrict__ words,
            long long n_words, long long* __restrict__ total_bits) {
    __shared__ unsigned s_window[TILE_WORDS];
    __shared__ long long s_boff[TILE];
    const int tid = threadIdx.x;
    const long long b0 = static_cast<long long>(blockIdx.x) * TILE;
    const int nb = static_cast<int>(min(static_cast<long long>(TILE), n_blocks - b0));
    const int chunk = tid % CHUNKS, row = tid / CHUNKS;

    int4 ln[PASSES];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
        const int blk = row + p * ROWS;
        ln[p] = blk < nb ? load4<VEC>(lens + (b0 + blk) * SLOTS + chunk * 4) : make_int4(0, 0, 0, 0);
    }
    if (tid < nb) s_boff[tid] = __ldg(boff + b0 + tid);
    const long long lo = __ldg(boff + b0);
    const long long hi = b0 + TILE < n_blocks ? __ldg(boff + b0 + TILE)
                                              : __ldg(boff + n_blocks - 1) + __ldg(block_bits + n_blocks - 1);
    if (b0 + TILE >= n_blocks && tid == 0) *total_bits = hi;
    const long long first = lo >> 5;
    const long long count = hi > lo ? ((hi - 1) >> 5) - first + 1 : 0;
    const bool shared = count > 0 && count <= TILE_WORDS;  // uniform over the CTA
    if (shared)
        for (int i = tid; i < count; i += THREADS) s_window[i] = 0;
    __syncthreads();

    Pieces out{shared ? s_window : nullptr, first, count, words, n_words};
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
        const int4 l = ln[p];
        if (max(max(l.x, l.y), max(l.z, l.w)) <= 0) continue;
        const long long slot = (b0 + row + p * ROWS) * SLOTS + chunk * 4;
        const int4 v = load4<VEC>(values + slot);
        const int4 o = load4<VEC>(offs + slot);
        const long long base = s_boff[row + p * ROWS];
        if (l.x > 0) out.emit(base + o.x, l.x, static_cast<unsigned>(v.x));
        if (l.y > 0) out.emit(base + o.y, l.y, static_cast<unsigned>(v.y));
        if (l.z > 0) out.emit(base + o.z, l.z, static_cast<unsigned>(v.z));
        if (l.w > 0) out.emit(base + o.w, l.w, static_cast<unsigned>(v.w));
    }
    out.flush();
    if (!shared) return;  // uniform
    __syncthreads();
    // the window to the stream: a photograph's tile of ~22 words is one
    // coalesced 4-byte store per thread of its first warp
    for (int i = tid; i < count; i += THREADS) {
        const long long w = first + i;
        if (w >= n_words) break;
        const unsigned x = s_window[i];
        if (i == 0 || i == count - 1) {
            if (x) atomicOr(&words[w], x);  // shared with the neighbouring tiles
        } else {
            words[w] = x;
        }
    }
}

}  // namespace

// values, lens, offs: int32 [n_blocks, 68]; boff: int64 [n_blocks], each
// block's stream bit offset, nondecreasing; block_bits: int32 [n_blocks];
// words: uint32 [n_words], zeroed; total_bits: int64 [1], set to
// boff[n_blocks - 1] + block_bits[n_blocks - 1].
extern "C" int dmmt_pack_emissions(const int* values, const int* lens, const int* offs,
                                   const long long* boff, const int* block_bits, long long n_blocks,
                                   unsigned* words, long long n_words, long long* total_bits,
                                   void* stream) {
    if (n_blocks < 1 || n_words < 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long ctas = (n_blocks + TILE - 1) / TILE;
    if (ctas > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = ((reinterpret_cast<uintptr_t>(values) | reinterpret_cast<uintptr_t>(lens) |
                       reinterpret_cast<uintptr_t>(offs)) & 15) == 0;
    if (vec)
        pack_kernel<true><<<static_cast<unsigned>(ctas), THREADS, 0, s>>>(
            values, lens, offs, boff, block_bits, n_blocks, words, n_words, total_bits);
    else
        pack_kernel<false><<<static_cast<unsigned>(ctas), THREADS, 0, s>>>(
            values, lens, offs, boff, block_bits, n_blocks, words, n_words, total_bits);
    return static_cast<int>(cudaGetLastError());
}
