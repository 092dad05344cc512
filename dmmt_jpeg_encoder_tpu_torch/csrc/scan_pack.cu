// Huffman scan packing on Hopper: scan-order blocks -> MSB-first bitstream.
//
// Replaces: dmmt_jpeg_encoder_tpu/bitstream/fused_pack.py :
// fused_pack_words (Pallas kernel _make_kernel). Output contract as there
// and as device_pack.pack_to_words + byteswap_words: uint32 words in
// memory (big-endian stream) byte order, plus the total bit count. Per
// block (reference: src/image/writer/jpeg/encoder.rs:264-404): the DC
// codeword and magnitude bits, then for each nonzero AC its ZRL codes
// (one per 16 zeros) and its (run, category) codeword + magnitude bits,
// then EOB when the block ends in zeros. Block i uses the chroma tables
// iff i % stride >= lpm.
//
// Also replaces: dmmt_jpeg_encoder_tpu/bitstream/fused_pack.py :
// fused_pack_words_slab, B independent streams (one per image of a
// row-stacked slab) in one call, dmmt_scan_pack_slab: the launch gains an
// image axis (gridDim.y); image b reads its own [N, 64] blocks, its own
// four tables and `valid` row, and writes its own zeroed n_words region and
// total bit count, so each image's words equal a standalone dmmt_scan_pack
// bit for bit (dmmt_scan_pack is the case B = 1). A CTA never spans two
// images.
//
// Both take the TPU kernels' optional per-block `valid` mask (int32
// [n_blocks], or [n_images, n_blocks]; null for none): an invalid block
// contributes 0 bits and emits nothing (the sharded encode masks the
// alignment blocks that pad an image to whole MCU rows per shard).
//
// Bound on the H100: the coefficients (128 bytes a block) read once and the
// stream (~3 bytes a block on photographs) written once, so bytes: 24.9 MB
// in at 4K, 0.0076 ms at 3.35 TB/s; the zero fill of the worst-case word
// buffer (n_words = N * 64 + 2, in the wrapper) moves twice the bytes of
// the coefficients. The TPU kernel carried each block's bit offset through
// its sequential grid; here one launch of 128-block tiles runs a single
// pass with decoupled look-back: a CTA takes the next tile id from a
// counter (so every tile before it belongs to a CTA that is running or
// done), codes its tile, publishes the tile's bit count, sums the counts
// and prefixes of the tiles before it (one warp reads 32 at a time), and
// publishes its own prefix; the last tile writes the total bit count.
//
// The work is integer coding, not bytes, so the design spends instructions
// on nonzero coefficients only:
// - eight lanes share a block, each loading 8 consecutive zigzag
//   coefficients as one 16-byte load, so a warp holds 4 blocks and a thread
//   issues all four of its tile's loads before it looks at any (for the
//   tile of its block index, before the counter has answered; CTAs mostly
//   start in that order, and a CTA that got another tile loads again); the
//   8 lanes build the block's 64-bit nonzero mask with 3 shuffles;
// - each warp compacts its 4 blocks' items (the DC, each nonzero AC with
//   its run, the EOB) in stream order into shared memory (a warp scan of
//   the lanes' counts), then codes 32 items a round, one a lane: a
//   photograph's block has ~10 items of its 64 positions;
// - the emission pass codes the items again, a warp scan of their lengths
//   gives each its bit position, and each lane ORs its codeword (ZRLs
//   first) into a shared-memory copy of the tile's words; the CTA then
//   stores the words once, plain coalesced stores inside and a global
//   atomicOr only for the first and last word, which the neighbouring tiles
//   share. A tile whose words exceed the shared buffer (TILE_WORDS: blocks
//   near the 2048-bit worst case) ORs every word straight into device
//   memory instead; that branch is uniform over the CTA and both arms are
//   exact.
// Offsets are int64, so a stream may exceed 2^31 bits. Blocks that are not
// 16-byte aligned take 2-byte loads (a uniform branch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 8;                        // lanes per block, 8 coefficients each
constexpr int PER_PASS = THREADS / LANES;       // blocks per pass of the CTA
constexpr int TILE = 128;                       // blocks per CTA
constexpr int PASSES = TILE / PER_PASS;
constexpr int SEGMENTS = PASSES * WARPS;        // (pass, warp) runs of 4 blocks, in block order
constexpr int MAX_ITEMS = 4 * 64;               // items of one warp's 4 blocks, at most
constexpr int TILE_WORDS = 2048;                // the shared word buffer
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(SEGMENTS == 32, "one warp scans the segments");

// the look-back's tile states: 0 = not ready, else a flag and a bit count
constexpr unsigned long long AGGREGATE = 1ull << 62, INCLUSIVE = 2ull << 62;
constexpr unsigned long long VALUE = (1ull << 62) - 1;

// (code << 8 | len) entries: DC tables [2][16], AC tables [2][256]
struct Tables {
    unsigned dc[2][16];
    unsigned ac[2][256];
};

// codes/lens: int32 [4][256] in the order luma DC, luma AC, chroma DC,
// chroma AC; 16-byte loads where both are 16-byte aligned (THREADS >= 136)
__device__ void load_tables(Tables& t, const int* codes, const int* lens) {
    if (((reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(lens)) & 15) == 0) {
        const int i = threadIdx.x;
        if (i < 136) {  // 128 AC vectors, then 8 DC vectors
            const int c = i < 128 ? i / 64 : (i - 128) / 4, k = i < 128 ? i % 64 : (i - 128) % 4;
            const int src = (i < 128 ? (2 * c + 1) * 256 : 2 * c * 256) + 4 * k;
            const int4 cv = __ldg(reinterpret_cast<const int4*>(codes + src));
            const int4 lv = __ldg(reinterpret_cast<const int4*>(lens + src));
            unsigned* dst = i < 128 ? &t.ac[c][4 * k] : &t.dc[c][4 * k];
            dst[0] = (static_cast<unsigned>(cv.x) << 8) | static_cast<unsigned>(lv.x);
            dst[1] = (static_cast<unsigned>(cv.y) << 8) | static_cast<unsigned>(lv.y);
            dst[2] = (static_cast<unsigned>(cv.z) << 8) | static_cast<unsigned>(lv.z);
            dst[3] = (static_cast<unsigned>(cv.w) << 8) | static_cast<unsigned>(lv.w);
        }
        return;
    }
    for (int i = threadIdx.x; i < 2 * 256; i += blockDim.x) {
        const int c = i / 256, s = i % 256, src = (2 * c + 1) * 256 + s;
        t.ac[c][s] = (static_cast<unsigned>(codes[src]) << 8) | static_cast<unsigned>(lens[src]);
    }
    for (int i = threadIdx.x; i < 2 * 16; i += blockDim.x) {
        const int c = i / 16, s = i % 16, src = 2 * c * 256 + s;
        t.dc[c][s] = (static_cast<unsigned>(codes[src]) << 8) | static_cast<unsigned>(lens[src]);
    }
}

__device__ __forceinline__ int category(int v) { return 32 - __clz(v < 0 ? -v : v); }

// magnitude bits: v for v >= 0, one's complement of |v| for v < 0
__device__ __forceinline__ unsigned pattern(int v, int cat) {
    return static_cast<unsigned>(v >= 0 ? v : v + (1 << cat) - 1);
}

// coefficient j (0..7) of a lane's 16 bytes (j may be a run-time value)
__device__ __forceinline__ int coef(const int4& x, int j) {
    const int w = j < 4 ? (j < 2 ? x.x : x.y) : (j < 6 ? x.z : x.w);
    return (j & 1) ? (w >> 16) : static_cast<int>(static_cast<short>(w & 0xFFFF));
}

// Zigzag positions 8g .. 8g + 7 of a block: one 16-byte load, or eight
// 2-byte loads where the blocks are not 16-byte aligned.
__device__ __forceinline__ int4 load8(const short* blk, int g, bool aligned) {
    if (aligned) return __ldg(reinterpret_cast<const int4*>(blk) + g);
    int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        w[i] = static_cast<int>(static_cast<unsigned short>(__ldg(blk + 8 * g + 2 * i)) |
                                (static_cast<unsigned>(static_cast<unsigned short>(
                                     __ldg(blk + 8 * g + 2 * i + 1))) << 16));
    return make_int4(w[0], w[1], w[2], w[3]);
}

// An item of the stream: bits 0-15 the coefficient, 16-21 the zero run
// before it, 22 chroma, 23-24 the kind.
enum { AC = 0, DC = 1, EOB = 2 };

__device__ __forceinline__ unsigned make_item(int kind, int chroma, int run, int v) {
    return (static_cast<unsigned>(kind) << 23) | (static_cast<unsigned>(chroma) << 22) |
           (static_cast<unsigned>(run) << 16) | (static_cast<unsigned>(v) & 0xFFFFu);
}

// An item's codeword (right-aligned, magnitude bits included), its length,
// and the ZRL codes that go before it.
struct Code {
    unsigned val;
    int len, zrl;
};

__device__ __forceinline__ Code code_of(unsigned item, const Tables& t) {
    const int kind = item >> 23, ch = (item >> 22) & 1, run = (item >> 16) & 63;
    const int v = static_cast<short>(item & 0xFFFFu), cat = category(v);
    if (kind == EOB) {
        const unsigned e = t.ac[ch][0x00];
        return {e >> 8, static_cast<int>(e & 0xFF), 0};
    }
    const unsigned e = kind == DC ? t.dc[ch][cat] : t.ac[ch][((run & 15) << 4) | cat];
    return {((e >> 8) << cat) | pattern(v, cat), static_cast<int>(e & 0xFF) + cat, run >> 4};
}

__device__ __forceinline__ int zrl_len(const Tables& t, int ch) {
    return static_cast<int>(t.ac[ch][0xF0] & 0xFF);
}

// The bits an item takes in the stream.
__device__ __forceinline__ int bits_of(unsigned item, const Tables& t) {
    const Code c = code_of(item, t);
    return c.len + c.zrl * zrl_len(t, (item >> 22) & 1);
}

__device__ __forceinline__ unsigned bswap(unsigned x) { return __byte_perm(x, 0, 0x0123); }

struct SharedSink {  // word w of the stream is buf[w - first], logical (big-endian) order
    unsigned* buf;
    long long first;
    __device__ __forceinline__ void flush(long long w, unsigned x) const {
        if (x) atomicOr(&buf[w - first], x);
    }
};

struct GlobalSink {  // memory byte order, straight into the zeroed stream
    unsigned* words;
    long long n_words;
    __device__ __forceinline__ void flush(long long w, unsigned x) const {
        if (x && w < n_words) atomicOr(&words[w], bswap(x));
    }
};

// One item's emissions, gathered MSB first into a 64-bit window over words
// w and w + 1; a word is ORed out once the window has passed it.
template <class Sink>
struct Window {
    Sink sink;
    long long w;             // the window's first word
    unsigned long long win;
    int o;                   // bits of word w used, < 32 between puts

    __device__ __forceinline__ Window(Sink s, long long pos) : sink(s), w(pos >> 5), win(0),
                                                               o(static_cast<int>(pos & 31)) {}
    // `len` (<= 32) bits of val, right-aligned
    __device__ __forceinline__ void put(unsigned val, int len) {
        if (len == 0) return;
        win |= static_cast<unsigned long long>(val) << (64 - o - len);
        o += len;
        if (o >= 32) {
            sink.flush(w, static_cast<unsigned>(win >> 32));
            win <<= 32;
            ++w;
            o -= 32;
        }
    }
    __device__ __forceinline__ void finish() {
        if (o > 0) sink.flush(w, static_cast<unsigned>(win >> 32));
    }
};

// The items of one segment (a warp's 4 blocks of one pass), the first at
// bit `pos`: a lane codes items lane, lane + 32, ...; a warp scan of their
// lengths places them.
template <class Sink>
__device__ __forceinline__ void emit_segment(Sink sink, const unsigned* items, int n_items,
                                             long long pos, const Tables& t, int lane) {
    for (int r = 0; r < n_items; r += 32) {
        const int s = r + lane;
        const unsigned item = s < n_items ? items[s] : make_item(EOB, 0, 0, 0);
        const int ch = (item >> 22) & 1;
        const Code c = code_of(item, t);
        const int zl = zrl_len(t, ch);
        const int len = s < n_items ? c.len + c.zrl * zl : 0;
        int inc = len;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc += y;
        }
        if (len) {
            Window<Sink> out(sink, pos + inc - len);
            const unsigned zcode = t.ac[ch][0xF0] >> 8;
            for (int z = 0; z < c.zrl; ++z) out.put(zcode, zl);
            out.put(c.val, c.len);
            out.finish();
        }
        pos += __shfl_sync(FULL, inc, 31);
    }
}

// ---- the one launch --------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
pack_kernel(const short* __restrict__ scan, long long n, int stride, int lpm,
            const int* __restrict__ codes, const int* __restrict__ lens,
            const int* __restrict__ valid, unsigned long long* __restrict__ state,
            unsigned* __restrict__ words, long long n_words, long long* __restrict__ total_bits) {
    __shared__ Tables t;
    __shared__ unsigned s_items[SEGMENTS][MAX_ITEMS];
    __shared__ unsigned s_buf[TILE_WORDS];
    __shared__ int s_count[SEGMENTS];       // items of each segment
    __shared__ int s_off[SEGMENTS];         // bits of each segment, then its offset in the tile
    __shared__ long long s_tile, s_base;
    __shared__ int s_total;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = tid % LANES, q = tid / LANES;
    const long long img = blockIdx.y;
    const long long n_tiles = gridDim.x;
    state += img * (n_tiles + 1);        // the tiles' states, then the tile counter
    if (tid == 0) s_tile = static_cast<long long>(atomicAdd(&state[n_tiles], 1ull));
    scan += img * n * 64;
    if (valid) valid += img * n;
    words += img * n_words;
    // every pass's 16 bytes, all loads issued before any is used: for tile
    // blockIdx.x while the counter answers (CTAs mostly start in order),
    // again for the tile it gives where that differs
    const bool aligned = (reinterpret_cast<uintptr_t>(scan) & 15) == 0;
    int4 x[PASSES];
    bool on[PASSES];
    auto load_tile = [&](long long b0) {
#pragma unroll
        for (int it = 0; it < PASSES; ++it) {
            const long long b = b0 + it * PER_PASS + q;
            on[it] = b < n && (!valid || valid[b]);
            x[it] = on[it] ? load8(scan + b * 64, g, aligned) : make_int4(0, 0, 0, 0);
        }
    };
    load_tile(static_cast<long long>(blockIdx.x) * TILE);
    load_tables(t, codes + img * 1024, lens + img * 1024);
    __syncthreads();
    const long long tile = s_tile, b0 = tile * TILE;
    if (tile != blockIdx.x) load_tile(b0);
    const int r0 = static_cast<int>(b0 % stride);

    // 1. each warp's items in stream order, and their bits
#pragma unroll
    for (int it = 0; it < PASSES; ++it) {
        const int chroma = (r0 + it * PER_PASS + q) % stride >= lpm;
        unsigned m8 = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) m8 |= static_cast<unsigned>(coef(x[it], j) != 0) << j;
        if (g == 0) m8 &= ~1u;  // position 0 is the DC
        unsigned long long mask = static_cast<unsigned long long>(m8) << (8 * g);
#pragma unroll
        for (int d = 1; d < LANES; d <<= 1) mask |= __shfl_xor_sync(FULL, mask, d);
        if (g == 0) m8 |= 1u;   // the DC is always an item
        if (!on[it]) m8 = 0;
        const bool eob = on[it] && g == LANES - 1 && !(mask >> 63);
        const int count = __popc(m8) + eob;
        int inc = count;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc += y;
        }
        unsigned* items = s_items[it * WARPS + warp];
        int slot = inc - count;
        for (unsigned m = m8; m; m &= m - 1) {
            const int j = __ffs(m) - 1, p = 8 * g + j;
            const unsigned long long below = mask & ((1ull << p) - 1);
            const int run = p ? p - (below ? 63 - __clzll(below) : 0) - 1 : 0;
            items[slot++] = make_item(p ? AC : DC, chroma, run, coef(x[it], j));
        }
        if (eob) items[slot] = make_item(EOB, chroma, 0, 0);
        const int n_items = __shfl_sync(FULL, inc, 31);
        __syncwarp();
        int bits = 0;
        for (int s = lane; s < n_items; s += 32) bits += bits_of(items[s], t);
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) bits += __shfl_xor_sync(FULL, bits, d);
        if (lane == 0) {
            s_count[it * WARPS + warp] = n_items;
            s_off[it * WARPS + warp] = bits;
        }
    }
    __syncthreads();

    // 2. the segments' offsets in the tile; the tile's offset in the stream
    //    by decoupled look-back (warp 0)
    if (warp == 0) {
        const int bits = s_off[lane];
        int inc = bits;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc += y;
        }
        s_off[lane] = inc - bits;
        const int total = __shfl_sync(FULL, inc, 31);
        long long base = 0;
        if (tile == 0) {
            if (lane == 0) atomicExch(&state[0], INCLUSIVE | static_cast<unsigned long long>(total));
        } else {
            if (lane == 0) atomicExch(&state[tile], AGGREGATE | static_cast<unsigned long long>(total));
            long long k = tile - 1;  // the window's newest tile; lane l reads tile k - l
            while (true) {
                const long long i = k - lane;
                unsigned long long st = INCLUSIVE;  // before tile 0: a prefix of 0
                if (i >= 0) st = *reinterpret_cast<volatile unsigned long long*>(&state[i]);
                const unsigned inclusive = __ballot_sync(FULL, (st & INCLUSIVE) != 0);
                const unsigned waiting = __ballot_sync(FULL, st == 0);
                const int last = inclusive ? __ffs(inclusive) - 1 : 31;
                const unsigned needed = last == 31 ? FULL : (2u << last) - 1;
                if (waiting & needed) continue;  // a tile up to the first prefix has not published
                long long v = lane <= last ? static_cast<long long>(st & VALUE) : 0;
#pragma unroll
                for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
                base += v;
                if (inclusive) break;
                k -= 32;
            }
            if (lane == 0)
                atomicExch(&state[tile], INCLUSIVE | static_cast<unsigned long long>(base + total));
        }
        if (lane == 0) {
            s_base = base;
            s_total = total;
            if (tile == n_tiles - 1) total_bits[img] = base + total;
        }
    }
    __syncthreads();

    // 3. emission
    const long long base = s_base;
    const int total = s_total;
    if (total == 0) return;  // uniform: every block of the tile is invalid
    const long long first = base >> 5;
    const int count = static_cast<int>(((base + total - 1) >> 5) - first + 1);
    if (count <= TILE_WORDS) {
        for (int i = tid; i < count; i += THREADS) s_buf[i] = 0;
        __syncthreads();
        const SharedSink sink{s_buf, first};
#pragma unroll
        for (int it = 0; it < PASSES; ++it) {
            const int seg = it * WARPS + warp;
            emit_segment(sink, s_items[seg], s_count[seg], base + s_off[seg], t, lane);
        }
        __syncthreads();
        for (int i = tid; i < count; i += THREADS) {
            const long long w = first + i;
            const unsigned v = s_buf[i];
            if (w >= n_words) break;
            if (i == 0 || i == count - 1) {
                if (v) atomicOr(&words[w], bswap(v));  // shared with the neighbouring tiles
            } else {
                words[w] = bswap(v);
            }
        }
    } else {  // over-full tile: every word straight into device memory
        const GlobalSink sink{words, n_words};
#pragma unroll
        for (int it = 0; it < PASSES; ++it) {
            const int seg = it * WARPS + warp;
            emit_segment(sink, s_items[seg], s_count[seg], base + s_off[seg], t, lane);
        }
    }
}

cudaError_t launch_pack(const short* scan, int n_images, long long n_blocks, int stride, int lpm,
                        const int* codes, const int* lens, const int* valid,
                        unsigned long long* state, unsigned* words, long long n_words,
                        long long* total_bits, cudaStream_t s) {
    if (n_images < 1 || n_images > 65535 || n_blocks < 1 || stride < 1 || lpm < 1 || lpm > stride)
        return cudaErrorInvalidValue;
    const long long n_tiles = (n_blocks + TILE - 1) / TILE;
    if (n_tiles > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(n_images));
    pack_kernel<<<grid, THREADS, 0, s>>>(scan, n_blocks, stride, lpm, codes, lens, valid, state,
                                         words, n_words, total_bits);
    return cudaGetLastError();
}

}  // namespace

// scan: int16 [n_blocks, 64] in scan order; codes/lens: int32 [4, 256];
// valid: int32 [n_blocks] (nonzero = packed) or null; state: int64 scratch
// [ceil(n_blocks / 128) + 1], zeroed; words: uint32 [n_words], zeroed;
// total_bits: int64 [1].
extern "C" int dmmt_scan_pack(const short* scan, long long n_blocks, int stride, int lpm,
                              const int* codes, const int* lens, const int* valid,
                              unsigned long long* state, unsigned* words, long long n_words,
                              long long* total_bits, void* stream) {
    return static_cast<int>(launch_pack(scan, 1, n_blocks, stride, lpm, codes, lens, valid, state,
                                        words, n_words, total_bits,
                                        static_cast<cudaStream_t>(stream)));
}

// The slab form: scan int16 [n_images, n_blocks, 64]; codes/lens int32
// [n_images, 4, 256]; valid int32 [n_images, n_blocks] or null; state int64
// [n_images, ceil(n_blocks / 128) + 1], zeroed; words uint32 [n_images,
// n_words], zeroed (n_words per image); total_bits int64 [n_images].
extern "C" int dmmt_scan_pack_slab(const short* scan, int n_images, long long n_blocks,
                                   int stride, int lpm, const int* codes, const int* lens,
                                   const int* valid, unsigned long long* state, unsigned* words,
                                   long long n_words, long long* total_bits, void* stream) {
    return static_cast<int>(launch_pack(scan, n_images, n_blocks, stride, lpm, codes, lens, valid,
                                        state, words, n_words, total_bits,
                                        static_cast<cudaStream_t>(stream)));
}
