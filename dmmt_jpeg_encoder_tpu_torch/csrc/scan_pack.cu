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
// Bound on the H100: 128 bytes of coefficients in and a few bytes of
// stream out per block; the work is integer bit manipulation and the
// serial dependency of every block's bit offset on all blocks before it.
// The TPU kernel carried that offset through its sequential grid in SMEM;
// here blocks run in parallel, so the offset becomes a device-wide
// exclusive scan, in three launches:
//   1. bits: one warp per block computes the block's bit length (tables
//      in shared memory) and each CTA reduces its CHUNK blocks to one sum;
//   2. scan: one CTA turns the chunk sums into exclusive chunk bases
//      (int64) and the total bit count;
//   3. emit: each CTA re-scans its chunk's block lengths in shared memory,
//      adds its chunk base, and one warp per block places every emission
//      with atomicOr into the zeroed output. Emissions occupy disjoint bit
//      ranges, so OR is exact; byte order commutes with OR, so each piece
//      is byte-swapped (__byte_perm) and OR-ed straight into memory order.
// Offsets are int64, so the stream may exceed 2^31 bits.
//
// Also replaces: dmmt_jpeg_encoder_tpu/bitstream/fused_pack.py :
// fused_pack_words_slab, B independent streams (one per image of a
// row-stacked slab) in one call, dmmt_scan_pack_slab. The three launches
// gain an image axis (gridDim.y in launches 1 and 3, one scan CTA per
// image in launch 2): image b reads its own [N, 64] blocks and its own four
// tables, and writes its own zeroed n_words region and total bit count, so
// each image's words equal a standalone dmmt_scan_pack bit for bit.
// dmmt_scan_pack is the case B = 1. The TPU kernel padded each image to
// whole grid tiles and staged compacted tables in SMEM; here a CTA simply
// never spans two images. Bound: the same bytes per block as above, B
// times; the 8 KB of tables are read once per CTA from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 256;            // blocks per CTA in launches 1 and 3
constexpr int SCAN_THREADS = 1024;    // launch 2
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(CHUNK == THREADS, "emit_kernel scans one block length per thread");

// (code << 8 | len) entries: DC tables [2][16], AC tables [2][256]
struct Tables {
    unsigned dc[2][16];
    unsigned ac[2][256];
};

// codes/lens: int32 [4][256] in the order luma DC, luma AC, chroma DC, chroma AC
__device__ void load_tables(Tables& t, const int* codes, const int* lens) {
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

// What one lane knows about its two positions p = lane and p = lane + 32 of
// a block, after the warp has looked at the whole block.
struct LaneBlock {
    int v[2];            // coefficient values
    int len[2];          // code + magnitude bits at p (DC at p = 0), 0 if none
    int zrl[2];          // ZRL codes before p
    unsigned long long mask;  // nonzero AC positions
};

__device__ __forceinline__ LaneBlock analyse(const short* blk, const Tables& t, int chroma, int lane) {
    LaneBlock lb;
    lb.v[0] = blk[lane];
    lb.v[1] = blk[lane + 32];
    const unsigned lo = __ballot_sync(FULL, lb.v[0] != 0) & ~1u;
    const unsigned hi = __ballot_sync(FULL, lb.v[1] != 0);
    lb.mask = (static_cast<unsigned long long>(hi) << 32) | lo;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int p = lane + 32 * h, v = lb.v[h];
        lb.len[h] = 0;
        lb.zrl[h] = 0;
        if (p == 0) {
            const int cat = category(v);
            lb.len[h] = static_cast<int>(t.dc[chroma][cat] & 0xFF) + cat;
        } else if (v != 0) {
            const unsigned long long below = lb.mask & ((1ull << p) - 1);
            const int prev = below ? 63 - __clzll(below) : 0;
            const int run = p - prev - 1, cat = category(v);
            lb.zrl[h] = run >> 4;
            lb.len[h] = static_cast<int>(t.ac[chroma][((run & 15) << 4) | cat] & 0xFF) + cat;
        }
    }
    return lb;
}

__device__ __forceinline__ int eob_len(const LaneBlock& lb, const Tables& t, int chroma) {
    const int last = lb.mask ? 63 - __clzll(lb.mask) : 0;
    return last < 63 ? static_cast<int>(t.ac[chroma][0x00] & 0xFF) : 0;
}

__device__ __forceinline__ int zrl_len(const Tables& t, int chroma) {
    return static_cast<int>(t.ac[chroma][0xF0] & 0xFF);
}

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, x, d);
        if (lane >= d) x += y;
    }
    return x;
}

__device__ __forceinline__ unsigned bswap(unsigned x) { return __byte_perm(x, 0, 0x0123); }

// OR `len` bits of `val` (right-aligned) into the stream at bit `pos`.
__device__ __forceinline__ void put(unsigned* words, long long n_words, long long pos,
                                    unsigned val, int len) {
    const long long w = pos >> 5;
    const int end = static_cast<int>(pos & 31) + len;
    if (end <= 32) {
        if (w < n_words) atomicOr(&words[w], bswap(val << (32 - end)));
    } else {
        const int spill = end - 32;
        if (w + 1 < n_words) {
            atomicOr(&words[w], bswap(val >> spill));
            atomicOr(&words[w + 1], bswap(val << (32 - spill)));
        }
    }
}

// ---- launch 1: per-block bit lengths + per-chunk sums ----------------------
__global__ void __launch_bounds__(THREADS)
bits_kernel(const short* __restrict__ scan, long long n, int stride, int lpm,
            const int* __restrict__ codes, const int* __restrict__ lens,
            int* __restrict__ block_bits, long long* __restrict__ chunk_sums) {
    __shared__ Tables t;
    __shared__ long long s_warp[WARPS];
    const long long img = blockIdx.y;  // image of a slab (0 for one stream)
    scan += img * n * 64;
    block_bits += img * n;
    chunk_sums += img * gridDim.x;
    load_tables(t, codes + img * 1024, lens + img * 1024);
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    long long sum = 0;
    for (int j = warp; j < CHUNK; j += WARPS) {
        const long long b = static_cast<long long>(blockIdx.x) * CHUNK + j;
        if (b >= n) break;
        const int chroma = (b % stride) >= lpm;
        const LaneBlock lb = analyse(scan + b * 64, t, chroma, lane);
        const int zl = zrl_len(t, chroma);
        int bits = lb.len[0] + lb.len[1] + (lb.zrl[0] + lb.zrl[1]) * zl;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) bits += __shfl_xor_sync(FULL, bits, d);
        bits += eob_len(lb, t, chroma);
        if (lane == 0) block_bits[b] = bits;
        sum += bits;
    }
    if (lane == 0) s_warp[warp] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long total = 0;
        for (int w = 0; w < WARPS; ++w) total += s_warp[w];
        chunk_sums[blockIdx.x] = total;
    }
}

// ---- launch 2: exclusive scan of the chunk sums (one CTA) ------------------
__global__ void __launch_bounds__(SCAN_THREADS)
chunk_scan_kernel(const long long* __restrict__ chunk_sums, long long n_chunks,
                  long long* __restrict__ chunk_base, long long* __restrict__ total_bits) {
    __shared__ long long s_warp[SCAN_THREADS / 32];
    __shared__ long long s_carry;
    const long long img = blockIdx.x;  // one CTA per image
    chunk_sums += img * n_chunks;
    chunk_base += img * n_chunks;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) s_carry = 0;
    __syncthreads();
    for (long long base = 0; base < n_chunks; base += SCAN_THREADS) {
        const long long i = base + tid;
        const long long x = i < n_chunks ? chunk_sums[i] : 0;
        long long inc = x;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const long long y = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc += y;
        }
        if (lane == 31) s_warp[warp] = inc;
        __syncthreads();
        if (warp == 0) {
            long long w = s_warp[lane];
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const long long y = __shfl_up_sync(FULL, w, d);
                if (lane >= d) w += y;
            }
            s_warp[lane] = w;  // inclusive over warps
        }
        __syncthreads();
        const long long warp_excl = warp ? s_warp[warp - 1] : 0;
        if (i < n_chunks) chunk_base[i] = s_carry + warp_excl + inc - x;
        __syncthreads();
        if (tid == 0) s_carry += s_warp[SCAN_THREADS / 32 - 1];
        __syncthreads();
    }
    if (tid == 0) total_bits[img] = s_carry;
}

// ---- launch 3: place every emission ----------------------------------------
__global__ void __launch_bounds__(THREADS)
emit_kernel(const short* __restrict__ scan, long long n, int stride, int lpm,
            const int* __restrict__ codes, const int* __restrict__ lens,
            const int* __restrict__ block_bits, const long long* __restrict__ chunk_base,
            unsigned* __restrict__ words, long long n_words) {
    __shared__ Tables t;
    __shared__ long long s_off[CHUNK];   // exclusive bit offset of each block in the chunk
    __shared__ long long s_warp[WARPS];
    const long long img = blockIdx.y;
    scan += img * n * 64;
    block_bits += img * n;
    chunk_base += img * gridDim.x;
    words += img * n_words;
    load_tables(t, codes + img * 1024, lens + img * 1024);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long b0 = static_cast<long long>(blockIdx.x) * CHUNK;

    // CTA exclusive scan of this chunk's block lengths (CHUNK == THREADS)
    const long long x = b0 + tid < n ? block_bits[b0 + tid] : 0;
    long long inc = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(FULL, inc, d);
        if (lane >= d) inc += y;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    long long warp_excl = 0;
    for (int w = 0; w < warp; ++w) warp_excl += s_warp[w];
    s_off[tid] = chunk_base[blockIdx.x] + warp_excl + inc - x;
    __syncthreads();

    for (int j = warp; j < CHUNK; j += WARPS) {
        const long long b = b0 + j;
        if (b >= n) break;
        const int chroma = (b % stride) >= lpm;
        const LaneBlock lb = analyse(scan + b * 64, t, chroma, lane);
        const int zl = zrl_len(t, chroma);
        const unsigned zcode = t.ac[chroma][0xF0] >> 8;
        // bit offsets within the block: positions 0..31 (first halves) in
        // lane order, then positions 32..63
        const int seg0 = lb.len[0] + lb.zrl[0] * zl, seg1 = lb.len[1] + lb.zrl[1] * zl;
        const int inc0 = warp_inclusive_scan(seg0, lane);
        const int total0 = __shfl_sync(FULL, inc0, 31);
        const int inc1 = warp_inclusive_scan(seg1, lane);
        const int total1 = __shfl_sync(FULL, inc1, 31);
        const long long base = s_off[j];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int p = lane + 32 * h, v = lb.v[h];
            long long pos = base + (h ? total0 + inc1 - seg1 : inc0 - seg0);
            if (p == 0) {
                const int cat = category(v);
                const unsigned e = t.dc[chroma][cat];
                put(words, n_words, pos, ((e >> 8) << cat) | pattern(v, cat),
                    static_cast<int>(e & 0xFF) + cat);
            } else if (v != 0) {
                for (int z = 0; z < lb.zrl[h]; ++z, pos += zl) put(words, n_words, pos, zcode, zl);
                const unsigned long long below = lb.mask & ((1ull << p) - 1);
                const int prev = below ? 63 - __clzll(below) : 0;
                const int run = p - prev - 1, cat = category(v);
                const unsigned e = t.ac[chroma][((run & 15) << 4) | cat];
                put(words, n_words, pos, ((e >> 8) << cat) | pattern(v, cat),
                    static_cast<int>(e & 0xFF) + cat);
            }
        }
        const int el = eob_len(lb, t, chroma);
        if (lane == 0 && el) put(words, n_words, base + total0 + total1, t.ac[chroma][0x00] >> 8, el);
    }
}

}  // namespace

namespace {

cudaError_t launch_pack(const short* scan, int n_images, long long n_blocks, int stride, int lpm,
                        const int* codes, const int* lens, int* block_bits,
                        long long* chunk_sums, long long* chunk_base, unsigned* words,
                        long long n_words, long long* total_bits, cudaStream_t s) {
    if (n_images < 1 || n_images > 65535 || n_blocks < 1 || stride < 1 || lpm < 1 || lpm > stride)
        return cudaErrorInvalidValue;
    const long long n_chunks = (n_blocks + CHUNK - 1) / CHUNK;
    const dim3 grid(static_cast<unsigned>(n_chunks), static_cast<unsigned>(n_images));
    bits_kernel<<<grid, THREADS, 0, s>>>(scan, n_blocks, stride, lpm, codes, lens, block_bits,
                                         chunk_sums);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    chunk_scan_kernel<<<n_images, SCAN_THREADS, 0, s>>>(chunk_sums, n_chunks, chunk_base,
                                                        total_bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    emit_kernel<<<grid, THREADS, 0, s>>>(scan, n_blocks, stride, lpm, codes, lens, block_bits,
                                         chunk_base, words, n_words);
    return cudaGetLastError();
}

}  // namespace

// scan: int16 [n_blocks, 64] in scan order; codes/lens: int32 [4, 256];
// block_bits: int32 scratch [n_blocks]; chunk_sums, chunk_base: int64 scratch
// [ceil(n_blocks / 256)]; words: uint32 [n_words], zeroed; total_bits: int64 [1].
extern "C" int dmmt_scan_pack(const short* scan, long long n_blocks, int stride, int lpm,
                              const int* codes, const int* lens, int* block_bits,
                              long long* chunk_sums, long long* chunk_base, unsigned* words,
                              long long n_words, long long* total_bits, void* stream) {
    return static_cast<int>(launch_pack(scan, 1, n_blocks, stride, lpm, codes, lens, block_bits,
                                        chunk_sums, chunk_base, words, n_words, total_bits,
                                        static_cast<cudaStream_t>(stream)));
}

// The slab form: scan int16 [n_images, n_blocks, 64]; codes/lens int32
// [n_images, 4, 256]; block_bits int32 [n_images, n_blocks]; chunk_sums,
// chunk_base int64 [n_images, ceil(n_blocks / 256)]; words uint32
// [n_images, n_words], zeroed (n_words per image); total_bits int64 [n_images].
extern "C" int dmmt_scan_pack_slab(const short* scan, int n_images, long long n_blocks,
                                   int stride, int lpm, const int* codes, const int* lens,
                                   int* block_bits, long long* chunk_sums, long long* chunk_base,
                                   unsigned* words, long long n_words, long long* total_bits,
                                   void* stream) {
    return static_cast<int>(launch_pack(scan, n_images, n_blocks, stride, lpm, codes, lens,
                                        block_bits, chunk_sums, chunk_base, words, n_words,
                                        total_bits, static_cast<cudaStream_t>(stream)));
}
