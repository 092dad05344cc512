// The pixel strips of the two fused phase-1 kernels (phase1.cu, the Arai
// DCT; fused_phase1.cu, the matmul DCT): one CTA of STRIP_THREADS threads
// owns STRIP_PIXELS pixels along one MCU row (P420 8 MCUs, 128 x 16; P422
// 16 MCUs, 256 x 8; P444 32 MCUs, 256 x 8), so each pixel row it reads is
// 384 or 768 contiguous bytes (twice that for 16-bit samples).
// load_strip_rows brings them into shared memory as 16-byte chunks; a chunk
// that crosses the ends of the image takes byte loads, so any width and any
// alignment work. Row r's first sample lands at byte (its address mod 16)
// of its raw row: strip_row(s_raw, ...) finds it. A sample past H or W is
// never read: the kernels take it as 0 (black padding).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dmmt {

constexpr int STRIP_THREADS = 128;
constexpr int STRIP_PIXELS = 2048;
constexpr int BLOCK_PITCH = 9;   // floats per row of a shared 8 x 8 block

// The strip's geometry for sampling rates HR x VR and T-sized samples.
template <int HR, int VR, typename T>
struct Strip {
    static constexpr int MW = 8 * HR, MH = 8 * VR, LPM = HR * VR;
    static constexpr int SW = STRIP_PIXELS / MH;          // strip width, pixels
    static constexpr int S = SW / MW;                     // MCUs per strip
    static constexpr int NBX = SW / 8;                    // luma blocks across
    static constexpr int NL = VR * NBX;                   // luma blocks (= S * LPM)
    static constexpr int NB = NL + 2 * S;                 // all blocks
    static constexpr int UNITS = STRIP_PIXELS / LPM / STRIP_THREADS;  // subsample units per thread
    static constexpr int ITEMS = NB * 8 / STRIP_THREADS;  // block rows (columns) per thread
    static constexpr int ROW_BYTES = SW * 3 * static_cast<int>(sizeof(T));
    static constexpr int RAW_PITCH = ROW_BYTES + 32;      // room for a 16-byte head and tail
    static constexpr int CHUNKS = ROW_BYTES / 16 + 2;     // 16-byte chunks a row can touch
    static_assert(STRIP_PIXELS % (LPM * STRIP_THREADS) == 0 && (NB * 8) % STRIP_THREADS == 0,
                  "even work");
    static_assert(ROW_BYTES % 16 == 0, "16-byte rows");
};

// The address of pixel (row, col) of an [height, width, 3] image.
template <typename T>
__device__ __forceinline__ uintptr_t pixel_addr(const T* rgb, int width, int row, int col) {
    return reinterpret_cast<uintptr_t>(rgb) +
           (static_cast<size_t>(row) * width + col) * 3 * sizeof(T);
}

// The strip's MH rows from (row0, col0), n_px pixels each (n_px > 0), into
// s_raw (MH raw rows of RAW_PITCH bytes, 16-byte aligned); every thread of
// the CTA calls it. No barrier: the caller synchronizes before reading.
template <typename G, typename T>
__device__ __forceinline__ void load_strip_rows(unsigned char* s_raw, const T* rgb, int height,
                                                int width, int row0, int col0, int n_px) {
    const uintptr_t img_begin = reinterpret_cast<uintptr_t>(rgb);
    const uintptr_t img_end = img_begin + static_cast<size_t>(height) * width * 3 * sizeof(T);
    for (int i = threadIdx.x; i < G::MH * G::CHUNKS; i += STRIP_THREADS) {
        const int r = i / G::CHUNKS, c = i % G::CHUNKS;
        if (row0 + r >= height) continue;
        const uintptr_t start = pixel_addr(rgb, width, row0 + r, col0);
        const uintptr_t a = (start & ~uintptr_t(15)) + 16 * c;
        if (a >= start + static_cast<uintptr_t>(n_px) * 3 * sizeof(T)) continue;
        unsigned char* dst = s_raw + r * G::RAW_PITCH + 16 * c;
        if (a >= img_begin && a + 16 <= img_end) {
            *reinterpret_cast<int4*>(dst) = __ldg(reinterpret_cast<const int4*>(a));
        } else {
            for (int j = 0; j < 16; ++j)
                if (a + j >= img_begin && a + j < img_end)
                    dst[j] = __ldg(reinterpret_cast<const unsigned char*>(a + j));
        }
    }
}

// Row r's first sample in s_raw, as load_strip_rows placed it.
template <typename G, typename T>
__device__ __forceinline__ const unsigned char* strip_row(const unsigned char* s_raw, const T* rgb,
                                                          int width, int row0, int col0, int r) {
    return s_raw + r * G::RAW_PITCH + (pixel_addr(rgb, width, row0 + r, col0) & 15);
}

}  // namespace dmmt
