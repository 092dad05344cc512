// Per-group small-table lookup on Hopper.
//
// Replaces: dmmt_jpeg_encoder_tpu/ops/pallas_lookup.py :
// pallas_table_lookup (Pallas kernel _lookup_kernel, the one-group form)
// and pallas_table_lookup_grouped (_lookup_kernel_grouped). For each group
// g: out[g, i] = tables[g, symbols[g, i]] for a symbol in [0, t), and 0
// otherwise, as the TPU kernel's compare-and-select sweep gives 0 for a
// symbol that matches no entry. Entries are the combined (code << 8 | len)
// words, below 2^24, held in int32.
//
// Bound on the H100: reading 4 bytes and writing 4 bytes per entry, so the
// memory rate. The TPU swept the T table entries once per tile (a gather
// serializes there); here each CTA stages its group's <= 512-entry table in
// shared memory once and every thread reads its entries' codewords from it.
// Design, to keep enough bytes in flight to reach the memory rate:
// - each thread issues UNROLL independent 16-byte (int4) symbol loads
//   before it looks any of them up, then writes int4s; both streaming
//   (evict-first), since nothing reads them again soon;
// - the vector loop runs on each group's 16-byte-aligned interior; a
//   scalar head and tail (at most three entries each) cover a row base
//   that is not aligned, which happens whenever G > 1 and m % 4 != 0;
//   where the symbols and the output are not aligned alike, every entry
//   takes the scalar loop;
// - the grid is what the card holds at once (SMs x resident CTAs), shared
//   out over the groups, and no larger than the work needs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // int4 symbol loads in flight per thread
constexpr int MAX_T = 512;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ int look(const int* tab, int s, int t) {
    return static_cast<unsigned>(s) < static_cast<unsigned>(t) ? tab[s] : 0;
}

__global__ void __launch_bounds__(THREADS)
lookup_kernel(const int* __restrict__ symbols, const int* __restrict__ tables, long long m, int t,
              int* __restrict__ out, bool vec) {
    __shared__ int s_tab[MAX_T];
    const long long g = blockIdx.y;
    for (int i = threadIdx.x; i < t; i += THREADS) s_tab[i] = tables[g * t + i];
    __syncthreads();
    symbols += g * m;
    out += g * m;
    // [0, head) and [tail, m) scalar, [head, tail) as n4 int4s
    const long long head =
        vec ? min(m, static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(symbols) & 15)) & 15) / 4) : 0;
    const long long n4 = vec ? (m - head) / 4 : 0;
    const long long tail = head + 4 * n4;
    const long long threads = static_cast<long long>(gridDim.x) * THREADS;
    const long long n_scalar = head + (m - tail);
    for (long long k = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; k < n_scalar; k += threads) {
        const long long i = k < head ? k : tail + (k - head);
        out[i] = look(s_tab, symbols[i], t);
    }
    const int4* s4 = reinterpret_cast<const int4*>(symbols + head);
    int4* o4 = reinterpret_cast<int4*>(out + head);
    for (long long base = static_cast<long long>(blockIdx.x) * THREADS * UNROLL + threadIdx.x; base < n4;
         base += threads * UNROLL) {
        int4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            if (base + u * THREADS < n4) v[u] = __ldcs(s4 + base + u * THREADS);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            if (base + u * THREADS < n4)
                __stcs(o4 + base + u * THREADS, make_int4(look(s_tab, v[u].x, t), look(s_tab, v[u].y, t),
                                                          look(s_tab, v[u].z, t), look(s_tab, v[u].w, t)));
    }
}

// CTAs the card holds at once (SMs x resident CTAs), per device; 0 on failure.
int resident_ctas(int dev) {
    static int cached[MAX_DEVICES] = {0};
    if (dev >= 0 && dev < MAX_DEVICES && cached[dev] > 0) return cached[dev];
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lookup_kernel, THREADS, 0) != cudaSuccess ||
        per_sm < 1)
        return 0;
    if (dev >= 0 && dev < MAX_DEVICES) cached[dev] = sms * per_sm;
    return sms * per_sm;
}

}  // namespace

// symbols: int32 [n_groups, m]; tables: int32 [n_groups, t]; out: int32 [n_groups, m].
extern "C" int dmmt_table_lookup_grouped(const int* symbols, const int* tables, int n_groups,
                                         long long m, int t, int* out, void* stream) {
    if (n_groups < 1 || n_groups > 65535 || m < 0 || t < 1 || t > MAX_T)
        return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0;
    const cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int resident = resident_ctas(dev);
    if (resident < 1) {
        const cudaError_t last = cudaGetLastError();
        return static_cast<int>(last != cudaSuccess ? last : cudaErrorInvalidConfiguration);
    }
    const long long per_cta = static_cast<long long>(THREADS) * UNROLL * 4;  // entries per pass
    long long ctas = (m + per_cta - 1) / per_cta;
    const long long cap = resident / n_groups;
    if (ctas > cap) ctas = cap;
    if (ctas < 1) ctas = 1;
    const bool vec = ((reinterpret_cast<uintptr_t>(symbols) ^ reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(n_groups));
    lookup_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(symbols, tables, m, t, out,
                                                                            vec);
    return static_cast<int>(cudaGetLastError());
}
