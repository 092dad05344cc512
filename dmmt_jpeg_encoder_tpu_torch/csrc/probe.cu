// Capability probe on Hopper: out = x + 1 on a float32 [8, 128] tile.
//
// Replaces: dmmt_jpeg_encoder_tpu/utils/capability.py : _probe_lowering
// (a trivial pallas_call, lowered once per process to learn whether the
// backend could run the Mosaic kernels). Here the question is whether the
// kernel library built for this card and launches on it, so the probe is
// built with the other kernels and launched (utils/capability.py checks
// the result against x + 1 once per process and device).
//
// Bound on the H100: 4 KiB read and 4 KiB written, far below launch
// latency; one CTA of 256 threads, four elements each.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
add_one_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
    for (int i = threadIdx.x; i < n; i += THREADS) out[i] = x[i] + 1.0f;
}

}  // namespace

// x, out: float32 [n], n <= 2^20.
extern "C" int dmmt_probe(const float* x, float* out, int n, void* stream) {
    if (n < 1 || n > (1 << 20)) return static_cast<int>(cudaErrorInvalidValue);
    add_one_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n);
    return static_cast<int>(cudaGetLastError());
}
