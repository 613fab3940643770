// The tensor-core probe: one m16n8k16 bf16 product with float32 sums per
// case, on crafted inputs, through the instruction wrapper that kernels K1
// and K3 use in their bf16 mode (`lumen::mma_bf16_16816` in
// cluster_scan.cuh). It replaces no TPU kernel: ops/mma_probe.py holds its
// wrapper and compares its results bit for bit with candidate models of
// how the tensor cores round a sum, so that the bf16 twins can form their
// products as the card does. One warp per case; its cost is negligible.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmma_probe.so mma_probe.cu
// Entry: mma_probe_launch(), plain C, returns cudaGetLastError().
#include "cluster_scan.cuh"

namespace {

constexpr int WARPS = 4;

__device__ __forceinline__ unsigned pack(unsigned short lo, unsigned short hi)
{
    return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

// Case c: d (16, 8) = a (16, 16) · b (16, 8), all row-major; a and b hold
// bfloat16 bit patterns.
__global__ void __launch_bounds__(WARPS * 32)
mma_probe_kernel(const unsigned short* __restrict__ a,
                 const unsigned short* __restrict__ b,
                 float* __restrict__ d, int n)
{
    const int c = blockIdx.x * WARPS + threadIdx.x / 32;
    if (c >= n) return;  // whole warps
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2, q = lane & 3;
    const unsigned short* A = a + (size_t)c * 256;
    const unsigned short* B = b + (size_t)c * 128;
    const unsigned fa[4] = {
        pack(A[g * 16 + 2 * q], A[g * 16 + 2 * q + 1]),
        pack(A[(g + 8) * 16 + 2 * q], A[(g + 8) * 16 + 2 * q + 1]),
        pack(A[g * 16 + 2 * q + 8], A[g * 16 + 2 * q + 9]),
        pack(A[(g + 8) * 16 + 2 * q + 8], A[(g + 8) * 16 + 2 * q + 9])};
    const unsigned b0 = pack(B[2 * q * 8 + g], B[(2 * q + 1) * 8 + g]);
    const unsigned b1 = pack(B[(2 * q + 8) * 8 + g], B[(2 * q + 9) * 8 + g]);
    float acc[4];
    lumen::mma_bf16_16816(acc, fa, b0, b1);
    float* D = d + (size_t)c * 128;
    D[g * 8 + 2 * q] = acc[0];
    D[g * 8 + 2 * q + 1] = acc[1];
    D[(g + 8) * 8 + 2 * q] = acc[2];
    D[(g + 8) * 8 + 2 * q + 1] = acc[3];
}

}  // namespace

extern "C" int mma_probe_launch(const void* a, const void* b, void* d, int n,
                                void* stream)
{
    if (n == 0) return 0;
    mma_probe_kernel<<<(n + WARPS - 1) / WARPS, WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned short*>(a),
        static_cast<const unsigned short*>(b), static_cast<float*>(d), n);
    return static_cast<int>(cudaGetLastError());
}
