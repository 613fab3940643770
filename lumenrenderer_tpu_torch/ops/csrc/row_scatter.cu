// Row scatter-add, the backward of a row gather: out (rows, C) += for each
// entry e, grad[e, :] added into out[idx[e], :]. ops/row_gather.py holds the
// contract, the autograd op around it and the plain PyTorch twin
// (`index_add_`). The JAX package has no Pallas kernel here: XLA compiles
// the gather's transpose into its own scatter-add, so this kernel replaces
// none. It replaces PyTorch's sort-based backward of `table[idx]`, which
// gives each run of equal indices to one warp that walks it serially: a
// triangle hit by 10^5 rays became a loop of 10^5 steps on one warp.
//
// What bounds it on an H100: one pass over the incoming gradient, N x C x 4
// bytes (the interior's attribute table at 720p: 921,600 x 52-64 columns,
// 192-236 MB, about 60-75 us at 3.35 TB/s), plus N indices; the table being
// added into (1.5-1.9 MB) stays in L2. So the design reads the gradient
// coalesced, 16 bytes a lane, and issues as few global reductions as the
// indices allow, merging equal rows before they reach L2.
//
// A warp owns a span of whole chunks of 32 consecutive entries and walks
// it a chunk at a time. It copies the 32 gradient rows into its own shared
// stage with cp.async (16-byte pieces when C % 4 == 0 and both pointers are
// 16-byte aligned, else 4-byte), groups the 32 lanes' rows with
// __match_any_sync, and sums each group's rows column by column from the
// stage (lane q holds column vector q), in lane order. The sum goes into a
// carried row kept in shared memory: a group whose row is the carried one
// adds to it; any other row first flushes the carried row to `out` with one
// reduction a column vector (atomicAdd of a float4, Hopper's vector red, on
// the 16-byte path), then replaces it. The group holding the chunk's last
// lane goes last, so a row that continues into the next chunk stays
// carried: rays come in pixel order, and a large triangle's hits arrive as
// long runs. The launch aims at WARPS_PER_SM warps an SM.
//
// One path serves every table. A block's private copy of a small table in
// shared memory, filled with shared atomics and flushed once, was timed
// against it on an H100 at 720p and is not kept: 0.138 ms against 0.196 on
// the light table (128 x 17, 921,600 entries picked by power), 0.163
// against 0.054 where most entries fall on one row, and no faster on the
// packed materials (81 x 25, 7,338 entries).
//
// Counter (optional, null when nothing records): counter[0] += entries
// scattered, counter[1] += global row updates issued (flushed carried rows).
// Atomics make the sums' order, and so the low bits of `out`, vary from run
// to run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librow_scatter.so row_scatter.cu
// Entry: row_scatter_launch(), plain C, returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;              // warps a block
constexpr int WARPS_PER_SM = 16;      // warps the launch aims at per SM

__device__ __forceinline__ unsigned smem_addr(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One column vector of a row: a float (any C) or a float4 (C % 4 == 0).
template <typename V> struct Col;

template <> struct Col<float> {
    __device__ static float zero() { return 0.f; }
    __device__ static float add(float a, float b) { return a + b; }
    __device__ static void red(float* p, float v) { atomicAdd(p, v); }
    __device__ static void copy(float* dst, const float* src)
    {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(smem_addr(dst)), "l"(src) : "memory");
    }
};

template <> struct Col<float4> {
    __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
    __device__ static float4 add(float4 a, float4 b)
    {
        return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    }
    __device__ static void red(float4* p, float4 v) { atomicAdd(p, v); }
    __device__ static void copy(float4* dst, const float4* src)
    {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(smem_addr(dst)), "l"(src) : "memory");
    }
};

template <typename V>
__device__ __forceinline__ void flush(V* out, long long row, int qn,
                                      const V* carry, int lane)
{
    V* dst = out + row * qn;
    for (int q = lane; q < qn; q += 32) Col<V>::red(dst + q, carry[q]);
}

template <typename Idx, typename V>
__global__ void __launch_bounds__(WARPS * 32)
row_scatter_kernel(const V* __restrict__ grad, const Idx* __restrict__ idx,
                   V* __restrict__ out, unsigned long long* counter,
                   long long n, int qn, long long per_warp)
{
    extern __shared__ float4 smem_raw[];
    const int lane = threadIdx.x & 31;
    const int wib = threadIdx.x >> 5;
    // per warp: a stage of 32 rows, then the carried row
    V* stage = reinterpret_cast<V*>(smem_raw) + (size_t)wib * 33 * qn;
    V* carry = stage + 32 * qn;
    const long long begin = ((long long)blockIdx.x * WARPS + wib) * per_warp;
    const long long end = min(begin + per_warp, n);
    long long carry_row = -1;
    unsigned long long updates = 0;
    for (long long base = begin; base < end; base += 32) {
        const int cnt = (int)min(32LL, end - base);
        __syncwarp();                       // the last chunk's reads are done
        const V* src = grad + base * qn;
        for (int k = lane; k < cnt * qn; k += 32)
            Col<V>::copy(stage + k, src + k);
        const long long row = lane < cnt ? (long long)idx[base + lane] : -1LL;
        const unsigned peers = __match_any_sync(FULL, row);
        const int leader = __ffs(peers) - 1;
        unsigned pending = __ballot_sync(FULL, lane == leader && row >= 0);
        const int last = __shfl_sync(FULL, leader, cnt - 1);
        cp_async_wait_all();
        __syncwarp();                       // every lane's copies have landed
        while (pending) {
            int g = __ffs(pending) - 1;
            const unsigned rest = pending & ~(1u << last);
            if (g == last && rest) g = __ffs(rest) - 1;
            pending &= ~(1u << g);
            const unsigned members = __shfl_sync(FULL, peers, g);
            const long long grow = __shfl_sync(FULL, row, g);
            const bool merge = grow == carry_row;
            if (!merge && carry_row >= 0) {
                flush(out, carry_row, qn, carry, lane);
                ++updates;
            }
            for (int q = lane; q < qn; q += 32) {
                V acc = merge ? carry[q] : Col<V>::zero();
                for (unsigned m = members; m; m &= m - 1)
                    acc = Col<V>::add(acc, stage[(__ffs(m) - 1) * qn + q]);
                carry[q] = acc;
            }
            carry_row = grow;
        }
    }
    if (carry_row >= 0) {
        flush(out, carry_row, qn, carry, lane);
        ++updates;
    }
    if (counter != nullptr && lane == 0 && end > begin) {
        atomicAdd(counter, (unsigned long long)(end - begin));
        atomicAdd(counter + 1, updates);
    }
}

template <typename Idx, typename V>
cudaError_t launch(const void* grad, const void* idx, void* out,
                   void* counter, long long n, int qn, int blocks,
                   long long per_warp, size_t smem, cudaStream_t s)
{
    auto k = row_scatter_kernel<Idx, V>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    k<<<blocks, WARPS * 32, smem, s>>>(
        static_cast<const V*>(grad), static_cast<const Idx*>(idx),
        static_cast<V*>(out), static_cast<unsigned long long*>(counter), n,
        qn, per_warp);
    return cudaGetLastError();
}

}  // namespace

// grad (n, c) float32, idx (n,) int32 (idx64 == 0) or int64, out (rows, c)
// float32 zeroed by the caller, counter null or two uint64. vec != 0: the
// 16-byte path (the caller has checked C % 4 == 0 and 16-byte aligned
// grad and out). The launch's shape is made here: each warp a span of
// whole chunks of 32 entries, about WARPS_PER_SM warps an SM, WARPS warps a
// block, and per warp 33 rows of shared memory (the stage and the carried
// row). Returns cudaErrorInvalidValue for rows too wide for a block.
extern "C" int row_scatter_launch(const void* grad, const void* idx,
                                  int idx64, void* out, void* counter,
                                  long long n, int c, int vec, void* stream)
{
    if (n == 0 || c == 0) return 0;
    int dev, sms, smem_max;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
            != cudaSuccess)
        return err;
    const size_t smem = (size_t)WARPS * 33 * c * sizeof(float);
    if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
    const long long chunks = (n + 31) / 32;
    const long long warps_aimed = (long long)sms * WARPS_PER_SM;
    const long long per = 32 * ((chunks + warps_aimed - 1) / warps_aimed);
    const long long warps = (n + per - 1) / per;
    const int blocks = (int)((warps + WARPS - 1) / WARPS);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int qn = vec ? c / 4 : c;
    if (idx64)
        return vec ? launch<long long, float4>(grad, idx, out, counter, n, qn,
                                               blocks, per, smem, s)
                   : launch<long long, float>(grad, idx, out, counter, n, qn,
                                              blocks, per, smem, s);
    return vec ? launch<int, float4>(grad, idx, out, counter, n, qn, blocks,
                                     per, smem, s)
               : launch<int, float>(grad, idx, out, counter, n, qn, blocks,
                                    per, smem, s);
}
