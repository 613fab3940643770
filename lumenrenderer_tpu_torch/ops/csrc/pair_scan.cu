// Pair scan: closest-hit keys or occlusion bits for 128-pair tiles, each
// tile a run of (ray, cluster) pairs of one cluster. Hopper (sm_90a) port of
// the Pallas kernel `pair_scan` (resident and streamed variants) in
// lumenrenderer_tpu/ops/pallas/pair_intersect.py; see ops/pair_scan.py for
// the contract, the plain PyTorch twin and the design notes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpair_scan.so pair_scan.cu
// Entry: pair_scan_launch(), plain C, returns cudaGetLastError().
#include "cluster_scan.cuh"

namespace {

using lumen::NF;
using lumen::RT;

// One block per pair tile, one thread per pair: one slab load, one test,
// no visit loop. The key has no visit field (low bits = k_bits). A dead
// pair (tmax < tmin, the padding) cannot hit: KEY_MISS or 0.
template <bool CLOSEST>
__global__ void __launch_bounds__(RT)
pair_scan_kernel(const float* __restrict__ rf_pairs,    // (S, 12)
                 const float* __restrict__ feats,       // (C, 10, 4K)
                 const int* __restrict__ tile_cluster,  // (S / 128,)
                 int* __restrict__ out,                 // (S,)
                 int num_clusters, int k, int k_bits)
{
    extern __shared__ float4 slab[];  // (K, 10) float4

    const int tile = blockIdx.x;
    const int lane = threadIdx.x;
    const int cl = min(max(tile_cluster[tile], 0), num_clusters - 1);
    lumen::load_slab(reinterpret_cast<float*>(slab),
                     feats + (size_t)cl * NF * 4 * k, k, lane);
    const float* rf = rf_pairs + ((size_t)tile * RT + lane) * 12;
    float r[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) r[f] = rf[f];
    const float tmin = rf[10];
    const float tmax = rf[11];
    __syncthreads();

    int best = lumen::KEY_MISS;
    int occ = 0;
    lumen::test_slab<CLOSEST>(slab, r, tmin, tmax, k, ~((1 << k_bits) - 1),
                              0, best, occ);
    out[(size_t)tile * RT + lane] = CLOSEST ? best : occ;
}

}  // namespace

extern "C" int pair_scan_launch(const void* rf_pairs, const void* feats,
                                const void* tile_cluster, void* out,
                                int tiles, int num_clusters, int k,
                                int k_bits, int closest, void* stream)
{
    if (tiles == 0) return 0;
    const size_t smem = (size_t)NF * 4 * k * sizeof(float);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* a = static_cast<const float*>(rf_pairs);
    const float* b = static_cast<const float*>(feats);
    const int* c = static_cast<const int*>(tile_cluster);
    int* o = static_cast<int*>(out);
    if (closest) {
        pair_scan_kernel<true><<<tiles, RT, smem, s>>>(a, b, c, o,
                                                       num_clusters, k,
                                                       k_bits);
    } else {
        pair_scan_kernel<false><<<tiles, RT, smem, s>>>(a, b, c, o,
                                                        num_clusters, k,
                                                        k_bits);
    }
    return static_cast<int>(cudaGetLastError());
}
