// Visit scan: closest-hit keys or occlusion bits for 128-ray tiles against
// their ordered lists of triangle clusters (Möller–Trumbore as a bilinear
// form). Hopper (sm_90a) port of the Pallas kernel `visit_scan` in
// lumenrenderer_tpu/ops/pallas/intersect.py; see ops/visit_scan.py for the
// contract, the plain PyTorch twin and the design notes, and
// cluster_scan.cuh for the slab test and visit loop it shares with the
// instanced scan.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libvisit_scan.so visit_scan.cu
// Entry: visit_scan_launch(), plain C, returns cudaGetLastError().
#include "cluster_scan.cuh"

namespace {

using lumen::NF;
using lumen::RT;

// The tile's rays are fixed: every visit tests the same world-space ray.
struct FixedRay {
    float f[NF];
    __device__ __forceinline__ void operator()(int, float (&r)[NF]) const
    {
#pragma unroll
        for (int j = 0; j < NF; ++j) r[j] = f[j];
    }
};

// One block per tile, one thread per ray.
template <bool CLOSEST>
__global__ void __launch_bounds__(RT)
visit_scan_kernel(const float* __restrict__ rf_t,   // (T, 128, 12)
                  const float* __restrict__ feats,  // (C, 10, 4K)
                  const int* __restrict__ sel,      // (T, mv) cluster ids
                  const int* __restrict__ nv,       // (T,) live visits
                  const int* __restrict__ tnb,      // (T, mv) entry-t bits
                  int* __restrict__ out,            // (T, 128)
                  int num_clusters, int k, int mv, int k_bits, int low_bits)
{
    extern __shared__ float4 slab[];  // (K, 10) float4

    const int tile = blockIdx.x;
    const int lane = threadIdx.x;
    const float* rf = rf_t + ((size_t)tile * RT + lane) * 12;
    FixedRay ray;
#pragma unroll
    for (int f = 0; f < NF; ++f) ray.f[f] = rf[f];
    const float tmin = rf[10];
    const float tmax = rf[11];
    const bool dead = tmax < tmin;  // padded or terminated lane

    int best = lumen::KEY_MISS;
    int occ = dead ? 1 : 0;
    lumen::scan_visits<CLOSEST>(ray, slab, feats, sel + (size_t)tile * mv,
                                tnb + (size_t)tile * mv, min(nv[tile], mv),
                                mv, num_clusters, k, k_bits, low_bits, tmin,
                                tmax, dead, best, occ);
    // dead lanes: closest 0, any 1 (callers mask them)
    out[(size_t)tile * RT + lane] = CLOSEST ? (dead ? 0 : best) : occ;
}

}  // namespace

extern "C" int visit_scan_launch(const void* rf_t, const void* feats,
                                 const void* sel, const void* nv,
                                 const void* tnb, void* out, int tiles,
                                 int num_clusters, int k, int mv, int k_bits,
                                 int low_bits, int closest, void* stream)
{
    if (tiles == 0) return 0;
    const size_t smem = (size_t)NF * 4 * k * sizeof(float);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* a = static_cast<const float*>(rf_t);
    const float* b = static_cast<const float*>(feats);
    const int* c = static_cast<const int*>(sel);
    const int* d = static_cast<const int*>(nv);
    const int* e = static_cast<const int*>(tnb);
    int* o = static_cast<int*>(out);
    if (closest) {
        visit_scan_kernel<true><<<tiles, RT, smem, s>>>(
            a, b, c, d, e, o, num_clusters, k, mv, k_bits, low_bits);
    } else {
        visit_scan_kernel<false><<<tiles, RT, smem, s>>>(
            a, b, c, d, e, o, num_clusters, k, mv, k_bits, low_bits);
    }
    return static_cast<int>(cudaGetLastError());
}
