// Instanced visit scan: the visit scan of visit_scan.cu for two-level
// scenes, whose visits are (instance, cluster) units. Each visit maps the
// tile's world rays into the instance's object space with its world->object
// 3x4 affine, then runs the same slab test in world t. Hopper (sm_90a) port
// of the Pallas kernel `visit_scan_instanced` in
// lumenrenderer_tpu/ops/pallas/instanced.py; see ops/visit_scan_instanced.py
// for the contract, the plain PyTorch twin and the design notes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libvisit_scan_instanced.so visit_scan_instanced.cu
// Entry: visit_scan_instanced_launch(), plain C, returns cudaGetLastError().
#include "cluster_scan.cuh"

namespace {

using lumen::NF;
using lumen::RT;

// The ray in visit i's object space. The affine and the cross product are
// written with round-to-nearest intrinsics, which nvcc never contracts into
// FMAs, in the order of the plain twin, so the ten features equal the
// twin's bit for bit.
struct InstancedRay {
    float ox, oy, oz, dx, dy, dz;
    const float* minv;  // the tile's (mv, 12) affines

    __device__ __forceinline__ void operator()(int i, float (&r)[NF]) const
    {
        float m[12];
#pragma unroll
        for (int j = 0; j < 12; ++j) m[j] = __ldg(minv + i * 12 + j);
        const float oox = __fadd_rn(__fadd_rn(__fadd_rn(
            __fmul_rn(m[0], ox), __fmul_rn(m[1], oy)), __fmul_rn(m[2], oz)),
            m[3]);
        const float ooy = __fadd_rn(__fadd_rn(__fadd_rn(
            __fmul_rn(m[4], ox), __fmul_rn(m[5], oy)), __fmul_rn(m[6], oz)),
            m[7]);
        const float ooz = __fadd_rn(__fadd_rn(__fadd_rn(
            __fmul_rn(m[8], ox), __fmul_rn(m[9], oy)), __fmul_rn(m[10], oz)),
            m[11]);
        const float ddx = __fadd_rn(__fadd_rn(
            __fmul_rn(m[0], dx), __fmul_rn(m[1], dy)), __fmul_rn(m[2], dz));
        const float ddy = __fadd_rn(__fadd_rn(
            __fmul_rn(m[4], dx), __fmul_rn(m[5], dy)), __fmul_rn(m[6], dz));
        const float ddz = __fadd_rn(__fadd_rn(
            __fmul_rn(m[8], dx), __fmul_rn(m[9], dy)), __fmul_rn(m[10], dz));
        r[0] = __fsub_rn(__fmul_rn(ooy, ddz), __fmul_rn(ooz, ddy));
        r[1] = __fsub_rn(__fmul_rn(ooz, ddx), __fmul_rn(oox, ddz));
        r[2] = __fsub_rn(__fmul_rn(oox, ddy), __fmul_rn(ooy, ddx));
        r[3] = ddx;
        r[4] = ddy;
        r[5] = ddz;
        r[6] = oox;
        r[7] = ooy;
        r[8] = ooz;
        r[9] = 1.f;
    }
};

// One block per tile, one thread per ray.
template <bool CLOSEST>
__global__ void __launch_bounds__(RT)
visit_scan_instanced_kernel(
    const float* __restrict__ rayblk,  // (T, 8, 128) rows o, d, pad
    const float* __restrict__ wnd,     // (T, 128, 8) cols tmin, tmax, pad
    const float* __restrict__ feats,   // (C, 10, 4K) object space
    const int* __restrict__ sel_cl,    // (T, mv) cluster ids
    const float* __restrict__ minv12,  // (T, mv, 12) world -> object
    const int* __restrict__ nv,        // (T,) live visits
    const int* __restrict__ tnb,       // (T, mv) world entry-t bits
    int* __restrict__ out,             // (T, 128)
    int num_clusters, int k, int mv, int k_bits, int low_bits)
{
    extern __shared__ float4 slab[];  // (K, 10) float4

    const int tile = blockIdx.x;
    const int lane = threadIdx.x;
    const float* rb = rayblk + (size_t)tile * 8 * RT + lane;  // coalesced
    InstancedRay ray;
    ray.ox = rb[0 * RT];
    ray.oy = rb[1 * RT];
    ray.oz = rb[2 * RT];
    ray.dx = rb[3 * RT];
    ray.dy = rb[4 * RT];
    ray.dz = rb[5 * RT];
    ray.minv = minv12 + (size_t)tile * mv * 12;
    const float* w = wnd + ((size_t)tile * RT + lane) * 8;
    const float tmin = w[0];
    const float tmax = w[1];
    const bool dead = tmax < tmin;  // padded or terminated lane

    int best = lumen::KEY_MISS;
    int occ = dead ? 1 : 0;
    lumen::scan_visits<CLOSEST>(ray, slab, feats, sel_cl + (size_t)tile * mv,
                                tnb + (size_t)tile * mv, min(nv[tile], mv),
                                mv, num_clusters, k, k_bits, low_bits, tmin,
                                tmax, dead, best, occ);
    // dead lanes: closest 0, any 1 (callers mask them)
    out[(size_t)tile * RT + lane] = CLOSEST ? (dead ? 0 : best) : occ;
}

}  // namespace

extern "C" int visit_scan_instanced_launch(
    const void* rayblk, const void* wnd, const void* feats,
    const void* sel_cl, const void* minv12, const void* nv, const void* tnb,
    void* out, int tiles, int num_clusters, int k, int mv, int k_bits,
    int low_bits, int closest, void* stream)
{
    if (tiles == 0) return 0;
    const size_t smem = (size_t)NF * 4 * k * sizeof(float);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* a = static_cast<const float*>(rayblk);
    const float* b = static_cast<const float*>(wnd);
    const float* c = static_cast<const float*>(feats);
    const int* d = static_cast<const int*>(sel_cl);
    const float* e = static_cast<const float*>(minv12);
    const int* f = static_cast<const int*>(nv);
    const int* g = static_cast<const int*>(tnb);
    int* o = static_cast<int*>(out);
    if (closest) {
        visit_scan_instanced_kernel<true><<<tiles, RT, smem, s>>>(
            a, b, c, d, e, f, g, o, num_clusters, k, mv, k_bits, low_bits);
    } else {
        visit_scan_instanced_kernel<false><<<tiles, RT, smem, s>>>(
            a, b, c, d, e, f, g, o, num_clusters, k, mv, k_bits, low_bits);
    }
    return static_cast<int>(cudaGetLastError());
}
