// Shared device code of the cluster intersection kernels (visit_scan.cu,
// visit_scan_instanced.cu, pair_scan.cu), Möller–Trumbore written as the
// bilinear form f (10) · tri_feat (10, 4K). The instanced and pair scans
// use the one-ray-per-thread slab load, test and visit loop below; the
// visit scan has its own (four rays a thread) and uses the TMA bulk copy
// and mbarrier helpers at the end.
#pragma once
#include <cuda_runtime.h>

namespace lumen {

constexpr int RT = 128;               // rays per tile = threads per block
constexpr int NF = 10;                // ray features [o x d, d, o, 1]
constexpr int KEY_MISS = 0x7F000000;  // closest-mode "no hit" key

// Copy a cluster's (10, 4K) coefficient slab to shared memory, transposed
// so that triangle j's ten (det, u, v, t) coefficient quadruples are ten
// float4s: global (f, q*K + j) -> shared ((j*10 + f)*4 + q). Every thread
// then reads the same float4 (a broadcast) for 4 FMAs.
__device__ __forceinline__ void load_slab(float* __restrict__ slab_f,
                                          const float* __restrict__ src,
                                          int k, int tid)
{
    const int fk = 4 * k;
    const int slab_len = NF * fk;
    for (int e = tid; e < slab_len; e += RT) {
        const int f = e / fk;
        const int c = e - f * fk;
        const int q = c / k;
        const int j = c - q * k;
        slab_f[(j * NF + f) * 4 + q] = __ldg(src + e);
    }
}

// Test one ray's features against the K triangles of the slab. Closest
// mode folds the packed key (t's float bits & low_mask) | visit_field | j
// into `best`; any mode ORs a hit into `occ`.
template <bool CLOSEST>
__device__ __forceinline__ void test_slab(const float4* __restrict__ slab,
                                          const float (&r)[NF], float tmin,
                                          float tmax, int k, int low_mask,
                                          int visit_field, int& best, int& occ)
{
    for (int j = 0; j < k; ++j) {
        float det = 0.f, un = 0.f, vn = 0.f, tn = 0.f;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
            const float4 cf = slab[j * NF + f];
            det = fmaf(r[f], cf.x, det);
            un = fmaf(r[f], cf.y, un);
            vn = fmaf(r[f], cf.z, vn);
            tn = fmaf(r[f], cf.w, tn);
        }
        // division-free hit test after normalising the sign of det;
        // zero-filled padding triangles have det == 0 and never hit
        const float s = det > 0.f ? 1.f : (det < 0.f ? -1.f : 0.f);
        const float ad = det * s;
        const float us = un * s;
        const float vs = vn * s;
        const float ts = tn * s;
        const bool hit = (ad > 1e-12f) && (us >= 0.f) && (vs >= 0.f) &&
                         (us + vs <= ad) && (ts > tmin * ad) &&
                         (ts <= tmax * ad);
        if (CLOSEST) {
            if (hit) {
                // packed key: t's float bits (order-preserving for t >= 0)
                // above the visit position and triangle slot
                const int tb = __float_as_int(fmaxf(ts / ad, 0.f));
                best = min(best, (tb & low_mask) | visit_field | j);
            }
        } else {
            occ |= hit ? 1 : 0;
        }
    }
}

// The ordered visit loop of one tile with its block-wide early-out, shared
// by the single-level and the instanced visit scans. `rays(i, r)` fills the
// thread's ray features for visit i (fixed for the single-level scan, the
// instance's object-space ray for the instanced one). The early-out is
// conservative, so the result equals a full scan: closest stops when no
// live ray can still improve, given that later visits start no nearer than
// the next entry t (tnb); any stops when every lane is occluded or dead.
template <bool CLOSEST, class Rays>
__device__ __forceinline__ void scan_visits(const Rays& rays,
                                            float4* slab,
                                            const float* __restrict__ feats,
                                            const int* __restrict__ tile_sel,
                                            const int* __restrict__ tile_tnb,
                                            int n, int mv, int num_clusters,
                                            int k, int k_bits, int low_bits,
                                            float tmin, float tmax, bool dead,
                                            int& best, int& occ)
{
    const int lane = threadIdx.x;
    const int low_mask = ~((1 << low_bits) - 1);
    const int slab_len = NF * 4 * k;
    float* slab_f = reinterpret_cast<float*>(slab);
    for (int i = 0; i < n; ++i) {
        const int cl = min(max(tile_sel[i], 0), num_clusters - 1);
        // the previous visit's readers were released by the vote below
        load_slab(slab_f, feats + (size_t)cl * slab_len, k, lane);
        float r[NF];
        rays(i, r);
        __syncthreads();
        test_slab<CLOSEST>(slab, r, tmin, tmax, k, low_mask, i << k_bits,
                           best, occ);
        bool done;
        if (CLOSEST) {
            const int nxt = tile_tnb[min(i + 1, mv - 1)];
            done = __syncthreads_and(dead ||
                                     (best >> low_bits) < (nxt >> low_bits));
        } else {
            done = __syncthreads_and(occ);
        }
        if (done) break;
    }
}

// Hopper's 1-D bulk copy (TMA) from global into shared memory, completed on
// an mbarrier that counts the bytes (the visit scan's double-buffered slab).
__device__ __forceinline__ unsigned smem_addr(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One expected arrival per phase: the thread that issues the copy.
__device__ __forceinline__ void mbar_init(unsigned long long* bar)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) and
// complete the barrier's current phase when they have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                    "r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity)
{
    asm volatile("{\n"
                 ".reg .pred P1;\n"
                 "LAB_WAIT:\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
                 "@!P1 bra LAB_WAIT;\n"
                 "}\n"
                 :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

}  // namespace lumen
