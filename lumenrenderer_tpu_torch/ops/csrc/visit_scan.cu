// Kernel K1, the visit scan: closest-hit keys or occlusion bits for 128-ray
// tiles against their ordered lists of triangle clusters (Möller–Trumbore
// as a bilinear form). Hopper (sm_90a) port of the Pallas kernel
// `visit_scan` (lumenrenderer_tpu/ops/pallas/intersect.py:325, both its
// VMEM-resident and its DMA-streamed variant); ops/visit_scan.py holds the
// contract and the plain PyTorch twin.
//
// What bounds it on an H100: fp32 FMA issue. A visit costs live rays x live
// triangles x 40 FMAs (80 flop); its bytes are a few hundred per ray and a
// slab of at most 20 KB per visit from L2 (the interior table, 2.75 MB,
// stays in the 50 MB L2), so the flop over 67 TFLOP/s is the bound and
// device memory is not. Every instruction that is not an FFMA takes an
// FFMA's issue slot.
//
// The design against that:
// - A block of 128 threads per tile: four warps, each testing one
//   interleaved quarter of the cluster's triangles (slots w, w + 4, ...);
//   each lane holds 4 rays (lane, lane + 32, ...) and tests them against
//   the same triangle, so one broadcast float4 from shared memory feeds 16
//   FMAs (the one-ray version fed 4, and its shared loads rivalled its
//   FMAs). The warps fold their keys (bits) through shared memory at each
//   vote.
// - Only live slots are tested: padding sits at each cluster's tail, and
//   `nlive` says where it starts (a third of the interior scene's slots).
// - The hit test normalises signs by XOR with det's sign bit (no
//   multiplies) and forms t by the one exact division, for hits only, with
//   one branch for the lane's 4 rays. Each ray's FMA order over the ten
//   features is the twin's, so keys and bits equal the one-ray kernel's.
// - The slab table arrives in the kernel's order, (C, K, 10) float4
//   (ops/visit_scan.py `slab_layout`), so a visit's live slots are one
//   contiguous block: one thread copies it with a TMA bulk copy into one of
//   two shared buffers, completed on an mbarrier. The copy for visit i + 1
//   is in flight while visit i is tested; no other thread spends
//   instructions or registers on it.
// - K is a template parameter (32, 64, 128), which sizes the buffers.
// - A block-wide vote before every visit ends the tile when no live ray can
//   still improve (closest: later visits start no nearer than their entry
//   t) or every lane is occluded or dead (any). It is conservative, so the
//   result equals a full scan. An optional counter gets the number of
//   visits each tile ran.
// Measured alternatives (2 rays a thread, 64 or 256 threads, the triangle
// loop unrolled by 2 or 4) were slower on the interior passes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libvisit_scan.so visit_scan.cu
// Entry: visit_scan_launch(), plain C, returns cudaGetLastError().
#include "cluster_scan.cuh"

namespace {

using lumen::KEY_MISS;
using lumen::NF;
using lumen::RT;

constexpr int R = 4;            // rays per thread
constexpr int G = RT / R;       // ray groups: the lanes of a warp
constexpr int SPLIT = 4;        // warps, one slice of triangles each
constexpr int THREADS = G * SPLIT;
static_assert(G == 32, "one warp per slice: its slab reads are broadcasts");

// Test the thread's R rays against slots j0, j0 + SPLIT, ... below nt of a
// slab. Closest mode folds the packed key
// (t's float bits & low_mask) | visit_field | slot into best; any mode ORs
// hits into occ.
template <bool CLOSEST>
__device__ __forceinline__ void test_rays(const float4* __restrict__ slab,
                                          int j0, int nt,
                                          const float (&rf)[R][NF],
                                          const float (&tmin)[R],
                                          const float (&tmax)[R],
                                          int low_mask, int visit_field,
                                          int (&best)[R], int (&occ)[R])
{
#pragma unroll 1
    for (int j = j0; j < nt; j += SPLIT) {
        float det[R], un[R], vn[R], tn[R];
#pragma unroll
        for (int r = 0; r < R; ++r) det[r] = un[r] = vn[r] = tn[r] = 0.f;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
            const float4 cf = slab[j * NF + f];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                det[r] = fmaf(rf[r][f], cf.x, det[r]);
                un[r] = fmaf(rf[r][f], cf.y, un[r]);
                vn[r] = fmaf(rf[r][f], cf.z, vn[r]);
                tn[r] = fmaf(rf[r][f], cf.w, tn[r]);
            }
        }
        bool hit[R];
        bool any_hit = false;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            // sign(det) * x, exactly, as a flip of x's sign bit; det == 0
            // (padding slots) fails ad > 1e-12 either way
            const unsigned sg = __float_as_uint(det[r]) & 0x80000000u;
            const float ad = fabsf(det[r]);
            const float us = __uint_as_float(__float_as_uint(un[r]) ^ sg);
            const float vs = __uint_as_float(__float_as_uint(vn[r]) ^ sg);
            const float ts = __uint_as_float(__float_as_uint(tn[r]) ^ sg);
            hit[r] = (ad > 1e-12f) && (us >= 0.f) && (vs >= 0.f) &&
                     (us + vs <= ad) && (ts > tmin[r] * ad) &&
                     (ts <= tmax[r] * ad);
            any_hit |= hit[r];
            tn[r] = ts;
            det[r] = ad;
        }
        if (CLOSEST) {
            // hits are rare: one branch for the thread's R rays
            if (any_hit) {
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    if (hit[r]) {
                        const int tb =
                            __float_as_int(fmaxf(tn[r] / det[r], 0.f));
                        best[r] = min(best[r],
                                      (tb & low_mask) | visit_field | j);
                    }
                }
            }
        } else {
#pragma unroll
            for (int r = 0; r < R; ++r) occ[r] |= hit[r] ? 1 : 0;
        }
    }
}

// Fold the warps' keys (bits) of each ray so that every warp holds the
// ray's minimum (OR). Ends with the block synchronised.
template <bool CLOSEST>
__device__ __forceinline__ void combine(int (*part)[RT], int g, int s,
                                        int (&best)[R], int (&occ)[R])
{
#pragma unroll
    for (int r = 0; r < R; ++r)
        part[s][g + r * G] = CLOSEST ? best[r] : occ[r];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int o = 0; o < SPLIT; ++o) {
            const int v = part[o][g + r * G];
            if (CLOSEST) best[r] = min(best[r], v);
            else occ[r] |= v;
        }
    }
}

// One block per tile: warp s tests slots s, s + SPLIT, ... of each slab;
// its lane g holds rays g + r * G.
template <int K, bool CLOSEST>
__global__ void __launch_bounds__(THREADS)
visit_scan_kernel(const float* __restrict__ rf_t,    // (T, 128, 12)
                  const float4* __restrict__ slabs,  // (C, K * 10)
                  const int* __restrict__ nlive,     // (C,) slots to test
                  const int* __restrict__ sel,       // (T, mv) cluster ids
                  const int* __restrict__ nv,        // (T,) live visits
                  const int* __restrict__ tnb,       // (T, mv) entry-t bits
                  int* __restrict__ out,             // (T, 128)
                  int* __restrict__ visits,          // (T,) or null
                  int num_clusters, int mv, int k_bits, int low_bits)
{
    constexpr int SLAB = K * NF;  // float4s
    extern __shared__ __align__(128) float4 buf[];  // two slabs
    __shared__ __align__(8) unsigned long long bar[2];
    __shared__ int part[SPLIT][RT];

    const int tid = threadIdx.x;
    const int g = tid % G;
    const int s = tid / G;
    const int tile = blockIdx.x;
    float rf[R][NF], tmin[R], tmax[R];
    bool dead[R];
    int best[R], occ[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float* p = rf_t + ((size_t)tile * RT + g + r * G) * 12;
#pragma unroll
        for (int f = 0; f < NF; ++f) rf[r][f] = p[f];
        tmin[r] = p[10];
        tmax[r] = p[11];
        dead[r] = tmax[r] < tmin[r];  // padded or terminated lane
        best[r] = KEY_MISS;
        occ[r] = dead[r] ? 1 : 0;
    }
    if (tid == 0) {
        lumen::mbar_init(&bar[0]);
        lumen::mbar_init(&bar[1]);
    }
    const int n = min(nv[tile], mv);
    const int* tsel = sel + (size_t)tile * mv;
    const int* ttnb = tnb + (size_t)tile * mv;
    const int low_mask = ~((1 << low_bits) - 1);
    auto cluster = [&](int i) {
        return min(max(tsel[i], 0), num_clusters - 1);
    };
    // copy the live slots only (padding is at each cluster's tail)
    auto fetch = [&](int i) {
        const int cl = cluster(i);
        lumen::bulk_load(buf + (i & 1) * SLAB, slabs + (size_t)cl * SLAB,
                         nlive[cl] * NF * sizeof(float4), &bar[i & 1]);
    };

    int ran = 0;
    for (int i = 0; i < n; ++i) {
        // the vote before visit i (its barrier also publishes the barriers'
        // initialisation and releases the buffer of visit i - 1)
        combine<CLOSEST>(part, g, s, best, occ);
        bool done = true;
        if (CLOSEST) {
            const int nxt = ttnb[i] >> low_bits;
#pragma unroll
            for (int r = 0; r < R; ++r)
                done &= dead[r] || (best[r] >> low_bits) < nxt;
        } else {
#pragma unroll
            for (int r = 0; r < R; ++r) done &= occ[r] != 0;
        }
        if (__syncthreads_and(done)) break;
        if (tid == 0) {
            if (i == 0) fetch(0);
            if (i + 1 < n) fetch(i + 1);
        }
        const int nt = nlive[cluster(i)];
        lumen::mbar_wait(&bar[i & 1], (i >> 1) & 1);
        test_rays<CLOSEST>(buf + (i & 1) * SLAB, s, nt, rf, tmin, tmax,
                           low_mask, i << k_bits, best, occ);
        ran = i + 1;
    }
    // a slab prefetched for a visit that the vote skipped must land before
    // the block's shared memory is released
    if (tid == 0 && ran > 0 && ran < n)
        lumen::mbar_wait(&bar[ran & 1], (ran >> 1) & 1);
    combine<CLOSEST>(part, g, s, best, occ);
    if (s == 0) {
        // dead lanes: closest 0, any 1 (callers mask them)
#pragma unroll
        for (int r = 0; r < R; ++r)
            out[(size_t)tile * RT + g + r * G] =
                CLOSEST ? (dead[r] ? 0 : best[r]) : occ[r];
    }
    if (visits != nullptr && tid == 0) visits[tile] = ran;
}

struct Args {
    const float* rf_t;
    const float4* slabs;
    const int *nlive, *sel, *nv, *tnb;
    int *out, *visits;
    int tiles, num_clusters, mv, k_bits, low_bits;
};

template <int K>
int launch(const Args& a, bool closest, cudaStream_t s)
{
    const size_t smem = 2 * (size_t)K * NF * sizeof(float4);
    if (closest) {
        visit_scan_kernel<K, true><<<a.tiles, THREADS, smem, s>>>(
            a.rf_t, a.slabs, a.nlive, a.sel, a.nv, a.tnb, a.out, a.visits,
            a.num_clusters, a.mv, a.k_bits, a.low_bits);
    } else {
        visit_scan_kernel<K, false><<<a.tiles, THREADS, smem, s>>>(
            a.rf_t, a.slabs, a.nlive, a.sel, a.nv, a.tnb, a.out, a.visits,
            a.num_clusters, a.mv, a.k_bits, a.low_bits);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int visit_scan_launch(const void* rf_t, const void* slabs,
                                 const void* nlive, const void* sel,
                                 const void* nv, const void* tnb, void* out,
                                 void* visits,
                                 int tiles, int num_clusters, int k, int mv,
                                 int k_bits, int low_bits, int closest,
                                 void* stream)
{
    if (tiles == 0) return 0;
    const Args a{static_cast<const float*>(rf_t),
                 static_cast<const float4*>(slabs),
                 static_cast<const int*>(nlive),
                 static_cast<const int*>(sel),
                 static_cast<const int*>(nv),
                 static_cast<const int*>(tnb),
                 static_cast<int*>(out),
                 static_cast<int*>(visits),
                 tiles, num_clusters, mv, k_bits, low_bits};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (k) {
    case 32: return launch<32>(a, closest != 0, s);
    case 64: return launch<64>(a, closest != 0, s);
    case 128: return launch<128>(a, closest != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
