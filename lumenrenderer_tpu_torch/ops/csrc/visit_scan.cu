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
// The design against that, on the loop that K1, K2 and K3 share
// (cluster_scan.cuh):
// - A block of 128 threads per tile: four warps, each testing one
//   interleaved quarter of the cluster's triangles (slots w, w + 4, ...);
//   each lane holds 4 rays (lane, lane + 32, ...) and tests them against
//   the same triangle, so one broadcast float4 from shared memory feeds 16
//   FMAs. The warps fold their keys (bits) through shared memory at each
//   vote.
// - Only live slots are tested: padding sits at each cluster's tail, and
//   `nlive` says where it starts (a third of the interior scene's slots).
// - The hit test normalises signs by XOR with det's sign bit (no
//   multiplies) and forms t by the one exact division, for hits only, with
//   one branch for the lane's 4 rays.
// - One thread copies a visit's live slots with a TMA bulk copy into one of
//   two shared buffers, completed on an mbarrier. The copy for visit i + 1
//   is in flight while visit i is tested.
// - K is a template parameter (32, 64, 128), which sizes the buffers.
// - A block-wide vote before every visit ends the tile when no live ray can
//   still improve (closest: later visits start no nearer than their entry
//   t) or every lane is occluded or dead (any). It is conservative, so the
//   result equals a full scan. An optional counter gets the number of
//   visits each tile ran.
// Measured alternatives (2 rays a thread, 64 or 256 threads, the triangle
// loop unrolled by 2 or 4) were slower on the interior passes.
// The bf16 mode (the TPU kernel's precision="default") is its own kernel,
// `visit_scan_mma_kernel`: the product on the tensor cores (mma.sync
// m16n8k16, bf16 inputs, float32 sums), so fp32 FMA issue no longer bounds
// it; what is left on the CUDA cores is the epilogue of every (ray,
// triangle) pair: the sign flip, six compares and the key. Four warps per
// tile, each owning 32 rays (two m16 tiles) whose rounded features sit in
// A fragments made once; every warp walks all live slots of the visit's
// cluster in groups of four triangles, the table in fragment order
// (ops/visit_scan.py `mma_layout`, 128 bytes a triangle, one 16-byte
// shared load a lane a group), so each lane finds det, u, v and t of one
// triangle for four rays in its own accumulators. The vote, the bulk
// copies and the key are the fp32 mode's (cluster_scan.cuh
// `visit_loop_mma`); the closest vote ends a tile only when its lanes are
// dead (ROADMAP C-25).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libvisit_scan.so visit_scan.cu
// Entry: visit_scan_launch(), plain C, returns cudaGetLastError().
#include "cluster_scan.cuh"

namespace {

using lumen::NF;
using lumen::RT;

constexpr int R = 4;            // rays per thread
constexpr int G = RT / R;       // ray groups: the lanes of a warp
constexpr int SPLIT = 4;        // warps, one slice of triangles each
constexpr int THREADS = G * SPLIT;
static_assert(G == 32, "one warp per slice: its slab reads are broadcasts");

// One block per tile (lumen::visit_loop): warp s tests slots s, s + SPLIT,
// ... of each slab; its lane g holds rays g + r * G, whose features stay in
// registers across the visits.
template <int K, bool CLOSEST>
__global__ void __launch_bounds__(THREADS)
visit_scan_kernel(const float* __restrict__ rf_t,    // (T, 128, 12)
                  const float4* __restrict__ slabs,  // (C, K * 10) quads
                  const int* __restrict__ nlive,     // (C,) slots to test
                  const int* __restrict__ sel,       // (T, mv) cluster ids
                  const int* __restrict__ nv,        // (T,) live visits
                  const int* __restrict__ tnb,       // (T, mv) entry-t bits
                  int* __restrict__ out,             // (T, 128)
                  int* __restrict__ visits,          // (T,) or null
                  int num_clusters, int mv, int k_bits, int low_bits)
{
    const int g = threadIdx.x % G;
    const int tile = blockIdx.x;
    float rf[R][NF], tmin[R], tmax[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float* p = rf_t + ((size_t)tile * RT + g + r * G) * 12;
#pragma unroll
        for (int f = 0; f < NF; ++f) rf[r][f] = p[f];
        tmin[r] = p[10];
        tmax[r] = p[11];
    }
    lumen::visit_loop<K, 0, R, SPLIT, CLOSEST>(
        slabs, nlive, sel, nv, tnb, out, visits, num_clusters, mv, k_bits,
        low_bits, tmin, tmax, [](int, float4*, unsigned long long*) {},
        [&](const float4*) -> const float(&)[R][NF] { return rf; });
}

// The bf16 mode: one block of four warps per tile on the tensor cores
// (lumen::visit_loop_mma); lane (g, q) of warp w holds rays
// lumen::mma_row(w, g, r), r < 4.
template <int K, bool CLOSEST>
__global__ void __launch_bounds__(THREADS)
visit_scan_mma_kernel(const float* __restrict__ rf_t,   // (T, 128, 12)
                      const uint4* __restrict__ frags,  // (C, K / 4, 32)
                      const int* __restrict__ nlive,    // (C,) % 4 == 0
                      const int* __restrict__ sel,      // (T, mv)
                      const int* __restrict__ nv,       // (T,)
                      int* __restrict__ out,            // (T, 128)
                      int* __restrict__ visits,         // (T,) or null
                      int num_clusters, int mv, int k_bits, int low_bits)
{
    const int lane = threadIdx.x % 32;
    const int w = threadIdx.x / 32;
    const float* rows = rf_t + (size_t)blockIdx.x * RT * 12;
    unsigned a[2][4];
    float tmin[4], tmax[4];
    lumen::mma_ray_fragments(
        [&](int r) { return rows + lumen::mma_row(w, lane >> 2, r) * 12; },
        lane & 3, a, tmin, tmax);
    lumen::visit_loop_mma<K, 0, CLOSEST>(
        frags, nlive, sel, nv, out, visits, num_clusters, mv, k_bits,
        low_bits, tmin, tmax, [](int, uint4*, unsigned long long*) {},
        [&](const uint4*) -> const unsigned(&)[2][4] { return a; });
}

struct Args {
    const float* rf_t;
    const void* slabs;
    const int *nlive, *sel, *nv, *tnb;
    int *out, *visits;
    int tiles, num_clusters, mv, k_bits, low_bits;
};

template <int K, bool CLOSEST>
int launch_mode(const Args& a, cudaStream_t s)
{
    const size_t smem = 2 * lumen::slab_float4s<K>() * sizeof(float4);
    visit_scan_kernel<K, CLOSEST><<<a.tiles, THREADS, smem, s>>>(
        a.rf_t, static_cast<const float4*>(a.slabs), a.nlive, a.sel, a.nv,
        a.tnb, a.out, a.visits, a.num_clusters, a.mv, a.k_bits, a.low_bits);
    return static_cast<int>(cudaGetLastError());
}

template <int K, bool CLOSEST>
int launch_mma(const Args& a, cudaStream_t s)
{
    const size_t smem = 2 * lumen::mma_slab_uint4s<K>() * sizeof(uint4);
    visit_scan_mma_kernel<K, CLOSEST><<<a.tiles, THREADS, smem, s>>>(
        a.rf_t, static_cast<const uint4*>(a.slabs), a.nlive, a.sel, a.nv,
        a.out, a.visits, a.num_clusters, a.mv, a.k_bits, a.low_bits);
    return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch(const Args& a, bool closest, bool bf16, cudaStream_t s)
{
    if (bf16)
        return closest ? launch_mma<K, true>(a, s)
                       : launch_mma<K, false>(a, s);
    return closest ? launch_mode<K, true>(a, s)
                   : launch_mode<K, false>(a, s);
}

}  // namespace

extern "C" int visit_scan_launch(const void* rf_t, const void* slabs,
                                 const void* nlive, const void* sel,
                                 const void* nv, const void* tnb, void* out,
                                 void* visits,
                                 int tiles, int num_clusters, int k, int mv,
                                 int k_bits, int low_bits, int closest,
                                 int bf16, void* stream)
{
    if (tiles == 0) return 0;
    const Args a{static_cast<const float*>(rf_t),
                 slabs,
                 static_cast<const int*>(nlive),
                 static_cast<const int*>(sel),
                 static_cast<const int*>(nv),
                 static_cast<const int*>(tnb),
                 static_cast<int*>(out),
                 static_cast<int*>(visits),
                 tiles, num_clusters, mv, k_bits, low_bits};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (k) {
    case 32: return launch<32>(a, closest != 0, bf16 != 0, s);
    case 64: return launch<64>(a, closest != 0, bf16 != 0, s);
    case 128: return launch<128>(a, closest != 0, bf16 != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
