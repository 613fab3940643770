// Kernel K3, the pair scan: closest-hit keys or occlusion bits for 128-pair
// tiles, each tile a run of (ray, cluster) pairs of one cluster. Hopper
// (sm_90a) port of the Pallas kernel `pair_scan` (resident and streamed
// variants) in lumenrenderer_tpu/ops/pallas/pair_intersect.py:129; see
// ops/pair_scan.py for the contract and the plain PyTorch twin.
//
// What bounds it on an H100: fp32 FMA issue, as K1 (live pairs x live
// triangles x 40 FMAs; a tile's bytes are its 6 KB of rows and a slab of at
// most 20 KB from L2). The bf16 mode's product runs on the tensor cores,
// which leaves the epilogue of every pair on the CUDA cores.
//
// The design, on the loop that K1, K2 and K3 share (cluster_scan.cuh): a
// block of four warps per pair tile, each warp testing an interleaved
// quarter of the cluster's live slots, each lane four pairs (g, g + 32,
// g + 64, g + 96), so one broadcast float4 feeds 16 FMAs. Before the slab
// is fetched the block votes on whether any of its pairs is live
// (t_max >= t_min); the run-padded tail of the stream is dead (its tiles
// carry cluster 0), and such a tile writes the miss key or 0 and returns
// without touching the table. A live tile's slots [0, nlive) arrive by one
// TMA bulk copy on an mbarrier while the lanes load their pairs' features.
// The key has no visit field (low bits = k_bits). K is a template parameter
// (32, 64, 128), which sizes the slab. The bf16 mode (the TPU kernel's
// precision="default") is its own kernel, `pair_scan_mma_kernel`, K1's
// tensor-core design for one visit (cluster_scan.cuh `test_rays_mma`):
// warp w's 32 pairs in A fragments of their rounded features, every warp
// walking all live slots in groups of four triangles of the table in
// fragment order (ops/visit_scan.py `mma_layout`), mma.sync m16n8k16 bf16
// products with float32 sums, the fp32 mode's epilogue on the
// accumulators, and a fold over each quad.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpair_scan.so pair_scan.cu
// Entry: pair_scan_launch(), plain C, returns cudaGetLastError().
#include "cluster_scan.cuh"

namespace {

using lumen::KEY_MISS;
using lumen::NF;
using lumen::RT;

constexpr int R = 4;            // pairs per thread
constexpr int G = RT / R;       // pair groups: the lanes of a warp
constexpr int SPLIT = 4;        // warps, one slice of triangles each
constexpr int THREADS = G * SPLIT;
static_assert(G == 32, "one warp per slice: its slab reads are broadcasts");

// One block per pair tile; warp s tests slots s, s + SPLIT, ...
template <int K, bool CLOSEST>
__global__ void __launch_bounds__(THREADS)
pair_scan_kernel(const float* __restrict__ rows,         // (S, 12)
                 const void* __restrict__ table,         // (C, K * 10) quads
                 const int* __restrict__ nlive,          // (C,) slots to test
                 const int* __restrict__ tile_cluster,   // (S / 128,)
                 int* __restrict__ out,                  // (S,)
                 int num_clusters, int k_bits)
{
    extern __shared__ __align__(128) float4 slab[];  // (K, 10) quads
    const float4* slabs = static_cast<const float4*>(table);
    __shared__ __align__(8) unsigned long long bar;
    __shared__ int part[SPLIT][RT];

    const int tid = threadIdx.x;
    const int g = tid % G;
    const int s = tid / G;
    const int tile = blockIdx.x;
    float tmin[R], tmax[R];
    int best[R], occ[R];
    bool live = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float* p = rows + ((size_t)tile * RT + g + r * G) * 12;
        tmin[r] = p[10];
        tmax[r] = p[11];
        live |= tmax[r] >= tmin[r];
        best[r] = KEY_MISS;  // dead pairs (t_max < t_min) never hit
        occ[r] = 0;
    }
    if (tid == 0) lumen::mbar_init(&bar);
    // the vote (its barrier also publishes the barrier's initialisation):
    // a tile with no live pair never touches the table
    if (__syncthreads_or(live)) {
        const int cl = min(max(tile_cluster[tile], 0), num_clusters - 1);
        const int nt = nlive[cl];
        if (tid == 0)
            lumen::bulk_load(slab, slabs + (size_t)cl * K * NF,
                             nt * NF * sizeof(float4), &bar);
        // the pairs' features load while the slab is in flight
        float rf[R][NF];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float* p = rows + ((size_t)tile * RT + g + r * G) * 12;
#pragma unroll
            for (int f = 0; f < NF; ++f) rf[r][f] = p[f];
        }
        lumen::mbar_wait(&bar, 0);
        lumen::test_rays<R, SPLIT, CLOSEST>(
            slab, s, nt, rf, tmin, tmax, ~((1 << k_bits) - 1), 0, best, occ);
        lumen::combine<R, SPLIT, CLOSEST>(part, g, s, best, occ);
    }
    if (s == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
            out[(size_t)tile * RT + g + r * G] = CLOSEST ? best[r] : occ[r];
    }
}

// The bf16 mode on the tensor cores: lane (g, q) of warp w holds pairs
// lumen::mma_row(w, g, r), r < 4; the same vote, one bulk copy of the
// cluster's nlive (a multiple of 4) slots in fragment order.
template <int K, bool CLOSEST>
__global__ void __launch_bounds__(THREADS)
pair_scan_mma_kernel(const float* __restrict__ rows,       // (S, 12)
                     const uint4* __restrict__ frags,      // (C, K / 4, 32)
                     const int* __restrict__ nlive,        // (C,) % 4 == 0
                     const int* __restrict__ tile_cluster, // (S / 128,)
                     int* __restrict__ out,                // (S,)
                     int num_clusters, int k_bits)
{
    constexpr int SLAB = lumen::mma_slab_uint4s<K>();
    extern __shared__ __align__(128) uint4 mslab[];
    __shared__ __align__(8) unsigned long long bar;

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int w = tid / 32;
    const int q = lane & 3;
    const int tile = blockIdx.x;
    const float* trows = rows + (size_t)tile * RT * 12;
    auto row = [&](int r) {
        return trows + lumen::mma_row(w, lane >> 2, r) * 12;
    };
    float tmin[4], tmax[4];
    int best[4], occ[4];
    bool live = false;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        tmin[r] = row(r)[10];
        tmax[r] = row(r)[11];
        live |= tmax[r] >= tmin[r];
        best[r] = KEY_MISS;  // dead pairs (t_max < t_min) never hit
        occ[r] = 0;
    }
    if (tid == 0) lumen::mbar_init(&bar);
    // the vote (its barrier also publishes the barrier's initialisation):
    // a tile with no live pair never touches the table
    if (__syncthreads_or(live)) {
        const int cl = min(max(tile_cluster[tile], 0), num_clusters - 1);
        const int nt = nlive[cl];
        if (tid == 0)
            lumen::bulk_load(mslab, frags + (size_t)cl * SLAB,
                             nt * (lumen::MMA_GROUP_BYTES / lumen::MMA_GROUP),
                             &bar);
        // the pairs' fragments form while the slab is in flight
        unsigned a[2][4];
        lumen::mma_ray_fragments(row, q, a, tmin, tmax);
        lumen::mbar_wait(&bar, 0);
        lumen::test_rays_mma<CLOSEST>(mslab, nt / lumen::MMA_GROUP, a, tmin,
                                      tmax, ~((1 << k_bits) - 1), 0, lane,
                                      best, occ);
        lumen::quad_fold<CLOSEST>(best, occ);
    }
    out[(size_t)tile * RT + lumen::mma_row(w, lane >> 2, q)] =
        CLOSEST ? lumen::quad_pick(best, q) : lumen::quad_pick(occ, q);
}

struct Args {
    const float* rows;
    const void* slabs;
    const int *nlive, *tile_cluster;
    int* out;
    int tiles, num_clusters, k_bits;
};

template <int K, bool CLOSEST>
int launch_mode(const Args& a, cudaStream_t s)
{
    const size_t smem = lumen::slab_float4s<K>() * sizeof(float4);
    pair_scan_kernel<K, CLOSEST><<<a.tiles, THREADS, smem, s>>>(
        a.rows, a.slabs, a.nlive, a.tile_cluster, a.out, a.num_clusters,
        a.k_bits);
    return static_cast<int>(cudaGetLastError());
}

template <int K, bool CLOSEST>
int launch_mma(const Args& a, cudaStream_t s)
{
    const size_t smem = lumen::mma_slab_uint4s<K>() * sizeof(uint4);
    pair_scan_mma_kernel<K, CLOSEST><<<a.tiles, THREADS, smem, s>>>(
        a.rows, static_cast<const uint4*>(a.slabs), a.nlive, a.tile_cluster,
        a.out, a.num_clusters, a.k_bits);
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

extern "C" int pair_scan_launch(const void* rows, const void* slabs,
                                const void* nlive, const void* tile_cluster,
                                void* out, int tiles, int num_clusters, int k,
                                int k_bits, int closest, int bf16,
                                void* stream)
{
    if (tiles == 0) return 0;
    const Args a{static_cast<const float*>(rows),
                 slabs,
                 static_cast<const int*>(nlive),
                 static_cast<const int*>(tile_cluster),
                 static_cast<int*>(out), tiles, num_clusters, k_bits};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (k) {
    case 32: return launch<32>(a, closest != 0, bf16 != 0, s);
    case 64: return launch<64>(a, closest != 0, bf16 != 0, s);
    case 128: return launch<128>(a, closest != 0, bf16 != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
