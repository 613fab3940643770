// Kernel K3, the pair scan: closest-hit keys or occlusion bits for 128-pair
// tiles, each tile a run of (ray, cluster) pairs of one cluster. Hopper
// (sm_90a) port of the Pallas kernel `pair_scan` (resident and streamed
// variants) in lumenrenderer_tpu/ops/pallas/pair_intersect.py:129; see
// ops/pair_scan.py for the contract and the plain PyTorch twin.
//
// What bounds it on an H100: fp32 FMA issue, as K1 (live pairs x live
// triangles x 40 FMAs; a tile's bytes are its 6 KB of rows and a slab of at
// most 20 KB from L2).
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
// precision="default", cluster_scan.cuh) is a template flag: a bfloat16
// table and the pairs' features rounded once when loaded.
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
template <int K, bool CLOSEST, bool BF16>
__global__ void __launch_bounds__(THREADS)
pair_scan_kernel(const float* __restrict__ rows,         // (S, 12)
                 const void* __restrict__ table,         // (C, K * 10) quads
                 const int* __restrict__ nlive,          // (C,) slots to test
                 const int* __restrict__ tile_cluster,   // (S / 128,)
                 int* __restrict__ out,                  // (S,)
                 int num_clusters, int k_bits)
{
    using Q = typename lumen::Quad<BF16>::T;
    extern __shared__ __align__(128) float4 smem[];
    Q* slab = reinterpret_cast<Q*>(smem);            // (K, 10) quads
    const Q* slabs = static_cast<const Q*>(table);
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
                             nt * NF * sizeof(Q), &bar);
        // the pairs' features load while the slab is in flight
        float rf[R][NF];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float* p = rows + ((size_t)tile * RT + g + r * G) * 12;
#pragma unroll
            for (int f = 0; f < NF; ++f) rf[r][f] = p[f];
        }
        lumen::mode_features<BF16>(rf);
        lumen::mbar_wait(&bar, 0);
        lumen::test_rays<R, SPLIT, CLOSEST, BF16>(
            slab, s, nt, rf, tmin, tmax, ~((1 << k_bits) - 1), 0, best, occ);
        lumen::combine<R, SPLIT, CLOSEST>(part, g, s, best, occ);
    }
    if (s == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
            out[(size_t)tile * RT + g + r * G] = CLOSEST ? best[r] : occ[r];
    }
}

struct Args {
    const float* rows;
    const void* slabs;
    const int *nlive, *tile_cluster;
    int* out;
    int tiles, num_clusters, k_bits;
};

template <int K, bool CLOSEST, bool BF16>
int launch_mode(const Args& a, cudaStream_t s)
{
    const size_t smem = lumen::slab_float4s<K, BF16>() * sizeof(float4);
    pair_scan_kernel<K, CLOSEST, BF16><<<a.tiles, THREADS, smem, s>>>(
        a.rows, a.slabs, a.nlive, a.tile_cluster, a.out, a.num_clusters,
        a.k_bits);
    return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch(const Args& a, bool closest, bool bf16, cudaStream_t s)
{
    if (bf16)
        return closest ? launch_mode<K, true, true>(a, s)
                       : launch_mode<K, false, true>(a, s);
    return closest ? launch_mode<K, true, false>(a, s)
                   : launch_mode<K, false, false>(a, s);
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
