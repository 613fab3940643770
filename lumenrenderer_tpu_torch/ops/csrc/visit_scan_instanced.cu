// Kernel K2, the instanced visit scan: the visit scan of visit_scan.cu for
// two-level scenes, whose visits are (instance, cluster) units. Each visit
// maps the tile's world rays into the instance's object space with its
// world->object 3x4 affine, then runs the same slab test in world t. Hopper
// (sm_90a) port of the Pallas kernel `visit_scan_instanced` in
// lumenrenderer_tpu/ops/pallas/instanced.py:168; see
// ops/visit_scan_instanced.py for the contract and the plain PyTorch twin.
//
// What bounds it on an H100: fp32 FMA issue, as K1: live rays x live
// triangles x 40 FMAs per visit, beside which the affine (about 30 flops
// per ray and visit) is small. A unit mesh may hold far fewer triangles than
// K (a box: 12 of 128 slots), so the per-visit costs (vote, fold, barrier,
// the affine) weigh more than in K1. In the bf16 mode the product goes to
// the tensor cores, and what is left on the CUDA cores, each pair's
// epilogue and each visit's fixed cost (the vote, the wait, the features
// formed and traded), sets the pace.
//
// The design, on the loop that K1, K2 and K3 share (cluster_scan.cuh): a
// block of four warps per tile, each warp testing an interleaved quarter of
// a unit's live slots, each lane holding four rays' world origin and
// direction; per visit one thread copies the unit's live slots
// and its 12 affine floats into one of two shared buffers by TMA bulk
// copies on one mbarrier (the copy for visit i + 1 in flight while visit i
// is tested); every lane then forms its rays' object-space features from
// the affine (a broadcast) and tests them. The affine and the cross product
// use round-to-nearest intrinsics, which nvcc never contracts into FMAs, in
// the order of the plain twin, so the ten features equal the twin's bit for
// bit. K1's vote runs before every visit, so a tile whose lanes are all dead
// runs none; an optional counter gets the visits each tile ran. K is a
// template parameter (32, 64, 128), which sizes the buffers. Measured
// alternatives (one or two warps per tile, two rays a lane, buffers sized
// to the longest cluster) were no faster on the instanced passes.
// The bf16 mode (the TPU kernel's precision="default") is its own kernel,
// `visit_scan_instanced_mma_kernel`, on K1's tensor-core loop
// (cluster_scan.cuh `visit_loop_mma`, `test_rays_mma`; the table in
// fragment order, mma.sync m16n8k16 bf16 products with float32 sums, the
// closest vote ending a tile only when its lanes are dead, ROADMAP C-25).
// What is K2's own is that the A fragments change with every visit: the
// affine rides the unit's bulk copy, and each quad forms its four rays'
// object-space features once between its lanes, lane q its own ray q
// (`object_features`, then rounded to bfloat16 pairs), and trades the
// bf16x2 words by shuffles so that each lane holds the k slots of its
// fragments (`quad_fragments`). Forming all four rays in every lane does
// the affine and the cross product four times (PERF.md has both forms'
// times).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libvisit_scan_instanced.so visit_scan_instanced.cu
// Entry: visit_scan_instanced_launch(), plain C, returns cudaGetLastError().
#include "cluster_scan.cuh"

namespace {

using lumen::NF;
using lumen::RT;

constexpr int R = 4;            // rays per thread
constexpr int G = RT / R;       // ray groups: the lanes of a warp
constexpr int SPLIT = 4;        // warps, one slice of triangles each
constexpr int THREADS = G * SPLIT;
constexpr int AFFINE = 3;       // float4s of a visit's 3x4 affine
static_assert(G == 32, "one warp per slice: its slab reads are broadcasts");

// The ray (world origin and direction w) in the object space of the affine
// m, as the ten features [O x D, D, O, 1].
__device__ __forceinline__ void object_features(const float* m,
                                                const float (&w)[6],
                                                float (&r)[NF])
{
    const float ox = w[0], oy = w[1], oz = w[2];
    const float dx = w[3], dy = w[4], dz = w[5];
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

// The lane's A fragments for a visit under the affine m (row-major 3x4):
// lane (g, q) forms the features of its own ray q from its world origin and
// direction w and packs them into five bf16x2 words (features 2j, 2j + 1 in
// word j, rounded to nearest even); the quad then trades them so that lane
// q holds word q of rays 0-3 and, lane 0, word 4 (features 8 and 9; the
// other lanes' k slots 8-15 are zero). Word q is a 4 x 4 transpose across
// the quad, two stages of two shuffles; the words to send and the rays
// they belong to depend on q, so they are chosen by selects (an index into
// a register array that depends on the lane would put it in local memory).
__device__ __forceinline__ void quad_fragments(const float* m,
                                               const float (&w)[6], int lane,
                                               unsigned (&a)[2][4])
{
    constexpr unsigned ALL = 0xffffffffu;
    float f[NF];
    object_features(m, w, f);
    const unsigned w0 = lumen::bf16x2(f[0], f[1]);
    const unsigned w1 = lumen::bf16x2(f[2], f[3]);
    const unsigned w2 = lumen::bf16x2(f[4], f[5]);
    const unsigned w3 = lumen::bf16x2(f[6], f[7]);
    const unsigned w4 = lumen::bf16x2(f[8], f[9]);
    const int q = lane & 3;
    const bool q0 = q & 1, q1 = q & 2;
    // with lane q ^ 1: keep words q0 and 2 + q0, send the other two; then
    // words q0 and 2 + q0 of rays q (k0, k1) and q ^ 1 (r0, r1)
    const unsigned k0 = q0 ? w1 : w0, k1 = q0 ? w3 : w2;
    const unsigned r0 = __shfl_xor_sync(ALL, q0 ? w0 : w1, 1);
    const unsigned r1 = __shfl_xor_sync(ALL, q0 ? w2 : w3, 1);
    // with lane q ^ 2: keep word q, send word q ^ 2; then word q of rays
    // q (ka), q ^ 1 (kb), q ^ 2 (ra) and q ^ 3 (rb)
    const unsigned ka = q1 ? k1 : k0, kb = q1 ? r1 : r0;
    const unsigned ra = __shfl_xor_sync(ALL, q1 ? k0 : k1, 2);
    const unsigned rb = __shfl_xor_sync(ALL, q1 ? r0 : r1, 2);
    // rays 2 q1 and 2 q1 + 1 (e0, e1), the other pair (o0, o1)
    const unsigned e0 = q0 ? kb : ka, e1 = q0 ? ka : kb;
    const unsigned o0 = q0 ? rb : ra, o1 = q0 ? ra : rb;
    a[0][0] = q1 ? o0 : e0;
    a[0][1] = q1 ? o1 : e1;
    a[1][0] = q1 ? e0 : o0;
    a[1][1] = q1 ? e1 : o1;
    // word 4 of rays 1-3 from their lanes, kept by lane 0
    const int quad = lane & ~3;
    const unsigned x1 = __shfl_sync(ALL, w4, quad + 1);
    const unsigned x2 = __shfl_sync(ALL, w4, quad + 2);
    const unsigned x3 = __shfl_sync(ALL, w4, quad + 3);
    a[0][2] = q == 0 ? w4 : 0u;
    a[0][3] = q == 0 ? x1 : 0u;
    a[1][2] = q == 0 ? x2 : 0u;
    a[1][3] = q == 0 ? x3 : 0u;
}

// One block per tile (lumen::visit_loop): warp s tests slots s, s + SPLIT,
// ... of each unit's slab; its lane g holds rays g + r * G, in world space
// across the visits and in the unit's object space for each.
template <int K, bool CLOSEST>
__global__ void __launch_bounds__(THREADS)
visit_scan_instanced_kernel(
    const float* __restrict__ rayblk,  // (T, 8, 128) rows o, d, pad
    const float* __restrict__ wnd,     // (T, 128, 8) cols tmin, tmax, pad
    const float4* __restrict__ slabs,  // (C, K * 10) object-space quads
    const int* __restrict__ nlive,     // (C,) slots to test
    const int* __restrict__ sel_cl,    // (T, mv) cluster ids
    const float* __restrict__ minv12,  // (T, mv, 12) world -> object
    const int* __restrict__ nv,        // (T,) live visits
    const int* __restrict__ tnb,       // (T, mv) world entry-t bits
    int* __restrict__ out,             // (T, 128)
    int* __restrict__ visits,          // (T,) or null
    int num_clusters, int mv, int k_bits, int low_bits)
{
    const int g = threadIdx.x % G;
    const int tile = blockIdx.x;
    float wo[R][6], rf[R][NF], tmin[R], tmax[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float* rb = rayblk + (size_t)tile * 8 * RT + g + r * G;
#pragma unroll
        for (int f = 0; f < 6; ++f) wo[r][f] = rb[f * RT];  // coalesced
        const float* w = wnd + ((size_t)tile * RT + g + r * G) * 8;
        tmin[r] = w[0];
        tmax[r] = w[1];
    }
    lumen::visit_loop<K, AFFINE, R, SPLIT, CLOSEST>(
        slabs, nlive, sel_cl, nv, tnb, out, visits, num_clusters, mv, k_bits,
        low_bits, tmin, tmax,
        // the visit's affine lands after the unit's slab, on its barrier
        [&](int i, float4* dst, unsigned long long* bar) {
            lumen::bulk_copy(dst, minv12 + ((size_t)tile * mv + i) * 12,
                             AFFINE * sizeof(float4), bar);
        },
        [&](const float4* affine) -> const float(&)[R][NF] {
            float m[12];
            const float* mp = reinterpret_cast<const float*>(affine);
#pragma unroll
            for (int j = 0; j < 12; ++j) m[j] = mp[j];
#pragma unroll
            for (int r = 0; r < R; ++r) object_features(m, wo[r], rf[r]);
            return rf;
        });
}

// The bf16 mode: one block of four warps per tile on the tensor cores
// (lumen::visit_loop_mma); lane (g, q) of warp w holds the windows of rays
// lumen::mma_row(w, g, r), r < 4, and the world origin and direction of
// ray r = q, from which it and its quad form each visit's A fragments.
template <int K, bool CLOSEST>
__global__ void __launch_bounds__(THREADS)
visit_scan_instanced_mma_kernel(
    const float* __restrict__ rayblk,  // (T, 8, 128) rows o, d, pad
    const float* __restrict__ wnd,     // (T, 128, 8) cols tmin, tmax, pad
    const uint4* __restrict__ frags,   // (C, K / 4, 32) fragment order
    const int* __restrict__ nlive,     // (C,) % 4 == 0
    const int* __restrict__ sel_cl,    // (T, mv) cluster ids
    const float* __restrict__ minv12,  // (T, mv, 12) world -> object
    const int* __restrict__ nv,        // (T,) live visits
    int* __restrict__ out,             // (T, 128)
    int* __restrict__ visits,          // (T,) or null
    int num_clusters, int mv, int k_bits, int low_bits)
{
    const int lane = threadIdx.x % 32;
    const int w = threadIdx.x / 32;
    const int g = lane >> 2;
    const int tile = blockIdx.x;
    float wo[6], tmin[4], tmax[4];
    const float* rb =
        rayblk + (size_t)tile * 8 * RT + lumen::mma_row(w, g, lane & 3);
#pragma unroll
    for (int f = 0; f < 6; ++f) wo[f] = rb[f * RT];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const float* p =
            wnd + ((size_t)tile * RT + lumen::mma_row(w, g, r)) * 8;
        tmin[r] = p[0];
        tmax[r] = p[1];
    }
    unsigned a[2][4];
    lumen::visit_loop_mma<K, AFFINE, CLOSEST>(
        frags, nlive, sel_cl, nv, out, visits, num_clusters, mv, k_bits,
        low_bits, tmin, tmax,
        // the visit's affine lands after the unit's fragments, on their
        // barrier
        [&](int i, uint4* dst, unsigned long long* bar) {
            lumen::bulk_copy(dst, minv12 + ((size_t)tile * mv + i) * 12,
                             AFFINE * sizeof(uint4), bar);
        },
        [&](const uint4* affine) -> const unsigned(&)[2][4] {
            quad_fragments(reinterpret_cast<const float*>(affine), wo, lane,
                           a);
            return a;
        });
}

struct Args {
    const float *rayblk, *wnd;
    const void* slabs;
    const int *nlive, *sel_cl;
    const float* minv12;
    const int *nv, *tnb;
    int *out, *visits;
    int tiles, num_clusters, mv, k_bits, low_bits;
};

template <int K, bool CLOSEST>
int launch_mode(const Args& a, cudaStream_t s)
{
    const size_t smem =
        2 * (lumen::slab_float4s<K>() + AFFINE) * sizeof(float4);
    visit_scan_instanced_kernel<K, CLOSEST><<<a.tiles, THREADS, smem, s>>>(
        a.rayblk, a.wnd, static_cast<const float4*>(a.slabs), a.nlive,
        a.sel_cl, a.minv12, a.nv, a.tnb, a.out, a.visits, a.num_clusters,
        a.mv, a.k_bits, a.low_bits);
    return static_cast<int>(cudaGetLastError());
}

template <int K, bool CLOSEST>
int launch_mma(const Args& a, cudaStream_t s)
{
    const size_t smem =
        2 * (lumen::mma_slab_uint4s<K>() + AFFINE) * sizeof(uint4);
    visit_scan_instanced_mma_kernel<K, CLOSEST>
        <<<a.tiles, THREADS, smem, s>>>(
        a.rayblk, a.wnd, static_cast<const uint4*>(a.slabs), a.nlive,
        a.sel_cl, a.minv12, a.nv, a.out, a.visits, a.num_clusters, a.mv,
        a.k_bits, a.low_bits);
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

extern "C" int visit_scan_instanced_launch(
    const void* rayblk, const void* wnd, const void* slabs, const void* nlive,
    const void* sel_cl, const void* minv12, const void* nv, const void* tnb,
    void* out, void* visits, int tiles, int num_clusters, int k, int mv,
    int k_bits, int low_bits, int closest, int bf16, void* stream)
{
    if (tiles == 0) return 0;
    const Args a{static_cast<const float*>(rayblk),
                 static_cast<const float*>(wnd),
                 slabs,
                 static_cast<const int*>(nlive),
                 static_cast<const int*>(sel_cl),
                 static_cast<const float*>(minv12),
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
