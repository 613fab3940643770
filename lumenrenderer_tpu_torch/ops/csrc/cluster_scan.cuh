// Shared device code of the cluster intersection kernels K1 (visit_scan.cu),
// K2 (visit_scan_instanced.cu) and K3 (pair_scan.cu): Möller–Trumbore
// written as the bilinear form f (10) · tri_feat (10, 4K), tested by one
// loop for all three in fp32 (`test_rays`), the tensor-core loop of their
// bf16 mode (`test_rays_mma`), the TMA bulk copy that feeds them, and the
// visit loops of K1 and K2 (`visit_loop`, `visit_loop_mma`).
//
// Each kernel has two modes. fp32 (the TPU kernels' "highest"): the table
// and the rays' features in float32, on the CUDA cores. bf16 (their
// "default", one bf16 MXU pass): the rays' ten features are rounded to
// bfloat16 (round to nearest even), K1's and K3's once, K2's per visit
// after they are formed in instance space, and the table arrives as
// bfloat16 in fragment order (`mma_layout`). The product runs on the
// tensor cores, one mma.sync m16n8k16 per 16 rays and two triangles'
// (det, u) or (v, t) columns, the ten features padded to the 16 of one
// k-step; the products are exact and the tensor cores sum them in their
// own way (ops/mma_probe.py measures it; `visit_scan.mma_product` is the
// twins' copy). In both modes t_min, t_max and the hit test stay float32.
//
// The fp32 loop's shape: a block of SPLIT slices per 128-ray tile, slice s
// testing the slots s, s + SPLIT, ... of a cluster's live slots; each
// thread of a slice holds R rays (g, g + G, ...), so one broadcast float4
// of the slab feeds 4R FMAs. Each ray's FMA order over the ten features is
// that of the plain twins (`slab_hits` in ops/visit_scan.py), so keys and
// bits equal theirs. The slabs arrive in the kernels' order
// (ops/visit_scan.py `slab_layout`): a cluster's live slots are one
// contiguous block of nlive · 10 float4s, which one thread copies into
// shared memory with one TMA bulk copy completed on an mbarrier.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lumen {

constexpr int RT = 128;               // rays (pairs) per tile
constexpr int NF = 10;                // ray features [o x d, d, o, 1]
constexpr int KEY_MISS = 0x7F000000;  // closest-mode "no hit" key

// One m16n8k16 tensor-core product with bfloat16 inputs and float32 sums,
// from zero: d = a · b. The fragments are PTX's (lane = 4 g + q): a holds
// bf16x2 pairs (row g, k 2q, 2q + 1), (g + 8, 2q, 2q + 1), (g, 2q + 8,
// 2q + 9), (g + 8, 2q + 8, 2q + 9); b holds (k 2q, 2q + 1; column g),
// (2q + 8, 2q + 9; g); d holds (row g, columns 2q, 2q + 1), (g + 8, 2q,
// 2q + 1). The lower k index sits in each pair's low half.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f));
}

// -- the bf16 mode of K1, K2 and K3 on the tensor cores --------------------
//
// A block of four warps per 128-ray (pair) tile; warp w owns rows 32 w ...
// 32 w + 31, two m16 tiles. Lane (g, q) = (lane >> 2, lane & 3) holds the A
// fragments of both (8 registers, the rounded features: K1's and K3's made
// once, K2's per visit) and, in its accumulators, rows 32 w + 16 mt + 8 h
// + g (mt, h in {0, 1}): its four rays, numbered r = 2 mt + h. The table comes in groups of four
// triangles; a group is two n8 tiles whose columns interleave (det0, u0,
// det1, u1, ...) and (v0, t0, ...), so lane (g, q) finds det, u, v and t of
// the group's triangle q for its four rays in its own accumulators. Each
// lane's fragments of a group are one 16-byte load: 512 contiguous bytes a
// group, 128 a triangle, free of bank conflicts.
constexpr int MMA_GROUP = 4;           // triangles per group
constexpr int MMA_GROUP_BYTES = 512;   // 32 lanes x 16 bytes

template <int K>
__host__ __device__ constexpr int mma_slab_uint4s()
{
    return K / MMA_GROUP * 32;
}

// The tile's row of the lane's ray r (warp w, lane group g).
__device__ __forceinline__ int mma_row(int w, int g, int r)
{
    return 32 * w + 16 * (r >> 1) + 8 * (r & 1) + g;
}

// Two values rounded to bfloat16 (nearest even), the first in the low half.
__device__ __forceinline__ unsigned bf16x2(float lo, float hi)
{
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
}

// The lane's A fragments (k slot f holds feature f; slots 10-15 are zero)
// and windows from its rays' rows (row(r) -> 12 floats: the ten features,
// t_min, t_max).
template <class Row>
__device__ __forceinline__ void mma_ray_fragments(Row row, int q,
                                                  unsigned (&a)[2][4],
                                                  float (&tmin)[4],
                                                  float (&tmax)[4])
{
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const float* p = row(r);
        const int mt = r >> 1, h = r & 1;
        a[mt][h] = bf16x2(p[2 * q], p[2 * q + 1]);
        a[mt][2 + h] = q == 0 ? bf16x2(p[8], p[9]) : 0u;
        tmin[r] = p[10];
        tmax[r] = p[11];
    }
}

// Fold the quad's keys (bits) so that its four lanes each hold the minimum
// (OR) of every ray r.
template <bool CLOSEST>
__device__ __forceinline__ void quad_fold(int (&best)[4], int (&occ)[4])
{
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            if (CLOSEST)
                best[r] = min(best[r], __shfl_xor_sync(0xffffffffu, best[r], o));
            else
                occ[r] |= __shfl_xor_sync(0xffffffffu, occ[r], o);
        }
    }
}

// The value of ray r = q of the lane (every lane of a folded quad holds all
// four; lane q writes one).
__device__ __forceinline__ int quad_pick(const int (&v)[4], int q)
{
    return q == 0 ? v[0] : q == 1 ? v[1] : q == 2 ? v[2] : v[3];
}

// Test the lane's four rays against triangle 4 j + q of each group j < ng
// of a slab in fragment order. Closest mode folds the packed key
// (t's float bits & low_mask) | visit_field | slot into best; any mode ORs
// hits into occ. The epilogue is test_rays' on the accumulators, its
// window test behind one branch for the lane's four pairs (measured: one
// branch a pair, and none, were slower).
template <bool CLOSEST>
__device__ __forceinline__ void test_rays_mma(
    const uint4* __restrict__ slab, int ng, const unsigned (&a)[2][4],
    const float (&tmin)[4], const float (&tmax)[4], int low_mask,
    int visit_field, int lane, int (&best)[4], int (&occ)[4])
{
    const int q = lane & 3;
#pragma unroll 1
    for (int j = 0; j < ng; ++j) {
        const uint4 b = slab[j * 32 + lane];
        float du[2][4], vt[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            mma_bf16_16816(du[mt], a[mt], b.x, b.y);
            mma_bf16_16816(vt[mt], a[mt], b.z, b.w);
        }
        bool in[4];
        float ts[4], ad[4];
        bool any_in = false;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int mt = r >> 1, h = r & 1;
            const float det = du[mt][2 * h], un = du[mt][2 * h + 1];
            const float vn = vt[mt][2 * h], tn = vt[mt][2 * h + 1];
            // sign(det) * x, exactly, as a flip of x's sign bit; det == 0
            // (padding slots) fails ad > 1e-12 either way
            const unsigned sg = __float_as_uint(det) & 0x80000000u;
            ad[r] = fabsf(det);
            const float us = __uint_as_float(__float_as_uint(un) ^ sg);
            const float vs = __uint_as_float(__float_as_uint(vn) ^ sg);
            ts[r] = __uint_as_float(__float_as_uint(tn) ^ sg);
            in[r] = (ad[r] > 1e-12f) && (us >= 0.f) && (vs >= 0.f) &&
                    (us + vs <= ad[r]);
            any_in |= in[r];
        }
        // rays meet few of a cluster's triangles: one branch skips the
        // window tests of the lane's four pairs
        if (any_in) {
            bool hit[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
                hit[r] = in[r] && (ts[r] > tmin[r] * ad[r]) &&
                         (ts[r] <= tmax[r] * ad[r]);
            if (CLOSEST) {
                const int slot = j * MMA_GROUP + q;
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    if (hit[r]) {
                        const int tb =
                            __float_as_int(fmaxf(ts[r] / ad[r], 0.f));
                        best[r] = min(best[r],
                                      (tb & low_mask) | visit_field | slot);
                    }
                }
            } else {
#pragma unroll
                for (int r = 0; r < 4; ++r) occ[r] |= hit[r] ? 1 : 0;
            }
        }
    }
}

// Test the thread's R rays against slots j0, j0 + SPLIT, ... below nt of a
// slab ((K, 10) quadruples, triangle j's ten (det, u, v, t) quadruples in a
// row). Closest mode folds the packed key
// (t's float bits & low_mask) | visit_field | slot into best; any mode ORs
// hits into occ.
template <int R, int SPLIT, bool CLOSEST>
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

// Fold the slices' keys (bits) of each ray through `part` (SPLIT, RT) in
// shared memory so that every slice holds the ray's minimum (OR); thread g
// of slice s holds rays g + r * (RT / R). Ends with the block synchronised.
template <int R, int SPLIT, bool CLOSEST>
__device__ __forceinline__ void combine(int (*part)[RT], int g, int s,
                                        int (&best)[R], int (&occ)[R])
{
    constexpr int G = RT / R;
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

// Hopper's 1-D bulk copy (TMA) from global into shared memory, completed on
// an mbarrier that counts the bytes.
__device__ __forceinline__ unsigned smem_addr(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One expected arrival per phase: the thread that issues the copies.
__device__ __forceinline__ void mbar_init(unsigned long long* bar)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive on the barrier's current phase, which then completes when `bytes`
// more have landed through bulk_copy.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned), counted
// on the barrier's current phase.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                    "r"(smem_addr(bar)) : "memory");
}

// One copy that completes the barrier's current phase.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar)
{
    mbar_expect(bar, bytes);
    bulk_copy(dst, src, bytes, bar);
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

// The fp32 visit loop of K1 and K2 for the block's tile (blockIdx.x):
// SPLIT warps, thread g of warp s holding the rays g + r * (RT / R) with
// windows [tmin, tmax] (tmax < tmin: a padded or terminated lane). Before
// each of the tile's min(nv, mv) visits a block-wide vote ends the tile
// when no live ray can still improve (closest: visit i starts no nearer
// than its entry-t key tnb[., i]) or every lane is occluded or dead (any);
// it is conservative, so the result equals a full scan. Visit i's cluster
// is sel[., i], clamped to the table; one thread copies its live slots,
// then the EXTRA float4s that extra(i, dst, bar) copies on the same
// barrier, into one of two shared buffers, the copy for visit i + 1 in
// flight while visit i is tested. Each buffer's mbarrier phase parity is
// its use count. rays(extra) returns the rays' ten features for the visit
// (an array of the kernel's registers), given the buffer's EXTRA float4s.
// Writes the tile's keys (bits) to out (T, 128) (dead lanes: closest 0,
// any 1; callers mask them) and, unless visits is null, the number of
// visits run to visits (T,). The table holds (C, K · 10) float4
// quadruples. The dynamic shared memory holds the two buffers:
// 2 (slab_float4s<K>() + EXTRA) float4s.
template <int K>
__host__ __device__ constexpr int slab_float4s()
{
    return K * NF;
}

template <int K, int EXTRA, int R, int SPLIT, bool CLOSEST, class Extra,
          class Rays>
__device__ __forceinline__ void visit_loop(
    const float4* __restrict__ slabs, const int* __restrict__ nlive,
    const int* __restrict__ sel, const int* __restrict__ nv,
    const int* __restrict__ tnb, int* __restrict__ out,
    int* __restrict__ visits, int num_clusters, int mv, int k_bits,
    int low_bits, const float (&tmin)[R], const float (&tmax)[R],
    Extra extra, Rays rays)
{
    constexpr int G = RT / R;
    constexpr int SLAB = slab_float4s<K>();        // float4s
    constexpr int STRIDE = SLAB + EXTRA;           // one buffer
    extern __shared__ __align__(128) float4 buf[];
    __shared__ __align__(8) unsigned long long bar[2];
    __shared__ int part[SPLIT][RT];

    const int tid = threadIdx.x;
    const int g = tid % G;
    const int s = tid / G;
    const int tile = blockIdx.x;
    bool dead[R];
    int best[R], occ[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        dead[r] = tmax[r] < tmin[r];
        best[r] = KEY_MISS;
        occ[r] = dead[r] ? 1 : 0;
    }
    if (tid == 0) {
        mbar_init(&bar[0]);
        mbar_init(&bar[1]);
    }
    const int n = min(nv[tile], mv);
    const int* tsel = sel + (size_t)tile * mv;
    const int* ttnb = tnb + (size_t)tile * mv;
    const int low_mask = ~((1 << low_bits) - 1);
    auto cluster = [&](int i) {
        return min(max(tsel[i], 0), num_clusters - 1);
    };
    // the live slots only (padding is at each cluster's tail)
    auto fetch = [&](int i) {
        const int cl = cluster(i);
        float4* dst = buf + (i & 1) * STRIDE;
        const unsigned bytes = nlive[cl] * NF * sizeof(float4);
        mbar_expect(&bar[i & 1], bytes + EXTRA * sizeof(float4));
        bulk_copy(dst, slabs + (size_t)cl * K * NF, bytes, &bar[i & 1]);
        extra(i, dst + SLAB, &bar[i & 1]);
    };

    int ran = 0;
    for (int i = 0; i < n; ++i) {
        // the vote before visit i (its barrier also publishes the barriers'
        // initialisation and releases the buffer of visit i - 1)
        combine<R, SPLIT, CLOSEST>(part, g, s, best, occ);
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
        const float4* slot = buf + (i & 1) * STRIDE;
        mbar_wait(&bar[i & 1], (i >> 1) & 1);
        const float(&rf)[R][NF] = rays(slot + SLAB);
        test_rays<R, SPLIT, CLOSEST>(slot, s, nt, rf, tmin, tmax, low_mask,
                                     i << k_bits, best, occ);
        ran = i + 1;
    }
    // a copy issued for a visit that the vote skipped must land before the
    // block's shared memory is released
    if (tid == 0 && ran > 0 && ran < n)
        mbar_wait(&bar[ran & 1], (ran >> 1) & 1);
    combine<R, SPLIT, CLOSEST>(part, g, s, best, occ);
    if (s == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
            out[(size_t)tile * RT + g + r * G] =
                CLOSEST ? (dead[r] ? 0 : best[r]) : occ[r];
    }
    if (visits != nullptr && tid == 0) visits[tile] = ran;
}

// The bf16 visit loop of K1 and K2 for the block's tile (blockIdx.x), on
// the tensor cores: four warps, lane (g, q) of warp w holding the windows of
// its four rays (`mma_row`). Before each of the tile's min(nv, mv) visits a
// block-wide vote ends the tile when every lane is occluded or dead (any)
// or, closest, when every lane is dead: a rounded triangle may lie nearer
// than its cluster's fp32 box, so the entry-t test of the fp32 mode does
// not apply (ROADMAP C-25), and the result equals a full scan. Visit i's
// cluster is sel[., i], clamped to the table; one thread copies its nlive
// (a multiple of 4) slots in fragment order, nlive · 128 bytes, then the
// EXTRA uint4s that extra(i, dst, bar) copies on the same barrier, into one
// of two shared buffers, the copy for visit i + 1 in flight while visit i
// is tested. frags(extra) returns the lane's A fragments for the visit (an
// array of the kernel's registers: K1 its fragments made once, K2 those it
// forms from the visit's affine), given the buffer's EXTRA uint4s. Warps
// own disjoint rays, so only the lanes of a quad fold their keys (bits).
// Writes out (T, 128) (dead lanes: closest 0, any 1) and, unless visits is
// null, the visits run. The dynamic shared memory holds the two buffers:
// 2 (mma_slab_uint4s<K>() + EXTRA) uint4s.
template <int K, int EXTRA, bool CLOSEST, class Extra, class Frags>
__device__ __forceinline__ void visit_loop_mma(
    const uint4* __restrict__ table, const int* __restrict__ nlive,
    const int* __restrict__ sel, const int* __restrict__ nv,
    int* __restrict__ out, int* __restrict__ visits, int num_clusters,
    int mv, int k_bits, int low_bits, const float (&tmin)[4],
    const float (&tmax)[4], Extra extra, Frags frags)
{
    constexpr int SLAB = mma_slab_uint4s<K>();
    constexpr int STRIDE = SLAB + EXTRA;           // one buffer
    extern __shared__ __align__(128) uint4 mbuf[];
    __shared__ __align__(8) unsigned long long bar[2];

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int w = tid / 32;
    const int tile = blockIdx.x;
    bool dead[4];
    int best[4], occ[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        dead[r] = tmax[r] < tmin[r];
        best[r] = KEY_MISS;
        occ[r] = dead[r] ? 1 : 0;
    }
    if (tid == 0) {
        mbar_init(&bar[0]);
        mbar_init(&bar[1]);
    }
    const int n = min(nv[tile], mv);
    const int* tsel = sel + (size_t)tile * mv;
    const int low_mask = ~((1 << low_bits) - 1);
    auto cluster = [&](int i) {
        return min(max(tsel[i], 0), num_clusters - 1);
    };
    auto fetch = [&](int i) {
        const int cl = cluster(i);
        uint4* dst = mbuf + (i & 1) * STRIDE;
        const unsigned bytes = nlive[cl] * (MMA_GROUP_BYTES / MMA_GROUP);
        mbar_expect(&bar[i & 1], bytes + EXTRA * sizeof(uint4));
        bulk_copy(dst, table + (size_t)cl * SLAB, bytes, &bar[i & 1]);
        extra(i, dst + SLAB, &bar[i & 1]);
    };

    int ran = 0;
    for (int i = 0; i < n; ++i) {
        // the vote before visit i (its barrier also publishes the barriers'
        // initialisation and releases the buffer of visit i - 1)
        bool done = true;
        if (!CLOSEST) quad_fold<false>(best, occ);
#pragma unroll
        for (int r = 0; r < 4; ++r) done &= CLOSEST ? dead[r] : occ[r] != 0;
        if (__syncthreads_and(done)) break;
        if (tid == 0) {
            if (i == 0) fetch(0);
            if (i + 1 < n) fetch(i + 1);
        }
        const int ng = nlive[cluster(i)] / MMA_GROUP;
        const uint4* slot = mbuf + (i & 1) * STRIDE;
        mbar_wait(&bar[i & 1], (i >> 1) & 1);
        const unsigned(&a)[2][4] = frags(slot + SLAB);
        test_rays_mma<CLOSEST>(slot, ng, a, tmin, tmax, low_mask,
                               i << k_bits, lane, best, occ);
        ran = i + 1;
    }
    // a copy issued for a visit that the vote skipped must land before the
    // block's shared memory is released
    if (tid == 0 && ran > 0 && ran < n)
        mbar_wait(&bar[ran & 1], (ran >> 1) & 1);
    quad_fold<CLOSEST>(best, occ);
    const int q = lane & 3;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        if (CLOSEST && dead[r]) best[r] = 0;
    }
    out[(size_t)tile * RT + mma_row(w, lane >> 2, q)] =
        CLOSEST ? quad_pick(best, q) : quad_pick(occ, q);
    if (visits != nullptr && tid == 0) visits[tile] = ran;
}

}  // namespace lumen
