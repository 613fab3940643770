// Visit scan: closest-hit keys or occlusion bits for 128-ray tiles against
// their ordered lists of triangle clusters (Möller–Trumbore as a bilinear
// form). Hopper (sm_90a) port of the Pallas kernel `visit_scan` in
// lumenrenderer_tpu/ops/pallas/intersect.py; see ops/visit_scan.py for the
// contract, the plain PyTorch twin and the design notes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libvisit_scan.so visit_scan.cu
// Entry: visit_scan_launch(), plain C, returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int RT = 128;               // rays per tile = threads per block
constexpr int NF = 10;                // ray features [o x d, d, o, 1]
constexpr int KEY_MISS = 0x7F000000;  // closest-mode "no hit" key

// One block per tile, one thread per ray. Per visit the block copies the
// cluster's (10, 4K) coefficient slab to shared memory, transposed so that
// triangle j's ten (det, u, v, t) coefficient quadruples are ten float4s;
// every thread then reads the same float4 (a broadcast) for 4 FMAs.
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
    float* slab_f = reinterpret_cast<float*>(slab);

    const int tile = blockIdx.x;
    const int lane = threadIdx.x;
    const float* rf = rf_t + ((size_t)tile * RT + lane) * 12;
    float r[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) r[f] = rf[f];
    const float tmin = rf[10];
    const float tmax = rf[11];
    const bool dead = tmax < tmin;  // padded or terminated lane

    const int n = min(nv[tile], mv);
    const int low_mask = ~((1 << low_bits) - 1);
    const int fk = 4 * k;
    const int slab_len = NF * fk;
    const int* tile_sel = sel + (size_t)tile * mv;
    const int* tile_tnb = tnb + (size_t)tile * mv;

    int best = KEY_MISS;
    int occ = dead ? 1 : 0;

    for (int i = 0; i < n; ++i) {
        const int cl = min(max(tile_sel[i], 0), num_clusters - 1);
        const float* src = feats + (size_t)cl * slab_len;
        // global (f, q*K + j) -> shared ((j*10 + f)*4 + q); the previous
        // visit's readers were released by the barrier at the loop's end
        for (int e = lane; e < slab_len; e += RT) {
            const int f = e / fk;
            const int c = e - f * fk;
            const int q = c / k;
            const int j = c - q * k;
            slab_f[(j * NF + f) * 4 + q] = __ldg(src + e);
        }
        __syncthreads();

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
                    // packed key: t's float bits (order-preserving for
                    // t >= 0) above the visit position and triangle slot
                    const int tb = __float_as_int(fmaxf(ts / ad, 0.f));
                    best = min(best, (tb & low_mask) | (i << k_bits) | j);
                }
            } else {
                occ |= hit ? 1 : 0;
            }
        }

        // block-wide early-out (conservative, so checked every visit):
        // closest stops when no live ray can still improve, given that
        // later visits start no nearer than the next entry t; any stops
        // when every lane is occluded or dead
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
