// Kernel T, the per-ray BVH walk of the "sah", "bvh" and "lbvh" accels: for
// each ray, a near-first stack walk of the BVH with best-t culling and
// Möller–Trumbore over each leaf's slots, in closest or any mode. The JAX
// package runs this walk as an XLA while_loop under vmap
// (lumenrenderer_tpu/accel/traverse.py:60 `_traverse_scalar`), with no Pallas
// kernel; ops/bvh_traverse.py holds the contract and the plain PyTorch twin.
//
// What bounds it on an H100: each ray's chain of dependent loads (pop, read
// the node's children, test their boxes, push) and the divergence of the
// rays of a warp, which walk different paths of different lengths. The
// operations (26 per box test, 54 per ray-triangle test: ops/bvh_traverse.py
// BOX_TEST_OPS and SLOT_TEST_OPS) and the bytes
// (the rays in, the results out, the BVH once: 0.6 MB for the interior
// scene, which stays in L2) are far below that. The frame sorts its bounce
// rays by octant and Morton code and its shadow rays by capsule, so the
// threads of a warp start near each other and walk similar paths.
//
// The design, simple and right first: one thread per ray, 128 to a block,
// the stack of max_depth + 2 entries in local memory (cap 64, checked by the
// wrapper before launch; a walk that would outgrow max_depth + 2 stops and
// sets the error word instead of writing past it). Rounding follows the
// twin (ops/bvh_traverse.py gives why): the cross and dot products' fused
// multiply-adds of the reference's CPU build as the float32 rounding of a
// float64 a b + c, every other product and sum rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn: nvcc contracts nothing), in the twin's
// order; divisions are IEEE (no fast-math in the build), and min and max
// propagate NaN as torch.minimum and jnp.max do. So t, u and v equal the
// twin's bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbvh_traverse.so bvh_traverse.cu
// Entry: bvh_traverse_launch(), plain C, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 128;
constexpr int STACK_CAP = 64;   // ops/bvh_traverse.py STACK_CAP
constexpr float BIG = 3.4e38f;

__device__ __forceinline__ float nmin(float a, float b)
{
    return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float nmax(float a, float b)
{
    return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p, int i)
{
    return V3{__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}

// a b + c rounded once to double (a b is exact there), then to float
__device__ __forceinline__ float fma_d(float a, float b, float c)
{
    return __double2float_rn(__dadd_rn(__dmul_rn(a, b), c));
}

__device__ __forceinline__ float dot(V3 a, V3 b)
{
    return fma_d(a.z, b.z, fma_d(a.y, b.y, mul(a.x, b.x)));
}

__device__ __forceinline__ V3 cross(V3 a, V3 b)
{
    return V3{fma_d(a.y, b.z, -mul(a.z, b.y)),
              fma_d(a.z, b.x, -mul(a.x, b.z)),
              fma_d(a.x, b.y, -mul(a.y, b.x))};
}

__device__ __forceinline__ float rcp(float x)
{
    return fabsf(x) > 1e-20f ? 1.0f / x : (x >= 0.f ? 1e20f : -1e20f);
}

struct Ray {
    V3 o, d, inv;
    float t_min;
};

// slab test of node i's box with cap `cap`: hit, and entry t in `near`
__device__ __forceinline__ bool box(const float* __restrict__ lo,
                                    const float* __restrict__ hi, int i,
                                    const Ray& r, float cap, float& near)
{
    const V3 l = load3(lo, i), h = load3(hi, i);
    const float x0 = mul(sub(l.x, r.o.x), r.inv.x), x1 = mul(sub(h.x, r.o.x), r.inv.x);
    const float y0 = mul(sub(l.y, r.o.y), r.inv.y), y1 = mul(sub(h.y, r.o.y), r.inv.y);
    const float z0 = mul(sub(l.z, r.o.z), r.inv.z), z1 = mul(sub(h.z, r.o.z), r.inv.z);
    const float tn = nmax(nmax(nmin(x0, x1), nmin(y0, y1)), nmin(z0, z1));
    const float tf = nmin(nmin(nmax(x0, x1), nmax(y0, y1)), nmax(z0, z1));
    near = nmax(tn, r.t_min);
    return tn <= tf && tf >= r.t_min && tn <= cap;
}

struct Hit {
    float t, u, v;
};

// Möller–Trumbore of slot s: t (BIG on a miss), u, v
__device__ __forceinline__ Hit slot_test(const float* __restrict__ p0,
                                         const float* __restrict__ e1,
                                         const float* __restrict__ e2,
                                         const int* __restrict__ tri_id,
                                         int s, const Ray& r)
{
    const V3 a = load3(e1, s), b = load3(e2, s), p = load3(p0, s);
    const V3 pvec = cross(r.d, b);
    const float det = dot(a, pvec);
    const bool ok = fabsf(det) > 1e-9f;
    const float inv = ok ? 1.0f / det : 0.f;
    const V3 tvec{sub(r.o.x, p.x), sub(r.o.y, p.y), sub(r.o.z, p.z)};
    const float u = mul(dot(tvec, pvec), inv);
    const V3 qvec = cross(tvec, a);
    const float v = mul(dot(r.d, qvec), inv);
    const float t = mul(dot(b, qvec), inv);
    const bool hit = ok && u >= 0.f && v >= 0.f && add(u, v) <= 1.f &&
                     t > r.t_min && __ldg(tri_id + s) >= 0;
    return Hit{hit ? t : BIG, u, v};
}

template <bool ANY>
__global__ void __launch_bounds__(THREADS)
bvh_traverse_kernel(const float* __restrict__ node_lo,
                    const float* __restrict__ node_hi,
                    const int* __restrict__ child0,
                    const int* __restrict__ child1,
                    const float* __restrict__ tri_p0,
                    const float* __restrict__ tri_e1,
                    const float* __restrict__ tri_e2,
                    const int* __restrict__ tri_id,
                    const float* __restrict__ orig,
                    const float* __restrict__ dirs,
                    const float* __restrict__ t_min,
                    const float* __restrict__ t_max,
                    float* __restrict__ t_out, int* __restrict__ tri_out,
                    float* __restrict__ u_out, float* __restrict__ v_out,
                    bool* __restrict__ hit_out, int* __restrict__ counts,
                    int* __restrict__ error, int n_rays, int leaf_size,
                    int max_stack)
{
    const int ray = blockIdx.x * THREADS + threadIdx.x;
    if (ray >= n_rays) return;
    Ray r;
    r.o = load3(orig, ray);
    r.d = load3(dirs, ray);
    r.inv = V3{rcp(r.d.x), rcp(r.d.y), rcp(r.d.z)};
    r.t_min = t_min[ray];
    float best_t = t_max[ray], bu = 0.f, bv = 0.f;
    int best_tri = -1, inner = 0, leaves = 0;
    int stack[STACK_CAP];
    int sp = 0;
    float near;
    if (box(node_lo, node_hi, 0, r, best_t, near)) stack[sp++] = 0;
    while (sp > 0 && !(ANY && best_tri >= 0)) {
        const int node = stack[--sp];
        const int c0 = __ldg(child0 + node);
        if (c0 >= 0) {
            ++inner;
            const int c1 = __ldg(child1 + node);
            float t0, t1;
            const bool h0 = box(node_lo, node_hi, c0, r, best_t, t0);
            const bool h1 = box(node_lo, node_hi, c1, r, best_t, t1);
            const bool swap = t1 < t0;
            const bool h_far = swap ? h0 : h1, h_near = swap ? h1 : h0;
            if (sp + int(h_far) + int(h_near) > max_stack) {
                atomicOr(error, 1);
                break;
            }
            if (h_far) stack[sp++] = swap ? c0 : c1;
            if (h_near) stack[sp++] = swap ? c1 : c0;
            // every slot at BIG: taken only when best_t is above BIG, as
            // leaf 0's slot 0 (the reference's rule)
            if (BIG < best_t) {
                const Hit h = slot_test(tri_p0, tri_e1, tri_e2, tri_id, 0, r);
                best_tri = __ldg(tri_id);
                bu = h.u;
                bv = h.v;
                best_t = BIG;
            }
        } else {
            ++leaves;
            const int base = (-c0 - 1) * leaf_size;
            Hit best = slot_test(tri_p0, tri_e1, tri_e2, tri_id, base, r);
            int k = 0;
            for (int s = 1; s < leaf_size; ++s) {
                const Hit h = slot_test(tri_p0, tri_e1, tri_e2, tri_id,
                                        base + s, r);
                if (h.t < best.t) {
                    best = h;
                    k = s;
                }
            }
            if (best.t < best_t) {
                best_tri = __ldg(tri_id + base + k);
                bu = best.u;
                bv = best.v;
                best_t = best.t;
            }
        }
    }
    if (ANY) {
        hit_out[ray] = best_tri >= 0;
    } else {
        t_out[ray] = best_tri >= 0 ? best_t : CUDART_INF_F;
        tri_out[ray] = best_tri;
        u_out[ray] = bu;
        v_out[ray] = bv;
    }
    if (counts) {
        counts[2 * ray] = inner;
        counts[2 * ray + 1] = leaves;
    }
}

}  // namespace

extern "C" int bvh_traverse_launch(
    const float* node_lo, const float* node_hi, const int* child0,
    const int* child1, const float* tri_p0, const float* tri_e1,
    const float* tri_e2, const int* tri_id, const float* orig,
    const float* dirs, const float* t_min, const float* t_max, float* t_out,
    int* tri_out, float* u_out, float* v_out, bool* hit_out, int* counts,
    int* error, int n_rays, int leaf_size, int max_stack, int any_hit,
    cudaStream_t stream)
{
    if (max_stack > STACK_CAP || leaf_size < 1) return cudaErrorInvalidValue;
    const dim3 grid((n_rays + THREADS - 1) / THREADS);
    if (any_hit) {
        bvh_traverse_kernel<true><<<grid, THREADS, 0, stream>>>(
            node_lo, node_hi, child0, child1, tri_p0, tri_e1, tri_e2, tri_id,
            orig, dirs, t_min, t_max, t_out, tri_out, u_out, v_out, hit_out,
            counts, error, n_rays, leaf_size, max_stack);
    } else {
        bvh_traverse_kernel<false><<<grid, THREADS, 0, stream>>>(
            node_lo, node_hi, child0, child1, tri_p0, tri_e1, tri_e2, tri_id,
            orig, dirs, t_min, t_max, t_out, tri_out, u_out, v_out, hit_out,
            counts, error, n_rays, leaf_size, max_stack);
    }
    return cudaGetLastError();
}
