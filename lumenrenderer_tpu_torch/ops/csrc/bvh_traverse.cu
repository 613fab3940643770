// Kernel T, the per-ray BVH walk of the "sah", "bvh" and "lbvh" accels: for
// each ray, a near-first stack walk of the BVH with best-t culling and
// Möller–Trumbore over each leaf's slots, in closest or any mode. The JAX
// package runs this walk as an XLA while_loop under vmap
// (lumenrenderer_tpu/accel/traverse.py:60 `_traverse_scalar`), with no Pallas
// kernel; ops/bvh_traverse.py holds the contract and the plain PyTorch twin.
//
// What bounds it on an H100: the instructions its warps issue, not bytes or
// floating-point rate. The operations (26 per box test, 54 per ray-triangle
// test: ops/bvh_traverse.py BOX_TEST_OPS and SLOT_TEST_OPS) and the bytes
// (the rays in, the results out, the BVH once: 0.6 MB for the interior
// scene, which stays in L2) are far below it; every pop is a short chain of
// dependent loads (the stack, the node's record) and about a hundred
// instructions, and the rays of a warp walk paths of different lengths, so
// a warp issues its longest ray's pops with its lanes partly idle. The frame
// sorts its bounce rays by octant and Morton code and its shadow rays by
// capsule, so the lanes of a warp start near each other.
//
// The design cuts the instructions of a pop and of a leaf:
// - the BVH comes as records made at build (format.BVH `nodes` and
//   `slots`): an internal pop reads its node's 64-byte child-pair record
//   (both children's boxes and ids, a leaf's id -(leaf + 1)) as four float4
//   loads, a leaf slot is three float4s (p0 with tri_id bit-cast, e1, e2);
//   the stack holds those ids, so a pop knows a leaf without a load. The
//   root's own box comes from node_lo[0] and node_hi[0], and a root that is
//   a leaf is pushed as its leaf id;
// - the fused products are float32 fused multiply-adds (__fmaf_rn), which
//   the twin forms exactly (ops/bvh_traverse.py `_fma`): the float64 forms
//   they replace cost conversions at a sixteenth of the float32 rate;
// - the slab test's NaN-propagating min and max are one PTX min.NaN or
//   max.NaN each, not a compare and two selects;
// - the default leaf of 4 slots is unrolled, and a padding slot after a
//   leaf's first (tri_id -1: a miss at BIG, which cannot replace the first
//   slot, the least t being taken strictly) is skipped.
// One thread walks one ray, 128 to a block, its stack of max_depth + 2
// entries in local memory (cap 64, checked by the wrapper before launch; a
// walk that would outgrow max_depth + 2 stops and sets the error word
// instead of writing past it). A stack in shared memory, a while-while loop
// (descend to a leaf, then test it), persistent warps fetching rays from a
// counter, 64 or 256 threads a block and __launch_bounds__ for 10 blocks an
// SM were each measured slower on one BVH or mode at least (PERF.md), and
// are not used.
//
// Rounding follows the twin: every product and sum that is not a fused
// product is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn: nvcc
// contracts nothing), in the twin's order; divisions are IEEE (no fast-math
// in the build). So t, u and v equal the twin's bit for bit, and each ray
// pops the twin's nodes in the twin's order (its counters are equal too).
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

// min and max that propagate NaN, as torch.minimum and jnp.max do: one
// instruction each (sm_80+); a NaN's bits and a zero's sign reach no output
__device__ __forceinline__ float nmin(float a, float b)
{
    float m;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
    return m;
}

__device__ __forceinline__ float nmax(float a, float b)
{
    float m;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
    return m;
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

// the fused a b + c, rounded once (the twin's _fma)
__device__ __forceinline__ float fused(float a, float b, float c)
{
    return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ float dot(V3 a, V3 b)
{
    return fused(a.z, b.z, fused(a.y, b.y, mul(a.x, b.x)));
}

__device__ __forceinline__ V3 cross(V3 a, V3 b)
{
    return V3{fused(a.y, b.z, -mul(a.z, b.y)),
              fused(a.z, b.x, -mul(a.x, b.z)),
              fused(a.x, b.y, -mul(a.y, b.x))};
}

__device__ __forceinline__ float rcp(float x)
{
    return fabsf(x) > 1e-20f ? 1.0f / x : (x >= 0.f ? 1e20f : -1e20f);
}

struct Ray {
    V3 o, d, inv;
    float t_min;
};

// slab test of the box (l, h) with cap `cap`: hit, and entry t in `near`
__device__ __forceinline__ bool box(V3 l, V3 h, const Ray& r, float cap,
                                    float& near)
{
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
    int id;
};

// Möller–Trumbore of slot s, read as its three float4s: t (BIG on a miss),
// u, v and the slot's triangle id
__device__ __forceinline__ Hit slot_test(const float4* __restrict__ slots,
                                         int s, const Ray& r)
{
    const float4 q0 = __ldg(slots + 3 * s), q1 = __ldg(slots + 3 * s + 1),
                 q2 = __ldg(slots + 3 * s + 2);
    const V3 p{q0.x, q0.y, q0.z}, a{q1.x, q1.y, q1.z}, b{q2.x, q2.y, q2.z};
    const int id = __float_as_int(q0.w);
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
                     t > r.t_min && id >= 0;
    return Hit{hit ? t : BIG, u, v, id};
}

// a leaf's least t, the first slot among equals; L > 0 unrolls a leaf of
// L slots (the default 4), L = 0 takes `size`
template <int L>
__device__ __forceinline__ Hit leaf_test(const float4* __restrict__ slots,
                                         int leaf, int size, const Ray& r)
{
    const int n = L > 0 ? L : size;
    const int base = leaf * n;
    Hit best = slot_test(slots, base, r);
#pragma unroll
    for (int s = 1; s < n; ++s) {
        // a padding slot (tri_id -1) misses at BIG, so it cannot replace
        // the first slot: its arithmetic is skipped
        if (__float_as_int(__ldg(slots + 3 * (base + s)).w) < 0) continue;
        const Hit h = slot_test(slots, base + s, r);
        if (h.t < best.t) best = h;
    }
    return best;
}

template <bool ANY>
__global__ void __launch_bounds__(THREADS)
bvh_traverse_kernel(const float4* __restrict__ nodes,
                    const float4* __restrict__ slots,
                    const float* __restrict__ node_lo,
                    const float* __restrict__ node_hi,
                    const int* __restrict__ child0,
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
    int stack[STACK_CAP];   // child refs: >= 0 a node, -(leaf + 1) a leaf
    int sp = 0;
    float near;
    const int root = __ldg(child0);
    if (box(load3(node_lo, 0), load3(node_hi, 0), r, best_t, near))
        stack[sp++] = root >= 0 ? 0 : root;
    while (sp > 0 && !(ANY && best_tri >= 0)) {
        const int ref = stack[--sp];
        if (ref >= 0) {
            ++inner;
            const float4* rec = nodes + 4 * ref;
            const float4 q0 = __ldg(rec), q1 = __ldg(rec + 1),
                         q2 = __ldg(rec + 2), q3 = __ldg(rec + 3);
            const int c0 = __float_as_int(q3.x), c1 = __float_as_int(q3.y);
            float t0, t1;
            const bool h0 = box(V3{q0.x, q0.y, q0.z}, V3{q0.w, q1.x, q1.y},
                                r, best_t, t0);
            const bool h1 = box(V3{q1.z, q1.w, q2.x}, V3{q2.y, q2.z, q2.w},
                                r, best_t, t1);
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
                const Hit h = slot_test(slots, 0, r);
                best_tri = h.id;
                bu = h.u;
                bv = h.v;
                best_t = BIG;
            }
        } else {
            ++leaves;
            const Hit best = leaf_size == 4
                                 ? leaf_test<4>(slots, -ref - 1, 4, r)
                                 : leaf_test<0>(slots, -ref - 1, leaf_size, r);
            if (best.t < best_t) {
                best_tri = best.id;
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
    const void* nodes, const void* slots, const float* node_lo,
    const float* node_hi, const int* child0, const float* orig,
    const float* dirs, const float* t_min, const float* t_max, float* t_out,
    int* tri_out, float* u_out, float* v_out, bool* hit_out, int* counts,
    int* error, int n_rays, int leaf_size, int max_stack, int any_hit,
    cudaStream_t stream)
{
    if (max_stack > STACK_CAP || leaf_size < 1) return cudaErrorInvalidValue;
    const dim3 grid((n_rays + THREADS - 1) / THREADS);
    const float4* nd = static_cast<const float4*>(nodes);
    const float4* sl = static_cast<const float4*>(slots);
    if (any_hit) {
        bvh_traverse_kernel<true><<<grid, THREADS, 0, stream>>>(
            nd, sl, node_lo, node_hi, child0, orig, dirs, t_min, t_max,
            t_out, tri_out, u_out, v_out, hit_out, counts, error, n_rays,
            leaf_size, max_stack);
    } else {
        bvh_traverse_kernel<false><<<grid, THREADS, 0, stream>>>(
            nd, sl, node_lo, node_hi, child0, orig, dirs, t_min, t_max,
            t_out, tri_out, u_out, v_out, hit_out, counts, error, n_rays,
            leaf_size, max_stack);
    }
    return cudaGetLastError();
}
