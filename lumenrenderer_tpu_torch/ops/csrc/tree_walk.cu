// Kernel W, the tile tree walk of tree culling: for each 128-ray tile, a
// depth-first, near-first walk of the cluster (or unit) tree by the tile's
// interval ray, appending the leaves it reaches. The JAX package runs this
// walk as an XLA while_loop under vmap (lumenrenderer_tpu/accel/tiled.py:113
// `_tile_tree_visits`), with no Pallas kernel; ops/tree_walk.py holds the
// contract and the plain PyTorch twin.
//
// What bounds it on an H100: the longest tile's walk. Each pop loads two
// child boxes (the tree, 0.75 MB at the mega scene, stays in L2) and tests
// them, a chain of dependent loads, one pop after another per tile; the
// bytes (each tile's bounds in, its lists out) and the operations (about 90
// per box test) are small beside that latency.
//
// The design, a simple one: one thread per tile, its stack (node id and
// entry t) in local memory, MAX_STACK entries (the wrapper raises for a tree
// deeper than MAX_STACK - 2); the tile's reciprocals formed once, by IEEE
// division (no fast-math in the build); each box test in the twin's order of
// operations, with no multiply-add to contract, so the lists equal the
// twin's bit for bit. Entry t is max(tn, 0) + 0 so that a zero is +0.0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtree_walk.so tree_walk.cu
// Entry: tree_walk_launch(), plain C, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int MAX_STACK = 64;   // ops/tree_walk.py MAX_STACK
constexpr int THREADS = 128;

struct Tile {
    float olo[3], ohi[3], inv_a[3], inv_b[3], cap;
    bool zero[3];
};

// The conservative interval-ray slab test of node `n`: true when a ray of
// the tile may enter the box; tn gets its entry t, max(tn_lb, 0) + 0.
__device__ __forceinline__ bool box_test(const float* __restrict__ lo,
                                         const float* __restrict__ hi,
                                         int n, const Tile& t, float& tn)
{
    float tn_lb = -CUDART_INF_F;
    float tf_ub = CUDART_INF_F;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float blo = lo[3 * n + a];
        const float bhi = hi[3 * n + a];
        const float n1 = blo - t.ohi[a], n2 = blo - t.olo[a];
        const float n3 = bhi - t.ohi[a], n4 = bhi - t.olo[a];
        const float c[8] = {n1 * t.inv_a[a], n1 * t.inv_b[a],
                            n2 * t.inv_a[a], n2 * t.inv_b[a],
                            n3 * t.inv_a[a], n3 * t.inv_b[a],
                            n4 * t.inv_a[a], n4 * t.inv_b[a]};
        float mn = c[0], mx = c[0];
#pragma unroll
        for (int i = 1; i < 8; ++i) {
            mn = fminf(mn, c[i]);
            mx = fmaxf(mx, c[i]);
        }
        tn_lb = fmaxf(tn_lb, t.zero[a] ? -CUDART_INF_F : mn);
        tf_ub = fminf(tf_ub, t.zero[a] ? CUDART_INF_F : mx);
    }
    tn = fmaxf(tn_lb, 0.f) + 0.f;
    return tn_lb <= tf_ub && tf_ub >= 0.f && tn_lb <= t.cap;
}

__global__ void __launch_bounds__(THREADS)
tree_walk_kernel(const float* __restrict__ olo,     // (T, 3)
                 const float* __restrict__ ohi,
                 const float* __restrict__ dlo,
                 const float* __restrict__ dhi,
                 const float* __restrict__ t_cap,   // (T,)
                 const bool* __restrict__ alive,    // (T,)
                 const float* __restrict__ tree_lo, // (Nn, 3)
                 const float* __restrict__ tree_hi,
                 const int* __restrict__ child0,    // (Nn,) < 0: leaf
                 const int* __restrict__ child1,
                 const int* __restrict__ leaf_cluster,  // (Nl,)
                 int* __restrict__ visits,          // (T, mv)
                 float* __restrict__ vtn,           // (T, mv)
                 int* __restrict__ count_out,       // (T,)
                 int* __restrict__ pops_out,        // (T,) or null
                 int tiles, int mv)
{
    const int tile = blockIdx.x * blockDim.x + threadIdx.x;
    if (tile >= tiles) return;
    Tile t;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float lo = dlo[3 * tile + a], hi = dhi[3 * tile + a];
        t.olo[a] = olo[3 * tile + a];
        t.ohi[a] = ohi[3 * tile + a];
        t.inv_a[a] = 1.0f / (fabsf(lo) > 1e-20f ? lo : 1e-20f);
        t.inv_b[a] = 1.0f / (fabsf(hi) > 1e-20f ? hi : 1e-20f);
        t.zero[a] = lo <= 0.f && hi >= 0.f;
    }
    t.cap = t_cap[tile];
    int* tv = visits + (size_t)tile * mv;
    float* tt = vtn + (size_t)tile * mv;
    for (int i = 0; i < mv; ++i) {
        tv[i] = 0;
        tt[i] = CUDART_INF_F;
    }

    int stack[MAX_STACK];
    float tstack[MAX_STACK];
    int sp = 0;
    float root_tn;
    if (box_test(tree_lo, tree_hi, 0, t, root_tn) && alive[tile]) {
        stack[0] = 0;
        tstack[0] = root_tn;
        sp = 1;
    }
    int count = 0, pops = 0;
    while (sp > 0) {
        --sp;
        const int node = stack[sp];
        const float node_tn = tstack[sp];
        ++pops;
        const int c0 = child0[node];
        if (c0 < 0) {                     // a leaf: append while there is room
            if (count < mv) {
                tv[count] = leaf_cluster[-c0 - 1];
                tt[count] = node_tn;
            }
            ++count;
            continue;
        }
        const int c1 = child1[node];
        float tn0, tn1;
        const bool h0 = box_test(tree_lo, tree_hi, c0, t, tn0);
        const bool h1 = box_test(tree_lo, tree_hi, c1, t, tn1);
        const bool swap = tn1 < tn0;
        if (swap ? h0 : h1) {             // the far child first
            stack[sp] = swap ? c0 : c1;
            tstack[sp] = swap ? tn0 : tn1;
            ++sp;
        }
        if (swap ? h1 : h0) {             // the near child pops next
            stack[sp] = swap ? c1 : c0;
            tstack[sp] = swap ? tn1 : tn0;
            ++sp;
        }
    }
    count_out[tile] = count;
    if (pops_out != nullptr) pops_out[tile] = pops;
}

}  // namespace

extern "C" int tree_walk_launch(const void* olo, const void* ohi,
                                const void* dlo, const void* dhi,
                                const void* t_cap, const void* alive,
                                const void* tree_lo, const void* tree_hi,
                                const void* child0, const void* child1,
                                const void* leaf_cluster, void* visits,
                                void* vtn, void* count, void* pops, int tiles,
                                int mv, void* stream)
{
    if (tiles == 0) return 0;
    tree_walk_kernel<<<(tiles + THREADS - 1) / THREADS, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(olo), static_cast<const float*>(ohi),
        static_cast<const float*>(dlo), static_cast<const float*>(dhi),
        static_cast<const float*>(t_cap), static_cast<const bool*>(alive),
        static_cast<const float*>(tree_lo), static_cast<const float*>(tree_hi),
        static_cast<const int*>(child0), static_cast<const int*>(child1),
        static_cast<const int*>(leaf_cluster), static_cast<int*>(visits),
        static_cast<float*>(vtn), static_cast<int*>(count),
        static_cast<int*>(pops), tiles, mv);
    return static_cast<int>(cudaGetLastError());
}
