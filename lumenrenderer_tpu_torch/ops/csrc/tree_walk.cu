// Kernel W, the tile tree walk of tree culling: for each 128-ray tile, a
// depth-first, near-first walk of the cluster (or unit) tree by the tile's
// interval ray, listing the first mv leaves it reaches and counting up to
// mv + 1. The JAX package runs this walk as an XLA while_loop under vmap
// (lumenrenderer_tpu/accel/tiled.py:113 `_tile_tree_visits`), with no Pallas
// kernel; ops/tree_walk.py holds the contract and the plain PyTorch twin.
//
// What bounds it on an H100: the longest tile's chain of dependent loads.
// Each node handled loads its two child boxes (the tree, 1.5 MB of records
// at the mega scene, stays in L2) and tests them; the bytes (each tile's
// bounds in, its lists out) and the operations (about 90 per box test) are
// small beside that latency. Two things shorten the chain: the walk stops
// at mv + 1 leaves, which is all the caller reads (a tile whose interval ray
// admits every cluster used to walk the whole tree), and a warp walks a
// tile's nodes 32 at a time.
//
// The design: one warp per tile. The leaves must come out in the order of the
// contract's one-node-a-step walk (the twin's), the lexicographic order of
// their paths from the root
// (near = 0, far = 1; near is the child with the strictly smaller entry t,
// child 0 on a tie). The tile's pending entries (nodes, and leaves not yet
// listed) sit in shared memory in that order, the first on top. Each step
// lists the leaves on top (nothing can precede them), then takes the top
// min(32, sp) entries, one a lane: a node's lane loads the node's 64-byte
// record (both child boxes and ids, four 16-byte loads) and tests both
// children; a leaf's lane keeps it. The lanes write back, in lane order, near
// child before far, so the stack stays in path order with no key stored:
// every entry's subtree precedes the entries below it. Lane offsets come from
// __ballot_sync / __popc.
// The stack's bound, from the tree's levels D: call a node open when a child
// of it is pending. Two open nodes p < q (in path order) not on one path were
// taken in that order of steps, q no later than p (else p's pending child,
// which precedes q, would have been among the 32 smallest when q was taken).
// So every step that took an open node before the last such step also took
// an ancestor of the last one: at most D - 1 steps hold open nodes, 32 nodes
// each, 64 pending children. A leaf held back has a pending node before it,
// and the step that made it took an ancestor of that node: at most D - 2
// such steps, 64 leaves each, plus one per ancestor. With one step's growth
// (32) that is `stack_entries` (ops/tree_walk.py), 8 bytes each: the wrapper
// sizes the shared stack so. Each step checks its new size against it before
// writing; past it the tile stops and sets the error word, and the wrapper
// raises, so the kernel never clips.
//
// The tile's reciprocals are formed once, by IEEE division (no fast-math in
// the build); each box test is in the twin's order of operations, with no
// multiply-add to contract, so the lists equal the twin's bit for bit. Entry
// t is max(tn, 0) + 0 so that a zero is +0.0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtree_walk.so tree_walk.cu
// Entry: tree_walk_launch(), plain C, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARP = 32;        // one warp (a block) per tile
constexpr unsigned FULL = 0xffffffffu;

struct Tile {
    float olo[3], ohi[3], inv_a[3], inv_b[3], cap;
    bool zero[3];
};

__device__ __forceinline__ Tile load_tile(const float* __restrict__ olo,
                                          const float* __restrict__ ohi,
                                          const float* __restrict__ dlo,
                                          const float* __restrict__ dhi,
                                          const float* __restrict__ t_cap,
                                          int tile)
{
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
    return t;
}

// The conservative interval-ray slab test of box [lo, hi]: true when a ray
// of the tile may enter it; tn gets its entry t, max(tn_lb, 0) + 0.
__device__ __forceinline__ bool box_test(const float lo[3], const float hi[3],
                                         const Tile& t, float& tn)
{
    float tn_lb = -CUDART_INF_F;
    float tf_ub = CUDART_INF_F;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float n1 = lo[a] - t.ohi[a], n2 = lo[a] - t.olo[a];
        const float n3 = hi[a] - t.ohi[a], n4 = hi[a] - t.olo[a];
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

__device__ __forceinline__ bool node_test(const float* __restrict__ tree_lo,
                                          const float* __restrict__ tree_hi,
                                          int n, const Tile& t, float& tn)
{
    const float lo[3] = {tree_lo[3 * n], tree_lo[3 * n + 1],
                         tree_lo[3 * n + 2]};
    const float hi[3] = {tree_hi[3 * n], tree_hi[3 * n + 1],
                         tree_hi[3 * n + 2]};
    return box_test(lo, hi, t, tn);
}

struct Args {
    const float *olo, *ohi, *dlo, *dhi, *t_cap;     // (T, 3), t_cap (T,)
    const bool* alive;                              // (T,)
    const float *tree_lo, *tree_hi;                 // (Nn, 3)
    const int *child0, *child1, *leaf_cluster;      // (Nn,), (Nl,)
    const float4* nodes;                            // (Nn, 4): records
    int* visits;                                    // (T, mv)
    float* vtn;                                     // (T, mv)
    int *count, *pops;                              // (T,); pops may be null
    int* error;                                     // (1,): 1 past the stack
    int tiles, mv, entries;                         // entries: stack size
};

// A stack entry: x >= 0 an internal node's id, x < 0 the leaf of cluster
// -x - 1 with y its entry t's bits (a node's y is not read).
__global__ void __launch_bounds__(WARP) tree_walk_warp(Args g)
{
    extern __shared__ int2 stack[];
    const int tile = blockIdx.x;
    const int lane = threadIdx.x;
    const Tile t = load_tile(g.olo, g.ohi, g.dlo, g.dhi, g.t_cap, tile);
    const int mv = g.mv, limit = mv + 1;
    int* tv = g.visits + (size_t)tile * mv;
    float* tt = g.vtn + (size_t)tile * mv;

    int sp = 0;
    float root_tn;
    if (node_test(g.tree_lo, g.tree_hi, 0, t, root_tn) && g.alive[tile]) {
        const int c0 = g.child0[0];
        if (lane == 0)
            stack[0] = make_int2(c0 < 0 ? -g.leaf_cluster[-c0 - 1] - 1 : 0,
                                 __float_as_int(root_tn));
        sp = 1;
    }
    __syncwarp();
    int count = 0, pops = 0;
    while (sp > 0 && count < limit) {
        const int n = min(WARP, sp);
        const int2 e = lane < n ? stack[sp - 1 - lane] : make_int2(0, 0);
        const unsigned leaves = __ballot_sync(FULL, lane < n && e.x < 0);
        const int lead = leaves == FULL ? WARP : __ffs(~leaves) - 1;
        if (lead > 0) {                   // leaves on top: list them
            const int take = min(lead, limit - count);
            if (lane < take && count + lane < mv) {
                tv[count + lane] = -e.x - 1;
                tt[count + lane] = __int_as_float(e.y);
            }
            count += take;
            pops += take;
            sp -= lead;
            continue;
        }
        // a node on top: expand the window of the n first entries
        int out = 0;
        int2 o0 = make_int2(0, 0), o1 = make_int2(0, 0);
        if (lane < n && e.x < 0) {
            o0 = e;
            out = 1;
        } else if (lane < n) {
            const float4* r = g.nodes + 4 * (size_t)e.x;
            const float4 a = __ldg(r), b = __ldg(r + 1);
            const float4 c = __ldg(r + 2), d = __ldg(r + 3);
            const float lo0[3] = {a.x, a.y, a.z}, hi0[3] = {a.w, b.x, b.y};
            const float lo1[3] = {b.z, b.w, c.x}, hi1[3] = {c.y, c.z, c.w};
            float tn0, tn1;
            const bool h0 = box_test(lo0, hi0, t, tn0);
            const bool h1 = box_test(lo1, hi1, t, tn1);
            const int r0 = __float_as_int(d.x), r1 = __float_as_int(d.y);
            const bool swap = tn1 < tn0;
            const int2 near_e = swap ? make_int2(r1, __float_as_int(tn1))
                                   : make_int2(r0, __float_as_int(tn0));
            const int2 far_e = swap ? make_int2(r0, __float_as_int(tn0))
                                  : make_int2(r1, __float_as_int(tn1));
            const bool hn = swap ? h1 : h0, hf = swap ? h0 : h1;
            if (hn) {
                o0 = near_e;
                o1 = far_e;
                out = hf ? 2 : 1;
            } else if (hf) {
                o0 = far_e;
                out = 1;
            }
        }
        pops += __popc(__ballot_sync(FULL, lane < n && e.x >= 0));
        const unsigned one = __ballot_sync(FULL, out >= 1);
        const unsigned two = __ballot_sync(FULL, out == 2);
        const unsigned before = (1u << lane) - 1u;
        const int pre = __popc(one & before) + __popc(two & before);
        const int base = sp - n;
        const int top = base + __popc(one) + __popc(two);   // new sp
        if (top > g.entries) {            // the bound above is wrong: stop
            if (lane == 0) *g.error = 1;
            break;
        }
        __syncwarp();                     // every lane has read its entry
        if (out >= 1) stack[top - 1 - pre] = o0;
        if (out == 2) stack[top - 2 - pre] = o1;
        sp = top;
        __syncwarp();
    }
    for (int i = count + lane; i < mv; i += WARP) {
        tv[i] = 0;
        tt[i] = CUDART_INF_F;
    }
    if (lane == 0) {
        g.count[tile] = count;
        if (g.pops != nullptr) g.pops[tile] = pops;
    }
}

}  // namespace

extern "C" int tree_walk_launch(const void* olo, const void* ohi,
                                const void* dlo, const void* dhi,
                                const void* t_cap, const void* alive,
                                const void* tree_lo, const void* tree_hi,
                                const void* child0, const void* child1,
                                const void* leaf_cluster, const void* nodes,
                                void* visits, void* vtn, void* count,
                                void* pops, void* error, int tiles, int mv,
                                int entries, void* stream)
{
    if (tiles == 0) return 0;
    const Args g{static_cast<const float*>(olo),
                 static_cast<const float*>(ohi),
                 static_cast<const float*>(dlo),
                 static_cast<const float*>(dhi),
                 static_cast<const float*>(t_cap),
                 static_cast<const bool*>(alive),
                 static_cast<const float*>(tree_lo),
                 static_cast<const float*>(tree_hi),
                 static_cast<const int*>(child0),
                 static_cast<const int*>(child1),
                 static_cast<const int*>(leaf_cluster),
                 static_cast<const float4*>(nodes),
                 static_cast<int*>(visits), static_cast<float*>(vtn),
                 static_cast<int*>(count), static_cast<int*>(pops),
                 static_cast<int*>(error), tiles, mv, entries};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t smem = (size_t)entries * sizeof(int2);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            tree_walk_warp, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    tree_walk_warp<<<tiles, WARP, smem, s>>>(g);
    return static_cast<int>(cudaGetLastError());
}
