"""Kernel W: the tile tree walk of tree culling, on Hopper.

The JAX package walks the cluster tree (or the two-level unit tree) per
128-ray tile in `lumenrenderer_tpu/accel/tiled.py:113` `_tile_tree_visits`:
one `lax.while_loop` per tile under `vmap`, which XLA compiles into one
device loop. It has no Pallas kernel. Run eagerly in PyTorch, the same walk
needs one host-driven step (dozens of launches) per node popped by the
longest walk, so the port writes the walk as a kernel of its own,
`csrc/tree_walk.cu`.

Contract. Tile t is the interval ray of its live rays: origins within
[olo[t], ohi[t]], directions within [dlo[t], dhi[t]] (T,3), the largest
t_max `t_cap[t]`, and `any_alive[t]` false when no ray of the tile is live.
The tree is `tree_lo`/`tree_hi` (Nn,3) node boxes (node 0 the root),
`child0`/`child1` (Nn,) int32 (child0 < 0: leaf -(i + 1)) and
`leaf_cluster` (Nl,) int32. A box possibly hits the tile when, with the
candidates (blo, bhi) - (ohi, olo) times the reciprocals of dlo and dhi
(each guarded as 1 / where(|x| > 1e-20, x, 1e-20)), entry tn = max over the
axes of the candidates' min and exit tf = min of their max (an axis whose
direction interval holds 0 gives -inf and +inf): tn <= tf, tf >= 0 and
tn <= t_cap; its entry t is max(tn, 0). From the root (if it possibly hits
and the tile is alive) the walk pops a node: a leaf appends its cluster and
entry t at slot `count` while count < mv, and counts; an internal node
pushes each child that possibly hits, the far one first (near: strictly
smaller entry t of the second child swaps them). The walk stops once it has
counted mv + 1 leaves. Returns (visits (T,mv) int32, 0 past the count, vtn
(T,mv) float32 entry t, inf past the count, count (T,) int32 = min(leaves
reached, mv + 1)), in pop order: the caller sorts. JAX's walk does not stop,
so its count may be larger, but its lists, its valid mask (slot < count)
and its overflow (count > mv) are the same. Entry t is +0.0, never -0.0, so
the lists are equal bit for bit wherever they are computed.

The kernel (csrc/tree_walk.cu has the design): a warp per tile walks up to
32 nodes a step from a shared stack kept in the order of the leaves'
near/far paths, reading each node's two child boxes and ids as one 64-byte
record (`node_records`: the sets carry them as `tree_nodes`, made at build,
refit and conversion, passed as `nodes=`). An optional int32 (T,) counter
receives the nodes each tile handled: for the twin the nodes its walk
popped, for the kernel its expanded nodes and the leaves it listed.

On a CPU tensor the wrapper runs `tile_tree_visits_ref`, the plain PyTorch
twin (one vectorised step per pop over the tiles still walking, as many
steps as the longest stopped walk has pops); on a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

SHARED_BYTES = 227 * 1024    # a block's most shared memory (H100)
BOX_TEST_OPS = 90            # operations of one box test, for the bound
COMPACT_EVERY = 16           # twin steps between narrowing its tiles
WARP = 32                    # the kernel's nodes a step (csrc)
# launches of the CUDA kernel (the CPU twin does not count)
LAUNCHES = {"walk": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _reciprocals(dlo, dhi):
    """(inv_a, inv_b, zero_in_d) (T,3) of the tiles' direction intervals."""
    eps = 1e-20
    inv_a = 1.0 / torch.where(dlo.abs() > eps, dlo, eps)
    inv_b = 1.0 / torch.where(dhi.abs() > eps, dhi, eps)
    return inv_a, inv_b, (dlo <= 0.0) & (dhi >= 0.0)


def box_test(blo, bhi, olo, ohi, inv_a, inv_b, zero, cap):
    """The walk's conservative interval-ray slab test of boxes (N,3) against
    tiles (N,3) each: (possible hit (N,) bool, entry t (N,) float32, +0.0
    for every zero)."""
    n1, n2 = blo - ohi, blo - olo
    n3, n4 = bhi - ohi, bhi - olo
    cands = torch.stack([n1 * inv_a, n1 * inv_b, n2 * inv_a, n2 * inv_b,
                         n3 * inv_a, n3 * inv_b, n4 * inv_a, n4 * inv_b])
    tn = torch.where(zero, -torch.inf, cands.amin(0)).amax(-1)
    tf = torch.where(zero, torch.inf, cands.amax(0)).amin(-1)
    hit = (tn <= tf) & (tf >= 0.0) & (tn <= cap)
    return hit, tn.clamp_min(0.0) + 0.0


def node_records(tree_lo, tree_hi, child0, child1, leaf_cluster):
    """(Nn,16) float32, one 64-byte record per node for the kernel: child
    0's box lo and hi, child 1's, then two int32 bit-cast into the floats,
    each child's id (>= 0: an internal node, else -(cluster + 1) for a
    leaf), and two zeros. A leaf's row holds node 0's children and is never
    read. The boxes are the tree's own floats."""
    c0 = child0.long().clamp_min(0)
    c1 = child1.long().clamp_min(0)

    def ref(c):
        kid = child0[c].long()
        leaf = -leaf_cluster[(-kid - 1).clamp_min(0)].long() - 1
        return torch.where(kid >= 0, c, leaf).to(torch.int32)

    ids = torch.stack([ref(c0), ref(c1), torch.zeros_like(child0),
                       torch.zeros_like(child0)], 1).view(torch.float32)
    return torch.cat([tree_lo[c0], tree_hi[c0], tree_lo[c1], tree_hi[c1],
                      ids], 1).contiguous()


def stack_entries(tree_depth: int) -> int:
    """Entries of the kernel's shared stack that no walk of a tree with
    `tree_depth` levels can exceed (csrc/tree_walk.cu gives the bound):
    64 per level for pending nodes, 65 per level for leaves held back, and
    one step's growth; 8 bytes each. At 40 levels that is 4,998 entries,
    39 KiB."""
    return (2 * WARP * max(tree_depth - 1, 0)
            + (2 * WARP + 1) * max(tree_depth - 2, 0) + WARP)


def tile_tree_visits_ref(olo, ohi, dlo, dhi, t_cap, any_alive, tree_lo,
                         tree_hi, child0, child1, leaf_cluster, *,
                         tree_depth: int, mv: int, pops=None, nodes=None):
    """Plain PyTorch twin of the kernel (same contract; `nodes` is not
    read, the twin walks the tree's own arrays): each step pops one
    node of every tile still walking, with masked writes; a tile stops at
    mv + 1 leaves. The set of tiles still walking is narrowed, a host sync
    on a CUDA device, every COMPACT_EVERY steps there and every step on the
    CPU. `pops`, an int32 (T,) tensor, receives the nodes each tile
    popped."""
    tiles = olo.shape[0]
    dev = olo.device
    inv_a, inv_b, zero = _reciprocals(dlo, dhi)
    stack = torch.zeros((tiles, tree_depth + 2), dtype=torch.long, device=dev)
    tstack = torch.zeros((tiles, tree_depth + 2), dtype=torch.float32,
                         device=dev)
    root_hit, tstack[:, 0] = box_test(
        tree_lo[:1], tree_hi[:1], olo, ohi, inv_a, inv_b, zero, t_cap)
    sp = (root_hit & any_alive).long()
    visits = torch.zeros((tiles, mv), dtype=torch.int32, device=dev)
    vtn = torch.full((tiles, mv), torch.inf, dtype=torch.float32, device=dev)
    count = torch.zeros(tiles, dtype=torch.long, device=dev)
    popped = torch.zeros(tiles, dtype=torch.long, device=dev)
    a = sp.nonzero()[:, 0]
    step = 0
    compact = 1 if dev.type == "cpu" else COMPACT_EVERY
    while a.numel():
        sp_a = sp[a]
        act = sp_a > 0
        top = (sp_a - 1).clamp_min(0)
        node, node_tn = stack[a, top], tstack[a, top]
        popped[a] += act
        c0 = child0[node].long()
        leaf = act & (c0 < 0)
        cnt = count[a]
        take = leaf & (cnt < mv)
        slot = cnt.clamp_max(mv - 1)
        visits[a, slot] = torch.where(
            take, leaf_cluster[(-c0 - 1).clamp_min(0)], visits[a, slot])
        vtn[a, slot] = torch.where(take, node_tn, vtn[a, slot])
        count[a] = cnt + leaf
        inner = act & ~leaf
        c0, c1 = c0.clamp_min(0), child1[node].long()
        tile = (olo[a], ohi[a], inv_a[a], inv_b[a], zero[a], t_cap[a])
        h0, t0 = box_test(tree_lo[c0], tree_hi[c0], *tile)
        h1, t1 = box_test(tree_lo[c1], tree_hi[c1], *tile)
        swap = t1 < t0
        top = torch.where(act, top, sp_a)
        for child, t_child, hit in (
                (torch.where(swap, c0, c1), torch.where(swap, t0, t1),
                 torch.where(swap, h0, h1) & inner),         # far first
                (torch.where(swap, c1, c0), torch.where(swap, t1, t0),
                 torch.where(swap, h1, h0) & inner)):
            stack[a, top] = torch.where(hit, child, stack[a, top])
            tstack[a, top] = torch.where(hit, t_child, tstack[a, top])
            top = top + hit
        sp[a] = torch.where(cnt + leaf > mv, 0, top)         # mv + 1: stop
        step += 1
        if step % compact == 0:
            a = a[sp[a] > 0]
    if pops is not None:
        pops.copy_(popped)
    return visits, vtn, count.to(torch.int32)


def tile_tree_visits(olo, ohi, dlo, dhi, t_cap, any_alive, tree_lo, tree_hi,
                     child0, child1, leaf_cluster, *, tree_depth: int,
                     mv: int, nodes, pops=None):
    """Walk the tree for every tile (contract in the module docstring):
    (visits (T,mv) int32, vtn (T,mv) float32, count (T,) int32) in pop
    order. `nodes` is the tree's `node_records` (the sets' `tree_nodes`).
    `pops`, an int32 (T,) tensor, receives the nodes each tile handled (on
    the CPU, from the twin). Raises where the kernel's stack would not fit
    a block's shared memory, and where a walk outgrew the stack that
    `stack_entries` allots (a host sync)."""
    tiles = olo.shape[0]
    nn = tree_lo.shape[0]
    f32 = torch.float32
    expect = {
        "olo": (olo, f32, (tiles, 3)), "ohi": (ohi, f32, (tiles, 3)),
        "dlo": (dlo, f32, (tiles, 3)), "dhi": (dhi, f32, (tiles, 3)),
        "t_cap": (t_cap, f32, (tiles,)),
        "any_alive": (any_alive, torch.bool, (tiles,)),
        "tree_lo": (tree_lo, f32, (nn, 3)), "tree_hi": (tree_hi, f32, (nn, 3)),
        "child0": (child0, torch.int32, (nn,)),
        "child1": (child1, torch.int32, (nn,)),
        "leaf_cluster": (leaf_cluster, torch.int32, (leaf_cluster.shape[0],)),
        "nodes": (nodes, f32, (nn, 16)),
    }
    if pops is not None:
        expect["pops"] = (pops, torch.int32, (tiles,))
    build.check_tensors(olo.device, expect)
    if mv < 1 or nn < 1:
        raise ValueError(f"mv={mv} and the tree's {nn} nodes must be >= 1")
    args = (olo, ohi, dlo, dhi, t_cap, any_alive, tree_lo, tree_hi, child0,
            child1, leaf_cluster)
    if olo.device.type == "cpu":
        return tile_tree_visits_ref(*args, tree_depth=tree_depth, mv=mv,
                                    pops=pops)
    if olo.device.type != "cuda":
        raise ValueError(f"tile_tree_visits runs on cpu or cuda, not "
                         f"{olo.device}")
    entries = stack_entries(tree_depth)
    if 8 * entries > SHARED_BYTES:
        raise ValueError(f"a tree of depth {tree_depth} needs a stack of "
                         f"{8 * entries} bytes; a block holds {SHARED_BYTES}")
    fn = build.load_function("tree_walk", "tree_walk_launch",
                             [ctypes.c_void_p] * 17 + [ctypes.c_int] * 3
                             + [ctypes.c_void_p])
    dev = olo.device
    visits = torch.empty((tiles, mv), dtype=torch.int32, device=dev)
    vtn = torch.empty((tiles, mv), dtype=f32, device=dev)
    count = torch.empty((tiles,), dtype=torch.int32, device=dev)
    error = torch.zeros((1,), dtype=torch.int32, device=dev)
    build.launch(fn, dev, *(x.data_ptr() for x in args), nodes.data_ptr(),
                 visits.data_ptr(), vtn.data_ptr(), count.data_ptr(),
                 None if pops is None else pops.data_ptr(), error.data_ptr(),
                 tiles, mv, entries)
    LAUNCHES["walk"] += 1
    if int(error):
        raise RuntimeError(f"a walk of the depth-{tree_depth} tree outgrew "
                           f"its stack of {entries} entries")
    return visits, vtn, count
