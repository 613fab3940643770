"""Kernel T: the per-ray BVH walk of the "sah", "bvh" and "lbvh" accels, on
Hopper.

The JAX package walks the BVH per ray in
`lumenrenderer_tpu/accel/traverse.py:60` `_traverse_scalar`: one
`lax.while_loop` under `vmap`, which XLA compiles into one device loop. It
has no Pallas kernel. Run eagerly in PyTorch, the same lockstep walk needs
one host-driven step (about 80 launches on 3.7M rays) per node popped by
the longest ray, so the port writes the walk as a kernel of its own,
`csrc/bvh_traverse.cu`, as it did for kernel W.

Contract (JAX's, exactly). A ray has origin o, direction d (R,3), t_min and
t_max (R,); inv_d = safe_rcp(d). A box test of (lo, hi) with cap c gives
t0 = (lo - o) * inv_d, t1 = (hi - o) * inv_d, tn = max over the axes of
min(t0, t1), tf = min of max(t0, t1) (NaN propagates, as in JAX), hit =
tn <= tf and tf >= t_min and tn <= c, and entry t max(tn, t_min). The walk
tests the root with cap t_max and pushes it on a hit; best_t starts at
t_max, best_tri at -1, u = v = 0. While the stack is not empty (and, in
any mode, no triangle was taken), it pops a node. An internal node tests
both children with cap best_t and pushes each that hits, the far child
first (the second child is near only when its entry t is strictly
smaller). A leaf runs Möller–Trumbore over its `leaf_size` slots (det =
e1 . (d x e2), |det| > 1e-9; u, v, t from 1/det; a slot hits when u >= 0,
v >= 0, u + v <= 1, t > t_min and tri_id >= 0), t = 3.4e38 (BIG) where a
slot misses; its least t, the first slot among equals, replaces the best
when strictly below best_t. An internal node offers the same replacement
with every slot at BIG, so with t_max above BIG the walk takes leaf 0's
slot 0 (ROADMAP C-22: the reference's, kept). Closest mode returns (t, tri,
u, v): t = inf and tri = -1 where no triangle was taken; any mode returns
(R,) bool.

Rounding. XLA's CPU build of the reference contracts Möller–Trumbore's
products into fused multiply-adds: a cross product component is
fma(a1, b2, -(a2 b1)) and a dot product fma(x2, y2, fma(x1, y1, x0 y0)).
Near a grazing triangle the cancellation makes that visible (u off by
2.7e-6 on tests/test_bvh.py's rays without it). The kernel writes each as
the float32 fused multiply-add (`__fmaf_rn`) and the twin's `_fma` forms
the same correctly rounded a b + c from float64 (exact product, TwoSum,
round to odd, then to float32); every other operation is rounded on its
own, in the same order in the twin and the kernel, so the two agree bit
for bit, and the twin equals the reference bit for bit on the hits of the
CPU tests.

The kernel reads the BVH as the records its builds make (`format.BVH`'s
`nodes`, a 64-byte child-pair record per node, and `slots`, a 48-byte
record per leaf slot) and takes the root's box from `node_lo[0]` and
`node_hi[0]`; the twin walks the BVH's own arrays.

An optional int32 (R,2) `counts` receives, per ray, the internal nodes and
the leaves it popped: the walk's box tests are 1 + 2 * internal, its
ray-triangle tests leaf_size * leaves (the bound's operations).

On a CPU tensor the wrapper runs `bvh_traverse_ref`, the plain PyTorch twin
(one vectorised pop a step over the rays still walking, as many steps as
the longest walk pops); on a CUDA tensor it launches the kernel or raises.
The kernel's stack holds at most STACK_CAP entries: a BVH whose max_depth +
2 exceeds it is refused before launch; a walk that outgrows max_depth + 2
(a BVH whose max_depth is wrong) stops and sets the device's error word,
which `raise_on_error` reads at the caller's own synchronisation, so a
call adds no host sync.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..core.vecmath import fma as _fma
from ..core.vecmath import safe_rcp
from . import build

BIG = 3.4e38                 # a missing slot's t (JAX's BIG)
DET_EPS = 1e-9
STACK_CAP = 64               # the kernel's stack entries (csrc)
COMPACT_EVERY = 16           # twin steps between narrowing its rays (CUDA)
# Operations the kernel does, for the bound (csrc `box` and `slot_test`,
# each fused product counted as a multiply and an add):
# a box test is 6 subtractions, 6 multiplies, 6 min/max of the slab pairs,
# 4 to reduce them, 1 for the entry t and 3 compares;
BOX_TEST_OPS = 26
# a slot test is 2 cross products of 9 (a multiply and a fused product a
# component), 4 dot products of 5, 3 multiplies by 1/det, the 3
# subtractions of tvec, |det| > eps (2), the division, u + v, 5 compares
# and the select of t.
SLOT_TEST_OPS = 54
# launches of the CUDA kernel (the CPU twin does not count)
LAUNCHES = {"closest": 0, "any": 0}
_ERRORS: Dict[torch.device, torch.Tensor] = {}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _dot(a, b):
    return _fma(a[..., 2], b[..., 2],
                _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([_fma(a1, b2, -(a2 * b1)), _fma(a2, b0, -(a0 * b2)),
                        _fma(a0, b1, -(a1 * b0))], dim=-1)


def box_test(lo, hi, o, inv_d, t_min, cap):
    """Slab test of boxes (A,3) against rays (A,3): (hit (A,), entry t)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    hit = (tn <= tf) & (tf >= t_min) & (tn <= cap)
    return hit, torch.maximum(tn, t_min)


def leaf_test(bvh, leaf, o, d, t_min):
    """Möller–Trumbore of rays (A,) against their leaves' slots: (t (A,L)
    with BIG for a miss, u, v, tri_id)."""
    idx = leaf[:, None] * bvh.leaf_size + torch.arange(
        bvh.leaf_size, device=o.device)
    p0, e1, e2, tid = (bvh.tri_p0[idx], bvh.tri_e1[idx], bvh.tri_e2[idx],
                       bvh.tri_id[idx])
    dd = d[:, None, :].expand(p0.shape)
    pvec = _cross(dd, e2)
    det = _dot(e1, pvec)
    ok = det.abs() > DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvec = o[:, None, :] - p0
    u = _dot(tvec, pvec) * inv
    qvec = _cross(tvec, e1)
    v = _dot(dd, qvec) * inv
    t = _dot(e2, qvec) * inv
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min[:, None]) & (tid >= 0))
    return torch.where(hit, t, BIG), u, v, tid


def bvh_traverse_ref(bvh, o, d, t_min, t_max, *, any_hit: bool,
                     counts=None):
    """Plain PyTorch twin of the kernel (the contract above): each step
    pops one node of every ray still walking. The set of rays still
    walking is narrowed, a host sync on a CUDA device, every COMPACT_EVERY
    steps there and every step on the CPU."""
    r = o.shape[0]
    dev = o.device
    inv_d = safe_rcp(d)
    stack = torch.zeros((r, bvh.max_depth + 2), dtype=torch.long,
                        device=dev)
    root_hit, _ = box_test(bvh.node_lo[:1], bvh.node_hi[:1], o, inv_d,
                           t_min, t_max)
    sp = root_hit.long()
    best_t = t_max.clone()
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(r, dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)
    inner = torch.zeros(r, dtype=torch.int32, device=dev)
    leaves = torch.zeros_like(inner)
    a = sp.nonzero()[:, 0]
    step = 0
    compact = 1 if dev.type == "cpu" else COMPACT_EVERY
    while a.numel():
        act = sp[a] > 0
        if any_hit:
            act = act & (best_tri[a] < 0)
        sp_a = sp[a] - act.long()
        node = stack[a, sp_a.clamp_min(0)]
        c0 = bvh.child0[node].long()
        c1 = bvh.child1[node].long()
        is_leaf = c0 < 0
        o_a, d_a, inv_a, tn_a = o[a], d[a], inv_d[a], t_min[a]
        bt = best_t[a]
        inner[a] += (act & ~is_leaf).int()
        leaves[a] += (act & is_leaf).int()

        c0i = c0.clamp_min(0)
        h0, t0 = box_test(bvh.node_lo[c0i], bvh.node_hi[c0i], o_a, inv_a,
                          tn_a, bt)
        h1, t1 = box_test(bvh.node_lo[c1], bvh.node_hi[c1], o_a, inv_a,
                          tn_a, bt)
        inner_a = act & ~is_leaf
        swap = t1 < t0
        top = sp_a
        for child, hit in ((torch.where(swap, c0i, c1),
                            torch.where(swap, h0, h1) & inner_a),   # far
                           (torch.where(swap, c1, c0i),
                            torch.where(swap, h1, h0) & inner_a)):  # near
            at = top.clamp_max(stack.shape[1] - 1)
            stack[a, at] = torch.where(hit, child, stack[a, at])
            top = top + hit.long()

        t_l, u_l, v_l, id_l = leaf_test(bvh, (-c0 - 1).clamp_min(0), o_a,
                                        d_a, tn_a)
        t_l = torch.where(is_leaf[:, None], t_l, BIG)
        k = t_l.argmin(1, keepdim=True)
        t_k = t_l.gather(1, k)[:, 0]
        better = act & (t_k < bt)
        best_tri[a] = torch.where(better, id_l.gather(1, k)[:, 0],
                                  best_tri[a])
        bu[a] = torch.where(better, u_l.gather(1, k)[:, 0], bu[a])
        bv[a] = torch.where(better, v_l.gather(1, k)[:, 0], bv[a])
        best_t[a] = torch.where(better, t_k, bt)
        sp[a] = torch.where(act, top, 0)
        step += 1
        if step % compact == 0:
            keep = sp[a] > 0
            if any_hit:
                keep = keep & (best_tri[a] < 0)
            a = a[keep]
    if counts is not None:
        counts.copy_(torch.stack([inner, leaves], 1))
    if any_hit:
        return best_tri >= 0
    return (torch.where(best_tri >= 0, best_t, torch.inf), best_tri, bu, bv)


def _device_key(device) -> torch.device:
    """`device` with its CUDA index resolved ("cuda" is the current one)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _error_word(device) -> torch.Tensor:
    dev = _device_key(device)
    err = _ERRORS.get(dev)
    if err is None:
        err = _ERRORS[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return err


def raise_on_error(device) -> None:
    """Raise (and clear the word) if a launch on `device` since the last
    call had a walk outgrow its BVH's max_depth + 2; reads the device's
    error word, so call it where the caller synchronises anyway."""
    err = _ERRORS.get(_device_key(device))
    if err is not None and int(err):
        err.zero_()
        raise RuntimeError("a BVH walk outgrew the stack of its max_depth "
                           "+ 2 entries: the BVH's max_depth is wrong")


def bvh_traverse(bvh, o, d, t_min, t_max, *, any_hit: bool, counts=None):
    """Walk the BVH for every ray (contract in the module docstring).
    o, d (R,3) float32; t_min, t_max (R,) float32; all on the BVH's
    device. Returns (t, tri, u, v), or the hit bits in any mode."""
    r = o.shape[0]
    nn, s = bvh.node_lo.shape[0], bvh.tri_p0.shape[0]
    f32, i32 = torch.float32, torch.int32
    expect = {
        "o": (o, f32, (r, 3)), "d": (d, f32, (r, 3)),
        "t_min": (t_min, f32, (r,)), "t_max": (t_max, f32, (r,)),
        "node_lo": (bvh.node_lo, f32, (nn, 3)),
        "node_hi": (bvh.node_hi, f32, (nn, 3)),
        "child0": (bvh.child0, i32, (nn,)), "child1": (bvh.child1, i32, (nn,)),
        "tri_p0": (bvh.tri_p0, f32, (s, 3)), "tri_e1": (bvh.tri_e1, f32, (s, 3)),
        "tri_e2": (bvh.tri_e2, f32, (s, 3)), "tri_id": (bvh.tri_id, i32, (s,)),
        "nodes": (bvh.nodes, f32, (nn, 16)),
        "slots": (bvh.slots, f32, (s, 12)),
    }
    if counts is not None:
        expect["counts"] = (counts, i32, (r, 2))
    build.check_tensors(o.device, expect)
    if o.device.type == "cpu":
        return bvh_traverse_ref(bvh, o, d, t_min, t_max, any_hit=any_hit,
                                counts=counts)
    if o.device.type != "cuda":
        raise ValueError(f"bvh_traverse runs on cpu or cuda, not {o.device}")
    if bvh.max_depth + 2 > STACK_CAP:
        raise ValueError(f"a BVH of depth {bvh.max_depth} needs a stack of "
                         f"{bvh.max_depth + 2} entries; the kernel holds "
                         f"{STACK_CAP}")
    fn = build.load_function("bvh_traverse", "bvh_traverse_launch",
                             [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4
                             + [ctypes.c_void_p])
    dev = o.device
    t = torch.empty(r, dtype=f32, device=dev)
    tri = torch.empty(r, dtype=i32, device=dev)
    u = torch.empty(r, dtype=f32, device=dev)
    v = torch.empty(r, dtype=f32, device=dev)
    hit = torch.empty(r, dtype=torch.bool, device=dev)
    if r:
        ptrs = [x.data_ptr() for x in (
            bvh.nodes, bvh.slots, bvh.node_lo, bvh.node_hi, bvh.child0, o,
            d, t_min, t_max)]
        if any_hit:
            outs = [None, None, None, None, hit.data_ptr()]
        else:
            outs = [t.data_ptr(), tri.data_ptr(), u.data_ptr(),
                    v.data_ptr(), None]
        build.launch(fn, dev, *ptrs, *outs,
                     None if counts is None else counts.data_ptr(),
                     _error_word(dev).data_ptr(), r, bvh.leaf_size,
                     bvh.max_depth + 2, int(any_hit))
        LAUNCHES["any" if any_hit else "closest"] += 1
    return hit if any_hit else (t, tri, u, v)
