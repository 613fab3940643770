"""Triangle clusters with precomputed Möller–Trumbore coefficients.

Port of `ClusterSet`, `build_clusters` and `ray_features` from
`lumenrenderer_tpu/accel/stream.py`. Möller–Trumbore is written as a bilinear
form: with ray features f = [o×d, d, o, 1] (10 per ray) and per-triangle
coefficient columns, the four quantities det, u·det, v·det and t·det of a
(rays × triangles) block are one product f · tri_feat. A second-level SAH
tree over the cluster boxes (one cluster per leaf) serves tree culling, for
scenes of more than 2048 clusters. Each ClusterSet also carries its table in
the kernels' order (`ops.visit_scan.slab_layout`) and its tree as kernel W's
node records (`ops.tree_walk.node_records`), made once per build or refit
rather than per kernel call, and keeps the bf16 kernels' table
(`ops.visit_scan.mma_layout`) from its first bf16 query (`mma_kernel_layout`).

The pair-stream intersector of that file, the CLI's default accel, follows
(`intersect_closest`, `intersect_any`, `stream_intersectors`): a dense
(ray, cluster) box test, the pairs compacted cluster-major, each cluster's
run padded to 128-pair tiles, one product per tile, and a per-ray min.
JAX lets XLA fuse the per-tile product (T,128,4K); eagerly that would be
181 GB on a 2560x1440 query, so the product runs over blocks of at most
`PAIR_BLOCK_TILES` tiles and reduces over K inside the block. Only the
live prefix of JAX's padded arrays is built: the slots past it hold no
pair. `torch.nonzero` syncs the host once a query.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.struct import TensorStruct
from ..ops.tree_walk import node_records
from ..ops.visit_scan import mma_layout, slab_layout
from ..scene.textures import take_rows
from .sah import build_sah_arrays, build_sah_boxes


@dataclasses.dataclass(frozen=True)
class ClusterSet(TensorStruct):
    """C clusters of K triangles each, the cluster tree over their boxes,
    and the coefficient table in the kernels' order."""

    aabb_lo: torch.Tensor   # (C,3) float32
    aabb_hi: torch.Tensor   # (C,3)
    tri_feat: torch.Tensor  # (C,10,4K) coefficient blocks [det|u|v|t]
    tri_id: torch.Tensor    # (C,K) int32 scene triangle ids, -1 = padding
    tree_lo: torch.Tensor   # (Nn,3) float32 node boxes, node 0 the root
    tree_hi: torch.Tensor   # (Nn,3)
    tree_child0: torch.Tensor   # (Nn,) int32, < 0: leaf -(i + 1)
    tree_child1: torch.Tensor   # (Nn,) int32
    tree_leaf_cluster: torch.Tensor  # (Nl,) int32 cluster of leaf i
    tree_depth: int
    tree_nodes: torch.Tensor    # (Nn,16) the tree as kernel W's records
    slabs: torch.Tensor     # (C,K,10,4) tri_feat in the kernels' order
    nlive: torch.Tensor     # (C,) int32 live slots per cluster

    @property
    def num_clusters(self) -> int:
        return self.tri_id.shape[0]

    @property
    def tris_per_cluster(self) -> int:
        return self.tri_id.shape[1]


TREE_FIELDS = ("tree_lo", "tree_hi", "tree_child0", "tree_child1",
               "tree_leaf_cluster", "tree_depth")


def ray_features(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Per-ray feature rows [o×d, d, o, 1] (...,10)."""
    return torch.cat([vm.cross(o, d), d, o, torch.ones_like(o[..., :1])],
                     dim=-1)


def sah_cluster_order(tri_pos: np.ndarray, cluster_size: int) -> np.ndarray:
    """(C,K) triangle ids of the SAH leaves of K triangles, -1 padded."""
    tp32 = np.asarray(tri_pos, np.float32)
    order = build_sah_arrays(tp32, leaf_size=cluster_size)[4]
    return order.reshape(-1, cluster_size)


def walk_layout(tree: dict) -> dict:
    """The `tree_nodes` field of a dict of the `tree_*` fields."""
    return dict(tree_nodes=node_records(
        tree["tree_lo"], tree["tree_hi"], tree["tree_child0"],
        tree["tree_child1"], tree["tree_leaf_cluster"]))


def box_tree(lo: np.ndarray, hi: np.ndarray) -> dict:
    """The `tree_*` fields of a binned-SAH tree over boxes (N,3), one box per
    leaf, and its `tree_nodes`. Boxes that are not finite or are padding
    (|x| >= 1e29) take 0."""
    clean = lambda a: np.where(np.isfinite(a) & (np.abs(a) < 1e29), a, 0.0)
    tlo, thi, c0, c1, order, depth = build_sah_boxes(clean(lo), clean(hi),
                                                     leaf_size=1)
    t_ = torch.from_numpy
    tree = dict(tree_lo=t_(tlo), tree_hi=t_(thi), tree_child0=t_(c0),
                tree_child1=t_(c1),
                tree_leaf_cluster=t_(order.astype(np.int32)),
                tree_depth=depth)
    return dict(tree, **walk_layout(tree))


def kernel_layout(tri_feat: torch.Tensor) -> dict:
    """The `slabs` and `nlive` fields of a (C,10,4K) coefficient table."""
    slabs, nlive = slab_layout(tri_feat, tri_feat.shape[2] // 4)
    return dict(slabs=slabs, nlive=nlive)


def mma_kernel_layout(cs) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 kernels' (frags, nlive) of a ClusterSet's (or an
    InstancedClusterSet's) table (`ops.visit_scan.mma_layout`), made at its
    first call and kept on the set; a refit, a rebuild or a move makes a new
    set, which makes its own."""
    layout = cs.__dict__.get("_mma_layout")
    if layout is None:
        layout = mma_layout(cs.tri_feat, cs.tris_per_cluster)
        object.__setattr__(cs, "_mma_layout", layout)   # a frozen dataclass
    return layout


def global_box_tree(tree: dict, lo: torch.Tensor, hi: torch.Tensor) -> dict:
    """`tree` with every node box set to the bounds of the boxes (N,3) whose
    |x| < 1e30, and its `tree_nodes`: the conservative tree refit."""
    big = 1e30
    glo = torch.where(lo.abs() < big, lo, big).amin(0)
    ghi = torch.where(hi.abs() < big, hi, -big).amax(0)
    shape = tree["tree_lo"].shape
    tree = dict(tree, tree_lo=glo.expand(shape).contiguous(),
                tree_hi=ghi.expand(shape).contiguous())
    return dict(tree, **walk_layout(tree))


def clusters_from_order(tri_pos, tri_id: np.ndarray) -> ClusterSet:
    """Cluster boxes and coefficient blocks for a given (C,K) membership,
    computed in float64 on the host and stored as float32."""
    tp = np.asarray(tri_pos, np.float32).astype(np.float64)
    ids = np.asarray(tri_id).astype(np.int64)
    c, k = ids.shape
    valid = ids >= 0
    tri3 = tp[np.maximum(ids, 0)]                  # (C,K,3,3)
    lo = np.where(valid[..., None], tri3.min(axis=2), np.inf).min(axis=1)
    hi = np.where(valid[..., None], tri3.max(axis=2), -np.inf).max(axis=1)
    lo = np.where(np.isfinite(lo), lo, 1e30)
    hi = np.where(np.isfinite(hi), hi, -1e30)
    p0 = tri3[:, :, 0]
    e1 = tri3[:, :, 1] - p0
    e2 = tri3[:, :, 2] - p0
    n = np.cross(e1, e2)

    def z3(a):  # (C,K,3) -> (C,3,K), zero on padding slots
        return np.where(valid[..., None], a, 0.0).transpose(0, 2, 1)

    feat = np.zeros((c, 10, 4 * k), np.float64)
    feat[:, 3:6, 0 * k:1 * k] = z3(-n)
    feat[:, 0:3, 1 * k:2 * k] = z3(e2)
    feat[:, 3:6, 1 * k:2 * k] = z3(np.cross(p0, e2))
    feat[:, 0:3, 2 * k:3 * k] = z3(-e1)
    feat[:, 3:6, 2 * k:3 * k] = z3(-np.cross(p0, e1))
    feat[:, 6:9, 3 * k:4 * k] = z3(n)
    feat[:, 9, 3 * k:4 * k] = np.where(
        valid, -np.einsum("ckj,ckj->ck", p0, n), 0.0)
    t_ = torch.from_numpy
    tri_feat = t_(feat.astype(np.float32))
    return ClusterSet(
        aabb_lo=t_(lo.astype(np.float32)), aabb_hi=t_(hi.astype(np.float32)),
        tri_feat=tri_feat, tri_id=t_(ids.astype(np.int32)),
        **box_tree(lo, hi), **kernel_layout(tri_feat))


def build_clusters(tri_pos, cluster_size: int = 64) -> ClusterSet:
    """SAH clusters of `cluster_size` triangles over (T,3,3) positions."""
    tp = (tri_pos.detach().cpu().numpy() if isinstance(tri_pos, torch.Tensor)
          else np.asarray(tri_pos))
    return clusters_from_order(tp, sah_cluster_order(tp, cluster_size))


def refit_clusters(cs: ClusterSet, tri_pos: torch.Tensor) -> ClusterSet:
    """Refit for dynamic scenes, on tri_pos's device in float32 as the JAX
    package's `refit_clusters` computes it (not `build_clusters`' float64
    host path): membership (tri_id) stays, boxes, Möller–Trumbore
    coefficients and the kernels' layout follow the new (T,3,3) world
    positions. The tree is refit conservatively, as JAX does: every node box
    becomes the bounds of all clusters, so tree culling stays sound (it
    admits every cluster, up to the visit cap)."""
    ids = cs.tri_id.long()
    valid = ids >= 0
    k = cs.tris_per_cluster
    c = ids.shape[0]
    tri3 = tri_pos[ids.clamp_min(0)]                 # (C,K,3,3)
    big = 1e30
    v3 = valid[..., None]
    lo = torch.where(v3, tri3.amin(2), big).amin(1)
    hi = torch.where(v3, tri3.amax(2), -big).amax(1)
    lo = torch.where(torch.isfinite(lo) & (lo.abs() < big), lo, big)
    hi = torch.where(torch.isfinite(hi) & (hi.abs() < big), hi, -big)

    p0 = tri3[:, :, 0]
    e1 = tri3[:, :, 1] - p0
    e2 = tri3[:, :, 2] - p0
    n = vm.cross(e1, e2)

    def z3(a):  # (C,K,3) -> (C,3,K), zero on padding slots
        return torch.where(v3, a, 0.0).transpose(1, 2)

    feat = torch.zeros((c, 10, 4 * k), dtype=torch.float32,
                       device=tri_pos.device)
    feat[:, 3:6, 0 * k:1 * k] = z3(-n)
    feat[:, 0:3, 1 * k:2 * k] = z3(e2)
    feat[:, 3:6, 1 * k:2 * k] = z3(vm.cross(p0, e2))
    feat[:, 0:3, 2 * k:3 * k] = z3(-e1)
    feat[:, 3:6, 2 * k:3 * k] = z3(-vm.cross(p0, e1))
    feat[:, 6:9, 3 * k:4 * k] = z3(n)
    feat[:, 9, 3 * k:4 * k] = torch.where(valid, -(p0 * n).sum(-1), 0.0)
    tree = {f: getattr(cs, f) for f in TREE_FIELDS}
    return cs.replace(aabb_lo=lo, aabb_hi=hi, tri_feat=feat,
                      **global_box_tree(tree, lo, hi), **kernel_layout(feat))


# -- the pair-stream intersector ----------------------------------------------

PAIR_TILE = 128
PAIR_BLOCK_TILES = 8192     # tiles per block of the product: 1,048,576 pairs
MASK_RAYS = 1 << 18         # rays per block of the (R,C) box test


def _ray_cluster_mask(cs: ClusterSet, o, d, t_min, t_max) -> torch.Tensor:
    """Dense (R,C) slab test, as the (R,C) view of a cluster-major (C,R)
    tensor; computed over blocks of MASK_RAYS rays."""
    r, c = o.shape[0], cs.num_clusters
    tiny = torch.where(d >= 0, 1e-20, -1e-20)
    inv = 1.0 / torch.where(d.abs() > 1e-20, d, tiny)
    out = torch.empty((c, r), dtype=torch.bool, device=o.device)
    for a in range(0, r, MASK_RAYS):
        b = min(a + MASK_RAYS, r)
        t0 = (cs.aabb_lo[None] - o[a:b, None]) * inv[a:b, None]
        t1 = (cs.aabb_hi[None] - o[a:b, None]) * inv[a:b, None]
        tn = torch.minimum(t0, t1).amax(-1)
        tf = torch.maximum(t0, t1).amin(-1)
        out[:, a:b] = ((tn <= tf) & (tf >= t_min[a:b, None])
                       & (tn <= t_max[a:b, None])).T
    return out.T


def _extract_pairs(mask_rc: torch.Tensor, max_pairs: int):
    """Cluster-major compaction of the (R,C) mask: (pair_ray (P,),
    pair_cluster (P,), overflow ()) int64, the first P <= max_pairs pairs
    in JAX's order (JAX pads to max_pairs with -1)."""
    r = mask_rc.shape[0]
    idx = torch.nonzero(mask_rc.T.reshape(-1)).reshape(-1)  # host sync
    overflow = torch.tensor(idx.numel() > max_pairs, device=idx.device)
    idx = idx[:max_pairs]
    return idx % r, idx // r, overflow


def _pad_runs_to_tiles(pair_ray, pair_cluster, num_clusters: int):
    """Scatter the pairs so each cluster's run starts on a PAIR_TILE
    boundary: (padded_ray (S,), tile_cluster (S/PAIR_TILE,)) int64, -1
    where no pair is. S bounds the runs' padded length; the slots are the
    first S of JAX's out_size, at the same positions."""
    n, c = pair_ray.shape[0], num_clusters
    dev = pair_ray.device
    counts = torch.bincount(pair_cluster, minlength=c)
    starts = torch.cumsum(counts, 0) - counts
    padded = (counts + PAIR_TILE - 1) // PAIR_TILE * PAIR_TILE
    offsets = torch.cumsum(padded, 0) - padded
    dest = (offsets[pair_cluster]
            + torch.arange(n, device=dev) - starts[pair_cluster])
    size = -(-n // PAIR_TILE) * PAIR_TILE + c * PAIR_TILE
    padded_ray = torch.full((size,), -1, dtype=torch.int64, device=dev)
    padded_ray[dest] = pair_ray
    tile_cluster = torch.full((size // PAIR_TILE,), -1, dtype=torch.int64,
                              device=dev)
    tile_cluster[dest // PAIR_TILE] = pair_cluster   # one cluster a tile
    return padded_ray, tile_cluster


def _intersect_tiles(cs: ClusterSet, rf, t_min, t_max, padded_ray,
                     tile_cluster, need_uv: bool):
    """Möller–Trumbore of each pair tile against its cluster, one
    (128,10)x(10,4K) product a tile, over blocks of PAIR_BLOCK_TILES tiles,
    each pair reduced over K inside its block (the first K at the least t).

    rf: (R,10) ray features. Returns flat per-slot results (S,): (t, u, v,
    triangle id) of the pair's best hit (t = inf without one), or with
    need_uv=False the pair's any-hit bit."""
    k = cs.tris_per_cluster
    tiles = tile_cluster.shape[0]
    pr_all = padded_ray.reshape(tiles, PAIR_TILE)
    dev = rf.device
    shape = (tiles, PAIR_TILE)
    if need_uv:
        t_p = torch.empty(shape, dtype=torch.float32, device=dev)
        u_p, v_p = torch.empty_like(t_p), torch.empty_like(t_p)
        id_p = torch.empty(shape, dtype=cs.tri_id.dtype, device=dev)
    else:
        any_p = torch.empty(shape, dtype=torch.bool, device=dev)
    for a in range(0, tiles, PAIR_BLOCK_TILES):
        b = min(a + PAIR_BLOCK_TILES, tiles)
        pr = pr_all[a:b]
        prc = pr.clamp_min(0)
        tc = tile_cluster[a:b].clamp_min(0)
        res = torch.bmm(take_rows(rf, prc), cs.tri_feat[tc])  # (nb,128,4K)
        det = res[..., 0 * k:1 * k]
        ok = det.abs() > 1e-12
        inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        u = res[..., 1 * k:2 * k] * inv
        v = res[..., 2 * k:3 * k] * inv
        t = res[..., 3 * k:4 * k] * inv
        tid = cs.tri_id[tc]                              # (nb,K)
        hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > t_min[prc][..., None]) & (t <= t_max[prc][..., None])
               & (tid[:, None, :] >= 0) & (pr >= 0)[..., None])
        if not need_uv:
            any_p[a:b] = hit.any(-1)
            continue
        t = torch.where(hit, t, torch.inf)
        kbest = t.argmin(-1, keepdim=True)
        t_p[a:b] = t.gather(-1, kbest)[..., 0]
        u_p[a:b] = u.gather(-1, kbest)[..., 0]
        v_p[a:b] = v.gather(-1, kbest)[..., 0]
        id_p[a:b] = tid.gather(1, kbest[..., 0])
    if not need_uv:
        return any_p.reshape(-1)
    return t_p.reshape(-1), u_p.reshape(-1), v_p.reshape(-1), id_p.reshape(-1)


def _sizes(r: int, c: int, max_pairs_per_ray: int):
    max_pairs = ((r * max_pairs_per_ray) // PAIR_TILE + 1) * PAIR_TILE
    out_size = max_pairs + c * PAIR_TILE
    return max_pairs, out_size


def pair_stream(cs: ClusterSet, origins, dirs, t_min, t_max,
                max_pairs_per_ray: int = 8) -> Dict:
    """A query's pair stream: {"t_min", "t_max" (R,), "padded_ray",
    "tile_cluster", "overflow", "pairs" (the pairs kept)}."""
    r = origins.shape[0]
    tn = vm.per_ray(t_min, r, origins.device)
    tx = vm.per_ray(t_max, r, origins.device)
    max_pairs, _ = _sizes(r, cs.num_clusters, max_pairs_per_ray)
    mask = _ray_cluster_mask(cs, origins, dirs, tn, tx)
    pair_ray, pair_cluster, overflow = _extract_pairs(mask, max_pairs)
    del mask
    padded_ray, tile_cluster = _pad_runs_to_tiles(pair_ray, pair_cluster,
                                                  cs.num_clusters)
    return {"t_min": tn, "t_max": tx, "padded_ray": padded_ray,
            "tile_cluster": tile_cluster, "overflow": overflow,
            "pairs": pair_ray.shape[0]}


def intersect_closest(cs: ClusterSet, origins, dirs, t_min, t_max,
                      max_pairs_per_ray: int = 8) -> Dict[str, torch.Tensor]:
    """Closest hits {"t", "tri" (-1 = miss), "u", "v"} (R,) and "overflow"
    (more pairs than the cap: some were dropped). The winner of a ray is
    the pair of the smallest padded slot among those at its least t."""
    r = origins.shape[0]
    q = pair_stream(cs, origins, dirs, t_min, t_max, max_pairs_per_ray)
    pr = q["padded_ray"]
    t_p, u_p, v_p, id_p = _intersect_tiles(
        cs, ray_features(origins, dirs), q["t_min"], q["t_max"], pr,
        q["tile_cluster"], need_uv=True)
    ray_p = torch.where(pr >= 0, pr, r)
    best_t = torch.full((r + 1,), torch.inf, device=pr.device)
    best_t.scatter_reduce_(0, ray_p, t_p, "amin")
    is_win = (t_p <= best_t[ray_p]) & torch.isfinite(t_p)
    big = torch.iinfo(torch.int64).max
    win = torch.full((r + 1,), big, dtype=torch.int64, device=pr.device)
    win.scatter_reduce_(0, torch.where(is_win, ray_p, r),
                        torch.arange(pr.shape[0], device=pr.device), "amin")
    win = win[:r]
    found = win < big
    wi = torch.where(found, win, 0)
    return {"t": torch.where(found, t_p[wi], torch.inf),
            "tri": torch.where(found, id_p[wi], -1),
            "u": torch.where(found, u_p[wi], 0.0),
            "v": torch.where(found, v_p[wi], 0.0),
            "overflow": q["overflow"]}


def intersect_any(cs: ClusterSet, origins, dirs, t_min, t_max,
                  max_pairs_per_ray: int = 8) -> torch.Tensor:
    """Occlusion (R,) bool: True where a triangle blocks [t_min, t_max]."""
    r = origins.shape[0]
    q = pair_stream(cs, origins, dirs, t_min, t_max, max_pairs_per_ray)
    pr = q["padded_ray"]
    any_p = _intersect_tiles(cs, ray_features(origins, dirs), q["t_min"],
                             q["t_max"], pr, q["tile_cluster"],
                             need_uv=False)
    occ = torch.zeros(r + 1, dtype=torch.bool, device=pr.device)
    occ[torch.where(pr >= 0, pr, r)[any_p]] = True
    return occ[:r]


def stream_intersectors(cs: ClusterSet, max_pairs_per_ray: int = 8) -> Tuple:
    """Bind a ClusterSet into (intersect_fn, occlude_fn) for the wavefront
    loop. The intersect_fn keeps "overflow", which the port's frame
    reports (JAX's drops it)."""

    def isect(o, d, tn, tx):
        return intersect_closest(cs, o, d, tn, tx, max_pairs_per_ray)

    def occl(o, d, tn, tx):
        return intersect_any(cs, o, d, tn, tx, max_pairs_per_ray)

    return isect, occl
