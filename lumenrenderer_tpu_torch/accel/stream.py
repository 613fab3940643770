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
rather than per kernel call. The pair-stream intersector of that file
is not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.struct import TensorStruct
from ..ops.tree_walk import node_records
from ..ops.visit_scan import slab_layout
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
