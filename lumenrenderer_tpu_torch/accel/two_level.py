"""Two-level instancing (TLAS over BLAS) for the tiled intersector.

Port of `lumenrenderer_tpu/accel/two_level.py`. Geometry is clustered once
per unique mesh, in object space (the BLAS: SAH clusters with Möller–Trumbore
coefficients, concatenated into one table); instances are a table of
transforms. A TLAS leaf is a unit, one (instance, cluster) pair, whose world
box is the instance-transformed object box. Tile culling runs over the
units as it runs over clusters (`tiled.cull_tiles`: the frustum up to 2048
units, the unit tree past that), and kernel K2
(`ops/visit_scan_instanced.py`) maps each tile's rays into the unit's object
space at every visit. The map keeps the ray's world t, so windows, the packed
key and the early-out work in world t as in the single-level scan.

A winner decodes to a virtual triangle id, `inst_tri_base[inst] +` its
mesh-local id, which indexes the flattened SceneData (`flatten_instances`
order), so shading is unchanged. `refit_instances` follows new transforms
in O(units) for dynamic scenes, and refits the unit tree conservatively.

As in JAX: `precision` is K2's ("high" and "highest" fp32, "default" the
TPU's one bf16 pass); `culling="dense"` walks the unit tree, as every value
but "frustum" and "auto" does there (`two_level.py:238-245`); `_query`'s
`decode` is accepted and has no effect: the winner's t is the key's
quantised distance and u, v are left to `extract_surface_data`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from ..core.struct import TensorStruct
from ..ops import tree_walk as tw
from ..ops import visit_scan_instanced as vsi
from .stream import (TREE_FIELDS, box_tree, build_clusters, global_box_tree,
                     kernel_layout, mma_kernel_layout)
from .tiled import RAY_TILE, decode_winners, pad_rays, visit_lists


@dataclasses.dataclass(frozen=True)
class InstancedClusterSet(TensorStruct):
    """Unit, BLAS and instance tables, and the unit tree. `aabb_lo`/`aabb_hi`
    are the units' world boxes and `tree_*` a tree over them, the fields
    that culling reads, so culling treats units as it treats clusters."""

    aabb_lo: torch.Tensor        # (V,3) world boxes of the units
    aabb_hi: torch.Tensor        # (V,3)
    unit_inst: torch.Tensor      # (V,) int32 instance of each unit
    unit_cluster: torch.Tensor   # (V,) int32 global cluster of each unit
    tri_feat: torch.Tensor       # (C,10,4K) object-space coefficients
    tri_id: torch.Tensor         # (C,K) int32 mesh-local ids, -1 = padding
    obj_lo: torch.Tensor         # (C,3) object-space cluster boxes
    obj_hi: torch.Tensor         # (C,3)
    inst_minv: torch.Tensor      # (I,3,4) world -> object affine
    inst_tri_base: torch.Tensor  # (I,) int32 virtual triangle id base
    inst_cluster_base: torch.Tensor  # (I,) int32 first cluster of the mesh
    tree_lo: torch.Tensor        # (Nn,3) unit tree node boxes
    tree_hi: torch.Tensor        # (Nn,3)
    tree_child0: torch.Tensor    # (Nn,) int32, < 0: leaf -(i + 1)
    tree_child1: torch.Tensor    # (Nn,) int32
    tree_leaf_cluster: torch.Tensor  # (V,) int32 unit of leaf i
    tree_depth: int
    tree_nodes: torch.Tensor     # (Nn,16) the unit tree as W's records
    slabs: torch.Tensor          # (C,K,10,4) tri_feat in the kernels' order
    nlive: torch.Tensor          # (C,) int32 live slots per cluster
    tris_per_cluster: int
    # the bf16 mode's table in fragment order is made at the set's first
    # bf16 query and kept on it (`stream.mma_kernel_layout`)

    @property
    def num_clusters(self) -> int:
        """The number of units (what culling counts)."""
        return self.aabb_lo.shape[0]


def _unit_boxes(lo, hi, mats):
    """World boxes of object boxes (V,3) under affines (V,4,4), from the
    8 corners, in float32 elementwise arithmetic."""
    corners = torch.stack([
        torch.where(torch.tensor([(i >> a) & 1 for a in range(3)],
                                 dtype=torch.bool, device=lo.device), hi, lo)
        for i in range(8)])                              # (8,V,3)
    rot = mats[:, :3, :3]
    w = (rot[None] * corners[:, :, None, :]).sum(-1) + mats[:, :3, 3]
    return w.amin(0), w.amax(0)


def build_instanced(meshes: Sequence[np.ndarray], inst_mesh: Sequence[int],
                    inst_transform: Sequence[np.ndarray],
                    cluster_size: int = 128) -> InstancedClusterSet:
    """meshes: per unique mesh its (T_m,3,3) object-space triangles;
    inst_mesh: each instance's mesh index; inst_transform: each instance's
    4x4 object -> world matrix. Clusters are built once per unique mesh."""
    sets = [build_clusters(np.asarray(m, np.float32), cluster_size)
            for m in meshes]
    mesh_cluster_base = np.cumsum([0] + [s.num_clusters for s in sets])[:-1]
    mesh_tris = [np.asarray(m).shape[0] for m in meshes]
    inst_mesh = np.asarray(inst_mesh, np.int32)
    mats = np.stack([np.asarray(t, np.float32).reshape(4, 4)
                     for t in inst_transform])
    n_inst = inst_mesh.shape[0]
    minv = np.zeros((n_inst, 3, 4), np.float32)
    tri_base = np.zeros((n_inst,), np.int32)
    cl_base = mesh_cluster_base[inst_mesh].astype(np.int32)
    u_inst, u_cluster = [], []
    base = 0
    for i, m in enumerate(inst_mesh):
        minv[i] = np.linalg.inv(mats[i])[:3, :4]
        tri_base[i] = base
        base += mesh_tris[m]
        c = sets[m].num_clusters
        u_inst.append(np.full((c,), i, np.int32))
        u_cluster.append(np.arange(c, dtype=np.int32) + cl_base[i])
    cat = lambda f: torch.cat([getattr(s, f) for s in sets])
    obj_lo, obj_hi = cat("aabb_lo"), cat("aabb_hi")
    unit_inst = torch.from_numpy(np.concatenate(u_inst))
    unit_cluster = torch.from_numpy(np.concatenate(u_cluster))
    v_lo, v_hi = _unit_boxes(obj_lo[unit_cluster.long()],
                             obj_hi[unit_cluster.long()],
                             torch.from_numpy(mats)[unit_inst.long()])
    tri_feat = cat("tri_feat")
    return InstancedClusterSet(
        aabb_lo=v_lo, aabb_hi=v_hi, unit_inst=unit_inst,
        unit_cluster=unit_cluster, tri_feat=tri_feat,
        tri_id=cat("tri_id"), obj_lo=obj_lo, obj_hi=obj_hi,
        inst_minv=torch.from_numpy(minv),
        inst_tri_base=torch.from_numpy(tri_base),
        inst_cluster_base=torch.from_numpy(cl_base),
        **box_tree(v_lo.numpy(), v_hi.numpy()), **kernel_layout(tri_feat),
        tris_per_cluster=cluster_size)


def refit_instances(ics: InstancedClusterSet,
                    transforms: torch.Tensor) -> InstancedClusterSet:
    """New (I,4,4) object -> world transforms: new world -> object affines
    and unit boxes, in O(units) on the tables' device; no triangle work, so
    the kernel layout stays. The unit tree is refit conservatively, as JAX
    does: every node box becomes the bounds of all units."""
    minv = torch.linalg.inv(transforms)[:, :3, :4]
    cl = ics.unit_cluster.long()
    v_lo, v_hi = _unit_boxes(ics.obj_lo[cl], ics.obj_hi[cl],
                             transforms[ics.unit_inst.long()])
    tree = {f: getattr(ics, f) for f in TREE_FIELDS}
    return ics.replace(aabb_lo=v_lo, aabb_hi=v_hi, inst_minv=minv,
                       **global_box_tree(tree, v_lo, v_hi))


def scan_inputs(ics: InstancedClusterSet, origins, dirs, t_min, t_max,
                max_visits: int, culling: str = "auto",
                walk: Callable = tw.tile_tree_visits) -> Dict:
    """Pad rays to whole tiles, cull the units (`tiled.cull_tiles`; "dense"
    walks the unit tree, as JAX does), and
    build K2's inputs: {"args": (rayblk, wnd, feats, sel_cl, minv12, nv,
    tnb), "kw": {k, mv, k_bits, low_bits}}, the table's kernel layout, plus
    what the decode needs: the (T,mv) unit lists sel, s_bits, overflow, the
    ray count r and the (r,) live mask."""
    r = origins.shape[0]
    o, d, tn, tx = pad_rays(origins, dirs, t_min, t_max, RAY_TILE)
    sel, nv, tnb, overflow, kw, s_bits = visit_lists(
        ics, o, d, tn, tx, max_visits,
        "tree" if culling == "dense" else culling, walk)
    zeros = torch.zeros((o.shape[0], 6), dtype=torch.float32, device=o.device)
    rayblk = torch.cat([o, d, zeros[:, :2]], dim=1).reshape(
        -1, RAY_TILE, 8).transpose(1, 2).contiguous()
    wnd = torch.cat([tn[:, None], tx[:, None], zeros],
                    dim=1).reshape(-1, RAY_TILE, 8)
    sel_l = sel.long()
    minv12 = ics.inst_minv.reshape(-1, 12)[ics.unit_inst[sel_l].long()]
    return {
        "args": (rayblk, wnd, ics.tri_feat, ics.unit_cluster[sel_l], minv12,
                 nv, tnb),
        "kw": kw, "layout": (ics.slabs, ics.nlive), "sel": sel,
        "s_bits": s_bits, "overflow": overflow,
        "r": r, "live": (tx >= tn)[:r],
    }


def _query(ics: InstancedClusterSet, origins, dirs, t_min, t_max,
           max_visits: int, closest: bool, culling: str = "auto",
           scan: Callable = vsi.visit_scan_instanced,
           walk: Callable = tw.tile_tree_visits, precision: str = "high",
           decode: bool = True) -> Dict[str, torch.Tensor]:
    del decode  # accepted and unused, as in JAX (ROADMAP C-24)
    q = scan_inputs(ics, origins, dirs, t_min, t_max, max_visits, culling,
                    walk)
    # the set carries the fp32 layout and keeps the bf16 one
    layout = (mma_kernel_layout(ics) if vsi.is_bf16(precision)
              else q["layout"])
    out = scan(*q["args"], **q["kw"], closest=closest, layout=layout,
               precision=precision)
    if not closest:
        return {"occluded": (out.reshape(-1)[:q["r"]] > 0) & q["live"],
                "overflow": q["overflow"]}
    found, unit, slot, t = decode_winners(out, q)
    # the virtual triangle id indexes the flattened SceneData
    tri = (ics.inst_tri_base[ics.unit_inst[unit].long()]
           + ics.tri_id[ics.unit_cluster[unit].long(), slot])
    return {"t": t, "tri": torch.where(found, tri, -1),
            "overflow": q["overflow"]}


def instanced_intersectors(ics: InstancedClusterSet, max_visits: int = 128,
                           culling: str = "auto",
                           scan: Callable = vsi.visit_scan_instanced,
                           walk: Callable = tw.tile_tree_visits,
                           precision: str = "high") -> Tuple:
    """Bind an InstancedClusterSet into (intersect_fn, occlude_fn) for the
    wavefront loop, with the contract of `tiled.tiled_intersectors`
    (decode=False): `scan` and `walk` are kernels K2 and W, or their twins
    (`visit_scan_instanced_ref`, `tile_tree_visits_ref`); `precision` is
    K2's."""
    vsi.is_bf16(precision)

    def isect(o, d, tn, tx):
        return _query(ics, o, d, tn, tx, max_visits, True, culling, scan,
                      walk, precision)

    def occl(o, d, tn, tx):
        return _query(ics, o, d, tn, tx, max_visits, False, culling, scan,
                      walk, precision)["occluded"]

    return isect, occl


def instance_tables(instances) -> Tuple[list, list, list]:
    """(meshes, inst_mesh, inst_transform) for `build_instanced` from a
    SceneBuilder's instances: one (T,3,3) object-space triangle array per
    unique mesh object (by identity), in order of first use."""
    slot: Dict[int, int] = {}
    meshes, inst_mesh, inst_tf = [], [], []
    for inst in instances:
        key = id(inst.mesh)
        if key not in slot:
            slot[key] = len(meshes)
            meshes.append(inst.mesh.positions[inst.mesh.indices])
        inst_mesh.append(slot[key])
        inst_tf.append(inst.transform)
    return meshes, inst_mesh, inst_tf
