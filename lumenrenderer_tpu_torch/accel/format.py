"""The BVH format shared by the SAH and LBVH builders and the traversal.

Port of `lumenrenderer_tpu/accel/format.py`. Node boxes and child indices,
with each leaf's triangles in `leaf_size` consecutive slots in
Möller–Trumbore form. child0 >= 0: an internal node with children (child0,
child1); child0 < 0: leaf -child0 - 1, whose triangles occupy slots
[leaf * L, (leaf + 1) * L), padded with tri_id = -1 (p0 = inf, e1 = e2 =
0). Node 0 is the root. `leaf_size` and `max_depth` (levels of the
deepest leaf, the root 1) are plain ints: the traversal's stack holds
max_depth + 2 entries.

The port's BVH also carries the same tree as kernel T's records, made once
at build (`make_bvh`): `nodes`, one 64-byte child-pair record per node
(`ops.tree_walk.node_records`: both children's boxes in the tree's own
floats, then each child's id, >= 0 internal or -(leaf + 1), bit-cast), and
`slots`, one 48-byte record per leaf slot: (p0, tri_id bit-cast), (e1, 0),
(e2, 0). The JAX package's fields are the BVH's own; the records repeat
them bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.struct import TensorStruct
from ..ops.tree_walk import node_records


@dataclasses.dataclass(frozen=True)
class BVH(TensorStruct):
    node_lo: torch.Tensor   # (N,3) float32
    node_hi: torch.Tensor   # (N,3) float32
    child0: torch.Tensor    # (N,) int32 (>= 0 internal child; < 0 leaf -i-1)
    child1: torch.Tensor    # (N,) int32
    tri_p0: torch.Tensor    # (S,3) float32 leaf-slot triangles (MT form)
    tri_e1: torch.Tensor    # (S,3)
    tri_e2: torch.Tensor    # (S,3)
    tri_id: torch.Tensor    # (S,) int32 scene triangle id, -1 = padding
    nodes: torch.Tensor     # (N,16) float32 kernel T's child-pair records
    slots: torch.Tensor     # (S,12) float32 kernel T's slot records
    leaf_size: int
    max_depth: int

    @property
    def num_nodes(self) -> int:
        return self.node_lo.shape[0]

    @property
    def num_leaves(self) -> int:
        return self.tri_p0.shape[0] // self.leaf_size


def slot_records(tri_p0, tri_e1, tri_e2, tri_id) -> torch.Tensor:
    """(S,12) float32: per slot (p0, tri_id bit-cast), (e1, 0), (e2, 0)."""
    zero = torch.zeros_like(tri_p0[:, :1])
    return torch.cat([tri_p0, tri_id[:, None].view(torch.float32), tri_e1,
                      zero, tri_e2, zero], 1).contiguous()


def kernel_records(bvh: BVH) -> dict:
    """The `nodes` and `slots` of a BVH's own arrays, on their device."""
    leaves = torch.arange(bvh.num_leaves, dtype=torch.int32,
                          device=bvh.child0.device)
    return dict(nodes=node_records(bvh.node_lo, bvh.node_hi, bvh.child0,
                                   bvh.child1, leaves),
                slots=slot_records(bvh.tri_p0, bvh.tri_e1, bvh.tri_e2,
                                   bvh.tri_id))


def make_bvh(node_lo, node_hi, child0, child1, tri_p0, tri_e1, tri_e2,
             tri_id, leaf_size: int, max_depth: int) -> BVH:
    """The BVH of the given arrays, with kernel T's records made from them
    on their device."""
    bvh = BVH(node_lo=node_lo, node_hi=node_hi, child0=child0,
              child1=child1, tri_p0=tri_p0, tri_e1=tri_e1, tri_e2=tri_e2,
              tri_id=tri_id, nodes=None, slots=None, leaf_size=leaf_size,
              max_depth=max_depth)
    return bvh.replace(**kernel_records(bvh))
