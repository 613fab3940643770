"""The BVH format shared by the SAH and LBVH builders and the traversal.

Port of `lumenrenderer_tpu/accel/format.py`. Node boxes and child indices,
with each leaf's triangles in `leaf_size` consecutive slots in
Möller–Trumbore form. child0 >= 0: an internal node with children (child0,
child1); child0 < 0: leaf -child0 - 1, whose triangles occupy slots
[leaf * L, (leaf + 1) * L), padded with tri_id = -1 (p0 = inf, e1 = e2 =
0). Node 0 is the root. `leaf_size` and `max_depth` (levels of the
deepest leaf, the root 1) are plain ints: the traversal's stack holds
max_depth + 2 entries.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.struct import TensorStruct


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
    leaf_size: int
    max_depth: int

    @property
    def num_nodes(self) -> int:
        return self.node_lo.shape[0]

    @property
    def num_leaves(self) -> int:
        return self.tri_p0.shape[0] // self.leaf_size
