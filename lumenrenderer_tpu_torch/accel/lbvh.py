"""LBVH build: a Morton-sorted complete binary tree, built on the device.

Port of `lumenrenderer_tpu/accel/lbvh.py`. Triangles are sorted by the
Morton code of their box centroid (a stable sort, as `jnp.argsort` is);
runs of `leaf_size` sorted triangles form leaves, the leaf count is padded
to a power of two, and the tree is complete in heap order (children of i
are 2i + 1 and 2i + 2), its interior boxes made by log2(m) level-wise
min/max reductions.
"""
from __future__ import annotations

import torch

from . import morton
from .format import BVH, make_bvh

#: padded/invalid triangle slot marker
INVALID = -1


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0) if n > 1 else 1


def build_lbvh(tri_pos: torch.Tensor, leaf_size: int = 4) -> BVH:
    """The LBVH of (T,3,3) world-space triangles, on their device."""
    t = tri_pos.shape[0]
    if t == 0:
        raise ValueError("empty scene: no triangles to build an LBVH over")
    dev = tri_pos.device
    lo_t = tri_pos.amin(1)
    hi_t = tri_pos.amax(1)
    centroid = 0.5 * (lo_t + hi_t)
    codes = morton.morton3d(centroid, lo_t.amin(0), hi_t.amax(0))
    order = torch.argsort(codes, stable=True).to(torch.int32)

    m = _next_pow2(-(-t // leaf_size))          # padded leaf count
    pad = m * leaf_size - t
    tri_id = torch.cat([order, torch.full((pad,), INVALID, dtype=torch.int32,
                                          device=dev)])
    p = tri_pos[tri_id.clamp_min(0).long()]      # (slots,3,3)
    valid = (tri_id >= 0)[:, None]
    p0 = torch.where(valid, p[:, 0], torch.inf)
    e1 = torch.where(valid, p[:, 1] - p[:, 0], 0.0)
    e2 = torch.where(valid, p[:, 2] - p[:, 0], 0.0)

    # leaf boxes over their slots (inf boxes for padding)
    slot_lo = torch.where(valid, torch.minimum(torch.minimum(p[:, 0], p[:, 1]),
                                               p[:, 2]), torch.inf)
    slot_hi = torch.where(valid, torch.maximum(torch.maximum(p[:, 0], p[:, 1]),
                                               p[:, 2]), -torch.inf)
    cur_lo = slot_lo.reshape(m, leaf_size, 3).amin(1)
    cur_hi = slot_hi.reshape(m, leaf_size, 3).amax(1)
    levels_lo, levels_hi = [cur_lo], [cur_hi]
    while cur_lo.shape[0] > 1:
        cur_lo = torch.minimum(cur_lo[0::2], cur_lo[1::2])
        cur_hi = torch.maximum(cur_hi[0::2], cur_hi[1::2])
        levels_lo.append(cur_lo)
        levels_hi.append(cur_hi)

    # heap layout: internal node i has children 2i+1 / 2i+2; node j >= m-1
    # is leaf j-(m-1)
    ids = torch.arange(2 * m - 1, dtype=torch.int32, device=dev)
    is_leaf = ids >= (m - 1)
    child0 = torch.where(is_leaf, -(ids - (m - 1)) - 1, 2 * ids + 1)
    child1 = torch.where(is_leaf, 0, 2 * ids + 2).to(torch.int32)
    return make_bvh(torch.cat(levels_lo[::-1]), torch.cat(levels_hi[::-1]),
                    child0.to(torch.int32), child1, p0, e1, e2, tri_id,
                    leaf_size=leaf_size,
                    max_depth=max(int(m - 1).bit_length(), 1) + 1)
