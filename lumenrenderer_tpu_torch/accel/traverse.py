"""BVH traversal: closest-hit and occlusion queries over a `format.BVH`.

Port of `lumenrenderer_tpu/accel/traverse.py`. JAX runs `_traverse_scalar`
under `vmap` as one XLA while_loop; here the walk is kernel T
(`ops/bvh_traverse.py`, `csrc/bvh_traverse.cu`) on a CUDA device and its
plain twin, the lockstep walk with per-ray stacks (R, max_depth + 2), on
the CPU. The `_ref` functions always run the twin.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core import vecmath as vm
from ..ops import bvh_traverse as bt
from .format import BVH


def _walk(walk, bvh, origins, dirs, t_min, t_max, any_hit: bool):
    r, dev = origins.shape[0], origins.device
    return walk(bvh, origins.contiguous(), dirs.contiguous(),
                vm.per_ray(t_min, r, dev).contiguous(),
                vm.per_ray(t_max, r, dev).contiguous(), any_hit=any_hit)


def _closest(walk, bvh, origins, dirs, t_min, t_max):
    t, tri, u, v = _walk(walk, bvh, origins, dirs, t_min, t_max, False)
    return {"t": t, "tri": tri, "u": u, "v": v}


def _any(walk, bvh, origins, dirs, t_min, t_max):
    return _walk(walk, bvh, origins, dirs, t_min, t_max, True)


def intersect_closest(bvh: BVH, origins, dirs, t_min, t_max):
    """Closest hits of rays (R,3); t_min, t_max scalars or (R,). Returns
    {"t", "tri", "u", "v"} (R,) with t = inf and tri = -1 on a miss."""
    return _closest(bt.bvh_traverse, bvh, origins, dirs, t_min, t_max)


def intersect_any(bvh: BVH, origins, dirs, t_min, t_max) -> torch.Tensor:
    """Occlusion (R,) bool; the walk stops at the first triangle taken."""
    return _any(bt.bvh_traverse, bvh, origins, dirs, t_min, t_max)


def intersect_closest_ref(bvh: BVH, origins, dirs, t_min, t_max):
    """`intersect_closest` through the plain twin on any device."""
    return _closest(bt.bvh_traverse_ref, bvh, origins, dirs, t_min, t_max)


def intersect_any_ref(bvh: BVH, origins, dirs, t_min, t_max):
    """`intersect_any` through the plain twin on any device."""
    return _any(bt.bvh_traverse_ref, bvh, origins, dirs, t_min, t_max)


def bvh_intersectors(bvh: BVH) -> Tuple:
    """(intersect_fn, occlude_fn) over the BVH for the wavefront frame:
    kernel T on CUDA tensors, its twin on CPU tensors; the closest query
    also returns overflow (always False: a walk drops no hit)."""
    no_overflow = torch.tensor(False, device=bvh.node_lo.device)

    def isect(o, d, tn, tx):
        return dict(intersect_closest(bvh, o, d, tn, tx),
                    overflow=no_overflow)

    def occl(o, d, tn, tx):
        return intersect_any(bvh, o, d, tn, tx)

    return isect, occl
