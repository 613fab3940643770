"""Ray sorting for coherence: sort, query, unsort.

Port of `lumenrenderer_tpu/accel/sorting.py`: `ray_sort_key`,
`capsule_sort_key` and `sorted_intersectors` (the frame's), and the
block-local partition `blocked_sorted_intersectors`, which the JAX package
keeps as a measured losing experiment on the TPU. Keys are int64 here where
the JAX package uses uint32; both sorts are stable, so the permutations are
the same. Tiling decides which clusters a tile admits, so the sort order must
match for occlusion to match.
"""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..utils import profiling
from . import morton

DEAD_KEY = 0xFFFFFFFF  # dead rays sort last: live tiles stay tight
PARTITION_BLOCK = 2048  # rays a block of the block-local partition


def ray_sort_key(o, d, scene_lo, scene_hi) -> torch.Tensor:
    """Bounce-ray key: [octant(3) | origin morton(21)]."""
    octant = ((d[:, 0] >= 0).to(torch.int64)
              | ((d[:, 1] >= 0).to(torch.int64) << 1)
              | ((d[:, 2] >= 0).to(torch.int64) << 2))
    m = morton.morton3d(o, scene_lo, scene_hi) >> 9
    return (octant << 29) | m


def capsule_sort_key(o, d, t_max, scene_lo, scene_hi) -> torch.Tensor:
    """Shadow-ray key: [origin morton(12) | endpoint morton(12)]."""
    end = o + d * t_max.clamp_min(0.0)[:, None]
    m_o = morton.morton3d(o, scene_lo, scene_hi) >> 18
    m_e = morton.morton3d(end, scene_lo, scene_hi) >> 18
    return (m_o << 12) | m_e


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


def sorted_intersectors(isect, occl, scene_lo, scene_hi):
    """Wrap (intersect_fn, occlude_fn): bounce rays sort by octant|morton,
    shadow rays by the origin->endpoint capsule key."""

    def _prep(o, d, tn, tx, capsule):
        r = o.shape[0]
        tn_b = vm.per_ray(tn, r, o.device)
        tx_b = vm.per_ray(tx, r, o.device)
        key = (capsule_sort_key(o, d, tx_b, scene_lo, scene_hi) if capsule
               else ray_sort_key(o, d, scene_lo, scene_hi))
        key = torch.where(tx_b > tn_b, key, torch.full_like(key, DEAD_KEY))
        order = torch.argsort(key, stable=True)
        return order, o[order], d[order], tn_b[order], tx_b[order]

    def isect_sorted(o, d, tn, tx):
        with profiling.span("accel.sort"):
            order, os_, ds_, tns, txs = _prep(o, d, tn, tx, capsule=False)
            res = isect(os_, ds_, tns, txs)
            inv = _inverse(order)
            return {k: (v[inv] if v.ndim > 0 else v) for k, v in res.items()}

    def occl_sorted(o, d, tn, tx):
        with profiling.span("accel.sort"):
            order, os_, ds_, tns, txs = _prep(o, d, tn, tx, capsule=True)
            return occl(os_, ds_, tns, txs)[_inverse(order)]

    return isect_sorted, occl_sorted


def _block_partition_order(buckets: torch.Tensor, n_buckets: int,
                           block: int) -> torch.Tensor:
    """The stable block-local counting partition of the JAX package: within
    each block of `block` rays, the rays by bucket (int in [0, n_buckets)),
    ties in ray order. Returns order (R,) int64, the source of each sorted
    slot (R % block == 0). A stable sort within each block gives the same
    permutation as the partition's ranks."""
    del n_buckets  # the sort needs no bucket count
    blocks = buckets.reshape(-1, block)
    base = torch.arange(blocks.shape[0], device=buckets.device)[:, None]
    return (torch.argsort(blocks, dim=1, stable=True)
            + base * block).reshape(-1)


def _radix_block_order(buckets: torch.Tensor, passes: int,
                       block: int) -> torch.Tensor:
    """The JAX package's LSD base-8 block-local radix over `passes` digits:
    stable passes compose to one stable partition by the low 3 * passes
    bits within each block."""
    bits = 3 * passes
    return _block_partition_order(buckets & ((1 << bits) - 1), 1 << bits,
                                  block)


def blocked_sorted_intersectors(isect, occl, scene_lo, scene_hi,
                                block: int = PARTITION_BLOCK):
    """Wrap (intersect_fn, occlude_fn) with a block-local partition instead
    of a global sort: bounce rays by direction octant, shadow rays by their
    endpoint's 6-bit Morton cell, each within blocks of `block` rays (the
    rays padded with dead ones to whole blocks); dead rays (t_max < t_min)
    go to the last bucket."""

    def _pack(o, d, tn, tx):
        r = o.shape[0]
        tn_b = vm.per_ray(tn, r, o.device)
        tx_b = vm.per_ray(tx, r, o.device)
        packed = torch.cat([o, d, tn_b[:, None], tx_b[:, None]], dim=1)
        pad = (-r) % block
        if pad:
            fill = torch.zeros((pad, 8), dtype=packed.dtype, device=o.device)
            fill[:, 6] = 1.0                   # t_min 1 > t_max 0: dead
            packed = torch.cat([packed, fill])
        return packed, r

    def _apply(packed, order):
        s = packed[order]
        return s[:, 0:3], s[:, 3:6], s[:, 6], s[:, 7]

    def isect_sorted(o, d, tn, tx):
        packed, r = _pack(o, d, tn, tx)
        dd = packed[:, 3:6]
        octant = ((dd[:, 0] >= 0).to(torch.int64)
                  | ((dd[:, 1] >= 0).to(torch.int64) << 1)
                  | ((dd[:, 2] >= 0).to(torch.int64) << 2))
        octant = torch.where(packed[:, 7] < packed[:, 6], 8, octant)
        order = _block_partition_order(octant, 9, block)
        res = isect(*_apply(packed, order))
        inv = _inverse(order)[:r]
        return {k: (v[inv] if v.ndim > 0 else v) for k, v in res.items()}

    def occl_sorted(o, d, tn, tx):
        packed, r = _pack(o, d, tn, tx)
        end = packed[:, 0:3] + packed[:, 3:6] * packed[:, 7].clamp_min(
            0.0)[:, None]
        cell = morton.morton3d(end, scene_lo, scene_hi) >> 24     # 6 bits
        cell = torch.where(packed[:, 7] < packed[:, 6], 63, cell)
        order = _radix_block_order(cell, 2, block)
        return occl(*_apply(packed, order))[_inverse(order)[:r]]

    return isect_sorted, occl_sorted
