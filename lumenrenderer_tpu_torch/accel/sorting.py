"""Ray sorting for coherence: sort, query, unsort.

Port of `ray_sort_key`, `capsule_sort_key` and `sorted_intersectors` from
`lumenrenderer_tpu/accel/sorting.py` (its block-local partition variants are
a recorded losing experiment and are not ported). Keys are int64 here where
the JAX package uses uint32; both sorts are stable, so the permutations are
the same. Tiling decides which clusters a tile admits, so the sort order must
match for occlusion to match.
"""
from __future__ import annotations

import torch

from . import morton

DEAD_KEY = 0xFFFFFFFF  # dead rays sort last: live tiles stay tight


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
        tn_b = torch.as_tensor(tn, dtype=torch.float32,
                               device=o.device).expand(r)
        tx_b = torch.as_tensor(tx, dtype=torch.float32,
                               device=o.device).expand(r)
        key = (capsule_sort_key(o, d, tx_b, scene_lo, scene_hi) if capsule
               else ray_sort_key(o, d, scene_lo, scene_hi))
        key = torch.where(tx_b > tn_b, key, torch.full_like(key, DEAD_KEY))
        order = torch.argsort(key, stable=True)
        return order, o[order], d[order], tn_b[order], tx_b[order]

    def isect_sorted(o, d, tn, tx):
        order, os_, ds_, tns, txs = _prep(o, d, tn, tx, capsule=False)
        res = isect(os_, ds_, tns, txs)
        inv = _inverse(order)
        return {k: (v[inv] if v.ndim > 0 else v) for k, v in res.items()}

    def occl_sorted(o, d, tn, tx):
        order, os_, ds_, tns, txs = _prep(o, d, tn, tx, capsule=True)
        return occl(os_, ds_, tns, txs)[_inverse(order)]

    return isect_sorted, occl_sorted
