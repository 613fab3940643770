"""The yardstick of a kernel's share of its roofline: the card's published
peaks, the least time a call could take, and kernel K1's operations and
bytes counted from its inputs and its own visit counter.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, without
sparsity), which assume the full 700 W power limit; a share is stated with
the card's power limit beside it.
"""
from __future__ import annotations

from typing import Tuple

import torch

PEAK_FP32_FLOPS = 67e12       # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12      # bf16 on the tensor cores (a bf16 kernel's)
PEAK_BYTES = 3.35e12          # HBM3
FLOP_PER_PAIR = 80            # 40 FMAs per ray-triangle test: 10 features
                              # times [det, u, v, t]
RAY_TILE = 128
KEY_MISS = 0x7F000000         # the visit scan's key of no hit


def bound_s(flop: float, nbytes: float,
            peak_flops: float = PEAK_FP32_FLOPS) -> Tuple[float, str]:
    """(least seconds, what sets it) for `flop` operations and `nbytes`."""
    ops, mem = flop / peak_flops, nbytes / PEAK_BYTES
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def live_triangles(feats: torch.Tensor, k: int) -> torch.Tensor:
    """(C,) live triangles of each cluster of the coefficient table
    (C,10,4K): one past the last slot with a nonzero coefficient, at
    least 1 (the slots after it are padding that never hits)."""
    c = feats.shape[0]
    nz = feats.view(c, 10, 4, k).permute(0, 3, 1, 2).reshape(c, k, 40)
    slot = torch.arange(1, k + 1, device=feats.device)
    return (nz.ne(0).any(-1) * slot).amax(-1).clamp_min(1).double()


def visit_flop(rf_t, feats, sel, visits, k: int) -> float:
    """FLOP_PER_PAIR for each (live ray, live triangle) pair of the visits
    each tile ran: rf_t (T,128,12) ray features with t_min, t_max in
    columns 10, 11 (a ray is live when t_max >= t_min), sel (T,mv) the
    visit lists, visits (T,) the visits run."""
    live_rays = (rf_t[..., 11] >= rf_t[..., 10]).sum(1).double()
    tris = live_triangles(feats, k)
    sel = sel.long().clamp(0, tris.shape[0] - 1)
    ran = (torch.arange(sel.shape[1], device=sel.device)[None]
           < visits[:, None].long())
    return FLOP_PER_PAIR * float((live_rays[:, None] * tris[sel] * ran).sum())


def visit_bytes(rf_t, feats, sel, nv, tnb) -> int:
    """Each input once and the (T,128) int32 output once."""
    return nbytes(rf_t, feats, sel, nv, tnb) + rf_t.shape[0] * RAY_TILE * 4


# -- the visits a tile runs, replayed (float32 mode) -------------------------

def _slab_hits(rf, slab, tmin, tmax, k: int, closest: bool):
    res = torch.bmm(rf, slab)
    det, un, vn, tn = res.split(k, dim=-1)
    s = torch.sign(det)
    ad = det * s
    us, vs, ts = un * s, vn * s, tn * s
    hit = ((ad > 1e-12) & (us >= 0.0) & (vs >= 0.0) & (us + vs <= ad)
           & (ts > tmin * ad) & (ts <= tmax * ad))
    if not closest:
        return hit, None
    ad_safe = torch.where(ad > 1e-12, ad, torch.ones_like(ad))
    return hit, (ts / ad_safe).clamp_min(0.0).view(torch.int32)


def replay_visits(rf_t, feats, sel, nv, tnb, *, k: int, mv: int,
                  k_bits: int, low_bits: int, closest: bool) -> torch.Tensor:
    """(T,) visits each tile runs under the visit scan's block-wide vote:
    before visit i (i < min(nv, mv)) a tile stops when every lane is dead
    or, closest, holds a key whose t field lies below that of the entry t
    `tnb[:, i]`, or, any, is occluded. Keys pack (t bits above low_bits,
    visit << k_bits, slot)."""
    rf = rf_t[..., :10]
    tmin, tmax = rf_t[..., 10:11], rf_t[..., 11:12]
    dead = rf_t[..., 11] < rf_t[..., 10]
    tiles = sel.shape[0]
    kid = torch.arange(k, dtype=torch.int32, device=sel.device)
    low_mask = ~((1 << low_bits) - 1)
    state = (torch.full((tiles, RAY_TILE), KEY_MISS, dtype=torch.int32,
                        device=sel.device) if closest else dead.clone())
    n = nv.clamp_max(mv)
    ran = n.clone()
    stopped = torch.zeros_like(n, dtype=torch.bool)
    for i in range(int(nv.max()) + 1 if tiles else 0):
        if closest:
            nxt = tnb[:, min(i, mv - 1)] >> low_bits
            done = (dead | ((state >> low_bits) < nxt[:, None])).all(1)
        else:
            done = state.all(1)
        stop = done & ~stopped & (i < n)
        ran = torch.where(stop, i, ran)
        stopped |= stop
        if i == int(nv.max()):
            break
        hit, tb = _slab_hits(rf, feats[sel[:, i].long()], tmin, tmax, k,
                             closest)
        hit &= (i < nv)[:, None, None]
        if closest:
            key = (tb & low_mask) | (i << k_bits) | kid
            key = torch.where(hit, key, torch.full_like(key, KEY_MISS))
            state = torch.minimum(state, key.amin(-1))
        else:
            state = state | hit.any(-1)
    return ran.to(torch.int32)
