"""Tiled intersector: 128-ray tiles against ordered lists of SAH clusters.

Port of `lumenrenderer_tpu/accel/tiled.py` on the path the renderer takes:
tile-frustum culling builds each tile's visit list (`_frustum_visits`), the
visit scan (kernel K1, `ops/visit_scan.py`) returns one packed key per ray,
and the winner is decoded from the key without re-deriving t/u/v
(`decode=False`; `extract_surface_data` re-derives them exactly). Not
ported yet: cluster-tree culling for scenes of more than 2048 clusters, the
dense per-ray culling path, and the in-intersector exact decode.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..ops import visit_scan as vs
from .stream import ClusterSet, ray_features

RAY_TILE = vs.RAY_TILE
KEY_MISS = vs.KEY_MISS
MAX_FRUSTUM_CLUSTERS = 2048


def _pad(a: torch.Tensor, r_pad: int, fill: float) -> torch.Tensor:
    if r_pad == 0:
        return a
    tail = torch.full((r_pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, tail], dim=0)


def _tile_bounds(o, d, tn, tx, tiles: int, tile: int):
    """Per-tile conservative bounds over the live rays."""
    ot = o.reshape(tiles, tile, 3)
    dt = d.reshape(tiles, tile, 3)
    alive = (tx > tn).reshape(tiles, tile)
    a3 = alive[..., None]
    big = 3e37
    olo = torch.where(a3, ot, big).amin(1)
    ohi = torch.where(a3, ot, -big).amax(1)
    dlo = torch.where(a3, dt, big).amin(1)
    dhi = torch.where(a3, dt, -big).amax(1)
    t_cap = torch.where(alive, tx.reshape(tiles, tile), -big).amax(1)
    return olo, ohi, dlo, dhi, t_cap, alive.any(1)


def _frustum_visits(cs: ClusterSet, o, d, tn, tx, tiles: int, mv: int):
    """Interval-ray (packet) slab test of every (tile, cluster) pair.

    Returns (order (T,mv) cluster ids, valid (T,mv), tnear (T,mv) ascending,
    overflow ()). Ties in tnear keep cluster-id order, as `lax.top_k` does."""
    olo, ohi, dlo, dhi, t_cap, any_alive = _tile_bounds(
        o, d, tn, tx, tiles, RAY_TILE)
    eps = 1e-20
    inv_a = 1.0 / torch.where(dlo.abs() > eps, dlo, eps)
    inv_b = 1.0 / torch.where(dhi.abs() > eps, dhi, eps)
    zero_in_d = ((dlo <= 0.0) & (dhi >= 0.0))[:, None, :]
    nmin = cs.aabb_lo[None] - ohi[:, None]                       # (T,C,3)
    nmax = cs.aabb_hi[None] - olo[:, None]
    c1 = nmin * inv_a[:, None]
    c2 = nmin * inv_b[:, None]
    c3 = nmax * inv_a[:, None]
    c4 = nmax * inv_b[:, None]
    inf = torch.inf
    ent = torch.minimum(torch.minimum(c1, c2), torch.minimum(c3, c4))
    exi = torch.maximum(torch.maximum(c1, c2), torch.maximum(c3, c4))
    tn_lb = torch.where(zero_in_d, -inf, ent).amax(-1)           # (T,C)
    tf_ub = torch.where(zero_in_d, inf, exi).amin(-1)
    hit = ((tn_lb <= tf_ub) & (tf_ub >= 0.0) & (tn_lb <= t_cap[:, None])
           & any_alive[:, None])
    # + 0.0 turns -0.0 into +0.0 so zero entries tie by id alone
    tnear = torch.where(hit, tn_lb.clamp_min(0.0) + 0.0, inf)
    srt, idx = torch.sort(tnear, dim=1, stable=True)
    tnear_k = srt[:, :mv]
    overflow = (hit.sum(1) > mv).any()
    return idx[:, :mv].to(torch.int32), torch.isfinite(tnear_k), tnear_k, \
        overflow


def key_bits(k: int, mv: int) -> Tuple[int, int, int]:
    """(k_bits, s_bits, low_bits) of the packed key for K triangles per
    cluster and mv visits; t keeps 23 - low_bits mantissa bits."""
    k_bits = max((k - 1).bit_length(), 1)
    s_bits = max((mv - 1).bit_length(), 1)
    low_bits = k_bits + s_bits
    if low_bits > 15:
        raise ValueError(f"packed-key layout overflow: {k=} {mv=}")
    return k_bits, s_bits, low_bits


def scan_inputs(cs: ClusterSet, origins, dirs, t_min, t_max,
                max_visits: int) -> Dict:
    """Pad rays to whole tiles, cull, and build the visit scan's inputs:
    {"args": (rf_t, feats, sel, nv, tnb), "kw": {k, mv, k_bits, low_bits}},
    plus what the decode needs: s_bits, overflow, the ray count r and the
    (T,128) dead-lane mask (padding included)."""
    r = origins.shape[0]
    dev = origins.device
    t_min_b = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(r)
    t_max_b = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(r)
    r_pad = (-r) % RAY_TILE
    o = _pad(origins, r_pad, 0.0)
    d = _pad(dirs, r_pad, 1.0)
    tn = _pad(t_min_b, r_pad, 0.0)
    tx = _pad(t_max_b, r_pad, -1.0)          # padded rays are dead
    tiles = (r + r_pad) // RAY_TILE
    k = cs.tris_per_cluster
    c = cs.num_clusters
    if c > MAX_FRUSTUM_CLUSTERS:
        raise NotImplementedError(
            f"{c} clusters: cluster-tree culling (more than "
            f"{MAX_FRUSTUM_CLUSTERS} clusters) is not ported yet")
    mv = min(max_visits, c)
    order, valid_k, tnear_k, overflow = _frustum_visits(
        cs, o, d, tn, tx, tiles, mv)
    k_bits, s_bits, low_bits = key_bits(k, mv)
    rf_t = torch.cat([ray_features(o, d), tn[:, None], tx[:, None]],
                     dim=1).reshape(tiles, RAY_TILE, 12)
    nv = valid_k.sum(1, dtype=torch.int32)
    tn_bits = tnear_k.clamp_min(0.0).view(torch.int32)
    tnb = torch.where(valid_k, tn_bits.clamp_max(KEY_MISS - 1),
                      torch.full_like(tn_bits, KEY_MISS))
    return {
        "args": (rf_t, cs.tri_feat, order, nv, tnb),
        "kw": dict(k=k, mv=mv, k_bits=k_bits, low_bits=low_bits),
        "s_bits": s_bits, "overflow": overflow, "r": r,
        "dead": (tx < tn).reshape(tiles, RAY_TILE),
    }


def _query(cs: ClusterSet, origins, dirs, t_min, t_max, max_visits: int,
           closest: bool, scan: Callable = vs.visit_scan
           ) -> Dict[str, torch.Tensor]:
    q = scan_inputs(cs, origins, dirs, t_min, t_max, max_visits)
    out = scan(*q["args"], **q["kw"], closest=closest)
    r, overflow = q["r"], q["overflow"]
    live = ~q["dead"].reshape(-1)[:r]
    if not closest:
        return {"occluded": (out.reshape(-1)[:r] > 0) & live,
                "overflow": overflow}

    k_bits, low_bits = q["kw"]["k_bits"], q["kw"]["low_bits"]
    s_bits = q["s_bits"]
    order = q["args"][2]
    bk = out.reshape(-1)[:r]
    found = live & (bk < KEY_MISS)   # dead lanes carry key 0
    k_win = torch.where(found, bk & ((1 << k_bits) - 1), 0).long()
    step_win = torch.where(found, (bk >> k_bits) & ((1 << s_bits) - 1),
                           0).long()
    tile_idx = torch.arange(r, device=origins.device) // RAY_TILE
    cluster = order[tile_idx, step_win].long()
    tri_g = cs.tri_id[cluster, k_win]
    low_mask = ~((1 << low_bits) - 1)
    # t is the key's quantized distance: good to ~2^-(23 - low_bits)
    t_key = (bk & low_mask).view(torch.float32)
    return {
        "t": torch.where(found, t_key, torch.inf),
        "tri": torch.where(found, tri_g, -1),
        "overflow": overflow,
    }


def intersect_closest(cs: ClusterSet, origins, dirs, t_min, t_max,
                      max_visits: int = 12, scan: Callable = vs.visit_scan):
    """Closest hits: {"t" (quantized), "tri" (-1 = miss), "overflow"}."""
    return _query(cs, origins, dirs, t_min, t_max, max_visits, True, scan)


def intersect_any(cs: ClusterSet, origins, dirs, t_min, t_max,
                  max_visits: int = 12, scan: Callable = vs.visit_scan):
    """Occlusion mask (R,) bool."""
    return _query(cs, origins, dirs, t_min, t_max, max_visits, False,
                  scan)["occluded"]


def tiled_intersectors(cs: ClusterSet, max_visits: int = 12,
                       scan: Callable = vs.visit_scan) -> Tuple:
    """Bind a ClusterSet into (intersect_fn, occlude_fn) for the wavefront
    loop. `scan` is the visit scan: the kernel wrapper, or its plain twin
    `visit_scan_ref` to compare the two on one device."""

    def isect(o, d, tn, tx):
        return intersect_closest(cs, o, d, tn, tx, max_visits, scan)

    def occl(o, d, tn, tx):
        return intersect_any(cs, o, d, tn, tx, max_visits, scan)

    return isect, occl
