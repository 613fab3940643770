"""Pair-admission intersector: cluster admission refined to the single ray.

Port of `lumenrenderer_tpu/accel/pairs.py`. The tiled intersector makes every
ray of a 128-ray tile pay for the union of its tile's clusters; this one
keeps only the (ray, cluster) pairs each ray enters:

1. tile culling (`tiled.cull_tiles`: the frustum up to 2048 clusters, the
   cluster tree past that) gives each tile its candidate clusters;
2. `_refine_hits` slab-tests each ray against its tile's candidates within
   its own [t_min, t_max];
3. `_emit_sorted_pairs` compacts the surviving pairs (at most `p_cap`; more
   sets `overflow`), sorts them by cluster, and pads each cluster's run to
   128, so a 128-pair tile refers to one cluster;
4. kernel K3 (`ops/pair_scan.py`) tests each pair tile against its cluster
   in one Möller–Trumbore product, with no visit loop;
5. the per-pair keys scatter back to the rays' candidate slots, and a min
   over the slots (any: an OR) gives the ray's result.

As in JAX, `precision` is K3's ("high" and "highest" fp32, "default" the
TPU's one bf16 pass) and `culling` picks step 1's: "auto", "frustum", and
the tree for any other value, "dense" included (`pairs.py:135-141`).

Dynamic shapes replace JAX's static ones where that is simpler eagerly:
`torch.nonzero` (one host sync) then truncation or padding to `p_cap`, and
scatters into a buffer with one parking slot. The caps (`PAIR_GROUP`,
`p_cap`, `s_cap`) are the JAX package's, so shapes and `overflow` agree.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops import pair_scan as ps
from .stream import ClusterSet, mma_kernel_layout, ray_features
from .tiled import KEY_MISS, RAY_TILE, cull_tiles, exact_winners, pad_rays

PAIR_GROUP = RAY_TILE * 8   # rays pad to this, and p_cap, s_cap round to it
REFINE_TILES = 2048         # tiles per chunk of the (T,128,mv,3) refine


def _refine_hits(cs: ClusterSet, o, d, tn, tx, sel, valid, tiles: int
                 ) -> torch.Tensor:
    """Exact per-ray slab test against the tile's candidate clusters:
    (tiles, 128, mv) bool, true where ray r enters cluster sel[tile(r), s]
    within [tn, tx]. Computed in chunks of tiles (elementwise, so equal to
    one pass)."""
    eps = 1e-20
    inv = 1.0 / torch.where(d.abs() > eps, d,
                            torch.where(d >= 0, eps, -eps))
    ot = o.reshape(tiles, RAY_TILE, 1, 3)
    it = inv.reshape(tiles, RAY_TILE, 1, 3)
    tn_r = tn.reshape(tiles, RAY_TILE, 1)
    tx_r = tx.reshape(tiles, RAY_TILE, 1)
    out = torch.empty((tiles, RAY_TILE, sel.shape[1]), dtype=torch.bool,
                      device=o.device)
    for a in range(0, tiles, REFINE_TILES):
        b = min(a + REFINE_TILES, tiles)
        s = sel[a:b].long()
        t0 = (cs.aabb_lo[s][:, None] - ot[a:b]) * it[a:b]  # (t,128,mv,3)
        t1 = (cs.aabb_hi[s][:, None] - ot[a:b]) * it[a:b]
        tnear = torch.minimum(t0, t1).amax(-1)
        tfar = torch.maximum(t0, t1).amin(-1)
        out[a:b] = ((tnear <= tfar) & (tfar >= tn_r[a:b])
                    & (tnear <= tx_r[a:b])
                    & (tx_r[a:b] >= tn_r[a:b])      # dead lanes emit none
                    & valid[a:b, None, :])
    return out


def _emit_sorted_pairs(hit, sel, c: int, mv: int, p_cap: int, s_cap: int):
    """Compact the refine mask into cluster-major, run-padded pair streams.

    Returns (idx (p_cap,) flat slot index ray*mv + slot, n_slots for
    padding; dest_orig (p_cap,) each pair's position in the padded stream,
    in idx order; pair_ray_s (s_cap,) the ray of each stream position,
    n_rays for padding; tile_cluster (s_cap/128,) int32; overflow ()).
    Indices are int64."""
    tiles = hit.shape[0]
    dev = hit.device
    n_rays = tiles * RAY_TILE
    n_slots = n_rays * mv
    idx = torch.nonzero(hit.reshape(-1)).reshape(-1)        # ascending
    overflow = torch.tensor(idx.numel() > p_cap, device=dev)
    idx = idx[:p_cap]
    if idx.numel() < p_cap:
        idx = torch.cat([idx, torch.full((p_cap - idx.numel(),), n_slots,
                                         dtype=idx.dtype, device=dev)])
    pair_ray = idx // mv                       # padding -> exactly n_rays
    r_tile = (pair_ray // RAY_TILE).clamp_max(tiles - 1)
    pair_cluster = sel[r_tile, idx % mv].long()
    ckey = torch.where(idx < n_slots, pair_cluster, c)     # padding last
    perm = torch.argsort(ckey, stable=True)
    ckey_s = ckey[perm]
    ray_s = pair_ray[perm]
    cl = torch.arange(c, device=dev)
    starts = torch.searchsorted(ckey_s, cl, side="left")
    ends = torch.searchsorted(ckey_s, cl, side="right")
    padded = (ends - starts + RAY_TILE - 1) // RAY_TILE * RAY_TILE
    offsets = torch.cumsum(padded, 0) - padded
    csafe = ckey_s.clamp_max(c - 1)
    rank = torch.arange(p_cap, device=dev) - starts[csafe]
    dest = torch.where(ckey_s < c, offsets[csafe] + rank, s_cap)
    # writes into s_cap + 1 slots: padding pairs all land on the last one
    pair_ray_s = torch.full((s_cap + 1,), n_rays, dtype=torch.int64,
                            device=dev)
    pair_ray_s[dest] = ray_s
    cluster_s = torch.full((s_cap + 1,), -1, dtype=torch.int64, device=dev)
    cluster_s[dest] = ckey_s
    tile_cluster = cluster_s[:s_cap].reshape(-1, RAY_TILE).amax(1)
    dest_orig = torch.empty_like(dest)
    dest_orig[perm] = dest
    return (idx, dest_orig, pair_ray_s[:s_cap],
            tile_cluster.clamp_min(0).to(torch.int32), overflow)


def scan_inputs(cs: ClusterSet, origins, dirs, t_min, t_max,
                max_visits: int, max_pairs_per_ray: int,
                culling: str = "auto") -> Dict:
    """Steps 1-3 and K3's inputs: {"args": (rf_pairs, feats, tile_cluster),
    "kw": {k, k_bits}}, the table's kernel layout, plus what the reduction
    needs: idx, dest_orig, sel, mv, the padded and real ray counts rp and
    r, s_cap, overflow and the (r,) live mask; and `pairs`, the number of
    admitted pairs."""
    r = origins.shape[0]
    dev = origins.device
    c = cs.num_clusters
    k = cs.tris_per_cluster
    o, d, tn, tx = pad_rays(origins, dirs, t_min, t_max, PAIR_GROUP)
    rp = o.shape[0]
    tiles = rp // RAY_TILE
    mv = min(max_visits, c)
    if culling not in ("auto", "frustum"):
        culling = "tree"
    sel, valid, _, cull_ovf = cull_tiles(cs, o, d, tn, tx, tiles, mv,
                                         culling)
    hit = _refine_hits(cs, o, d, tn, tx, sel, valid, tiles)
    p_cap = -(-(rp * max_pairs_per_ray) // PAIR_GROUP) * PAIR_GROUP
    s_cap = -(-(p_cap + c * RAY_TILE) // PAIR_GROUP) * PAIR_GROUP
    idx, dest_orig, pair_ray_s, tile_cluster, pair_ovf = _emit_sorted_pairs(
        hit, sel, c, mv, p_cap, s_cap)
    rf12 = torch.cat([ray_features(o, d), tn[:, None], tx[:, None]], dim=1)
    dead_row = torch.zeros((1, 12), dtype=torch.float32, device=dev)
    dead_row[0, 10] = 1.0                      # t_max < t_min: never hits
    rf_pairs = torch.cat([rf12, dead_row])[pair_ray_s.clamp_max(rp)]
    return {
        "args": (rf_pairs, cs.tri_feat, tile_cluster),
        "kw": dict(k=k, k_bits=max((k - 1).bit_length(), 1)),
        "layout": (cs.slabs, cs.nlive), "idx": idx, "dest_orig": dest_orig, "sel": sel, "mv": mv, "rp": rp,
        "r": r, "s_cap": s_cap, "overflow": cull_ovf | pair_ovf,
        "live": (tx >= tn)[:r], "pairs": int(hit.sum()),
    }


def _query(cs: ClusterSet, origins, dirs, t_min, t_max, max_visits: int,
           max_pairs_per_ray: int, closest: bool, decode: bool,
           precision: str = "high", culling: str = "auto"
           ) -> Dict[str, torch.Tensor]:
    q = scan_inputs(cs, origins, dirs, t_min, t_max, max_visits,
                    max_pairs_per_ray, culling)
    # the ClusterSet carries the fp32 layout and keeps the bf16 one
    layout = (mma_kernel_layout(cs) if ps.is_bf16(precision)
              else q["layout"])
    out_s = ps.pair_scan(*q["args"], **q["kw"], closest=closest,
                         layout=layout, precision=precision)
    r, rp, mv = q["r"], q["rp"], q["mv"]
    dev = origins.device
    # step 5: per-pair results back to the rays' candidate slots
    miss = KEY_MISS if closest else 0
    out_ext = torch.cat([out_s, torch.full((1,), miss, dtype=torch.int32,
                                           device=dev)])
    out_orig = out_ext[q["dest_orig"].clamp_max(q["s_cap"])]
    n_slots = rp * mv
    slots = torch.full((n_slots + 1,), miss, dtype=torch.int32, device=dev)
    slots[q["idx"]] = out_orig                  # padding pairs park at end
    slots = slots[:n_slots].reshape(rp, mv)
    overflow = q["overflow"]
    if not closest:
        return {"occluded": (slots > 0).any(1)[:r] & q["live"],
                "overflow": overflow}

    best = slots.amin(1)
    slot_win = slots.argmin(1)                  # first of equal keys
    found = (best < KEY_MISS)[:r]
    k_bits = q["kw"]["k_bits"]
    ray_ids = torch.arange(rp, device=dev)
    cl_w = q["sel"][ray_ids // RAY_TILE, slot_win][:r].long().clamp_min(0)
    k_win = (best & ((1 << k_bits) - 1))[:r].long()
    tri_g = cs.tri_id[cl_w, k_win]
    if not decode:
        # t is the key's quantized distance, good to ~2^-(23 - k_bits);
        # extract_surface_data re-derives t/u/v exactly
        t_key = (best[:r] & ~((1 << k_bits) - 1)).view(torch.float32)
        return {"t": torch.where(found, t_key, torch.inf),
                "tri": torch.where(found, tri_g, -1), "overflow": overflow}
    # exact winner: one (r,10,4) coefficient gather and product
    exact, found = exact_winners(cs.tri_feat, cs.tris_per_cluster, cl_w,
                                 k_win, origins, dirs, found)
    return {**exact, "tri": torch.where(found, tri_g, -1),
            "overflow": overflow}


def intersect_closest(cs: ClusterSet, origins, dirs, t_min, t_max,
                      max_visits: int = 128, max_pairs_per_ray: int = 8,
                      decode: bool = True, precision: str = "high",
                      culling: str = "auto") -> Dict[str, torch.Tensor]:
    """Closest hits: {"t", "tri" (-1 = miss), "overflow"}, and with decode
    the exact t and the barycentrics "u", "v"; without it t is the key's
    quantized distance."""
    return _query(cs, origins, dirs, t_min, t_max, max_visits,
                  max_pairs_per_ray, True, decode, precision, culling)


def intersect_any(cs: ClusterSet, origins, dirs, t_min, t_max,
                  max_visits: int = 128, max_pairs_per_ray: int = 8,
                  precision: str = "high", culling: str = "auto"
                  ) -> torch.Tensor:
    """Occlusion mask (R,) bool."""
    return _query(cs, origins, dirs, t_min, t_max, max_visits,
                  max_pairs_per_ray, False, False, precision,
                  culling)["occluded"]


def pair_intersectors(cs: ClusterSet, max_visits: int = 128,
                      max_pairs_per_ray: int = 8, decode: bool = True,
                      precision: str = "high", culling: str = "auto"
                      ) -> Tuple:
    """Bind a ClusterSet into (intersect_fn, occlude_fn) for the wavefront
    loop, with the contract of `tiled.tiled_intersectors`; `precision` is
    K3's."""
    ps.is_bf16(precision)

    def isect(o, d, tn, tx):
        return intersect_closest(cs, o, d, tn, tx, max_visits,
                                 max_pairs_per_ray, decode, precision,
                                 culling)

    def occl(o, d, tn, tx):
        return intersect_any(cs, o, d, tn, tx, max_visits, max_pairs_per_ray,
                             precision, culling)

    return isect, occl
