"""Tiled intersector: 128-ray tiles against ordered lists of SAH clusters.

Port of `lumenrenderer_tpu/accel/tiled.py` on the path the renderer takes:
tile culling builds each tile's visit list, the visit scan (kernel K1,
`ops/visit_scan.py`) returns one packed key per ray, and the winner is
decoded from the key without re-deriving t/u/v (`decode=False`;
`extract_surface_data` re-derives them exactly). Culling is the JAX Pallas
path's: `culling="auto"` tests every (tile, cluster) pair against the tile's
frustum (`_frustum_visits`) up to 2048 clusters and walks the cluster tree
past that (`_tile_tree_visits`, the walk in `ops/tree_walk.py`); "frustum"
and "tree" force one. Not ported: the dense per-ray culling path and the
in-intersector exact decode.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..ops import tree_walk as tw
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


def pad_rays(origins, dirs, t_min, t_max, group: int):
    """Per-ray windows from scalars or (R,) tensors, and the rays padded to a
    multiple of `group`: (o, d, tn, tx). Padded rays are dead (tx < tn)."""
    r = origins.shape[0]
    dev = origins.device
    t_min_b = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(r)
    t_max_b = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(r)
    r_pad = (-r) % group
    return (_pad(origins, r_pad, 0.0), _pad(dirs, r_pad, 1.0),
            _pad(t_min_b, r_pad, 0.0), _pad(t_max_b, r_pad, -1.0))


def _frustum_visits(cs: ClusterSet, o, d, tn, tx, tiles: int, mv: int):
    """Interval-ray (packet) slab test of every (tile, cluster) pair; `cs` is
    a ClusterSet or any table of boxes `aabb_lo`/`aabb_hi` (two-level units).
    Memory is (T,C,3) float32 per intermediate.

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


def _tile_tree_visits(acc, o, d, tn, tx, tiles: int, mv: int,
                      walk: Callable = tw.tile_tree_visits):
    """Depth-first, near-first walk of `acc`'s tree (a ClusterSet's cluster
    tree or an InstancedClusterSet's unit tree) by each tile's interval ray
    (`walk`: kernel W's wrapper `ops.tree_walk.tile_tree_visits`, or its
    twin); the walk's lists sorted by entry t (stable, as `jnp.argsort`).

    Returns (order (T,mv), valid (T,mv), tnear (T,mv) ascending, inf past
    the count, overflow ()). A tile that reaches more than mv leaves keeps
    the first mv it popped, not the nearest (ROADMAP C-12)."""
    olo, ohi, dlo, dhi, t_cap, any_alive = _tile_bounds(
        o, d, tn, tx, tiles, RAY_TILE)
    visits, vtn, count = walk(
        olo, ohi, dlo, dhi, t_cap, any_alive, acc.tree_lo, acc.tree_hi,
        acc.tree_child0, acc.tree_child1, acc.tree_leaf_cluster,
        tree_depth=acc.tree_depth, mv=mv, nodes=acc.tree_nodes)
    vtn, idx = torch.sort(vtn, dim=1, stable=True)
    visits = visits.gather(1, idx)
    valid = torch.arange(mv, device=o.device)[None] < count[:, None]
    overflow = (count > mv).any()
    return visits, valid, torch.where(valid, vtn, torch.inf), overflow


def cull_tiles(acc, o, d, tn, tx, tiles: int, mv: int,
               culling: str = "auto", walk: Callable = tw.tile_tree_visits):
    """Each tile's visit list by `culling`: "frustum", "tree" (through
    `walk`), or "auto" (the frustum up to MAX_FRUSTUM_CLUSTERS clusters or
    units, the tree past that, as the JAX package's Pallas path chooses).
    Returns what `_frustum_visits` returns."""
    if culling == "auto":
        culling = ("frustum" if acc.num_clusters <= MAX_FRUSTUM_CLUSTERS
                   else "tree")
    if culling == "frustum":
        return _frustum_visits(acc, o, d, tn, tx, tiles, mv)
    if culling == "tree":
        return _tile_tree_visits(acc, o, d, tn, tx, tiles, mv, walk)
    raise NotImplementedError(f"culling={culling!r} is not ported; "
                              "'auto', 'frustum' and 'tree' are")


def key_bits(k: int, mv: int) -> Tuple[int, int, int]:
    """(k_bits, s_bits, low_bits) of the packed key for K triangles per
    cluster and mv visits; t keeps 23 - low_bits mantissa bits."""
    k_bits = max((k - 1).bit_length(), 1)
    s_bits = max((mv - 1).bit_length(), 1)
    low_bits = k_bits + s_bits
    if low_bits > 15:
        raise ValueError(f"packed-key layout overflow: {k=} {mv=}")
    return k_bits, s_bits, low_bits


def visit_lists(acc, o, d, tn, tx, max_visits: int, culling: str = "auto",
                walk: Callable = tw.tile_tree_visits):
    """Cull the padded rays' tiles against `acc` (a ClusterSet, or the units
    of an InstancedClusterSet) and lay out the visit scan's list inputs:
    (sel (T,mv) int32, nv (T,) int32, tnb (T,mv) int32 entry-t bits with
    KEY_MISS past nv, overflow (), kw {k, mv, k_bits, low_bits}, s_bits)."""
    mv = min(max_visits, acc.num_clusters)
    sel, valid, tnear, overflow = cull_tiles(
        acc, o, d, tn, tx, o.shape[0] // RAY_TILE, mv, culling, walk)
    k_bits, s_bits, low_bits = key_bits(acc.tris_per_cluster, mv)
    nv = valid.sum(1, dtype=torch.int32)
    tn_bits = tnear.clamp_min(0.0).view(torch.int32)
    tnb = torch.where(valid, tn_bits.clamp_max(KEY_MISS - 1),
                      torch.full_like(tn_bits, KEY_MISS))
    kw = dict(k=acc.tris_per_cluster, mv=mv, k_bits=k_bits, low_bits=low_bits)
    return sel, nv, tnb, overflow, kw, s_bits


def decode_winners(out: torch.Tensor, q: Dict):
    """Decode a closest-mode visit scan's (T,128) keys for the r real rays
    of scan inputs `q`: (found (r,), the winning visit's entry of q["sel"]
    (r,) int64, the slot in its cluster (r,) int64, t (r,) the key's
    quantized distance, good to ~2^-(23 - low_bits), inf where not found)."""
    r, k_bits, low_bits = q["r"], q["kw"]["k_bits"], q["kw"]["low_bits"]
    bk = out.reshape(-1)[:r]
    found = q["live"] & (bk < KEY_MISS)   # dead lanes carry key 0
    slot = torch.where(found, bk & ((1 << k_bits) - 1), 0).long()
    step = torch.where(found, (bk >> k_bits) & ((1 << q["s_bits"]) - 1),
                       0).long()
    tile_idx = torch.arange(r, device=out.device) // RAY_TILE
    entry = q["sel"][tile_idx, step].long()
    t_key = (bk & ~((1 << low_bits) - 1)).view(torch.float32)
    return found, entry, slot, torch.where(found, t_key, torch.inf)


def scan_inputs(cs: ClusterSet, origins, dirs, t_min, t_max,
                max_visits: int, culling: str = "auto",
                walk: Callable = tw.tile_tree_visits) -> Dict:
    """Pad rays to whole tiles, cull, and build the visit scan's inputs:
    {"args": (rf_t, feats, sel, nv, tnb), "kw": {k, mv, k_bits, low_bits}},
    the table's kernel layout (slabs, nlive), plus what the decode needs:
    the visit lists sel, s_bits, overflow, the ray count r and the (r,) live
    mask."""
    r = origins.shape[0]
    o, d, tn, tx = pad_rays(origins, dirs, t_min, t_max, RAY_TILE)
    sel, nv, tnb, overflow, kw, s_bits = visit_lists(cs, o, d, tn, tx,
                                                     max_visits, culling,
                                                     walk)
    rf_t = torch.cat([ray_features(o, d), tn[:, None], tx[:, None]],
                     dim=1).reshape(-1, RAY_TILE, 12)
    return {"args": (rf_t, cs.tri_feat, sel, nv, tnb), "kw": kw,
            "layout": (cs.slabs, cs.nlive), "sel": sel, "s_bits": s_bits,
            "overflow": overflow, "r": r, "live": (tx >= tn)[:r]}


def _query(cs: ClusterSet, origins, dirs, t_min, t_max, max_visits: int,
           closest: bool, scan: Callable = vs.visit_scan,
           culling: str = "auto", walk: Callable = tw.tile_tree_visits
           ) -> Dict[str, torch.Tensor]:
    q = scan_inputs(cs, origins, dirs, t_min, t_max, max_visits, culling,
                    walk)
    out = scan(*q["args"], **q["kw"], closest=closest, layout=q["layout"])
    if not closest:
        return {"occluded": (out.reshape(-1)[:q["r"]] > 0) & q["live"],
                "overflow": q["overflow"]}
    found, cluster, slot, t = decode_winners(out, q)
    return {"t": t, "tri": torch.where(found, cs.tri_id[cluster, slot], -1),
            "overflow": q["overflow"]}


def intersect_closest(cs: ClusterSet, origins, dirs, t_min, t_max,
                      max_visits: int = 12, scan: Callable = vs.visit_scan,
                      culling: str = "auto",
                      walk: Callable = tw.tile_tree_visits):
    """Closest hits: {"t" (quantized), "tri" (-1 = miss), "overflow"}."""
    return _query(cs, origins, dirs, t_min, t_max, max_visits, True, scan,
                  culling, walk)


def intersect_any(cs: ClusterSet, origins, dirs, t_min, t_max,
                  max_visits: int = 12, scan: Callable = vs.visit_scan,
                  culling: str = "auto",
                  walk: Callable = tw.tile_tree_visits):
    """Occlusion mask (R,) bool."""
    return _query(cs, origins, dirs, t_min, t_max, max_visits, False,
                  scan, culling, walk)["occluded"]


def tiled_intersectors(cs: ClusterSet, max_visits: int = 12,
                       scan: Callable = vs.visit_scan,
                       culling: str = "auto",
                       walk: Callable = tw.tile_tree_visits) -> Tuple:
    """Bind a ClusterSet into (intersect_fn, occlude_fn) for the wavefront
    loop. `scan` is the visit scan and `walk` the tree walk: the kernel
    wrappers, or their plain twins (`visit_scan_ref`,
    `tile_tree_visits_ref`) to compare the two on one device. `culling`:
    see `cull_tiles`."""

    def isect(o, d, tn, tx):
        return intersect_closest(cs, o, d, tn, tx, max_visits, scan, culling,
                                 walk)

    def occl(o, d, tn, tx):
        return intersect_any(cs, o, d, tn, tx, max_visits, scan, culling,
                             walk)

    return isect, occl
