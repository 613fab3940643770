"""Tiled intersector: 128-ray tiles against ordered lists of SAH clusters.

Port of `lumenrenderer_tpu/accel/tiled.py` (its Pallas path): tile culling
builds each tile's visit list, the visit scan (kernel K1,
`ops/visit_scan.py`) returns one packed key per ray, and the winner is
decoded from the key. With `decode=True` (the default, as in JAX) the
winner's t, u and v are re-derived exactly from its coefficient columns
(`exact_winners`); the renderer passes `decode=False` and takes the key's
quantised t, since `extract_surface_data` re-derives them.

Culling: `culling="auto"` tests every (tile, cluster) pair against the
tile's frustum (`_frustum_visits`) up to 2048 clusters and walks the cluster
tree past that (`_tile_tree_visits`, the walk in `ops/tree_walk.py`);
"frustum" and "tree" force one, and "dense" slab-tests every (ray, cluster)
pair and takes each tile's union (`_dense_visits`: exact, O(R·C), computed
in chunks of tiles). `candidate_dtype` picks K1's precision: "float32" and
"high" run fp32, "bfloat16" the TPU's one bf16 pass (`visit_scan`'s
"default").
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..core import vecmath as vm
from ..ops import tree_walk as tw
from ..ops import visit_scan as vs
from ..utils import profiling
from .stream import ClusterSet, mma_kernel_layout, ray_features

RAY_TILE = vs.RAY_TILE
KEY_MISS = vs.KEY_MISS
MAX_FRUSTUM_CLUSTERS = 2048
DENSE_PAIRS = 1 << 22       # (ray, cluster) pairs a chunk of the dense cull
# candidate_dtype -> the visit scan's precision
CANDIDATE_PRECISION = {"float32": "highest", "high": "highest",
                       "bfloat16": "default"}


def candidate_precision(candidate_dtype: str) -> str:
    """The visit scan's precision for `candidate_dtype`; ValueError on an
    unknown one."""
    if candidate_dtype not in CANDIDATE_PRECISION:
        raise ValueError(f"candidate_dtype {candidate_dtype!r} not in "
                         f"{tuple(CANDIDATE_PRECISION)}")
    return CANDIDATE_PRECISION[candidate_dtype]


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


def _ray_cluster_window(cs, o, d, t_min, t_max):
    """Dense (R,C) slab test of rays (R,3) within [t_min, t_max] (R,)
    against the clusters' boxes: (hit (R,C), t_near (R,C), inf where not
    hit). Memory is (R,C,3) float32 per intermediate."""
    eps = 1e-20
    inv = 1.0 / torch.where(d.abs() > eps, d,
                            torch.where(d >= 0, eps, -eps))
    t0 = (cs.aabb_lo[None] - o[:, None]) * inv[:, None]
    t1 = (cs.aabb_hi[None] - o[:, None]) * inv[:, None]
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    hit = (tn <= tf) & (tf >= t_min[:, None]) & (tn <= t_max[:, None])
    # + 0.0 turns -0.0 into +0.0, as jnp.maximum(tn, 0.0) gives
    return hit, torch.where(hit, tn.clamp_min(0.0) + 0.0, torch.inf)


def _dense_visits(cs, o, d, tn, tx, tiles: int, mv: int):
    """Exact per-ray culling: each tile admits the clusters any of its rays
    enters (`_ray_cluster_window`), ordered by the nearest entry of its
    rays (stable: ties keep cluster-id order, as `jnp.argsort`), the first
    mv kept. Chunks of tiles bound the (rays, C, 3) intermediates to
    DENSE_PAIRS (ray, cluster) pairs. Returns what `_frustum_visits`
    returns."""
    c = cs.num_clusters
    hit_tc = torch.empty((tiles, c), dtype=torch.bool, device=o.device)
    tnear_tc = torch.empty((tiles, c), dtype=torch.float32, device=o.device)
    step = max(1, DENSE_PAIRS // (RAY_TILE * c))
    for a in range(0, tiles, step):
        b = min(a + step, tiles)
        rays = slice(a * RAY_TILE, b * RAY_TILE)
        hit, tnear = _ray_cluster_window(cs, o[rays], d[rays], tn[rays],
                                         tx[rays])
        hit_tc[a:b] = hit.view(b - a, RAY_TILE, c).any(1)
        tnear_tc[a:b] = tnear.view(b - a, RAY_TILE, c).amin(1)
    srt, idx = torch.sort(tnear_tc, dim=1, stable=True)
    order = idx[:, :mv]
    overflow = (hit_tc.sum(1) > mv).any()
    return order.to(torch.int32), hit_tc.gather(1, order), srt[:, :mv], \
        overflow


def pad_rays(origins, dirs, t_min, t_max, group: int):
    """Per-ray windows from scalars or (R,) tensors, and the rays padded to a
    multiple of `group`: (o, d, tn, tx). Padded rays are dead (tx < tn)."""
    r = origins.shape[0]
    dev = origins.device
    t_min_b = vm.per_ray(t_min, r, dev)
    t_max_b = vm.per_ray(t_max, r, dev)
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
    `walk`), "dense" (`_dense_visits`), or "auto" (the frustum up to
    MAX_FRUSTUM_CLUSTERS clusters or units, the tree past that, as the JAX
    package's Pallas path chooses). Returns what `_frustum_visits`
    returns."""
    if culling == "auto":
        culling = ("frustum" if acc.num_clusters <= MAX_FRUSTUM_CLUSTERS
                   else "tree")
    if culling == "frustum":
        return _frustum_visits(acc, o, d, tn, tx, tiles, mv)
    if culling == "tree":
        return _tile_tree_visits(acc, o, d, tn, tx, tiles, mv, walk)
    if culling == "dense":
        return _dense_visits(acc, o, d, tn, tx, tiles, mv)
    raise ValueError(f"culling {culling!r} not in ('auto', 'frustum', "
                     "'tree', 'dense')")


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


def exact_winners(feats, k: int, cluster, slot, origins, dirs, found):
    """The exact decode of closest hits: winner i's coefficient columns
    (cluster[i], slot[i]) of `feats (C,10,4K)` times ray i's features,
    a chain of float32 fused multiply-adds over the ten features in order
    (as XLA's dot runs the JAX decode at HIGHEST; no matmul, so no TF32).
    The chain is what keeps u and v within 1e-6 of JAX's: a plain float32
    product summed over the features misses that by up to 4.5e-6 on
    `tests/test_torch_options.py::test_exact_decode_matches_jax`, where
    the bilinear form cancels. Returns {"t", "u", "v"} (inf, 0, 0 where not found) and found &
    |det| > 1e-12."""
    c = feats.shape[0]
    cols = feats.reshape(c, 10, 4, k)[cluster, :, :, slot]      # (r,10,4)
    rf = ray_features(origins, dirs)
    res4 = torch.zeros_like(cols[:, 0])
    for f in range(10):
        res4 = vm.fma(rf[:, f, None], cols[:, f], res4)
    det = res4[:, 0]
    okd = det.abs() > 1e-12
    inv = torch.where(okd, 1.0 / torch.where(okd, det, 1.0), 0.0)
    found = found & okd
    return {"t": torch.where(found, res4[:, 3] * inv, torch.inf),
            "u": torch.where(found, res4[:, 1] * inv, 0.0),
            "v": torch.where(found, res4[:, 2] * inv, 0.0)}, found


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
           culling: str = "auto", walk: Callable = tw.tile_tree_visits,
           candidate_dtype: str = "float32", decode: bool = True
           ) -> Dict[str, torch.Tensor]:
    precision = candidate_precision(candidate_dtype)
    with profiling.span("accel.cull"):
        q = scan_inputs(cs, origins, dirs, t_min, t_max, max_visits,
                        culling, walk)
    # the ClusterSet carries the fp32 layout and keeps the bf16 one
    layout = (q["layout"] if precision == "highest"
              else mma_kernel_layout(cs))
    with profiling.span("accel.k1"):
        counter = {}
        if scan is vs.visit_scan and profiling.is_recording():
            # the frame's own launches count their visits while recording
            counter["visits"] = torch.empty(q["args"][0].shape[0],
                                            dtype=torch.int32,
                                            device=origins.device)
        out = scan(*q["args"], **q["kw"], closest=closest, layout=layout,
                   precision=precision, **counter)
        if counter:
            profiling.count_visits(counter["visits"], q["args"][3])
    with profiling.span("accel.decode"):
        if not closest:
            return {"occluded": (out.reshape(-1)[:q["r"]] > 0) & q["live"],
                    "overflow": q["overflow"]}
        found, cluster, slot, t = decode_winners(out, q)
        if not decode:
            return {"t": t,
                    "tri": torch.where(found, cs.tri_id[cluster, slot], -1),
                    "overflow": q["overflow"]}
        exact, found = exact_winners(cs.tri_feat, cs.tris_per_cluster,
                                     cluster.clamp_min(0), slot, origins,
                                     dirs, found)
        return {**exact,
                "tri": torch.where(found, cs.tri_id[cluster, slot], -1),
                "overflow": q["overflow"]}


def intersect_closest(cs: ClusterSet, origins, dirs, t_min, t_max,
                      max_visits: int = 12, scan: Callable = vs.visit_scan,
                      culling: str = "auto",
                      walk: Callable = tw.tile_tree_visits,
                      candidate_dtype: str = "float32", decode: bool = True):
    """Closest hits: {"t", "tri" (-1 = miss), "overflow"}, and with decode
    the exact t and the barycentrics "u", "v"; without it t is the key's
    quantized distance."""
    return _query(cs, origins, dirs, t_min, t_max, max_visits, True, scan,
                  culling, walk, candidate_dtype, decode)


def intersect_any(cs: ClusterSet, origins, dirs, t_min, t_max,
                  max_visits: int = 12, scan: Callable = vs.visit_scan,
                  culling: str = "auto",
                  walk: Callable = tw.tile_tree_visits,
                  candidate_dtype: str = "float32"):
    """Occlusion mask (R,) bool."""
    return _query(cs, origins, dirs, t_min, t_max, max_visits, False,
                  scan, culling, walk, candidate_dtype)["occluded"]


def tiled_intersectors(cs: ClusterSet, max_visits: int = 12,
                       scan: Callable = vs.visit_scan,
                       culling: str = "auto",
                       walk: Callable = tw.tile_tree_visits,
                       candidate_dtype: str = "float32",
                       decode: bool = True) -> Tuple:
    """Bind a ClusterSet into (intersect_fn, occlude_fn) for the wavefront
    loop. `scan` is the visit scan and `walk` the tree walk: the kernel
    wrappers, or their plain twins (`visit_scan_ref`,
    `tile_tree_visits_ref`) to compare the two on one device. `culling`:
    see `cull_tiles`; `candidate_dtype`: see `candidate_precision`;
    `decode`: see `intersect_closest`."""
    candidate_precision(candidate_dtype)

    def isect(o, d, tn, tx):
        return intersect_closest(cs, o, d, tn, tx, max_visits, scan, culling,
                                 walk, candidate_dtype, decode)

    def occl(o, d, tn, tx):
        return intersect_any(cs, o, d, tn, tx, max_visits, scan, culling,
                             walk, candidate_dtype)

    return isect, occl
