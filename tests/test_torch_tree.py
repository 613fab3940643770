"""PyTorch port, the cluster tree and tree culling, against the JAX package.

- Cluster and unit trees from the same boxes: exactly equal (the same
  numpy SAH builder over the same float64 / float32 boxes).
- The tree walk (`tiled._tile_tree_visits`, kernel W's plain twin) against
  JAX `_tile_tree_visits` on the same tables: visit lists, valid masks and
  overflow equal on every tile, overflowing ones included; entry t within
  rtol 1e-6.
- Tree-culled queries against JAX's Pallas path in interpret mode: the same
  triangle or a key tie, occlusion equal; against `brute` on the tiles that
  do not overflow (ROADMAP C-12: an overflowing tile keeps the first mv
  leaves it popped): the same triangle on 99% of hits, t within the packed
  key's resolution, occlusion equal.
- `mega_scene`: geometry, materials, lights and camera equal to JAX's.
- Refits: the conservative tree (every node the global bounds), as JAX's.

tests/test_torch_tree_scenes.py and test_torch_tree_frame.py hold the
two-level and frame tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import (coherent_rays, n, port_clusters,
                                 port_instanced, rng, t, to_numpy_tree)

from lumenrenderer_tpu.accel import brute, stream as jstream
from lumenrenderer_tpu.accel import tiled as jtiled, two_level as jtwo
from lumenrenderer_tpu.scene import presets as jpresets
from lumenrenderer_tpu_torch.accel import stream as pstream
from lumenrenderer_tpu_torch.accel import tiled as ptiled, two_level as ptwo
from lumenrenderer_tpu_torch.ops import tree_walk as ptw
from lumenrenderer_tpu_torch.scene import presets

TREE = ("tree_lo", "tree_hi", "tree_child0", "tree_child1",
        "tree_leaf_cluster")


def random_tris(g, count, spread=3.0):
    c = g.uniform(-spread, spread, size=(count, 1, 3))
    d = g.normal(size=(count, 3, 3)) * 0.15
    return (c + d).astype(np.float32)


def _windows(g, r, any_mode):
    tn = np.full(r, 1e-4, np.float32)
    tx = (g.uniform(0.3, 2.0, r) if any_mode else np.full(r, 1e9)).astype(
        np.float32)
    tx[::7] = -1.0
    tx[128 * 3:128 * 4] = -1.0          # a tile with every lane dead
    return tn, tx


def _same_bits(a, b):
    """float32 tensors equal bit for bit (ids bit-cast into node records
    can be NaN patterns)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _jax_clusters(seed=0, count=3000, k=16):
    return jstream.build_clusters(jnp.asarray(random_tris(rng(seed), count)),
                                  cluster_size=k)


def test_cluster_tree_matches_jax():
    g = rng(0)
    tris = random_tris(g, 3000)
    cs = jstream.build_clusters(jnp.asarray(tris), cluster_size=16)
    own = pstream.clusters_from_order(tris, np.asarray(cs.tri_id))
    for got in (own, port_clusters(cs)):
        for f in TREE:
            np.testing.assert_array_equal(n(getattr(got, f)),
                                          np.asarray(getattr(cs, f)),
                                          err_msg=f)
        assert got.tree_depth == cs.tree_depth > 5
        slabs, nlive = got.slabs, got.nlive
        np.testing.assert_array_equal(
            n(slabs), np.asarray(cs.tri_feat).reshape(-1, 10, 4, 16)
            .transpose(0, 3, 1, 2))
        assert nlive.dtype == torch.int32 and int(nlive.max()) <= 16
    # an empty cluster's +-1e30 box enters the tree as the zero box
    lo = np.array([[0, 0, 0], [1e30, 1e30, 1e30]], np.float64)
    hi = np.array([[1, 1, 1], [-1e30, -1e30, -1e30]], np.float64)
    tree = pstream.box_tree(lo, hi)
    np.testing.assert_array_equal(n(tree["tree_lo"])[0], [0, 0, 0])
    np.testing.assert_array_equal(n(tree["tree_hi"])[0], [1, 1, 1])


@pytest.mark.parametrize("mode,mv,refit", [
    ("closest", None, False), ("any", None, False), ("closest", 4, False),
    ("closest", 4, True), ("closest", 48, True)])
def test_tree_walk_matches_jax(mode, mv, refit):
    """On a refit tree every node is the global box, so every live tile
    admits every cluster up to the cap, with entry t tied throughout."""
    g = rng(1)
    tris = random_tris(rng(0), 3000)
    cs = jstream.build_clusters(jnp.asarray(tris), cluster_size=16)
    pcs = port_clusters(cs)
    if refit:
        moved = tris + np.float32(0.1) * g.normal(size=tris.shape).astype(
            np.float32)
        cs = jstream.refit_clusters(cs, jnp.asarray(moved))
        pcs = pstream.refit_clusters(pcs, t(moved))
        np.testing.assert_array_equal(n(pcs.tree_lo), np.asarray(cs.tree_lo))
        assert (n(pcs.tree_lo) == n(pcs.tree_lo)[0]).all()
    tiles = 32
    o, d = coherent_rays(g, tiles)
    tn, tx = _windows(g, tiles * 128, mode == "any")
    mv = mv or cs.num_clusters
    ref = jtiled._tile_tree_visits(cs, *map(jnp.asarray, (o, d, tn, tx)),
                                   tiles, mv)
    got = ptiled._tile_tree_visits(pcs, t(o), t(d), t(tn), t(tx), tiles, mv)
    for name, a, b in zip(("order", "valid", "tnear", "overflow"), got, ref):
        if name == "tnear":
            np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-6)
        else:
            np.testing.assert_array_equal(n(a), np.asarray(b), err_msg=name)
    counts = np.asarray(ref[1]).sum(1)
    assert counts[3] == 0 and counts.max() > 3
    assert bool(ref[3]) == (mv < cs.num_clusters)
    if refit:       # every tile whose rays meet the global box is full
        assert (counts == mv).mean() > 0.5
        assert (np.asarray(ref[2])[np.asarray(ref[1])] == 0).any()
    elif mv != 4:   # the walk admits fewer clusters than every one
        assert 0 < counts.mean() < 0.5 * cs.num_clusters


def _serial_walk(cs, tile, mv):
    """The serial walk of one tile in plain Python, stopped at mv + 1
    leaves: ([(cluster, entry t)], nodes popped)."""
    test = lambda node: ptw.box_test(cs.tree_lo[node:node + 1],
                                     cs.tree_hi[node:node + 1], *tile)
    hit, tn0 = test(0)
    stack, leaves, n_pops = [(0, float(tn0))] if bool(hit) else [], [], 0
    while stack and len(leaves) <= mv:
        node, node_tn = stack.pop()
        n_pops += 1
        c0, c1 = int(cs.tree_child0[node]), int(cs.tree_child1[node])
        if c0 < 0:
            leaves.append((int(cs.tree_leaf_cluster[-c0 - 1]), node_tn))
            continue
        (h0, t0), (h1, t1) = test(c0), test(c1)
        near, far = ((c1, t1, h1), (c0, t0, h0)) if t1 < t0 else (
            (c0, t0, h0), (c1, t1, h1))
        stack += [(c, float(tc)) for c, tc, h in (far, near) if bool(h)]
    return leaves, n_pops


def _tile_args(bounds, i):
    """box_test's tile arguments for tile i of `bounds`."""
    inv_a, inv_b, zero = ptw._reciprocals(bounds[2][i:i + 1],
                                          bounds[3][i:i + 1])
    return (bounds[0][i:i + 1], bounds[1][i:i + 1], inv_a, inv_b, zero,
            bounds[4][i:i + 1])


@pytest.mark.parametrize("small_mv", [False, True])
def test_tree_walk_twin_pops_and_raw_lists(small_mv):
    """The wrapper on CPU tensors runs the twin uncounted; its pop counter
    counts every node popped, leaves included, and it stops at mv + 1
    leaves, as a plain-Python walk does."""
    g = rng(2)
    cs = port_clusters(_jax_clusters(seed=2))
    o, d = coherent_rays(g, 8)
    tn, tx = _windows(g, 8 * 128, False)
    bounds = ptiled._tile_bounds(t(o), t(d), t(tn), t(tx), 8, 128)
    tree = (cs.tree_lo, cs.tree_hi, cs.tree_child0, cs.tree_child1,
            cs.tree_leaf_cluster)
    mv = 4 if small_mv else cs.num_clusters
    pops = torch.full((8,), -1, dtype=torch.int32)
    ptw.reset_launches()
    visits, vtn, count = ptw.tile_tree_visits(
        *bounds, *tree, tree_depth=cs.tree_depth, mv=mv, nodes=cs.tree_nodes,
        pops=pops)
    assert ptw.LAUNCHES == {"walk": 0}
    assert int(count[3]) == 0 and int(pops[3]) == 0
    assert int(count.max()) <= mv + 1
    # each live tile walked node by node in plain Python
    for i in (i for i in range(8) if i != 3):
        leaves, n_pops = _serial_walk(cs, _tile_args(bounds, i), mv)
        k = min(len(leaves), mv)
        assert int(pops[i]) == n_pops and int(count[i]) == len(leaves)
        assert n(visits[i, :k]).tolist() == [c for c, _ in leaves[:k]]
        assert n(vtn[i, :k]).tolist() == [v for _, v in leaves[:k]]
    assert int(count.max()) == (mv + 1 if small_mv else int(count.max()))
    assert int(count.max()) > (4 if small_mv else 10)
    live = torch.arange(mv)[None] < count[:, None]
    assert bool(torch.isfinite(vtn[live]).all()) and bool(
        (vtn[~live] == torch.inf).all())
    assert bool((vtn >= 0).all()) and not bool(torch.signbit(vtn).any())
    with pytest.raises(ValueError):
        ptw.tile_tree_visits(bounds[0].double(), *bounds[1:], *tree,
                             tree_depth=cs.tree_depth, mv=4,
                             nodes=cs.tree_nodes)


def _warp_walk(cs, recs, tile, alive, mv):
    """Kernel W (csrc/tree_walk.cu, tree_walk_warp) in
    plain Python for one tile: its stack in path order (top last), the
    leaves on top listed first, then up to WARP entries a step, a node's
    children from its record written back near before far. Returns
    ([(cluster, entry t)], the stack's largest size)."""
    hit, tn = ptw.box_test(cs.tree_lo[:1], cs.tree_hi[:1], *tile)
    c0 = int(cs.tree_child0[0])
    root = -int(cs.tree_leaf_cluster[-c0 - 1]) - 1 if c0 < 0 else 0
    stack = [(root, float(tn))] if bool(hit) and alive else []
    ids = recs[:, 12:14].contiguous().view(torch.int32)
    leaves, largest = [], len(stack)
    while stack and len(leaves) <= mv:
        top = stack[-ptw.WARP:][::-1]                # path order
        lead = next((j for j, e in enumerate(top) if e[0] >= 0), len(top))
        if lead:
            leaves += top[:min(lead, mv + 1 - len(leaves))]
            del stack[len(stack) - lead:]
            continue
        nodes = torch.tensor([e[0] for e in top if e[0] >= 0])
        r = recs[nodes]
        h0, t0 = ptw.box_test(r[:, 0:3], r[:, 3:6], *tile)
        h1, t1 = ptw.box_test(r[:, 6:9], r[:, 9:12], *tile)
        out, j = [], 0
        for e in top:
            if e[0] < 0:
                out.append(e)
                continue
            kids = [(int(ids[e[0], 0]), float(t0[j]), bool(h0[j])),
                    (int(ids[e[0], 1]), float(t1[j]), bool(h1[j]))]
            if t1[j] < t0[j]:
                kids.reverse()
            out += [(c, tc) for c, tc, h in kids if h]   # near, then far
            j += 1
        stack[len(stack) - len(top):] = out[::-1]
        largest = max(largest, len(stack))
    return [(-c - 1, tc) for c, tc in leaves], largest


@pytest.mark.parametrize("mv", [1, 4, 48])
@pytest.mark.parametrize("refit", [False, True])
def test_tree_walk_warp_order_equals_the_serial_walk(mv, refit):
    """Kernel W's path-ordered stack lists the twin's leaves, entry t
    bits and counts on every tile, ties at t = 0 included (origins inside
    boxes; on a refit tree every node ties), and never holds more entries
    than `stack_entries` allots;
    `node_records` carries the tree's own floats and each child's id."""
    g = rng(8)
    tris = random_tris(g, 3000)
    cs = pstream.build_clusters(torch.from_numpy(tris), cluster_size=16)
    if refit:
        cs = pstream.refit_clusters(cs, t(tris) + 0.05)
    tiles = 24
    o, d = coherent_rays(g, tiles)
    tn, tx = _windows(g, tiles * 128, False)
    bounds = ptiled._tile_bounds(t(o), t(d), t(tn), t(tx), tiles, 128)
    tree = (cs.tree_lo, cs.tree_hi, cs.tree_child0, cs.tree_child1,
            cs.tree_leaf_cluster)
    recs = cs.tree_nodes
    assert _same_bits(recs, ptw.node_records(*tree))
    inner = (cs.tree_child0 >= 0).nonzero()[:, 0]
    kids = cs.tree_child0[inner].long(), cs.tree_child1[inner].long()
    for k, (c, lo) in enumerate(zip(kids, (0, 6))):
        assert torch.equal(recs[inner, lo:lo + 3], cs.tree_lo[c])
        assert torch.equal(recs[inner, lo + 3:lo + 6], cs.tree_hi[c])
        ref = recs[inner, 12 + k].contiguous().view(torch.int32).long()
        leaf = cs.tree_child0[c] < 0
        assert torch.equal(ref[~leaf], c[~leaf])
        assert torch.equal(-ref[leaf] - 1, cs.tree_leaf_cluster[
            -cs.tree_child0[c[leaf]].long() - 1].long())
    visits, vtn, count = ptw.tile_tree_visits_ref(
        *bounds, *tree, tree_depth=cs.tree_depth, mv=mv)
    cap, largest, zeros = ptw.stack_entries(cs.tree_depth), 0, 0
    for i in range(tiles):
        leaves, big = _warp_walk(cs, recs, _tile_args(bounds, i),
                                 bool(bounds[5][i]), mv)
        largest = max(largest, big)
        k = min(len(leaves), mv)
        assert len(leaves) == int(count[i]), i
        assert [c for c, _ in leaves[:k]] == n(visits[i, :k]).tolist(), i
        got = torch.tensor([v for _, v in leaves[:k]], dtype=torch.float32)
        assert torch.equal(got.view(torch.int32),
                           vtn[i, :k].view(torch.int32)), i
        zeros += int((got == 0).sum())
    assert 1 < largest <= cap and zeros > 0
    assert int(count.max()) == mv + 1 and int(count[3]) == 0


def _walk_counts(acc, o, d, tn, tx, mv):
    """Leaves each tile's walk reaches, up to mv + 1 (count <= mv: the tile
    does not overflow)."""
    tiles = -(-o.shape[0] // 128)
    po, pd, ptn, ptx = ptiled.pad_rays(t(o), t(d), t(tn), t(tx), 128)
    bounds = ptiled._tile_bounds(po, pd, ptn, ptx, tiles, 128)
    return n(ptw.tile_tree_visits(
        *bounds, acc.tree_lo, acc.tree_hi, acc.tree_child0, acc.tree_child1,
        acc.tree_leaf_cluster, tree_depth=acc.tree_depth, mv=mv,
        nodes=acc.tree_nodes)[2])


def test_tree_queries_match_pallas_and_brute():
    g = rng(3)
    tris = random_tris(g, 1500)
    cs = jstream.build_clusters(jnp.asarray(tris), cluster_size=32)
    pcs = port_clusters(cs)
    o, d = coherent_rays(g, 8)
    r = o.shape[0]
    mv = 48
    kw = dict(max_visits=mv, culling="tree")
    got = ptiled.intersect_closest(pcs, t(o), t(d), 1e-4, 1e9, **kw)
    ref = jtiled.intersect_closest(cs, o, d, 1e-4, 1e9, use_pallas=True,
                                   candidate_dtype="float32", **kw)
    occ = n(ptiled.intersect_any(pcs, t(o), t(d), 1e-4, 2.0, **kw))
    occ_j = np.asarray(jtiled.intersect_any(cs, o, d, 1e-4, 2.0,
                                            use_pallas=True,
                                            candidate_dtype="float32", **kw))
    assert bool(got["overflow"]) == bool(ref["overflow"])
    _, _, low_bits = ptiled.key_bits(32, mv)
    res_t = 2.0 ** -(23 - low_bits)
    tri, t_p = n(got["tri"]), n(got["t"])
    tri_j, t_j = np.asarray(ref["tri"]), np.asarray(ref["t"])
    np.testing.assert_array_equal(tri >= 0, tri_j >= 0)
    hit = tri >= 0
    tie = np.abs(t_p - t_j) <= 2 * res_t * np.abs(t_j)
    assert ((tri == tri_j) | tie | ~hit).all()
    np.testing.assert_array_equal(occ, occ_j)
    # brute on the tiles whose walk stays within mv
    ok = np.repeat(_walk_counts(pcs, o, d, np.full(r, 1e-4, np.float32),
                                np.full(r, 1e9, np.float32), mv) <= mv,
                   128)[:r]
    assert 0.25 < ok.mean() < 1.0       # some tiles overflow, most do not
    rb = brute.intersect_closest(jnp.asarray(tris), o, d, 1e-4, 1e9)
    tri_b, t_b = np.asarray(rb["tri"]), np.asarray(rb["t"])
    np.testing.assert_array_equal(hit[ok], tri_b[ok] >= 0)
    hb = ok & (tri_b >= 0)
    assert (np.abs(t_p[hb] - t_b[hb]) / t_b[hb]).max() <= 2 * res_t
    assert (tri[hb] == tri_b[hb]).mean() > 0.99 and hb.sum() > 200
    ok_a = np.repeat(_walk_counts(pcs, o, d, np.full(r, 1e-4, np.float32),
                                  np.full(r, 2.0, np.float32), mv) <= mv,
                     128)[:r]
    occ_b = np.asarray(brute.intersect_any(jnp.asarray(tris), o, d, 1e-4,
                                           2.0))
    np.testing.assert_array_equal(occ[ok_a], occ_b[ok_a])


def test_auto_culling_picks_the_tree_past_2048_clusters(monkeypatch):
    g = rng(4)
    tris = random_tris(g, 18000, spread=6.0)
    big = pstream.build_clusters(torch.from_numpy(tris), cluster_size=8)
    small = pstream.build_clusters(torch.from_numpy(tris[:2000]),
                                   cluster_size=8)
    assert big.num_clusters > ptiled.MAX_FRUSTUM_CLUSTERS
    assert small.num_clusters <= ptiled.MAX_FRUSTUM_CLUSTERS
    # two tiles of rays from outside the field, each a narrow cone at it
    o = np.repeat([[0, 0, 20], [20, 1, 0]], 128, 0).astype(np.float32)
    aim = np.repeat(g.uniform(-3, 3, (2, 3)), 128, 0) - o
    d = aim / np.linalg.norm(aim, axis=1, keepdims=True) + g.normal(
        size=o.shape) * 0.01
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    r = o.shape[0]
    calls = []
    for name in ("_frustum_visits", "_tile_tree_visits"):
        fn = getattr(ptiled, name)
        monkeypatch.setattr(ptiled, name, lambda *a, _fn=fn, _n=name:
                            calls.append(_n) or _fn(*a))
    got = ptiled.intersect_closest(big, t(o), t(d), 1e-4, 1e9,
                                   max_visits=128)
    assert calls == ["_tile_tree_visits"]
    ptiled.intersect_closest(small, t(o), t(d), 1e-4, 1e9, max_visits=128)
    assert calls[1:] == ["_frustum_visits"]
    ok = np.repeat(_walk_counts(big, o, d, np.full(r, 1e-4, np.float32),
                                np.full(r, 1e9, np.float32), 128) <= 128,
                   128)
    rb = brute.intersect_closest(jnp.asarray(tris), o, d, 1e-4, 1e9)
    tri, tri_b = n(got["tri"]), np.asarray(rb["tri"])
    assert (tri_b[ok] >= 0).sum() > 50
    np.testing.assert_array_equal(tri[ok] >= 0, tri_b[ok] >= 0)
    assert ((tri == tri_b) | (tri_b < 0))[ok].mean() > 0.99


def test_mega_scene_matches_jax():
    jb, jcamf = jpresets.mega_scene(n_tris=24_000, n_lights=8)
    pb, pcamf = presets.mega_scene(n_tris=24_000, n_lights=8)
    jsc, psc = jb.build(), pb.build()
    assert psc.num_triangles == 24_018
    for f in ("tri_pos", "tri_normal", "tri_uv", "tri_mat", "tri_inst",
              "inst_emission_mode"):
        np.testing.assert_array_equal(n(getattr(psc, f)),
                                      np.asarray(getattr(jsc, f)), err_msg=f)
    np.testing.assert_array_equal(n(psc.lights.packed),
                                  np.asarray(jsc.lights.packed))
    assert int(psc.lights.count) == int(jsc.lights.count) == 16
    jm, pm = to_numpy_tree(jsc.materials), to_numpy_tree(psc.materials)
    for f, a in pm.items():
        np.testing.assert_array_equal(n(a), jm[f], err_msg=f)
    jc, pc = to_numpy_tree(jcamf(16 / 9)), to_numpy_tree(pcamf(16 / 9))
    for f, a in pc.items():
        np.testing.assert_allclose(n(a), jc[f], rtol=1e-6, err_msg=f)


def test_refits_give_the_conservative_tree():
    g = rng(5)
    tris = random_tris(g, 1500)
    cs = jstream.build_clusters(jnp.asarray(tris), cluster_size=32)
    moved = tris + np.float32(0.25) * g.normal(size=(1500, 1, 3)).astype(
        np.float32)
    ref = jstream.refit_clusters(cs, jnp.asarray(moved))
    got = pstream.refit_clusters(port_clusters(cs), t(moved))
    for f in TREE + ("aabb_lo", "aabb_hi"):
        np.testing.assert_allclose(n(getattr(got, f)),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   err_msg=f)
    np.testing.assert_array_equal(
        n(got.tree_lo), np.broadcast_to(n(got.aabb_lo).min(0),
                                        got.tree_lo.shape))
    np.testing.assert_array_equal(n(got.slabs), n(pstream.kernel_layout(
        got.tri_feat)["slabs"]))
    # still sound: every tile admits clusters up to the cap, and the tiles
    # that do not overflow agree with brute on the moved triangles
    o, d = coherent_rays(g, 4, cone=0.05)
    res = ptiled.intersect_closest(got, t(o), t(d), 1e-4, 1e9,
                                   max_visits=128, culling="tree")
    ok = np.repeat(_walk_counts(got, o, d, np.full(512, 1e-4, np.float32),
                                np.full(512, 1e9, np.float32), 128) <= 128,
                   128)
    rb = brute.intersect_closest(jnp.asarray(moved), o, d, 1e-4, 1e9)
    assert ok.all() == (got.num_clusters <= 128)
    tri = n(res["tri"])
    np.testing.assert_array_equal(tri[ok] >= 0, np.asarray(rb["tri"])[ok]
                                  >= 0)
    # the unit tree of a two-level refit
    meshes = [g.uniform(-0.5, 0.5, (30, 3, 3)).astype(np.float32)]
    tfs = [np.eye(4, dtype=np.float32) for _ in range(6)]
    for i, m in enumerate(tfs):
        m[:3, 3] = [i, 0.5 * i, 0]
    jics = jtwo.build_instanced(meshes, [0] * 6, tfs, cluster_size=32)
    tfs2 = np.stack(tfs)
    tfs2[2, :3, 3] += [0.7, -0.3, 0.2]
    ref_i = jtwo.refit_instances(jics, jnp.asarray(tfs2))
    got_i = ptwo.refit_instances(port_instanced(jics), torch.from_numpy(tfs2))
    for f in TREE:
        np.testing.assert_allclose(n(getattr(got_i, f)),
                                   np.asarray(getattr(ref_i, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    own = ptwo.build_instanced(meshes, [0] * 6, tfs, cluster_size=32)
    for f in TREE:
        np.testing.assert_array_equal(n(getattr(own, f)),
                                      np.asarray(getattr(jics, f)),
                                      err_msg=f)


def test_kernel_layout_rides_the_cluster_set():
    """build, refit and convert carry the table in the kernels' order and
    the tree as kernel W's node records; the wrappers check a given
    layout's shapes and, on the CPU, give the twin's result with or without
    it."""
    from lumenrenderer_tpu_torch.ops import visit_scan as pvs

    g = rng(7)
    tris = random_tris(g, 600)
    cs = pstream.build_clusters(torch.from_numpy(tris), cluster_size=32)
    slabs, nlive = pvs.slab_layout(cs.tri_feat, 32)
    assert torch.equal(cs.slabs, slabs) and torch.equal(cs.nlive, nlive)
    o, d = coherent_rays(g, 2)
    q = ptiled.scan_inputs(cs, t(o), t(d), 1e-4, 1e9, 64)
    assert q["layout"][0] is cs.slabs
    kw = dict(q["kw"], closest=True)
    out = pvs.visit_scan(*q["args"], **kw, layout=q["layout"])
    assert torch.equal(out, pvs.visit_scan(*q["args"], **kw))
    with pytest.raises(ValueError):
        pvs.visit_scan(*q["args"], **kw, layout=(slabs[:, :16], nlive))
    with pytest.raises(ValueError):
        pvs.visit_scan(*q["args"], **kw, layout=(slabs, nlive.long()))
    moved = pstream.refit_clusters(cs, t(tris) + 0.5)
    assert torch.equal(moved.slabs,
                       pvs.slab_layout(moved.tri_feat, 32)[0])
    records = lambda s: ptw.node_records(*(getattr(s, f) for f in TREE))
    jcs = _jax_clusters(seed=7, count=600, k=32)
    for s in (cs, moved, port_clusters(jcs),
              port_clusters(jstream.refit_clusters(jcs, jnp.asarray(tris)))):
        assert _same_bits(s.tree_nodes, records(s))
    assert bool((moved.tree_nodes[:, :6] == torch.cat(
        [moved.tree_lo[0], moved.tree_hi[0]])).all())
    meshes = [g.uniform(-0.5, 0.5, (30, 3, 3)).astype(np.float32)]
    tfs = np.stack([np.eye(4, dtype=np.float32)] * 3)
    tfs[:, 0, 3] = [0, 1, 2]
    ics = ptwo.build_instanced(meshes, [0] * 3, list(tfs), cluster_size=32)
    tfs[1, 1, 3] = 0.5
    for s in (ics, ptwo.refit_instances(ics, torch.from_numpy(tfs)),
              port_instanced(jtwo.build_instanced(meshes, [0] * 3, list(tfs),
                                                  cluster_size=32))):
        assert _same_bits(s.tree_nodes, records(s))
    with pytest.raises(ValueError):
        ptw.tile_tree_visits(*ptiled._tile_bounds(t(o), t(d), *(torch.full(
            (o.shape[0],), v) for v in (1e-4, 1e9)), 2, 128),
            *(getattr(cs, f) for f in TREE), tree_depth=cs.tree_depth, mv=4,
            nodes=cs.tree_nodes[:, :12])
