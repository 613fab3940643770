"""PyTorch port, the options of the JAX package's ported modules, against it.

- Dense culling: `_ray_cluster_window` hits exactly equal, t_near within
  1e-6; each tile's dense visit list (JAX's `_query` lines for
  culling="dense") exactly equal; the intersector with culling="dense"
  against JAX's Pallas path in interpret mode on the cases of
  tests/test_tiled.py's capped parity test: the same triangle or a tie
  within the packed key's t resolution on every ray, occlusion equal.
- The exact decode (decode=True, the default): t, u and v within 1e-6 of
  JAX's decode=True and the triangle bit for bit, misses included; the
  decode of a winner whose exact det is at most 1e-12 (a ray in the
  triangle's plane) is a miss on both sides.
- Swizzle: `block_swizzle_map` exactly equal for a frame the 16x8 blocks
  tile and one they do not; a swizzled 32x16 frame against JAX's swizzled
  frame with the same uniforms, at the frame tests' tolerances.
- Blocked sort: `_block_partition_order` and `_radix_block_order`
  permutations exactly equal; `blocked_sorted_intersectors` hands the
  query the same rays in the same order as JAX's and gives the triangles
  and occlusion of `sorted_intersectors` (ties within the key's t
  resolution).
- Two-level and pairs: culling="dense" walks the tree, as JAX does.
- Helpers (bsdf, vecmath, sampling) within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import (ListUniforms, jax_frame_uniforms, n,
                                 port_camera, port_clusters, port_scene, rng,
                                 t)

from lumenrenderer_tpu.accel import sorting as jsorting
from lumenrenderer_tpu.accel import stream as jstream, tiled as jtiled
from lumenrenderer_tpu.bsdf import common as jcommon
from lumenrenderer_tpu.core import camera as jcamera
from lumenrenderer_tpu.core import sampling as jsampling
from lumenrenderer_tpu.core import vecmath as jvm
from lumenrenderer_tpu.integrator import wavefront as jwf
from lumenrenderer_tpu.scene import presets as jpresets
from lumenrenderer_tpu_torch.accel import pairs as ppairs
from lumenrenderer_tpu_torch.accel import sorting as psorting
from lumenrenderer_tpu_torch.accel import stream as pstream
from lumenrenderer_tpu_torch.accel import tiled as ptiled
from lumenrenderer_tpu_torch.accel import two_level as ptwo
from lumenrenderer_tpu_torch.bsdf import common as pcommon
from lumenrenderer_tpu_torch.core import camera as pcamera
from lumenrenderer_tpu_torch.core import sampling as psampling
from lumenrenderer_tpu_torch.core import vecmath as pvm
from lumenrenderer_tpu_torch.integrator import wavefront as pwf
from lumenrenderer_tpu_torch.scene import presets

TOL = 1e-6


def random_tris(g, count, spread=2.0):
    c = g.uniform(-spread, spread, size=(count, 1, 3))
    d = g.normal(size=(count, 3, 3)) * 0.15
    return (c + d).astype(np.float32)


def random_rays(g, count, spread=3.0):
    o = g.uniform(-spread, spread, size=(count, 3)).astype(np.float32)
    d = g.normal(size=(count, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def aimed_rays(g, tris, count, spread=4.0):
    """Rays from random origins aimed near random triangles' centroids."""
    o = g.uniform(-spread, spread, size=(count, 3)).astype(np.float32)
    aim = tris[g.integers(0, len(tris), count)].mean(1)
    d = aim + g.normal(size=(count, 3)) * 0.1 - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def _tie_or_same(tri_p, t_p, tri_j, t_j, low_bits):
    """Every ray: the same triangle (misses included), or both hit within
    the packed key's t resolution of each other."""
    same = tri_p == tri_j
    both = (tri_p >= 0) & (tri_j >= 0)
    res = 2.0 ** -(23 - low_bits)
    tie = both & np.isclose(t_p, t_j, rtol=2 * res, atol=0)
    return same | tie


# -- dense culling -------------------------------------------------------------

def test_ray_cluster_window_matches_jax():
    g = rng(20)
    cs = jstream.build_clusters(jnp.asarray(random_tris(g, 500, 3.0)),
                                cluster_size=16)
    o, d = aimed_rays(g, random_tris(g, 500, 3.0), 700)
    d[:40, 0] = 0.0                       # axis-parallel rays: the eps rule
    tn = g.uniform(0, 1e-3, 700).astype(np.float32)
    tx = np.where(np.arange(700) % 6 == 0, -1.0,
                  g.uniform(0.5, 8, 700)).astype(np.float32)
    ref = jtiled._ray_cluster_window(cs, *map(jnp.asarray, (o, d, tn, tx)))
    got = ptiled._ray_cluster_window(port_clusters(cs), t(o), t(d), t(tn),
                                     t(tx))
    np.testing.assert_array_equal(n(got[0]), np.asarray(ref[0]))
    hit = np.asarray(ref[0])
    assert hit.sum() > 1000 and (~hit).sum() > 1000
    np.testing.assert_allclose(n(got[1])[hit], np.asarray(ref[1])[hit],
                               rtol=TOL, atol=TOL)
    assert np.isinf(n(got[1])[~hit]).all()


def _jax_dense_lists(cs, o, d, tn, tx, tiles, mv):
    """The dense visit lists as JAX's tiled._query builds them."""
    hit_rc, tnear_rc = jtiled._ray_cluster_window(
        cs, *map(jnp.asarray, (o, d, tn, tx)))
    c = cs.num_clusters
    hit_tc = jnp.any(hit_rc.reshape(tiles, 128, c), axis=1)
    tnear_tc = jnp.min(tnear_rc.reshape(tiles, 128, c), axis=1)
    tnear_tc = jnp.where(hit_tc, tnear_tc, jnp.inf)
    order = jnp.argsort(tnear_tc, axis=1)[:, :mv]
    return (order, jnp.take_along_axis(hit_tc, order, axis=1),
            jnp.take_along_axis(tnear_tc, order, axis=1),
            jnp.any(jnp.sum(hit_tc, axis=1) > mv))


@pytest.mark.parametrize("mv_frac", [1.0, 0.5])
def test_dense_visit_lists_match_jax(mv_frac, monkeypatch):
    g = rng(21)
    cs = jstream.build_clusters(jnp.asarray(random_tris(g, 600, 3.0)),
                                cluster_size=32)
    o, d = random_rays(g, 1024, spread=4.0)
    o[:256] = o[0]                 # a coherent tile pair: entry-t ties at 0
    tn = np.full(1024, 1e-4, np.float32)
    tx = np.where(np.arange(1024) % 5 == 0, -1.0, 1e9).astype(np.float32)
    mv = max(int(cs.num_clusters * mv_frac), 1)
    ref = _jax_dense_lists(cs, o, d, tn, tx, 8, mv)
    # small chunks: the chunked reduction equals one pass
    monkeypatch.setattr(ptiled, "DENSE_PAIRS", 3 * 128 * cs.num_clusters)
    got = ptiled.cull_tiles(port_clusters(cs), t(o), t(d), t(tn), t(tx), 8,
                            mv, "dense")
    for name, a, b in zip(("order", "valid", "tnear", "overflow"), got, ref):
        np.testing.assert_array_equal(n(a), np.asarray(b), err_msg=name)
    assert (np.asarray(ref[2]) == 0).sum() > 10     # ties were exercised


@pytest.mark.parametrize("capped", [True, False])
def test_dense_culling_intersector_matches_jax(capped):
    """tests/test_tiled.py's capped production parity case (and uncapped),
    the port's visit scan twin against JAX's Pallas kernel in interpret
    mode, both culling="dense"."""
    g = rng(22)
    tris = random_tris(g, 400, spread=3.0)
    cs = jstream.build_clusters(jnp.asarray(tris), cluster_size=32)
    o, d = aimed_rays(g, tris, 512)
    mv = max(cs.num_clusters // 2, 1) if capped else cs.num_clusters
    pcs = port_clusters(cs)
    ref = jtiled.intersect_closest(cs, o, d, 1e-4, 1e9, max_visits=mv,
                                   use_pallas=True, culling="dense",
                                   candidate_dtype="float32", decode=False)
    got = ptiled.intersect_closest(pcs, t(o), t(d), 1e-4, 1e9, max_visits=mv,
                                   culling="dense", decode=False)
    assert bool(got["overflow"]) == bool(ref["overflow"]) == capped
    _, _, low_bits = ptiled.key_bits(32, mv)
    ok = _tie_or_same(n(got["tri"]), n(got["t"]), np.asarray(ref["tri"]),
                      np.asarray(ref["t"]), low_bits)
    assert ok.all() and (np.asarray(ref["tri"]) >= 0).sum() > 50
    occ = n(ptiled.intersect_any(pcs, t(o), t(d), 1e-4, 4.0, max_visits=mv,
                                 culling="dense"))
    occ_j = np.asarray(jtiled.intersect_any(cs, o, d, 1e-4, 4.0,
                                            max_visits=mv, use_pallas=True,
                                            culling="dense",
                                            candidate_dtype="float32"))
    np.testing.assert_array_equal(occ, occ_j)


# -- the exact decode ----------------------------------------------------------

@pytest.mark.parametrize("culling", ["frustum", "dense"])
def test_exact_decode_matches_jax(culling):
    g = rng(23)
    tris = random_tris(g, 300, spread=2.5)
    cs = jstream.build_clusters(jnp.asarray(tris), cluster_size=32)
    o, d = aimed_rays(g, tris, 600)
    d[:150] = random_rays(g, 150)[1]                 # mostly misses
    mv = cs.num_clusters
    ref = jtiled.intersect_closest(cs, o, d, 1e-4, 1e9, max_visits=mv,
                                   use_pallas=True, culling=culling,
                                   candidate_dtype="float32")
    got = ptiled.intersect_closest(port_clusters(cs), t(o), t(d), 1e-4, 1e9,
                                   max_visits=mv, culling=culling)
    tri = np.asarray(ref["tri"])
    np.testing.assert_array_equal(n(got["tri"]), tri)
    hit = tri >= 0
    assert hit.sum() > 50 and (~hit).sum() > 50     # hits and misses
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(n(got[f])[hit], np.asarray(ref[f])[hit],
                                   rtol=TOL, atol=TOL, err_msg=f)
    assert np.isinf(n(got["t"])[~hit]).all()
    assert (n(got["u"])[~hit] == 0).all() and (n(got["v"])[~hit] == 0).all()


def test_exact_decode_of_a_grazing_winner_is_a_miss():
    """A winner whose exact det is at most 1e-12 (the ray lies in the
    triangle's plane) decodes to a miss, on both sides; the others to JAX's
    decode formula (an einsum at HIGHEST) within 1e-6."""
    g = rng(24)
    tris = random_tris(g, 64, spread=1.0)
    tris[:5, :, 2] = tris[:5, :1, 2]             # five triangles in z planes
    cs = jstream.build_clusters(jnp.asarray(tris), cluster_size=16)
    c, k = cs.num_clusters, 16
    ids = np.asarray(cs.tri_id)
    live = np.argwhere(ids >= 0)
    first = np.concatenate([np.argwhere(ids == i) for i in range(5)])
    pick = np.concatenate([first, live[g.integers(0, len(live), 200)]])
    cluster, slot = pick[:, 0], pick[:, 1]
    v = tris[ids[cluster, slot]]                             # (r,3,3)
    o = v.mean(1) - 2.0 * g.normal(size=(len(cluster), 3)).astype(np.float32)
    d = v.mean(1) - o
    o[:5] = v[:5].mean(1) - np.float32([3, 0, 0])          # in the plane
    d[:5] = (1, 0, 0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    found = np.ones(len(cluster), bool)
    exact, got_found = ptiled.exact_winners(
        t(cs.tri_feat), k, t(cluster), t(slot), t(o), t(d), t(found))
    cols = cs.tri_feat.reshape(c, 10, 4, k)[cluster, :, :, slot]
    res4 = jnp.einsum("rf,rfc->rc", jstream.ray_features(o, d), cols,
                      precision=jax.lax.Precision.HIGHEST)
    det = np.asarray(res4[:, 0])
    okd = np.abs(det) > 1e-12
    assert not okd[:5].any() and okd[5:].all()
    np.testing.assert_array_equal(n(got_found), okd)
    for f, col in (("t", 3), ("u", 1), ("v", 2)):
        ref = np.asarray(res4[:, col])[okd] / det[okd]
        np.testing.assert_allclose(n(exact[f])[okd], ref, rtol=TOL, atol=TOL)
    assert np.isinf(n(exact["t"])[:5]).all()
    assert (n(exact["u"])[:5] == 0).all() and (n(exact["v"])[:5] == 0).all()


# -- swizzle -------------------------------------------------------------------

@pytest.mark.parametrize("w,h", [(32, 16), (40, 20)])
def test_block_swizzle_map_matches_jax(w, h):
    perm, inv = pcamera.block_swizzle_map(w, h)
    ref_perm, ref_inv = jcamera.block_swizzle_map(w, h)
    assert perm.dtype == np.int32 and inv.dtype == np.int32
    np.testing.assert_array_equal(perm, ref_perm)
    np.testing.assert_array_equal(inv, ref_inv)
    np.testing.assert_array_equal(perm[inv], np.arange(w * h))
    assert (w % 16 == 0 and h % 8 == 0) != bool((perm == np.arange(w * h))
                                                 .all())


def test_swizzled_frame_matches_jax_with_same_uniforms():
    jb, camf = jpresets.cornell_box(bsdf_extras=True)
    sc, cam = jb.build(), camf(2.0)
    w, h = 32, 16
    cfg_kw = dict(width=w, height=h, max_depth=3, bsdf="disney",
                  light_strategy="mis", rr_start_depth=1, swizzle=True)
    jcfg = jwf.RenderConfig(**cfg_kw)
    cs = jstream.build_clusters(sc.tri_pos, cluster_size=16)
    mv = cs.num_clusters
    ji, jo = jtiled.tiled_intersectors(cs, max_visits=mv,
                                       candidate_dtype="float32",
                                       culling="frustum", decode=False)
    key = jax.random.PRNGKey(4)
    ref = jwf.render_wavefront(sc, ji, jo, cam, key, jnp.uint32(0), jcfg)
    pi, po = ptiled.tiled_intersectors(port_clusters(cs), mv, decode=False)
    got = pwf.render_wavefront(
        port_scene(sc), pi, po, port_camera(cam),
        ListUniforms(jax_frame_uniforms(key, jcfg, w * h)), 0,
        pwf.RenderConfig(**cfg_kw))
    img_j = np.asarray(jwf.merge_channels(ref))
    img_p = n(pwf.merge_channels(got))
    assert img_j.mean() > 0.01
    ok = np.isclose(img_p, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    for aov in ("depth", "normal", "albedo", "motion"):
        good = np.isclose(n(got[aov]), np.asarray(ref[aov]), rtol=1e-4,
                          atol=1e-5).reshape(w * h, -1).all(-1)
        assert good.mean() >= 0.99, aov
    # the rows came back in row-major order: depth equals the unswizzled
    # frame's under center jitter
    plain = {}
    for swz in (False, True):
        cfg = pwf.RenderConfig(**{**cfg_kw, "swizzle": swz,
                                  "jitter": "center", "max_depth": 1})
        plain[swz] = pwf.render_wavefront(
            port_scene(sc), pi, po, port_camera(cam),
            psampling.generator_uniforms(torch.Generator().manual_seed(0)),
            0, cfg)["depth"]
    assert torch.equal(plain[False], plain[True])


# -- the blocked sort ----------------------------------------------------------

def test_block_partition_orders_match_jax():
    g = rng(25)
    r, block = 6144, 2048
    octant = g.integers(0, 9, r).astype(np.int32)
    cell = g.integers(0, 64, r).astype(np.int32)
    np.testing.assert_array_equal(
        n(psorting._block_partition_order(t(octant), 9, block)),
        np.asarray(jsorting._block_partition_order(jnp.asarray(octant), 9,
                                                   block)))
    np.testing.assert_array_equal(
        n(psorting._radix_block_order(t(cell), 2, block)),
        np.asarray(jsorting._radix_block_order(jnp.asarray(cell), 2, block)))


def test_blocked_sorted_intersectors_match_jax_and_sorted():
    g = rng(26)
    tris = random_tris(g, 500, spread=3.0)
    cs = pstream.build_clusters(torch.from_numpy(tris), cluster_size=32)
    r = 3000                         # pads to two blocks of 2048
    o, d = random_rays(g, r, spread=3.5)
    tx = np.where(np.arange(r) % 7 == 0, -1.0, 1e9).astype(np.float32)
    sx = np.where(np.arange(r) % 7 == 0, -1.0, 2.0).astype(np.float32)
    lo, hi = np.full(3, -4, np.float32), np.full(3, 4, np.float32)
    seen = {}

    def spy(tag):
        def fn(o_, d_, tn_, tx_):
            seen[tag] = np.concatenate([np.asarray(o_), np.asarray(d_)], 1)
            lib = jnp.asarray if tag[0] == "j" else torch.as_tensor
            if tag[1] == "i":
                return {"tri": o_[:, 0], "overflow": lib(False)}
            return lib(np.zeros(o_.shape[0], bool))
        return fn

    ji, jo = jsorting.blocked_sorted_intersectors(spy("ji"), spy("jo"),
                                                  lo, hi)
    pi, po = psorting.blocked_sorted_intersectors(spy("pi"), spy("po"),
                                                  t(lo), t(hi))
    out_j = ji(jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tx))
    out_p = pi(t(o), t(d), 1e-3, t(tx))
    jo(jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(sx))
    po(t(o), t(d), 1e-3, t(sx))
    np.testing.assert_array_equal(seen["pi"], seen["ji"])
    np.testing.assert_array_equal(seen["po"], seen["jo"])
    np.testing.assert_array_equal(n(out_p["tri"]), np.asarray(out_j["tri"]))
    np.testing.assert_array_equal(n(out_p["tri"]), o[:, 0])
    # on the tiled intersector: the global sort's triangles and occlusion
    mv = cs.num_clusters
    isect, occl = ptiled.tiled_intersectors(cs, mv, decode=False)
    blocked = psorting.blocked_sorted_intersectors(isect, occl, t(lo), t(hi))
    glob = psorting.sorted_intersectors(isect, occl, t(lo), t(hi))
    hb, hg = blocked[0](t(o), t(d), 1e-3, t(tx)), glob[0](t(o), t(d), 1e-3,
                                                          t(tx))
    _, _, low_bits = ptiled.key_bits(32, mv)
    ok = _tie_or_same(n(hb["tri"]), n(hb["t"]), n(hg["tri"]), n(hg["t"]),
                      low_bits)
    assert ok.all() and (n(hg["tri"]) >= 0).sum() > 200
    ob = n(blocked[1](t(o), t(d), 1e-3, t(sx)))
    og = n(glob[1](t(o), t(d), 1e-3, t(sx)))
    assert (ob == og).mean() > 0.99 and og.sum() > 100


# -- two-level and pairs: "dense" walks the tree -------------------------------

def test_two_level_and_pairs_dense_walk_the_tree():
    b, _ = presets.instanced_boxes(n_inst=30)
    ics = ptwo.build_instanced(*ptwo.instance_tables(b.instances),
                               cluster_size=32)
    o, d = random_rays(rng(27), 400, spread=3.0)
    tn, tx = torch.full((400,), 1e-3), torch.full((400,), 1e8)
    for closest in (True, False):
        dense = ptwo._query(ics, t(o), t(d), tn, tx, 64, closest, "dense")
        tree = ptwo._query(ics, t(o), t(d), tn, tx, 64, closest, "tree")
        exact = ptwo._query(ics, t(o), t(d), tn, tx, 64, closest, "dense",
                            decode=True)             # accepted, no effect
        for key in dense:
            assert torch.equal(dense[key], tree[key]), key
            assert torch.equal(exact[key], tree[key]), key
    cs = pstream.build_clusters(torch.from_numpy(random_tris(rng(28), 300)),
                                cluster_size=32)
    for fn in (ppairs.intersect_closest, ppairs.intersect_any):
        dense = fn(cs, t(o), t(d), 1e-3, 1e8, culling="dense")
        tree = fn(cs, t(o), t(d), 1e-3, 1e8, culling="tree")
        if isinstance(dense, dict):
            assert all(torch.equal(dense[k], tree[k]) for k in dense)
            assert int((dense["tri"] >= 0).sum()) > 20
        else:
            assert torch.equal(dense, tree)


# -- helpers -------------------------------------------------------------------

def _close(a, b):
    np.testing.assert_allclose(n(a), np.asarray(b), rtol=TOL, atol=TOL)


def test_bsdf_helpers_match_jax():
    g = rng(29)
    m = 500
    nh = g.uniform(-0.2, 1, m).astype(np.float32)
    oh = g.uniform(-0.2, 1, m).astype(np.float32)
    wo_z = g.uniform(-0.2, 1, m).astype(np.float32)
    alpha = g.uniform(0.02, 1, m).astype(np.float32)
    _close(pcommon.ggx_d(t(nh), t(alpha)),
           jcommon.ggx_d(jnp.asarray(nh), jnp.asarray(alpha)))
    _close(pcommon.smith_g1(t(wo_z), t(alpha)),
           jcommon.smith_g1(jnp.asarray(wo_z), jnp.asarray(alpha)))
    _close(pcommon.ggx_vndf_pdf(t(wo_z), t(nh), t(oh), t(alpha)),
           jcommon.ggx_vndf_pdf(*map(jnp.asarray, (wo_z, nh, oh, alpha))))


def test_vecmath_and_sampling_helpers_match_jax():
    g = rng(30)
    m = 400
    v = g.normal(size=(m, 3)).astype(np.float32)
    nrm = g.normal(size=(m, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    mat = g.normal(size=(m, 4, 4)).astype(np.float32)
    x = g.uniform(-1, 2, (m, 3)).astype(np.float32)
    u = g.uniform(size=(m, 2)).astype(np.float32)
    jv, jn, jm = map(jnp.asarray, (v, nrm, mat))
    _close(pvm.length_sq(t(v)), jvm.length_sq(jv))
    _close(pvm.to_local(t(v), t(nrm)), jvm.to_local(jv, jn))
    _close(pvm.face_forward(t(nrm), t(v)), jvm.face_forward(jn, jv))
    _close(pvm.transform_point(t(mat), t(v)), jvm.transform_point(jm, jv))
    _close(pvm.transform_dir(t(mat), t(v)), jvm.transform_dir(jm, jv))
    _close(pvm.transform_normal(t(mat), t(nrm)),
           jvm.transform_normal(jm, jn))
    _close(pvm.saturate(t(x)), jvm.saturate(jnp.asarray(x)))
    _close(psampling.sample_uniform_sphere(t(u)),
           jsampling.sample_uniform_sphere(jnp.asarray(u)))
