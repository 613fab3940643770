"""PyTorch port, acceleration structures, against the JAX package.

- ClusterSet from the same membership: 1e-6 relative (float64 host math in
  both, stored as float32).
- SAH leaf order and frustum visit lists: exactly equal.
- visit_scan_ref (K1's plain twin) against the Pallas kernel in interpret
  mode at precision="highest": the same triangle, or t within rtol 1e-3, on
  100% of rays; occlusion identical (the bar of tests/test_tiled.py).
- tiled intersector against the brute-force oracle: same triangle or t
  within the packed key's resolution, on every ray; occlusion exact.
- sort keys and permutations: exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import n, port_clusters, rng, t

from lumenrenderer_tpu.accel import brute, sah as jsah, sorting as jsorting
from lumenrenderer_tpu.accel import stream as jstream, tiled as jtiled
from lumenrenderer_tpu.ops.pallas import intersect as jpk
from lumenrenderer_tpu_torch.accel import sah as psah, sorting as psorting
from lumenrenderer_tpu_torch.accel import stream as pstream, tiled as ptiled
from lumenrenderer_tpu_torch.ops import visit_scan as pvs


def random_tris(g, count, spread=2.0):
    c = g.uniform(-spread, spread, size=(count, 1, 3))
    d = g.normal(size=(count, 3, 3)) * 0.15
    return (c + d).astype(np.float32)


def random_rays(g, count, spread=3.0):
    o = g.uniform(-spread, spread, size=(count, 3)).astype(np.float32)
    d = g.normal(size=(count, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_sah_order_matches_jax_numpy_builder():
    tris = random_tris(rng(0), 700)
    for leaf in (16, 64):
        ref = jsah.build_sah_arrays(tris, leaf_size=leaf)
        got = psah.build_sah_arrays(tris, leaf_size=leaf)
        for a, b in zip(ref[:5], got[:5]):
            np.testing.assert_array_equal(a, b)
        assert ref[5] == got[5]


@pytest.mark.parametrize("k", [16, 128])
def test_clusters_from_same_order_match_jax(k):
    tris = random_tris(rng(1), 500)
    ref = jstream.build_clusters(jnp.asarray(tris), cluster_size=k)
    got = pstream.clusters_from_order(tris, np.asarray(ref.tri_id))
    assert got.tris_per_cluster == ref.tris_per_cluster
    np.testing.assert_array_equal(n(got.tri_id), np.asarray(ref.tri_id))
    for f in ("aabb_lo", "aabb_hi", "tri_feat"):
        np.testing.assert_allclose(n(getattr(got, f)),
                                   np.asarray(getattr(ref, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


def test_build_clusters_uses_numpy_sah_order():
    tris = random_tris(rng(2), 300)
    cs = pstream.build_clusters(torch.from_numpy(tris), cluster_size=32)
    order = jsah.build_sah_arrays(tris, leaf_size=32)[4].reshape(-1, 32)
    np.testing.assert_array_equal(n(cs.tri_id), order)


def _padded_inputs(g, r, dead_every=0):
    o, d = random_rays(g, r, spread=4.0)
    tn = np.full(r, 1e-4, np.float32)
    tx = np.full(r, 1e9, np.float32)
    if dead_every:
        tx[::dead_every] = -1.0
    pad = (-r) % 1024                    # the JAX kernel path pads to 8 tiles
    o = np.concatenate([o, np.zeros((pad, 3), np.float32)])
    d = np.concatenate([d, np.ones((pad, 3), np.float32)])
    tn = np.concatenate([tn, np.zeros(pad, np.float32)])
    tx = np.concatenate([tx, -np.ones(pad, np.float32)])
    return o, d, tn, tx, (r + pad) // 128


@pytest.mark.parametrize("mv_frac", [1.0, 0.5])
def test_frustum_visits_match_jax(mv_frac):
    g = rng(3)
    tris = random_tris(g, 600, spread=3.0)
    cs = jstream.build_clusters(jnp.asarray(tris), cluster_size=32)
    o, d, tn, tx, tiles = _padded_inputs(g, 900, dead_every=5)
    # coherent tiles too: rays from one origin share frusta, so many
    # clusters tie at entry t = 0 (origin inside their boxes)
    o[:512] = o[0]
    mv = max(int(cs.num_clusters * mv_frac), 1)
    ref = jtiled._frustum_visits(cs, *map(jnp.asarray, (o, d, tn, tx)),
                                 tiles, mv)
    got = ptiled._frustum_visits(port_clusters(cs), t(o), t(d), t(tn), t(tx),
                                 tiles, mv)
    for name, a, b in zip(("order", "valid", "tnear", "overflow"), got, ref):
        np.testing.assert_array_equal(n(a), np.asarray(b), err_msg=name)
    assert (np.asarray(ref[2]) == 0).sum() > 10   # ties were exercised


def _visit_inputs(g, cs, r=1024):
    o, d, tn, tx, tiles = _padded_inputs(g, r, dead_every=7)
    mv = cs.num_clusters
    order, valid, tnear, _ = jtiled._frustum_visits(
        cs, *map(jnp.asarray, (o, d, tn, tx)), tiles, mv)
    rf = np.asarray(jstream.ray_features(jnp.asarray(o), jnp.asarray(d)))
    rf_t = np.concatenate([rf, tn[:, None], tx[:, None]], 1).reshape(
        tiles, 128, 12).astype(np.float32)
    nv = np.asarray(valid).sum(1).astype(np.int32)
    bits = np.maximum(np.asarray(tnear), 0).astype(np.float32).view(np.int32)
    tnb = np.where(np.asarray(valid), np.minimum(bits, jpk.KEY_MISS - 1),
                   jpk.KEY_MISS).astype(np.int32)
    return rf_t, np.asarray(order, np.int32), nv, tnb, mv


@pytest.mark.parametrize("closest", [True, False])
def test_visit_scan_twin_matches_pallas_interpret(closest):
    g = rng(4)
    tris = random_tris(g, 200)
    cs = jstream.build_clusters(jnp.asarray(tris), cluster_size=32)
    rf_t, sel, nv, tnb, mv = _visit_inputs(g, cs)
    assert rf_t.shape[0] == 8
    k = 32
    k_bits, s_bits, low_bits = ptiled.key_bits(k, mv)
    kw = dict(k=k, mv=mv, k_bits=k_bits, low_bits=low_bits, closest=closest)
    ref = np.asarray(jpk.visit_scan(
        jnp.asarray(rf_t), cs.tri_feat, cs.tri_id, jnp.asarray(sel),
        jnp.asarray(nv), jnp.asarray(tnb), interpret=True,
        precision="highest", **kw))
    got = n(pvs.visit_scan_ref(t(rf_t), t(cs.tri_feat), t(sel), t(nv),
                               t(tnb), **kw))
    if not closest:
        np.testing.assert_array_equal(got, ref)
        return
    same = got == ref
    low_mask = ~((1 << low_bits) - 1)
    t_of = lambda key: (key & low_mask).astype(np.int32).view(np.float32)
    both = (ref < jpk.KEY_MISS) & (got < jpk.KEY_MISS)
    tie = both & np.isclose(t_of(got), t_of(ref), rtol=1e-3)
    assert (same | tie).all()
    assert (ref < jpk.KEY_MISS).sum() > 100


def test_visit_scan_wrapper_on_cpu_runs_the_twin_uncounted():
    g = rng(5)
    tris = random_tris(g, 120)
    cs = jstream.build_clusters(jnp.asarray(tris), cluster_size=32)
    rf_t, sel, nv, tnb, mv = _visit_inputs(g, cs, r=256)
    k_bits, _, low_bits = ptiled.key_bits(32, mv)
    args = (t(rf_t), t(cs.tri_feat), t(sel), t(nv), t(tnb))
    kw = dict(k=32, mv=mv, k_bits=k_bits, low_bits=low_bits, closest=True)
    pvs.reset_launches()
    out = pvs.visit_scan(*args, **kw)
    assert torch.equal(out, pvs.visit_scan_ref(*args, **kw))
    assert pvs.LAUNCHES == {"closest": 0, "any": 0}
    with pytest.raises(ValueError):
        pvs.visit_scan(args[0].double(), *args[1:], **kw)
    with pytest.raises(ValueError):
        pvs.visit_scan(args[0], args[1], args[2][:, :-1], *args[3:], **kw)
    with pytest.raises(ValueError):
        pvs.visit_scan(*args, **{**kw, "low_bits": 16})


@pytest.mark.parametrize("n_tris,k", [(30, 8), (500, 64)])
def test_tiled_matches_brute(n_tris, k):
    g = rng(6)
    tris = random_tris(g, n_tris)
    cs = pstream.build_clusters(torch.from_numpy(tris), cluster_size=k)
    o, d = random_rays(g, 300)      # deliberately not a multiple of 128
    res = ptiled.intersect_closest(cs, t(o), t(d), 1e-4, 1e9,
                                   max_visits=cs.num_clusters)
    ref = brute.intersect_closest(jnp.asarray(tris), jnp.asarray(o),
                                  jnp.asarray(d), 1e-4, 1e9)
    assert not bool(res["overflow"])
    tri_p, tri_b = n(res["tri"]), np.asarray(ref["tri"])
    t_p, t_b = n(res["t"]), np.asarray(ref["t"])
    np.testing.assert_array_equal(tri_p >= 0, tri_b >= 0)
    hit = tri_b >= 0
    _, _, low_bits = ptiled.key_bits(k, cs.num_clusters)
    res_t = 2.0 ** -(23 - low_bits)      # the key keeps 23-low_bits bits
    rel = np.abs(t_p[hit] - t_b[hit]) / t_b[hit]
    assert rel.max() <= 2 * res_t
    assert ((tri_p == tri_b) | ~hit).mean() > 0.99
    occ = n(ptiled.intersect_any(cs, t(o), t(d), 1e-4, 4.0,
                                 max_visits=cs.num_clusters))
    np.testing.assert_array_equal(
        occ, np.asarray(brute.intersect_any(jnp.asarray(tris), jnp.asarray(o),
                                            jnp.asarray(d), 1e-4, 4.0)))


def test_tiled_dead_rays_and_overflow():
    g = rng(7)
    tris = random_tris(g, 400, spread=0.3)
    cs = pstream.build_clusters(torch.from_numpy(tris), cluster_size=8)
    o, d = random_rays(g, 256, spread=0.5)
    tmax = np.where(np.arange(256) % 2 == 0, 1e9, -1.0).astype(np.float32)
    res = ptiled.intersect_closest(cs, t(o), t(d), 1e-4, t(tmax),
                                   max_visits=1)
    assert bool(res["overflow"])
    assert (n(res["tri"])[1::2] == -1).all()
    occ = n(ptiled.intersect_any(cs, t(o), t(d), 1e-4, t(tmax),
                                 max_visits=4))
    assert not occ[1::2].any()


def test_sort_keys_and_permutation_match_jax():
    g = rng(8)
    r = 3000
    o = g.uniform(-1, 3, (r, 3)).astype(np.float32)
    d = g.normal(size=(r, 3)).astype(np.float32)
    tx = g.uniform(-1, 4, r).astype(np.float32)
    lo, hi = np.array([-1, -1, -1], np.float32), np.array([3, 3, 3], np.float32)
    jo, jd, jtx = map(jnp.asarray, (o, d, tx))
    ref_b = np.asarray(jsorting.ray_sort_key(jo, jd, jnp.asarray(lo),
                                             jnp.asarray(hi)))
    ref_c = np.asarray(jsorting.capsule_sort_key(jo, jd, jtx, jnp.asarray(lo),
                                                 jnp.asarray(hi)))
    got_b = n(psorting.ray_sort_key(t(o), t(d), t(lo), t(hi)))
    got_c = n(psorting.capsule_sort_key(t(o), t(d), t(tx), t(lo), t(hi)))
    np.testing.assert_array_equal(got_b, ref_b.astype(np.int64))
    np.testing.assert_array_equal(got_c, ref_c.astype(np.int64))
    # the permutations the sorted intersectors apply, dead rays included
    seen = {}

    def spy(tag):
        def fn(o_, d_, tn_, tx_):
            seen[tag] = np.asarray(o_)
            lib = jnp.asarray if tag[0] == "j" else torch.as_tensor
            if tag[1] == "i":
                return {"tri": o_[:, 0], "overflow": lib(False)}
            return lib(np.zeros(o_.shape[0], bool))
        return fn

    ji, jo_ = jsorting.sorted_intersectors(spy("ji"), spy("jo"), lo, hi)
    pi, po = psorting.sorted_intersectors(spy("pi"), spy("po"), t(lo), t(hi))
    out_j = ji(jo, jd, 1e-3, jtx)
    out_p = pi(t(o), t(d), 1e-3, t(tx))
    jo_(jo, jd, 1e-3, jtx)
    po(t(o), t(d), 1e-3, t(tx))
    np.testing.assert_array_equal(n(seen["pi"]), seen["ji"])
    np.testing.assert_array_equal(n(seen["po"]), seen["jo"])
    np.testing.assert_array_equal(n(out_p["tri"]), o[:, 0])
    np.testing.assert_array_equal(np.asarray(out_j["tri"]), o[:, 0])
