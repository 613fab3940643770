"""PyTorch port, pair-admission intersector, against the JAX package, on a
small triangle soup like tests/test_pairs.py's.

- The refine mask and every output of the pair emission: exactly equal (the
  port keeps flat slot indices in int64 where JAX has int32).
- pair_scan_ref (K3's plain twin) against the Pallas kernel in interpret
  mode at precision="highest": closest keys equal or a tie within the key's
  t quantum plus the Pallas t's own error (2^-16 relative: K3's key keeps
  18 mantissa bits, so that error shows); occlusion bits equal.
- intersect_closest and intersect_any against JAX and the brute-force
  oracle, at tests/test_pairs.py's bars: hit mask equal, decoded t within
  rtol 1e-4 (the key's t within 2e-4 relative), the same triangle,
  occlusion equal; an admission set larger than the cap sets overflow.
- A 64x48 frame through the pair intersectors against the tiled frame from
  the same random numbers: primary depth and normal equal within rtol 1e-4
  on at least 99.9% of pixels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import n, port_clusters, rng, t

from lumenrenderer_tpu.accel import brute, pairs as jpairs
from lumenrenderer_tpu.accel import stream as jstream, tiled as jtiled
from lumenrenderer_tpu.ops.pallas import pair_intersect as jpk
from lumenrenderer_tpu_torch.accel import pairs as ppairs, stream as pstream
from lumenrenderer_tpu_torch.accel import tiled as ptiled
from lumenrenderer_tpu_torch.core import sampling
from lumenrenderer_tpu_torch.integrator import wavefront as pwf
from lumenrenderer_tpu_torch.ops import pair_scan as pps
from lumenrenderer_tpu_torch.scene import presets

K = 32
KEY_MISS = 0x7F000000


@pytest.fixture(scope="module")
def soup():
    g = rng(7)
    count = 600
    tri = g.uniform(-1, 1, (count, 3, 3)).astype(np.float32)
    tri[:, 1:] = tri[:, :1] + 0.3 * g.uniform(-1, 1, (count, 2, 3)).astype(
        np.float32)
    r = 900
    o = g.uniform(-2, 2, (r, 3)).astype(np.float32)
    d = g.uniform(-1, 1, (r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tx = np.where(g.uniform(size=r) < 0.25, -1.0, 1e8).astype(np.float32)
    cs = jstream.build_clusters(jnp.asarray(tri), cluster_size=K)
    return tri, o, d, tx, cs


def _stages(lib, cs, o, d, tx, mv=128, mpr=16):
    """Culling, refine and emission of one package on padded inputs."""
    arr = jnp.asarray if lib is jpairs else t
    tiled = jtiled if lib is jpairs else ptiled
    r = o.shape[0]
    pad = (-r) % ppairs.PAIR_GROUP
    o = arr(np.concatenate([o, np.zeros((pad, 3), np.float32)]))
    d = arr(np.concatenate([d, np.ones((pad, 3), np.float32)]))
    tn = arr(np.concatenate([np.full(r, 1e-3, np.float32),
                             np.zeros(pad, np.float32)]))
    tx = arr(np.concatenate([tx, -np.ones(pad, np.float32)]))
    tiles = (r + pad) // 128
    c = cs.num_clusters
    mv = min(mv, c)
    sel, valid, _, _ = tiled._frustum_visits(cs, o, d, tn, tx, tiles, mv)
    hit = lib._refine_hits(cs, o, d, tn, tx, sel, valid, tiles)
    p_cap = -(-((r + pad) * mpr) // ppairs.PAIR_GROUP) * ppairs.PAIR_GROUP
    s_cap = -(-(p_cap + c * 128) // ppairs.PAIR_GROUP) * ppairs.PAIR_GROUP
    return hit, lib._emit_sorted_pairs(hit, sel, c, mv, p_cap, s_cap)


def test_refine_and_emit_match_jax(soup):
    tri, o, d, tx, cs = soup
    hit_j, emit_j = _stages(jpairs, cs, o, d, tx)
    hit_p, emit_p = _stages(ppairs, port_clusters(cs), o, d, tx)
    np.testing.assert_array_equal(n(hit_p), np.asarray(hit_j))
    names = ("idx", "dest_orig", "pair_ray_s", "tile_cluster", "overflow")
    for name, a, b in zip(names, emit_p, emit_j):
        np.testing.assert_array_equal(n(a), np.asarray(b), err_msg=name)
    assert np.asarray(hit_j).sum() > 1000


@pytest.mark.parametrize("closest", [True, False])
def test_k3_twin_matches_pallas_interpret(soup, closest):
    tri, o, d, tx, cs = soup
    if not closest:
        tx = np.where(tx > 0, 1.2, -1.0).astype(np.float32)
    q = ppairs.scan_inputs(port_clusters(cs), t(o), t(d), 1e-3, t(tx),
                           128, 16)
    rf_pairs, feats, tile_cluster = map(n, q["args"])
    kw = dict(q["kw"], closest=closest)
    ref = np.asarray(jpk.pair_scan(jnp.asarray(rf_pairs), cs.tri_feat,
                                   jnp.asarray(tile_cluster), interpret=True,
                                   precision="highest", **kw))
    got = n(pps.pair_scan_ref(*q["args"], **kw))
    if not closest:
        np.testing.assert_array_equal(got, ref)
        assert ref.sum() > 50
        return
    low_mask = ~((1 << kw["k_bits"]) - 1)
    t_of = lambda key: (key & low_mask).astype(np.int32).view(np.float32)
    both = (ref < KEY_MISS) & (got < KEY_MISS)
    # the key's quantum, plus the error of the Pallas kernel's t: a bf16
    # reciprocal in interpret mode, one Newton step, 2^-16 relative
    rel = 2.0 ** -(23 - kw["k_bits"]) + 2.0 ** -16
    quantum = np.maximum(t_of(got), t_of(ref)) * rel
    tie = both & (np.abs(t_of(got) - t_of(ref)) <= quantum)
    assert ((got == ref) | tie).all()
    same_slot = (got & ~low_mask) == (ref & ~low_mask)
    assert same_slot[both].mean() > 0.99
    assert (ref < KEY_MISS).sum() > 50


def test_k3_wrapper_on_cpu_runs_the_twin_uncounted(soup):
    tri, o, d, tx, cs = soup
    q = ppairs.scan_inputs(port_clusters(cs), t(o), t(d), 1e-3, t(tx), 128, 4)
    pps.reset_launches()
    out = pps.pair_scan(*q["args"], **q["kw"], closest=True)
    assert torch.equal(out, pps.pair_scan_ref(*q["args"], **q["kw"],
                                              closest=True))
    assert pps.LAUNCHES == {"closest": 0, "any": 0}
    rf_pairs, feats, tc = q["args"]
    with pytest.raises(ValueError):           # not whole pair tiles
        pps.pair_scan(rf_pairs[:-1], feats, tc, **q["kw"], closest=True)
    with pytest.raises(ValueError):
        pps.pair_scan(rf_pairs, feats, tc.long(), **q["kw"], closest=True)
    with pytest.raises(ValueError):           # key field too narrow for K
        pps.pair_scan(rf_pairs, feats, tc, k=K, k_bits=4, closest=True)


@pytest.mark.parametrize("decode", [True, False])
def test_pairs_closest_matches_jax_and_brute(soup, decode):
    tri, o, d, tx, cs = soup
    ref = brute.intersect_closest(tri, o, d, 1e-3, tx)
    ref_j = jpairs.intersect_closest(cs, o, d, 1e-3, tx, decode=decode,
                                     max_pairs_per_ray=16,
                                     precision="highest", interpret=True)
    got = ppairs.intersect_closest(port_clusters(cs), t(o), t(d), 1e-3,
                                   t(tx), max_pairs_per_ray=16, decode=decode)
    assert not bool(got["overflow"])
    hr = np.isfinite(np.asarray(ref["t"]))
    np.testing.assert_array_equal(np.isfinite(n(got["t"])), hr)
    np.testing.assert_array_equal(n(got["tri"])[hr],
                                  np.asarray(ref["tri"])[hr])
    np.testing.assert_array_equal(n(got["tri"]), np.asarray(ref_j["tri"]))
    rt, gt = np.asarray(ref["t"])[hr], n(got["t"])[hr]
    if decode:
        np.testing.assert_allclose(gt, rt, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gt, np.asarray(ref_j["t"])[hr],
                                   rtol=1e-5)
        for f in ("u", "v"):
            np.testing.assert_allclose(n(got[f]), np.asarray(ref_j[f]),
                                       rtol=1e-5, atol=1e-6)
    else:
        assert np.max(np.abs(gt - rt) / np.maximum(rt, 1e-3)) < 2e-4
        # JAX's key t carries its approximate reciprocal (2^-16 relative)
        np.testing.assert_allclose(gt, np.asarray(ref_j["t"])[hr],
                                   rtol=2.0 ** -18 + 2.0 ** -16)


def test_pairs_any_matches_jax_and_brute(soup):
    tri, o, d, tx, cs = soup
    tx2 = np.where(tx > 0, 1.2, -1.0).astype(np.float32)
    ref = np.asarray(brute.intersect_any(tri, o, d, 1e-3, tx2))
    ref_j = np.asarray(jpairs.intersect_any(cs, o, d, 1e-3, tx2,
                                            max_pairs_per_ray=16,
                                            precision="highest",
                                            interpret=True))
    got = n(ppairs.intersect_any(port_clusters(cs), t(o), t(d), 1e-3, t(tx2),
                                 max_pairs_per_ray=16))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, ref_j)
    assert ref.sum() > 50


def test_pairs_overflow_flag(soup):
    tri, o, d, tx, cs = soup
    # one pair per ray cannot hold the admission set
    got = ppairs.intersect_closest(port_clusters(cs), t(o), t(d), 1e-3,
                                   torch.full((len(o),), 1e8),
                                   max_pairs_per_ray=1, decode=False)
    assert bool(got["overflow"])


def test_pair_frame_matches_tiled():
    b, camf = presets.interior_scene(n_boxes=60, n_lights=8)
    sc = b.build()
    cs = pstream.build_clusters(sc.tri_pos, cluster_size=K)
    w, h = 64, 48
    cfg = pwf.RenderConfig(width=w, height=h, max_depth=3, bsdf="disney",
                           light_strategy="mis")
    outs = []
    for isect, occl in (
            ppairs.pair_intersectors(cs, max_visits=128, max_pairs_per_ray=8,
                                     decode=False),
            ptiled.tiled_intersectors(cs, max_visits=cs.num_clusters)):
        gen = torch.Generator().manual_seed(3)
        outs.append(pwf.render_wavefront(sc, isect, occl, camf(w / h),
                                         sampling.generator_uniforms(gen), 0,
                                         cfg))
    got, ref = outs
    assert not bool(got["overflow"]) and not bool(ref["overflow"])
    assert float(n(ref["depth"]).mean()) > 0
    for aov in ("depth", "normal"):
        good = np.isclose(n(got[aov]), n(ref[aov]), rtol=1e-4,
                          atol=1e-5).reshape(w * h, -1).all(-1)
        assert good.mean() >= 0.999, aov
    img_p = n(pwf.merge_channels(got))
    img_t = n(pwf.merge_channels(ref))
    assert np.isfinite(img_p).all()
    assert abs(img_p.mean() - img_t.mean()) <= 0.05 * img_t.mean()
