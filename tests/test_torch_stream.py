"""PyTorch port, the brute-force and pair-stream intersectors
(`accel/brute.py`, `accel/stream.py`), against the JAX package (the checks
of tests/test_stream.py) and through the Renderer.

Both packages get the same triangles, rays and `ClusterSet` arrays (the
JAX set converted; ROADMAP C-8). Held: brute t within 1e-5, u and v
within 5e-5 and the triangle exact; the stream's triangle equal except where the two best
t lie within 1e-5 relative (a tie), t, u and v within 1e-5 elsewhere,
occlusion and `overflow` equal (a forced overflow included); the t_max
window; both against brute; the product split into one-tile blocks equal
to one block; Cornell frames through accel="stream" and "brute" equal to
rtol 1e-3, atol 5e-3 (tests/test_renderer.py's bar for BVH against brute).
"""
import _torch_port_helpers  # noqa: F401  (thread cap under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import n, port_clusters, rng, t

from lumenrenderer_tpu.accel import brute as jbrute
from lumenrenderer_tpu.accel import stream as jstream
from lumenrenderer_tpu_torch.accel import brute, stream
from lumenrenderer_tpu_torch.core.camera import generate_primary_rays
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets


def random_tris(g, count, spread=2.0):
    c = g.uniform(-spread, spread, size=(count, 1, 3))
    d = g.normal(size=(count, 3, 3)) * 0.15
    return (c + d).astype(np.float32)


def random_rays(g, r, spread=3.0):
    o = g.uniform(-spread, spread, size=(r, 3)).astype(np.float32)
    d = g.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def aimed_rays(g, tris, r, spread=3.0):
    """Rays from random origins, half of them aimed at triangles."""
    o, d = random_rays(g, r, spread)
    aim = tris[g.integers(0, len(tris), r)].mean(1) - o
    aim /= np.linalg.norm(aim, axis=-1, keepdims=True)
    d[::2] = aim[::2]
    return o, d


def _sets(g, n_tris, k, spread=2.0):
    tris = random_tris(g, n_tris, spread)
    jcs = jstream.build_clusters(jnp.asarray(tris), cluster_size=k)
    return tris, jcs, port_clusters(jcs)


def _hold_closest(got, ref, uv_atol=1e-5):
    """Triangles equal except at ties (best t within 1e-5 relative); t, u,
    v within 1e-5 (u and v: uv_atol) where both hit the same triangle."""
    gt, rt = n(got["t"]), np.asarray(ref["t"])
    same = n(got["tri"]) == np.asarray(ref["tri"])
    both = np.isfinite(gt) & np.isfinite(rt)
    tie = both & (np.abs(gt - rt) <= 1e-5 * np.abs(rt))
    assert (same | tie).all()
    np.testing.assert_array_equal(np.isinf(gt)[same], np.isinf(rt)[same])
    hit = same & both
    for f, atol in (("t", 1e-5), ("u", uv_atol), ("v", uv_atol)):
        np.testing.assert_allclose(n(got[f])[hit], np.asarray(ref[f])[hit],
                                   rtol=1e-5, atol=atol, err_msg=f)
    return same


def test_torch_brute_matches_jax():
    g = rng(0)
    tris = random_tris(g, 150)
    o, d = aimed_rays(g, tris, 300)
    tmax = np.where(g.uniform(size=300) < 0.3, 2.0, 1e9).astype(np.float32)
    ref = jbrute.intersect_closest(jnp.asarray(tris), jnp.asarray(o),
                                   jnp.asarray(d), 1e-4, jnp.asarray(tmax),
                                   chunk=128)
    got = brute.intersect_closest(t(tris), t(o), t(d), 1e-4, t(tmax),
                                  chunk=128)
    np.testing.assert_array_equal(n(got["tri"]), np.asarray(ref["tri"]))
    assert (n(got["tri"]) >= 0).mean() > 0.2
    # Möller–Trumbore's u and v cancel near a triangle's centroid: the two
    # packages' float32 dot products differ there by up to 2e-5
    _hold_closest(got, ref, uv_atol=5e-5)
    np.testing.assert_array_equal(
        n(brute.intersect_any(t(tris), t(o), t(d), 1e-4, t(tmax))),
        np.asarray(jbrute.intersect_any(jnp.asarray(tris), jnp.asarray(o),
                                        jnp.asarray(d), 1e-4,
                                        jnp.asarray(tmax))))


@pytest.mark.parametrize("n_tris,k", [(30, 8), (200, 16), (500, 64)])
def test_torch_stream_closest_matches_jax(n_tris, k):
    g = rng(n_tris)
    tris, jcs, pcs = _sets(g, n_tris, k)
    o, d = random_rays(g, 256)
    ref = jstream.intersect_closest(jcs, jnp.asarray(o), jnp.asarray(d),
                                    1e-4, 1e9, max_pairs_per_ray=64)
    got = stream.intersect_closest(pcs, t(o), t(d), 1e-4, 1e9,
                                   max_pairs_per_ray=64)
    assert bool(got["overflow"]) == bool(ref["overflow"]) is False
    same = _hold_closest(got, ref)
    assert same.mean() > 0.99
    # the compaction keeps JAX's cluster-major order: its live prefix
    tn = torch.full((256,), 1e-4)
    tx = torch.full((256,), 1e9)
    mask = stream._ray_cluster_mask(pcs, t(o), t(d), tn, tx)
    jmask = jstream._ray_cluster_mask(jcs, jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(n(tn)), jnp.asarray(n(tx)))
    np.testing.assert_array_equal(n(mask), np.asarray(jmask))
    max_pairs = stream._sizes(256, pcs.num_clusters, 64)[0]
    pr, pc, _ = stream._extract_pairs(mask, max_pairs)
    jpr, jpc, _ = jstream._extract_pairs(jmask, max_pairs)
    live = pr.shape[0]
    np.testing.assert_array_equal(n(pr), np.asarray(jpr)[:live])
    np.testing.assert_array_equal(n(pc), np.asarray(jpc)[:live])
    assert (np.asarray(jpr)[live:] == -1).all()


@pytest.mark.parametrize("n_tris,k", [(30, 8), (200, 16), (500, 64)])
def test_torch_stream_any_matches_jax(n_tris, k):
    g = rng(n_tris + 1)
    tris, jcs, pcs = _sets(g, n_tris, k)
    o, d = aimed_rays(g, tris, 256)
    ref = np.asarray(jstream.intersect_any(jcs, jnp.asarray(o),
                                           jnp.asarray(d), 1e-4, 4.0,
                                           max_pairs_per_ray=64))
    got = n(stream.intersect_any(pcs, t(o), t(d), 1e-4, 4.0,
                                 max_pairs_per_ray=64))
    np.testing.assert_array_equal(got, ref)
    assert 0.05 < got.mean() < 0.95
    occ_b = n(brute.intersect_any(t(tris), t(o), t(d), 1e-4, 4.0))
    assert (got == occ_b).mean() > 0.995


def test_torch_stream_overflow_matches_jax():
    """A cap of one pair per ray overflows on densely overlapping
    triangles; both packages keep the same first pairs."""
    g = rng(9)
    tris, jcs, pcs = _sets(g, 400, 8, spread=0.3)
    o, d = random_rays(g, 128, spread=0.5)
    ref = jstream.intersect_closest(jcs, jnp.asarray(o), jnp.asarray(d),
                                    1e-4, 1e9, max_pairs_per_ray=1)
    got = stream.intersect_closest(pcs, t(o), t(d), 1e-4, 1e9,
                                   max_pairs_per_ray=1)
    assert bool(ref["overflow"]) and bool(got["overflow"])
    _hold_closest(got, ref)


def test_torch_stream_tmax_window():
    g = rng(3)
    tris, jcs, pcs = _sets(g, 80, 16)
    o, d = aimed_rays(g, tris, 128)
    full = stream.intersect_closest(pcs, t(o), t(d), 1e-4, 1e9,
                                    max_pairs_per_ray=64)
    t_full = n(full["t"])
    hit = np.isfinite(t_full)
    assert hit.mean() > 0.1
    cap = np.where(hit, t_full * 0.5, 1e9).astype(np.float32)
    capped = stream.intersect_closest(pcs, t(o), t(d), 1e-4, t(cap),
                                      max_pairs_per_ray=64)
    ref = jstream.intersect_closest(jcs, jnp.asarray(o), jnp.asarray(d),
                                    1e-4, jnp.asarray(cap),
                                    max_pairs_per_ray=64)
    _hold_closest(capped, ref)
    tc = n(capped["t"])[hit]
    # nothing beyond the window: a hit inside it, or none
    assert ((tc <= t_full[hit] * 0.5 + 1e-6) | np.isinf(tc)).all()


def test_torch_stream_matches_brute():
    """Cornell primary hits: the stream against brute force (differences
    only at exact-t ties on shared quad diagonals)."""
    b, camf = presets.cornell_box()
    sc = b.build()
    cs = stream.build_clusters(sc.tri_pos, cluster_size=8)
    o, d = generate_primary_rays(camf(1.0), 32, 32, 0, jitter="center")
    rs = stream.intersect_closest(cs, o, d, 1e-3, 1e9, max_pairs_per_ray=32)
    rb = brute.intersect_closest(sc.tri_pos, o, d, 1e-3, 1e9)
    same = n(rs["tri"]) == n(rb["tri"])
    tie = np.isclose(n(rs["t"]), n(rb["t"]), rtol=1e-5)
    assert (same | tie).mean() > 0.999
    np.testing.assert_allclose(n(rs["t"])[same], n(rb["t"])[same],
                               rtol=2e-4, atol=1e-5)


def test_torch_stream_blocked_product(monkeypatch):
    """One-tile product blocks and 7-ray box-test blocks give the result
    of one block, bit for bit."""
    g = rng(4)
    tris, _, pcs = _sets(g, 300, 16)
    o, d = aimed_rays(g, tris, 200)
    args = (pcs, t(o), t(d), 1e-4, 1e9)
    whole = stream.intersect_closest(*args, max_pairs_per_ray=32)
    occ = stream.intersect_any(*args, max_pairs_per_ray=32)
    tiles = stream.pair_stream(*args, 32)["tile_cluster"].shape[0]
    monkeypatch.setattr(stream, "PAIR_BLOCK_TILES", 1)
    monkeypatch.setattr(stream, "MASK_RAYS", 7)
    assert tiles > 10
    blocked = stream.intersect_closest(*args, max_pairs_per_ray=32)
    for f in ("t", "tri", "u", "v", "overflow"):
        np.testing.assert_array_equal(n(blocked[f]), n(whole[f]))
    np.testing.assert_array_equal(
        n(stream.intersect_any(*args, max_pairs_per_ray=32)), n(occ))


def test_torch_renderer_stream_and_brute_images():
    b, camf = presets.cornell_box()
    sc, cam = b.build(), camf(1.0)
    cfg = RenderConfig(width=24, height=24, max_depth=3, bsdf="lambert")
    img_s = Renderer(sc, cfg, accel="stream", cluster_size=8,
                     device="cpu").render(cam, spp=12, seed=5)
    img_b = Renderer(sc, cfg, accel="brute", device="cpu").render(
        cam, spp=12, seed=5)
    assert img_s.mean() > 0.05
    np.testing.assert_allclose(img_s, img_b, rtol=1e-3, atol=5e-3)
