"""The BVH accels of the PyTorch port (accel/format.py, sah.build_sah,
lbvh.py, traverse.py, native/bvh_native.py, ops/bvh_traverse.py's twin)
against `lumenrenderer_tpu`'s on the CPU.

Builders: the same triangles give the same BVH exactly (the SAH from the
numpy builder's arrays on both sides, ROADMAP C-8). The traversal twin
against JAX's `intersect_closest` / `intersect_any` on tests/test_bvh.py's
cases: triangle ids and hit bits equal, t, u and v within 1e-6 (JAX's XLA
build may fuse its products; the twin rounds each one). Kernel T itself
runs on the card only (tests/test_torch_kernels.py, chip_smoke.py).
"""
import logging
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import n, port_camera, rng, t
from lumenrenderer_tpu.accel import lbvh as jlbvh
from lumenrenderer_tpu.accel import sah as jsah
from lumenrenderer_tpu.accel import traverse as jtraverse
from lumenrenderer_tpu.core import vecmath as jvm
from lumenrenderer_tpu.core.camera import generate_primary_rays as jprimary
from lumenrenderer_tpu.native import bvh_native as jnative
from lumenrenderer_tpu.scene import presets as jpresets
from lumenrenderer_tpu_torch.accel import brute, lbvh, sah, traverse
from lumenrenderer_tpu_torch.core import vecmath
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.native import bvh_native
from lumenrenderer_tpu_torch.ops import bvh_traverse as bt
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets

FIELDS = ("node_lo", "node_hi", "child0", "child1", "tri_p0", "tri_e1",
          "tri_e2", "tri_id")
ATOL = 1e-6


def random_tris(g, count, spread=2.0):
    c = g.uniform(-spread, spread, size=(count, 1, 3))
    return (c + g.normal(size=(count, 3, 3)) * 0.15).astype(np.float32)


def random_rays(g, count, spread=3.0):
    o = g.uniform(-spread, spread, size=(count, 3)).astype(np.float32)
    d = g.normal(size=(count, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _jax_sah_numpy(tris, leaf_size, monkeypatch):
    """JAX's build_sah with its native builder refused (numpy arrays)."""
    def refuse(*a, **k):
        raise ImportError("native builder refused by the test")

    monkeypatch.setattr(jnative, "build_sah", refuse)
    return jsah.build_sah(jnp.asarray(tris), leaf_size=leaf_size)


def _port_sah_numpy(tris, leaf_size):
    return sah.bvh_from_arrays(tris, sah.build_sah_arrays(tris, leaf_size),
                               leaf_size)


def _pair(builder, tris, leaf_size, monkeypatch):
    if builder == "lbvh":
        return (jlbvh.build_lbvh(jnp.asarray(tris), leaf_size=leaf_size),
                lbvh.build_lbvh(t(tris), leaf_size=leaf_size))
    return (_jax_sah_numpy(tris, leaf_size, monkeypatch),
            _port_sah_numpy(tris, leaf_size))


def _same_bvh(jb, pb):
    for f in FIELDS:
        np.testing.assert_array_equal(n(getattr(pb, f)),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert (pb.leaf_size, pb.max_depth, pb.num_nodes, pb.num_leaves) == (
        jb.leaf_size, jb.max_depth, jb.num_nodes, jb.num_leaves)


def test_safe_rcp_matches_jax():
    x = np.array([0.0, -0.0, 1e-21, -1e-21, 1e-20, 2e-20, -3.0, 0.5,
                  np.nan], np.float32)
    np.testing.assert_array_equal(n(vecmath.safe_rcp(t(x))),
                                  np.asarray(jvm.safe_rcp(jnp.asarray(x))))


@pytest.mark.parametrize("count,leaf_size", [(37, 4), (64, 4), (123, 2),
                                             (333, 8)])
def test_builds_equal_jax(count, leaf_size, monkeypatch):
    tris = random_tris(rng(count), count)
    for builder in ("sah", "lbvh"):
        _same_bvh(*_pair(builder, tris, leaf_size, monkeypatch))


def _bits(x):
    return np.ascontiguousarray(n(x)).view(np.int32)


def _hold_records(b):
    """Kernel T's records decode to the BVH's own fields, bit for bit."""
    nodes, slots = _bits(b.nodes), _bits(b.slots)
    lo, hi = _bits(b.node_lo), _bits(b.node_hi)
    c0, c1 = n(b.child0), n(b.child1)
    assert nodes.shape == (b.num_nodes, 16)
    inner = c0 >= 0
    for k, c in enumerate((c0[inner], c1[inner])):
        np.testing.assert_array_equal(nodes[inner, 6 * k:6 * k + 3], lo[c])
        np.testing.assert_array_equal(nodes[inner, 6 * k + 3:6 * k + 6],
                                      hi[c])
        # a child's id: its node if internal, else -(leaf + 1)
        np.testing.assert_array_equal(nodes[inner, 12 + k],
                                      np.where(c0[c] >= 0, c, c0[c]))
    assert (nodes[:, 14:] == 0).all()
    p0, e1, e2 = _bits(b.tri_p0), _bits(b.tri_e1), _bits(b.tri_e2)
    assert slots.shape == (p0.shape[0], 12)
    for k, f in enumerate((p0, e1, e2)):
        np.testing.assert_array_equal(slots[:, 4 * k:4 * k + 3], f)
    np.testing.assert_array_equal(slots[:, 3], n(b.tri_id))
    assert (slots[:, 7] == 0).all() and (slots[:, 11] == 0).all()


@pytest.mark.parametrize("builder", ["sah", "lbvh"])
@pytest.mark.parametrize("leaf_size", [1, 4, 8])
@pytest.mark.parametrize("count", [1, 5, 123])
def test_kernel_records_decode_to_the_bvh(builder, leaf_size, count):
    tris = random_tris(rng(count * leaf_size), count)
    b = (sah.build_sah(tris, leaf_size) if builder == "sah"
         else lbvh.build_lbvh(t(tris), leaf_size))
    assert (b.num_nodes == 1) == (count <= leaf_size)   # a root leaf
    pad = n(b.tri_id) < 0
    if count % leaf_size:
        assert pad.any()
    assert np.isinf(n(b.slots)[pad, :3]).all()      # padding: p0 = inf
    assert (_bits(b.slots)[pad, 3] == -1).all()
    for bb in (b, b.to("cpu"), b.replace(max_depth=b.max_depth + 1)):
        _hold_records(bb)
    meta = b.to("meta")
    assert meta.nodes.shape == b.nodes.shape and meta.slots.is_meta


def _fma_exact(a, b, c):
    """a b + c rounded to the nearest float32, ties to even, computed
    exactly: the nearest of the float32 candidate and its neighbours. A
    non-finite operand or an exact zero (its sign) is float64's, whose
    product is exact."""
    x = (Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
         if np.isfinite([a, b, c]).all() else 0)
    if x == 0:
        with np.errstate(invalid="ignore"):
            return np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    top = np.finfo(np.float32).max
    if abs(x) >= Fraction(float(top)) + Fraction(2) ** 103:   # overflow
        return np.float32(np.inf if x > 0 else -np.inf)
    cand = np.float32(float(x))
    near = [y for y in (np.nextafter(cand, np.float32(-np.inf)), cand,
                        np.nextafter(cand, np.float32(np.inf)))
            if np.isfinite(y)]
    return min(near, key=lambda y: (abs(Fraction(float(y)) - x),
                                    int(np.float32(y).view(np.int32)) & 1))


def _fma_inputs(kind, g, m=400):
    f32 = np.float32
    if kind == "random":
        return [g.normal(size=m).astype(f32) * f32(10.0) ** g.integers(
            -8, 8, m).astype(f32) for _ in range(3)]
    if kind == "subnormal":         # results below 2^-126
        a = (g.uniform(1, 2, m) * 2.0 ** -75).astype(f32)
        b = (g.uniform(-2, 2, m) * 2.0 ** -70).astype(f32)
        c = g.integers(1, 1 << 23, m).astype(np.int32).view(f32)
        return a, b, c * np.where(g.random(m) < 0.5, f32(-1), f32(1))
    if kind == "nonfinite":
        vals = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1.0, -2.0,
                         3.4e38, 1e-45], f32)
        a, b, c = np.meshgrid(vals, vals, vals, indexing="ij")
        return a.ravel(), b.ravel(), c.ravel()
    # c with a random mantissa, a b half an ulp of c (exactly: "halfway",
    # or less 2^-46 of it: "near_halfway", where rounding a b + c to
    # float64 first lands on the tie and then rounds the wrong way)
    c = (g.uniform(1, 2, m) * 2.0 ** g.integers(-20, 20, m)).astype(f32)
    c = c * np.where(g.random(m) < 0.5, f32(-1), f32(1))
    h = (np.spacing(np.abs(c)) / 2).astype(f32)
    sign = np.where(g.random(m) < 0.5, f32(-1), f32(1))
    if kind == "halfway":
        return np.ones(m, f32), sign * h, c
    return (np.full(m, 1 + 2.0 ** -23, f32),
            (sign * h * f32(1 - 2.0 ** -23)).astype(f32), c)


@pytest.mark.parametrize("kind", ["random", "halfway", "near_halfway",
                                  "subnormal", "nonfinite"])
def test_twin_fma_is_the_rounded_exact_product(kind):
    """The twin's _fma is the float32 fused multiply-add of the kernel's
    __fmaf_rn: the exact a b + c rounded once, to nearest even."""
    a, b, c = _fma_inputs(kind, rng(len(kind)))
    got = n(bt._fma(t(a), t(b), t(c)))
    want = np.array([_fma_exact(*x) for x in zip(a, b, c)], np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))
    if kind == "near_halfway":      # float64 rounding first would differ
        old = (a.astype(np.float64) * b + c).astype(np.float32)
        assert (old.view(np.int32) != want.view(np.int32)).any()


def test_lbvh_shapes_and_bounds():
    tris = random_tris(rng(1), 37)
    b = lbvh.build_lbvh(t(tris), leaf_size=4)
    assert b.num_leaves == 16 and b.node_lo.shape == (31, 3)
    ids = n(b.tri_id)
    assert sorted(ids[ids >= 0].tolist()) == list(range(37))
    np.testing.assert_allclose(n(b.node_lo[0]), tris.reshape(-1, 3).min(0))
    np.testing.assert_allclose(n(b.node_hi[0]), tris.reshape(-1, 3).max(0))


def _check_invariants(b, count):
    lo, hi, c0, c1 = n(b.node_lo), n(b.node_hi), n(b.child0), n(b.child1)
    for i in range(b.num_nodes):
        if c0[i] < 0:
            continue
        for c in (c0[i], c1[i]):
            if np.all(np.isfinite(lo[c])):
                assert np.all(lo[i] <= lo[c] + 1e-5)
                assert np.all(hi[i] >= hi[c] - 1e-5)
    ids = n(b.tri_id)
    assert sorted(ids[ids >= 0].tolist()) == list(range(count))
    leaves = sorted((-c0[c0 < 0] - 1).tolist())
    assert leaves == list(range(b.num_leaves))


def test_native_builder_compiles_and_holds_invariants():
    so = bvh_native.build_library()
    assert so.exists() and so.parent == bvh_native.BUILD_DIR
    g = rng(5)
    tris = random_tris(g, 123)
    b = sah.build_sah(tris, leaf_size=4)
    # the native partition, not numpy's (C-8), from the port's own build
    assert b.num_nodes == len(bvh_native.build_sah(tris, 4)[2])
    _check_invariants(b, 123)
    o, d = random_rays(g, 256)
    got = traverse.intersect_closest(b, t(o), t(d), 1e-4, 1e9)
    ref = brute.intersect_closest(t(tris), t(o), t(d), 1e-4, 1e9)
    assert (n(got["tri"]) == n(ref["tri"])).mean() > 0.99
    both = (n(got["tri"]) >= 0) & (n(ref["tri"]) >= 0)
    np.testing.assert_allclose(n(got["t"])[both], n(ref["t"])[both],
                               rtol=1e-4, atol=1e-5)


def test_build_sah_falls_back_to_numpy_with_a_warning(monkeypatch, caplog):
    def broken(*a, **k):
        raise RuntimeError("no compiler here")

    monkeypatch.setattr(bvh_native, "build_sah", broken)
    tris = random_tris(rng(7), 64)
    with caplog.at_level(logging.WARNING):
        b = sah.build_sah(tris, leaf_size=4)
    assert any("no compiler here" in r.getMessage() for r in caplog.records)
    for f in FIELDS:
        assert torch.equal(getattr(b, f),
                           getattr(_port_sah_numpy(tris, 4), f)), f


def _hold_walks(jb, pb, o, d, t_min, t_max):
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    ref = jtraverse.intersect_closest(jb, jo, jd, t_min, t_max)
    got = traverse.intersect_closest_ref(pb, t(o), t(d), t_min, t_max)
    np.testing.assert_array_equal(n(got["tri"]), np.asarray(ref["tri"]))
    hits = np.asarray(ref["tri"]) >= 0
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(n(got[k]), np.asarray(ref[k]), rtol=0,
                                   atol=ATOL, err_msg=k)
        # the twin's fused products are XLA's: on the hits, bit for bit
        np.testing.assert_array_equal(n(got[k])[hits].view(np.int32),
                                      np.asarray(ref[k])[hits].view(np.int32),
                                      err_msg=k)
    hit_ref = np.asarray(jtraverse.intersect_any(jb, jo, jd, t_min, t_max))
    np.testing.assert_array_equal(
        n(traverse.intersect_any_ref(pb, t(o), t(d), t_min, t_max)), hit_ref)
    return got


@pytest.mark.parametrize("builder", ["lbvh", "sah"])
@pytest.mark.parametrize("count,leaf_size", [(12, 1), (100, 4), (333, 8)])
def test_walk_matches_jax(builder, count, leaf_size, monkeypatch):
    g = rng(count + leaf_size)
    tris = random_tris(g, count)
    o, d = random_rays(g, 256)
    jb, pb = _pair(builder, tris, leaf_size, monkeypatch)
    got = _hold_walks(jb, pb, o, d, 1e-4, 1e9)
    assert (n(got["tri"]) >= 0).any()
    _hold_walks(jb, pb, o, d, 1e-4, 4.0)        # the occlusion window


def test_walk_tmax_window_matches_jax():
    g = rng(60)
    tris = random_tris(g, 60)
    o, d = random_rays(g, 128)
    jb = jlbvh.build_lbvh(jnp.asarray(tris))
    pb = lbvh.build_lbvh(t(tris))
    full = _hold_walks(jb, pb, o, d, 1e-4, 1e9)
    hit = np.isfinite(n(full["t"]))
    cap = np.where(hit, n(full["t"]) * 0.5, 1e9).astype(np.float32)
    capped = _hold_walks(jb, pb, o, d, 1e-4, cap)
    assert (n(capped["tri"])[hit] == -1).all()


def test_walk_single_and_degenerate_triangles():
    tris = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                     [[0, 0, 0], [0, 0, 0], [0, 0, 0]]], np.float32)
    o = np.array([[0.2, 0.2, 1.0], [5.0, 5.0, 1.0]], np.float32)
    d = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], np.float32)
    jb = jlbvh.build_lbvh(jnp.asarray(tris), leaf_size=2)
    pb = lbvh.build_lbvh(t(tris), leaf_size=2)
    got = _hold_walks(jb, pb, o, d, 1e-4, 1e9)
    assert n(got["tri"]).tolist() == [0, -1]
    np.testing.assert_allclose(n(got["t"])[0], 1.0, atol=1e-5)


def test_walk_above_big_takes_leaf_zero_as_jax_does():
    """ROADMAP C-22: with t_max above BIG (3.4e38) every node offers its
    BIG slots as a hit, so both walks return leaf 0's slot 0 where they
    find nothing nearer."""
    g = rng(50)
    tris = random_tris(g, 50)
    o, d = random_rays(g, 256)
    jb = jlbvh.build_lbvh(jnp.asarray(tris))
    pb = lbvh.build_lbvh(t(tris))
    got = _hold_walks(jb, pb, o, d, 1e-4, np.inf)
    ref = traverse.intersect_closest(pb, t(o), t(d), 1e-4, 1e9)
    fake = (n(got["tri"]) >= 0) & (n(ref["tri"]) < 0)
    assert fake.any() and (n(got["tri"])[fake] == n(pb.tri_id)[0]).all()


def test_walk_counts_and_wrapper_checks():
    g = rng(3)
    tris = random_tris(g, 100)
    o, d = random_rays(g, 64)
    b = sah.build_sah(tris)
    counts = torch.zeros((64, 2), dtype=torch.int32)
    tn = torch.full((64,), 1e-4)
    tx = torch.full((64,), 1e9)
    _, tri, _, _ = bt.bvh_traverse(b, t(o), t(d), tn, tx, any_hit=False,
                                   counts=counts)
    c = n(counts)
    assert (c[n(tri) >= 0, 1] >= 1).all()         # a hit pops its leaf
    assert (c >= 0).all() and c[:, 0].max() >= b.max_depth - 1
    bt.reset_launches()
    assert bt.LAUNCHES == {"closest": 0, "any": 0}  # the twin counts none
    with pytest.raises(ValueError):
        bt.bvh_traverse(b, t(o)[:, :2].contiguous(), t(d), tn, tx,
                        any_hit=True)
    with pytest.raises(ValueError):
        bt.bvh_traverse(b.to("meta"), t(o).to("meta"), t(d).to("meta"),
                        tn.to("meta"), tx.to("meta"), any_hit=True)


@pytest.mark.parametrize("accel", ["sah", "lbvh"])
def test_cornell_primary_hits_equal_brute(accel):
    """tests/test_bvh.py:122 on the port: the BVH's primary hits equal
    brute force's, and the JAX LBVH's."""
    jb, jcamf = jpresets.cornell_box()
    jo, jd = jprimary(jcamf(1.0), 48, 48, jnp.uint32(0), jitter="center")
    sc = presets.cornell_box()[0].build()
    o, d = t(np.asarray(jo)), t(np.asarray(jd))
    b = (sah.build_sah(sc.tri_pos) if accel == "sah"
         else lbvh.build_lbvh(sc.tri_pos))
    got = traverse.intersect_closest(b, o, d, 1e-3, 1e9)
    ref = brute.intersect_closest(sc.tri_pos, o, d, 1e-3, 1e9)
    same = n(got["tri"]) == n(ref["tri"])
    assert same.mean() > 0.995
    np.testing.assert_allclose(n(got["t"])[same & (n(got["tri"]) >= 0)],
                               n(ref["t"])[same & (n(ref["tri"]) >= 0)],
                               rtol=1e-4)
    if accel == "lbvh":
        jref = jtraverse.intersect_closest(
            jlbvh.build_lbvh(jb.build().tri_pos), jo, jd, 1e-3, 1e9)
        np.testing.assert_array_equal(n(got["tri"]), np.asarray(jref["tri"]))


@pytest.mark.parametrize("accel", ["sah", "bvh", "lbvh"])
def test_cornell_frames_equal_brute(accel):
    """tests/test_renderer.py:60 on the port: the same seed through a BVH
    and through brute force gives the same image."""
    b, camf = presets.cornell_box(bsdf_extras=True)
    sc, cam = b.build(), camf(1.0)
    cfg = RenderConfig(width=24, height=24, max_depth=3)
    r = Renderer(sc, cfg, accel=accel, device="cpu")
    assert r.bvh is not None and r.bvh.leaf_size == 4
    img = r.render(cam, spp=4, seed=5)
    ref = Renderer(sc, cfg, accel="brute", device="cpu").render(cam, spp=4,
                                                                 seed=5)
    np.testing.assert_allclose(img, ref, rtol=1e-3, atol=5e-3)
    assert img.mean() > 0.05
    assert not r.frame_stats["overflow"]


def test_port_camera_rays_feed_the_walk():
    """The primary rays' origins are a broadcast view; the walk takes
    them as they come."""
    jb, jcamf = jpresets.cornell_box()
    cam = port_camera(jcamf(1.0))
    sc = presets.cornell_box()[0].build()
    from lumenrenderer_tpu_torch.core.camera import generate_primary_rays

    o, d = generate_primary_rays(cam, 8, 8, 0, jitter="center")
    assert not o.is_contiguous()
    got = traverse.intersect_any(sah.build_sah(sc.tri_pos), o, d, 1e-3, 1e9)
    assert got.dtype == torch.bool and bool(got.all())


def test_cli_renders_through_a_bvh_config(tmp_path, capsys):
    from lumenrenderer_tpu_torch.app import cli
    from lumenrenderer_tpu_torch.utils.config import AppConfig

    cfg = AppConfig(accel="lbvh")
    cfg.save(str(tmp_path / "app.json"))
    out = tmp_path / "o.png"
    assert cli.main([str(tmp_path / "app.json"), "--preset", "cornell",
                     "--size", "16x16", "--out-size", "16x16", "--spp", "1",
                     "--depth", "2", "--cpu", "-o", str(out)]) == 0
    assert "accel=lbvh" in capsys.readouterr().err and out.exists()
