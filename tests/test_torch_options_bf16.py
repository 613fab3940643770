"""PyTorch port, the bf16 candidate mode of kernels K1, K2 and K3
(precision="default", the TPU's one bf16 MXU pass), on the CPU.

On the CPU, JAX's Precision.DEFAULT is exact float32, so a Pallas run in
interpret mode at "default" is no reference for the bf16 mode. The
references:
- K1 and K3: the Pallas kernel in interpret mode at precision="highest" on
  inputs rounded to bfloat16 (the rays' ten features and the coefficient
  table; t_min, t_max stay float32). A product of two bfloat16 values is
  exact in float32, so this is the TPU's one-pass product.
- K2: the features are formed inside the kernel, so the reference is built
  here in jnp: each visit's object-space features by the arithmetic of
  `ops/pallas/instanced.py:81-93`, rounded to bfloat16, times the rounded
  table (an einsum at HIGHEST), then the kernel's sign-normalised hit test
  and packed key (t by an exact division).
Tolerances: occlusion bits bit for bit; K1's and K3's keys bit for bit or
a tie within the key's t quantum plus the Pallas kernel's 2^-16
reciprocal error (its t comes from an approximate reciprocal and one
Newton step), with the winner's visit and slot fields equal on >= 99% of
the rays that both hit. K2's twin sums as the tensor cores do
(`mma_product`), not as the einsum's float32 sum, so the two may differ in
the last bits of a sum; on this test's rays no key moves, and its keys are
held bit for bit (`test_torch_bf16_mma_instanced.py` holds other rays to
the tie bar, and the kernel's data flow to the twin bit for bit). Visit
lists uncapped and capped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import (jax_instanced_builder, n, port_clusters,
                                 rng, t)

from lumenrenderer_tpu.accel import stream as jstream, tiled as jtiled
from lumenrenderer_tpu.accel import two_level as jtwo
from lumenrenderer_tpu.ops.pallas import intersect as jpk
from lumenrenderer_tpu.ops.pallas import pair_intersect as jppk
from lumenrenderer_tpu_torch.accel import pairs as ppairs
from lumenrenderer_tpu_torch.accel import tiled as ptiled
from lumenrenderer_tpu_torch.accel import two_level as ptwo
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.ops import pair_scan as pps
from lumenrenderer_tpu_torch.ops import visit_scan as pvs
from lumenrenderer_tpu_torch.ops import visit_scan_instanced as pvsi
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets

KEY_MISS = pvs.KEY_MISS


def bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def random_tris(g, count, spread=2.5):
    c = g.uniform(-spread, spread, size=(count, 1, 3))
    return (c + g.normal(size=(count, 3, 3)) * 0.2).astype(np.float32)


def aimed_rays(g, tris, count, spread=4.0):
    o = g.uniform(-spread, spread, size=(count, 3)).astype(np.float32)
    aim = tris[g.integers(0, len(tris), count)].mean(1)
    d = aim + g.normal(size=(count, 3)) * 0.1 - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def _same_or_tie(got, ref, low_bits):
    """Keys equal, or both hits within the key's t quantum plus 2^-16 of
    the Pallas t; the winners' visit and slot fields equal on >= 99%."""
    low_mask = ~((1 << low_bits) - 1)
    t_of = lambda key: (key & low_mask).astype(np.int32).view(np.float32)
    both = (ref < KEY_MISS) & (got < KEY_MISS)
    rel = 2.0 ** -(23 - low_bits) + 2.0 ** -16
    quantum = np.maximum(t_of(got), t_of(ref)) * rel
    tie = both & (np.abs(t_of(got) - t_of(ref)) <= quantum)
    assert ((got == ref) | tie).all()
    assert ((got & ~low_mask) == (ref & ~low_mask))[both].mean() >= 0.99
    assert both.sum() > 100


def _k1_inputs(g, cs, tris, mv, r=1024):
    """K1's inputs as JAX's tiled._query builds them (8 tiles), frustum
    lists capped at mv."""
    o, d = aimed_rays(g, tris, r)
    tn = np.full(r, 1e-4, np.float32)
    tx = np.where(np.arange(r) % 7 == 0, -1.0, 1e9).astype(np.float32)
    tiles = r // 128
    order, valid, tnear, _ = jtiled._frustum_visits(
        cs, *map(jnp.asarray, (o, d, tn, tx)), tiles, mv)
    rf = np.asarray(jstream.ray_features(jnp.asarray(o), jnp.asarray(d)))
    rf_t = np.concatenate([rf, tn[:, None], tx[:, None]], 1).reshape(
        tiles, 128, 12).astype(np.float32)
    bits = np.maximum(np.asarray(tnear), 0).astype(np.float32).view(np.int32)
    tnb = np.where(np.asarray(valid), np.minimum(bits, KEY_MISS - 1),
                   KEY_MISS).astype(np.int32)
    return (rf_t, np.asarray(order, np.int32),
            np.asarray(valid).sum(1).astype(np.int32), tnb)


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("closest", [True, False])
def test_k1_bf16_twin_matches_rounded_pallas(closest, capped):
    g = rng(40)
    tris = random_tris(g, 400)
    cs = jstream.build_clusters(jnp.asarray(tris), cluster_size=32)
    mv = cs.num_clusters // 3 if capped else cs.num_clusters
    rf_t, sel, nv, tnb = _k1_inputs(g, cs, tris, mv)
    k_bits, _, low_bits = ptiled.key_bits(32, mv)
    kw = dict(k=32, mv=mv, k_bits=k_bits, low_bits=low_bits, closest=closest)
    rf_r = rf_t.copy()
    rf_r[..., :10] = bf16(rf_t[..., :10])
    ref = np.asarray(jpk.visit_scan(
        jnp.asarray(rf_r), jnp.asarray(bf16(cs.tri_feat)), cs.tri_id,
        jnp.asarray(sel), jnp.asarray(nv), jnp.asarray(tnb), interpret=True,
        precision="highest", **kw))
    args = (t(rf_t), t(cs.tri_feat), t(sel), t(nv), t(tnb))
    got = n(pvs.visit_scan_ref(*args, **kw, precision="default"))
    # the wrapper on CPU tensors: the twin, uncounted, its counter the
    # replay's
    pvs.reset_launches()
    visits = torch.empty(rf_t.shape[0], dtype=torch.int32)
    out = pvs.visit_scan(*args, **kw, precision="default", visits=visits)
    assert torch.equal(out, t(got))
    assert torch.equal(visits, pvs.executed_visits_ref(
        *args, **kw, precision="default"))
    assert pvs.LAUNCHES_BF16 == {"closest": 0, "any": 0}
    fp32 = n(pvs.visit_scan_ref(*args, **kw))
    if closest:
        _same_or_tie(got, ref, low_bits)
    else:
        np.testing.assert_array_equal(got, ref)
        assert ref.sum() > 100
    assert (got != fp32).any()            # bf16 is its own mode


def stacked_tris(g, m=256, dx=1e-3):
    """m triangles facing +x, 1e-3 apart along x with 1e-4 of jitter, their
    y, z corners scattered: bf16-rounded, a later cluster's triangles often
    lie nearer than that cluster's fp32 box."""
    tris = np.zeros((m, 3, 3), np.float32)
    tris[:, :, 0] = (1.0 + dx * np.arange(m))[:, None]
    tris[:, :, 1:] = np.float32([[-3, -3], [3, -3], [0, 4]])
    tris[:, :, 1:] += g.uniform(-0.9, 0.9, size=(m, 3, 2))
    tris[:, :, 0] += g.normal(size=(m, 3)) * 0.1 * dx
    return tris


def test_k1_bf16_vote_keeps_hits_nearer_than_their_box():
    """Rays head-on into a stack of triangles: many bf16 winners lie nearer
    than the entry t of their own cluster, where the fp32 vote would have
    ended the tile. The bf16 vote ends a tile only when its lanes are dead,
    so every tile runs all its visits and the keys are the full scan's:
    never farther than JAX's, and nearer where JAX's entry-t check, every
    4 visits, drops such a hit (ROADMAP C-25)."""
    g = rng(0)
    tris = stacked_tris(g)
    cs = jstream.build_clusters(jnp.asarray(tris), cluster_size=32)
    r, mv = 1024, cs.num_clusters
    o = np.zeros((r, 3), np.float32)
    o[:, 1:] = g.uniform(-1, 1, (r, 2))
    d = np.tile(np.float32([1, 0, 0]), (r, 1))
    tn, tx = np.full(r, 1e-4, np.float32), np.full(r, 1e9, np.float32)
    order, valid, tnear, _ = jtiled._frustum_visits(
        cs, *map(jnp.asarray, (o, d, tn, tx)), r // 128, mv)
    rf = np.asarray(jstream.ray_features(jnp.asarray(o), jnp.asarray(d)))
    rf_t = np.concatenate([rf, tn[:, None], tx[:, None]], 1).reshape(
        -1, 128, 12)
    tnb = np.asarray(tnear).astype(np.float32).view(np.int32)
    sel = np.asarray(order, np.int32)
    nv = np.asarray(valid).sum(1).astype(np.int32)
    k_bits, _, low_bits = ptiled.key_bits(32, mv)
    kw = dict(k=32, mv=mv, k_bits=k_bits, low_bits=low_bits, closest=True)
    args = (t(rf_t), t(cs.tri_feat), t(sel), t(nv), t(tnb))
    got = n(pvs.visit_scan_ref(*args, **kw, precision="default"))
    visit = (got >> k_bits) & ((1 << (low_bits - k_bits)) - 1)
    entry = np.take_along_axis(tnb, visit, 1) >> low_bits
    fp32_ran = n(pvs.executed_visits_ref(*args, **kw))[:, None]
    cut = ((got >> low_bits) < entry) & (visit >= fp32_ran)
    assert (got < KEY_MISS).all() and cut.sum() > 100
    np.testing.assert_array_equal(
        n(pvs.executed_visits_ref(*args, **kw, precision="default")), nv)
    rf_r = rf_t.copy()
    rf_r[..., :10] = bf16(rf_t[..., :10])
    ref = np.asarray(jpk.visit_scan(
        jnp.asarray(rf_r), jnp.asarray(bf16(cs.tri_feat)), cs.tri_id,
        jnp.asarray(sel), jnp.asarray(nv), jnp.asarray(tnb), interpret=True,
        precision="highest", **kw))
    low_mask = ~((1 << low_bits) - 1)
    t_of = lambda key: (key & low_mask).astype(np.int32).view(np.float32)
    quantum = t_of(ref) * (2.0 ** -(23 - low_bits) + 2.0 ** -16)
    assert (t_of(got) <= t_of(ref) + quantum).all()
    # the hits JAX drops: a whole key step nearer (t fields 0.99902 and 1)
    assert ((got >> low_bits) < (ref >> low_bits)).sum() > 10


def _k2_inputs(ics, o, d, tn, tx, mv):
    """K2's inputs as JAX's two_level._query builds them (8 tiles)."""
    r = o.shape[0]
    tiles = r // 128
    sel, valid, tnear, _ = jtiled._frustum_visits(
        ics, *map(jnp.asarray, (o, d, tn, tx)), tiles, mv)
    sel, valid, tnear = map(np.asarray, (sel, valid, tnear))
    rayblk = np.concatenate([o, d, np.zeros((r, 2), np.float32)], 1
                            ).reshape(tiles, 128, 8).transpose(0, 2, 1)
    wnd = np.concatenate([tn[:, None], tx[:, None],
                          np.zeros((r, 6), np.float32)], 1
                         ).reshape(tiles, 128, 8)
    bits = np.maximum(tnear, 0).astype(np.float32).view(np.int32)
    tnb = np.where(valid, np.minimum(bits, KEY_MISS - 1),
                   KEY_MISS).astype(np.int32)
    minv12 = np.asarray(ics.inst_minv).reshape(-1, 12)[
        np.asarray(ics.unit_inst)[sel]]
    sel_cl = np.asarray(ics.unit_cluster)[sel].astype(np.int32)
    return (np.ascontiguousarray(rayblk), wnd, np.asarray(ics.tri_feat),
            sel_cl, np.ascontiguousarray(minv12, np.float32),
            valid.sum(1).astype(np.int32), tnb)


def _k2_bf16_reference(rayblk, wnd, feats, sel_cl, minv12, nv, *, k, mv,
                       k_bits, low_bits, closest):
    """K2's bf16 mode in jnp: instanced.py:81-93's features, rounded to
    bfloat16, times the rounded table, the sign-normalised test."""
    rb = jnp.asarray(rayblk)
    ox, oy, oz, dx, dy, dz = (rb[:, f] for f in range(6))
    tmin, tmax = jnp.asarray(wnd[..., 0:1]), jnp.asarray(wnd[..., 1:2])
    dead = wnd[..., 1] < wnd[..., 0]
    fr = jnp.asarray(bf16(feats))
    kid = jnp.arange(k, dtype=jnp.int32)
    low_mask = ~((1 << low_bits) - 1)
    best = jnp.full(dead.shape, KEY_MISS, jnp.int32)
    occ = jnp.asarray(dead)
    for i in range(mv):
        m = [jnp.asarray(minv12[:, i, j])[:, None] for j in range(12)]
        oox = m[0] * ox + m[1] * oy + m[2] * oz + m[3]
        ooy = m[4] * ox + m[5] * oy + m[6] * oz + m[7]
        ooz = m[8] * ox + m[9] * oy + m[10] * oz + m[11]
        ddx = m[0] * dx + m[1] * dy + m[2] * dz
        ddy = m[4] * dx + m[5] * dy + m[6] * dz
        ddz = m[8] * dx + m[9] * dy + m[10] * dz
        rf = jnp.stack([ooy * ddz - ooz * ddy, ooz * ddx - oox * ddz,
                        oox * ddy - ooy * ddx, ddx, ddy, ddz, oox, ooy, ooz,
                        jnp.ones_like(oox)], -1)
        rf = rf.astype(jnp.bfloat16).astype(jnp.float32)
        res = jnp.einsum("trf,tfc->trc", rf, fr[sel_cl[:, i]],
                         precision=jax.lax.Precision.HIGHEST)
        det, un, vn, tn_ = (res[..., q * k:(q + 1) * k] for q in range(4))
        s = jnp.sign(det)
        ad, us, vs, ts = det * s, un * s, vn * s, tn_ * s
        hit = ((ad > 1e-12) & (us >= 0) & (vs >= 0) & (us + vs <= ad)
               & (ts > tmin * ad) & (ts <= tmax * ad)
               & jnp.asarray(i < nv)[:, None, None])
        if closest:
            tb = jax.lax.bitcast_convert_type(
                jnp.maximum(ts / jnp.where(ad > 1e-12, ad, 1.0), 0.0),
                jnp.int32)
            key = jnp.where(hit, (tb & low_mask) | (i << k_bits) | kid,
                            KEY_MISS)
            best = jnp.minimum(best, key.min(-1))
        else:
            occ = occ | hit.any(-1)
    if closest:
        return np.where(dead, 0, np.asarray(best))
    return np.asarray(occ).astype(np.int32)


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("closest", [True, False])
def test_k2_bf16_twin_matches_jnp_reference(closest, capped):
    jb = jax_instanced_builder(n_inst=12)
    ics = jtwo.build_instanced(*ptwo.instance_tables(jb.instances),
                               cluster_size=32)
    g = rng(41)
    r = 1024
    o = g.uniform(-4, 4, (r, 3)).astype(np.float32)
    aim = g.uniform(-3, 3, (r, 3)).astype(np.float32)
    d = (aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
    tn = np.full(r, 1e-3, np.float32)
    tx = np.where(np.arange(r) % 9 == 0, -1.0, 1e8).astype(np.float32)
    mv = 4 if capped else ics.num_clusters
    args = _k2_inputs(ics, o, d.astype(np.float32), tn, tx, mv)
    k_bits, _, low_bits = ptiled.key_bits(32, mv)
    kw = dict(k=32, mv=mv, k_bits=k_bits, low_bits=low_bits, closest=closest)
    ref = _k2_bf16_reference(*args[:6], **kw)
    targs = tuple(map(t, args))
    got = n(pvsi.visit_scan_instanced_ref(*targs, **kw, precision="default"))
    np.testing.assert_array_equal(got, ref)
    assert ((ref > 0) & (ref < KEY_MISS)).sum() > 50
    visits = torch.empty(args[0].shape[0], dtype=torch.int32)
    out = pvsi.visit_scan_instanced(*targs, **kw, precision="default",
                                    visits=visits)
    assert torch.equal(out, t(got))
    assert torch.equal(visits, pvsi.executed_visits_instanced_ref(
        *targs, **kw, precision="default"))


@pytest.mark.parametrize("closest", [True, False])
def test_k3_bf16_twin_matches_rounded_pallas(closest):
    g = rng(42)
    tris = random_tris(g, 600)
    cs = jstream.build_clusters(jnp.asarray(tris), cluster_size=32)
    o, d = aimed_rays(g, tris, 1500)
    tx = np.where(np.arange(1500) % 9 == 0, -1.0,
                  1e8 if closest else 2.0).astype(np.float32)
    q = ppairs.scan_inputs(port_clusters(cs), t(o), t(d), 1e-3, t(tx), 128,
                           16)
    rf_pairs, feats, tile_cluster = map(n, q["args"])
    kw = dict(q["kw"], closest=closest)
    rf_r = rf_pairs.copy()
    rf_r[:, :10] = bf16(rf_pairs[:, :10])
    ref = np.asarray(jppk.pair_scan(jnp.asarray(rf_r),
                                    jnp.asarray(bf16(feats)),
                                    jnp.asarray(tile_cluster), interpret=True,
                                    precision="highest", **kw))
    got = n(pps.pair_scan(*q["args"], **kw, precision="default"))
    if closest:
        _same_or_tie(got, ref, kw["k_bits"])
    else:
        np.testing.assert_array_equal(got, ref)
        assert ref.sum() > 100


def test_bf16_layout_and_precision_checks():
    g = rng(43)
    cs = jstream.build_clusters(jnp.asarray(random_tris(g, 300)),
                                cluster_size=32)
    feats = t(cs.tri_feat)
    nlive = pvs.slab_layout(pvs.round_bf16(feats), 32)[1]
    assert torch.equal(nlive, pvs.slab_layout(feats, 32)[1])
    rf_t, sel, nv, tnb = _k1_inputs(g, cs, random_tris(g, 10), 8, r=256)
    k_bits, _, low_bits = ptiled.key_bits(32, 8)
    args = (t(rf_t), feats, t(sel), t(nv), t(tnb))
    kw = dict(k=32, mv=8, k_bits=k_bits, low_bits=low_bits, closest=True)
    pvs.visit_scan(*args, **kw, precision="high")       # "high" is fp32
    with pytest.raises(ValueError):
        pvs.visit_scan(*args, **kw, precision="low")
    with pytest.raises(ValueError):                     # an fp32 layout
        pvs.visit_scan(*args, **kw, precision="default",
                       layout=pvs.slab_layout(feats, 32))
    with pytest.raises(ValueError):
        ptiled.tiled_intersectors(port_clusters(cs), 8,
                                  candidate_dtype="float16")


def test_renderer_bf16_frame_runs_k1_in_bf16(monkeypatch):
    b, camf = presets.cornell_box(bsdf_extras=True)
    sc, cam = b.build(), camf(1.0)
    cfg = RenderConfig(width=32, height=32, max_depth=3)
    seen = []
    twin = pvs.visit_scan_ref

    def spy(*args, **kw):
        seen.append(kw["precision"])
        return twin(*args, **kw)

    monkeypatch.setattr(pvs, "visit_scan_ref", spy)
    means = {}
    for dtype in ("bfloat16", "high"):
        r = Renderer(sc, cfg, device="cpu", candidate_dtype=dtype)
        seen.clear()
        st, _ = r.render_frame(r.init_state(0), cam)
        assert set(seen) == {"default" if dtype == "bfloat16"
                             else "highest"}
        assert len(seen) == 2 * cfg.max_depth
        assert bool(torch.isfinite(st.accum).all())
        means[dtype] = float(st.accum.mean())
    # the twin path: the bf16 tiled intersectors give the frame's image
    r = Renderer(sc, cfg, device="cpu", candidate_dtype="bfloat16")
    isect, occl = ptiled.tiled_intersectors(
        r.clusters, r.max_visits, scan=twin, candidate_dtype="bfloat16",
        decode=False)
    o = torch.tensor([[0.0, 1.0, 3.0]]).expand(256, 3).contiguous()
    dirs = torch.nn.functional.normalize(
        torch.from_numpy(rng(44).normal(size=(256, 3)).astype(np.float32))
        + torch.tensor([0.0, 0.0, -2.0]), dim=-1)
    for a, b_ in ((r._isect(o, dirs, 1e-3, 1e9), isect(o, dirs, 1e-3, 1e9)),):
        assert torch.equal(a["tri"], b_["tri"]) and int((a["tri"] >= 0)
                                                       .sum()) > 20
    assert torch.equal(r._occl(o, dirs, 1e-3, 2.0), occl(o, dirs, 1e-3, 2.0))
    # bf16 geometry is lossy by design (phantom occlusions, other
    # winners): its frame is held to its twin path above, not to fp32's
    assert means["bfloat16"] > 0 and means["high"] > 0


def test_two_level_bf16_routes_to_k2_bf16():
    """ROADMAP C-23: JAX's two-level path asks K2 for "bfloat16", which
    its Pallas kernel does not know (KeyError) and its CPU scan runs as
    fp32; the port runs K2's bf16 mode."""
    b, camf = presets.instanced_boxes(n_inst=20)
    r = Renderer(b.build(), RenderConfig(width=32, height=32, max_depth=2),
                 accel="two_level", builder=b, device="cpu",
                 candidate_dtype="bfloat16")
    st, _ = r.render_frame(r.init_state(0), camf(1.0))
    assert bool(torch.isfinite(st.accum).all()) and float(
        st.accum.mean()) > 0
    o, d = aimed_rays(rng(45), np.zeros((1, 3, 3), np.float32), 512)
    tn, tx = torch.full((512,), 1e-3), torch.full((512,), 1e8)
    got = r._isect(t(o), t(d), tn, tx)
    mv = r.max_visits
    bf = ptwo._query(r.instanced, t(o), t(d), tn, tx, mv, True,
                     precision="default")
    fp = ptwo._query(r.instanced, t(o), t(d), tn, tx, mv, True,
                     precision="highest")
    assert torch.equal(got["tri"], bf["tri"]) and torch.equal(got["t"],
                                                              bf["t"])
    assert int((bf["tri"] >= 0).sum()) > 100
    assert not torch.equal(bf["t"], fp["t"])
