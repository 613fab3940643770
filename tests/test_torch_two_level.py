"""PyTorch port, two-level instancing and dynamic scenes, against the JAX
package, on the two-level test scene (`presets.instanced_boxes`, the JAX
package's `tests/test_two_level.py` scene).

- Scene, unit, BLAS and instance tables: equal, or within 1e-6 for float32
  values computed on both sides (per-triangle features compared through
  tri_id, because the two SAH builders may order a cluster differently).
- visit_scan_instanced_ref (K2's plain twin) against the Pallas kernel in
  interpret mode at precision="highest": closest keys equal or a tie within
  the key's t quantum; occlusion bits equal.
- The two-level intersector against JAX (Pallas, interpret mode) and the
  brute-force oracle, at tests/test_two_level.py's bars: hit mask equal,
  triangle equal on at least 99.5% of hits, occlusion equal.
- Refits and rebakes (float32 on both sides, different summation order):
  rtol and atol 1e-5.
- Frames: two-level against tiled within the JAX test's 2e-3 relative mean
  difference; against the JAX frame from the same uniforms on 99% of pixels
  within rtol 1e-3, as tests/test_torch_integrator.py holds the tiled frame.
"""
import logging

import _torch_port_helpers as helpers
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import (ListUniforms, jax_frame_uniforms, n,
                                 port_camera, port_clusters, port_instanced,
                                 port_scene, rng, t)

from lumenrenderer_tpu.accel import brute, stream as jstream
from lumenrenderer_tpu.accel import tiled as jtiled, two_level as jtwo
from lumenrenderer_tpu.core import transform as jtransform
from lumenrenderer_tpu.core.camera import Camera as JCamera
from lumenrenderer_tpu.integrator import wavefront as jwf
from lumenrenderer_tpu.ops.pallas import instanced as jpk
from lumenrenderer_tpu.scene.dynamic import DynamicScene as JDynamicScene
from lumenrenderer_tpu_torch.accel import tiled as ptiled, two_level as ptwo
from lumenrenderer_tpu_torch.core import transform as ptransform
from lumenrenderer_tpu_torch.core.camera import Camera
from lumenrenderer_tpu_torch.integrator import wavefront as pwf
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.ops import visit_scan_instanced as pvsi
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets
from lumenrenderer_tpu_torch.scene.dynamic import DynamicScene
from lumenrenderer_tpu_torch.scene.geometry import InstanceHost
from lumenrenderer_tpu_torch.scene.materials import MaterialSpec
from lumenrenderer_tpu_torch.scene.scene import SceneBuilder

K = 32


def _jax_ics(jb, k=K):
    return jtwo.build_instanced(*ptwo.instance_tables(jb.instances),
                                cluster_size=k)


def _rays(g, r, dead_every=0):
    o = g.uniform(-4, 4, (r, 3)).astype(np.float32)
    d = g.uniform(-1, 1, (r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tx = np.full(r, 1e8, np.float32)
    if dead_every:
        tx[::dead_every] = -1.0
    return o, d, tx


def test_preset_matches_jax_scene():
    jsc = helpers.jax_instanced_builder().build()
    psc = presets.instanced_boxes()[0].build()
    for f in ("tri_pos", "tri_normal", "tri_uv", "tri_mat", "tri_inst",
              "inst_emission_mode"):
        np.testing.assert_array_equal(n(getattr(psc, f)),
                                      np.asarray(getattr(jsc, f)), err_msg=f)
    np.testing.assert_array_equal(n(psc.lights.packed),
                                  np.asarray(jsc.lights.packed))


def test_build_instanced_matches_jax():
    jb = helpers.jax_instanced_builder()
    ref = _jax_ics(jb)
    got = ptwo.build_instanced(*ptwo.instance_tables(
        presets.instanced_boxes()[0].instances), cluster_size=K)
    assert got.tris_per_cluster == ref.tris_per_cluster
    assert got.tri_feat.shape[0] == 2      # one cluster per unique mesh
    for f in ("unit_inst", "unit_cluster", "inst_tri_base",
              "inst_cluster_base"):
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("aabb_lo", "aabb_hi", "obj_lo", "obj_hi", "inst_minv"):
        np.testing.assert_allclose(n(getattr(got, f)),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    # per-triangle coefficient columns, matched through tri_id (mesh-local
    # ids; each mesh here is one cluster)
    fg = n(got.tri_feat).reshape(-1, 10, 4, K)
    fr = np.asarray(ref.tri_feat).reshape(-1, 10, 4, K)
    ids_g, ids_r = n(got.tri_id), np.asarray(ref.tri_id)
    for c in range(ids_g.shape[0]):
        live = np.nonzero(ids_g[c] >= 0)[0]
        assert sorted(ids_g[c, live]) == sorted(ids_r[c][ids_r[c] >= 0])
        for j in live:
            jr = np.nonzero(ids_r[c] == ids_g[c, j])[0][0]
            np.testing.assert_allclose(fg[c, :, :, j], fr[c, :, :, jr],
                                       rtol=1e-6, atol=1e-6)


def _k2_inputs(ics, o, d, tn, tx):
    """K2's inputs as the JAX package's _query builds them (8-tile padded
    for the Pallas kernel)."""
    r = o.shape[0]
    pad = (-r) % 1024
    o = np.concatenate([o, np.zeros((pad, 3), np.float32)])
    d = np.concatenate([d, np.ones((pad, 3), np.float32)])
    tn = np.concatenate([tn, np.zeros(pad, np.float32)])
    tx = np.concatenate([tx, -np.ones(pad, np.float32)])
    rp = r + pad
    tiles = rp // 128
    mv = ics.num_clusters
    sel, valid, tnear, _ = jtiled._frustum_visits(
        ics, *map(jnp.asarray, (o, d, tn, tx)), tiles, mv)
    sel, valid, tnear = map(np.asarray, (sel, valid, tnear))
    rayblk = np.concatenate([o, d, np.zeros((rp, 2), np.float32)], 1
                            ).reshape(tiles, 128, 8).transpose(0, 2, 1)
    wnd = np.concatenate([tn[:, None], tx[:, None],
                          np.zeros((rp, 6), np.float32)], 1
                         ).reshape(tiles, 128, 8)
    nv = valid.sum(1).astype(np.int32)
    bits = np.maximum(tnear, 0).astype(np.float32).view(np.int32)
    tnb = np.where(valid, np.minimum(bits, jpk.KEY_MISS - 1),
                   jpk.KEY_MISS).astype(np.int32)
    minv12 = np.asarray(ics.inst_minv).reshape(-1, 12)[
        np.asarray(ics.unit_inst)[sel]]
    sel_cl = np.asarray(ics.unit_cluster)[sel].astype(np.int32)
    return (np.ascontiguousarray(rayblk), wnd, np.asarray(ics.tri_feat),
            sel_cl, minv12, nv, tnb), mv


@pytest.mark.parametrize("closest", [True, False])
def test_k2_twin_matches_pallas_interpret(closest):
    ics = _jax_ics(helpers.jax_instanced_builder())
    o, d, tx = _rays(rng(0), 1500, dead_every=9)
    if not closest:
        tx = np.where(tx > 0, 4.0, -1.0).astype(np.float32)
    args, mv = _k2_inputs(ics, o, d, np.full(1500, 1e-3, np.float32), tx)
    k_bits, _, low_bits = ptiled.key_bits(K, mv)
    kw = dict(k=K, mv=mv, k_bits=k_bits, low_bits=low_bits, closest=closest)
    ref = np.asarray(jpk.visit_scan_instanced(
        *map(jnp.asarray, args), interpret=True, precision="highest", **kw))
    got = n(pvsi.visit_scan_instanced_ref(*map(t, args), **kw))
    if not closest:
        np.testing.assert_array_equal(got, ref)
        assert ref.sum() > 100
        return
    low_mask = ~((1 << low_bits) - 1)
    t_of = lambda key: (key & low_mask).astype(np.int32).view(np.float32)
    both = (ref < jpk.KEY_MISS) & (got < jpk.KEY_MISS)
    quantum = np.maximum(t_of(got), t_of(ref)) * 2.0 ** -(23 - low_bits)
    tie = both & (np.abs(t_of(got) - t_of(ref)) <= quantum)
    assert ((got == ref) | tie).all()
    assert (ref < jpk.KEY_MISS).sum() > 100


def test_k2_wrapper_on_cpu_runs_the_twin_uncounted():
    ics = _jax_ics(helpers.jax_instanced_builder(n_inst=6))
    o, d, tx = _rays(rng(1), 200)
    args, mv = _k2_inputs(ics, o, d, np.full(200, 1e-3, np.float32), tx)
    args = tuple(map(t, args))
    k_bits, _, low_bits = ptiled.key_bits(K, mv)
    kw = dict(k=K, mv=mv, k_bits=k_bits, low_bits=low_bits, closest=True)
    pvsi.reset_launches()
    out = pvsi.visit_scan_instanced(*args, **kw)
    assert torch.equal(out, pvsi.visit_scan_instanced_ref(*args, **kw))
    assert pvsi.LAUNCHES == {"closest": 0, "any": 0}
    with pytest.raises(ValueError):          # minv12 of the wrong shape
        pvsi.visit_scan_instanced(*args[:4], args[4][..., :9], *args[5:],
                                  **kw)
    with pytest.raises(ValueError):          # rays not transposed
        pvsi.visit_scan_instanced(args[0].transpose(1, 2), *args[1:], **kw)


def test_instanced_intersectors_match_jax_and_brute():
    jb = helpers.jax_instanced_builder()
    flat = np.asarray(jb.build().tri_pos)
    ics = _jax_ics(jb)
    r = 1500
    o, d, tx = _rays(rng(0), r)
    ji, jo = jtwo.instanced_intersectors(ics, max_visits=128,
                                         precision="highest", use_pallas=True,
                                         interpret=True)
    ref_j = ji(o, d, 1e-3, jnp.asarray(tx))
    ref_b = brute.intersect_closest(flat, o, d, 1e-3, 1e8)
    occ_j = np.asarray(jo(o, d, 1e-3, jnp.full((r,), 4.0, jnp.float32)))
    occ_b = np.asarray(brute.intersect_any(flat, o, d, 1e-3, 4.0))
    hit_b = np.isfinite(np.asarray(ref_b["t"]))
    # the port on JAX's tables, and on its own build
    own = ptwo.build_instanced(*ptwo.instance_tables(
        presets.instanced_boxes()[0].instances), cluster_size=K)
    for ics_p in (port_instanced(ics), own):
        pi, po = ptwo.instanced_intersectors(ics_p, max_visits=128)
        got = pi(t(o), t(d), 1e-3, t(tx))
        assert not bool(got["overflow"])
        tri = n(got["tri"])
        np.testing.assert_array_equal(tri >= 0, hit_b)
        np.testing.assert_array_equal(tri >= 0, np.asarray(ref_j["tri"]) >= 0)
        for ref in (ref_b, ref_j):
            same = tri == np.asarray(ref["tri"])
            assert (same | ~hit_b).mean() > 0.995
        occ = n(po(t(o), t(d), 1e-3, torch.full((r,), 4.0)))
        np.testing.assert_array_equal(occ, occ_b)
        np.testing.assert_array_equal(occ, occ_j)
    assert hit_b.sum() > 100 and occ_b.sum() > 100


def test_refit_instances_matches_jax_and_rebuild():
    g = rng(2)
    meshes = [g.uniform(-0.5, 0.5, (30, 3, 3)).astype(np.float32)]
    tfs = []
    for _ in range(6):
        m4 = np.eye(4, dtype=np.float32)
        m4[:3, 3] = g.uniform(-2, 2, 3)
        tfs.append(m4)
    tfs2 = [m.copy() for m in tfs]
    tfs2[2][:3, 3] += [0.7, -0.3, 0.2]
    tfs2[4][:3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]]) * 1.3
    jics = jtwo.build_instanced(meshes, [0] * 6, tfs, cluster_size=K)
    ref = jtwo.refit_instances(jics, jnp.asarray(np.stack(tfs2)))
    got = ptwo.refit_instances(port_instanced(jics),
                               torch.from_numpy(np.stack(tfs2)))
    rebuilt = ptwo.build_instanced(meshes, [0] * 6, tfs2, cluster_size=K)
    for f in ("aabb_lo", "aabb_hi", "inst_minv"):
        for other in (np.asarray(getattr(ref, f)), n(getattr(rebuilt, f))):
            np.testing.assert_allclose(n(getattr(got, f)), other, rtol=1e-5,
                                       atol=1e-5, err_msg=f)


def test_two_level_frame_matches_tiled():
    b, camf = presets.instanced_boxes()
    sc = b.build()
    cfg = RenderConfig(width=64, height=64, max_depth=3, bsdf="lambert",
                       light_strategy="nee", sort_secondary=False)
    r_flat = Renderer(sc, cfg, accel="tiled", cluster_size=K, device="cpu")
    r_inst = Renderer(sc, cfg, accel="two_level", cluster_size=K, builder=b,
                      device="cpu")
    assert r_inst.max_visits == 21 and r_inst.clusters is None
    img_a = r_flat.render(camf(1.0), spp=4, seed=1)
    img_b = r_inst.render(camf(1.0), spp=4, seed=1)
    assert img_a.mean() > 0.01
    diff = np.abs(img_a - img_b).mean() / (np.abs(img_a).mean() + 1e-6)
    assert diff < 2e-3, diff


def test_two_level_frame_matches_jax_with_same_uniforms():
    jb = helpers.jax_instanced_builder()
    sc = jb.build()
    cam = JCamera.look_at((0.0, 1.0, 9.0), (0.0, 0.0, 0.0), fov_y_deg=50.0,
                          aspect=1.0)
    w = h = 16
    cfg_kw = dict(width=w, height=h, max_depth=3, bsdf="disney",
                  light_strategy="mis", rr_start_depth=1)
    jcfg = jwf.RenderConfig(**cfg_kw)
    ics = _jax_ics(jb)
    ji, jo = jtwo.instanced_intersectors(ics, max_visits=ics.num_clusters,
                                         precision="highest")
    key = jax.random.PRNGKey(5)
    ref = jwf.render_wavefront(sc, ji, jo, cam, key, jnp.uint32(0), jcfg)
    pi, po = ptwo.instanced_intersectors(port_instanced(ics),
                                         ics.num_clusters)
    got = pwf.render_wavefront(
        port_scene(sc), pi, po, port_camera(cam),
        ListUniforms(jax_frame_uniforms(key, jcfg, w * h)), 0,
        pwf.RenderConfig(**cfg_kw))
    img_j = np.asarray(jwf.merge_channels(ref))
    img_p = n(pwf.merge_channels(got))
    assert img_j.mean() > 0.01
    ok = np.isclose(img_p, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    for aov in ("depth", "normal"):
        good = np.isclose(n(got[aov]), np.asarray(ref[aov]), rtol=1e-4,
                          atol=1e-5).reshape(w * h, -1).all(-1)
        assert good.mean() >= 0.99, aov
    assert not bool(got["overflow"]) and not bool(ref["overflow"])


def test_dynamic_instance_move_via_tlas():
    """Moving an instance refits the TLAS (O(units)) and the image follows:
    it changes, and equals a fresh build at the new transform."""
    b, camf = presets.instanced_boxes(n_inst=8)
    dyn = DynamicScene(b)
    cfg = RenderConfig(width=48, height=48, max_depth=2, bsdf="lambert",
                       light_strategy="nee", sort_secondary=False)
    cam = camf(1.0)
    r = Renderer(dyn.build(), cfg, accel="two_level", cluster_size=K,
                 builder=b, dynamic=dyn, device="cpu")
    st, _ = r.render_frame(r.init_state(0), cam)
    img0 = n(st.accum)
    assert "Rebake Time" in r.frame_stats and not dyn.dirty
    dyn.transform(0).translation = (50.0, 0.0, 0.0)
    assert dyn.dirty
    st, _ = r.render_frame(r.init_state(0), cam)
    img1 = n(st.accum)
    assert not np.allclose(img0, img1)
    b2, _ = presets.instanced_boxes(n_inst=8)
    b2.instances[0].transform = (
        np.array([[1, 0, 0, 50], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                 np.float32) @ b2.instances[0].transform)
    r2 = Renderer(b2.build(), cfg, accel="two_level", cluster_size=K,
                  builder=b2, device="cpu")
    st2, _ = r2.render_frame(r2.init_state(0), cam)
    img2 = n(st2.accum)
    diff = np.abs(img1 - img2).mean() / (np.abs(img2).mean() + 1e-6)
    assert diff < 2e-3, diff


def _move(dyn, quat):
    dyn.transform(1).set_parent(dyn.transform(0))
    dyn.transform(0).translation = (0.25, 0.5, -0.75)
    dyn.transform(0).rotation = quat((0.0, 1.0, 0.0), 0.3)
    dyn.transform(1).scale = (1.5, 0.5, 1.0)
    dyn.transform(6).translation = (0.0, -2.0, 0.0)   # the light


def test_rebake_matches_jax():
    jdyn = JDynamicScene(helpers.jax_instanced_builder(n_inst=6))
    pdyn = DynamicScene(presets.instanced_boxes(n_inst=6)[0])
    jsc, psc = jdyn.build(), pdyn.build()
    _move(jdyn, jtransform.quat_from_axis_angle)
    _move(pdyn, ptransform.quat_from_axis_angle)
    np.testing.assert_array_equal(pdyn.world_matrices(),
                                  jdyn.world_matrices())
    jcs = jstream.build_clusters(jsc.tri_pos, cluster_size=K)
    jsc2, jcs2 = jdyn.rebake(jsc, jcs)
    psc2, pcs2 = pdyn.rebake(psc, port_clusters(jcs))
    assert not pdyn.dirty
    close = lambda a, b, msg: np.testing.assert_allclose(
        n(a), np.asarray(b), rtol=1e-5, atol=1e-5, err_msg=msg)
    for f in ("tri_pos", "tri_normal", "tri_tangent"):
        close(getattr(psc2, f), getattr(jsc2, f), f)
    close(psc2.lights.packed, jsc2.lights.packed, "lights")
    for f in ("aabb_lo", "aabb_hi", "tri_feat"):
        close(getattr(pcs2, f), getattr(jcs2, f), f)
    # the refit is a refit: it keeps the build's membership
    np.testing.assert_array_equal(n(pcs2.tri_id), np.asarray(jcs.tri_id))
    jics = _jax_ics(helpers.jax_instanced_builder(n_inst=6))
    _, jics2 = jdyn.rebake_two_level(jsc, jics)
    psc3, pics2 = pdyn.rebake_two_level(psc, port_instanced(jics))
    close(psc3.tri_pos, jsc2.tri_pos, "tri_pos")
    for f in ("aabb_lo", "aabb_hi", "inst_minv"):
        close(getattr(pics2, f), getattr(jics2, f), f)


def test_transform_world_matrices_match_jax():
    made = []
    for mod in (jtransform, ptransform):
        calls = []
        root = mod.Transform(translation=(1, 2, 3),
                             rotation=mod.quat_from_axis_angle((0, 0, 1), 0.7))
        mid = mod.Transform(scale=(2, 1, 0.5))
        leaf = mod.Transform(translation=(-1, 0, 4))
        mid.set_parent(root)
        leaf.set_parent(mid)
        leaf.add_dependent(lambda: calls.append(1))
        before = leaf.world_matrix.copy()
        root.rotation = mod.quat_from_axis_angle((1, 1, 0), 1.1)
        made.append((before, leaf.world_matrix, len(calls)))
    (jb, ja, jc), (pb, pa, pc) = made
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pa, ja)
    assert pc == jc == 1 and not np.allclose(pa, pb)


def test_tiled_dynamic_tracks_motion_and_warns_on_drift(caplog):
    b = SceneBuilder(env_radiance=(0.3, 0.3, 0.3))
    red = b.add_material(MaterialSpec(base_color=(0.9, 0.1, 0.1)))
    lightm = b.add_material(MaterialSpec(emissive=(30.0, 30.0, 30.0)))
    b.add_instance(InstanceHost(
        mesh=presets.box_mesh((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5), red)))
    b.add_instance(InstanceHost(mesh=presets.make_quad_mesh(
        [(-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1)], lightm)))
    dyn = DynamicScene(b)
    cam = Camera.look_at(eye=(0, 0, 6), target=(0, 0, 0), fov_y_deg=40.0)
    cfg = RenderConfig(width=32, height=32, max_depth=2, bsdf="lambert",
                       light_strategy="nee", rr_start_depth=99,
                       jitter="center", sort_secondary=False)
    r = Renderer(dyn.build(), cfg, accel="tiled", dynamic=dyn, device="cpu")
    st, aux0 = r.render_frame(r.init_state(0), cam)
    dyn.transform(0).translation = (1.5, 0.0, 0.0)
    st, aux1 = r.render_frame(st, cam)
    d0 = n(aux0["depth"]).reshape(32, 32)
    d1 = n(aux1["depth"]).reshape(32, 32)
    assert d0[16, 16] > 0.0 and d1[16, 16] == 0.0 and d1[16, 24:].max() > 0
    assert 1.0 <= r.frame_stats["cluster_drift"] < r.DRIFT_REBUILD_RATIO
    dyn.transform(0).translation = (40.0, 0.0, 0.0)
    with caplog.at_level(logging.WARNING):
        r.render_frame(st, cam)
    assert r.frame_stats["cluster_drift"] > r.DRIFT_REBUILD_RATIO
    assert any("cluster drift" in rec.getMessage() for rec in caplog.records)
