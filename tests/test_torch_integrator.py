"""PyTorch port, integrator stages and the frame, against the JAX package.

Stages take the same inputs on both sides, uniforms included:
extract_surface_data, NEE and the BSDFs to rtol 1e-4, atol 1e-5 (float32
chains of transcendental math, evaluated in a different order). The frame:
the same uniforms (JAX's threefry draws, injected into the port), the same
clusters; pixels agree to rtol 1e-3 / atol 1e-4 on at least 99% of pixels
(a ray can pick another of two co-near triangles within the packed key's t
resolution, and its path then diverges).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import (ListUniforms, jax_frame_uniforms, n,
                                 port_camera, port_clusters, port_scene, rng,
                                 t)

from lumenrenderer_tpu.accel import brute, stream as jstream
from lumenrenderer_tpu.accel import tiled as jtiled
from lumenrenderer_tpu.bsdf import disney as jdisney, lambert as jlambert
from lumenrenderer_tpu.integrator import nee as jnee
from lumenrenderer_tpu.integrator import surface as jsurface
from lumenrenderer_tpu.integrator import wavefront as jwf
from lumenrenderer_tpu.scene import geometry as jgeom
from lumenrenderer_tpu.scene import materials as jmat
from lumenrenderer_tpu.scene import presets as jpresets
from lumenrenderer_tpu.scene import scene as jscene
from lumenrenderer_tpu_torch.accel import tiled as ptiled
from lumenrenderer_tpu_torch.bsdf import disney as pdisney
from lumenrenderer_tpu_torch.bsdf import lambert as plambert
from lumenrenderer_tpu_torch.integrator import nee as pnee
from lumenrenderer_tpu_torch.integrator import surface as psurface
from lumenrenderer_tpu_torch.integrator import wavefront as pwf

RTOL, ATOL = 1e-4, 1e-5


def _close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(n(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


def material_lab_scene():
    """JAX scene: facing quads with materials covering every Disney lobe
    (diffuse+subsurface, metal, clearcoat, sheen, anisotropic, glass)."""
    b = jscene.SceneBuilder(env_radiance=(0.3, 0.3, 0.3))
    specs = [
        jmat.MaterialSpec(base_color=(0.7, 0.3, 0.2), roughness=0.9,
                          subsurface=0.6),
        jmat.MaterialSpec(base_color=(0.9, 0.8, 0.5), metallic=1.0,
                          roughness=0.3),
        jmat.MaterialSpec(base_color=(0.2, 0.4, 0.8), clearcoat=1.0,
                          clearcoat_gloss=0.7, roughness=0.5),
        jmat.MaterialSpec(base_color=(0.5, 0.6, 0.3), sheen=1.0,
                          sheen_tint=0.8, spec_tint=0.5),
        jmat.MaterialSpec(base_color=(0.6, 0.6, 0.6), metallic=0.5,
                          roughness=0.4, anisotropic=0.8),
        jmat.MaterialSpec(base_color=(0.95, 0.95, 0.95), spec_trans=1.0,
                          roughness=0.05, ior=1.5,
                          transmittance=(0.8, 0.9, 0.7)),
        jmat.MaterialSpec(base_color=(0, 0, 0), emissive=(8.0, 7.0, 6.0)),
    ]
    ids = [b.add_material(s) for s in specs]
    for i, m in enumerate(ids):
        x = float(i) - 3.0
        b.add_instance(jgeom.InstanceHost(mesh=jpresets.make_quad_mesh(
            [(x, -1, -0.3 * i), (x + 0.9, -1, -0.3 * i),
             (x + 0.9, 1, -0.3 * i - 0.2), (x, 1, -0.3 * i - 0.2)], m)))
    return b.build()


def _hits(sc, g, count):
    """Rays from the front aimed at the quads, and their brute-force hits."""
    o = np.stack([g.uniform(-3, 4, count), g.uniform(-1, 1, count),
                  np.full(count, 3.0)], -1).astype(np.float32)
    target = np.stack([g.uniform(-3, 4, count), g.uniform(-1, 1, count),
                       g.uniform(-2, 0, count)], -1).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    h = brute.intersect_closest(sc.tri_pos, jnp.asarray(o), jnp.asarray(d),
                                1e-3, 1e9)
    return o, d, h


def _surfaces(sc, g, count=400, with_tangent=True):
    o, d, h = _hits(sc, g, count)
    ref = jsurface.extract_surface_data(
        sc, jnp.asarray(o), jnp.asarray(d), h["t"], h["tri"], h["u"], h["v"],
        with_tangent=with_tangent)
    got = psurface.extract_surface_data(port_scene(sc), t(o), t(d),
                                        t(h["tri"]), with_tangent=with_tangent)
    return o, d, ref, got


@pytest.mark.parametrize("with_tangent", [True, False])
def test_extract_surface_data_matches_jax(with_tangent):
    sc = material_lab_scene()
    _, _, ref, got = _surfaces(sc, rng(0), with_tangent=with_tangent)
    assert n(got.valid).mean() > 0.5
    v = n(got.valid)
    np.testing.assert_array_equal(v, np.asarray(ref.valid))
    for f in ("position", "normal", "geo_normal", "base_color", "emissive",
              "metallic", "roughness", "alpha", "mat_rows", "tangent", "t"):
        _close(n(getattr(got, f))[v], np.asarray(getattr(ref, f))[v], msg=f)
    for f in ("mat_idx", "light_row", "front_face", "is_emissive"):
        np.testing.assert_array_equal(n(getattr(got, f))[v],
                                      np.asarray(getattr(ref, f))[v], f)


def test_nee_matches_jax():
    g = rng(1)
    jb, _ = jpresets.interior_scene(40, 8)
    sc = jb.build()
    psc = port_scene(sc)
    for sel in ("cdf", "uniform"):
        jt = jnee.build_light_table(sc, sel)
        pt = pnee.build_light_table(psc, sel)
        _close(pt.aug, jt.aug, rtol=1e-6, atol=1e-6)
        _close(pt.cdf, jt.cdf, rtol=1e-6, atol=1e-6)
    r = 512
    u3 = g.uniform(size=(r, 3)).astype(np.float32)
    pos = g.uniform(1, 19, (r, 3)).astype(np.float32)
    jls = jnee.sample_light(jt, jnp.asarray(u3), jnp.asarray(pos))
    pls = pnee.sample_light(pt, t(u3), t(pos))
    np.testing.assert_array_equal(n(pls.light_idx), np.asarray(jls.light_idx))
    np.testing.assert_array_equal(n(pls.valid), np.asarray(jls.valid))
    for f in ("point", "normal", "radiance", "pdf_area", "wi", "dist",
              "cos_light"):
        _close(getattr(pls, f), getattr(jls, f), msg=f)
    _close(pnee.pdf_solid_angle(pls), jnee.pdf_solid_angle(jls))
    wi = g.normal(size=(r, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    hit_t = g.uniform(0.5, 10, r).astype(np.float32)
    row = g.integers(-1, int(sc.lights.count), r).astype(np.int32)
    _close(pnee.light_pdf_solid_angle(pt, t(wi), t(hit_t), t(row)),
           jnee.light_pdf_solid_angle(jt, jnp.asarray(wi), jnp.asarray(hit_t),
                                      jnp.asarray(row)))


def test_disney_eval_and_sample_match_jax():
    sc = material_lab_scene()
    g = rng(2)
    o, d, ref_sd, got_sd = _surfaces(sc, g, 600)
    v = n(got_sd.valid)
    r = o.shape[0]
    wi = g.normal(size=(r, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo = -d
    jf, jpdf = jdisney.evaluate(sc.materials, ref_sd, jnp.asarray(wo),
                                jnp.asarray(wi))
    pf, ppdf = pdisney.evaluate(got_sd, t(wo), t(wi))
    _close(n(pf)[v], np.asarray(jf)[v], msg="f")
    _close(n(ppdf)[v], np.asarray(jpdf)[v], msg="pdf")
    u = g.uniform(size=(r, 4)).astype(np.float32)
    jres = jdisney.sample(sc.materials, ref_sd, jnp.asarray(wo), jnp.asarray(u))
    pres = pdisney.sample(got_sd, t(wo), t(u))
    for name, a, b in zip(("wi", "f", "pdf"), pres[:3], jres[:3]):
        _close(n(a)[v], np.asarray(b)[v], msg=name)
    np.testing.assert_array_equal(n(pres[3])[v], np.asarray(jres[3])[v])


def test_lambert_matches_jax():
    g = rng(3)
    r = 300
    nrm = g.normal(size=(r, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    wo = nrm + 0.3 * g.normal(size=(r, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    col = g.uniform(size=(r, 3)).astype(np.float32)
    u = g.uniform(size=(r, 2)).astype(np.float32)
    ref = jlambert.sample_brdf(*map(jnp.asarray, (col, nrm, wo, u)))
    got = plambert.sample_brdf(*map(t, (col, nrm, wo, u)))
    for a, b in zip(got, ref):
        _close(a, b)


@pytest.mark.parametrize("scene,bsdf,strategy", [
    ("cornell", "disney", "mis"), ("cornell", "lambert", "nee"),
    ("lab", "disney", "bsdf")])
def test_frame_matches_jax_with_same_uniforms(scene, bsdf, strategy):
    if scene == "cornell":
        jb, camf = jpresets.cornell_box(bsdf_extras=True)
        sc, cam = jb.build(), camf(1.0)
    else:
        sc = material_lab_scene()
        cam = jpresets.Camera.look_at(eye=(0.5, 0.0, 4.0), target=(0.5, 0, 0),
                                      fov_y_deg=70.0)
    w = h = 16
    cfg_kw = dict(width=w, height=h, max_depth=4, bsdf=bsdf,
                  light_strategy=strategy, rr_start_depth=1)
    jcfg = jwf.RenderConfig(**cfg_kw)
    cs = jstream.build_clusters(sc.tri_pos, cluster_size=16)
    mv = cs.num_clusters
    ji, jo = jtiled.tiled_intersectors(cs, max_visits=mv,
                                       candidate_dtype="float32",
                                       culling="frustum", decode=False)
    key = jax.random.PRNGKey(11)
    ref = jwf.render_wavefront(sc, ji, jo, cam, key, jnp.uint32(0), jcfg)
    pi, po = ptiled.tiled_intersectors(port_clusters(cs), mv)
    got = pwf.render_wavefront(
        port_scene(sc), pi, po, port_camera(cam),
        ListUniforms(jax_frame_uniforms(key, jcfg, w * h)), 0,
        pwf.RenderConfig(**cfg_kw))
    img_j = np.asarray(jwf.merge_channels(ref))
    img_p = n(pwf.merge_channels(got))
    assert img_j.mean() > 0.01
    ok = np.isclose(img_p, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    for aov in ("depth", "normal", "albedo"):
        good = np.isclose(n(got[aov]), np.asarray(ref[aov]), rtol=1e-4,
                          atol=1e-5).reshape(w * h, -1).all(-1)
        assert good.mean() >= 0.99, aov
    assert bool(got["overflow"]) == bool(ref["overflow"])


def test_refusals():
    """swizzle excludes ReSTIR and a caller's pixel_ids, as in JAX
    (wavefront.py:191,194)."""
    with pytest.raises(ValueError):
        pwf.RenderConfig(swizzle=True, use_restir=True)
    jb, camf = jpresets.cornell_box()
    sc = jb.build()
    cfg = pwf.RenderConfig(width=16, height=8, max_depth=1, swizzle=True)
    with pytest.raises(ValueError):
        pwf.render_wavefront(port_scene(sc), None, None,
                             port_camera(camf(2.0)), ListUniforms([]), 0,
                             cfg, pixel_ids=torch.arange(64))
