"""PyTorch port, textures (`scene/textures.py`, the textured
`integrator/surface.py` and the frame's mip selection), against the JAX
package.

- build_texture_atlas: every leaf identical (values and dtypes) on images
  of 1x1, 5x3, 7x7 and 64x32, uint8 and float32, 1, 3 and 4 channels
  (and 2-D), mips on and off;
- sample_bilinear / sample_trilinear: atol 1e-6 on UVs in [-3, 4], LODs in
  [-2, 20] and texture ids from -1 (white) up;
- extract_surface_data on a textured, normal-mapped scene from injected
  brute-force hits: every field rtol 1e-5 (atol 1e-6), with and without a
  ray footprint (mip_spread, mip_dist0);
- frames (the JAX frame's draws injected, the same clusters): pixels rtol
  1e-3 / atol 1e-4 on >= 99%; the mip-vs-bilinear mean and smoothing
  checks of tests/test_textures.py on the port's own frames; the texture
  cases of tests/test_alpha.py;
- torch.autograd against jax.grad for every material's emissive and for
  the atlas texels through the trilinear path: rtol 1e-3;
- a textured ReSTIR frame: finite, reservoirs finite and >= 0, M growing.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import (ListUniforms, jax_frame_uniforms, n,
                                 port_camera, port_clusters, port_scene, rng,
                                 t, to_numpy_tree)

from lumenrenderer_tpu.accel import brute
from lumenrenderer_tpu.accel import stream as jstream
from lumenrenderer_tpu.accel import tiled as jtiled
from lumenrenderer_tpu.core.camera import Camera as JCamera
from lumenrenderer_tpu.integrator import surface as jsurface
from lumenrenderer_tpu.integrator import wavefront as jwf
from lumenrenderer_tpu.scene import geometry as jgeom
from lumenrenderer_tpu.scene import materials as jmat
from lumenrenderer_tpu.scene import presets as jpresets
from lumenrenderer_tpu.scene import scene as jscene
from lumenrenderer_tpu.scene import textures as jtex
from lumenrenderer_tpu_torch.accel import stream as pstream
from lumenrenderer_tpu_torch.accel import tiled as ptiled
from lumenrenderer_tpu_torch.core import sampling
from lumenrenderer_tpu_torch.core.camera import Camera
from lumenrenderer_tpu_torch.integrator import surface as psurface
from lumenrenderer_tpu_torch.integrator import wavefront as pwf
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import geometry as pgeom
from lumenrenderer_tpu_torch.scene import presets as ppresets
from lumenrenderer_tpu_torch.scene import textures as ptex
from lumenrenderer_tpu_torch.scene.materials import MaterialSpec
from lumenrenderer_tpu_torch.scene.scene import SceneBuilder

ATLAS_FIELDS = ("texels", "offset", "width", "height", "mip_offset",
                "n_mips")


def _images(dtype):
    """Images of every size and channel count the atlas test takes."""
    g = rng(3)
    shapes = [(1, 1, 4), (5, 3, 3), (7, 7, 1), (64, 32, 4), (5, 3), (7, 7, 3),
              (64, 32, 1)]
    out = []
    for s in shapes:
        a = g.uniform(0, 1, s)
        out.append((a * 255).astype(np.uint8) if dtype == "uint8"
                   else a.astype(np.float32))
    return out


@pytest.mark.parametrize("mips", [True, False])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_atlas_matches_jax(dtype, mips):
    imgs = _images(dtype)
    ref = jtex.build_texture_atlas(imgs, mips=mips)
    got = ptex.build_texture_atlas(imgs, mips=mips)
    assert got.count == ref.count == len(imgs) + 1
    for f in ATLAS_FIELDS:
        a, b = n(getattr(got, f)), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if mips:        # the 5x3 image: 5x3, 2x1, 1x1 (max(1, d // 2))
        assert n(got.n_mips)[2] == 3


def _atlas_pair():
    imgs = _images("float32") + _images("uint8")
    return jtex.build_texture_atlas(imgs), ptex.build_texture_atlas(imgs)


def test_samplers_match_jax():
    ja, pa = _atlas_pair()
    g = rng(4)
    r = 4096
    tid = g.integers(-1, ja.count - 1, r).astype(np.int32)
    tid[:16] = -1
    uv = g.uniform(-3, 4, (r, 2)).astype(np.float32)
    lod = g.uniform(-2, 20, r).astype(np.float32)
    ref = jtex.sample_bilinear(ja, jnp.asarray(tid), jnp.asarray(uv))
    got = ptex.sample_bilinear(pa, t(tid), t(uv))
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(got)[:16], 1.0, atol=1e-6)   # id -1: white
    ref = jtex.sample_trilinear(ja, jnp.asarray(tid), jnp.asarray(uv),
                                jnp.asarray(lod))
    got = ptex.sample_trilinear(pa, t(tid), t(uv), t(lod))
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=0, atol=1e-6)
    # broadcasting: one UV and LOD for several texture ids of a ray
    ids = tid.reshape(-1, 4)
    got4 = ptex.sample_trilinear(pa, t(ids), t(uv[::4])[:, None],
                                 t(lod[::4])[:, None])
    ref4 = jtex.sample_trilinear(ja, jnp.asarray(ids),
                                 jnp.asarray(np.repeat(uv[::4, None], 4, 1)),
                                 jnp.asarray(np.repeat(lod[::4, None], 4, 1)))
    np.testing.assert_allclose(n(got4), np.asarray(ref4), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# a textured, normal-mapped scene, built the same way in both packages
# ---------------------------------------------------------------------------

def _checker(size, c0, c1, cell):
    yy, xx = np.mgrid[0:size, 0:size]
    img = np.where(((xx // cell + yy // cell) % 2) == 0, c0, c1)
    return np.repeat(img[..., None], 3, axis=-1).astype(np.float32)


def textured_builder(sb, spec, geom, presets, seed=0):
    """A floor with a checker base color (alpha texture), a random normal
    map and a metal-rough map; a box; an area light with an emissive
    texture. sb/spec/geom/presets: SceneBuilder, MaterialSpec, the geometry
    and presets modules of one package."""
    g = rng(seed)
    b = sb(env_radiance=(0.05, 0.05, 0.05))
    base = np.concatenate([_checker(64, 0.2, 0.8, 4),
                           g.uniform(0.3, 1.0, (64, 64, 1))], -1)
    nrm = g.normal(size=(16, 16, 3)) * [0.3, 0.3, 1.0]
    nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[..., 2] = np.abs(nrm[..., 2])
    mr = g.uniform(0, 1, (8, 8, 3)).astype(np.float32)
    emt = (g.uniform(0.2, 1.0, (4, 4, 3)) * 255).astype(np.uint8)
    tb, tn, tm, te = (b.add_texture(x) for x in (
        base.astype(np.float32), (nrm * 0.5 + 0.5).astype(np.float32), mr,
        emt))
    floor_m = b.add_material(spec(base_color=(1.0, 0.9, 0.8), roughness=0.8,
                                  metallic=0.5, base_color_tex=tb,
                                  normal_tex=tn, metal_rough_tex=tm))
    box_m = b.add_material(spec(base_color=(0.6, 0.7, 0.3), roughness=0.4,
                                base_color_tex=tb))
    light_m = b.add_material(spec(base_color=(0, 0, 0),
                                  emissive=(30.0, 30.0, 30.0),
                                  emissive_tex=te))
    pos, idx = presets.quad((-6, 0, -6), (6, 0, -6), (6, 0, 6), (-6, 0, 6))
    floor = geom.MeshHost(positions=pos, indices=idx, material_ids=floor_m,
                          uvs=np.array([(0, 0), (4, 0), (4, 4), (0, 4)],
                                       np.float32))
    b.add_instance(geom.InstanceHost(mesh=floor))
    b.add_instance(geom.InstanceHost(
        mesh=presets.box_mesh((-1, 0, -1), (1, 1.5, 1), box_m)))
    pos, idx = presets.quad((-1, 5, -1), (1, 5, -1), (1, 5, 1), (-1, 5, 1))
    light = geom.MeshHost(positions=pos, indices=idx, material_ids=light_m,
                          uvs=np.array([(0, 0), (1, 0), (1, 1), (0, 1)],
                                       np.float32))
    b.add_instance(geom.InstanceHost(mesh=light))
    return b


@functools.lru_cache(maxsize=None)
def _scene():
    jb = textured_builder(jscene.SceneBuilder, jmat.MaterialSpec, jgeom,
                          jpresets)
    pb = textured_builder(SceneBuilder, MaterialSpec, pgeom, ppresets)
    return jb.build(), pb.build()


def test_textured_scene_build_matches_jax():
    jsc, psc = _scene()
    assert psc.textures.count == 5
    conv = port_scene(jsc)
    for part in ("textures", "materials"):
        for f, want in to_numpy_tree(getattr(jsc, part)).items():
            have = n(getattr(getattr(psc, part), f))
            assert have.dtype == want.dtype, (part, f)
            np.testing.assert_array_equal(have, want, err_msg=f)
            # scene_from_numpy carries the atlas whole
            np.testing.assert_array_equal(
                n(getattr(getattr(conv, part), f)), want, err_msg=f)
    for f in ("tri_uv", "tri_tangent", "tri_pos"):
        np.testing.assert_allclose(n(getattr(psc, f)),
                                   np.asarray(getattr(jsc, f)), rtol=1e-6,
                                   atol=1e-6)


def _hits(sc, g, count):
    o = np.stack([g.uniform(-5, 5, count), np.full(count, 4.0),
                  g.uniform(-5, 5, count)], -1).astype(np.float32)
    target = np.stack([g.uniform(-5.5, 5.5, count), np.zeros(count),
                       g.uniform(-5.5, 5.5, count)], -1).astype(np.float32)
    # a few rays up at the textured light
    o[:32, [0, 2]] = g.uniform(-0.5, 0.5, (32, 2))
    target[:32] = o[:32] + [0.0, 2.0, 0.0]
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    h = brute.intersect_closest(sc.tri_pos, jnp.asarray(o), jnp.asarray(d),
                                1e-3, 1e9)
    return o, d, h


@pytest.mark.parametrize("footprint", [False, True])
def test_extract_surface_data_textured_matches_jax(footprint):
    jsc, _ = _scene()
    psc = port_scene(jsc)
    g = rng(5)
    o, d, h = _hits(jsc, g, 600)
    kw_j, kw_p = {}, {}
    if footprint:
        spread = np.float32(0.01)
        dist0 = g.uniform(0, 30, 600).astype(np.float32)
        kw_j = dict(mip_spread=jnp.float32(spread),
                    mip_dist0=jnp.asarray(dist0))
        kw_p = dict(mip_spread=torch.tensor(spread), mip_dist0=t(dist0))
    ref = jsurface.extract_surface_data(
        jsc, jnp.asarray(o), jnp.asarray(d), h["t"], h["tri"], h["u"],
        h["v"], **kw_j)
    got = psurface.extract_surface_data(psc, t(o), t(d), t(h["tri"]), **kw_p)
    v = n(got.valid)
    np.testing.assert_array_equal(v, np.asarray(ref.valid))
    assert v.mean() > 0.9
    # the floor's normal map moved the shading normal
    assert (np.abs(n(got.normal)[v] - n(got.geo_normal)[v]).max(-1)
            > 0.05).mean() > 0.3
    for f in ("position", "normal", "geo_normal", "uv", "base_color",
              "emissive", "metallic", "roughness", "alpha", "mat_rows",
              "tangent", "t"):
        np.testing.assert_allclose(n(getattr(got, f))[v],
                                   np.asarray(getattr(ref, f))[v],
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    for f in ("mat_idx", "light_row", "front_face", "is_emissive"):
        np.testing.assert_array_equal(n(getattr(got, f))[v],
                                      np.asarray(getattr(ref, f))[v], f)


# ---------------------------------------------------------------------------
# frames and gradients against the JAX frame (its draws injected)
# ---------------------------------------------------------------------------

W = H = 16
KEY = 3
CONFIGS = {
    "disney": dict(width=W, height=H, max_depth=3, bsdf="disney",
                   light_strategy="mis", rr_start_depth=1),
    "lambert_nomip": dict(width=W, height=H, max_depth=3, bsdf="lambert",
                          light_strategy="nee", rr_start_depth=99,
                          mipmaps=False),
}


def _cam(mod):
    return mod.look_at(eye=(0.3, 3.0, 8.0), target=(0.0, 0.5, 0.0),
                       fov_y_deg=50.0, aspect=1.0)


@functools.lru_cache(maxsize=None)
def _bound():
    jsc, _ = _scene()
    cs = jstream.build_clusters(jsc.tri_pos, cluster_size=32)
    mv = cs.num_clusters
    jq = jtiled.tiled_intersectors(cs, max_visits=mv,
                                   candidate_dtype="float32",
                                   culling="frustum", decode=False)
    pq = ptiled.tiled_intersectors(port_clusters(cs), mv)
    return jsc, jq, port_scene(jsc), pq


def _with(scene, texels, emissive):
    return scene.replace(
        textures=scene.textures.replace(texels=texels),
        materials=scene.materials.replace(emissive=emissive))


@functools.lru_cache(maxsize=None)
def _jax_frame(name):
    """(image, {texels, emissive: d mean}) of the JAX frame."""
    jsc, (ji, jo), _, _ = _bound()
    cfg = jwf.RenderConfig(**CONFIGS[name])
    cam = _cam(JCamera)

    def frame(p):
        out = jwf.render_wavefront(_with(jsc, p["texels"], p["emissive"]),
                                   ji, jo, cam, jax.random.PRNGKey(KEY),
                                   jnp.uint32(0), cfg)
        return jwf.merge_channels(out)

    def loss(p):
        img = frame(p)
        return img.mean(), img

    p = {"texels": jsc.textures.texels, "emissive": jsc.materials.emissive}
    (_, img), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(p)
    return np.asarray(img), {k: np.asarray(x) for k, x in g.items()}


def _port_frame(name, remat):
    _, _, psc, (pi, po) = _bound()
    cfg = pwf.RenderConfig(**CONFIGS[name], remat=remat)
    src = ListUniforms(jax_frame_uniforms(jax.random.PRNGKey(KEY),
                                          jwf.RenderConfig(**CONFIGS[name]),
                                          W * H))
    p = {"texels": psc.textures.texels.clone().requires_grad_(),
         "emissive": psc.materials.emissive.clone().requires_grad_()}
    img = pwf.merge_channels(pwf.render_wavefront(
        _with(psc, p["texels"], p["emissive"]), pi, po,
        port_camera(_cam(JCamera)), src, 0, cfg))
    img.mean().backward()
    assert not src.arrays                    # every JAX draw consumed
    return n(img), {k: n(x.grad) for k, x in p.items()}


@pytest.mark.parametrize("name,remat", [("disney", False), ("disney", True),
                                        ("lambert_nomip", False)])
def test_textured_frame_and_gradients_match_jax(name, remat):
    img_j, grads_j = _jax_frame(name)
    img_p, grads_p = _port_frame(name, remat)
    assert np.isfinite(img_p).all() and img_j.mean() > 0.01
    ok = np.isclose(img_p, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    for k in ("emissive", "texels"):
        gj, gp = grads_j[k], grads_p[k]
        assert np.isfinite(gp).all(), k
        if k == "texels":
            # slot 0, the white texel, is sampled by the black light: the
            # JAX Disney transmission lobe's sqrt makes its gradient NaN
            # there (ROADMAP C-15); the rows of the scene's textures
            assert np.isfinite(gj[1:]).all()
            gj, gp = gj[1:], gp[1:]
        assert np.abs(gj).max() > 0, k
        np.testing.assert_allclose(gp, gj, rtol=1e-3,
                                   atol=1e-3 * np.abs(gj).max(), err_msg=k)
    # the base-color texels the frame sampled got a gradient
    _, psc = _scene()
    lo, hi = (int(psc.textures.offset[i]) for i in (1, 2))
    assert (np.abs(grads_p["texels"][lo:hi, :3]) > 0).sum() > 100


def _port_cfg_frame(scene, cam, cfg, seed, spp=1):
    """The mean of `spp` port frames of `scene` through the tiled twin."""
    cs = pstream.build_clusters(scene.tri_pos, cluster_size=32)
    isect, occl = ptiled.tiled_intersectors(cs, cs.num_clusters)
    acc = 0.0
    for i in range(spp):
        gen = torch.Generator().manual_seed(seed + i)
        with torch.no_grad():
            out = pwf.render_wavefront(scene, isect, occl, cam,
                                       sampling.generator_uniforms(gen), i,
                                       cfg)
        acc = acc + n(pwf.merge_channels(out))
    return acc / spp


def test_mip_vs_bilinear_mean_and_smoothing():
    """tests/test_textures.py's end-to-end check on the port's frames: a
    strongly minified checker floor, mipmapped and level-0 bilinear:
    finite, means within 8%, and less pixel-to-pixel variation in the far
    band with mips."""
    b = SceneBuilder(env_radiance=(0.0, 0.0, 0.0))
    tid = b.add_texture(_checker(256, 0.2, 0.8, 4))
    nm = np.zeros((8, 8, 3), np.float32)
    nm[..., 2] = 1.0
    nid = b.add_texture(nm * 0.5 + 0.5)
    m = b.add_material(MaterialSpec(base_color=(1.0, 1.0, 1.0), roughness=1.0,
                                    base_color_tex=tid, normal_tex=nid))
    lightm = b.add_material(MaterialSpec(base_color=(0, 0, 0),
                                         emissive=(40.0, 40.0, 40.0)))
    pos, idx = ppresets.quad((-20, 0, -20), (20, 0, -20), (20, 0, 20),
                             (-20, 0, 20))
    b.add_instance(pgeom.InstanceHost(mesh=pgeom.MeshHost(
        positions=pos, indices=idx, material_ids=m,
        uvs=np.array([(0, 0), (8, 0), (8, 8), (0, 8)], np.float32))))
    b.add_instance(pgeom.InstanceHost(mesh=ppresets.make_quad_mesh(
        [(-1, 6, -1), (1, 6, -1), (1, 6, 1), (-1, 6, 1)], lightm)))
    sc = b.build()
    cam = Camera.look_at(eye=(0, 2.0, 14), target=(0, 0.0, 0),
                         fov_y_deg=50.0, aspect=1.0)
    w = h = 48
    base = dict(width=w, height=h, max_depth=2, bsdf="lambert",
                light_strategy="nee", rr_start_depth=99)
    img_mip = _port_cfg_frame(sc, cam, pwf.RenderConfig(**base, mipmaps=True),
                              0, spp=8)
    img_raw = _port_cfg_frame(sc, cam,
                              pwf.RenderConfig(**base, mipmaps=False), 0,
                              spp=8)
    assert np.isfinite(img_mip).all()
    lit = img_raw.mean(axis=1) > 1e-4
    assert lit.sum() > 200
    r = img_mip[lit].mean() / img_raw[lit].mean()
    assert abs(r - 1.0) < 0.08, r
    im2, ir2 = img_mip.reshape(h, w, 3), img_raw.reshape(h, w, 3)
    tv = lambda a: np.abs(np.diff(a[..., 0], axis=1)).mean()
    band_m, band_r = im2[h // 3:h // 2], ir2[h // 3:h // 2]
    assert tv(band_m) < 0.7 * tv(band_r), (tv(band_m), tv(band_r))


# ---------------------------------------------------------------------------
# the texture cases of tests/test_alpha.py, JAX frame against the port's
# ---------------------------------------------------------------------------

ALPHA_CFG = dict(width=16, height=16, max_depth=2, bsdf="lambert",
                 light_strategy="nee", rr_start_depth=99, jitter="center",
                 alpha_materials=True, mipmaps=False)


def _alpha_quads(sb, spec, geom, mats):
    """Quads side by side at z = 0 spanning x in [-5, 5], one per
    (material kwargs, texture) in `mats`; UVs 0..1 each."""
    b = sb(env_radiance=(2.0, 2.0, 2.0))
    xs = np.linspace(-5, 5, len(mats) + 1)
    for (kw, tex), x0, x1 in zip(mats, xs[:-1], xs[1:]):
        if tex is not None:
            kw = dict(kw, base_color_tex=b.add_texture(tex))
        m = b.add_material(spec(base_color=(0.0, 0.0, 0.0), roughness=1.0,
                                **kw))
        b.add_instance(geom.InstanceHost(mesh=geom.MeshHost(
            positions=np.array([(x0, -5, 0), (x1, -5, 0), (x1, 5, 0),
                                (x0, 5, 0)], np.float32),
            indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
            uvs=np.array([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32),
            material_ids=m)))
    return b


def _alpha_tex(a):
    tex = np.ones((4, 4, 4), np.float32)
    tex[..., 3] = a
    return tex


ALPHA_CASES = {
    # a MASK cut by texture alpha: 0.1 left (hole: env), 0.9 right (black)
    "mask_holes": [({"alpha_mode": 1}, _alpha_tex(0.1)),
                   ({"alpha_mode": 1}, _alpha_tex(0.9))],
    # alpha = factor x texture alpha: 0.2 x 1.0 < the cutoff 0.5: a hole
    "factor_times_texture": [({"alpha_mode": 1, "alpha_cutoff": 0.5,
                               "alpha_factor": 0.2}, _alpha_tex(1.0))],
    # OPAQUE ignores the texture's alpha and the factor
    "opaque_ignores_alpha": [({"alpha_mode": 0, "alpha_factor": 0.05},
                              _alpha_tex(0.05))],
    # BLEND passes through stochastically with probability 1 - alpha
    "blend": [({"alpha_mode": 2}, _alpha_tex(0.3))],
}


@pytest.mark.parametrize("case", sorted(ALPHA_CASES))
def test_texture_alpha_matches_jax(case):
    mats = ALPHA_CASES[case]
    jsc = _alpha_quads(jscene.SceneBuilder, jmat.MaterialSpec, jgeom,
                       mats).build()
    psc = _alpha_quads(SceneBuilder, MaterialSpec, pgeom, mats).build()
    jcfg = jwf.RenderConfig(**ALPHA_CFG)
    jcam = JCamera.look_at(eye=(0.043, 0.017, 3), target=(0.043, 0.017, 0),
                           fov_y_deg=30.0)
    isect = functools.partial(brute.intersect_closest, jsc.tri_pos)
    occl = functools.partial(brute.intersect_any, jsc.tri_pos)
    jframe = jax.jit(lambda key, fi: jwf.merge_channels(jwf.render_wavefront(
        jsc, isect, occl, jcam, key, fi, jcfg)))
    cs = pstream.build_clusters(psc.tri_pos, cluster_size=32)
    pi, po = ptiled.tiled_intersectors(cs, cs.num_clusters)
    frames = 24 if case == "blend" else 1
    acc_j = acc_p = 0.0
    for i in range(frames):
        key = jax.random.PRNGKey(i)
        img_j = np.asarray(jframe(key, jnp.uint32(i)))
        src = ListUniforms(jax_frame_uniforms(key, jcfg, 256))
        with torch.no_grad():
            img_p = n(pwf.merge_channels(pwf.render_wavefront(
                psc, pi, po, port_camera(jcam), src, i,
                pwf.RenderConfig(**ALPHA_CFG))))
        ok = np.isclose(img_p, img_j, rtol=1e-3, atol=1e-4).all(-1)
        assert ok.mean() >= 0.99, ok.mean()
        acc_j, acc_p = acc_j + img_j, acc_p + img_p
    lum = (acc_p / frames).mean(-1).reshape(16, 16)
    if case == "mask_holes":
        np.testing.assert_allclose(lum[:, :7], 2.0, rtol=1e-3)
        np.testing.assert_allclose(lum[:, 9:], 0.0, atol=1e-4)
    elif case == "factor_times_texture":
        np.testing.assert_allclose(lum.mean(), 2.0, rtol=1e-3)
    elif case == "opaque_ignores_alpha":
        np.testing.assert_allclose(lum, 0.0, atol=1e-5)
    else:
        expect = (1 - 0.3) * 2.0
        assert abs(lum.mean() - expect) / expect < 0.12, lum.mean()
    r = Renderer(psc, pwf.RenderConfig(width=8, height=8, max_depth=2,
                                       bsdf="lambert", light_strategy="nee"),
                 device="cpu", cluster_size=32)
    assert r.config.alpha_materials == (case != "opaque_ignores_alpha")


# ---------------------------------------------------------------------------
# ReSTIR on a textured scene (its target pdf reads the textured base color)
# ---------------------------------------------------------------------------

def test_textured_restir_frame_and_reservoirs():
    b, camf = ppresets.interior_scene(n_boxes=15, n_lights=12, seed=3)
    img = _checker(32, 0.1, 0.9, 4)
    tid = b.add_texture(img)
    for inst in b.instances:
        m = inst.mesh
        # a planar projection of each mesh onto the floor's axes
        m.uvs = (m.positions[:, [0, 2]] / 4.0).astype(np.float32)
        m.tangents = pgeom.compute_tangents(m.positions, m.normals, m.uvs,
                                            m.indices)
    for spec in b.materials[:17]:
        spec.base_color_tex = tid
    sc = b.build()
    assert sc.textures.count == 2
    cfg = pwf.RenderConfig(width=32, height=32, max_depth=2, bsdf="disney",
                           light_strategy="nee", use_restir=True)
    r = Renderer(sc, cfg, device="cpu")
    st = r.init_state(0)
    for _ in range(3):
        st, _ = r.render_frame(st, camf(1.0))
        m_max = float(st.restir.reservoir.m.max())
    assert np.isfinite(n(st.accum)).all() and float(st.accum.mean()) > 0
    res = st.restir.reservoir
    for f in (res.w_sum, res.m, res.w_out, res.p_hat, res.bary):
        assert torch.isfinite(f).all() and (f >= 0).all()
    assert int(res.light_idx.min()) >= 0 and m_max > 1
    # the texture darkens the frame against the untextured scene's
    for spec in b.materials[:17]:
        spec.base_color_tex = -1
    r0 = Renderer(b.build(), cfg, device="cpu")
    st0 = r0.init_state(0)
    for _ in range(3):
        st0, _ = r0.render_frame(st0, camf(1.0))
    assert float(st.accum.mean()) < float(st0.accum.mean())
