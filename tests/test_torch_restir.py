"""PyTorch port, ReSTIR DI (`restir/di.py`), against the JAX package.

Stage parity: the same inputs on both sides, JAX's own draws included
(`jax_restir_draws`), so the stages agree up to floating-point order. The
surface is the small interior scene's (15 boxes, 12 lights) primary hits, so
the reuse gates pass, with random albedos and a random 5% of pixels masked.
A categorical pick compares u * w_sum with an fp32 running sum, and a
different summation order flips it within an ulp of a boundary, so picks are
held to an identical fraction and the floats only where the picks agree:

- all_light_radiance, build_light_cdf: rtol 1e-6; fill_light_bags identical
  on >= 99.99%;
- RIS (tiled at 32x32, per-pixel at 40x24) and temporal reuse: light_idx
  identical on >= 99.9%, w_sum / w_out / p_hat / bary within rtol 1e-4,
  atol 1e-6 where they agree;
- visibility: the occluder receives the same rays (rtol 1e-6) and the same
  pixels are killed;
- spatial reuse (2 iterations; cos/sin differ by ulps and move a neighbour
  now and then): light_idx identical on >= 99%, floats as above;
- shade (Disney): rtol 1e-3 on >= 99.9% of pixels; the whole RestirDI and
  the ReSTIR frame: color rtol 1e-3 on >= 99% of pixels, state as spatial.

Port-only statistics at 40x40, depth 1, Lambert, Renderer(device="cpu"),
with the bounds of the JAX package's tests/test_restir.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import (ListUniforms, jax_frame_uniforms,
                                 jax_restir_draws, n, port_camera,
                                 port_clusters, port_scene, rng, t,
                                 to_numpy_tree)

from lumenrenderer_tpu.accel import brute
from lumenrenderer_tpu.accel import stream as jstream
from lumenrenderer_tpu.accel import tiled as jtiled
from lumenrenderer_tpu.core import camera as jcamera
from lumenrenderer_tpu.core import vecmath as jvm
from lumenrenderer_tpu.integrator import nee as jnee
from lumenrenderer_tpu.integrator import surface as jsurface
from lumenrenderer_tpu.integrator import wavefront as jwf
from lumenrenderer_tpu.restir import di as jdi
from lumenrenderer_tpu.scene import presets as jpresets
from lumenrenderer_tpu_torch.accel import tiled as ptiled
from lumenrenderer_tpu_torch.integrator import nee as pnee
from lumenrenderer_tpu_torch.integrator import surface as psurface
from lumenrenderer_tpu_torch.integrator import wavefront as pwf
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.restir import di as pdi
from lumenrenderer_tpu_torch.scene import presets
from lumenrenderer_tpu_torch.utils import convert

RTOL, ATOL = 1e-4, 1e-6
FLOATS = ("w_sum", "w_out", "p_hat", "bary")


# ---------------------------------------------------------------------------
# shared inputs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _scene():
    jb, camf = jpresets.interior_scene(n_boxes=15, n_lights=12, seed=3)
    sc = jb.build()
    return sc, port_scene(sc), camf


@functools.lru_cache(maxsize=None)
def _inputs(w, h):
    """(JAX SurfaceData, port SurfaceData, hit mask, motion, wo) of the
    scene's primary hits at w x h."""
    sc, _, camf = _scene()
    o, d = jcamera.generate_primary_rays(camf(w / h), w, h, jnp.uint32(0),
                                         jitter="center")
    hits = brute.intersect_closest(sc.tri_pos, o, d, 1e-3, 1e9)
    jsd = jsurface.extract_surface_data(sc, o, d, hits["t"], hits["tri"],
                                        hits["u"], hits["v"],
                                        with_tangent=False)
    g = rng(w * h)
    count = w * h
    jsd = jsd.replace(base_color=jnp.asarray(
        g.uniform(0.05, 0.95, (count, 3)).astype(np.float32)))
    psd = psurface.SurfaceData(**{
        f.name: t(getattr(jsd, f.name))
        for f in dataclasses.fields(psurface.SurfaceData)})
    hit = np.asarray(jsd.valid) & (g.uniform(size=count) > 0.05)
    motion = g.normal(0.0, 1.5, (count, 2)).astype(np.float32)
    motion[::7] = 0.5                  # ties: jnp.round and torch.round
    motion[::11] = 40.0                # off screen
    return jsd, psd, hit, motion, -np.asarray(d)


def _configs(**kw):
    return jdi.RestirConfig(**kw), pdi.RestirConfig(**kw)


def _light_inputs(key):
    """JAX's rad_all, CDF pdf and bags (the stages' shared inputs)."""
    sc, _, _ = _scene()
    rad_all = jnee.all_light_radiance(sc)
    cdf, pdf = jdi.build_light_cdf(sc, rad_all)
    bags = jdi.fill_light_bags(cdf, jdi.RestirConfig(), key)
    return rad_all, pdf, bags


def _held_reservoir(got, ref, pick_fraction, fields=FLOATS):
    """light_idx identical on >= pick_fraction; the other fields within
    RTOL/ATOL where the picks agree; m close everywhere."""
    same = n(got.light_idx) == np.asarray(ref.light_idx)
    assert same.mean() >= pick_fraction, same.mean()
    for f in fields:
        np.testing.assert_allclose(n(getattr(got, f))[same],
                                   np.asarray(getattr(ref, f))[same],
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    np.testing.assert_allclose(n(got.m), np.asarray(ref.m), rtol=RTOL)


class RecordingOccluder:
    """A stand-in occluder shared by both packages: records each call's
    rays and calls the segment occluded where its midpoint lies above a
    height fixed at the first call (that call's median)."""

    def __init__(self):
        self.calls = []
        self.y = None

    def __call__(self, o, d, tn, tx):
        is_torch = isinstance(o, torch.Tensor)
        a = [np.broadcast_to(np.asarray(n(x), np.float32), (o.shape[0],)
                             + ((3,) if i < 2 else ()))
             for i, x in enumerate((o, d, tn, tx))]
        self.calls.append(a)
        mid_y = a[0][:, 1] + a[1][:, 1] * a[3] * 0.5
        if self.y is None:
            self.y = float(np.median(mid_y))
        occ = mid_y > self.y
        return torch.from_numpy(occ) if is_torch else jnp.asarray(occ)


def _history(w, h, key):
    """A JAX RestirState (valid) of a previous frame: RIS reservoirs with M
    from 1 to 1,500, gbuffer at the current surface with depth noise and a
    share of turned normals."""
    sc, _, _ = _scene()
    jsd, _, _, _, _ = _inputs(w, h)
    rad_all, pdf, bags = _light_inputs(jax.random.fold_in(key, 1))
    res = jdi.ris_primary(sc, jsd, bags, pdf, jdi.RestirConfig(), w,
                          jax.random.fold_in(key, 2), rad_all=rad_all)
    g = rng(7)
    count = w * h
    m = g.uniform(1.0, 1500.0, count).astype(np.float32)
    res = res.replace(m=jnp.asarray(m), w_sum=res.w_sum * m / 32.0)
    depth = np.asarray(jdi.sd_depth(jsd))
    nrm = np.array(jsd.normal)
    turned = g.uniform(size=count) < 0.1
    nrm[turned] = nrm[turned][:, [1, 2, 0]]
    return jdi.RestirState(
        reservoir=res,
        prev_depth=jnp.asarray((depth * g.uniform(0.95, 1.05, count))
                               .astype(np.float32)),
        prev_normal=jnp.asarray(nrm), prev_position=jsd.position,
        prev_albedo=jvm.luminance(jsd.base_color), valid=jnp.asarray(True))


def _port_state(jstate):
    return convert.restir_state_from_numpy(to_numpy_tree(jstate))


def _jax_eval(sc, bsdf="disney"):
    cfg = jwf.RenderConfig(bsdf=bsdf)
    return lambda sd, wo, wi: jwf._bsdf_eval(cfg, sd, sc.materials, wo, wi)


def _port_eval(bsdf="disney"):
    cfg = pwf.RenderConfig(bsdf=bsdf)
    return lambda sd, wo, wi: pwf._bsdf_eval(cfg, sd, wo, wi)


# ---------------------------------------------------------------------------
# stage parity
# ---------------------------------------------------------------------------

def test_light_cdf_and_bags_match_jax():
    sc, psc, _ = _scene()
    jrad = jnee.all_light_radiance(sc)
    prad = pnee.all_light_radiance(psc)
    np.testing.assert_allclose(n(prad), np.asarray(jrad), rtol=1e-6)
    for cdf_p, cdf_j in zip(pnee.build_light_cdf(psc, prad),
                            jnee.build_light_cdf(sc, jrad)):
        np.testing.assert_allclose(n(cdf_p), np.asarray(cdf_j), rtol=1e-6,
                                   atol=1e-7)
    for cdf_p, cdf_j in zip(pdi.build_light_cdf(psc),
                            jdi.build_light_cdf(sc)):
        np.testing.assert_allclose(n(cdf_p), np.asarray(cdf_j), rtol=1e-6,
                                   atol=1e-7)
    jcfg, pcfg = _configs()
    key = jax.random.PRNGKey(3)
    cdf_j, _ = jdi.build_light_cdf(sc, jrad)
    bags_j = np.asarray(jdi.fill_light_bags(cdf_j, jcfg, key))
    u = np.asarray(jax.random.uniform(key, (pcfg.num_bags, pcfg.bag_size)))
    bags_p = n(pdi.fill_light_bags(pnee.build_light_cdf(psc, prad)[0], pcfg,
                                   ListUniforms([u])))
    assert bags_p.dtype == np.int32 and bags_p.shape == bags_j.shape
    assert (bags_p == bags_j).mean() >= 0.9999
    assert bags_p.max() < int(sc.lights.count)


@pytest.mark.parametrize("w,h", [(32, 32), (40, 24)])
def test_ris_primary_matches_jax(w, h):
    sc, psc, _ = _scene()
    jsd, psd, _, _, _ = _inputs(w, h)
    jcfg, pcfg = _configs()
    key = jax.random.PRNGKey(w)
    rad_all, pdf, bags = _light_inputs(key)
    k_ris = jax.random.split(key, 6)[1]
    ref = jdi.ris_primary(sc, jsd, bags, pdf, jcfg, w, k_ris,
                          rad_all=rad_all)
    draws = jax_restir_draws(key, jcfg, w, h)[1:5]
    got = pdi.ris_primary(psc, psd, t(bags), t(pdf), pcfg, w,
                          ListUniforms(draws), rad_all=t(rad_all))
    assert got.light_idx.dtype == torch.int32
    assert all(getattr(got, f).shape == getattr(ref, f).shape
               for f in ("light_idx", "bary", "w_sum", "m"))
    assert float(ref.w_sum.mean()) > 0
    _held_reservoir(got, ref, 0.999)


def test_visibility_pass_matches_jax():
    w, h = 32, 32
    sc, psc, _ = _scene()
    jsd, psd, hit, _, _ = _inputs(w, h)
    key = jax.random.PRNGKey(5)
    rad_all, pdf, bags = _light_inputs(key)
    res = jdi.ris_primary(sc, jsd, bags, pdf, jdi.RestirConfig(), w, key,
                          rad_all=rad_all)
    occ = RecordingOccluder()
    ref = jdi.visibility_pass(sc, jsd, res, occ, jnp.asarray(hit),
                              rad_all=rad_all)
    pres = _port_state(jdi.init_state(w * h).replace(reservoir=res)).reservoir
    got = pdi.visibility_pass(psc, psd, pres, occ, t(hit),
                              rad_all=t(rad_all))
    (jo, jd, jtn, jtx), (po, pd, ptn, ptx) = occ.calls
    for a, b in ((po, jo), (pd, jd), (ptn, jtn), (ptx, jtx)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert (ptx[~hit] > 0).any()         # missed pixels' rays are sent too
    killed_j = (np.asarray(ref.w_out) == 0) & (np.asarray(ref.w_sum) == 0)
    killed_p = (n(got.w_out) == 0) & (n(got.w_sum) == 0)
    np.testing.assert_array_equal(killed_p, killed_j)
    assert 0 < killed_j.mean() < 1
    for f in ("w_out", "w_sum"):
        np.testing.assert_allclose(n(getattr(got, f)),
                                   np.asarray(getattr(ref, f)), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("biased", [True, False])
def test_temporal_pass_matches_jax(biased):
    w, h = 32, 32
    sc, psc, _ = _scene()
    jsd, psd, _, motion, _ = _inputs(w, h)
    jcfg, pcfg = _configs(biased=biased)
    key = jax.random.PRNGKey(9)
    rad_all, pdf, bags = _light_inputs(key)
    res = jdi.ris_primary(sc, jsd, bags, pdf, jcfg, w, key, rad_all=rad_all)
    jstate = _history(w, h, key)
    k_t = jax.random.split(key, 6)[2]
    ref = jdi.temporal_pass(sc, jsd, res, jstate, jnp.asarray(motion), jcfg,
                            w, h, k_t, rad_all=rad_all)
    pres = _port_state(jdi.init_state(w * h).replace(reservoir=res)).reservoir
    got = pdi.temporal_pass(
        psc, psd, pres, _port_state(jstate), t(motion), pcfg, w, h,
        ListUniforms([np.asarray(jax.random.uniform(k_t, (w * h,)))]),
        rad_all=t(rad_all))
    # the history was reused, and the M clamp (20 x 32) bit
    assert (np.asarray(ref.m) > 32).mean() > 0.3
    assert np.asarray(jstate.reservoir.m).max() > 20 * 32
    assert np.asarray(ref.m).max() <= 21 * 32 + 1e-3
    _held_reservoir(got, ref, 0.999)


def _spatial_input(w, h, key, biased):
    sc, _, _ = _scene()
    jsd, _, _, motion, _ = _inputs(w, h)
    jcfg = jdi.RestirConfig(biased=biased)
    rad_all, pdf, bags = _light_inputs(key)
    res = jdi.ris_primary(sc, jsd, bags, pdf, jcfg, w, key, rad_all=rad_all)
    return jdi.temporal_pass(sc, jsd, res, _history(w, h, key),
                             jnp.asarray(motion), jcfg, w, h,
                             jax.random.fold_in(key, 3), rad_all=rad_all)


@pytest.mark.parametrize("biased", [True, False])
def test_spatial_pass_matches_jax(biased):
    w, h = 32, 32
    sc, psc, _ = _scene()
    jsd, psd, hit, _, _ = _inputs(w, h)
    jcfg, pcfg = _configs(biased=biased)
    key = jax.random.PRNGKey(13)
    rad_all, _, _ = _light_inputs(key)
    res = _spatial_input(w, h, key, biased)
    k_s = jax.random.split(key, 6)[3]
    ref = jdi.spatial_pass(sc, jsd, res, jnp.asarray(hit), jcfg, w, h, k_s,
                           rad_all=rad_all)
    draws = jax_restir_draws(key, jcfg, w, h)[6:]
    assert len(draws) == 3 * pcfg.spatial_iterations
    pres = _port_state(jdi.init_state(w * h).replace(reservoir=res)).reservoir
    got = pdi.spatial_pass(psc, psd, pres, t(hit), pcfg, w, h,
                           ListUniforms(draws), rad_all=t(rad_all))
    # neighbours were taken
    assert (np.asarray(ref.m) > np.asarray(res.m)).mean() > 0.3
    _held_reservoir(got, ref, 0.99)
    with pytest.raises(TypeError):      # the halo is a DeviceMesh here
        pdi.spatial_pass(psc, psd, pres, t(hit), pcfg, w, h,
                         ListUniforms(draws), halo=("x", 2))


def test_shade_matches_jax():
    w, h = 32, 32
    sc, psc, _ = _scene()
    jsd, psd, hit, _, wo = _inputs(w, h)
    key = jax.random.PRNGKey(17)
    rad_all, _, _ = _light_inputs(key)
    res = _spatial_input(w, h, key, True)
    ref = np.asarray(jdi.shade(sc, jsd, jnp.asarray(wo), res, _jax_eval(sc),
                               jnp.asarray(hit), rad_all=rad_all))
    pres = _port_state(jdi.init_state(w * h).replace(reservoir=res)).reservoir
    got = n(pdi.shade(psc, psd, t(wo), pres, _port_eval(), t(hit),
                      rad_all=t(rad_all)))
    assert ref.mean() > 0
    ok = np.isclose(got, ref, rtol=1e-3, atol=1e-6).all(-1)
    assert ok.mean() >= 0.999, ok.mean()


def _held_state(got: pdi.RestirState, ref, pick_fraction):
    _held_reservoir(got.reservoir, ref.reservoir, pick_fraction)
    for f in ("prev_depth", "prev_normal", "prev_position", "prev_albedo"):
        np.testing.assert_allclose(n(getattr(got, f)),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    assert bool(got.valid) and bool(ref.valid)


@pytest.mark.parametrize("biased", [True, False])
def test_restir_di_matches_jax(biased):
    w, h = 32, 32
    sc, psc, _ = _scene()
    jsd, psd, hit, motion, wo = _inputs(w, h)
    jcfg, pcfg = _configs(biased=biased)
    key = jax.random.PRNGKey(21)
    jstate = _history(w, h, key)
    occ = RecordingOccluder()
    jcolor, jnew = jdi.RestirDI(occ, _jax_eval(sc), jcfg, w, h)(
        sc, jsd, jnp.asarray(wo), jnp.asarray(hit), jnp.asarray(motion),
        jstate, key)
    pcolor, pnew = pdi.RestirDI(occ, _port_eval(), pcfg, w, h)(
        psc, psd, t(wo), t(hit), t(motion), _port_state(jstate),
        ListUniforms(jax_restir_draws(key, jcfg, w, h)))
    assert len(occ.calls) == (4 if biased else 2)
    jcolor = np.asarray(jcolor)
    assert jcolor.mean() > 0
    ok = np.isclose(n(pcolor), jcolor, rtol=1e-3, atol=1e-6).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    _held_state(pnew, jnew, 0.99)


def test_restir_frame_matches_jax():
    """render_wavefront with ReSTIR at 32x32 (tile-candidate RIS), depth 2,
    on the tiled twin against the JAX frame's XLA scan."""
    w = h = 32
    sc, psc, camf = _scene()
    cam = camf(1.0)
    kw = dict(width=w, height=h, max_depth=2, bsdf="disney",
              light_strategy="nee", use_restir=True)
    jcfg = jwf.RenderConfig(**kw)
    jrcfg, prcfg = _configs()
    cs = jstream.build_clusters(sc.tri_pos, cluster_size=16)
    mv = cs.num_clusters
    ji, jo = jtiled.tiled_intersectors(cs, max_visits=mv,
                                       candidate_dtype="float32",
                                       culling="frustum", decode=False)
    key = jax.random.PRNGKey(23)
    ref = jwf.render_wavefront(
        sc, ji, jo, cam, key, jnp.uint32(0), jcfg,
        restir_state=jdi.init_state(w * h),
        restir_fn=jdi.RestirDI(jo, _jax_eval(sc), jrcfg, w, h))
    pi, po = ptiled.tiled_intersectors(port_clusters(cs), mv)
    got = pwf.render_wavefront(
        psc, pi, po, port_camera(cam),
        ListUniforms(jax_frame_uniforms(key, jcfg, w * h, restir_cfg=jrcfg)),
        0, pwf.RenderConfig(**kw),
        restir_state=pdi.init_state(w * h, device="cpu"),
        restir_fn=pdi.RestirDI(po, _port_eval(), prcfg, w, h))
    img_j = np.asarray(jwf.merge_channels(ref))
    img_p = n(pwf.merge_channels(got))
    assert img_j.mean() > 0.01
    ok = np.isclose(img_p, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    _held_state(got["restir_state"], ref["restir_state"], 0.99)


def test_restir_state_carries_across():
    jstate = _history(40, 24, jax.random.PRNGKey(2))
    st = _port_state(jstate)
    assert st.reservoir.light_idx.dtype == torch.int32
    assert st.valid.dtype == torch.bool and st.valid.shape == ()
    for f in dataclasses.fields(pdi.Reservoir):
        np.testing.assert_array_equal(
            n(getattr(st.reservoir, f.name)),
            np.asarray(getattr(jstate.reservoir, f.name)))
    empty = pdi.init_state(6, device="cpu")
    ref = jdi.init_state(6)
    for f in dataclasses.fields(pdi.RestirState):
        if f.name != "reservoir":
            a, b = n(getattr(empty, f.name)), np.asarray(getattr(ref, f.name))
            assert a.shape == b.shape and a.dtype == b.dtype, f.name


# ---------------------------------------------------------------------------
# port-only statistics (bounds of tests/test_restir.py)
# ---------------------------------------------------------------------------

SMALL = dict(candidates=8, num_bags=8, bag_size=128)
REUSE = dict(SMALL, spatial_iterations=2, spatial_samples=3,
             spatial_radius=8)


@functools.lru_cache(maxsize=None)
def _render(use_restir, spp, rcfg_items=(), seed=0, n_boxes=15, size=40):
    b, camf = presets.interior_scene(n_boxes=n_boxes, n_lights=12, seed=3)
    cfg = RenderConfig(width=size, height=size, max_depth=1, bsdf="lambert",
                       light_strategy="nee", use_restir=use_restir,
                       rr_start_depth=99)
    r = Renderer(b.build(), cfg, device="cpu",
                 restir_config=pdi.RestirConfig(**dict(rcfg_items)))
    st = r.init_state(seed)
    for _ in range(spp):
        st, _ = r.render_frame(st, camf(1.0))
    return st.accum.numpy().reshape(size, size, 3)


def test_ris_only_matches_nee():
    img_nee = _render(False, 60)
    img_res = _render(True, 60, tuple(dict(SMALL, spatial_iterations=0)
                                      .items()))
    m_n, m_r = img_nee.mean(), img_res.mean()
    assert abs(m_r - m_n) / m_n < 0.06, (m_r, m_n)
    tiles = lambda a: a.reshape(8, 5, 8, 5, 3).mean((1, 3))
    rel = np.abs(tiles(img_res) - tiles(img_nee)) / (tiles(img_nee) + 0.05)
    assert np.quantile(rel, 0.9) < 0.25


def test_spatial_reuse_open_scene_near_exact():
    a = _render(False, 40, n_boxes=0)
    b = _render(True, 40, tuple(REUSE.items()), n_boxes=0)
    assert abs(b.mean() - a.mean()) / a.mean() < 0.08, (b.mean(), a.mean())


def test_biased_and_unbiased_reuse_in_clutter():
    """Biased reuse darkens where neighbours' visibility disagrees, boundedly;
    the unbiased combine removes it: within 8% of NEE and no farther from
    it than biased + 0.02."""
    img_nee = _render(False, 60)
    r_b = _render(True, 50, tuple(dict(REUSE, biased=True).items())).mean() \
        / img_nee.mean()
    r_u = _render(True, 50, tuple(dict(REUSE, biased=False).items())).mean() \
        / img_nee.mean()
    assert 0.6 < r_b < 1.05, r_b
    assert abs(r_u - 1.0) < 0.08, (r_u, r_b)
    assert abs(r_u - 1.0) <= abs(r_b - 1.0) + 0.02, (r_u, r_b)


def test_reuse_reduces_variance_against_nee():
    rcfg = tuple(dict(SMALL, candidates=16, spatial_iterations=1,
                      spatial_samples=3, spatial_radius=8).items())
    ref = _render(False, 120, seed=7)
    err_nee = np.abs(_render(False, 4, seed=1) - ref).mean()
    err_res = np.abs(_render(True, 4, rcfg, seed=1) - ref).mean()
    assert err_res < err_nee * 0.85, (err_res, err_nee)


def test_temporal_state_and_reservoir_invariants():
    b, camf = presets.interior_scene(n_boxes=15, n_lights=12, seed=3)
    cfg = RenderConfig(width=24, height=24, max_depth=1, bsdf="lambert",
                       light_strategy="nee", use_restir=True,
                       rr_start_depth=99)
    r = Renderer(b.build(), cfg, device="cpu", restir_config=pdi.RestirConfig(
        candidates=4, num_bags=4, bag_size=32, spatial_iterations=0))
    st = r.init_state(0)
    assert not bool(st.restir.valid)
    st, _ = r.render_frame(st, camf(1.0))
    assert bool(st.restir.valid)
    m1 = float(st.restir.reservoir.m.max())
    st, _ = r.render_frame(st, camf(1.0))
    assert float(st.restir.reservoir.m.max()) > m1  # temporal reuse grows M
    assert np.isfinite(st.accum.numpy()).all()
    # the default config, 3 frames: every reservoir field finite and >= 0
    r = Renderer(b.build(), cfg, device="cpu")
    st = r.init_state(0)
    for _ in range(3):
        st, _ = r.render_frame(st, camf(1.0))
    res = st.restir.reservoir
    for f in (res.w_sum, res.m, res.w_out, res.p_hat, res.bary):
        assert torch.isfinite(f).all() and (f >= 0).all()
    assert int(res.light_idx.min()) >= 0
    # a camera move resets the accumulation and keeps the history
    cam = camf(1.0)
    cam.eye[2] -= 0.3
    st2, _ = r.render_frame(st, cam)
    assert st2.blend_count == 1 and bool(st2.restir.valid)
