"""PyTorch port, pixel gradients through the tiled frame, against the JAX
package (the checks of tests/test_gradients.py).

Both sides render the Cornell box with blocks at 16x16 through the tiled
intersector over the same 32-triangle clusters (the port's twin of K1, the
JAX package's XLA scan), with the JAX frame's own draws injected into the
port. The jitter is random: a centred ray through the corner pixel grazes
the box's edge, where the two scans may split a tie differently.

The port's torch.autograd gradients against jax.grad of the JAX frame:
emission, the environment, albedo and Disney roughness rtol 1e-3 (the last
two with the same sign; a live MIS weight would move roughness's by 0.3%);
each of the port's gradients against its own central difference with the
JAX tests' tolerances; remat=True against remat=False (values rtol 1e-6,
gradients rtol 1e-5, the same draws in the same order); a backward under
detect_anomaly; a ReSTIR frame's emissive gradient; the light table's.
The Disney albedo gradient is NaN on the JAX side (the transmission lobe's
sqrt of a black base color), so it is held only for being finite on the
port's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import (ListUniforms, jax_frame_uniforms, n,
                                 port_camera, port_clusters, port_scene, rng,
                                 t)

from lumenrenderer_tpu.accel import stream as jstream
from lumenrenderer_tpu.accel import tiled as jtiled
from lumenrenderer_tpu.integrator import nee as jnee
from lumenrenderer_tpu.integrator import wavefront as jwf
from lumenrenderer_tpu.restir import di as jdi
from lumenrenderer_tpu.scene import presets as jpresets
from lumenrenderer_tpu_torch.accel import tiled as ptiled
from lumenrenderer_tpu_torch.integrator import nee as pnee
from lumenrenderer_tpu_torch.integrator import wavefront as pwf
from lumenrenderer_tpu_torch.restir import di as pdi

W = H = 16
KEY = 42
CONFIGS = {
    "lambert": dict(width=W, height=H, max_depth=3, bsdf="lambert",
                    light_strategy="mis", rr_start_depth=99),
    "disney": dict(width=W, height=H, max_depth=3, bsdf="disney",
                   light_strategy="mis", rr_start_depth=99),
}
# the parameters held: scales of emission, albedo and roughness, a constant
# environment (and every material's emissive row)
P0 = {"em": 1.0, "alb": 1.0, "rough": 1.0, "env": 0.5}


@functools.lru_cache(maxsize=None)
def _setup():
    jb, camf = jpresets.cornell_box(with_blocks=True)
    sc, cam = jb.build(), camf(1.0)
    cs = jstream.build_clusters(sc.tri_pos, cluster_size=32)
    mv = cs.num_clusters
    jq = jtiled.tiled_intersectors(cs, max_visits=mv,
                                   candidate_dtype="float32",
                                   culling="frustum", decode=False)
    pq = ptiled.tiled_intersectors(port_clusters(cs), mv)
    return sc, cam, jq, port_scene(sc), port_camera(cam), pq


def _apply(scene, p, full):
    m = scene.materials
    return scene.replace(
        materials=m.replace(emissive=p["emissive"] * p["em"],
                            base_color=m.base_color * p["alb"],
                            roughness=m.roughness * p["rough"]),
        env_radiance=full(p["env"]))


@functools.lru_cache(maxsize=None)
def _jax_grads(name):
    """(value, {param: gradient}) of the JAX frame's mean at P0."""
    sc, cam, (ji, jo), _, _, _ = _setup()
    cfg = jwf.RenderConfig(**CONFIGS[name])

    def loss(p):
        sc2 = _apply(sc, p, lambda e: jnp.full((3,), e))
        out = jwf.render_wavefront(sc2, ji, jo, cam, jax.random.PRNGKey(KEY),
                                   jnp.uint32(0), cfg)
        return jwf.merge_channels(out).mean()

    p = {k: jnp.float32(v) for k, v in P0.items()}
    p["emissive"] = sc.materials.emissive
    v, g = jax.jit(jax.value_and_grad(loss))(p)
    return float(v), {k: np.asarray(x) for k, x in g.items()}


def _draws(name, **kw):
    cfg = jwf.RenderConfig(**{**CONFIGS[name], **kw})
    return jax_frame_uniforms(jax.random.PRNGKey(KEY), cfg, W * H)


def _port(name, params=None, grad=True, src=None, **kw):
    """(value, {param: gradient} or None, the draw source) of the port's
    frame mean, at P0 updated by `params`, with the JAX frame's draws (or
    the source `src`); kw updates the RenderConfig."""
    _, _, _, psc, pcam, (pi, po) = _setup()
    p = {k: torch.tensor(v, requires_grad=grad)
         for k, v in {**P0, **(params or {})}.items()}
    p["emissive"] = psc.materials.emissive.clone().requires_grad_(grad)
    src = src if src is not None else ListUniforms(_draws(name, **kw))
    with torch.set_grad_enabled(grad):
        out = pwf.render_wavefront(
            _apply(psc, p, lambda e: e * torch.ones(3)), pi, po, pcam, src, 0,
            pwf.RenderConfig(**{**CONFIGS[name], **kw}))
        v = pwf.merge_channels(out).mean()
        if grad:
            v.backward()
    if not grad:
        return float(v), None, src
    return float(v.detach()), {k: n(t.grad) for k, t in p.items()}, src


@pytest.mark.parametrize("name", ["lambert", "disney"])
def test_gradients_match_jax(name):
    jv, jg = _jax_grads(name)
    pv, pg, src = _port(name)
    assert src.arrays == []
    np.testing.assert_allclose(pv, jv, rtol=1e-5)
    for k in ("em", "env"):
        assert jg[k] > 0
        np.testing.assert_allclose(pg[k], jg[k], rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(pg["emissive"], jg["emissive"], rtol=1e-3,
                               atol=1e-7)
    light_rows = n(_setup()[3].materials.emissive).max(-1) > 0
    assert (pg["emissive"][light_rows] > 0).all()
    assert (pg["emissive"] >= 0).all()
    if name == "lambert":
        assert pg["rough"] == 0 and jg["rough"] == 0
        held = ("alb",)
    else:
        assert np.isnan(jg["alb"]) and np.isfinite(pg["alb"])
        held = ("rough",)
    for k in held:
        assert jg[k] != 0 and np.sign(pg[k]) == np.sign(jg[k]), k
        np.testing.assert_allclose(pg[k], jg[k], rtol=1e-3, err_msg=k)


# (config, parameter, step, rtol, atol): tests/test_gradients.py's central
# differences; the image is linear in emission and in the environment
CENTRAL = [("lambert", "em", 0.25, 2e-3, 0.0),
           ("lambert", "alb", 0.02, 2e-2, 0.0),
           ("lambert", "env", 0.1, 2e-3, 1e-6),
           ("disney", "em", 0.25, 2e-3, 0.0),
           ("disney", "env", 0.1, 2e-3, 1e-6)]


@pytest.mark.parametrize("name,param,step,rtol,atol", CENTRAL)
def test_gradient_matches_central_difference(name, param, step, rtol, atol):
    _, g, _ = _port(name)
    x0 = P0[param]
    hi, _, _ = _port(name, {param: x0 + step}, grad=False)
    lo, _, _ = _port(name, {param: x0 - step}, grad=False)
    fd = (hi - lo) / (2 * step)
    assert g[param] > 0
    np.testing.assert_allclose(g[param], fd, rtol=rtol, atol=atol)


class _Recording(ListUniforms):
    def __init__(self, arrays):
        super().__init__(arrays)
        self.shapes = []

    def _pop(self, shape, kind):
        self.shapes.append(shape)
        return super()._pop(shape, kind)


def test_remat_changes_neither_values_nor_gradients():
    """Depths >= 1 recomputed in the backward give the frame's values and
    gradients, from the same draws in the same order (Russian roulette from
    depth 2 draws inside the recomputed depths)."""
    got = {}
    deeper = dict(max_depth=4, rr_start_depth=2)
    for remat in (False, True):
        src = _Recording(_draws("disney", **deeper))
        v, g, _ = _port("disney", src=src, remat=remat, **deeper)
        assert src.arrays == []
        got[remat] = v, g, src.shapes
    (v0, g0, s0), (v1, g1, s1) = got[False], got[True]
    assert s0 == s1 and (W * H,) in s0[-3:]
    np.testing.assert_allclose(v1, v0, rtol=1e-6)
    assert g0["em"] > 0
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=1e-5, atol=1e-9,
                                   err_msg=k)


def test_detach_sampling_off_keeps_lambert_gradients():
    """With detach_sampling off, gradients also flow through the sampled
    directions, pdfs and MIS weights; under Lambert none of those depends on
    a material parameter, so the gradients are the detached ones."""
    v0, g0, _ = _port("lambert")
    v1, g1, _ = _port("lambert", detach_sampling=False)
    assert v1 == v0
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("remat", [False, True])
def test_backward_under_detect_anomaly(remat):
    """No backward function of the Disney frame makes a NaN (every
    parameter, the albedo's black light rows included)."""
    with torch.autograd.detect_anomaly():
        _, g, _ = _port("disney", remat=remat)
    for k, v in g.items():
        assert np.isfinite(v).all(), k


@pytest.mark.parametrize("selection", ["cdf", "uniform"])
def test_light_table_gradient_matches_jax(selection):
    """The light table's selection weights carry no gradient and its
    radiance columns do: a weighted sum of the table differentiated with
    respect to every material's emissive, 8 lights of their own colours."""
    jb, _ = jpresets.interior_scene(40, 8)
    sc = jb.build()
    psc = port_scene(sc)
    wts = rng(3).normal(size=(sc.lights.capacity, 17)).astype(np.float32)

    def jloss(em):
        sc2 = sc.replace(materials=sc.materials.replace(emissive=em))
        return (jnee.build_light_table(sc2, selection).aug * wts).sum()

    jg = np.asarray(jax.grad(jloss)(sc.materials.emissive))
    em = psc.materials.emissive.clone().requires_grad_()
    table = pnee.build_light_table(
        psc.replace(materials=psc.materials.replace(emissive=em)), selection)
    (table.aug * t(wts)).sum().backward()
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(n(em.grad), jg, rtol=1e-5, atol=1e-5)


def test_intersectors_see_no_gradient():
    """The frame detaches what it hands the intersectors, sorted or not
    (the spies see it), and `_detached`, through which it calls them, also
    detaches what they return."""
    _, _, _, psc, pcam, (pi, po) = _setup()
    seen = []

    def spy(query):
        def call(o, d, tn, tx):
            seen.append([x.requires_grad for x in (o, d, tx)
                         if isinstance(x, torch.Tensor)])
            return query(o, d, tn, tx)
        return call

    em = psc.materials.emissive.clone().requires_grad_()
    sc2 = psc.replace(materials=psc.materials.replace(emissive=em))
    out = pwf.render_wavefront(sc2, spy(pi), spy(po), pcam,
                               ListUniforms(_draws("disney")), 0,
                               pwf.RenderConfig(**CONFIGS["disney"]))
    pwf.merge_channels(out).mean().backward()
    assert len(seen) == 2 * CONFIGS["disney"]["max_depth"]
    assert not any(any(s) for s in seen)
    assert (n(em.grad) >= 0).all() and n(em.grad).max() > 0

    # an intersector whose outputs are live
    live = torch.tensor(2.0, requires_grad=True)
    o = torch.zeros(4, 3)
    hits = pwf._detached(lambda o, d, tn, tx: {"t": tx * live,
                                                "tri": torch.zeros(4)})(
        o, o, 0.0, o[:, 1])
    t_out = pwf._detached(lambda o, d, tn, tx: tx * live)(o, o, 0.0, o[:, 1])
    assert not any(v.requires_grad for v in (*hits.values(), t_out))


def test_replay_holds_a_recompute_to_what_its_forward_recorded():
    """A checkpointed depth's draw source and occluder return on each later
    pass what the first pass recorded, in order; a pass that asks for more,
    or runs to its end having asked for fewer, raises."""
    draws = iter(range(10))
    asks = [3]

    def body(x, uni, occl):
        return [uni() for _ in range(asks[0])] + [occl(x)]

    src, occl = pwf._Replay(lambda: next(draws)), pwf._Replay(lambda x: -x)
    run = pwf._replayed(body, src, occl)
    assert run(5) == [0, 1, 2, -5]
    assert run(7) == [0, 1, 2, -5]
    assert next(draws) == 3
    for asks[0] in (4, 2):
        with pytest.raises(RuntimeError, match="recomputed depth"):
            run(5)


def test_restir_gradient_matches_jax():
    """The emissive gradient of a ReSTIR frame (depth 0's direct light from
    one 16x16 candidate tile): the target pdf, W and G carry none."""
    sc, cam, (ji, jo), psc, pcam, (pi, po) = _setup()
    kw = dict(width=W, height=H, max_depth=2, bsdf="disney",
              light_strategy="nee", use_restir=True)
    jcfg = jwf.RenderConfig(**kw)
    jr = jdi.RestirConfig()
    key = jax.random.PRNGKey(KEY)

    def jloss(em):
        sc2 = sc.replace(materials=sc.materials.replace(emissive=em))
        fn = jdi.RestirDI(jo, lambda sd, wo, wi: jwf._bsdf_eval(
            jcfg, sd, sc2.materials, wo, wi), jr, W, H)
        out = jwf.render_wavefront(sc2, ji, jo, cam, key, jnp.uint32(0), jcfg,
                                   restir_state=jdi.init_state(W * H),
                                   restir_fn=fn)
        return jwf.merge_channels(out).mean()

    jv, jg = jax.jit(jax.value_and_grad(jloss))(sc.materials.emissive)
    pcfg = pwf.RenderConfig(**kw)
    em = psc.materials.emissive.clone().requires_grad_()
    sc2 = psc.replace(materials=psc.materials.replace(emissive=em))
    fn = pdi.RestirDI(po, lambda sd, wo, wi: pwf._bsdf_eval(pcfg, sd, wo, wi),
                      pdi.RestirConfig(), W, H)
    src = ListUniforms(jax_frame_uniforms(key, jcfg, W * H, restir_cfg=jr))
    out = pwf.render_wavefront(sc2, pi, po, pcam, src, 0, pcfg,
                               restir_state=pdi.init_state(
                                   W * H, device="cpu"),
                               restir_fn=fn)
    v = pwf.merge_channels(out).mean()
    v.backward()
    assert src.arrays == []
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5)
    jg = np.asarray(jg)
    assert jg.max() > 0
    np.testing.assert_allclose(n(em.grad), jg, rtol=1e-3, atol=1e-7)
