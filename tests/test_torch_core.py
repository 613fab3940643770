"""PyTorch port, core math and camera, against the JAX package.

Tolerance: rtol 1e-5 (float32 elementwise math; the two libraries may round
transcendental functions and reductions differently in the last bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_port_helpers import ListUniforms, n, port_camera, rng, t

from lumenrenderer_tpu.core import camera as jcam
from lumenrenderer_tpu.core import sampling as jsamp
from lumenrenderer_tpu.core import vecmath as jvm
from lumenrenderer_tpu_torch.core import camera as pcam
from lumenrenderer_tpu_torch.core import sampling as psamp
from lumenrenderer_tpu_torch.core import vecmath as pvm

RTOL, ATOL = 1e-5, 1e-6


def _unit(g, m):
    v = g.normal(size=(m, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(n(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["normalize", "reflect", "refract",
                                  "build_onb", "to_world",
                                  "luminance", "length", "cross"])
def test_vecmath_matches_jax(name):
    g = rng(1)
    a = g.normal(size=(257, 3)).astype(np.float32)
    u = _unit(g, 257)
    eta = g.uniform(0.5, 1.8, 257).astype(np.float32)
    args = {
        "normalize": (a,), "reflect": (u, _unit(g, 257)),
        "refract": (-u, _unit(g, 257), eta), "build_onb": (u,),
        "to_world": (a, u), "luminance": (np.abs(a),),
        "length": (a,), "cross": (a, u),
    }[name]
    ref = getattr(jvm, name)(*[jnp.asarray(x) for x in args])
    got = getattr(pvm, name)(*[t(x) for x in args])
    if isinstance(ref, tuple):
        for r_, g_ in zip(ref, got):
            _close(g_, r_)
    else:
        _close(got, ref)


@pytest.mark.parametrize("name", ["sample_cosine_hemisphere",
                                  "sample_triangle", "sample_ggx_vndf",
                                  "power_heuristic", "halton23"])
def test_sampling_matches_jax(name):
    g = rng(2)
    u2 = g.uniform(size=(300, 2)).astype(np.float32)
    if name == "sample_ggx_vndf":
        wo = _unit(g, 300)
        wo[:, 2] = np.abs(wo[:, 2]) + 1e-3
        ax = g.uniform(0.01, 1.0, 300).astype(np.float32)
        ay = g.uniform(0.01, 1.0, 300).astype(np.float32)
        ref = jsamp.sample_ggx_vndf(jnp.asarray(wo), jnp.asarray(ax),
                                    jnp.asarray(u2), roughness_y=jnp.asarray(ay))
        got = psamp.sample_ggx_vndf(t(wo), t(ax), t(u2), roughness_y=t(ay))
        _close(got, ref, atol=1e-5)
        return
    if name == "power_heuristic":
        pa, pb = g.uniform(0, 5, (2, 300)).astype(np.float32)
        pa[::7] = 0.0
        _close(psamp.power_heuristic(t(pa), t(pb)),
               jsamp.power_heuristic(jnp.asarray(pa), jnp.asarray(pb)))
        return
    if name == "halton23":
        idx = np.arange(0, 3000, 7)
        _close(psamp.halton23(t(idx)),
               jsamp.halton23(jnp.asarray(idx, jnp.uint32)))
        return
    _close(getattr(psamp, name)(t(u2)),
           getattr(jsamp, name)(jnp.asarray(u2)))


LOOK_AT = dict(eye=(0.5, 0.4, 2.45), target=(0.45, 0.55, 0.0), fov_y_deg=37.0,
               aspect=1.6)


def test_look_at_matches_jax():
    ref = jcam.Camera.look_at(**LOOK_AT)
    got = pcam.Camera.look_at(**LOOK_AT)
    for f in ("eye", "u", "v", "w", "prev_view_proj", "t_min", "t_max"):
        _close(getattr(got, f), getattr(ref, f), atol=1e-5)


@pytest.mark.parametrize("jitter", ["random", "halton", "center"])
def test_primary_rays_match_jax(jitter):
    cam = jcam.Camera.look_at(**LOOK_AT)
    w, h = 24, 15
    key = jax.random.PRNGKey(5)
    ro, rd = jcam.generate_primary_rays(cam, w, h, jnp.uint32(3), key=key,
                                        jitter=jitter)
    injected = ListUniforms([np.asarray(jax.random.uniform(key, (w * h, 2)))])
    po, pd = pcam.generate_primary_rays(port_camera(cam), w, h, 3,
                                        injected, jitter)
    _close(po, ro)
    _close(pd, rd)


def test_motion_vectors_match_jax():
    g = rng(3)
    prev = jcam.Camera.look_at(**LOOK_AT)
    cam = jcam.Camera.look_at(**{**LOOK_AT, "eye": (0.55, 0.4, 2.4)}
                              ).with_previous(prev, 37.0, 1.6)
    w, h = 16, 10
    pos = g.uniform(-0.5, 1.5, (w * h, 3)).astype(np.float32)
    valid = g.uniform(size=w * h) < 0.8
    ref = jcam.motion_vectors(jnp.asarray(pos), jnp.asarray(valid), cam, w, h)
    pcur = pcam.Camera.look_at(**{**LOOK_AT, "eye": (0.55, 0.4, 2.4)}
                               ).with_previous(port_camera(prev), 37.0, 1.6)
    _close(pcur.prev_view_proj, cam.prev_view_proj, atol=1e-5)
    got = pcam.motion_vectors(t(pos), t(valid), port_camera(cam), w, h)
    _close(got, ref, atol=1e-5)


def test_camera_signature_tracks_values():
    a = pcam.Camera.look_at(**LOOK_AT)
    b = pcam.Camera.look_at(**LOOK_AT)
    assert a.signature() == b.signature()
    a.eye[0] += 0.25  # in-place edit of the same object is a move
    assert a.signature() != b.signature()
