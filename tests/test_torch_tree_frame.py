"""PyTorch port, a mega frame with tree culling, against the JAX package.

A 32x32, depth-2 frame of `mega_scene(24,000 triangles, 8 lights)` through
`Renderer(culling="tree")` against the JAX Renderer's from the same
uniforms and the same clusters: 99% of pixels within rtol 1e-3, AOVs within
rtol 1e-4 on 99%, as tests/test_torch_integrator.py holds the tiled frame.
"""
import jax
import jax.numpy as jnp
import numpy as np
from _torch_port_helpers import (ListUniforms, jax_frame_uniforms, n,
                                 port_camera, port_clusters, port_scene)

from lumenrenderer_tpu.integrator import wavefront as jwf
from lumenrenderer_tpu.integrator.wavefront import RenderConfig as JConfig
from lumenrenderer_tpu.render.renderer import Renderer as JRenderer
from lumenrenderer_tpu.scene import presets as jpresets
from lumenrenderer_tpu_torch.integrator import wavefront as pwf
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets


def test_mega_frame_matches_jax_with_same_uniforms():
    w = h = 32
    kw = dict(width=w, height=h, max_depth=2, bsdf="disney",
              light_strategy="mis", rr_start_depth=1)
    jb, jcamf = jpresets.mega_scene(n_tris=24_000, n_lights=8)
    jsc, jcam = jb.build(), jcamf(1.0)
    jcfg = JConfig(**kw)
    # a cap of 64: at 24 (the XLA path's default) most tiles overflow and
    # keep clusters that miss (ROADMAP C-12), leaving a mostly black frame
    jr = JRenderer(jsc, jcfg, accel="tiled", culling="tree", max_visits=64,
                   candidate_dtype="float32")
    key = jax.random.PRNGKey(3)
    ref = jwf.render_wavefront(jsc, jr._isect, jr._occl, jcam, key,
                               jnp.uint32(0), jcfg)
    pb, _ = presets.mega_scene(n_tris=24_000, n_lights=8)
    pr = Renderer(pb.build(), RenderConfig(**kw), device="cpu",
                  culling="tree", max_visits=64)
    assert pr.max_visits == jr._tiled_opts["max_visits"]
    # the JAX build's clusters (its native SAH builder may cut others)
    pr.clusters = port_clusters(jr.clusters)
    pr._bind_accel()
    got = pwf.render_wavefront(
        pr.scene, pr._isect, pr._occl, port_camera(jcam),
        ListUniforms(jax_frame_uniforms(key, jcfg, w * h)), 0,
        RenderConfig(**kw))
    np.testing.assert_array_equal(n(pr.scene.tri_pos),
                                  np.asarray(port_scene(jsc).tri_pos))
    img_j = np.asarray(jwf.merge_channels(ref))
    img_p = n(pwf.merge_channels(got))
    assert img_j.mean() > 0.01 and (np.asarray(ref["depth"]) > 0).mean() > 0.3
    ok = np.isclose(img_p, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    for aov in ("depth", "normal", "albedo"):
        good = np.isclose(n(got[aov]), np.asarray(ref[aov]), rtol=1e-4,
                          atol=1e-5).reshape(w * h, -1).all(-1)
        assert good.mean() >= 0.99, aov
    assert bool(got["overflow"]) == bool(ref["overflow"])
