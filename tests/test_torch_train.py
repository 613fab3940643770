"""PyTorch port, the training step (`parallel/train.py`) against the JAX
package's, on one device.

One SGD step from the same parameters (the JAX `split_params` dict carried
over by `convert.params_from_numpy`) with the same draws: the loss, the
parameters after the step and their moves agree within rtol 1e-3. And the
port's counterpart of tests/test_parallel.py's convergence check
(test_train_converges_on_emission, which the conftest marks slow): Adam
recovers a light twice as bright from a target rendered with it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from _torch_port_helpers import (ListUniforms, jax_frame_uniforms, n,
                                 port_camera, port_clusters, port_scene,
                                 to_numpy_tree)

from lumenrenderer_tpu.accel import stream as jstream
from lumenrenderer_tpu.accel import tiled as jtiled
from lumenrenderer_tpu.integrator import wavefront as jwf
from lumenrenderer_tpu.parallel import train as jtrain
from lumenrenderer_tpu.scene import presets as jpresets
from lumenrenderer_tpu_torch.accel import tiled as ptiled
from lumenrenderer_tpu_torch.core import sampling
from lumenrenderer_tpu_torch.integrator import wavefront as pwf
from lumenrenderer_tpu_torch.parallel import train as ptrain
from lumenrenderer_tpu_torch.utils import convert

KW = dict(width=16, height=16, max_depth=3, bsdf="lambert",
          light_strategy="mis", rr_start_depth=99)


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


def test_train_step_matches_jax_sgd():
    sc, cam, (ji, jo), psc, pcam, (pi, po) = _setup()
    jcfg = jwf.RenderConfig(**KW)
    key = jax.random.PRNGKey(1)
    target = np.full((jcfg.num_pixels, 3), 0.05, np.float32)
    init, step = jtrain.make_train_step(sc, ji, jo, cam, jcfg,
                                        optax.sgd(1e-2))
    jst = init()
    jnew, jloss = jax.jit(step)(jst, key, jnp.uint32(0), jnp.asarray(target))

    params0 = to_numpy_tree(jtrain.split_params(sc)[0])
    pinit, pstep = ptrain.make_train_step(
        psc, pi, po, pcam, pwf.RenderConfig(**KW),
        lambda ps: torch.optim.SGD(ps.values(), lr=1e-2))
    pst = pinit(convert.params_from_numpy(params0))
    assert sorted(pst.params) == sorted(params0)
    src = ListUniforms(jax_frame_uniforms(key, jcfg, jcfg.num_pixels))
    pnew, ploss = pstep(pst, src, 0, torch.from_numpy(target))
    assert src.arrays == [] and pnew.step == 1
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    moved = 0.0
    for k, v0 in params0.items():
        got, want = n(pnew.params[k]), np.asarray(jnew.params[k])
        np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=k)
        np.testing.assert_allclose(got - v0, want - v0, rtol=1e-3,
                                   atol=1e-9, err_msg=k)
        moved = max(moved, float(np.abs(want - v0).max()))
    assert moved > 0


def test_train_recovers_emission():
    """Inverse rendering: Adam recovers a brighter light from a target
    rendered with twice the emission, with the same draws every step."""
    _, _, _, psc, pcam, (pi, po) = _setup()
    cfg = pwf.RenderConfig(**KW)

    def draws():
        return sampling.generator_uniforms(torch.Generator().manual_seed(1))

    params0, _ = ptrain.split_params(psc)
    bright = ptrain.merge_params(
        psc, {**params0, "emissive": params0["emissive"] * 2.0})
    with torch.no_grad():
        target = pwf.merge_channels(pwf.render_wavefront(
            bright, pi, po, pcam, draws(), 0, cfg))
    init, step = ptrain.make_train_step(
        psc, pi, po, pcam, cfg,
        lambda ps: torch.optim.Adam(ps.values(), lr=0.5))
    st = init()
    losses = []
    for _ in range(60):
        st, loss = step(st, draws(), 0, target)
        losses.append(float(loss))
    assert st.step == 60
    assert losses[-1] < losses[0] * 0.35, (losses[-1], losses[0])
    em0 = n(params0["emissive"])
    row = int(np.argmax(em0.max(-1)))
    assert n(st.params["emissive"])[row].mean() > em0[row].mean() * 1.2
    # the scene the step was built on is left as it was
    assert (n(psc.materials.emissive) == em0).all()
