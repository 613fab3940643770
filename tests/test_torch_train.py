"""PyTorch port, the training step (`parallel/train.py`) against the JAX
package's, on one device.

One SGD step from the same parameters (the JAX `split_params` dict carried
over by `convert.params_from_numpy`) with the same draws: the loss, the
parameters after the step and their moves agree within rtol 1e-3. And the
port's counterpart of tests/test_parallel.py's convergence check
(test_train_converges_on_emission, which the conftest marks slow): Adam
recovers a light twice as bright from a target rendered with it.

The captured step on the CPU (the graph's replay is a direct call there,
so these hold its draw plan and its inputs, not a CUDA graph; the card's
cases are in tests/test_torch_train_cuda.py), each step drawing from a
generator of its own: steps 2 on replay, with the same losses, Adam
moments and parameters as plain eager steps; another target shape, other
leaves, a frame that draws otherwise before the capture or a source whose
draws change dtype after it run eagerly, with the numbers of a plain
eager step, and capture anew, never replaying stale inputs; a returned
loss is not overwritten.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
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
from lumenrenderer_tpu_torch.utils import convert, profiling

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


GRAPH_KW = dict(width=16, height=16, max_depth=4, bsdf="disney",
                light_strategy="mis", remat=True)
FITTED = ("base_color", "emissive")


def _draws(i: int):
    """The draw source of step i: a generator of its own, so that what a
    call gets depends on the calls made before it."""
    return sampling.generator_uniforms(
        torch.Generator().manual_seed(1000 + i))


def _adam(ps):
    return torch.optim.Adam([ps[k] for k in FITTED], lr=0.05)


def _start(psc):
    params, _ = ptrain.split_params(psc)
    return {k: (v * 0.9 if k in FITTED else v) for k, v in params.items()}


def _eager_steps(psc, pi, po, pcam, cfg, target, steps):
    """The plain eager loop: zero_grad, frame, loss, backward, Adam."""
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in _start(psc).items()}
    opt = _adam(leaves)
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        out = pwf.render_wavefront(ptrain.merge_params(psc, leaves), pi, po,
                                   pcam, _draws(i), i, cfg)
        loss = ((pwf.merge_channels(out) - target) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return losses, leaves, opt


def _replays() -> int:
    row = profiling.span_table()["spans"].get("train.step")
    return row["graph_replays"] if row else 0


def _expected_loss(psc, pi, po, pcam, cfg, params, src, i, target):
    with torch.no_grad():
        out = pwf.render_wavefront(ptrain.merge_params(psc, params), pi, po,
                                   pcam, src, i, cfg)
        return ((pwf.merge_channels(out) - target) ** 2).mean()


@pytest.fixture
def clean_spans():
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("jitter", ["random", "halton"])
def test_captured_step_matches_eager_steps(jitter, clean_spans):
    _, _, _, psc, pcam, (pi, po) = _setup()
    cfg = pwf.RenderConfig(**GRAPH_KW, jitter=jitter)
    target = torch.full((cfg.num_pixels, 3), 0.05)
    losses, leaves, opt = _eager_steps(psc, pi, po, pcam, cfg, target, 3)
    init, step = ptrain.make_train_step(psc, pi, po, pcam, cfg, _adam)
    st = init(_start(psc))
    got = []
    with profiling.recording():
        for i in range(3):
            st, loss = step(st, _draws(i), i, target)
            got.append(loss)
            assert _replays() == i and st.step == i + 1
    assert profiling.span_table()["spans"]["train.replay"]["calls"] == 2
    for a, b in zip(got, losses):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k in FITTED:
        torch.testing.assert_close(st.params[k], leaves[k], rtol=0, atol=0)
        mine, plain = st.opt.state[st.params[k]], opt.state[leaves[k]]
        for m in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(mine[m], plain[m], rtol=0, atol=0)
        assert not torch.equal(st.params[k], _start(psc)[k])


def test_changed_inputs_run_eagerly_and_capture_anew(clean_spans,
                                                     monkeypatch):
    _, _, _, psc, pcam, (pi, po) = _setup()
    cfg = pwf.RenderConfig(**GRAPH_KW)
    full = torch.full((cfg.num_pixels, 3), 0.05)
    flat = torch.tensor([0.1, 0.05, 0.02])       # another target shape
    init, step = ptrain.make_train_step(psc, pi, po, pcam, cfg, _adam)
    render, extra = pwf.render_wavefront, [False]

    def frame(scene, isect, occl, camera, uniforms, *args, **kw):
        # takes draws of any float dtype; `extra` draws once more first
        if extra[0]:
            uniforms(5)
        return render(scene, isect, occl, camera,
                      lambda *shape: uniforms(*shape).float(), *args, **kw)

    def source(i: int, dtype):
        draws = _draws(i)
        return lambda *shape: draws(*shape).to(dtype)

    monkeypatch.setattr(pwf, "render_wavefront", frame)
    st, dtype, seen = init(_start(psc)), torch.float32, []
    # (what changes before the step, target, replayed): the frame's draws
    # change before a capture, which sees it before anything is drawn; the
    # source's dtype changes after one, which the next fill sees
    plan = [(None, full, False), (None, full, True), (None, full, True),
            (None, flat, False), (None, flat, True),
            ("leaves", flat, False), ("plan", flat, False),
            (None, flat, True), (None, flat, True),
            ("source", flat, False), (None, flat, True),
            ("target", full, False), (None, full, True)]
    with profiling.recording():
        for i, (change, target, replay) in enumerate(plan):
            if change == "leaves":
                st = init({k: v.detach() for k, v in st.params.items()})
            extra[0] = extra[0] or change == "plan"
            if change == "source":
                dtype = torch.float64
            before = {k: v.detach().clone() for k, v in st.params.items()}
            want = _expected_loss(psc, pi, po, pcam, cfg, before,
                                  source(i, dtype), i, target)
            n0 = _replays()
            st, loss = step(st, source(i, dtype), i, target)
            seen.append(_replays() - n0)
            torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    assert seen == [int(r) for _, _, r in plan]
    # after the capture the CPU runs the frame again, and one that leaves
    # the plan raises (a CUDA graph runs what it captured)
    extra[0] = False
    with pytest.raises(RuntimeError, match="asked for"):
        step(st, source(len(plan), dtype), len(plan), full)


def test_returned_losses_stay_as_returned():
    _, _, _, psc, pcam, (pi, po) = _setup()
    cfg = pwf.RenderConfig(**GRAPH_KW)
    target = torch.full((cfg.num_pixels, 3), 0.05)
    init, step = ptrain.make_train_step(psc, pi, po, pcam, cfg, _adam)
    st, losses, values = init(_start(psc)), [], []
    for i in range(3):
        st, loss = step(st, _draws(i), i, target)
        losses.append(loss)
        values.append(float(loss))
    assert [float(x) for x in losses] == values
    assert len(set(values)) == 3
