"""The captured training step (`parallel/train.py`) on the card: replayed
steps against plain eager steps from the same draws (loss and gradients
within 1e-5 relative; the row scatter-add sums by atomics, in another
order each run), three steps over each accel the Renderer offers (a
frame with a host wait fails its capture and runs eagerly), an eager
step with no host wait (sync debug mode "error"), and the
`graph_replays` counter, one a replayed step. Run on the card:
`python -m pytest --noconftest tests/test_torch_train_cuda.py -q -m
cuda`; the CPU cases of the same step are in test_torch_train.py."""
import pytest
import torch

from lumenrenderer_tpu_torch.integrator import wavefront as wf
from lumenrenderer_tpu_torch.parallel import train
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets
from lumenrenderer_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda
FITTED = ("base_color", "emissive")
W, H = 160, 96


@pytest.fixture(scope="module")
def fit():
    """(renderer, camera, target, starting parameters) of a small interior
    fit: depth 5, Disney with MIS, remat, the tiled accel and K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    b, camf = presets.interior_scene(n_boxes=60, n_lights=8)
    r = Renderer(b.build(), wf.RenderConfig(
        width=W, height=H, max_depth=5, bsdf="disney", light_strategy="mis",
        remat=True), accel="tiled", device=dev)
    cam = camf(W / H).to(dev)
    st = r.init_state(5)
    for _ in range(2):
        st, _ = r.render_frame(st, cam)
    params = dict(train.split_params(r.scene)[0])
    for k in FITTED:
        params[k] = params[k] * 0.8
    return r, cam, st.accum.clone(), params


def _adam(ps):
    return torch.optim.Adam([ps[k] for k in FITTED], lr=0.01)


def _draws(i):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(100 + i)
    return lambda *shape: torch.rand(shape, generator=gen, device="cuda")


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _against_eager(r, cam, target, params, steps: int) -> int:
    """`steps` steps of the captured step and of plain eager steps from
    the same draws: each loss and gradient within 1e-5 relative, each
    returned loss its own copy. Returns the replays the steps made."""
    init, step = train.make_train_step(r.scene, r._isect, r._occl, cam,
                                       r.config, _adam)
    st = init(params)
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    opt = _adam(leaves)
    losses = []
    profiling.reset()
    try:
        with profiling.recording():
            for i in range(steps):
                st, loss = step(st, _draws(i), i, target)
                losses.append(loss)
                opt.zero_grad(set_to_none=True)
                with torch.enable_grad():
                    out = wf.render_wavefront(
                        train.merge_params(r.scene, leaves), r._isect,
                        r._occl, cam, _draws(i), i, r.config)
                    ref = ((wf.merge_channels(out) - target) ** 2).mean()
                    ref.backward()
                opt.step()
                assert _rel(loss, ref.detach()) < 1e-5, i
                for k in FITTED:
                    assert _rel(st.params[k].grad, leaves[k].grad) < 1e-5, \
                        (i, k)
        replays = profiling.span_table()["spans"]["train.step"][
            "graph_replays"]
    finally:
        profiling.reset()
    assert len({float(x) for x in losses}) == steps
    return replays


def test_replayed_steps_match_eager_steps(fit):
    assert _against_eager(*fit, steps=5) == 4


@pytest.mark.parametrize("accel", ["tiled", "stream", "two_level", "sah",
                                   "bvh", "lbvh", "brute"])
def test_three_steps_over_each_accel(accel):
    """Steps 2 and 3 replay where the accel's frame makes no host wait.
    "stream" waits on its pair compaction, so its capture fails and its
    steps run eagerly; the accels after it capture as before."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    b, camf = presets.interior_scene(n_boxes=20, n_lights=4)
    r = Renderer(b.build(), wf.RenderConfig(
        width=64, height=48, max_depth=3, bsdf="disney",
        light_strategy="mis", remat=True), accel=accel, builder=b,
        device=dev)
    params = dict(train.split_params(r.scene)[0])
    for k in FITTED:
        params[k] = params[k] * 0.8
    target = torch.full((r.config.num_pixels, 3), 0.05, device=dev)
    replays = _against_eager(r, camf(64 / 48).to(dev), target, params, 3)
    assert replays == (0 if accel == "stream" else 2)


def test_eager_step_makes_no_host_wait(fit):
    r, cam, target, params = fit
    init, step = train.make_train_step(r.scene, r._isect, r._occl, cam,
                                       r.config, _adam)
    step(init(params), _draws(0), 0, target)    # kernels built, unwatched
    init, step = train.make_train_step(r.scene, r._isect, r._occl, cam,
                                       r.config, _adam)
    st = init(params)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, loss = step(st, _draws(0), 0, target)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(loss)


def test_graph_replays_count_one_a_replayed_step(fit):
    r, cam, target, params = fit
    init, step = train.make_train_step(r.scene, r._isect, r._occl, cam,
                                       r.config, _adam)
    st = init(params)
    profiling.reset()
    try:
        with profiling.recording():
            for i in range(4):
                st, _ = step(st, _draws(i), i, target)
        rows = profiling.span_table()["spans"]
    finally:
        profiling.reset()
    assert rows["train.step"]["calls"] == 4
    assert rows["train.step"]["graph_replays"] == 3
    assert rows["train.replay"]["calls"] == 3
    assert rows["train.forward"]["calls"] == 1
    assert rows["train.step"]["host_syncs"] == 0
