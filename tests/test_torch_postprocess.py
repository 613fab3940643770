"""PyTorch port, post-processing (`render/denoise.py`, `upscale.py`,
`checkpoint.py`, `Renderer.render_sequence`), against the JAX package
(tests/test_postprocess.py's checks).

Inputs are made with numpy from a seed and go through both packages. Held:
the À-Trous filter within 1e-5 of the largest value; `upscale` (Lanczos3
up and antialiased down, linear, sharpened) within 1e-5; temporal
accumulation over JAX's 8-frame pan, output and state within 1e-5 and the
history count exactly; the disocclusion reset; the temporal-then-spatial
pipeline within 1e-5 of the largest value. Port only: resume from a
checkpoint is exact on the CPU (ReSTIR reservoirs included), a JAX
checkpoint is refused, `render_sequence` in its three modes, and the
temporal stage's flicker bar.
"""
import _torch_port_helpers  # noqa: F401  (thread cap under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import n, rng, t

from lumenrenderer_tpu.render import checkpoint as jcheckpoint
from lumenrenderer_tpu.render import denoise as jdenoise
from lumenrenderer_tpu.render import state as jstate
from lumenrenderer_tpu.render import upscale as jupscale
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.render import checkpoint, denoise, upscale
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.restir.di import RestirConfig
from lumenrenderer_tpu_torch.scene import presets


def _edge_image(seed=0, h=64, w=64):
    """tests/test_postprocess.py's two flat regions with an albedo and
    normal edge, plus noise; depth varies so its edge stop acts."""
    g = rng(seed)
    clean = np.zeros((h, w, 3), np.float32)
    clean[:, :w // 2] = 0.8
    clean[:, w // 2:] = 0.2
    noisy = clean + g.normal(0, 0.2, clean.shape).astype(np.float32)
    albedo = g.uniform(0.0, 1.0, clean.shape).astype(np.float32)
    albedo[::7] = 0.01                       # passes through undemodulated
    normal = np.zeros_like(clean)
    normal[:, :w // 2, 2] = 1.0
    normal[:, w // 2:, 0] = 1.0
    depth = (1.0 + g.uniform(0.0, 0.2, (h, w))).astype(np.float32)
    return clean, noisy, albedo, normal, depth


@pytest.mark.parametrize("iterations", [4, 5])
def test_torch_atrous_matches_jax(iterations):
    clean, noisy, albedo, normal, depth = _edge_image()
    args = (noisy, albedo, normal, depth)
    ref = np.asarray(jdenoise.atrous_denoise(*map(jnp.asarray, args),
                                             iterations=iterations))
    got = n(denoise.atrous_denoise(*map(t, args), iterations=iterations))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    # JAX's bar on the flat image: noise halved, the edge kept
    flat = n(denoise.atrous_denoise(t(noisy), t(np.ones_like(clean)),
                                    t(normal), t(np.ones_like(depth)),
                                    iterations=4))
    assert np.abs(flat - clean).mean() < np.abs(noisy - clean).mean() * 0.5
    assert flat[:, :30].mean() > 0.6 and flat[:, 34:].mean() < 0.4


def test_torch_shift2_matches_jax():
    img = rng(1).uniform(size=(9, 7, 3)).astype(np.float32)
    for dy, dx in ((0, 0), (2, -3), (-8, 9), (16, 16)):
        np.testing.assert_array_equal(
            n(denoise._shift2(t(img), dy, dx)),
            np.asarray(jdenoise._shift2(jnp.asarray(img), dy, dx)))


def test_torch_denoise_frame_matches_jax():
    """denoise_frame over a rendered Cornell frame's accumulation and AOVs."""
    b, camf = presets.cornell_box()
    r = Renderer(b.build(), RenderConfig(width=32, height=32, max_depth=3,
                                         bsdf="lambert"),
                 accel="stream", cluster_size=8, device="cpu")
    st, aux = r.render_frame(r.init_state(0), camf(1.0))
    got = n(denoise.denoise_frame(st.accum, aux, 32, 32))
    ref = np.asarray(jdenoise.denoise_frame(
        jnp.asarray(n(st.accum)), {k: jnp.asarray(n(aux[k])) for k in
                                   ("albedo", "normal", "depth")}, 32, 32))
    assert got.shape == (32 * 32, 3) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("src,dst,method,sharpen", [
    ((24, 32), (48, 64), "lanczos3", 0.0),
    ((48, 64), (24, 32), "lanczos3", 0.0),
    ((24, 32), (48, 64), "linear", 0.0),
    ((24, 32), (48, 64), "lanczos3", 0.3),
    ((30, 20), (30, 45), "lanczos3", 0.0),
])
def test_torch_upscale_matches_jax(src, dst, method, sharpen):
    img = rng(2).random(src + (3,)).astype(np.float32)
    ref = np.asarray(jupscale.upscale(jnp.asarray(img), *dst, method=method,
                                      sharpen=sharpen))
    got = n(upscale.upscale(t(img), *dst, method=method, sharpen=sharpen))
    assert got.shape == ref.shape == dst + (3,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    if sharpen:
        assert got.min() >= 0.0 and np.isfinite(got).all()


def _pan_frames(seed=2, h=48, w=48, frames=8):
    """tests/test_postprocess.py's pan: stripes moving 1px a frame, with
    exact motion vectors and Gaussian noise."""
    g = rng(seed)
    base = np.zeros((h, w + 8, 3), np.float32)
    base[:, ::4] = 1.0
    for f in range(frames):
        clean = base[:, f:f + w]
        noisy = clean + g.normal(0, 0.25, clean.shape).astype(np.float32)
        motion = np.zeros((h, w, 2), np.float32)
        motion[..., 0] = 1.0 if f > 0 else 0.0
        yield clean, noisy, motion


def _same_state(got, ref, atol=1e-5):
    for f in ("hist", "depth", "normal"):
        np.testing.assert_allclose(n(getattr(got, f)),
                                   np.asarray(getattr(ref, f)), atol=atol)
    np.testing.assert_array_equal(n(got.count), np.asarray(ref.count))


def test_torch_temporal_pan_matches_jax():
    h = w = 48
    normal = np.zeros((h, w, 3), np.float32)
    normal[..., 2] = 1.0
    depth = np.ones((h, w), np.float32)
    js = jdenoise.init_temporal_state(h, w)
    ps = denoise.init_temporal_state(h, w, device="cpu")
    for clean, noisy, motion in _pan_frames():
        js, jout = jdenoise.temporal_accumulate(
            js, jnp.asarray(noisy), jnp.asarray(normal), jnp.asarray(depth),
            jnp.asarray(motion))
        ps, pout = denoise.temporal_accumulate(ps, t(noisy), t(normal),
                                               t(depth), t(motion))
        np.testing.assert_allclose(n(pout), np.asarray(jout), atol=1e-5)
        _same_state(ps, js)
    # JAX's bar: the reprojected history beats one frame's noise
    assert (np.abs(n(pout) - clean).mean()
            < np.abs(noisy - clean).mean() * 0.55)
    assert float(ps.count.median()) > 4.0


def test_torch_temporal_rejects_disocclusion():
    h = w = 32
    normal = np.zeros((h, w, 3), np.float32)
    normal[..., 2] = 1.0
    depth0 = np.full((h, w), 5.0, np.float32)
    depth0[:, :w // 2] = 1.0
    c0 = np.zeros((h, w, 3), np.float32)
    c0[:, :w // 2] = 1.0
    depth1 = np.full((h, w), 5.0, np.float32)
    c1 = np.zeros((h, w, 3), np.float32)
    zero = np.zeros((h, w, 2), np.float32)
    js = jdenoise.init_temporal_state(h, w)
    ps = denoise.init_temporal_state(h, w, device="cpu")
    for c, d in ((c0, depth0), (c1, depth1)):
        js, jout = jdenoise.temporal_accumulate(
            js, jnp.asarray(c), jnp.asarray(normal), jnp.asarray(d),
            jnp.asarray(zero))
        ps, pout = denoise.temporal_accumulate(ps, t(c), t(normal), t(d),
                                               t(zero))
        np.testing.assert_allclose(n(pout), np.asarray(jout), atol=1e-6)
        _same_state(ps, js, atol=1e-6)
    assert float(pout[:, :w // 2 - 1].abs().max()) < 1e-5


def test_torch_temporal_denoise_frame_matches_jax():
    """Two frames of the temporal-then-spatial pipeline over flat AOVs with
    a reprojecting motion field and a depth edge."""
    g = rng(4)
    h, w = 24, 32
    nn = h * w
    normal = np.zeros((nn, 3), np.float32)
    normal[:, 2] = 1.0
    depth = np.where(np.arange(nn) % w < 12, 1.0, 3.0).astype(np.float32)
    albedo = g.uniform(0.0, 1.0, (nn, 3)).astype(np.float32)
    motion = np.tile(np.float32([0.5, -0.25]), (nn, 1))
    aovs = {"albedo": albedo, "normal": normal, "depth": depth,
            "motion": motion}
    js = jdenoise.init_temporal_state(h, w)
    ps = denoise.init_temporal_state(h, w, device="cpu")
    for _ in range(2):
        frame = g.uniform(0.0, 2.0, (nn, 3)).astype(np.float32)
        js, jout = jdenoise.temporal_denoise_frame(
            js, jnp.asarray(frame), {k: jnp.asarray(v)
                                     for k, v in aovs.items()}, w, h)
        ps, pout = denoise.temporal_denoise_frame(
            ps, t(frame), {k: t(v) for k, v in aovs.items()}, w, h)
        ref = np.asarray(jout)
        assert np.abs(n(pout) - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_array_equal(n(ps.count), np.asarray(js.count))


# -- checkpoints and sequences (port only) ----------------------------------

def _cornell_renderer(restir=False, size=16, accel="stream"):
    b, camf = presets.cornell_box(with_blocks=True)
    cfg = RenderConfig(width=size, height=size, max_depth=2, bsdf="lambert",
                       light_strategy="nee" if restir else "mis",
                       use_restir=restir)
    r = Renderer(b.build(), cfg, accel=accel, cluster_size=8, device="cpu",
                 restir_config=RestirConfig() if restir else None)
    return r, camf(1.0)


@pytest.mark.parametrize("restir", [False, True])
def test_torch_checkpoint_resume_exact(tmp_path, restir):
    r, cam = _cornell_renderer(restir)
    st = r.init_state(3)
    for _ in range(2):
        st, _ = r.render_frame(st, cam)
    p = str(tmp_path / "ckpt.npz")
    checkpoint.save_state(p, st)
    resumed = checkpoint.load_state(p, r.init_state(999))
    assert resumed.frame_index == 2 and resumed.blend_count == 2
    assert resumed.camera_sig == st.camera_sig
    np.testing.assert_array_equal(n(resumed.accum), n(st.accum))
    if restir:
        assert bool(st.restir.valid) and bool(resumed.restir.valid)
        for f in ("light_idx", "bary", "w_sum", "m", "w_out", "p_hat"):
            a = getattr(resumed.restir.reservoir, f)
            assert a.dtype == getattr(st.restir.reservoir, f).dtype
            np.testing.assert_array_equal(
                n(a), n(getattr(st.restir.reservoir, f)))
    a, _ = r.render_frame(st, cam)
    b, _ = r.render_frame(resumed, cam)
    np.testing.assert_array_equal(n(a.accum), n(b.accum))
    if restir:
        np.testing.assert_array_equal(n(a.restir.reservoir.w_out),
                                      n(b.restir.reservoir.w_out))


def test_torch_checkpoint_refuses_jax(tmp_path):
    p = str(tmp_path / "jax.npz")
    jcheckpoint.save_state(p, jstate.init_state(16 * 16, 0))
    r, _ = _cornell_renderer()
    with pytest.raises(ValueError, match="threefry"):
        checkpoint.load_state(p, r.init_state(0))
    # and a state without reservoirs is not read into one with them
    q = str(tmp_path / "plain.npz")
    checkpoint.save_state(q, r.init_state(0))
    r2, _ = _cornell_renderer(restir=True)
    with pytest.raises(ValueError, match="ReSTIR"):
        checkpoint.load_state(q, r2.init_state(0))


@pytest.mark.parametrize("mode", ["temporal", "spatial", "off"])
def test_torch_render_sequence_modes(mode):
    from lumenrenderer_tpu_torch.core.camera import Camera

    r, cam = _cornell_renderer(size=24)
    cam2 = Camera.look_at(eye=(0.52, 0.5, 2.2), target=(0.52, 0.5, 0.0),
                          fov_y_deg=40.0).with_previous(cam, 40.0)
    imgs = r.render_sequence([cam, cam2], spp=2, denoise=mode, seed=9)
    assert len(imgs) == 2
    assert all(i.shape == (24, 24, 3) and np.isfinite(i).all() for i in imgs)
    if mode == "off":
        # frame f is spp frames from init_state(seed + f)
        np.testing.assert_array_equal(imgs[1], r.render(cam2, spp=2,
                                                        seed=10))
    else:
        assert not np.array_equal(imgs[0], r.render(cam, spp=2, seed=9))


def test_torch_sequence_temporal_reduces_flicker():
    """tests/test_postprocess.py's bar: on a static camera the temporal
    stage (without the spatial one) cuts the frame-to-frame flicker of
    independent 1-spp frames below 0.65 of the raw frames'."""
    b, camf = presets.cornell_box()
    r = Renderer(b.build(), RenderConfig(width=48, height=48, max_depth=2,
                                         bsdf="lambert"),
                 accel="brute", device="cpu")
    cam = camf(1.0)
    raw, aovs = [], []
    for f in range(3):
        st, aux = r.render_frame(r.init_state(5 + f), cam)
        raw.append(st.accum)
        aovs.append(aux)
    ts = denoise.init_temporal_state(48, 48, device="cpu")
    outs = []
    for f in range(3):
        ts, out = denoise.temporal_denoise_frame(ts, raw[f], aovs[f], 48, 48,
                                                 spatial=False)
        outs.append(n(out))
    flick_t = np.abs(outs[2] - outs[1]).mean()
    flick_r = np.abs(n(raw[2]) - n(raw[1])).mean()
    assert flick_t < flick_r * 0.65, (flick_t, flick_r)
