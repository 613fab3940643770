"""PyTorch port, the renderer and the slice as a whole.

- Furnace: analytic value albedo*env, atol 2e-3 (as tests/test_integrator.py).
- Cornell 16x16, 32 spp, Lambert, MIS: the port's mean image against the JAX
  Renderer's and against the numpy oracle tests/reference_pt.py. The RNG
  streams differ, so the bound is statistical: the image means may differ by
  at most 4 standard errors of their difference, with each standard error
  taken from the spread of that side's 32 per-frame means (the oracle's
  taken to equal the port's, the same estimator).
- Import isolation: the port never brings jax into a process.
"""
import pathlib
import subprocess
import sys

import _torch_port_helpers  # noqa: F401  (thread cap under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumenrenderer_tpu.core.camera import generate_primary_rays as jrays
from lumenrenderer_tpu.integrator.wavefront import RenderConfig as JConfig
from lumenrenderer_tpu.render.renderer import Renderer as JRenderer
from lumenrenderer_tpu.scene import presets as jpresets
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.render import state as pstate
from lumenrenderer_tpu_torch.render import tonemap
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from reference_pt import render_reference  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("strategy", ["bsdf", "mis", "nee"])
def test_furnace_exact(strategy):
    albedo, env = 0.6, 1.0
    b, camf = presets.furnace_scene(albedo=albedo, env=env)
    r = Renderer(b.build(), RenderConfig(
        width=16, height=16, max_depth=3, bsdf="lambert",
        light_strategy=strategy, rr_start_depth=99), device="cpu")
    img = r.render(camf(1.0), spp=2)
    np.testing.assert_allclose(img, albedo * env, atol=2e-3)


def _frame_means(render_frame, st, cam, spp):
    """Per-frame image means and the final accumulated image."""
    means, prev = [], None
    for i in range(spp):
        st, _ = render_frame(st, cam)
        acc = np.asarray(st.accum, np.float64)
        frame = acc * (i + 1) - (prev * i if prev is not None else 0.0)
        means.append(frame.mean())
        prev = acc
    return np.array(means), prev


def test_cornell_mean_matches_jax_and_oracle():
    w = h = 16
    spp = 32
    kw = dict(width=w, height=h, max_depth=3, bsdf="lambert",
              light_strategy="mis", rr_start_depth=99, jitter="center")
    jb, jcamf = jpresets.cornell_box(with_blocks=True)
    jsc, jcam = jb.build(), jcamf(1.0)
    jr = JRenderer(jsc, JConfig(**kw), accel="tiled", use_pallas=False,
                   culling="frustum")
    jm, jimg = _frame_means(jr.render_frame, jr.init_state(3), jcam, spp)

    pb, pcamf = presets.cornell_box(with_blocks=True)
    pr = Renderer(pb.build(), RenderConfig(**kw), device="cpu")
    pm, pimg = _frame_means(pr.render_frame, pr.init_state(3), pcamf(1.0),
                            spp)
    assert np.isfinite(pimg).all()

    o, d = jrays(jcam, w, h, jnp.uint32(0), jitter="center")
    ref = render_reference(
        np.asarray(jsc.tri_pos, np.float64), np.asarray(jsc.tri_mat),
        np.asarray(jsc.materials.base_color, np.float64),
        np.asarray(jsc.materials.emissive, np.float64),
        np.asarray(o, np.float64), np.asarray(d, np.float64),
        max_depth=3, spp=spp, strategy="mis", seed=7)

    se_p = pm.std(ddof=1) / np.sqrt(spp)
    se_j = jm.std(ddof=1) / np.sqrt(spp)
    bound_j = 4.0 * np.hypot(se_p, se_j)
    bound_o = 4.0 * np.hypot(se_p, se_p)
    assert abs(pimg.mean() - jimg.mean()) <= bound_j, (pimg.mean(),
                                                       jimg.mean(), bound_j)
    assert abs(pimg.mean() - ref.mean()) <= bound_o, (pimg.mean(), ref.mean(),
                                                      bound_o)
    # the same scene: each 4x4 block's mean within 25% of JAX's
    blocks = lambda a: a.reshape(4, 4, 4, 4, 3).mean((1, 3))
    np.testing.assert_allclose(blocks(pimg.reshape(h, w, 3)),
                               blocks(jimg.reshape(h, w, 3)), rtol=0.25,
                               atol=0.02)


def _small_renderer(**kw):
    b, camf = presets.cornell_box(bsdf_extras=True)
    cfg = RenderConfig(width=16, height=16, max_depth=3, **kw)
    return Renderer(b.build(), cfg, device="cpu"), camf


def test_camera_move_resets_accumulation_by_value():
    r, camf = _small_renderer()
    cam = camf(1.0)
    st = r.init_state(0)
    st, _ = r.render_frame(st, cam)
    st, _ = r.render_frame(st, camf(1.0))      # equal pose, new object
    assert st.blend_count == 2
    cam.eye[2] -= 0.3                          # in-place move, same object
    st, aux = r.render_frame(st, cam)
    assert st.blend_count == 1
    stats = r.get_last_frame_stats()
    assert stats["Frame"] == 3 and stats["overflow"] is False
    assert stats["Total Frame Time"] > 0
    assert set(aux) >= {"depth", "normal", "albedo", "motion", "overflow"}
    # two states, two poses: each keeps accumulating on its own
    a, b = r.init_state(1), r.init_state(2)
    other = camf(1.0)
    for _ in range(2):
        a, _ = r.render_frame(a, cam)
        b, _ = r.render_frame(b, other)
    assert (a.blend_count, b.blend_count) == (2, 2)


def test_debug_checks_and_png(tmp_path):
    r, camf = _small_renderer(debug_checks=True)
    path = tmp_path / "cornell.png"
    img = r.render_png(camf(1.0), str(path), spp=2)
    assert np.isfinite(img).all() and img.mean() > 0.01
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and b"IHDR" in data[:40]
    assert tonemap.to_uint8(torch.tensor([0.0, 0.5, 2.0])).tolist() == \
        [0, 128, 255]
    st = pstate.init_state(4, seed=1, device="cpu")
    st = pstate.reset_accumulation(
        pstate.FrameState(torch.ones(4, 3), 5, 5, st.generator))
    assert st.blend_count == 0 and float(st.accum.abs().sum()) == 0.0


def test_renderer_refusals():
    sc = presets.furnace_scene()[0].build()
    cfg = RenderConfig(width=8, height=8)
    for kw in ({"candidate_dtype": "float16"}, {"culling": "sparse"}):
        with pytest.raises(ValueError):
            Renderer(sc, cfg, device="cpu", **kw)
    with pytest.raises(ValueError):     # no such accel
        Renderer(sc, cfg, device="cpu", accel="octree")
    with pytest.raises(ValueError):     # two_level needs the SceneBuilder
        Renderer(sc, cfg, device="cpu", accel="two_level")


def test_port_never_imports_jax():
    code = ("import sys; import lumenrenderer_tpu_torch.render.renderer; "
            "import lumenrenderer_tpu_torch.utils.convert; "
            "import lumenrenderer_tpu_torch.accel.two_level; "
            "import lumenrenderer_tpu_torch.accel.pairs; "
            "import lumenrenderer_tpu_torch.scene.dynamic; "
            "import lumenrenderer_tpu_torch.ops.build; "
            "import lumenrenderer_tpu_torch.ops.visit_scan_instanced; "
            "import lumenrenderer_tpu_torch.ops.pair_scan; "
            "import lumenrenderer_tpu_torch.ops.tree_walk; "
            "import lumenrenderer_tpu_torch.scene.presets; "
            "import lumenrenderer_tpu_torch.scene.cache; "
            "import lumenrenderer_tpu_torch.scene.gltf; "
            "import lumenrenderer_tpu_torch.restir.di; "
            "import lumenrenderer_tpu_torch.parallel.train; "
            "import lumenrenderer_tpu_torch.volume.march; "
            "import lumenrenderer_tpu_torch.volume.nvdb; "
            "import lumenrenderer_tpu_torch.accel.brute; "
            "import lumenrenderer_tpu_torch.accel.stream; "
            "import lumenrenderer_tpu_torch.render.denoise; "
            "import lumenrenderer_tpu_torch.render.upscale; "
            "import lumenrenderer_tpu_torch.render.checkpoint; "
            "import lumenrenderer_tpu_torch.utils.config; "
            "import lumenrenderer_tpu_torch.utils.log; "
            "import lumenrenderer_tpu_torch.utils.profiling; "
            "import lumenrenderer_tpu_torch.app.cli; "
            "import lumenrenderer_tpu_torch.accel.format; "
            "import lumenrenderer_tpu_torch.accel.lbvh; "
            "import lumenrenderer_tpu_torch.accel.traverse; "
            "import lumenrenderer_tpu_torch.ops.bvh_traverse; "
            "import lumenrenderer_tpu_torch.native.bvh_native; "
            "import lumenrenderer_tpu_torch.parallel.shard; "
            "import lumenrenderer_tpu_torch.parallel.distributed; "
            "from lumenrenderer_tpu_torch.accel import sah; "
            "from lumenrenderer_tpu_torch.native import bvh_native; "
            "sah.build_sah([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]]); "
            "assert bvh_native._LIB._name.startswith("
            "str(bvh_native.BUILD_DIR)), bvh_native._LIB; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'chex', 'lumenrenderer_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    sources = (REPO / "lumenrenderer_tpu_torch").rglob("*.py")
    for src in list(sources) + [REPO / "chip_smoke.py"]:
        text = src.read_text()
        for mod in ("jax", "flax", "chex", "lumenrenderer_tpu."):
            assert f"import {mod}" not in text and f"from {mod}" not in text, \
                (src, mod)
