"""PyTorch port, the application (`app/cli.py`, `utils/config.py`,
`log.py`, `profiling.py`, `tonemap_aces`, `Renderer(stats_every=)` and
`profile_stages`), against the JAX package (the checks of
tests/test_assets.py's config and CLI tests, tests/test_observability.py
and tests/test_renderer.py's tonemap and profile tests).

Held: `AppConfig`'s defaults equal JAX's, and a file written by either
package loads in the other; the CLI end to end on the CPU writes the
upscaled PNG and the AOVs, and without CUDA and without --cpu exits
non-zero; `tonemap_aces` within 1e-6; `frame_record`'s line and JSON equal
JAX's for the same stats; the logger names; `Profiler.summary` equal to
JAX's; `stats_every` fills the per-stage keys; `profile_stages` returns
JAX's key set.
"""
import dataclasses
import json
import logging
import os
import pathlib
import subprocess
import sys

import _torch_port_helpers  # noqa: F401  (thread cap under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import n, rng, t

from lumenrenderer_tpu.integrator.wavefront import RenderConfig as JConfig
from lumenrenderer_tpu.render import tonemap as jtonemap
from lumenrenderer_tpu.render.renderer import Renderer as JRenderer
from lumenrenderer_tpu.scene import presets as jpresets
from lumenrenderer_tpu.utils import config as jconfig
from lumenrenderer_tpu.utils import log as jlog
from lumenrenderer_tpu.utils import profiling as jprofiling
from lumenrenderer_tpu_torch.app import cli
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.render import tonemap
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets
from lumenrenderer_tpu_torch.utils import config, log, profiling

REPO = pathlib.Path(__file__).resolve().parents[1]
STAGES = ("GeneratePrimaryRays", "Intersect (primary, coherent)",
          "Intersect (bounce, incoherent)", "Occlusion (shadow)",
          "ExtractSurfaceData", "BSDF evaluate", "ShadeDirect sample_light",
          "Total Frame Time")


def test_torch_app_config_defaults_match_jax():
    assert (dataclasses.asdict(config.AppConfig())
            == dataclasses.asdict(jconfig.AppConfig()))


def test_torch_app_config_roundtrip_across_packages(tmp_path):
    p = str(tmp_path / "cfg.json")
    cfg = config.AppConfig.load(p)          # missing: defaults written
    assert os.path.exists(p) and cfg == config.AppConfig()
    cfg.spp, cfg.render_resolution, cfg.accel = 7, (320, 180), "tiled"
    cfg.save(p)
    jcfg = jconfig.AppConfig.load(p)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jcfg.tonemap, jcfg.output_resolution = "aces", (640, 360)
    jcfg.save(p)
    back = config.AppConfig.load(p)
    assert dataclasses.asdict(back) == dataclasses.asdict(jcfg)
    assert back.render_resolution == (320, 180)
    with open(p) as f:
        assert json.load(f) == dataclasses.asdict(jcfg) | {
            "render_resolution": [320, 180], "output_resolution": [640, 360]}


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24],
                                                              "big")


def _cli(args, cwd, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-m", "lumenrenderer_tpu_torch.app.cli", *args],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=300)


def test_torch_cli_end_to_end(tmp_path):
    out = str(tmp_path / "cli.png")
    r = _cli(["--preset", "cornell", "--spp", "2", "--size", "32x32",
              "--out-size", "64x64", "--depth", "2", "-o", out, "--cpu",
              "--aovs"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert _png_size(out) == (64, 64)             # upscaled output
    for name in ("albedo", "normal", "depth"):
        assert _png_size(out.replace(".png", f".{name}.png")) == (32, 32)
    assert "mean stage times" in r.stderr


def test_torch_cli_config_denoise_and_stats(tmp_path):
    """A JSON config (written by the JAX package) naming the tiled accel
    and ACES, with --denoise and --stats-every: the stage times reach the
    summary."""
    p = str(tmp_path / "app.json")
    jcfg = jconfig.AppConfig()
    jcfg.accel, jcfg.tonemap, jcfg.output_path = "tiled", "aces", "o.png"
    jcfg.save(p)
    r = _cli([p, "--size", "24x16", "--spp", "2", "--depth", "2",
              "--denoise", "--stats-every", "1", "--cpu"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert _png_size(str(tmp_path / "o.png")) == (1280, 720)
    assert "accel=tiled" in r.stderr
    assert "Intersect (primary, coherent)" in r.stderr


def test_torch_cli_without_cuda_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI renders on it")
    r = _cli(["--preset", "cornell", "--spp", "1", "--size", "8x8", "-o",
              str(tmp_path / "x.png")], tmp_path)
    assert r.returncode != 0
    assert "RuntimeError" in r.stderr and "device='cpu'" in r.stderr
    assert not os.path.exists(tmp_path / "x.png")
    for flag in ("--mesh", "--distributed"):   # multi-device: the card too
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main([flag, "--preset", "cornell", "--spp", "1"])


def test_torch_tonemap_aces_matches_jax():
    x = rng(0).uniform(-0.5, 8.0, (64, 3)).astype(np.float32)
    for exposure in (1.0, 0.5):
        ref = np.asarray(jtonemap.tonemap_aces(jnp.asarray(x), exposure))
        got = n(tonemap.tonemap_aces(t(x), exposure))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert got.min() >= 0.0 and got.max() <= 1.0


def _records(caplog, fn):
    log.core(), jlog.core()      # configure first: it sets the level
    lg = logging.getLogger("lumen.core")
    with caplog.at_level(logging.DEBUG, logger="lumen.core"):
        lg.propagate = True            # let caplog capture
        try:
            fn()
        finally:
            lg.propagate = False
    out = [r.getMessage() for r in caplog.records]
    caplog.clear()
    return out


@pytest.mark.parametrize("as_json", [False, True])
def test_torch_frame_record_matches_jax(caplog, monkeypatch, as_json):
    if as_json:
        monkeypatch.setenv("LUMEN_LOG_JSON", "1")
    stats = {"Total Frame Time": 12.5, "Frame": 3, "overflow": False,
             "Intersect (primary, coherent)": 1.25}
    got = _records(caplog, lambda: log.frame_record(stats))
    ref = _records(caplog, lambda: jlog.frame_record(stats))
    assert got == ref and len(got) == 1
    if as_json:
        assert json.loads(got[0]) == {"frame_stats": stats}
    else:
        assert "Total_Frame_Time=12.500" in got[0]
    assert log.core().name == jlog.core().name == "lumen.core"
    assert log.client().name == jlog.client().name == "lumen.client"


def test_torch_profiler_summary_matches_jax(tmp_path):
    g = rng(1)
    prof, jprof = profiling.Profiler(window=4), jprofiling.Profiler(window=4)
    for i in range(6):
        times = {"a": float(g.uniform()), "b": float(g.uniform())}
        if i % 2:
            times["c"] = float(g.uniform())
        for p_, fs in ((prof, profiling.FrameStats(i)),
                       (jprof, jprofiling.FrameStats(i))):
            fs.times_ms = dict(times)
            p_.add(fs)
    assert prof.summary() == jprof.summary()
    assert prof.mean_ms("missing") == 0.0
    fs = profiling.FrameStats(0)
    with fs.stage("x", block_on={"t": torch.ones(3)}):
        pass
    with fs.stage("x"):
        pass
    assert fs.times_ms["x"] >= 0.0 and profiling.Timer().measure_ms() >= 0
    assert profiling.device_memory_stats("cpu") == {}
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_torch_stats_every_fills_stage_times():
    b, camf = presets.cornell_box(with_blocks=True)
    cfg = RenderConfig(width=16, height=16, max_depth=2, bsdf="lambert",
                       light_strategy="nee", rr_start_depth=99,
                       sort_secondary=False)
    r = Renderer(b.build(), cfg, accel="tiled", stats_every=2, device="cpu")
    st = r.init_state(0)
    for _ in range(3):
        st, _ = r.render_frame(st, camf(1.0))
    stats = r.get_last_frame_stats()
    for k in STAGES:
        assert k in stats and stats[k] >= 0.0, (k, sorted(stats))
    assert stats["Frame"] == 3 and st.frame_index == 3


def test_torch_profile_stages_keys_match_jax():
    jb, jcamf = jpresets.cornell_box()
    jr = JRenderer(jb.build(), JConfig(width=8, height=8, max_depth=1,
                                       bsdf="lambert"),
                   accel="brute", donate=False)
    ref = jr.profile_stages(jcamf(1.0), reps=1)
    b, camf = presets.cornell_box()
    for accel in ("stream", "brute"):
        r = Renderer(b.build(), RenderConfig(width=8, height=8, max_depth=1,
                                             bsdf="lambert"),
                     accel=accel, cluster_size=8, device="cpu")
        got = r.profile_stages(camf(1.0), reps=1)
        assert set(got) == set(ref) == set(STAGES)
        assert all(np.isfinite(v) and v >= 0.0 for v in got.values())
        assert (r.get_last_frame_stats()["Total Frame Time"]
                == got["Total Frame Time"])
