"""ReSTIR DI's spans and counters (`restir/di.py` through
`utils/profiling.py`), beside `test_torch_spans.py`: the `restir.*` spans
nest under `wavefront.nee` at depth 0 and the visibility spans hold the
occluder's query; `restir_rays_sent` counts each pixel's ray twice a frame
and `restir_rays_live` those that can change the image; the counters are
device tensors read when the table resolves, so recording them adds no
host wait; the benchmark's three ReSTIR readers find nothing in a frame
without ReSTIR; and the `restir.still` cell runs traced and untraced on
the CPU at a small size. The `cuda` case of the host-wait count runs on
the card: `python -m pytest --noconftest tests/test_torch_restir_spans.py
-q -m cuda`."""
import importlib.util
import sys
import time
from pathlib import Path

import pytest
import torch

from lumenrenderer_tpu_torch.core import sampling
from lumenrenderer_tpu_torch.integrator import wavefront
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets
from lumenrenderer_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import spec  # noqa: E402

RESTIR_SPANS = {"restir.cdf", "restir.ris", "restir.visibility",
                "restir.temporal", "restir.spatial", "restir.shade"}
READERS = ("restir_ms", "restir_visibility_ms", "restir_live_rays_pct")
# the cell cut to a size the CPU runs in seconds (the kernels' twins)
SMALL = {"render_config": {"width": 64, "height": 32},
         "scene": {"n_boxes": 40, "n_lights": 16},
         "check": {"rays_per_block": 2048}}


@pytest.fixture(autouse=True)
def clean_log():
    profiling.reset()
    yield
    profiling.reset()


def _renderer(device="cpu", use_restir=True, w=32, h=32):
    b, camf = presets.interior_scene(n_boxes=20, n_lights=8)
    r = Renderer(b.build(), RenderConfig(
        width=w, height=h, max_depth=1, light_strategy="nee",
        use_restir=use_restir), device=device)
    return r, camf(w / h)


def _held():
    return [s for spans in profiling._LOG.held.values() for s in spans]


def test_restir_spans_nest_under_nee_at_depth_0():
    r, cam = _renderer()
    gen = torch.Generator().manual_seed(5)
    st = r.init_state(0)
    with profiling.recording():
        wavefront.render_wavefront(
            r.scene, r._isect, r._occl, cam, sampling.generator_uniforms(gen),
            0, r.config, restir_state=st.restir, restir_fn=r._restir_fn)
    held = _held()
    restir = [s for s in held if s.name.startswith("restir.")]
    assert {s.name for s in restir} == RESTIR_SPANS
    for s in restir:
        assert s.parent.name == "wavefront.nee"
        assert s.parent.attrs == {"depth": 0}
    vis = [s for s in restir if s.name == "restir.visibility"]
    assert len(vis) == 2
    # each holds the sorted occluder's query; its counter is kept as a
    # device tensor until the table resolves it
    for s in vis:
        assert [c.name for c in held if c.parent is s] == ["accel.sort"]
        assert len(s.device_counts) == 1
        assert isinstance(s.device_counts[0][1], torch.Tensor)
    rows = profiling.span_table()["spans"]
    assert rows["restir.visibility"]["calls"] == 2
    assert all(rows[name]["calls"] == 1 for name in RESTIR_SPANS
               - {"restir.visibility"})


def test_restir_rays_sent_and_live():
    w, h = 32, 24
    r, cam = _renderer(w=w, h=h)
    st = r.init_state(1)
    with profiling.recording():
        for _ in range(2):
            st, _ = r.render_frame(st, cam)
            rows = r.frame_stats["spans"]["spans"]
            vis = rows["restir.visibility"]
            assert vis["restir_rays_sent"] == 2 * w * h
            assert 0 < vis["restir_rays_live"] <= vis["restir_rays_sent"]
            assert sum(row["restir_rays_sent"] for row in rows.values()) \
                == 2 * w * h
    # a frame outside the recording counts nothing
    r.render_frame(st, cam)
    assert profiling.span_table()["units"] == 2


def _frame_host_syncs(device, counters: bool, monkeypatch):
    r, cam = _renderer(device=device)
    st, _ = r.render_frame(r.init_state(2), cam)      # kernels built, warm
    with monkeypatch.context() as m:
        if not counters:
            m.setattr(profiling, "is_recording", lambda: False)
        with profiling.recording():
            r.render_frame(st, cam)
    rows = r.frame_stats["spans"]["spans"]
    return (sum(row["host_syncs"] for row in rows.values()),
            rows["restir.visibility"]["restir_rays_sent"])


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda",
                                                 marks=pytest.mark.cuda)])
def test_restir_counters_add_no_host_sync(device, monkeypatch):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    syncs_on, sent_on = _frame_host_syncs(device, True, monkeypatch)
    syncs_off, sent_off = _frame_host_syncs(device, False, monkeypatch)
    assert (sent_on, sent_off) == (2 * 32 * 32, 0)
    assert syncs_on == syncs_off


def test_readers_find_nothing_without_restir_spans():
    r, cam = _renderer(use_restir=False)
    with profiling.recording():
        r.render_frame(r.init_state(0), cam)
    assert "restir.visibility" not in profiling.span_table()["spans"]
    for name in READERS:
        assert spec.reader(name)({"units": 1}) is None, name
    profiling.reset()
    r, cam = _renderer()
    with profiling.recording():
        r.render_frame(r.init_state(0), cam)
    assert 0.0 < spec.reader("restir_live_rays_pct")({}) <= 100.0
    # no CUDA events on the CPU: no device ms
    assert spec.reader("restir_ms")({}) is None
    assert spec.reader("restir_visibility_ms")({}) is None


@pytest.fixture(scope="module")
def run_mod():
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_run_restir", ROOT / "perfbench" / "run.py")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("trace", [False, True])
def test_restir_cell_runs_on_the_cpu(run_mod, trace):
    c, res, checks, correct = run_mod.execute(
        "restir.still", 2147483693, 0.5, trace, "cpu",
        t0=time.perf_counter(), overrides=SMALL)
    assert correct and checks["l1_rel"]["value"] <= 1e-6, checks
    # the snapshot's frames were rendered, the window's among them
    assert res.info["frames"] >= c["traffic"]["check"]["frames"]
    entries = {m["name"] for m in c["per_layer"]}
    assert set(READERS) <= entries
    if not trace:
        assert set(res.e2e) == {"setup_s", "frame_ms", "frame_ms_p90",
                                "peak_mem_gib"}
        assert profiling.span_table()["units"] == 0     # nothing recorded
        return
    read = {name: spec.reader(name)(res.layers) for name in entries}
    assert 0.0 < read["restir_live_rays_pct"] <= 100.0
    assert read["host_syncs.preview"] == 0.0         # no waits on the CPU
    assert read["restir_ms"] is None and read["restir_visibility_ms"] is None
    assert profiling.span_table()["units"] == c["traffic"]["traced_frames"]
