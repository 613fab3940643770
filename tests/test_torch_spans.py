"""The port's spans and counters (`lumenrenderer_tpu_torch/utils/profiling.py`)
on the CPU: nothing recorded or allocated while nothing records, the span
names in a `torch.profiler` session's events, nesting and self time,
remat's recompute marked as the backward, K1's visit counter on the
frame's own launches, a frame's table taken alone, the held spans kept
bounded, the CLI's `--spans`, and the benchmark's span readers on a traced
CPU run of each cell. The `cuda` cases (CUDA events, allocator and
host-sync counters, timed waits, a sync debug mode the caller set) run on
the card:
`python -m pytest --noconftest tests/test_torch_spans.py -q -m cuda`."""
import importlib.util
import sys
import time
import tracemalloc
import warnings
from pathlib import Path

import pytest
import torch

from lumenrenderer_tpu_torch.accel import tiled
from lumenrenderer_tpu_torch.core import sampling
from lumenrenderer_tpu_torch.integrator import wavefront
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.ops import visit_scan as vs
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets
from lumenrenderer_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
WAVEFRONT = ("wavefront.surface", "wavefront.emission", "wavefront.nee",
             "wavefront.bounce")
FRAME_SPANS = {"frame", "frame.accumulate", "wavefront.primary",
               "wavefront.intersect", *WAVEFRONT, "accel.sort", "accel.cull",
               "accel.k1", "accel.decode"}
# each cell cut to a size the CPU runs in seconds (the kernels' twins)
SMALL = {
    "interior.preview": {"render_config": {"width": 64, "height": 36},
                         "scene": {"n_boxes": 60, "n_lights": 8},
                         "check": {"pixels": 512}},
    "interior_inverse.fit": {"render_config": {"width": 48, "height": 27},
                             "scene": {"n_boxes": 60, "n_lights": 8}},
}


@pytest.fixture(autouse=True)
def clean_log():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _held():
    """The closed spans not yet taken into the totals."""
    return [s for spans in profiling._LOG.held.values() for s in spans]


def _renderer(device="cpu", **cfg):
    b, camf = presets.cornell_box(with_blocks=True)
    r = Renderer(b.build(), RenderConfig(width=32, height=32, max_depth=3,
                                         **cfg), device=device)
    return r, camf(1.0)


def test_spans_off_record_and_allocate_nothing():
    assert not profiling.is_recording()
    off = profiling.span("wavefront.surface", depth=1)
    assert profiling.span("accel.sort") is off
    assert profiling.unit("frame") is off and off.unit is None
    with off as s:
        assert s is off

    def spans(n):
        for d in range(n):
            with profiling.unit("frame"):
                with profiling.span("wavefront.surface", depth=d):
                    pass

    spans(10)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        spans(2000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if "profiling" in str(d.traceback) and d.size_diff > 0]
    assert grown == []
    r, cam = _renderer()
    r.render_frame(r.init_state(0), cam)
    assert "spans" not in r.frame_stats
    assert profiling.span_table() == {"units": 0, "spans": {}}


def test_spans_appear_in_profiler_events_and_table():
    from torch.profiler import profile

    r, cam = _renderer()
    st = r.init_state(0)
    with profile() as prof:
        assert profiling.is_recording()
        st, _ = r.render_frame(st, cam)
    assert not profiling.is_recording()
    names = {e.name for e in prof.events()}
    assert FRAME_SPANS <= names
    table = profiling.span_table()
    assert table["units"] == 1 and set(table["spans"]) == FRAME_SPANS
    rows = table["spans"]
    assert rows["frame"]["calls"] == 1
    assert rows["wavefront.intersect"]["calls"] == 3
    assert rows["wavefront.surface"]["calls"] == 3
    # depths 1-2 sort their bounce rays; every depth sorts its shadow rays
    assert rows["accel.sort"]["calls"] == 2 + 3
    assert rows["accel.k1"]["calls"] == rows["accel.cull"]["calls"] == 3 + 3
    for row in rows.values():
        assert row["device_ms"] is None and row["device_allocs"] is None
        assert 0.0 <= row["host_self_ms"] <= row["host_ms"]
    # outside the profiler nothing more is recorded
    r.render_frame(st, cam)
    assert profiling.span_table()["units"] == 1


def test_nesting_units_and_self_time():
    with profiling.recording():
        with profiling.unit("step") as u:
            with profiling.span("outer"):
                time.sleep(0.02)
                with profiling.span("inner", depth=0):
                    time.sleep(0.03)
                with profiling.span("inner", depth=1):
                    time.sleep(0.01)
        with profiling.unit("step") as u2:
            with profiling.span("inner"):
                pass
        with profiling.span("loose"):
            pass
    assert u.unit is not None and u2.unit == u.unit + 1
    spans = {id(s): s for s in _held()}
    by_name = {}
    for s in _held():
        by_name.setdefault(s.name, []).append(s)
    inner0 = by_name["inner"][0]
    assert inner0.attrs == {"depth": 0} and inner0.parent.name == "outer"
    assert by_name["outer"][0].parent is u
    assert by_name["loose"][0].parent is None
    assert by_name["loose"][0].unit is None
    assert all(s.unit == u.unit for s in by_name["outer"] + by_name["inner"]
               [:2])
    assert len(spans) == 7
    one = profiling.span_table(u.unit)
    assert one["units"] == 1
    rows = one["spans"]
    assert set(rows) == {"step", "outer", "inner"}
    assert rows["inner"]["calls"] == 2
    outer = rows["outer"]
    assert outer["host_self_ms"] == pytest.approx(
        outer["host_ms"] - rows["inner"]["host_ms"])
    assert 20.0 <= outer["host_self_ms"] < 30.0
    assert rows["inner"]["host_ms"] >= 40.0
    assert rows["step"]["host_self_ms"] == pytest.approx(
        rows["step"]["host_ms"] - outer["host_ms"])
    assert all(r["host_syncs"] == 0 for r in rows.values())
    table = profiling.span_table()
    assert table["units"] == 2 and table["spans"]["inner"]["calls"] == 3
    assert table["spans"]["loose"]["calls"] == 1
    profiling.reset()
    assert profiling.span_table() == {"units": 0, "spans": {}}


def test_remat_recompute_is_marked_backward():
    r, cam = _renderer(remat=True)
    em = r.scene.materials.emissive.clone().requires_grad_()
    scene = r.scene.replace(materials=r.scene.materials.replace(emissive=em))
    gen = torch.Generator().manual_seed(0)
    with profiling.recording():
        out = wavefront.render_wavefront(
            scene, r._isect, r._occl, cam, sampling.generator_uniforms(gen),
            0, r.config)
        wavefront.merge_channels(out).mean().backward()
    assert em.grad is not None and torch.isfinite(em.grad).all()
    held = _held()
    rows = profiling.span_table()["spans"]
    # depths 1 and 2 run under checkpoint and again in the backward; their
    # hits and shadow bits are kept, so no query runs there. A recompute
    # stops once it has made what the backward needs (depth 2's before its
    # empty bounce), closing its open spans on the way out.
    for name in WAVEFRONT:
        assert rows[name]["calls"] == 3
    assert rows["wavefront.surface/backward"]["calls"] == 2
    back = {k for k in rows if k.endswith("/backward")}
    assert back == {f"{name}/backward" for name in WAVEFRONT}
    for s in held:
        if s.phase == "backward":
            assert s.attrs["depth"] in (1, 2) and s.parent is None
        else:
            assert s.name in FRAME_SPANS


def test_k1_visit_counter_counts_the_frames_launches():
    r, cam = _renderer()
    calls = []

    def recorder(fn, closest):
        def call(o, d, tn, tx):
            calls.append((o.clone(), d.clone(), tn, tx.clone(), closest))
            return fn(o, d, tn, tx)
        return call

    gen = torch.Generator().manual_seed(3)
    with profiling.recording():
        with torch.no_grad():
            wavefront.render_wavefront(
                r.scene, recorder(r._isect, True), recorder(r._occl, False),
                cam, sampling.generator_uniforms(gen), 0, r.config)
    assert len(calls) == 6
    run = listed = 0
    for o, d, tn, tx, closest in calls:
        q = tiled.scan_inputs(r.clusters, o, d, tn, tx, r.max_visits,
                              r.culling)
        ran = vs.executed_visits_ref(*q["args"], **q["kw"], closest=closest)
        run += int(ran.sum())
        listed += int(q["args"][3].sum())
    rows = profiling.span_table()["spans"]
    k1 = rows["accel.k1"]
    assert k1["calls"] == 6
    assert (k1["k1_visits_run"], k1["k1_visits_listed"]) == (run, listed)
    assert 0 < run <= listed
    assert sum(r_["k1_visits_run"] for r_ in rows.values()) == run
    # the twins a caller binds are called as they are
    twin_isect, _ = tiled.tiled_intersectors(r.clusters, r.max_visits,
                                             scan=vs.visit_scan_ref)
    profiling.reset()
    with profiling.recording():
        twin_isect(*calls[0][:4])
    assert profiling.span_table()["spans"]["accel.k1"]["k1_visits_listed"] \
        == 0


def test_recording_block_fills_frame_stats():
    r, cam = _renderer()
    st = r.init_state(0)
    with profiling.recording():
        st, _ = r.render_frame(st, cam)
        first = r.frame_stats["spans"]
        st, _ = r.render_frame(st, cam)
        second = r.frame_stats["spans"]
    assert first["units"] == second["units"] == 1
    assert set(first["spans"]) == FRAME_SPANS
    assert _held() == []                # each frame's table took its spans
    assert profiling.span_table()["units"] == 2
    fs = profiling.FrameStats(0)
    fs.add_spans(second)
    assert fs.times_ms["frame self host"] == \
        second["spans"]["frame"]["host_self_ms"]
    assert "frame self device" not in fs.times_ms
    r.render_frame(st, cam)
    assert "spans" not in r.frame_stats


def test_held_units_stay_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "HELD_UNITS", 4)
    monkeypatch.setattr(profiling, "HELD_LOOSE_SPANS", 8)
    with profiling.recording():
        for i in range(10):
            with profiling.unit("step"):
                with profiling.span("accel.k1"):
                    profiling.count_visits(torch.full((3,), i),
                                           torch.full((3,), 2 * i))
            assert len([u for u in profiling._LOG.held if u is not None]) \
                <= 4
        for _ in range(20):
            with profiling.span("loose"):
                pass
            assert len(profiling._LOG.held.get(None, ())) <= 8
    # the oldest units went into the totals, resolved: nothing was lost
    table = profiling.span_table()
    assert table["units"] == 10 and _held() == []
    k1 = table["spans"]["accel.k1"]
    assert k1["calls"] == 10
    assert (k1["k1_visits_run"], k1["k1_visits_listed"]) == (135, 270)
    assert table["spans"]["loose"]["calls"] == 20


def test_per_unit_sums_a_field_a_unit():
    assert profiling.per_unit("host_ms") is None      # nothing recorded
    with profiling.recording():
        for _ in range(2):
            with profiling.unit("step"):
                with profiling.span("a"):
                    time.sleep(0.01)
                with profiling.span("b"):
                    profiling.count_visits(torch.tensor([3, 1]),
                                           torch.tensor([4, 4]))
    assert profiling.per_unit("calls", "a") == 1.0
    assert profiling.per_unit("host_ms", "a") >= 10.0
    assert profiling.per_unit("k1_visits_listed") == 8.0
    assert profiling.per_unit("k1_visits_run",
                              lambda k: k in ("a", "b")) == 4.0
    assert profiling.per_unit("host_syncs") == 0.0
    assert profiling.per_unit("host_wait_ms", "step") == 0.0
    assert profiling.per_unit("calls", "none") is None
    assert profiling.per_unit("device_ms", "a") is None     # no CUDA events
    assert profiling.per_unit("device_allocs", "step") is None


def test_cli_spans_prints_mean_self_times():
    from lumenrenderer_tpu_torch.app import cli

    import contextlib
    import io
    import json
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(tmp, "app.json")
        with open(cfg, "w") as f:
            json.dump({"accel": "tiled"}, f)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main([cfg, "--preset", "cornell", "--spp", "2",
                           "--size", "16x16", "--depth", "2", "--cpu",
                           "--spans", "-o", os.path.join(tmp, "o.png")])
    assert rc == 0
    line = [x for x in err.getvalue().splitlines()
            if x.startswith("mean stage times: ")][-1]
    for name in ("frame", "accel.k1", "wavefront.surface"):
        assert f"'{name} self host': " in line
    assert "self device" not in line


@pytest.fixture(scope="module")
def run_mod():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(
        "perfbench_run_spans", ROOT / "perfbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell,number,none", [
    ("interior.preview",
     ("enqueue_ms.preview", "host_syncs.preview", "k1_visits_run_pct"),
     ("sort_ms", "cull_ms")),
    ("interior_inverse.fit", ("host_syncs.fit", "graph_steps_pct.fit"),
     ("recompute_ms", "device_allocs.fit")),
])
def test_traced_cpu_cell_reads_the_program_spans(run_mod, cell, number,
                                                 none):
    from perfbench import spec

    c, res, checks, correct = run_mod.execute(
        cell, 2147483651, 0.5, True, "cpu", t0=time.perf_counter(),
        overrides=SMALL[cell])
    assert correct, checks
    entries = {m["name"]: m for m in c["per_layer"]}
    read = {name: spec.reader(name)(res.layers) for name in entries}
    for name in number:
        assert read[name] is not None and read[name] >= 0.0, name
    for name in none:
        assert name in entries and read[name] is None, name
    # the profiled frames or steps, and nothing after them
    assert profiling.span_table()["units"] == (
        c["traffic"].get("traced_frames") or c["traffic"]["traced_steps"])
    if cell == "interior.preview":
        assert 0.0 < read["k1_visits_run_pct"] <= 100.0
        assert read["host_syncs.preview"] == 0.0     # no waits on the CPU
    else:
        assert read["host_syncs.fit"] == 0.0
        assert read["graph_steps_pct.fit"] == 100.0  # set-up captured it


@pytest.mark.cuda
def test_cuda_events_time_the_device(cuda):
    a = torch.randn(2048, 2048, device=cuda)
    a = a @ a / 2048.0                  # the library's set-up, not timed
    torch.cuda.synchronize()
    with profiling.recording():
        with profiling.unit("step"):
            with profiling.span("outer"):
                for _ in range(4):
                    a = a @ a / 2048.0
                with profiling.span("inner"):
                    for _ in range(8):
                        a = a @ a / 2048.0
    rows = profiling.span_table()["spans"]
    inner, outer = rows["inner"], rows["outer"]
    assert inner["device_ms"] > 0.0 and outer["device_ms"] > inner["device_ms"]
    assert outer["device_self_ms"] == pytest.approx(
        outer["device_ms"] - inner["device_ms"])
    # twice the products take about twice the time
    assert 1.2 < inner["device_ms"] / outer["device_self_ms"] < 4.0
    assert rows["step"]["device_allocs"] is not None


@pytest.mark.cuda
def test_cuda_allocator_counter(cuda):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with profiling.recording():
        with profiling.unit("step"):
            x = torch.empty(3 << 28, dtype=torch.uint8, device=cuda)
        del x
        with profiling.unit("step") as again:
            y = torch.empty(3 << 28, dtype=torch.uint8, device=cuda)
        del y
    assert profiling.span_table(again.unit)["spans"]["step"][
        "device_allocs"] == 0
    table = profiling.span_table()
    assert table["units"] == 2
    assert table["spans"]["step"]["device_allocs"] >= 1


@pytest.mark.cuda
def test_cuda_host_sync_counter(cuda):
    x = torch.ones(1024, device=cuda)
    torch.cuda.synchronize()
    with profiling.recording():
        with profiling.unit("step"):
            with profiling.span("quiet"):
                y = x * 2
            with profiling.span("planted"):
                y.sum().item()
            with profiling.span("waits"):
                profiling.synchronize(cuda)
    rows = profiling.span_table()["spans"]
    assert rows["quiet"]["host_syncs"] == 0
    assert rows["planted"]["host_syncs"] == 1
    assert rows["waits"]["host_syncs"] == 1
    assert rows["step"]["host_syncs"] == 0
    # outside a unit sync debug mode is off again
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_cuda_frame_spans_and_counters(cuda):
    r, cam = _renderer(device=cuda)
    st = r.init_state(0)
    st, _ = r.render_frame(st, cam)
    with profiling.recording():
        st, _ = r.render_frame(st, cam)
    rows = r.frame_stats["spans"]["spans"]
    assert set(rows) == FRAME_SPANS | {"frame.wait"}
    assert all(row["device_ms"] is not None for row in rows.values())
    # the camera's four host copies, the closing wait, the overflow read
    assert sum(row["host_syncs"] for row in rows.values()) >= 6
    assert rows["frame.wait"]["host_syncs"] == 1
    k1 = rows["accel.k1"]
    assert 0 < k1["k1_visits_run"] <= k1["k1_visits_listed"]


@pytest.mark.cuda
def test_cuda_synchronize_times_its_wait(cuda):
    a = torch.randn(4096, 4096, device=cuda)
    torch.cuda.synchronize()
    with profiling.recording():
        with profiling.unit("frame"):
            with profiling.span("work"):
                for _ in range(8):
                    a = a @ a / 4096.0
            with profiling.span("frame.wait"):
                profiling.synchronize(cuda)
    rows = profiling.span_table()["spans"]
    wait = rows["frame.wait"]
    assert wait["host_syncs"] == 1 and wait["host_wait_ms"] > 0.0
    # the wait holds most of the products' device time, and is the span's
    # host time but for the span's own cost
    assert wait["host_wait_ms"] > 0.5 * rows["work"]["device_ms"]
    assert wait["host_wait_ms"] <= wait["host_ms"]
    assert rows["work"]["host_wait_ms"] == 0.0
    assert profiling.per_unit("host_wait_ms") == pytest.approx(
        wait["host_wait_ms"])


@pytest.mark.cuda
def test_cuda_sync_debug_mode_the_caller_set(cuda):
    x = torch.ones(1024, device=cuda)
    try:
        torch.cuda.set_sync_debug_mode(2)
        with profiling.recording():
            with profiling.unit("step"):
                assert torch.cuda.get_sync_debug_mode() == 2
                with pytest.raises(RuntimeError):
                    x.sum().item()
        assert torch.cuda.get_sync_debug_mode() == 2
        torch.cuda.set_sync_debug_mode(1)
        # a mode set to warn still warns, and the wait is counted
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with profiling.recording():
                with profiling.unit("step") as u:
                    x.sum().item()
        assert torch.cuda.get_sync_debug_mode() == 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [str(w.message) for w in caught
            if str(w.message).startswith(profiling.SYNC_WARNING)]
    assert profiling.span_table(u.unit)["spans"]["step"]["host_syncs"] == 1
