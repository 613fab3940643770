"""Which path runs the Disney BSDF (`bsdf/disney.py`), its ray counters and
the benchmark's reader of them, on the CPU. Kernel D itself runs on the
card: `tests/test_torch_disney_kernel.py`."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from lumenrenderer_tpu_torch.bsdf import disney
from lumenrenderer_tpu_torch.core import vecmath as vm
from lumenrenderer_tpu_torch.integrator.surface import SurfaceData
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.ops import disney_bsdf as kernel
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets
from lumenrenderer_tpu_torch.scene.materials import GatheredMaterial
from lumenrenderer_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def clean_log():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def no_kernel(monkeypatch):
    """Kernel D's wrappers replaced by ones that fail the test if called."""
    def refuse(*args, **kw):
        raise AssertionError("kernel D was called")

    monkeypatch.setattr(kernel, "evaluate", refuse)
    monkeypatch.setattr(kernel, "sample", refuse)


@pytest.fixture(scope="module")
def reader():
    path = ROOT / "perfbench" / "metrics" / "bsdf_fused_pct.py"
    spec = importlib.util.spec_from_file_location("bsdf_fused_metric", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _surfaces(r=257, seed=0):
    g = torch.Generator().manual_seed(seed)
    normal = vm.normalize(torch.randn((r, 3), generator=g))
    wo = vm.normalize(normal + 0.5 * torch.randn((r, 3), generator=g))
    wi = vm.normalize(torch.randn((r, 3), generator=g))
    u = torch.rand((r, 4), generator=g)
    rows = torch.rand((r, 25), generator=g)
    rows[:, 17] += 1.0                                  # ior
    gm = GatheredMaterial(rows)
    z3 = torch.zeros_like(normal)
    zi = torch.zeros(r, dtype=torch.int32)
    sd = SurfaceData(
        position=z3, normal=normal, geo_normal=normal, uv=z3[:, :2],
        base_color=gm.base_color, emissive=z3, metallic=gm.metallic,
        roughness=gm.roughness, alpha=gm.alpha_factor, mat_idx=zi,
        mat_rows=rows, light_row=zi - 1, tri_idx=zi,
        tangent=vm.normalize(torch.randn((r, 3), generator=g)),
        t=torch.ones(r), valid=torch.ones(r, dtype=torch.bool),
        is_emissive=torch.zeros(r, dtype=torch.bool),
        front_face=torch.rand(r, generator=g) < 0.7)
    return sd, wo, wi, u


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_tensors_take_the_eager_body(no_kernel, grad):
    sd, wo, wi, u = _surfaces()
    if grad:
        sd = sd.replace(mat_rows=sd.mat_rows.clone().requires_grad_())
    with torch.set_grad_enabled(grad):
        f, pdf = disney.evaluate(sd, wo, wi)
        got = disney.sample(sd, wo, u)
        f_e, pdf_e = disney._evaluate(sd, wo, wi)
        want = disney._sample(sd, wo, u)
    assert torch.equal(f, f_e) and torch.equal(pdf, pdf_e)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert f.requires_grad == grad and got[1].requires_grad == grad


def test_an_input_under_grad_needs_the_eager_body():
    sd, wo, wi, u = _surfaces(16)
    assert not disney._needs_grad(sd, wo, wi)
    leaf = sd.replace(base_color=sd.base_color.clone().requires_grad_())
    assert disney._needs_grad(leaf, wo, wi)
    wo_leaf = wo.clone().requires_grad_()
    assert disney._needs_grad(sd, wo_leaf, u)
    with torch.no_grad():
        assert not disney._needs_grad(leaf, wo_leaf, wi)
    # on the CPU the kernel never runs, grad or none
    assert not disney._fused(sd, wo, wi)


def _each_field(sd, fn):
    return sd.replace(**{f.name: fn(getattr(sd, f.name))
                         for f in dataclasses.fields(sd)})


@pytest.mark.parametrize("case", ["float64", "batched", "cpu"])
def test_kernel_takes_float32_rows_on_cuda_only(case):
    """Kernel D's contract: float32 (R,k) CUDA tensors, ValueError on any
    other; the eager body takes other float dtypes and leading shapes."""
    sd, wo, wi, u = _surfaces(32)
    f0, pdf0 = disney.evaluate(sd, wo, wi)
    if case == "float64":
        def cast(x):
            return x.double() if x.is_floating_point() else x
        sd, wo, wi, u = _each_field(sd, cast), wo.double(), wi.double(), \
            u.double()
        match = "float32"
    elif case == "batched":
        def fold(x):
            return x.reshape(2, 16, *x.shape[1:])
        sd, wo, wi, u = _each_field(sd, fold), fold(wo), fold(wi), fold(u)
        match = r"expected torch\.float32 \(2, 3\)"
    else:
        match = "CUDA tensors"
    with pytest.raises(ValueError, match=match):
        kernel.evaluate(sd, wo, wi)
    with pytest.raises(ValueError, match=match):
        kernel.sample(sd, wo, u)
    f, pdf = disney.evaluate(sd, wo, wi)
    wi_s, f_s, pdf_s, spec = disney.sample(sd, wo, u)
    assert f.dtype == pdf.dtype == wi_s.dtype == f_s.dtype == wo.dtype
    assert wi_s.shape == f_s.shape == wo.shape
    assert pdf_s.shape == spec.shape == wo.shape[:-1]
    if case == "batched":
        assert torch.equal(f.reshape(-1, 3), f0)
        assert torch.equal(pdf.reshape(-1), pdf0)


def test_counters_charge_each_outside_call_once(reader):
    sd, wo, wi, u = _surfaces(100)
    disney.evaluate(sd, wo, wi)                 # not recording: not counted
    assert profiling.span_table()["spans"] == {}
    assert reader({}) is None
    with profiling.recording():
        with profiling.unit("frame"):
            with profiling.span("wavefront.nee"):
                disney.evaluate(sd, wo, wi)
            with profiling.span("wavefront.bounce"):
                disney.sample(sd, wo, u)        # its own evaluate: once
                head = sd.replace(**{f.name: getattr(sd, f.name)[:40]
                                     for f in dataclasses.fields(sd)})
                disney.sample(head, wo[:40], u[:40])
    rows = profiling.span_table()["spans"]
    assert rows["wavefront.nee"]["bsdf_rays"] == 100
    assert rows["wavefront.bounce"]["bsdf_rays"] == 140
    assert rows["frame"]["bsdf_rays"] == 0
    assert all(r["bsdf_fused_rays"] == 0 for r in rows.values())
    assert reader({}) == 0.0


def test_cpu_interior_frame_counts_nine_calls_a_ray(no_kernel, reader):
    b, camf = presets.interior_scene(n_boxes=20, n_lights=4)
    w, h = 16, 12
    r = Renderer(b.build(), RenderConfig(width=w, height=h, max_depth=5,
                                         light_strategy="mis"), device="cpu")
    with profiling.recording():
        r.render_frame(r.init_state(0), camf(w / h))
    assert profiling.per_unit("bsdf_rays") == 9 * w * h   # 5 NEE, 4 bounces
    assert profiling.per_unit("bsdf_fused_rays") == 0
    assert reader({}) == 0.0


def test_reader_finds_nothing_in_a_program_without_the_counter(
        reader, monkeypatch):
    # a program whose span rows have no such fields, as before the counter
    rows = {"frame": {"calls": 1, "host_syncs": 0},
            "wavefront.nee": {"calls": 5, "host_syncs": 0}}
    monkeypatch.setattr(profiling, "span_table",
                        lambda unit=None: {"units": 1, "spans": rows})
    assert reader({"units": 1}) is None
    monkeypatch.undo()
    assert reader({"units": 1}) is None         # nothing recorded
