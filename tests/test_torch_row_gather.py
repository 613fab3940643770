"""The row gather under grad (`ops/row_gather.py`) and its backward, the
row scatter-add (`ops/csrc/row_scatter.cu`).

CPU: `gather_rows` against autograd through `table[idx]` over index
patterns (uniform, one row taking 90%, all one row, all distinct, no
entries, N not a multiple of 32, C not a multiple of 4, int32 and int64,
1-D and 2-D); no autograd node without grad; the five gathers of the frame
under grad (the packed materials, the attribute table, NEE's and MIS's
light rows, the lights' emissive) go through it; the counter in the span
table and the benchmark's reader of it.

Marked `cuda` (skip without a card; run with `python -m pytest
--noconftest tests/test_torch_row_gather.py -q -m cuda`): the kernel
against the twin on 16-byte and single-float columns, at the 720p
attribute table's shape and at the light and material tables', with no
host sync and its launches counted; rows too wide for a block refused.
Tolerance on the card: the kernel sums each row's entries in another order
than the twin, with atomics whose order changes from run to run, in
float32; the error of a sum of k float32 terms in any order is at most
about k * 2^-24 times the sum of their magnitudes, and runs of equal rows
are summed in groups of at most 32 before they meet, so each element is
held to 1e-5 times the sum of the magnitudes added into it (plus 1e-6).
Where every row receives at most one entry the sums are exact.
"""
import contextlib
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from lumenrenderer_tpu_torch.integrator import nee as pnee
from lumenrenderer_tpu_torch.integrator import surface as psurface
from lumenrenderer_tpu_torch.ops import row_gather as rg
from lumenrenderer_tpu_torch.scene import lights as plights
from lumenrenderer_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


def _pattern(name, n, rows, gen):
    if name == "uniform":
        return torch.randint(0, rows, (n,), generator=gen)
    if name == "hot":            # one row takes 90%, in runs, as a floor
        idx = torch.randint(0, rows, (n,), generator=gen)
        hot = torch.rand(n, generator=gen) < 0.9
        return torch.where(hot, torch.full_like(idx, rows // 2), idx)
    if name == "one":
        return torch.full((n,), rows - 1, dtype=torch.long)
    if name == "distinct":
        return torch.randperm(rows, generator=gen)[:n]
    if name == "runs":           # pixel order: runs of equal rows
        lens = torch.randint(1, 70, (n,), generator=gen)
        vals = torch.randint(0, rows, (n,), generator=gen)
        return torch.repeat_interleave(vals, lens)[:n]
    raise ValueError(name)


def _assert_sums_close(got, want, g, idx, rows):
    """Each element within 1e-5 of the sum of the magnitudes added into it
    (plus 1e-6): two float32 sums of the same terms in other orders."""
    g = g.reshape(idx.numel(), g.shape[-1])
    mag = rg.gather_rows_backward_ref(g.double().abs(), idx.reshape(-1), rows)
    assert bool(((got.double() - want.double()).abs()
                 <= 1e-5 * mag + 1e-6).all())


def _grads(table, idx, g):
    """(gather_rows' value and gradient, table[idx]'s)."""
    a = table.detach().clone().requires_grad_()
    b = table.detach().clone().requires_grad_()
    va, vb = rg.gather_rows(a, idx), b[idx]
    va.backward(g)
    vb.backward(g)
    return va, a.grad, vb, b.grad


@pytest.mark.parametrize("idx_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("c", [52, 7, 17])   # 17: the light table's width
@pytest.mark.parametrize("pattern,n", [
    ("uniform", 1000), ("hot", 1000), ("one", 96), ("distinct", 200),
    ("runs", 517), ("uniform", 0), ("hot", 77)])
def test_values_and_gradient_match_autograd(pattern, n, c, idx_dtype):
    gen = torch.Generator().manual_seed(7)
    rows = 300
    table = torch.randn(rows, c, generator=gen)
    idx = _pattern(pattern, n, rows, gen).to(idx_dtype)
    g = torch.randn(n, c, generator=gen)
    va, ga, vb, gb = _grads(table, idx, g)
    assert torch.equal(va, vb)
    _assert_sums_close(ga, gb, g, idx, rows)


@pytest.mark.parametrize("shape", [(40, 25), (3, 5, 7), (0, 4)])
def test_any_index_shape(shape):
    gen = torch.Generator().manual_seed(3)
    table = torch.randn(9, 3, generator=gen)
    idx = torch.randint(0, 9, shape, generator=gen)
    g = torch.randn(*shape, 3, generator=gen)
    va, ga, vb, gb = _grads(table, idx, g)
    assert va.shape == (*shape, 3) and torch.equal(va, vb)
    _assert_sums_close(ga, gb, g, idx, 9)


def test_saves_only_the_indices():
    table = torch.randn(10, 4, requires_grad=True)
    idx = torch.randint(0, 10, (6, 5))
    out = rg.gather_rows(table, idx)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and torch.equal(saved[0], idx.reshape(-1))


def test_no_grad_is_the_plain_gather():
    table = torch.randn(10, 4, requires_grad=True)
    idx = torch.tensor([[1, 1, 9], [0, 3, 3]])
    with torch.no_grad():
        out = rg.gather_rows(table, idx)
    assert out.grad_fn is None and torch.equal(out, table.detach()[idx])
    plain = torch.randn(10, 4)
    out = rg.gather_rows(plain, idx)        # grad on, the table needs none
    assert out.grad_fn is None and torch.equal(out, plain[idx])
    out = rg.gather_rows(table, idx)
    assert type(out.grad_fn).__name__ == "_GatherRowsBackward"


def test_the_frame_routes_its_gathers_through_it(monkeypatch):
    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.integrator import wavefront as wf
    from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
    from lumenrenderer_tpu_torch.render.renderer import Renderer
    from lumenrenderer_tpu_torch.scene import presets

    calls = []

    def spy(table, idx):
        out = rg.gather_rows(table, idx)
        frame = sys._getframe(1)
        calls.append((Path(frame.f_code.co_filename).name,
                      frame.f_code.co_name, out.grad_fn))
        return out

    for mod in (psurface, pnee, plights):
        monkeypatch.setattr(mod, "gather_rows", spy)
    b, camf = presets.cornell_box(with_blocks=True)
    r = Renderer(b.build(), RenderConfig(width=8, height=8, max_depth=2,
                                         light_strategy="mis"), device="cpu")
    m = r.scene.materials
    em = m.emissive.clone().requires_grad_()
    bc = m.base_color.clone().requires_grad_()
    scene = r.scene.replace(materials=m.replace(emissive=em, base_color=bc))
    out = wf.render_wavefront(
        scene, r._isect, r._occl, camf(1.0),
        sampling.generator_uniforms(torch.Generator().manual_seed(0)), 0,
        r.config)
    wf.merge_channels(out).mean().backward()
    sites = {(f, fn) for f, fn, _ in calls}
    assert sites == {("surface.py", "_attr_table"),
                     ("surface.py", "extract_surface_data"),
                     ("nee.py", "select_light"),
                     ("nee.py", "light_pdf_solid_angle"),
                     ("lights.py", "radiance")}
    assert all(type(fn).__name__ == "_GatherRowsBackward"
               for _, _, fn in calls)
    assert bool(torch.isfinite(em.grad).all() & torch.isfinite(bc.grad).all())
    assert float(em.grad.abs().sum()) > 0.0 and float(bc.grad.abs().sum()) > 0


@pytest.fixture
def metric():
    path = ROOT / "perfbench" / "metrics" / "scatter_updates_pct.fit.py"
    spec = importlib.util.spec_from_file_location("scatter_metric", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_counter_in_the_span_table(metric):
    profiling.reset()
    assert metric({}) is None                      # nothing recorded
    table = torch.randn(50, 6, requires_grad=True)
    idx = torch.randint(0, 50, (333,))
    rg.gather_rows(table, idx).sum().backward()    # not recording
    assert profiling.span_table()["spans"] == {}
    with profiling.recording():
        with profiling.unit("train.step"):
            with profiling.span("train.backward"):
                rg.gather_rows(table, idx).sum().backward()
                rg.gather_rows(table, idx[:100]).sum().backward()
    rows = profiling.span_table()["spans"]
    assert rows["train.backward"]["row_scatter_rows"] == 433
    assert rows["train.backward"]["row_scatter_updates"] == 433
    assert rows["train.step"]["row_scatter_rows"] == 0
    assert profiling.per_unit("row_scatter_rows") == 433.0
    assert metric({}) == 100.0
    profiling.reset()


# ---------------------------------------------------------------- the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _check_kernel(dev, pattern, n, c, rows, idx_dtype, exact=False):
    gen = torch.Generator().manual_seed(n + c)
    idx = _pattern(pattern, n, rows, gen).to(idx_dtype)
    g = torch.randn(n, c, generator=gen)
    rg.reset_launches()
    profiling.reset()
    with profiling.recording():
        with profiling.unit("step"):
            got = rg.gather_rows_backward(g.to(dev), idx.to(dev), rows)
    counts = profiling.span_table()["spans"]["step"]
    profiling.reset()
    torch.cuda.synchronize()
    path = "float4" if c % 4 == 0 else "float"
    assert rg.LAUNCHES[path] == 1 and sum(rg.LAUNCHES.values()) == 1
    ref = rg.gather_rows_backward_ref(g.double(), idx, rows)
    got = got.cpu()
    if exact:
        assert torch.equal(got, ref.float())
    else:
        _assert_sums_close(got, ref, g, idx, rows)
    assert counts["row_scatter_rows"] == n
    assert 0 < counts["row_scatter_updates"] <= n
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["runs", "hot", "uniform"])
@pytest.mark.parametrize("c", [64, 52])
def test_kernel_attribute_table(dev, pattern, c):
    counts = _check_kernel(dev, pattern, 921_600, c, 7338, torch.int64)
    if pattern != "uniform":                 # equal rows merge in the warp
        assert counts["row_scatter_updates"] < 921_600 // 4


@pytest.mark.cuda
def test_kernel_one_row_one_update_a_chunk_at_most(dev):
    n = 100_003
    counts = _check_kernel(dev, "one", n, 64, 7338, torch.int64)
    assert counts["row_scatter_updates"] <= -(-n // 32)


@pytest.mark.cuda
@pytest.mark.parametrize("c,idx_dtype", [(7, torch.int32), (64, torch.int32),
                                         (13, torch.int64)])
def test_kernel_distinct_rows_exact(dev, c, idx_dtype):
    _check_kernel(dev, "distinct", 7000, c, 7338, idx_dtype, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,rows,pattern", [
    (921_600, 17, 128, "uniform"), (921_600, 17, 128, "runs"),
    (7338, 25, 100, "hot"), (1000, 3, 100, "one")])
def test_kernel_light_and_material_tables(dev, n, c, rows, pattern):
    _check_kernel(dev, pattern, n, c, rows, torch.int64)


@pytest.mark.cuda
def test_kernel_refuses_rows_too_wide_for_a_block(dev):
    g = torch.randn(1000, 500, device=dev)     # 33 rows a warp: 264 KB
    idx = torch.zeros(1000, dtype=torch.int64, device=dev)
    with pytest.raises(RuntimeError):
        rg.gather_rows_backward(g, idx, 10)


@pytest.mark.cuda
def test_kernel_backward_makes_no_host_sync(dev):
    gen = torch.Generator().manual_seed(5)
    table = torch.randn(7338, 64, generator=gen).to(dev).requires_grad_()
    lights = torch.randn(128, 17, generator=gen).to(dev).requires_grad_()
    idx = _pattern("runs", 921_600, 7338, gen).to(dev)
    li = _pattern("uniform", 921_600, 128, gen).to(dev)
    rg.reset_launches()
    profiling.reset()
    for record in (False, True):
        loss = (rg.gather_rows(table, idx).square().sum()
                + rg.gather_rows(lights, li).sum())
        torch.cuda.synchronize()
        with contextlib.ExitStack() as stack:
            if record:
                stack.enter_context(profiling.recording())
                stack.enter_context(profiling.unit("step"))
            torch.cuda.set_sync_debug_mode("error")
            try:
                loss.backward()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    rows = profiling.span_table()["spans"]["step"]
    assert rows["row_scatter_rows"] == 2 * 921_600
    profiling.reset()
    assert rg.LAUNCHES == {"float4": 2, "float": 2}
