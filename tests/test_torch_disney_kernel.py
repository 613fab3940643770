"""Kernel D (`ops/csrc/disney_bsdf.cu`) on the card against its eager twin,
`bsdf/disney.py` `_evaluate` and `_sample`, on the same CUDA tensors.

Marked `cuda`: it needs an NVIDIA GPU with nvcc (Hopper, sm_90a) and skips
where torch.cuda.is_available() is False. Run it on the card with
`python -m pytest --noconftest tests/test_torch_disney_kernel.py -q`.

Inputs: 2^20 random surfaces (every lobe drawn, total internal reflection,
back faces, degenerate tangents, roughness under 0.08, metallic 0 and 1,
spec_trans 1, wo below the surface, near-mirror wi), as contiguous tensors
and as column views of one table; and a scene's surfaces as
`extract_surface_data` builds them, missed rays included.
Tolerance: every output within 1e-5 relative or 1e-6 absolute of the
twin's, non-finite outputs at the same positions (NaN where NaN); the lobe,
total internal reflection and Fresnel-reflection codes and is_specular
equal, except on rays whose lobe draw lies within 1e-6 of a cumulative lobe
probability or whose Fresnel draw lies within 1e-6 of F (where one rounding
may flip the draw), which must be fewer than 1 in 10^5.
"""
import pytest
import torch

from lumenrenderer_tpu_torch.accel import brute
from lumenrenderer_tpu_torch.bsdf import common, disney
from lumenrenderer_tpu_torch.core import sampling
from lumenrenderer_tpu_torch.core import vecmath as vm
from lumenrenderer_tpu_torch.integrator.surface import (SurfaceData,
                                                        extract_surface_data)
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.ops import disney_bsdf as kernel
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets
from lumenrenderer_tpu_torch.scene.geometry import InstanceHost
from lumenrenderer_tpu_torch.scene.materials import (GatheredMaterial,
                                                     MaterialSpec)
from lumenrenderer_tpu_torch.scene.scene import SceneBuilder
from lumenrenderer_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

N = 1 << 20
RTOL, ATOL = 1e-5, 1e-6
NEAR = 1e-6              # a draw this close to its threshold may flip
NEAR_SHARE = 1e-5        # and fewer rays than this share may be so close


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _unit(g, n):
    v = torch.randn((n, 3), generator=g)
    return v / v.norm(dim=-1, keepdim=True)


def random_surfaces(n, seed, dev, views):
    """(sd, wo, wi, u) of n random surfaces on `dev`; views: every float
    input a column view of one (n, 64) table, as `extract_surface_data`'s
    gathered rows are."""
    g = torch.Generator().manual_seed(seed)

    def uni(*shape):
        return torch.rand(shape, generator=g)

    k = torch.arange(n)
    normal = _unit(g, n)
    tangent = _unit(g, n)
    # degenerate tangents: along the normal, or zero
    tangent = torch.where((k % 16 == 3)[:, None], normal, tangent)
    tangent = torch.where((k % 32 == 5)[:, None], 0.0, tangent)
    base = uni(n, 3)
    base[k % 20 == 7] = 0.0
    metallic = torch.where(k % 5 == 0, 0.0,
                           torch.where(k % 5 == 1, 1.0, uni(n)))
    roughness = torch.where(k % 4 == 0, 0.08 * uni(n), uni(n))
    roughness[k % 64 == 9] = 0.0
    rows = torch.zeros(n, 25)
    rows[:, 0:3] = base
    rows[:, 6] = metallic
    rows[:, 7] = roughness
    rows[:, 8:17] = uni(n, 9)
    rows[:, 11] *= (k % 3 == 0)                     # anisotropic
    rows[:, 14] *= (k % 2 == 0)                     # clearcoat
    rows[:, 16] = torch.where(k % 6 == 0, 1.0,      # spec_trans
                              torch.where(k % 6 == 1, 0.0, rows[:, 16]))
    rows[:, 17] = 1.0 + 1.5 * uni(n)                # ior
    rows[:, 18:21] = 1.0
    rows[:, 24] = 1.0
    front = uni(n) < 0.7
    # wo above the surface on 4 rays in 5, grazing on 1 in 50
    wo = _unit(g, n)
    wo = wo * torch.sign(vm.dot(wo, normal))[:, None]
    wo = torch.where((k % 5 == 4)[:, None], -wo, wo)
    graze = vm.normalize(tangent + 1e-4 * normal)
    wo = torch.where((k % 50 == 11)[:, None], graze, wo)
    # wi anywhere, and near the mirror direction on 1 ray in 4
    wi = _unit(g, n)
    mirror = vm.normalize(vm.reflect(-wo, normal) + 1e-3 * _unit(g, n))
    wi = torch.where((k % 4 == 2)[:, None], mirror, wi)
    u = uni(n, 4)
    if views:
        table = torch.cat([uni(n, 5), normal, tangent, rows, wo, wi, u,
                           uni(n, 64 - 5 - 3 - 3 - 25 - 3 - 3 - 4)], 1)
        table = table.to(dev)
        c = iter(torch.split(table, [5, 3, 3, 25, 3, 3, 4,
                                     64 - 46], dim=1))
        next(c)
        normal, tangent, rows, wo, wi, u = (next(c) for _ in range(6))
    else:
        normal, tangent, rows, wo, wi, u = (
            x.to(dev) for x in (normal, tangent, rows, wo, wi, u))
    gm = GatheredMaterial(rows)
    sd = _surface(normal, tangent, gm.base_color, gm.metallic, gm.roughness,
                  front.to(dev), rows)
    return sd, wo, wi, u


def _surface(normal, tangent, base, metallic, roughness, front, rows):
    n = normal.shape[0]
    z3 = torch.zeros_like(normal)
    zi = torch.zeros(n, dtype=torch.int32, device=normal.device)
    return SurfaceData(
        position=z3, normal=normal, geo_normal=normal, uv=z3[:, :2],
        base_color=base, emissive=z3, metallic=metallic, roughness=roughness,
        alpha=torch.ones_like(metallic), mat_idx=zi, mat_rows=rows,
        light_row=zi - 1, tri_idx=zi, tangent=tangent,
        t=torch.ones_like(metallic), valid=torch.ones_like(front),
        is_emissive=torch.zeros_like(front), front_face=front)


def lab_surfaces(n, seed, dev):
    """(sd, wo, wi, u): rays at quads of every Disney lobe, from the front
    and from behind, a tenth aimed off the quads, as `extract_surface_data`
    builds their surfaces (missed rays included)."""
    b = SceneBuilder(env_radiance=(0.3, 0.3, 0.3))
    specs = [
        MaterialSpec(base_color=(0.7, 0.3, 0.2), roughness=0.9,
                     subsurface=0.6),
        MaterialSpec(base_color=(0.9, 0.8, 0.5), metallic=1.0,
                     roughness=0.3),
        MaterialSpec(base_color=(0.2, 0.4, 0.8), clearcoat=1.0,
                     clearcoat_gloss=0.7, roughness=0.5),
        MaterialSpec(base_color=(0.5, 0.6, 0.3), sheen=1.0, sheen_tint=0.8,
                     spec_tint=0.5),
        MaterialSpec(base_color=(0.6, 0.6, 0.6), metallic=0.5,
                     roughness=0.4, anisotropic=0.8),
        MaterialSpec(base_color=(0.95, 0.95, 0.95), spec_trans=1.0,
                     roughness=0.05, ior=1.5),
        MaterialSpec(base_color=(0.9, 0.9, 0.9), metallic=1.0,
                     roughness=0.02),
    ]
    for i, spec in enumerate(specs):
        m = b.add_material(spec)
        x = float(i) - 3.0
        b.add_instance(InstanceHost(mesh=presets.make_quad_mesh(
            [(x, -1, -0.3 * i), (x + 0.9, -1, -0.3 * i),
             (x + 0.9, 1, -0.3 * i - 0.2), (x, 1, -0.3 * i - 0.2)], m)))
    sc = b.build().to(dev)
    g = torch.Generator().manual_seed(seed)

    def uni(*shape):
        return torch.rand(shape, generator=g)

    k = torch.arange(n)
    behind = (k % 4 == 1)[:, None]
    o = torch.stack([uni(n) * 7 - 3, uni(n) * 2 - 1,
                     torch.full((n,), 3.0)], -1)
    o = torch.where(behind, o * torch.tensor([1.0, 1.0, -1.0]), o)
    target = torch.stack([uni(n) * 7 - 3, uni(n) * 2 - 1, uni(n) * -2], -1)
    target = torch.where((k % 10 == 3)[:, None], target + 10.0, target)
    d = vm.normalize(target - o)
    o, d = o.to(dev), d.to(dev)
    hits = brute.intersect_closest(sc.tri_pos, o, d, 1e-3, 1e9)
    sd = extract_surface_data(sc, o, d, hits["tri"])
    wi = _unit(g, n).to(dev)
    return sd, -d, wi, uni(n, 4).to(dev)


def eager_codes(sd, wo, u):
    """The twin's lobe codes (as the kernel writes them) and the rays whose
    draws lie within NEAR of a threshold."""
    g = GatheredMaterial(sd.mat_rows)
    t, b, n = disney._frame(sd)
    wo_l = disney._clamp_up(vm.to_local_frame(wo, t, b, n))
    lobes = disney._lobe_probs(g, sd)
    sel, u3 = u[:, 2], u[:, 3]
    c1 = lobes.p_diffuse
    c2 = c1 + lobes.p_specular
    c3 = c2 + lobes.p_clearcoat
    lobe = torch.where(sel < c1, 0, torch.where(
        (sel >= c1) & (sel < c2), 1,
        torch.where((sel >= c2) & (sel < c3), 2, 3)))
    ax, ay = disney._alpha_aniso(g, sd)
    m = sampling.sample_ggx_vndf(wo_l, ax, u[:, :2], roughness_y=ay)
    eta = disney._eta(g, sd)
    f_r = common.fresnel_dielectric(vm.dot(wo_l, m).abs(), 1.0 / eta)
    _, tir = vm.refract(-wo_l, m, eta)
    trans = lobe == 3
    refl = (u3 < f_r) | tir
    code = lobe + 4 * (trans & tir) + 8 * (trans & refl)
    near = (((sel - c1).abs() < NEAR) | ((sel - c2).abs() < NEAR)
            | ((sel - c3).abs() < NEAR)
            | (trans & ~tir & ((u3 - f_r).abs() < NEAR)))
    return code.to(torch.uint8), near


def assert_close(name, got, want, keep):
    """got equals want within RTOL or ATOL on the rays `keep`, non-finite
    at the same places."""
    got, want = got[keep], want[keep]
    fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
    assert torch.equal(fin_g, fin_w), (
        f"{name}: non-finite at {int((fin_g != fin_w).sum())} other places")
    inf = got.isinf()
    assert torch.equal(inf, want.isinf()), f"{name}: infinities elsewhere"
    assert torch.equal(got[inf], want[inf]), f"{name}: other infinities"
    g, w = got[fin_g], want[fin_w]
    err = (g - w).abs()
    bad = (err > ATOL) & (err > RTOL * w.abs())
    if bool(bad.any()):
        i = int(torch.argmax(torch.where(bad, err / w.abs().clamp_min(ATOL),
                                         0.0)))
        raise AssertionError(f"{name}: {int(bad.sum())} of {g.numel()} "
                             f"values off, worst {float(g[i])!r} against "
                             f"{float(w[i])!r}")


def _row_keep(mask, width):
    return mask[:, None].expand(-1, width) if width else mask


CASES = [("random", False), ("random", True), ("lab", None)]


def _inputs(case, views, dev, seed):
    if case == "random":
        return random_surfaces(N, seed, dev, views)
    return lab_surfaces(N, seed, dev)


@pytest.mark.parametrize("case,views", CASES)
def test_evaluate_matches_twin(dev, case, views):
    sd, wo, wi, _ = _inputs(case, views, dev, 11)
    kernel.reset_launches()
    with torch.no_grad():
        f, pdf = kernel.evaluate(sd, wo, wi)
        f_e, pdf_e = disney._evaluate(sd, wo, wi)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["evaluate"] == 1
    keep = torch.ones(N, dtype=torch.bool, device=dev)
    assert_close("f", f, f_e, _row_keep(keep, 3))
    assert_close("pdf", pdf, pdf_e, keep)
    assert float((pdf_e > 0).float().mean()) > 0.2     # not all masked


@pytest.mark.parametrize("case,views", CASES)
def test_sample_matches_twin(dev, case, views):
    sd, wo, _, u = _inputs(case, views, dev, 12)
    with torch.no_grad():
        wi, f, pdf, spec, code = kernel.sample(sd, wo, u, with_lobe=True)
        wi_e, f_e, pdf_e, spec_e = disney._sample(sd, wo, u)
        code_e, near = eager_codes(sd, wo, u)
    torch.cuda.synchronize()
    assert int(near.sum()) < NEAR_SHARE * N
    keep = ~near
    assert torch.equal(code[keep], code_e[keep])
    assert torch.equal(spec[keep], spec_e[keep])
    for name, a, b, w in (("wi", wi, wi_e, 3), ("f", f, f_e, 3),
                          ("pdf", pdf, pdf_e, 0)):
        assert_close(name, a, b, _row_keep(keep, w))
    if case == "random":
        # the inputs reach every lobe, TIR, and both Fresnel branches
        lobes = torch.bincount((code & 3).long(), minlength=4)
        assert bool((lobes > N // 100).all()), lobes
        assert int((code & 4).sum()) > 0 and int((code == 3).sum()) > 0
        assert int(spec.sum()) > N // 100


def test_no_host_sync(dev):
    sd, wo, wi, u = random_surfaces(4096, 13, dev, True)
    with torch.no_grad():
        disney.evaluate(sd, wo, wi)              # built and loaded
        disney.sample(sd, wo, u)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            disney.evaluate(sd, wo, wi)
            disney.sample(sd, wo, u)
        finally:
            torch.cuda.set_sync_debug_mode(0)


def test_grad_takes_the_eager_body(dev):
    sd, wo, wi, u = random_surfaces(4096, 14, dev, False)
    rows = sd.mat_rows.clone().requires_grad_()
    leaf = sd.replace(mat_rows=rows, base_color=rows[:, 0:3])
    kernel.reset_launches()
    f, pdf = disney.evaluate(leaf, wo, wi)
    wi_s, f_s, _, _ = disney.sample(leaf, wo, u)
    assert kernel.LAUNCHES == {"evaluate": 0, "sample": 0}
    assert f.requires_grad and f_s.requires_grad
    (f.sum() + f_s.sum()).backward()
    assert rows.grad is not None
    with torch.no_grad():                        # no gradient: the kernel
        disney.evaluate(leaf, wo, wi)
        disney.sample(leaf, wo, u)
    assert kernel.LAUNCHES == {"evaluate": 1, "sample": 1}


def test_frame_counts_every_ray_fused(dev):
    b, camf = presets.interior_scene(n_boxes=40, n_lights=8)
    cfg = RenderConfig(width=64, height=36, max_depth=5,
                       light_strategy="mis")
    r = Renderer(b.build(), cfg, device=dev)
    st = r.init_state(0)
    st, _ = r.render_frame(st, camf(64 / 36))     # built and warm
    profiling.reset()
    kernel.reset_launches()
    with profiling.recording():
        st, _ = r.render_frame(st, camf(64 / 36))
    rows = profiling.span_table()["spans"].values()
    n = 64 * 36
    assert sum(x["bsdf_rays"] for x in rows) == 9 * n
    assert sum(x["bsdf_fused_rays"] for x in rows) == 9 * n
    assert kernel.LAUNCHES == {"evaluate": 5, "sample": 4}
    profiling.reset()
