"""Disney BSDF, sample and evaluate: port of
`lumenrenderer_tpu/bsdf/disney.py`.

Diffuse with Burley retro-reflection and subsurface lerp, sheen, anisotropic
GGX specular, GTR1 clearcoat and rough dielectric transmission, all lobes
evaluated for every ray and selected with `torch.where`. `evaluate` returns
f (no cosine) and the solid-angle pdf of `sample`.

Two paths give the same numbers. A call on CUDA tensors that needs no
gradient (grad mode off, or no input requires grad) runs kernel D
(`ops/disney_bsdf.py`), one launch a call; every other call runs the eager
body here, which is the differentiable path, the CPU path and the kernel's
twin. While spans record, each call charges its rays to the innermost span
(`profiling.count_bsdf`: `bsdf_rays`, and `bsdf_fused_rays` where D ran).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import sampling
from ..core import vecmath as vm
from ..ops import disney_bsdf as kernel
from ..scene.materials import GatheredMaterial
from ..utils import profiling
from . import common


class _Lobes(NamedTuple):
    p_diffuse: torch.Tensor
    p_specular: torch.Tensor
    p_clearcoat: torch.Tensor
    p_transmission: torch.Tensor


def _where0(cond, x):
    return torch.where(cond, x, torch.zeros_like(x))


def _f0_color(g, sd):
    """Specular F0: 0.08*specular, tinted, lerped to base color by metallic."""
    lum = vm.luminance(sd.base_color).clamp_min(1e-8)
    tint = sd.base_color / lum[..., None]
    dielectric = 0.08 * g.specular[..., None] * vm.lerp(
        torch.ones_like(tint), tint, g.spec_tint[..., None])
    return vm.lerp(dielectric, sd.base_color, sd.metallic[..., None])


def _lobe_probs(g, sd) -> _Lobes:
    base_lum = vm.luminance(sd.base_color).clamp_min(1e-4)
    w_diff = (1.0 - sd.metallic) * (1.0 - g.spec_trans) * base_lum
    w_spec = vm.luminance(_f0_color(g, sd)).clamp_min(0.08)
    w_cc = 0.25 * g.clearcoat
    w_trans = (1.0 - sd.metallic) * g.spec_trans * base_lum
    inv = 1.0 / (w_diff + w_spec + w_cc + w_trans).clamp_min(1e-8)
    return _Lobes(w_diff * inv, w_spec * inv, w_cc * inv, w_trans * inv)


def _alpha_aniso(g, sd):
    """Anisotropic GGX slopes (ax, ay) from roughness and `anisotropic`."""
    alpha = (sd.roughness * sd.roughness).clamp_min(1e-4)
    aspect = torch.sqrt(1.0 - 0.9 * g.anisotropic.clamp(0.0, 1.0))
    return (alpha / aspect).clamp_min(1e-4), (alpha * aspect).clamp_min(1e-4)


def _frame(sd):
    """Shading frame (t, b, n): tangent orthogonalised against the shading
    normal, with the canonical ONB where the tangent degenerates."""
    n = sd.normal
    t_raw = sd.tangent - n * vm.dot(sd.tangent, n)[..., None]
    len2 = vm.dot(t_raw, t_raw)
    t_onb, _ = vm.build_onb(n)
    t = torch.where((len2 > 1e-8)[..., None],
                    t_raw * torch.rsqrt(len2.clamp_min(1e-12))[..., None],
                    t_onb)
    return t, vm.cross(n, t), n


def _eta(g, sd):
    """Relative IOR eta_i/eta_t."""
    return torch.where(sd.front_face, 1.0 / g.ior, g.ior)


def _clamp_up(wo_l):
    """wo in the upper hemisphere: z clamped to >= 1e-6."""
    return torch.cat([wo_l[..., :2], wo_l[..., 2:].clamp_min(1e-6)], dim=-1)


def _eval_lobes(g, sd, wo_l, wi_l):
    """Reflection lobes in tangent space -> (f (R,3), pdfs by lobe)."""
    cos_o = wo_l[..., 2].clamp_min(1e-6)
    cos_i = wi_l[..., 2]
    reflect_side = cos_i > 1e-6
    cos_i_c = cos_i.clamp_min(1e-6)
    h = vm.normalize(wo_l + wi_l)
    h = torch.where(h[..., 2:3] < 0.0, -h, h)
    oh = vm.dot(wo_l, h).clamp_min(0.0)
    nh = h[..., 2].clamp_min(0.0)
    rough = sd.roughness
    ax, ay = _alpha_aniso(g, sd)

    fl = common.schlick_fresnel(cos_i_c)
    fv = common.schlick_fresnel(cos_o)
    rr = 2.0 * rough * oh * oh
    fd90 = 0.5 + rr
    f_d = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    fss = (1.0 + (rr - 1.0) * fl) * (1.0 + (rr - 1.0) * fv)
    ss = 1.25 * (fss * (1.0 / (cos_i_c + cos_o) - 0.5) + 0.5)
    diff_w = vm.lerp(f_d, ss, g.subsurface)
    diffuse_weight = (1.0 - sd.metallic) * (1.0 - g.spec_trans)
    f_diffuse = sd.base_color / math.pi * (diff_w * diffuse_weight)[..., None]
    lum = vm.luminance(sd.base_color).clamp_min(1e-8)
    tint = sd.base_color / lum[..., None]
    sheen_color = vm.lerp(torch.ones_like(tint), tint, g.sheen_tint[..., None])
    f_sheen = ((g.sheen * diffuse_weight)[..., None] * sheen_color
               * common.schlick_fresnel(oh)[..., None])

    fres = common.fresnel_schlick(_f0_color(g, sd), oh)
    d = common.ggx_d_aniso(h, ax, ay)
    g2 = common.smith_g2_aniso(wo_l, wi_l, ax, ay)
    f_spec = fres * (d * g2 / (4.0 * cos_o * cos_i_c).clamp_min(1e-8))[..., None]

    cc_alpha = vm.lerp(0.1, 0.001, g.clearcoat_gloss)
    d_cc = common.gtr1_d(nh, cc_alpha)
    g_cc = common.smith_g2(cos_o, cos_i_c, torch.full_like(cc_alpha, 0.25))
    f_cc_s = 0.04 + 0.96 * common.schlick_fresnel(oh)
    f_clearcoat = (0.25 * g.clearcoat * d_cc * g_cc * f_cc_s
                   / (4.0 * cos_o * cos_i_c).clamp_min(1e-8))[..., None] \
        * torch.ones_like(f_spec)

    f_reflect = _where0(reflect_side[..., None],
                        f_diffuse + f_sheen + f_spec + f_clearcoat)
    pdf_diffuse = _where0(reflect_side, cos_i_c / math.pi)
    pdf_spec = _where0(reflect_side,
                       common.ggx_vndf_pdf_aniso(wo_l, h, ax, ay)
                       / (4.0 * oh).clamp_min(1e-8))
    pdf_cc = _where0(reflect_side, d_cc * nh / (4.0 * oh).clamp_min(1e-8))
    return f_reflect, {"diffuse": pdf_diffuse, "specular": pdf_spec,
                       "clearcoat": pdf_cc}


def _eval_transmission(g, sd, wo_l, wi_l):
    """Rough dielectric transmission (Walter 2007) with base-color tint.
    Returns (f_trans (R,3), pdf_trans (R,))."""
    cos_o = wo_l[..., 2].clamp_min(1e-6)
    cos_i = wi_l[..., 2]
    trans_side = cos_i < -1e-6
    eta = _eta(g, sd)
    h = vm.normalize(wo_l + wi_l * (1.0 / eta)[..., None])
    h = torch.where(h[..., 2:3] < 0.0, -h, h)
    oh = vm.dot(wo_l, h)
    ih = vm.dot(wi_l, h)
    ax, ay = _alpha_aniso(g, sd)
    d = common.ggx_d_aniso(h, ax, ay)
    g2 = common.smith_g2_aniso(wo_l, wi_l, ax, ay)
    f_r = common.fresnel_dielectric(oh.abs(), 1.0 / eta)
    denom = ((oh + ih / eta) ** 2).clamp_min(1e-8)
    jac = ih.abs() / denom * (1.0 / (eta * eta))
    f_t = ((1.0 - f_r) * d * g2 * oh.abs() * jac
           / (cos_o * cos_i.abs()).clamp_min(1e-8))
    w = (1.0 - sd.metallic) * g.spec_trans
    # clamped above 0: sqrt's gradient at 0 is inf, and 0 * inf would make a
    # black base color's gradient NaN (lights are black)
    color = torch.sqrt(sd.base_color.clamp_min(1e-30))
    f_trans = _where0(trans_side[..., None], (f_t * w)[..., None] * color)
    pdf_trans = _where0(trans_side, common.ggx_vndf_pdf_aniso(wo_l, h, ax, ay)
                        * jac * (1.0 - f_r))
    return f_trans, pdf_trans


def _needs_grad(sd, *tensors) -> bool:
    """True where autograd would record the call: grad mode on and an input
    that requires grad."""
    return torch.is_grad_enabled() and any(
        x.requires_grad for x in (*tensors, sd.normal, sd.tangent,
                                  sd.base_color, sd.metallic, sd.roughness,
                                  sd.mat_rows))


def _fused(sd, wo, other) -> bool:
    """Whether kernel D runs the call: CUDA tensors and no gradient asked
    for."""
    return wo.is_cuda and not _needs_grad(sd, wo, other)


def evaluate(sd, wo, wi):
    """Combined Disney f (no cosine) and sampling pdf, world-space wo/wi.
    Material parameters come from the packed rows on `sd`. A CUDA call that
    needs no gradient runs kernel D, which takes float32 (R,k) inputs only
    and raises ValueError on other dtypes or leading shapes; every other
    call takes any float dtype and leading shape [..., k]."""
    fused = _fused(sd, wo, wi)
    profiling.count_bsdf(wo.shape[0], fused)
    if fused:
        return kernel.evaluate(sd, wo, wi)
    return _evaluate(sd, wo, wi)


def _evaluate(sd, wo, wi):
    """The eager body of `evaluate`."""
    g = GatheredMaterial(sd.mat_rows)
    t, b, n = _frame(sd)
    wo_l = vm.to_local_frame(wo, t, b, n)
    wi_l = vm.to_local_frame(wi, t, b, n)
    valid_o = wo_l[..., 2] > 1e-6
    wo_l = _clamp_up(wo_l)
    f_refl, pdfs = _eval_lobes(g, sd, wo_l, wi_l)
    f_trans, pdf_trans = _eval_transmission(g, sd, wo_l, wi_l)
    lobes = _lobe_probs(g, sd)
    pdf = (lobes.p_diffuse * pdfs["diffuse"]
           + lobes.p_specular * pdfs["specular"]
           + lobes.p_clearcoat * pdfs["clearcoat"]
           + lobes.p_transmission * pdf_trans)
    return _where0(valid_o[..., None], f_refl + f_trans), _where0(valid_o, pdf)


def sample(sd, wo, u):
    """Sample the Disney BSDF. u: (R,4) uniforms (2 direction, 1 lobe, 1
    Fresnel). Returns (wi, f, pdf, is_specular). Inputs as `evaluate`'s:
    float32 (R,k) on a CUDA call that needs no gradient."""
    fused = _fused(sd, wo, u)
    profiling.count_bsdf(wo.shape[0], fused)
    if fused:
        return kernel.sample(sd, wo, u)
    return _sample(sd, wo, u)


def _sample(sd, wo, u):
    """The eager body of `sample`."""
    g = GatheredMaterial(sd.mat_rows)
    t, b, n = _frame(sd)
    wo_l = _clamp_up(vm.to_local_frame(wo, t, b, n))
    lobes = _lobe_probs(g, sd)
    sel = u[..., 2]
    c1 = lobes.p_diffuse
    c2 = c1 + lobes.p_specular
    c3 = c2 + lobes.p_clearcoat
    pick_diffuse = sel < c1
    pick_spec = (sel >= c1) & (sel < c2)
    pick_cc = (sel >= c2) & (sel < c3)
    pick_trans = sel >= c3

    u2 = u[..., :2]
    wi_diff = sampling.sample_cosine_hemisphere(u2)
    ax, ay = _alpha_aniso(g, sd)
    m_spec = sampling.sample_ggx_vndf(wo_l, ax, u2, roughness_y=ay)
    wi_spec = vm.reflect(-wo_l, m_spec)
    cc_alpha = vm.lerp(0.1, 0.001, g.clearcoat_gloss)
    a2 = (cc_alpha * cc_alpha).clamp(1e-6, 1.0 - 1e-6)
    cos2 = (1.0 - torch.pow(a2, 1.0 - u2[..., 0])) / (1.0 - a2)
    cos_t = torch.sqrt(cos2.clamp(0.0, 1.0))
    sin_t = torch.sqrt((1.0 - cos2).clamp_min(0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    m_cc = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)
    wi_cc = vm.reflect(-wo_l, m_cc)
    eta = _eta(g, sd)
    # the transmission half-vector is the same VNDF draw as the specular one
    m_t = m_spec
    f_r = common.fresnel_dielectric(vm.dot(wo_l, m_t).abs(), 1.0 / eta)
    refr, tir = vm.refract(-wo_l, m_t, eta)
    do_reflect_t = (u[..., 3] < f_r) | tir
    wi_trans = torch.where(do_reflect_t[..., None], vm.reflect(-wo_l, m_t),
                           vm.normalize(refr))
    wi_l = torch.where(pick_diffuse[..., None], wi_diff,
                       torch.where(pick_spec[..., None], wi_spec,
                                   torch.where(pick_cc[..., None], wi_cc,
                                               wi_trans)))
    # the sampled direction is sampling machinery: no gradient flows back
    # through the warps (whose sqrt(0) corners give NaN), f stays live
    wi_l = wi_l.detach()
    wi = vm.to_world_frame(wi_l, t, b, n)
    f, pdf = _evaluate(sd, wo, wi)
    # the Fresnel reflection off a transmissive microfacet looks like the
    # specular lobe: fold its probability into the pdf
    h_rfl = vm.normalize(wo_l + wi_l)
    h_rfl = torch.where(h_rfl[..., 2:3] < 0.0, -h_rfl, h_rfl)
    oh = vm.dot(wo_l, h_rfl).clamp_min(0.0)
    pdf_spec_extra = (common.ggx_vndf_pdf_aniso(wo_l, h_rfl, ax, ay)
                      / (4.0 * oh).clamp_min(1e-8))
    pdf = pdf + _where0(wi_l[..., 2] > 0.0,
                        lobes.p_transmission * f_r * pdf_spec_extra)
    is_specular = (pick_spec | pick_cc | pick_trans) & (sd.roughness < 0.08)
    return wi, f, pdf, is_specular
