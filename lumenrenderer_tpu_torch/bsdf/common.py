"""Shared microfacet and Fresnel math: port of
`lumenrenderer_tpu/bsdf/common.py`. All functions are elementwise."""
from __future__ import annotations

import math

import torch


def _where0(cond, x):
    return torch.where(cond, x, torch.zeros_like(x))


def schlick_fresnel(cos_theta: torch.Tensor) -> torch.Tensor:
    """Schlick's (1-cos)^5 weight."""
    m = (1.0 - cos_theta).clamp(0.0, 1.0)
    return m * m * m * m * m


def fresnel_schlick(f0: torch.Tensor, cos_theta: torch.Tensor) -> torch.Tensor:
    return f0 + (1.0 - f0) * schlick_fresnel(cos_theta)[..., None]


def fresnel_dielectric(cos_i: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """Exact dielectric Fresnel; eta = eta_t/eta_i, cos_i >= 0."""
    cos_i = cos_i.clamp(0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / (eta * eta).clamp_min(1e-8)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt((1.0 - sin2_t).clamp_min(0.0))
    r_par = (eta * cos_i - cos_t) / (eta * cos_i + cos_t).clamp_min(1e-8)
    r_perp = (cos_i - eta * cos_t) / (cos_i + eta * cos_t).clamp_min(1e-8)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, torch.ones_like(f), f)


def ggx_d(nh: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """GGX normal distribution D(h) (isotropic)."""
    a2 = alpha * alpha
    d = nh * nh * (a2 - 1.0) + 1.0
    return _where0(nh > 0.0, a2 / (math.pi * d * d).clamp_min(1e-12))


def ggx_lambda(cos_theta: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Smith Lambda for GGX."""
    c = cos_theta.abs().clamp(1e-6, 1.0)
    t2 = (1.0 - c * c).clamp_min(0.0) / (c * c)
    return 0.5 * (-1.0 + torch.sqrt(1.0 + alpha * alpha * t2))


def smith_g1(cos_theta: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + ggx_lambda(cos_theta, alpha))


def smith_g2(cos_o, cos_i, alpha) -> torch.Tensor:
    """Height-correlated Smith G2."""
    return 1.0 / (1.0 + ggx_lambda(cos_o, alpha) + ggx_lambda(cos_i, alpha))


def gtr1_d(nh: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Berry/GTR1 distribution for clearcoat."""
    a2 = (alpha * alpha).clamp(1e-6, 1.0 - 1e-6)
    d = 1.0 + (a2 - 1.0) * nh * nh
    return _where0(nh > 0.0,
                   (a2 - 1.0) / (math.pi * torch.log(a2) * d).clamp_min(1e-12))


def ggx_d_aniso(h, ax, ay) -> torch.Tensor:
    """Anisotropic GGX D(h), h in the (tangent, bitangent, normal) frame."""
    hx, hy, hz = h[..., 0], h[..., 1], h[..., 2]
    e = (hx / ax) ** 2 + (hy / ay) ** 2 + hz * hz
    return _where0(hz > 0.0, 1.0 / (math.pi * ax * ay * e * e).clamp_min(1e-12))


def ggx_lambda_aniso(w, ax, ay) -> torch.Tensor:
    wz = w[..., 2].abs().clamp(1e-6, 1.0)
    a2t2 = ((ax * w[..., 0]) ** 2 + (ay * w[..., 1]) ** 2) / (wz * wz)
    return 0.5 * (-1.0 + torch.sqrt(1.0 + a2t2))


def smith_g1_aniso(w, ax, ay):
    return 1.0 / (1.0 + ggx_lambda_aniso(w, ax, ay))


def smith_g2_aniso(wo, wi, ax, ay):
    return 1.0 / (1.0 + ggx_lambda_aniso(wo, ax, ay)
                  + ggx_lambda_aniso(wi, ax, ay))


def ggx_vndf_pdf_aniso(wo, h, ax, ay):
    """PDF of anisotropic GGX VNDF sampling (half-vector measure)."""
    wo_z = wo[..., 2]
    oh = (wo * h).sum(-1)
    val = (smith_g1_aniso(wo, ax, ay) * ggx_d_aniso(h, ax, ay)
           * oh.clamp_min(0.0) / wo_z.clamp_min(1e-6))
    return _where0(wo_z > 0.0, val)


def ggx_vndf_pdf(wo_z, nh, oh, alpha):
    """PDF of isotropic GGX VNDF sampling (half-vector measure)."""
    val = (smith_g1(wo_z, alpha) * ggx_d(nh, alpha) * oh.clamp_min(0.0)
           / wo_z.clamp_min(1e-6))
    return _where0(wo_z > 0.0, val)
