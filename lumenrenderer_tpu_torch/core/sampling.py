"""Sampling primitives: Halton jitter, warps, and the frame's uniform source.

Port of `lumenrenderer_tpu/core/sampling.py`. JAX's threefry keys become one
`torch.Generator` per frame state; every random draw of a frame goes through a
`Uniforms` callable, so tests can inject the same numbers into both packages.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from . import vecmath as vm

# uniforms(*shape) -> float32 tensor of U[0,1) draws on the frame's device.
# ReSTIR also calls the source's uniform(*shape) and randint(high, *shape)
# (int32 draws in [0, high)).
Uniforms = Callable[..., torch.Tensor]


class GeneratorUniforms:
    """The production draw source: floats and integers from `gen` on its
    device."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def __call__(self, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.gen.device,
                          dtype=torch.float32)

    uniform = __call__

    def randint(self, high: int, *shape) -> torch.Tensor:
        return torch.randint(0, high, shape, generator=self.gen,
                             device=self.gen.device, dtype=torch.int32)


def generator_uniforms(gen: torch.Generator) -> GeneratorUniforms:
    """The production uniform source: draws from `gen` on its device."""
    return GeneratorUniforms(gen)


def halton(index: torch.Tensor, base: int) -> torch.Tensor:
    """Radical inverse of `index` in `base`, fixed 16 digits."""
    idx = index.to(torch.int64)
    f = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    r = torch.zeros_like(f)
    for _ in range(16):
        f = f / base
        r = r + f * (idx % base).to(torch.float32)
        idx = idx // base
    return r


def halton23(index: torch.Tensor) -> torch.Tensor:
    """2D Halton point (bases 2, 3)."""
    return torch.stack([halton(index, 2), halton(index, 3)], dim=-1)


def sample_cosine_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted direction in tangent space (z up); pdf = cos/pi."""
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    z = torch.sqrt((1.0 - u[..., 0]).clamp_min(0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def cosine_hemisphere_pdf(cos_theta: torch.Tensor) -> torch.Tensor:
    return cos_theta.clamp_min(0.0) / math.pi


def sample_uniform_sphere(u: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere from (...,2) uniforms."""
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt((1.0 - z * z).clamp_min(0.0))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def sample_triangle(u: torch.Tensor) -> torch.Tensor:
    """Uniform barycentrics on a triangle from (...,2) uniforms."""
    su = torch.sqrt(u[..., 0])
    b0 = 1.0 - su
    b1 = u[..., 1] * su
    return torch.stack([b0, b1, 1.0 - b0 - b1], dim=-1)


def sample_ggx_vndf(wo: torch.Tensor, roughness: torch.Tensor,
                    u: torch.Tensor,
                    roughness_y: torch.Tensor | None = None) -> torch.Tensor:
    """Sample a GGX visible normal (Heitz 2018) in tangent space."""
    ax = roughness.clamp_min(1e-4)[..., None]
    ay = ax if roughness_y is None else roughness_y.clamp_min(1e-4)[..., None]
    vh = vm.normalize(wo * torch.cat([ax, ay, torch.ones_like(ax)], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1_raw = (torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(lensq)],
                          dim=-1)
              * torch.rsqrt(lensq.clamp_min(1e-7))[..., None])
    # made on the device: an upload would make the host wait
    x_axis = torch.eye(3, dtype=vh.dtype, device=vh.device)[0]
    t1 = torch.where((lensq > 1e-7)[..., None], t1_raw, x_axis.expand_as(vh))
    t2 = vm.cross(vh, t1)
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt((1.0 - p1 ** 2).clamp_min(0.0)) + s * p2
    p3 = torch.sqrt((1.0 - p1 ** 2 - p2 ** 2).clamp_min(0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    return vm.normalize(torch.stack(
        [ax[..., 0] * nh[..., 0], ay[..., 0] * nh[..., 1],
         nh[..., 2].clamp_min(0.0)], dim=-1))


def power_heuristic(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """MIS power heuristic (beta=2) weight for strategy a."""
    a2 = pdf_a * pdf_a
    return torch.where(pdf_a > 0.0, a2 / (a2 + pdf_b * pdf_b).clamp_min(1e-20),
                       torch.zeros_like(a2))
