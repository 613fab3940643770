"""Lambertian BRDF: port of `lumenrenderer_tpu/bsdf/lambert.py`.

wo points from the surface to the viewer, wi to the light, n is the unit
shading normal. `eval_brdf` returns (f without the cosine, pdf in solid
angle); `sample_brdf` returns (wi, f, pdf).
"""
from __future__ import annotations

import math

import torch

from ..core import sampling
from ..core import vecmath as vm


def eval_brdf(base_color, n, wo, wi):
    cos_i = vm.dot(n, wi)
    valid = (cos_i > 0.0) & (vm.dot(n, wo) > 0.0)
    f = torch.where(valid[..., None], base_color / math.pi,
                    torch.zeros_like(base_color))
    pdf = torch.where(valid, sampling.cosine_hemisphere_pdf(cos_i),
                      torch.zeros_like(cos_i))
    return f, pdf


def sample_brdf(base_color, n, wo, u):
    wi = vm.to_world(sampling.sample_cosine_hemisphere(u), n)
    f, pdf = eval_brdf(base_color, n, wo, wi)
    return wi, f, pdf
