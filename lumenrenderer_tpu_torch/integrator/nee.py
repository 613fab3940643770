"""Next-event estimation: the per-frame light table and light sampling.

Port of `lumenrenderer_tpu/integrator/nee.py`. Every per-light quantity is
packed once per frame into one (L,17) row; a light sample fetches its row
with an index gather (exact; the JAX package used a one-hot matmul, the
TPU's faster idiom).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import sampling
from ..core import vecmath as vm
from ..ops.row_gather import gather_rows
from ..scene.scene import SceneData


class LightTable(NamedTuple):
    """aug (L,17) = [p0(3), e1(3), e2(3), normal(3), area(1), radiance(3),
    sel_pdf(1)]; cdf (L,) selection CDF; count () valid lights."""

    aug: torch.Tensor
    cdf: torch.Tensor
    count: torch.Tensor


class LightSample(NamedTuple):
    light_idx: torch.Tensor  # (R,) int64
    point: torch.Tensor      # (R,3)
    normal: torch.Tensor     # (R,3)
    radiance: torch.Tensor   # (R,3)
    pdf_area: torch.Tensor   # (R,) selection * point pdf, area measure
    wi: torch.Tensor         # (R,3) unit, surface -> light
    dist: torch.Tensor       # (R,)
    cos_light: torch.Tensor  # (R,) cosine at the light, 0 if behind
    valid: torch.Tensor      # (R,) bool


def all_light_radiance(scene: SceneData) -> torch.Tensor:
    """Dense (L,3) radiance of every light row, computed once per frame."""
    lights = scene.lights
    return scene.light_radiance(
        torch.arange(lights.capacity, device=lights.area.device))


def _selection_weights(scene: SceneData, rad: torch.Tensor,
                       selection: str) -> torch.Tensor:
    """selection: "cdf" (weights = luminance * area, uniform over valid
    lights when all are zero) or "uniform". The weights carry no gradient:
    the selection pdf is sampling machinery, the radiance columns stay
    live."""
    lights = scene.lights
    valid = (torch.arange(lights.capacity, device=lights.area.device)
             < lights.count).float()
    if selection == "cdf":
        w = torch.where(valid > 0, (vm.luminance(rad.detach()) * lights.area)
                        .clamp_min(0.0), 0.0)
        return torch.where(w.sum() > 0, w, valid)
    return valid


def build_light_cdf(scene: SceneData, light_rad_all=None):
    """(cdf (L,), sel_pdf (L,)) of the "cdf" selection: ReSTIR's light-bag
    sampler."""
    rad = (light_rad_all if light_rad_all is not None
           else all_light_radiance(scene))
    w = _selection_weights(scene, rad, "cdf")
    cdf = torch.cumsum(w, 0)
    total = cdf[-1].clamp_min(1e-20)
    return cdf / total, w / total


def build_light_table(scene: SceneData, selection: str = "cdf",
                      light_rad_all=None) -> LightTable:
    """The per-frame packed light table (selection: "cdf" or "uniform")."""
    lights = scene.lights
    rad = (light_rad_all if light_rad_all is not None
           else all_light_radiance(scene))
    w = _selection_weights(scene, rad, selection)
    cdf = torch.cumsum(w, 0)
    total = cdf[-1].clamp_min(1e-20)
    aug = torch.cat([lights.packed, rad, (w / total)[:, None]], dim=1)
    return LightTable(aug=aug.float(), cdf=cdf / total, count=lights.count)


def select_light(table: LightTable, u0: torch.Tensor):
    """Invert the CDF: idx = #{cdf < u0}, clamped; returns (idx, rows)."""
    L = table.cdf.shape[0]
    idx = torch.searchsorted(table.cdf, u0.contiguous()).clamp(0, L - 1)
    return idx, gather_rows(table.aug, idx)


def sample_light(table: LightTable, u: torch.Tensor,
                 shading_pos: torch.Tensor) -> LightSample:
    """u: (R,3) uniforms: u[:,0] picks the light, u[:,1:3] the point."""
    idx, row = select_light(table, u[:, 0])
    bary = sampling.sample_triangle(u[:, 1:3])
    point = row[:, 0:3] + bary[:, 1:2] * row[:, 3:6] + bary[:, 2:3] * row[:, 6:9]
    nrm = row[:, 9:12]
    area = row[:, 12]
    sel_pdf = row[:, 16]
    to_light = point - shading_pos
    dist = vm.length(to_light)
    wi = to_light / dist[..., None].clamp_min(1e-8)
    cos_light = vm.dot(nrm, -wi)
    valid = ((table.count > 0) & (cos_light > 1e-6) & (area > 1e-12)
             & (dist > 1e-5) & (sel_pdf > 0.0))
    return LightSample(light_idx=idx, point=point, normal=nrm,
                       radiance=row[:, 13:16],
                       pdf_area=sel_pdf / area.clamp_min(1e-12), wi=wi,
                       dist=dist, cos_light=cos_light.clamp_min(0.0),
                       valid=valid)


def pdf_solid_angle(ls: LightSample) -> torch.Tensor:
    """The sample's area pdf in solid-angle measure at the shading point."""
    return ls.pdf_area * ls.dist * ls.dist / ls.cos_light.clamp_min(1e-6)


def light_pdf_solid_angle(table: LightTable, wi: torch.Tensor,
                          hit_t: torch.Tensor,
                          light_row: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf NEE would give direction wi hitting light row
    `light_row` at distance hit_t (-1 = not a light): MIS weights."""
    prow = gather_rows(table.aug, light_row.clamp_min(0).long())
    cos_l = vm.dot(prow[:, 9:12], -wi).clamp_min(0.0)
    pdf_a = prow[:, 16] / prow[:, 12].clamp_min(1e-12)
    pdf_sa = pdf_a * hit_t * hit_t / cos_l.clamp_min(1e-6)
    return torch.where((light_row >= 0) & (cos_l > 1e-6), pdf_sa,
                       torch.zeros_like(pdf_sa))
