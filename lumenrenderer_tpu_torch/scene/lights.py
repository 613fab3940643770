"""Triangle-light extraction and per-light radiance.

Port of `lumenrenderer_tpu/scene/lights.py`. Light membership is chosen on
the host at scene build; `refit_lights` moves the light geometry with its
instances in dynamic scenes; radiance is read from the material table at
shade time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.struct import TensorStruct
from ..ops.row_gather import gather_rows
from .geometry import EmissionMode, FlatGeometry
from .materials import MaterialTable


@dataclasses.dataclass(frozen=True)
class TriangleLights(TensorStruct):
    """SoA of emissive triangles; rows past `count` are zero-area padding."""

    p0: torch.Tensor        # (L,3)
    e1: torch.Tensor        # (L,3) p1-p0
    e2: torch.Tensor        # (L,3) p2-p0
    normal: torch.Tensor    # (L,3) unit geometric normal
    area: torch.Tensor      # (L,)
    tri_idx: torch.Tensor   # (L,) index into the flat triangle arrays
    mat_idx: torch.Tensor   # (L,) material id for the radiance gather
    inst_idx: torch.Tensor  # (L,) instance id (emission override)
    count: torch.Tensor     # () int32 number of valid lights
    tri_to_light: torch.Tensor  # (T,) triangle -> light row, -1 if none
    packed: torch.Tensor    # (L,13) [p0, e1, e2, normal, area]

    @property
    def capacity(self) -> int:
        return self.p0.shape[0]


def radiance(lights: TriangleLights, materials: MaterialTable,
             inst_emission_mode: torch.Tensor,
             inst_emission_override: torch.Tensor,
             idx: torch.Tensor) -> torch.Tensor:
    """Radiance of light rows `idx` (...,) -> (...,3), honouring the
    per-instance emission mode (ENABLED, OVERRIDE, DISABLED)."""
    mat = gather_rows(materials.emissive, lights.mat_idx[idx].long())
    inst = lights.inst_idx[idx].long()
    mode = inst_emission_mode[inst]
    override = inst_emission_override[inst]
    rad = torch.where((mode == EmissionMode.OVERRIDE)[..., None], override,
                      mat)
    return torch.where((mode == EmissionMode.DISABLED)[..., None],
                       torch.zeros_like(rad), rad)


def extract_lights(geom: FlatGeometry, materials_emissive: np.ndarray,
                   capacity: Optional[int] = None) -> TriangleLights:
    """Host-side emissive-triangle scan: a triangle is a light if its
    instance is OVERRIDE with nonzero radiance, or ENABLED with an emissive
    material."""
    t = geom.tri_mat.shape[0]
    if t == 0:
        sel = np.zeros(0, np.int32)
    else:
        mat_em = materials_emissive[geom.tri_mat]
        mode = geom.inst_emission_mode[geom.tri_inst]
        override = geom.inst_emission_override[geom.tri_inst]
        is_light = (((mode == EmissionMode.ENABLED) & (mat_em.max(-1) > 0.0))
                    | ((mode == EmissionMode.OVERRIDE)
                       & (override.max(-1) > 0.0)))
        sel = np.nonzero(is_light)[0].astype(np.int32)
    n = sel.shape[0]
    cap = capacity or max(int(n), 1)
    if n > cap:
        sel = sel[:cap]
        n = cap
    p = geom.tri_pos[sel].reshape(n, 3, 3)
    p0, e1, e2 = p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    cr = np.cross(e1, e2)
    area2 = np.linalg.norm(cr, axis=-1)
    nrm = cr / np.maximum(area2[:, None], 1e-20)
    area = 0.5 * area2

    def pad(a, shape, dtype=np.float32):
        out = np.zeros((cap,) + shape, dtype)
        out[:n] = a
        return out

    tri_to_light = np.full((max(t, 1),), -1, np.int32)
    tri_to_light[sel] = np.arange(n, dtype=np.int32)
    cols = [pad(p0, (3,)), pad(e1, (3,)), pad(e2, (3,)), pad(nrm, (3,)),
            pad(area, ())[:, None]]
    t_ = torch.from_numpy
    return TriangleLights(
        p0=t_(cols[0]), e1=t_(cols[1]), e2=t_(cols[2]), normal=t_(cols[3]),
        area=t_(cols[4][:, 0].copy()),
        tri_idx=t_(pad(sel, (), np.int32)),
        mat_idx=t_(pad(geom.tri_mat[sel], (), np.int32)),
        inst_idx=t_(pad(geom.tri_inst[sel], (), np.int32)),
        count=torch.tensor(n, dtype=torch.int32),
        tri_to_light=t_(tri_to_light),
        packed=t_(np.concatenate(cols, axis=-1)),
    )


def refit_lights(lights: TriangleLights,
                 tri_pos: torch.Tensor) -> TriangleLights:
    """Light geometry of fixed membership at new (T,3,3) world positions,
    on tri_pos's device in float32 (dynamic scenes)."""
    valid = (torch.arange(lights.capacity, device=tri_pos.device)
             < lights.count)[:, None]
    tri = tri_pos[lights.tri_idx.long().clamp_min(0)]      # (L,3,3)
    p0 = torch.where(valid, tri[:, 0], 0.0)
    e1 = torch.where(valid, tri[:, 1] - tri[:, 0], 0.0)
    e2 = torch.where(valid, tri[:, 2] - tri[:, 0], 0.0)
    n = vm.cross(e1, e2)
    ln = torch.linalg.vector_norm(n, dim=-1)
    area = 0.5 * ln
    normal = n / ln.clamp_min(1e-12)[:, None]
    packed = torch.cat([p0, e1, e2, normal, area[:, None]], dim=1)
    return lights.replace(p0=p0, e1=e1, e2=e2, normal=normal, area=area,
                          packed=packed)
