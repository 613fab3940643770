"""Material table: structure-of-arrays Disney BSDF parameters.

Port of `lumenrenderer_tpu/scene/materials.py`. Per-ray material access is one
row gather of the packed (M,25) matrix, read through `GatheredMaterial`.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..core.struct import TensorStruct

# (name, width) of every float column of `MaterialTable.packed`, in order
PACKED_COLUMNS = (
    ("base_color", 3), ("emissive", 3), ("metallic", 1), ("roughness", 1),
    ("subsurface", 1), ("specular", 1), ("spec_tint", 1), ("anisotropic", 1),
    ("sheen", 1), ("sheen_tint", 1), ("clearcoat", 1),
    ("clearcoat_gloss", 1), ("spec_trans", 1), ("ior", 1),
    ("transmittance", 3), ("alpha_mode", 1), ("alpha_cutoff", 1),
    ("double_sided", 1), ("alpha_factor", 1),
)
TEXTURE_COLUMNS = ("base_color_tex", "emissive_tex", "normal_tex",
                   "metal_rough_tex")


@dataclasses.dataclass(frozen=True)
class MaterialTable(TensorStruct):
    """Row i = material i. Vector params are (M,3), scalars (M,); alpha_mode
    is 0 OPAQUE, 1 MASK, 2 BLEND; double_sided 0 culls back faces. Texture
    ids are int32 builder ids into the scene's atlas, -1 = none."""

    base_color: torch.Tensor
    emissive: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    subsurface: torch.Tensor
    specular: torch.Tensor
    spec_tint: torch.Tensor
    anisotropic: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    spec_trans: torch.Tensor
    ior: torch.Tensor
    transmittance: torch.Tensor
    alpha_mode: torch.Tensor
    alpha_cutoff: torch.Tensor
    double_sided: torch.Tensor
    alpha_factor: torch.Tensor
    base_color_tex: torch.Tensor
    emissive_tex: torch.Tensor
    normal_tex: torch.Tensor
    metal_rough_tex: torch.Tensor

    @property
    def count(self) -> int:
        return self.base_color.shape[0]

    def packed(self) -> torch.Tensor:
        """All float params as one (M,25) matrix (column map in
        `PACKED_COLUMNS`)."""
        cols = []
        for name, width in PACKED_COLUMNS:
            a = getattr(self, name)
            cols.append(a if width == 3 else a[:, None])
        return torch.cat(cols, dim=-1)


class GatheredMaterial:
    """Per-ray view over packed material rows (R,25): column slices."""

    __slots__ = ("rows",)

    def __init__(self, rows: torch.Tensor):
        self.rows = rows

    base_color = property(lambda s: s.rows[..., 0:3])
    emissive = property(lambda s: s.rows[..., 3:6])
    metallic = property(lambda s: s.rows[..., 6])
    roughness = property(lambda s: s.rows[..., 7])
    subsurface = property(lambda s: s.rows[..., 8])
    specular = property(lambda s: s.rows[..., 9])
    spec_tint = property(lambda s: s.rows[..., 10])
    anisotropic = property(lambda s: s.rows[..., 11])
    sheen = property(lambda s: s.rows[..., 12])
    sheen_tint = property(lambda s: s.rows[..., 13])
    clearcoat = property(lambda s: s.rows[..., 14])
    clearcoat_gloss = property(lambda s: s.rows[..., 15])
    spec_trans = property(lambda s: s.rows[..., 16])
    ior = property(lambda s: s.rows[..., 17])
    transmittance = property(lambda s: s.rows[..., 18:21])
    alpha_mode = property(lambda s: s.rows[..., 21])
    alpha_cutoff = property(lambda s: s.rows[..., 22])
    double_sided = property(lambda s: s.rows[..., 23])
    alpha_factor = property(lambda s: s.rows[..., 24])


@dataclasses.dataclass
class MaterialSpec:
    """Host-side material description (same fields and defaults as the JAX
    package's `MaterialSpec`)."""

    base_color: tuple = (0.8, 0.8, 0.8)
    emissive: tuple = (0.0, 0.0, 0.0)
    metallic: float = 0.0
    roughness: float = 0.5
    subsurface: float = 0.0
    specular: float = 0.5
    spec_tint: float = 0.0
    anisotropic: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.5
    clearcoat: float = 0.0
    clearcoat_gloss: float = 1.0
    spec_trans: float = 0.0
    ior: float = 1.5
    transmittance: tuple = (1.0, 1.0, 1.0)
    alpha_mode: int = 0
    alpha_cutoff: float = 0.5
    double_sided: bool = True
    alpha_factor: float = 1.0
    base_color_tex: int = -1
    emissive_tex: int = -1
    normal_tex: int = -1
    metal_rough_tex: int = -1


def build_material_table(specs: List[MaterialSpec]) -> MaterialTable:
    """Pack host MaterialSpecs into a MaterialTable (CPU tensors)."""
    specs = specs or [MaterialSpec()]
    fields = {}
    for name, _ in PACKED_COLUMNS:
        vals = [getattr(s, name) for s in specs]
        if name == "double_sided":
            vals = [1.0 if v else 0.0 for v in vals]
        fields[name] = torch.from_numpy(np.array(vals, np.float32))
    for name in TEXTURE_COLUMNS:
        fields[name] = torch.from_numpy(
            np.array([getattr(s, name) for s in specs], np.int32))
    return MaterialTable(**fields)
