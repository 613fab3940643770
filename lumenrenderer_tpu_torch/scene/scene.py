"""The scene as a dataclass of tensors, and its host-side builder.

Port of `lumenrenderer_tpu/scene/scene.py` and of the untextured part of
`scene/textures.py`: the atlas holds only the builtin white texel (slot 0).
Textures and volumes are refused.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.struct import TensorStruct
from . import lights as lights_mod
from .geometry import FlatGeometry, InstanceHost, flatten_instances
from .materials import (TEXTURE_COLUMNS, MaterialSpec, MaterialTable,
                        build_material_table)

MAX_MIPS = 14


@dataclasses.dataclass(frozen=True)
class TextureAtlas(TensorStruct):
    """Texel pool with per-texture offsets and mip levels (same leaves as
    the JAX atlas). The port builds only the one-slot white atlas."""

    texels: torch.Tensor      # (P,4)
    offset: torch.Tensor      # (K,)
    width: torch.Tensor       # (K,)
    height: torch.Tensor      # (K,)
    mip_offset: torch.Tensor  # (K,MAX_MIPS)
    n_mips: torch.Tensor      # (K,)

    @property
    def count(self) -> int:
        return self.offset.shape[0]


def white_atlas() -> TextureAtlas:
    i32 = torch.int32
    return TextureAtlas(
        texels=torch.ones((1, 4), dtype=torch.float32),
        offset=torch.zeros(1, dtype=i32), width=torch.ones(1, dtype=i32),
        height=torch.ones(1, dtype=i32),
        mip_offset=torch.zeros((1, MAX_MIPS), dtype=i32),
        n_mips=torch.ones(1, dtype=i32))


@dataclasses.dataclass(frozen=True)
class SceneData(TensorStruct):
    """World-space flattened triangle SoA + materials + lights."""

    tri_pos: torch.Tensor       # (T,3,3)
    tri_normal: torch.Tensor    # (T,3,3)
    tri_uv: torch.Tensor        # (T,3,2)
    tri_tangent: torch.Tensor   # (T,3,4)
    tri_mat: torch.Tensor       # (T,) int32
    tri_inst: torch.Tensor      # (T,) int32
    materials: MaterialTable
    lights: lights_mod.TriangleLights
    textures: TextureAtlas
    inst_emission_mode: torch.Tensor      # (I,) int32
    inst_emission_override: torch.Tensor  # (I,3)
    env_radiance: torch.Tensor            # (3,) constant environment light

    def __post_init__(self):
        if self.textures.count > 1:
            raise NotImplementedError(
                "textured scenes are not ported yet: the PyTorch port "
                "renders untextured scenes only")

    @property
    def num_triangles(self) -> int:
        return self.tri_pos.shape[0]

    def light_radiance(self, light_idx: torch.Tensor) -> torch.Tensor:
        return lights_mod.radiance(self.lights, self.materials,
                                   self.inst_emission_mode,
                                   self.inst_emission_override, light_idx)


@dataclasses.dataclass
class SceneBuilder:
    """Host-side scene assembly."""

    instances: List[InstanceHost] = dataclasses.field(default_factory=list)
    materials: List[MaterialSpec] = dataclasses.field(default_factory=list)
    light_capacity: Optional[int] = None
    env_radiance: tuple = (0.0, 0.0, 0.0)

    def add_material(self, spec: MaterialSpec) -> int:
        self.materials.append(spec)
        return len(self.materials) - 1

    def add_instance(self, inst: InstanceHost) -> int:
        self.instances.append(inst)
        return len(self.instances) - 1

    def add_texture(self, image) -> int:
        raise NotImplementedError("textures are not ported yet")

    def add_volume(self, *args, **kwargs) -> int:
        raise NotImplementedError("volumes are not ported yet")

    def build(self) -> SceneData:
        """Bake the scene into CPU tensors; move it with `.to(device)`."""
        specs = self.materials or [MaterialSpec()]
        if any(getattr(s, c) >= 0 for s in specs for c in TEXTURE_COLUMNS):
            raise NotImplementedError(
                "a material references a texture; textures are not ported")
        geom: FlatGeometry = flatten_instances(self.instances)
        emissive_np = np.array([s.emissive for s in specs],
                               np.float32).reshape(-1, 3)
        t_ = torch.from_numpy
        return SceneData(
            tri_pos=t_(geom.tri_pos), tri_normal=t_(geom.tri_normal),
            tri_uv=t_(geom.tri_uv), tri_tangent=t_(geom.tri_tangent),
            tri_mat=t_(geom.tri_mat), tri_inst=t_(geom.tri_inst),
            materials=build_material_table(specs),
            lights=lights_mod.extract_lights(geom, emissive_np,
                                             capacity=self.light_capacity),
            textures=white_atlas(),
            inst_emission_mode=t_(geom.inst_emission_mode),
            inst_emission_override=t_(geom.inst_emission_override),
            env_radiance=torch.tensor(self.env_radiance, dtype=torch.float32),
        )
