"""The scene as a dataclass of tensors, and its host-side builder.

Port of `lumenrenderer_tpu/scene/scene.py`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.struct import TensorStruct
from ..volume.grid import build_sparse, make_volume_set
from . import lights as lights_mod
from .geometry import FlatGeometry, InstanceHost, flatten_instances
from .materials import MaterialSpec, MaterialTable, build_material_table
from .textures import TextureAtlas, build_texture_atlas


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
    # volume.grid.VolumeSet or SparseVolumeSet, or None
    volumes: Optional[object] = None

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
    texture_images: List[np.ndarray] = dataclasses.field(default_factory=list)
    light_capacity: Optional[int] = None
    env_radiance: tuple = (0.0, 0.0, 0.0)
    volume_specs: list = dataclasses.field(default_factory=list)

    def add_material(self, spec: MaterialSpec) -> int:
        self.materials.append(spec)
        return len(self.materials) - 1

    def add_instance(self, inst: InstanceHost) -> int:
        self.instances.append(inst)
        return len(self.instances) - 1

    def add_texture(self, image: np.ndarray) -> int:
        """image: (H,W,4) (or 1 or 3 channels) float32 or uint8. Returns the
        texture id for MaterialSpec's *_tex fields."""
        self.texture_images.append(image)
        return len(self.texture_images) - 1

    def add_volume(self, density, aabb_lo, aabb_hi, sigma_t=1.0, albedo=0.9,
                   sparse: bool = False) -> int:
        """Add a density-grid volume: density (X,Y,Z) over the world box
        [aabb_lo, aabb_hi]. sparse=True builds a SparseVolumeSet (8³ index
        and apron bricks, memory in proportion to occupancy). Every volume
        of a scene shares one layout and one resolution: the first
        volume's `sparse` flag picks the layout. Returns the volume id."""
        self.volume_specs.append(
            (density, aabb_lo, aabb_hi, sigma_t, albedo, sparse))
        return len(self.volume_specs) - 1

    def build(self) -> SceneData:
        """Bake the scene into CPU tensors; move it with `.to(device)`."""
        specs = self.materials or [MaterialSpec()]
        geom: FlatGeometry = flatten_instances(self.instances)
        emissive_np = np.array([s.emissive for s in specs],
                               np.float32).reshape(-1, 3)
        t_ = torch.from_numpy
        volumes = None
        if self.volume_specs:
            make = build_sparse if self.volume_specs[0][5] else make_volume_set
            volumes = make(
                [np.asarray(s[0], np.float32) for s in self.volume_specs],
                [s[1] for s in self.volume_specs],
                [s[2] for s in self.volume_specs],
                sigma_t=[s[3] for s in self.volume_specs],
                albedo=[s[4] for s in self.volume_specs])
        return SceneData(
            tri_pos=t_(geom.tri_pos), tri_normal=t_(geom.tri_normal),
            tri_uv=t_(geom.tri_uv), tri_tangent=t_(geom.tri_tangent),
            tri_mat=t_(geom.tri_mat), tri_inst=t_(geom.tri_inst),
            materials=build_material_table(specs),
            lights=lights_mod.extract_lights(geom, emissive_np,
                                             capacity=self.light_capacity),
            textures=build_texture_atlas(self.texture_images),
            inst_emission_mode=t_(geom.inst_emission_mode),
            inst_emission_override=t_(geom.inst_emission_override),
            env_radiance=torch.tensor(self.env_radiance, dtype=torch.float32),
            volumes=volumes)
