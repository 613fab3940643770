"""Serialized scene cache: port of `lumenrenderer_tpu/scene/cache.py`.

A built `SceneData` is saved as one `np.savez_compressed` file in the JAX
package's format, so either package reads the other's cache: arrays
`leaf_0` ... `leaf_48` in the order JAX flattens its scene (field names
sorted at every level), then a dense `VolumeSet`'s five leaves (in their
declaration order, as JAX flattens them), and `__has_volumes__`.
`load_or_build("x.gltf")` uses `x.gltf.lumen.npz` while it is newer than
the source.

Sparse volumes are refused both ways: JAX writes a `SparseVolumeSet`'s six
leaves but reads any volume file back as a dense `VolumeSet`, so its own
files of sparse scenes load wrong (ROADMAP C-17).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..volume.grid import SparseVolumeSet, VolumeSet
from .lights import TriangleLights
from .materials import MaterialTable
from .scene import SceneData
from .textures import TextureAtlas

CACHE_EXT = ".lumen.npz"

# SceneData's leaves in the file's order (leaf_i is LEAVES[i])
LEAVES = (
    "env_radiance", "inst_emission_mode", "inst_emission_override",
    "lights.area", "lights.count", "lights.e1", "lights.e2",
    "lights.inst_idx", "lights.mat_idx", "lights.normal", "lights.p0",
    "lights.packed", "lights.tri_idx", "lights.tri_to_light",
    "materials.alpha_cutoff", "materials.alpha_factor",
    "materials.alpha_mode", "materials.anisotropic", "materials.base_color",
    "materials.base_color_tex", "materials.clearcoat",
    "materials.clearcoat_gloss", "materials.double_sided",
    "materials.emissive", "materials.emissive_tex", "materials.ior",
    "materials.metal_rough_tex", "materials.metallic", "materials.normal_tex",
    "materials.roughness", "materials.sheen", "materials.sheen_tint",
    "materials.spec_tint", "materials.spec_trans", "materials.specular",
    "materials.subsurface", "materials.transmittance",
    "textures.height", "textures.mip_offset", "textures.n_mips",
    "textures.offset", "textures.texels", "textures.width",
    "tri_inst", "tri_mat", "tri_normal", "tri_pos", "tri_tangent", "tri_uv",
)
VOLUME_LEAVES = tuple(f"volumes.{f.name}"
                      for f in dataclasses.fields(VolumeSet))
_PARTS = {"lights": TriangleLights, "materials": MaterialTable,
          "textures": TextureAtlas}
_SPARSE_REFUSED = ("sparse volumes have no cache file: the JAX package "
                   "reads them back as dense ones (ROADMAP C-17)")


def _leaf_names(scene_has_volumes: bool):
    return LEAVES + (VOLUME_LEAVES if scene_has_volumes else ())


def save_scene(path: str, scene: SceneData) -> None:
    """Write `scene` (on any device) to `path` (.npz). A scene with sparse
    volumes raises NotImplementedError."""
    if isinstance(scene.volumes, SparseVolumeSet):
        raise NotImplementedError(_SPARSE_REFUSED)
    has_volumes = scene.volumes is not None
    arrays = {}
    for i, name in enumerate(_leaf_names(has_volumes)):
        obj = scene
        for part in name.split("."):
            obj = getattr(obj, part)
        arrays[f"leaf_{i}"] = obj.detach().cpu().numpy()
    arrays["__has_volumes__"] = np.asarray(has_volumes)
    np.savez_compressed(path, **arrays)


def load_scene(path: str) -> SceneData:
    """Read a cache file into a SceneData of CPU tensors. A file of a scene
    with sparse volumes (one leaf more than a dense one) raises
    NotImplementedError."""
    with np.load(path) as z:
        names = _leaf_names(bool(z["__has_volumes__"]))
        if f"leaf_{len(names)}" in z.files:
            raise NotImplementedError(f"{path}: {_SPARSE_REFUSED}")
        leaves = {name: torch.from_numpy(z[f"leaf_{i}"])
                  for i, name in enumerate(names)}
    fields = {k: v for k, v in leaves.items() if "." not in k}
    if len(names) > len(LEAVES):
        fields["volumes"] = VolumeSet(**{
            name.split(".")[1]: leaves[name] for name in VOLUME_LEAVES})
    for part, cls in _PARTS.items():
        fields[part] = cls(**{f.name: leaves[f"{part}.{f.name}"]
                              for f in dataclasses.fields(cls)})
    return SceneData(**fields)


def load_or_build(gltf_path: str,
                  cache_path: Optional[str] = None) -> SceneData:
    """The scene of `gltf_path`: read from its cache file when that is at
    least as new as the source, else loaded, built and cached."""
    cache_path = cache_path or gltf_path + CACHE_EXT
    if (os.path.exists(cache_path)
            and os.path.getmtime(cache_path) >= os.path.getmtime(gltf_path)):
        return load_scene(cache_path)
    from .gltf import load_gltf

    scene = load_gltf(gltf_path).build()
    save_scene(cache_path, scene)
    return scene
