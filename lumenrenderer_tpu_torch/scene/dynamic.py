"""Dynamic scenes: instance-transform edits between frames.

Port of `lumenrenderer_tpu/scene/dynamic.py`. An edit to an instance's
`Transform` marks the scene dirty through the transform's dependents; the
renderer's next frame then rebakes on the scene's device: it re-transforms
the object-space triangle arrays by the per-instance matrices, refits the
light geometry (`lights.refit_lights`), and refits the accel, either the
cluster set (`stream.refit_clusters`) or, for two-level scenes, the
instance and unit tables only (`two_level.refit_instances`, no triangle
work in the accel). Shapes never change. Cluster membership is frozen at
build, so far-travelling instances inflate their clusters' boxes; a new
Renderer rebuilds them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..accel.stream import refit_clusters
from ..accel.two_level import refit_instances
from ..core.transform import Transform
from .geometry import FlatGeometry, flatten_instances
from .lights import refit_lights
from .scene import SceneBuilder, SceneData


def _apply(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-triangle (T,3,3) matrices applied to (T,3,3) vertex rows, in
    float32 elementwise arithmetic."""
    return (m[:, None] * v[:, :, None, :]).sum(-1)


def _transform_geometry(obj_pos, obj_normal, obj_tangent, tri_inst, mats4):
    """Apply per-instance 4x4s to the object-space triangle arrays."""
    rot = mats4[:, :3, :3]                          # (I,3,3)
    trn = mats4[:, :3, 3]                           # (I,3)
    # normals use the inverse transpose (right under non-uniform scale)
    rot_it = torch.linalg.inv(rot).transpose(1, 2)
    ti = tri_inst.long()
    r_t = rot[ti]
    pos = _apply(r_t, obj_pos) + trn[ti][:, None, :]
    nrm = _apply(rot_it[ti], obj_normal)
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=-1,
                                         keepdim=True).clamp_min(1e-12)
    tan = torch.cat([_apply(r_t, obj_tangent[..., :3]),
                     obj_tangent[..., 3:4]], dim=-1)
    return pos, nrm, tan


class DynamicScene:
    """Owns the object-space geometry and one `Transform` per instance, and
    produces refreshed (SceneData, accel) pairs on demand.

        dyn = DynamicScene(builder)
        r = Renderer(dyn.build(), cfg, dynamic=dyn)  # on the CUDA device
        dyn.transform(3).translation = (1, 0, 0)   # marks the scene dirty
        r.render_frame(st, cam)                    # rebakes, then renders
    """

    def __init__(self, builder: SceneBuilder):
        self._builder = builder
        # flattened with identity transforms: the object-space arrays; the
        # instances' own transforms stay as each node's base matrix
        self._obj: FlatGeometry = flatten_instances([
            dataclasses.replace(i, transform=np.eye(4, dtype=np.float32))
            for i in builder.instances])
        self._obj_on: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        self._init_mats = [np.asarray(i.transform, np.float32)
                           for i in builder.instances]
        self._transforms: List[Transform] = []
        self.dirty = True
        for _ in builder.instances:
            tr = Transform()
            tr.add_dependent(self._mark_dirty)
            self._transforms.append(tr)
        self._scene0: Optional[SceneData] = None

    def transform(self, instance_id: int) -> Transform:
        return self._transforms[instance_id]

    def _mark_dirty(self):
        self.dirty = True

    def world_matrices(self) -> np.ndarray:
        """(I,4,4): each Transform node's world matrix composed with the
        instance's initial transform."""
        if not self._transforms:
            return np.zeros((0, 4, 4), np.float32)
        return np.stack([t.world_matrix @ m0 for t, m0 in
                         zip(self._transforms, self._init_mats)]
                        ).astype(np.float32)

    def build(self) -> SceneData:
        """The initial SceneData (the builder's host build, on the CPU)."""
        if self._scene0 is None:
            self._scene0 = self._builder.build()
        return self._scene0

    def _object_geometry(self, device: torch.device):
        if device not in self._obj_on:
            self._obj_on[device] = tuple(
                torch.from_numpy(a).to(device) for a in (
                    self._obj.tri_pos, self._obj.tri_normal,
                    self._obj.tri_tangent, self._obj.tri_inst))
        return self._obj_on[device]

    def _world_matrices_on(self, device: torch.device) -> torch.Tensor:
        return torch.from_numpy(self.world_matrices()).to(device)

    def rebake(self, scene: SceneData, clusters=None):
        """(scene, clusters) at the current transforms, on the scene's
        device; clusters (a ClusterSet) are refit when given, else None."""
        dev = scene.tri_pos.device
        pos, nrm, tan = _transform_geometry(*self._object_geometry(dev),
                                            self._world_matrices_on(dev))
        new_scene = scene.replace(tri_pos=pos, tri_normal=nrm,
                                  tri_tangent=tan,
                                  lights=refit_lights(scene.lights, pos))
        self.dirty = False
        if clusters is None:
            return new_scene, None
        return new_scene, refit_clusters(clusters, pos)

    def rebake_two_level(self, scene: SceneData, ics):
        """Two-level variant: the shading arrays rebake as in `rebake`, the
        accel refits only its instance and unit tables."""
        new_scene, _ = self.rebake(scene, None)
        mats = self._world_matrices_on(ics.inst_minv.device)
        return new_scene, refit_instances(ics, mats)
