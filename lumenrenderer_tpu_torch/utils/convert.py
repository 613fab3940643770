"""Carry state into the port from numpy arrays.

The JAX package's scene, cluster sets, camera, ReSTIR state and training
parameters, turned into numpy leaves by the caller (a mapping of field name
to array, nested for sub-structures), become the port's dataclasses (or
tensors), so both packages can compute on the same arrays. This module takes
numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..accel.stream import (TREE_FIELDS, ClusterSet, kernel_layout,
                            walk_layout)
from ..accel.two_level import InstancedClusterSet
from ..core.camera import Camera
from ..restir.di import Reservoir, RestirState
from ..scene.lights import TriangleLights
from ..scene.materials import MaterialTable
from ..scene.scene import SceneData
from ..scene.textures import TextureAtlas
from ..volume.grid import SparseVolumeSet, VolumeSet


def _fill(cls, leaves: Mapping, **nested):
    """cls(**fields) with each field taken from `leaves` as a tensor, except
    those given in `nested`."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in nested:
            kw[f.name] = nested[f.name]
        else:
            kw[f.name] = torch.from_numpy(np.array(leaves[f.name]))
    return cls(**kw)


def _volumes(leaves: Optional[Mapping]):
    """VolumeSet, or SparseVolumeSet (its leaves have `index`, and `res`
    the sample grid's resolution), from the JAX volume set's leaves; None
    for None."""
    if leaves is None:
        return None
    if "index" in leaves:
        return _fill(SparseVolumeSet, leaves,
                     res=tuple(int(s) for s in np.asarray(leaves["res"])))
    return _fill(VolumeSet, leaves)


def scene_from_numpy(leaves: Mapping) -> SceneData:
    """SceneData from the JAX SceneData's leaves, its texture atlas and its
    volumes (dense or sparse, or None) whole."""
    return _fill(
        SceneData, leaves,
        materials=_fill(MaterialTable, leaves["materials"]),
        lights=_fill(TriangleLights, leaves["lights"]),
        textures=_fill(TextureAtlas, leaves["textures"]),
        volumes=_volumes(leaves.get("volumes")))


def _layouts(leaves: Mapping) -> dict:
    """tree_depth and the kernels' layouts (slabs, nlive, tree_nodes) from a
    JAX cluster or instanced set's leaves."""
    tree = {f: torch.from_numpy(np.array(leaves[f])) for f in TREE_FIELDS
            if f != "tree_depth"}
    return dict(tree_depth=int(leaves["tree_depth"]), **walk_layout(tree),
                **kernel_layout(torch.from_numpy(np.array(
                    leaves["tri_feat"]))))


def clusters_from_numpy(leaves: Mapping) -> ClusterSet:
    """ClusterSet from the JAX ClusterSet's leaves (aabb_lo, aabb_hi,
    tri_feat, tri_id, the cluster tree's `tree_*` and tree_depth); the
    kernels' layout is made from tri_feat and the tree."""
    return _fill(ClusterSet, leaves, **_layouts(leaves))


def instanced_from_numpy(leaves: Mapping) -> InstancedClusterSet:
    """InstancedClusterSet from the JAX InstancedClusterSet's leaves, the
    unit tree's included; the kernels' layout is made from tri_feat and the
    tree."""
    return _fill(InstancedClusterSet, leaves,
                 tris_per_cluster=int(leaves["tris_per_cluster"]),
                 **_layouts(leaves))


def camera_from_numpy(leaves: Mapping) -> Camera:
    """Camera from eye, u, v, w, prev_view_proj, t_min and t_max."""
    return _fill(Camera, leaves)


def params_from_numpy(leaves: Mapping) -> Dict[str, torch.Tensor]:
    """The training parameters (the JAX `split_params` dict: base_color,
    roughness, metallic, emissive, env_radiance) as float32 tensors, for
    `parallel.train`'s init_state."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in leaves.items()}


def restir_state_from_numpy(leaves: Mapping) -> RestirState:
    """RestirState (reservoir history and gbuffer) from the JAX RestirState's
    leaves."""
    return _fill(RestirState, leaves,
                 reservoir=_fill(Reservoir, leaves["reservoir"]))
