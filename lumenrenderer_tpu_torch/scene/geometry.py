"""Host-side geometry: meshes, instances, and scene flattening (numpy).

Port of `lumenrenderer_tpu/scene/geometry.py`; the code is numpy in both
packages. `flatten_instances` bakes instance transforms into world-space
triangle arrays for the single-level scene.
"""
from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import List, Optional

import numpy as np


class EmissionMode(IntEnum):
    """Mirror of `Lumen::EmissionMode` (`ModelLoading/MeshInstance.h`)."""

    DISABLED = 0
    ENABLED = 1
    OVERRIDE = 2


@dataclasses.dataclass
class MeshHost:
    """One mesh: positions (V,3) f32, indices (T,3) i32, optional normals,
    uvs (V,2), tangents (V,4) [xyz + handedness w], per-triangle material ids
    (T,) into the scene material table."""

    positions: np.ndarray
    indices: np.ndarray
    normals: Optional[np.ndarray] = None
    uvs: Optional[np.ndarray] = None
    tangents: Optional[np.ndarray] = None
    material_ids: Optional[np.ndarray] = None

    def __post_init__(self):
        self.positions = np.asarray(self.positions, np.float32).reshape(-1, 3)
        self.indices = np.asarray(self.indices, np.int32).reshape(-1, 3)
        t = self.indices.shape[0]
        v = self.positions.shape[0]
        if self.normals is None:
            self.normals = compute_vertex_normals(self.positions, self.indices)
        else:
            self.normals = np.asarray(self.normals, np.float32).reshape(v, 3)
        if self.uvs is None:
            self.uvs = np.zeros((v, 2), np.float32)
        else:
            self.uvs = np.asarray(self.uvs, np.float32).reshape(v, 2)
        if self.tangents is None:
            self.tangents = compute_tangents(
                self.positions, self.normals, self.uvs, self.indices
            )
        else:
            self.tangents = np.asarray(self.tangents, np.float32).reshape(v, 4)
        if self.material_ids is None:
            self.material_ids = np.zeros((t,), np.int32)
        else:
            mi = np.asarray(self.material_ids, np.int32)
            self.material_ids = (
                np.full((t,), int(mi), np.int32) if mi.ndim == 0 else mi.reshape(t)
            )

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]


@dataclasses.dataclass
class InstanceHost:
    """Mesh instance: transform + emission override, mirroring the reference's
    `MeshInstance` (`ModelLoading/MeshInstance.h`, emission modes + override
    radiance + material override)."""

    mesh: MeshHost
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    emission_mode: EmissionMode = EmissionMode.ENABLED
    emission_override: Optional[np.ndarray] = None  # (3,) radiance override
    material_override: int = -1

    def __post_init__(self):
        self.transform = np.asarray(self.transform, np.float32).reshape(4, 4)


def compute_vertex_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (used when the asset has none, like the
    reference's tangent/normal generation in `SceneManager.cpp:362-440`)."""
    v0, v1, v2 = (positions[indices[:, k]] for k in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    out = np.zeros_like(positions)
    for k in range(3):
        np.add.at(out, indices[:, k], fn)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(norm, 1e-12)).astype(np.float32)


def compute_tangents(
    positions: np.ndarray, normals: np.ndarray, uvs: np.ndarray, indices: np.ndarray
) -> np.ndarray:
    """Per-vertex tangents from UV derivatives (MikkTSpace-style average),
    equivalent of the reference's tangent generation (`SceneManager.cpp:362-440`).
    Degenerate UVs fall back to an arbitrary frame."""
    v = positions.shape[0]
    tan = np.zeros((v, 3), np.float64)
    p0, p1, p2 = (positions[indices[:, k]].astype(np.float64) for k in range(3))
    t0, t1, t2 = (uvs[indices[:, k]].astype(np.float64) for k in range(3))
    e1, e2 = p1 - p0, p2 - p0
    du1, dv1 = t1[:, 0] - t0[:, 0], t1[:, 1] - t0[:, 1]
    du2, dv2 = t2[:, 0] - t0[:, 0], t2[:, 1] - t0[:, 1]
    det = du1 * dv2 - du2 * dv1
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1.0, det), 0.0)
    t = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r[:, None]
    for k in range(3):
        np.add.at(tan, indices[:, k], t)
    # Gram-Schmidt against the normal; fall back to any perpendicular axis.
    n = normals.astype(np.float64)
    t_ortho = tan - n * np.sum(tan * n, axis=-1, keepdims=True)
    ln = np.linalg.norm(t_ortho, axis=-1, keepdims=True)
    fallback = np.cross(n, np.where(np.abs(n[:, 1:2]) < 0.99, [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]))
    fb_norm = fallback / np.maximum(np.linalg.norm(fallback, axis=-1, keepdims=True), 1e-12)
    t_final = np.where(ln > 1e-8, t_ortho / np.maximum(ln, 1e-12), fb_norm)
    w = np.ones((v, 1), np.float64)
    return np.concatenate([t_final, w], axis=-1).astype(np.float32)


@dataclasses.dataclass
class FlatGeometry:
    """World-space flattened triangle SoA (numpy, host)."""

    tri_pos: np.ndarray      # (T,3,3) world-space vertex positions
    tri_normal: np.ndarray   # (T,3,3) world-space shading normals
    tri_uv: np.ndarray       # (T,3,2)
    tri_tangent: np.ndarray  # (T,3,4) world-space tangents + handedness
    tri_mat: np.ndarray      # (T,) int32 material id (after instance override)
    tri_inst: np.ndarray     # (T,) int32 instance id
    # per-instance emission override data (for light extraction)
    inst_emission_mode: np.ndarray      # (I,) int32
    inst_emission_override: np.ndarray  # (I,3) float32


def flatten_instances(instances: List[InstanceHost]) -> FlatGeometry:
    """Bake instance transforms into one world-space triangle array.

    Single-level analogue of the reference's IAS-over-GAS: correctness-first
    path; the two-level BVH keeps meshes untransformed.
    """
    tp, tn, tuv, tt, tm, ti = [], [], [], [], [], []
    modes, overrides = [], []
    for inst_id, inst in enumerate(instances):
        m = inst.mesh
        tf = inst.transform
        rot = tf[:3, :3]
        nrm_mat = np.linalg.inv(rot).T if abs(np.linalg.det(rot)) > 1e-12 else rot
        pos_w = m.positions @ rot.T + tf[:3, 3]
        nrm_w = m.normals @ nrm_mat.T
        nrm_w /= np.maximum(np.linalg.norm(nrm_w, axis=-1, keepdims=True), 1e-12)
        tan_w = np.concatenate(
            [m.tangents[:, :3] @ rot.T, m.tangents[:, 3:4]], axis=-1
        )
        idx = m.indices
        tp.append(pos_w[idx])
        tn.append(nrm_w[idx])
        tuv.append(m.uvs[idx])
        tt.append(tan_w[idx])
        mats = m.material_ids.copy()
        if inst.material_override >= 0:
            mats[:] = inst.material_override
        tm.append(mats)
        ti.append(np.full((idx.shape[0],), inst_id, np.int32))
        modes.append(int(inst.emission_mode))
        overrides.append(
            np.zeros(3, np.float32)
            if inst.emission_override is None
            else np.asarray(inst.emission_override, np.float32)
        )
    cat = lambda xs, d: np.concatenate(xs, axis=0) if xs else np.zeros(d, np.float32)
    return FlatGeometry(
        tri_pos=cat(tp, (0, 3, 3)),
        tri_normal=cat(tn, (0, 3, 3)),
        tri_uv=cat(tuv, (0, 3, 2)),
        tri_tangent=cat(tt, (0, 3, 4)),
        tri_mat=np.concatenate(tm).astype(np.int32) if tm else np.zeros(0, np.int32),
        tri_inst=np.concatenate(ti).astype(np.int32) if ti else np.zeros(0, np.int32),
        inst_emission_mode=np.array(modes, np.int32),
        inst_emission_override=np.array(overrides, np.float32).reshape(-1, 3),
    )
