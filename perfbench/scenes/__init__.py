"""Scene generators, found by name: `perfbench/scenes/<name>.py` defines
`make(**params) -> SceneSpec`. A configuration names its generator and
parameters; the benchmark builds the arrays and hands the same to the
program (`perfbench.port.build_scene`) and to the reference."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Sequence

import numpy as np

# The Disney parameters of a material and their defaults (the port's and
# the JAX package's `MaterialSpec`); a scene states every one.
MATERIAL_DEFAULTS = {
    "base_color": (0.8, 0.8, 0.8), "emissive": (0.0, 0.0, 0.0),
    "metallic": 0.0, "roughness": 0.5, "subsurface": 0.0, "specular": 0.5,
    "spec_tint": 0.0, "anisotropic": 0.0, "sheen": 0.0, "sheen_tint": 0.5,
    "clearcoat": 0.0, "clearcoat_gloss": 1.0, "spec_trans": 0.0, "ior": 1.5,
    "transmittance": (1.0, 1.0, 1.0),
}


def default_material() -> Dict:
    return dict(MATERIAL_DEFAULTS)


def quad(corners: Sequence, material: int):
    """A planar quad as (positions (4,3) float32, material): two triangles
    (0, 1, 2) and (0, 2, 3), front face counter-clockwise."""
    return np.asarray(corners, np.float32).reshape(4, 3), int(material)


QUAD_INDICES = np.array([[0, 1, 2], [0, 2, 3]], np.int32)


@dataclasses.dataclass
class SceneSpec:
    """A scene as plain arrays: tri_pos (T,3,3) and tri_normal (T,3,3)
    float32 (vertex normals: each quad's face normal), tri_mat (T,) int32,
    the material table (name -> (M,) or (M,3) float32), the camera's eye,
    target and vertical field of view, and a constant environment
    radiance."""

    tri_pos: np.ndarray
    tri_normal: np.ndarray
    tri_mat: np.ndarray
    materials: Dict[str, np.ndarray]
    eye: tuple
    target: tuple
    fov_y_deg: float
    env_radiance: tuple = (0.0, 0.0, 0.0)

    @staticmethod
    def from_quads(quads: List, mats: List[Dict], **camera) -> "SceneSpec":
        pos = np.stack([q[0] for q in quads])                 # (Q,4,3)
        n = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        tri_pos = pos[:, QUAD_INDICES].reshape(-1, 3, 3)
        tri_normal = np.repeat(n[:, None, None, :], 2, 1)
        tri_normal = np.repeat(tri_normal, 3, 2).reshape(-1, 3, 3)
        tri_mat = np.repeat(np.array([q[1] for q in quads], np.int32), 2)
        table = {k: np.array([m[k] for m in mats], np.float32)
                 for k in MATERIAL_DEFAULTS}
        return SceneSpec(tri_pos=tri_pos.astype(np.float32),
                         tri_normal=tri_normal.astype(np.float32),
                         tri_mat=tri_mat, materials=table, **camera)

    @property
    def num_triangles(self) -> int:
        return self.tri_pos.shape[0]


def make(name: str, params: Dict) -> SceneSpec:
    """The scene of generator `name` (`perfbench/scenes/<name>.py`)."""
    return importlib.import_module(f"perfbench.scenes.{name}").make(**params)
