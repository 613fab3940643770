"""The program under test, reached through its public API only: the
scene handed to `SceneBuilder`, the camera, the Renderer. Nothing here
derives data for the reference."""
from __future__ import annotations

from typing import Dict

import numpy as np

from perfbench.scenes import SceneSpec


def build_scene(spec: SceneSpec):
    """The port's SceneData (CPU tensors) of `spec`: one mesh of the
    scene's triangles, its vertex normals and material ids given, one
    instance at the identity, every material stated in full."""
    from lumenrenderer_tpu_torch.scene.geometry import InstanceHost, MeshHost
    from lumenrenderer_tpu_torch.scene.materials import MaterialSpec
    from lumenrenderer_tpu_torch.scene.scene import SceneBuilder

    b = SceneBuilder(env_radiance=tuple(spec.env_radiance))
    m = spec.materials
    for i in range(m["base_color"].shape[0]):
        b.add_material(MaterialSpec(**{
            k: (tuple(float(x) for x in v[i]) if v.ndim == 2
                else float(v[i])) for k, v in m.items()}))
    t = spec.num_triangles
    b.add_instance(InstanceHost(mesh=MeshHost(
        positions=spec.tri_pos.reshape(-1, 3),
        indices=np.arange(3 * t, dtype=np.int32).reshape(t, 3),
        normals=spec.tri_normal.reshape(-1, 3),
        material_ids=spec.tri_mat)))
    return b.build()


def camera(spec: SceneSpec, width: int, height: int):
    from lumenrenderer_tpu_torch.core.camera import Camera

    return Camera.look_at(eye=spec.eye, target=spec.target,
                          fov_y_deg=spec.fov_y_deg, aspect=width / height)


def render_config(cfg: Dict):
    from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig

    return RenderConfig(**cfg)


def renderer(spec: SceneSpec, config: Dict, device, candidate_dtype=None):
    """The Renderer of a configuration file's `renderer` block (accel,
    candidate_dtype, RenderConfig) on `device`; `candidate_dtype`
    overrides the file's (the lower-precision control)."""
    from lumenrenderer_tpu_torch.render.renderer import Renderer

    r = config["renderer"]
    return Renderer(build_scene(spec), render_config(r["render_config"]),
                    accel=r["accel"], device=device,
                    candidate_dtype=candidate_dtype or r["candidate_dtype"])
