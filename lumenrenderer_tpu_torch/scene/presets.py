"""Built-in test scenes: port of `lumenrenderer_tpu/scene/presets.py`.

`cornell_box`, `furnace_scene`, `interior_scene` and `mega_scene` build the
same geometry and materials as the JAX presets (same numpy seed).
`instanced_boxes` is the two-level scene of the JAX package's tests
(`tests/test_two_level.py`), which has no JAX preset.
"""
from __future__ import annotations

import numpy as np

from ..core.camera import Camera
from .geometry import EmissionMode, InstanceHost, MeshHost
from .materials import MaterialSpec
from .scene import SceneBuilder


def quad(p00, p10, p11, p01):
    """Two-triangle quad from 4 corners (CCW front face)."""
    pos = np.array([p00, p10, p11, p01], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return pos, idx


def make_quad_mesh(corners, material_id: int) -> MeshHost:
    pos, idx = quad(*corners)
    return MeshHost(positions=pos, indices=idx, material_ids=material_id)


def cornell_box(
    light_radiance=(15.0, 15.0, 15.0),
    with_blocks: bool = True,
    bsdf_extras: bool = False,
):
    """The classic Cornell box in [0,1]^3, camera on +z looking at -z.

    Returns (SceneBuilder, camera_factory(aspect)->Camera).
    bsdf_extras: make one block metallic-glossy for GGX tests.
    """
    b = SceneBuilder()
    white = b.add_material(MaterialSpec(base_color=(0.73, 0.73, 0.73), roughness=1.0))
    red = b.add_material(MaterialSpec(base_color=(0.65, 0.05, 0.05), roughness=1.0))
    green = b.add_material(MaterialSpec(base_color=(0.12, 0.45, 0.15), roughness=1.0))
    light = b.add_material(
        MaterialSpec(base_color=(0.0, 0.0, 0.0), emissive=tuple(light_radiance))
    )
    glossy = b.add_material(
        MaterialSpec(base_color=(0.8, 0.6, 0.2), metallic=1.0, roughness=0.25)
    )

    def add_quad(corners, mat, mode=EmissionMode.ENABLED):
        b.add_instance(
            InstanceHost(mesh=make_quad_mesh(corners, mat), emission_mode=mode)
        )

    # floor (y=0, normal +y): cross(e1,e2) must be +y
    add_quad([(0, 0, 1), (1, 0, 1), (1, 0, 0), (0, 0, 0)], white)
    # ceiling (y=1, normal -y)
    add_quad([(0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1)], white)
    # back wall (z=0, normal +z)
    add_quad([(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)], white)
    # left wall (x=0, normal +x) red
    add_quad([(0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1)], red)
    # right wall (x=1, normal -x) green
    add_quad([(1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0)], green)
    # area light: small quad under the ceiling, facing down (-y)
    ly = 0.999
    add_quad(
        [(0.35, ly, 0.35), (0.65, ly, 0.35), (0.65, ly, 0.65), (0.35, ly, 0.65)],
        light,
    )

    if with_blocks:
        tall_mat = glossy if bsdf_extras else white
        b.add_instance(
            InstanceHost(mesh=box_mesh((0.15, 0.0, 0.10), (0.45, 0.6, 0.40), tall_mat))
        )
        b.add_instance(
            InstanceHost(mesh=box_mesh((0.55, 0.0, 0.50), (0.85, 0.3, 0.80), white))
        )

    def make_camera(aspect: float = 1.0) -> Camera:
        return Camera.look_at(
            eye=(0.5, 0.5, 2.45),
            target=(0.5, 0.5, 0.0),
            fov_y_deg=28.0,
            aspect=aspect,
        )

    return b, make_camera


def box_mesh(lo, hi, material_id: int) -> MeshHost:
    """Axis-aligned box with outward faces."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    faces = [
        # -z
        [(x0, y0, z0), (x0, y1, z0), (x1, y1, z0), (x1, y0, z0)],
        # +z
        [(x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)],
        # -x
        [(x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)],
        # +x
        [(x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (x1, y0, z1)],
        # -y
        [(x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)],
        # +y
        [(x0, y1, z0), (x0, y1, z1), (x1, y1, z1), (x1, y1, z0)],
    ]
    pos = []
    idx = []
    for f in faces:
        base = len(pos)
        pos.extend(f)
        idx.append([base, base + 1, base + 2])
        idx.append([base, base + 2, base + 3])
    return MeshHost(
        positions=np.array(pos, np.float32),
        indices=np.array(idx, np.int32),
        material_ids=material_id,
    )


def furnace_scene(albedo: float = 0.5, env: float = 1.0):
    """A single large quad filling the view, lit only by a constant
    environment — every cosine-sampled bounce escapes. Analytic value at
    depth D with NEE off and Lambert albedo rho: sum_{k=1..D-1} handled by
    test; used for exact energy-conservation checks."""
    b = SceneBuilder(env_radiance=(env, env, env))
    m = b.add_material(MaterialSpec(base_color=(albedo, albedo, albedo), roughness=1.0))
    b.add_instance(
        InstanceHost(
            mesh=make_quad_mesh(
                [(-50, -50, 0), (50, -50, 0), (50, 50, 0), (-50, 50, 0)], m
            )
        )
    )

    def make_camera(aspect: float = 1.0) -> Camera:
        return Camera.look_at(eye=(0, 0, 5), target=(0, 0, 0), fov_y_deg=40.0, aspect=aspect)

    return b, make_camera


def interior_scene(n_boxes: int = 600, n_lights: int = 64, seed: int = 0):
    """Procedural many-light interior: a big room filled with random boxes and
    many emissive panels — the benchmark/ReSTIR workload (≙ BASELINE config 3
    'many-light interior scene'). ~12 tris/box + room + lights."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mats = [
        b.add_material(
            MaterialSpec(
                base_color=tuple(rng.uniform(0.2, 0.9, 3)),
                roughness=float(rng.uniform(0.1, 1.0)),
                metallic=float(rng.uniform(0, 1) < 0.2),
            )
        )
        for _ in range(16)
    ]
    white = b.add_material(MaterialSpec(base_color=(0.7, 0.7, 0.7), roughness=1.0))
    room = 20.0
    # room shell (inward-facing box): reuse box_mesh but flip by using walls
    wallpts = [
        [(0, 0, room), (room, 0, room), (room, 0, 0), (0, 0, 0)],          # floor +y
        [(0, room, 0), (room, room, 0), (room, room, room), (0, room, room)],  # ceil -y
        [(0, 0, 0), (room, 0, 0), (room, room, 0), (0, room, 0)],          # back +z
        [(0, 0, 0), (0, room, 0), (0, room, room), (0, 0, room)],          # left +x
        [(room, 0, 0), (room, 0, room), (room, room, room), (room, room, 0)],  # right -x
    ]
    for w in wallpts:
        b.add_instance(InstanceHost(mesh=make_quad_mesh(w, white)))
    for _ in range(n_boxes):
        c = rng.uniform(1, room - 1, 3)
        s = rng.uniform(0.2, 1.2, 3)
        lo = c - s / 2
        hi = c + s / 2
        lo[1] = max(lo[1], 0.0)
        b.add_instance(
            InstanceHost(mesh=box_mesh(lo, hi, mats[rng.integers(len(mats))]))
        )
    for _ in range(n_lights):
        c = rng.uniform(2, room - 2, 3)
        c[1] = rng.uniform(room * 0.6, room - 0.2)
        s = rng.uniform(0.3, 0.8)
        col = rng.uniform(2.0, 30.0, 3)
        lm = b.add_material(MaterialSpec(base_color=(0, 0, 0), emissive=tuple(col)))
        b.add_instance(
            InstanceHost(
                mesh=make_quad_mesh(
                    [
                        (c[0] - s, c[1], c[2] - s),
                        (c[0] + s, c[1], c[2] - s),
                        (c[0] + s, c[1], c[2] + s),
                        (c[0] - s, c[1], c[2] + s),
                    ],
                    lm,
                )
            )
        )

    def make_camera(aspect: float = 1.0) -> Camera:
        return Camera.look_at(
            eye=(room / 2, room * 0.45, room - 1.0),
            target=(room / 2, room * 0.35, 0.0),
            fov_y_deg=60.0,
            aspect=aspect,
        )

    return b, make_camera


def instanced_boxes(n_inst: int = 20, seed: int = 5):
    """`n_inst` instances of one 12-triangle box, each rotated about z,
    scaled by 0.4-1.2 and moved within [-3, 3]^3, under one emissive box:
    one mesh object shared by many instances, for `accel="two_level"`."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    white = b.add_material(MaterialSpec(base_color=(0.7, 0.7, 0.7)))
    lightm = b.add_material(MaterialSpec(emissive=(9.0, 9.0, 9.0)))

    def centred_box(s):
        v = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                      for z in (-s, s)], np.float32)
        f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                      [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                      [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
        return MeshHost(positions=v, indices=f)

    box = centred_box(0.5)
    for _ in range(n_inst):
        m4 = np.eye(4, dtype=np.float32)
        ang = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(ang), np.sin(ang)
        m4[:3, :3] = (np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
                      * rng.uniform(0.4, 1.2))
        m4[:3, 3] = rng.uniform(-3, 3, 3)
        b.add_instance(InstanceHost(mesh=box, transform=m4,
                                    material_override=white))
    m4 = np.eye(4, dtype=np.float32)
    m4[:3, 3] = [0.0, 5.0, 0.0]
    b.add_instance(InstanceHost(mesh=centred_box(0.8), transform=m4,
                                material_override=lightm))

    def make_camera(aspect: float = 1.0) -> Camera:
        return Camera.look_at((0.0, 1.0, 9.0), (0.0, 0.0, 0.0),
                              fov_y_deg=50.0, aspect=aspect)

    return b, make_camera


def mega_scene(n_tris: int = 1_000_000, n_lights: int = 256, seed: int = 0):
    """About n_tris triangles: a field of perturbed boxes under many
    down-facing area lights, built vectorised as one mesh so the host build
    stays fast at millions of triangles. At the default size it has more
    than 2048 clusters, so the tiled intersector culls through the cluster
    tree."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(light_capacity=max(n_lights * 2, 512))
    n_box = max(n_tris // 12, 1)
    side = 200.0

    mats = [
        b.add_material(
            MaterialSpec(
                base_color=tuple(rng.uniform(0.2, 0.9, 3)),
                roughness=float(rng.uniform(0.15, 1.0)),
                metallic=float(rng.uniform(0, 1) < 0.15),
            )
        )
        for _ in range(32)
    ]

    # unit box template (24 vertices, 12 triangles), outward faces
    tmpl = box_mesh((0, 0, 0), (1, 1, 1), 0)
    tv = tmpl.positions
    ti = tmpl.indices
    centers = rng.uniform(2, side - 2, (n_box, 3)).astype(np.float32)
    centers[:, 1] = rng.uniform(0, 12, n_box)  # pile near the ground
    scales = rng.uniform(0.3, 2.0, (n_box, 3)).astype(np.float32)
    verts = (tv[None] * scales[:, None, :] + centers[:, None, :]).reshape(-1, 3)
    idx = (ti[None] + (np.arange(n_box) * 24)[:, None, None]).reshape(-1, 3)
    tri_mats = np.repeat(
        np.array(mats, np.int32)[rng.integers(0, len(mats), n_box)], 12)
    b.add_instance(InstanceHost(mesh=MeshHost(
        positions=verts.astype(np.float32), indices=idx.astype(np.int32),
        material_ids=tri_mats)))
    g = b.add_material(MaterialSpec(base_color=(0.5, 0.5, 0.5), roughness=1.0))
    b.add_instance(InstanceHost(mesh=make_quad_mesh(
        [(0, 0, side), (side, 0, side), (side, 0, 0), (0, 0, 0)], g)))
    # lights: one mesh of emissive quads facing down
    lc = rng.uniform(4, side - 4, (n_lights, 3)).astype(np.float32)
    lc[:, 1] = rng.uniform(14, 25, n_lights)
    ls = rng.uniform(0.5, 2.0, n_lights).astype(np.float32)
    lm = b.add_material(MaterialSpec(base_color=(0, 0, 0),
                                     emissive=(600.0, 560.0, 500.0)))
    lv, li = [], []
    for i in range(n_lights):
        base = 4 * i
        x, y, z = lc[i]
        s = ls[i]
        lv += [(x - s, y, z - s), (x + s, y, z - s), (x + s, y, z + s),
               (x - s, y, z + s)]
        li += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    b.add_instance(InstanceHost(mesh=MeshHost(
        positions=np.array(lv, np.float32), indices=np.array(li, np.int32),
        material_ids=lm)))

    def make_camera(aspect: float = 1.0) -> Camera:
        return Camera.look_at(
            eye=(side / 2, 14.0, side - 4.0),
            target=(side / 2, 4.0, side / 2),
            fov_y_deg=55.0,
            aspect=aspect,
        )

    return b, make_camera


def build(builder_and_cam, aspect: float = 1.0):
    b, cam_f = builder_and_cam
    return b.build(), cam_f(aspect)
