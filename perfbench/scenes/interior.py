"""The many-light interior: a 20-unit room of random boxes under emissive
panels, drawn from its own seed.

The draws follow the port's `presets.interior_scene` one for one (16 random
materials, a white one, the room's five walls, `n_boxes` boxes, `n_lights`
panels with a material each), so the same seed gives the same 7,338
triangles at the default sizes. The benchmark makes the scene itself and
hands the same arrays to the program and to the reference.
"""
from __future__ import annotations

import numpy as np

from perfbench.scenes import SceneSpec, default_material, quad

ROOM = 20.0


def _box_faces(lo, hi):
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    return [
        [(x0, y0, z0), (x0, y1, z0), (x1, y1, z0), (x1, y0, z0)],   # -z
        [(x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)],   # +z
        [(x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)],   # -x
        [(x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (x1, y0, z1)],   # +x
        [(x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)],   # -y
        [(x0, y1, z0), (x0, y1, z1), (x1, y1, z1), (x1, y1, z0)],   # +y
    ]


def make(n_boxes: int = 600, n_lights: int = 64, seed: int = 0) -> SceneSpec:
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(16):
        m = default_material()
        m["base_color"] = tuple(float(x) for x in rng.uniform(0.2, 0.9, 3))
        m["roughness"] = float(rng.uniform(0.1, 1.0))
        m["metallic"] = float(rng.uniform(0, 1) < 0.2)
        mats.append(m)
    white = default_material()
    white.update(base_color=(0.7, 0.7, 0.7), roughness=1.0)
    mats.append(white)
    white_id = len(mats) - 1
    r = ROOM
    meshes = [quad(w, white_id) for w in (
        [(0, 0, r), (r, 0, r), (r, 0, 0), (0, 0, 0)],
        [(0, r, 0), (r, r, 0), (r, r, r), (0, r, r)],
        [(0, 0, 0), (r, 0, 0), (r, r, 0), (0, r, 0)],
        [(0, 0, 0), (0, r, 0), (0, r, r), (0, 0, r)],
        [(r, 0, 0), (r, 0, r), (r, r, r), (r, r, 0)],
    )]
    for _ in range(n_boxes):
        c = rng.uniform(1, r - 1, 3)
        s = rng.uniform(0.2, 1.2, 3)
        lo = c - s / 2
        hi = c + s / 2
        lo[1] = max(lo[1], 0.0)
        lo = lo.astype(np.float32)
        hi = hi.astype(np.float32)
        mat = int(rng.integers(16))
        meshes.extend(quad(f, mat) for f in _box_faces(lo, hi))
    for _ in range(n_lights):
        c = rng.uniform(2, r - 2, 3)
        c[1] = rng.uniform(r * 0.6, r - 0.2)
        s = rng.uniform(0.3, 0.8)
        col = rng.uniform(2.0, 30.0, 3)
        m = default_material()
        m.update(base_color=(0.0, 0.0, 0.0),
                 emissive=tuple(float(x) for x in col))
        mats.append(m)
        meshes.append(quad([(c[0] - s, c[1], c[2] - s),
                            (c[0] + s, c[1], c[2] - s),
                            (c[0] + s, c[1], c[2] + s),
                            (c[0] - s, c[1], c[2] + s)], len(mats) - 1))
    return SceneSpec.from_quads(
        meshes, mats, eye=(r / 2, r * 0.45, r - 1.0),
        target=(r / 2, r * 0.35, 0.0), fov_y_deg=60.0)
