"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
state is carried into the port through numpy (`utils/convert.py`).
"""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lumenrenderer_tpu_torch.utils import convert

if os.environ.get("PYTEST_XDIST_WORKER"):
    # the suite runs several workers at once: keep each to two threads
    torch.set_num_threads(2)


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def coherent_rays(g, tiles, spread=4.0, cone=0.15):
    """128 rays per tile from nearby origins in a cone around one direction,
    as camera and sorted secondary rays come."""
    o = np.repeat(g.uniform(-spread, spread, (tiles, 1, 3)), 128, 1)
    o = o + g.normal(size=o.shape) * 0.05
    base = g.normal(size=(tiles, 1, 3))
    d = (base / np.linalg.norm(base, axis=-1, keepdims=True)
         + g.normal(size=(tiles, 128, 3)) * cone)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.reshape(-1, 3).astype(np.float32), d.reshape(-1, 3).astype(
        np.float32)


def to_numpy_tree(obj):
    """JAX pytree (chex/flax dataclass, dict, array) -> nested dict of numpy
    arrays; python scalars pass through."""
    if obj is None or isinstance(obj, (int, float, bool, str)):
        return obj
    if isinstance(obj, (jnp.ndarray, np.ndarray, jax.Array)):
        return np.asarray(obj)
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if hasattr(obj, "items"):
        return {k: to_numpy_tree(v) for k, v in obj.items()}
    if hasattr(obj, "_asdict"):
        return {k: to_numpy_tree(v) for k, v in obj._asdict().items()}
    return np.asarray(obj)


def t(x, dtype=None) -> torch.Tensor:
    """numpy/JAX array -> CPU tensor."""
    a = torch.from_numpy(np.array(x))
    return a if dtype is None else a.to(dtype)


def n(x) -> np.ndarray:
    """tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def port_scene(jax_scene):
    return convert.scene_from_numpy(to_numpy_tree(jax_scene))


def port_clusters(jax_cs):
    return convert.clusters_from_numpy(to_numpy_tree(jax_cs))


def port_camera(jax_cam):
    return convert.camera_from_numpy(to_numpy_tree(jax_cam))


def port_instanced(jax_ics):
    return convert.instanced_from_numpy(to_numpy_tree(jax_ics))


def jax_instanced_builder(n_inst: int = 20, seed: int = 5):
    """The JAX package's SceneBuilder of the two-level test scene
    (tests/test_two_level.py), which the port builds as
    `presets.instanced_boxes(n_inst, seed)`."""
    from lumenrenderer_tpu.scene.geometry import InstanceHost, MeshHost
    from lumenrenderer_tpu.scene.materials import MaterialSpec
    from lumenrenderer_tpu.scene.scene import SceneBuilder

    def box(s):
        v = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                      for z in (-s, s)], np.float32)
        f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                      [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                      [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
        return MeshHost(positions=v, indices=f)

    g = np.random.default_rng(seed)
    b = SceneBuilder()
    white = b.add_material(MaterialSpec(base_color=(0.7, 0.7, 0.7)))
    lightm = b.add_material(MaterialSpec(emissive=(9.0, 9.0, 9.0)))
    mesh = box(0.5)
    for _ in range(n_inst):
        m4 = np.eye(4, dtype=np.float32)
        ang = g.uniform(0, 2 * np.pi)
        c, s = np.cos(ang), np.sin(ang)
        m4[:3, :3] = (np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
                      * g.uniform(0.4, 1.2))
        m4[:3, 3] = g.uniform(-3, 3, 3)
        b.add_instance(InstanceHost(mesh=mesh, transform=m4,
                                    material_override=white))
    m4 = np.eye(4, dtype=np.float32)
    m4[:3, 3] = [0.0, 5.0, 0.0]
    b.add_instance(InstanceHost(mesh=box(0.8), transform=m4,
                                material_override=lightm))
    return b


class ListUniforms:
    """A draw source that returns given arrays in order, checking that each
    draw has the shape (and kind: float or integer) the JAX code drew."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def _pop(self, shape, kind):
        a = self.arrays.pop(0)
        assert a.shape == shape and a.dtype.kind == kind, (a.shape, a.dtype,
                                                           shape, kind)
        return a

    def __call__(self, *shape):
        return torch.from_numpy(np.array(self._pop(shape, "f"), np.float32))

    uniform = __call__

    def randint(self, high, *shape):
        a = self._pop(shape, "i")
        assert a.size == 0 or (0 <= a.min() and a.max() < high)
        return torch.from_numpy(np.array(a, np.int32))


def jax_restir_draws(key, rcfg, w: int, h: int, temporal: bool = True,
                     volumes: bool = False):
    """The draws `lumenrenderer_tpu`'s RestirDI.__call__ takes from `key` at
    a w x h frame, in the port's order: the bags' uniforms; RIS's bag and
    slot integers and barycentric and pick uniforms (tile-candidate or
    per-pixel shapes, as di.ris_primary chooses); the temporal combine's
    uniform (when there is a history state); per spatial iteration the
    angle, radius and pick uniforms; with volumes, the shading's
    transmittance uniform."""
    n = w * h
    c, s, bt = rcfg.candidates, rcfg.spatial_samples, rcfg.bag_tile
    k_bag, k_ris, k_t, k_s, _, k_v2 = jax.random.split(key, 6)
    out = [jax.random.uniform(k_bag, (rcfg.num_bags, rcfg.bag_size))]
    kb, kc, kp, kr = jax.random.split(k_ris, 4)
    if rcfg.tile_candidates and w % bt == 0 and h % bt == 0:
        tiles = (w // bt) * (h // bt)
        out += [jax.random.randint(kb, (tiles,), 0, rcfg.num_bags),
                jax.random.randint(kc, (tiles, c), 0, rcfg.bag_size),
                jax.random.uniform(kp, (tiles, 1, c, 2)),
                jax.random.uniform(kr, (tiles, bt * bt, 1))]
    else:
        out += [jax.random.randint(kb, (1 << 16,), 0, rcfg.num_bags),
                jax.random.randint(kc, (n, c), 0, rcfg.bag_size),
                jax.random.uniform(kp, (n, c, 2)),
                jax.random.uniform(kr, (n, 1))]
    if temporal:
        out.append(jax.random.uniform(k_t, (n,)))
    for it in range(rcfg.spatial_iterations):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(k_s, it), 3)
        out += [jax.random.uniform(k1, (n, s)), jax.random.uniform(k2, (n, s)),
                jax.random.uniform(k3, (n, 1))]
    if volumes:
        out.append(jax.random.uniform(k_v2, (n,)))
    return [np.asarray(a) for a in out]


def jax_march_draws(key, n_volumes: int, steps: int, n_rays: int):
    """The draws of `lumenrenderer_tpu`'s volume_scatter from `key`: per
    volume v (key fold_in(key, v)) u0 from fold_in 7, then per step i an
    (R,3) light sample from fold_in 100 + i."""
    out = []
    for v in range(n_volumes):
        kv = jax.random.fold_in(key, v)
        out.append(jax.random.uniform(jax.random.fold_in(kv, 7), (n_rays,)))
        out += [jax.random.uniform(jax.random.fold_in(kv, 100 + i),
                                   (n_rays, 3)) for i in range(steps)]
    return out


def jax_transmittance_draws(key, n_volumes: int, estimator: str,
                            n_rays: int, max_events: int = 64):
    """The draws of `lumenrenderer_tpu`'s transmittance_only from `key`:
    Riemann one (R,) for every volume; ratio tracking, per volume v, the
    events' (R,) uniforms from fold_in(fold_in(key, v), i), stacked into
    the (max_events, R) draw the port takes."""
    if estimator == "ratio":
        return [jnp.stack([
            jax.random.uniform(jax.random.fold_in(
                jax.random.fold_in(key, v), i), (n_rays,))
            for i in range(max_events)]) for v in range(n_volumes)]
    return [jax.random.uniform(key, (n_rays,))]


def jax_frame_uniforms(key, cfg, n_rays: int, restir_cfg=None,
                       n_volumes: int = 0):
    """The uniforms `lumenrenderer_tpu`'s render_wavefront draws from `key`,
    in the order the port draws them. With cfg.use_restir, restir_cfg's
    ReSTIR draws (with a history state) replace depth 0's NEE draw. With
    n_volumes volumes, the march's draws (fold_in(dkey, 23)) come first at
    depths below cfg.volume_depths, and NEE's shadow transmittance draws
    (fold_in(nkey, 9)) after NEE's."""
    key_j, key = jax.random.split(key)
    out = []
    if cfg.jitter == "random":
        out.append(jax.random.uniform(key_j, (n_rays, 2)))
    for depth in range(cfg.max_depth):
        dkey = jax.random.fold_in(key, depth)
        if n_volumes and depth < cfg.volume_depths:
            out += jax_march_draws(jax.random.fold_in(dkey, 23), n_volumes,
                                   cfg.volume_steps, n_rays)
        if cfg.alpha_test or cfg.alpha_materials:
            out.append(jax.random.uniform(jax.random.fold_in(dkey, 17),
                                          (n_rays,)))
        if cfg.use_restir and depth == 0:
            out += jax_restir_draws(dkey, restir_cfg, cfg.width, cfg.height,
                                    volumes=n_volumes > 0)
        elif cfg.light_strategy in ("nee", "mis"):
            nkey = jax.random.fold_in(dkey, 1)
            out.append(jax.random.uniform(nkey, (n_rays, 3)))
            if n_volumes:
                out += jax_transmittance_draws(
                    jax.random.fold_in(nkey, 9), n_volumes,
                    cfg.volume_transmittance, n_rays)
        if depth + 1 < cfg.max_depth:
            out.append(jax.random.uniform(jax.random.fold_in(dkey, 2),
                                          (n_rays, 4)))
            if depth >= cfg.rr_start_depth:
                out.append(jax.random.uniform(jax.random.fold_in(dkey, 3),
                                              (n_rays,)))
    return [np.asarray(a) for a in out]
