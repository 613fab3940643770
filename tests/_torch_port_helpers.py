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


class ListUniforms:
    """A `Uniforms` source that returns given arrays in order, checking that
    each draw has the shape the JAX frame drew."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def __call__(self, *shape):
        a = self.arrays.pop(0)
        assert a.shape == shape, (a.shape, shape)
        return torch.from_numpy(np.array(a, np.float32))


def jax_frame_uniforms(key, cfg, n_rays: int):
    """The uniforms `lumenrenderer_tpu`'s render_wavefront draws from `key`,
    in the order the port draws them."""
    key_j, key = jax.random.split(key)
    out = []
    if cfg.jitter == "random":
        out.append(jax.random.uniform(key_j, (n_rays, 2)))
    for depth in range(cfg.max_depth):
        dkey = jax.random.fold_in(key, depth)
        if cfg.alpha_test or cfg.alpha_materials:
            out.append(jax.random.uniform(jax.random.fold_in(dkey, 17),
                                          (n_rays,)))
        if cfg.light_strategy in ("nee", "mis"):
            out.append(jax.random.uniform(jax.random.fold_in(dkey, 1),
                                          (n_rays, 3)))
        if depth + 1 < cfg.max_depth:
            out.append(jax.random.uniform(jax.random.fold_in(dkey, 2),
                                          (n_rays, 4)))
            if depth >= cfg.rr_start_depth:
                out.append(jax.random.uniform(jax.random.fold_in(dkey, 3),
                                              (n_rays,)))
    return [np.asarray(a) for a in out]
