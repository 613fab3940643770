"""The differentiable-rendering training step on one device: port of
`lumenrenderer_tpu/parallel/train.py` (its mesh-sharded form is not ported).

Render the scene, compare with a target image, differentiate with respect to
the scene's parameters (materials, emission, environment) and step an
optimizer. JAX's optax transformation becomes a factory that builds a
`torch.optim` optimizer from the parameter dict, e.g.
`lambda ps: torch.optim.Adam(ps.values(), lr=0.5)`, or over some of them
(`[ps["emissive"]]`) as `optax.masked` would; JAX's PRNG key becomes the
frame's `Uniforms` source.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.camera import Camera
from ..core.sampling import Uniforms
from ..integrator import wavefront
from ..scene.scene import SceneData

MATERIAL_PARAMS = ("base_color", "roughness", "metallic", "emissive")


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]   # leaf tensors that require grad
    opt: torch.optim.Optimizer        # steps `params` in place
    step: int


def split_params(scene: SceneData) -> Tuple[Dict[str, torch.Tensor],
                                            SceneData]:
    """The differentiable parameter dict of the scene, and the scene."""
    params = {k: getattr(scene.materials, k) for k in MATERIAL_PARAMS}
    params["env_radiance"] = scene.env_radiance
    return params, scene


def merge_params(scene: SceneData,
                 params: Dict[str, torch.Tensor]) -> SceneData:
    """The scene with its parameters replaced by `params`."""
    return scene.replace(
        materials=scene.materials.replace(
            **{k: params[k] for k in MATERIAL_PARAMS}),
        env_radiance=params["env_radiance"])


def make_train_step(
        scene: SceneData, intersect_fn: Callable, occlude_fn: Callable,
        camera: Camera, cfg: wavefront.RenderConfig,
        optimizer: Callable[[Dict[str, torch.Tensor]], torch.optim.Optimizer]):
    """(init_state, train_step) for inverse rendering against a target
    image (N,3) with the mean squared error.

    init_state(params=None) copies `params` (a dict as `split_params`
    gives; default the scene's own) into leaf tensors and builds the
    optimizer from their dict. train_step(state, uniforms, frame_idx, target)
    renders one frame with `uniforms`, steps the optimizer (the state's
    tensors change in place) and returns (state with step + 1, the loss
    before the step)."""

    def loss_fn(params, uniforms: Uniforms, frame_idx: int, target):
        out = wavefront.render_wavefront(
            merge_params(scene, params), intersect_fn, occlude_fn, camera,
            uniforms, frame_idx, cfg)
        return ((wavefront.merge_channels(out) - target) ** 2).mean()

    def train_step(state: TrainState, uniforms: Uniforms, frame_idx: int,
                   target: torch.Tensor):
        state.opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(state.params, uniforms, frame_idx, target)
            loss.backward()
        state.opt.step()
        return TrainState(state.params, state.opt, state.step + 1), \
            loss.detach()

    def init_state(params: Optional[Dict[str, torch.Tensor]] = None
                   ) -> TrainState:
        if params is None:
            params, _ = split_params(scene)
        dev = scene.env_radiance.device
        leaves = {k: v.detach().to(dev, torch.float32).clone()
                  .requires_grad_(True) for k, v in params.items()}
        return TrainState(leaves, optimizer(leaves), 0)

    return init_state, train_step
