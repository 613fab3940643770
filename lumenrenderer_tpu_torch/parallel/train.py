"""The differentiable-rendering training step: port of
`lumenrenderer_tpu/parallel/train.py`, on one device (`make_train_step`)
and row-sharded over a device mesh (`make_sharded_train_step`).

Render the scene, compare with a target image, differentiate with respect to
the scene's parameters (materials, emission, environment) and step an
optimizer. JAX's optax transformation becomes a factory that builds a
`torch.optim` optimizer from the parameter dict, e.g.
`lambda ps: torch.optim.Adam(ps.values(), lr=0.5)`, or over some of them
(`[ps["emissive"]]`) as `optax.masked` would; JAX's PRNG key becomes the
frame's `Uniforms` source.

Under a mesh JAX shards the pixel loss and lets GSPMD psum the replicated
parameters' gradients. Here each rank renders its rows (`pixel_ids`), its
loss is the sum of its rows' squared errors over the whole frame's element
count (so the ranks' losses sum to the one-device mean), and the gradients
are all-reduced with SUM before the optimizer steps, so every rank's
parameters stay equal.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.camera import Camera
from ..core.sampling import Uniforms
from ..integrator import wavefront
from ..scene.scene import SceneData
from . import shard

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


def all_reduce_grads(params: Dict[str, torch.Tensor], mesh) -> None:
    """Sum every parameter's gradient over the mesh, in place, as one
    all-reduce of the gradients laid end to end (a missing gradient counts
    as zeros, so every rank sends the same layout)."""
    ps = list(params.values())
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1) for p in ps])
    flat = shard.all_reduce(flat, mesh)
    at = 0
    for p in ps:
        p.grad = flat[at:at + p.numel()].view_as(p).clone()
        at += p.numel()


def make_sharded_train_step(
        scene: SceneData, intersect_fn: Callable, occlude_fn: Callable,
        camera: Camera, cfg: wavefront.RenderConfig,
        optimizer: Callable[[Dict[str, torch.Tensor]], torch.optim.Optimizer],
        mesh):
    """`make_train_step` row-sharded over `mesh` (a `shard.make_mesh`
    DeviceMesh): (init_state, train_step) with the same signatures.

    init_state(params=None) takes rank 0's parameters (broadcast).
    train_step(state, uniforms, frame_idx, target) renders this rank's rows
    with `uniforms` (draws of the rank's n = W * H / world rays), target
    the whole frame (N,3) or the rank's rows (n,3); returns (state with
    step + 1, the whole frame's loss before the step, on every rank)."""
    ids = shard.pixel_ids(cfg.width, cfg.height, mesh,
                          device=scene.env_radiance.device)
    elements = cfg.num_pixels * 3
    init_one, _ = make_train_step(scene, intersect_fn, occlude_fn, camera,
                                  cfg, optimizer)

    def train_step(state: TrainState, uniforms: Uniforms, frame_idx: int,
                   target: torch.Tensor):
        if target.shape[0] == cfg.num_pixels:
            target = target[ids]
        state.opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            out = wavefront.render_wavefront(
                merge_params(scene, state.params), intersect_fn, occlude_fn,
                camera, uniforms, frame_idx, cfg, pixel_ids=ids)
            loss = ((wavefront.merge_channels(out) - target) ** 2
                    ).sum() / elements
            loss.backward()
        all_reduce_grads(state.params, mesh)
        state.opt.step()
        return (TrainState(state.params, state.opt, state.step + 1),
                shard.all_reduce(loss.detach(), mesh))

    def init_state(params: Optional[Dict[str, torch.Tensor]] = None
                   ) -> TrainState:
        if params is None:
            params, _ = split_params(scene)
        return init_one(shard.replicate(dict(params), mesh))

    return init_state, train_step
