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

import contextlib
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.camera import Camera
from ..core.sampling import Uniforms
from ..integrator import wavefront
from ..scene.scene import SceneData
from ..utils import profiling
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


class _PlanChanged(RuntimeError):
    """The frame asked its uniform source for other draws than the plan
    recorded on the last eager step."""


class _Recording:
    """A uniform source that passes each call on to `uniforms` and records
    the frame's draw plan: the shape each call asks for, and the dtype and
    device of what came back."""

    def __init__(self, uniforms: Uniforms):
        self.uniforms = uniforms
        self.plan = []

    def __call__(self, *shape):
        u = self.uniforms(*shape)
        self.plan.append((shape, u.dtype, u.device))
        return u


class _Planned:
    """The uniform source of the captured frame: the plan's buffers, in
    order; a call the plan does not hold raises `_PlanChanged`."""

    def __init__(self, plan, bufs):
        self.plan, self.bufs, self.pos = plan, bufs, 0

    def __call__(self, *shape):
        if self.pos == len(self.plan) or self.plan[self.pos][0] != shape:
            raise _PlanChanged(f"draw {self.pos} asked for {shape}")
        self.pos += 1
        return self.bufs[self.pos - 1]


class _Handed:
    """A uniform source that hands out `drawn`, draws already taken from
    `uniforms` for the frame's first calls, in order, and passes the later
    calls on to `uniforms`."""

    def __init__(self, drawn, uniforms: Uniforms):
        self.drawn, self.uniforms = list(drawn), uniforms

    def __call__(self, *shape):
        return self.drawn.pop(0) if self.drawn else self.uniforms(*shape)


class _StepGraph:
    """The frame under grad, its loss and backward for one set of leaves,
    one target shape and one draw plan, captured once and replayed: a CUDA
    graph on a CUDA device; on the CPU the same calls made directly at
    each replay. Its inputs are static buffers, filled before each replay:
    the plan's draws, the frame index and the target."""

    def __init__(self, body: Callable, params: Dict[str, torch.Tensor],
                 target: torch.Tensor, plan):
        self.body, self.params, self.plan = body, dict(params), plan
        # 0.5 is a draw like any other: the capture's run on the CPU, made
        # before a step's draws are in, reads it
        self.bufs = [torch.full(s, 0.5, dtype=t, device=d)
                     for s, t, d in plan]
        self.target = torch.empty(target.shape, dtype=target.dtype,
                                  device=target.device)
        self.frame = torch.zeros((), dtype=torch.int64, device=target.device)
        self.captured = False
        self.graph = self.loss = None
        self.grads = []

    def fits(self, params: Dict[str, torch.Tensor],
             target: torch.Tensor) -> bool:
        """Whether the step holds these leaves and a target of this shape,
        dtype and device."""
        return (params.keys() == self.params.keys()
                and all(params[k] is v for k, v in self.params.items())
                and (target.shape, target.dtype, target.device)
                == (self.target.shape, self.target.dtype, self.target.device))

    def capture(self, opt: torch.optim.Optimizer) -> None:
        """Record the step before any of its inputs are filled in: as a
        CUDA graph on a CUDA device, whose kernels run only at replay; on
        the CPU as a direct call whose numbers are dropped. Raises
        `_PlanChanged` where the frame asks for other draws than the plan,
        and on a CUDA device whatever else fails the capture, a host wait
        above all. The optimizer's gradients are set to None first (as the
        eager step does), so the backward writes them anew into the graph's
        memory at each replay."""
        opt.zero_grad(set_to_none=True)
        if self.target.device.type != "cuda":
            self._run()
        else:
            self.graph = torch.cuda.CUDAGraph()
            stream = torch.cuda.current_stream()
            try:
                with profiling.paused(), torch.cuda.graph(self.graph):
                    self.loss = self._run()
            finally:
                # a capture that fails leaves its own stream current
                torch.cuda.set_stream(stream)
            self.grads = [(p, p.grad) for p in self.params.values()
                          if p.grad is not None]
        self.captured = True

    def fill(self, uniforms: Uniforms, frame_idx: int,
             target: torch.Tensor):
        """Copy the next step's inputs in: a draw from `uniforms` for each
        of the plan's, in order, the frame index and the target. Returns
        None; or, where the source gave a draw of another shape, dtype or
        device than the plan's, the draws taken so far, that one last."""
        for i, ((shape, dtype, device), buf) in enumerate(
                zip(self.plan, self.bufs)):
            u = uniforms(*shape)
            if (tuple(u.shape), u.dtype, u.device) != (shape, dtype, device):
                return self.bufs[:i] + [u]
            buf.copy_(u)
        self.frame.fill_(frame_idx)
        self.target.copy_(target)
        return None

    def _run(self) -> torch.Tensor:
        src = _Planned(self.plan, self.bufs)
        loss = self.body(self.params, src, self.frame, self.target)
        if src.pos != len(self.plan):
            raise _PlanChanged(f"the frame drew {src.pos} of the plan's "
                               f"{len(self.plan)}")
        loss.backward()
        return loss

    def replay(self, opt: torch.optim.Optimizer) -> torch.Tensor:
        """Run the step on the buffers' contents; the leaves' gradients are
        then the graph's. Returns a copy of the loss."""
        if self.graph is None:
            opt.zero_grad(set_to_none=True)
            self.loss = self._run()
        else:
            self.graph.replay()
            for p, g in self.grads:
                p.grad = g
        profiling.count_graph_replay()
        return self.loss.detach().clone()


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
    before the step).

    The first step runs eagerly and records the frame's draw plan: the
    shapes it asks `uniforms` for, in order (the configuration fixes
    them), and the dtype and device of each draw. The second captures the
    frame, its loss and backward as a CUDA graph (on the CPU: the same
    calls, made directly), before it draws anything; then it and every
    later step draw the plan's shapes from `uniforms` in order, copy them,
    the frame index and the target into the graph's buffers, replay, and
    step the optimizer eagerly. So a replay computes what the eager step
    would from the same source. The step runs eagerly, records the plan
    again and captures anew at the next step where the leaves or the
    target's shape are not the last eager step's, where the capture finds
    the frame asking for other draws than the plan (before any is taken),
    or where the source gives a draw of another shape, dtype or device
    than the plan's (the eager frame then gets the draws already taken).
    Where a capture fails for any other reason, a host wait inside the
    frame above all, every step runs eagerly from then on. After the
    capture the frame's code runs no more on a CUDA device, so a change to
    it is not seen there; on the CPU it runs at each replay, and a frame
    that leaves the plan raises. On a CUDA device the eager steps run on a
    side stream, as a capture asks of the work before it."""

    def loss_fn(params, uniforms: Uniforms, frame_idx, target):
        out = wavefront.render_wavefront(
            merge_params(scene, params), intersect_fn, occlude_fn, camera,
            uniforms, frame_idx, cfg)
        return ((wavefront.merge_channels(out) - target) ** 2).mean()

    graph = None            # the step of the last eager step's inputs
    capturable = True       # no capture has failed but for the plan
    side = (torch.cuda.Stream(camera.eye.device)
            if camera.eye.device.type == "cuda" else None)

    def eager(state: TrainState, uniforms, frame_idx, target):
        nonlocal graph
        rec = _Recording(uniforms)
        if side is not None:
            side.wait_stream(torch.cuda.current_stream())
        with (torch.cuda.stream(side) if side is not None
              else contextlib.nullcontext()):
            with profiling.span("train.optimizer"):
                state.opt.zero_grad(set_to_none=True)
            with torch.enable_grad():
                with profiling.span("train.forward"):
                    loss = loss_fn(state.params, rec, frame_idx, target)
                with profiling.span("train.backward"):
                    loss.backward()
        if side is not None:
            torch.cuda.current_stream().wait_stream(side)
        if capturable:
            graph = _StepGraph(loss_fn, state.params, target, rec.plan)
        return loss.detach()

    def replayed(state: TrainState, uniforms, frame_idx, target):
        """(the loss of the step by replay, or None where it runs eagerly;
        the source the eager step draws from)."""
        nonlocal graph, capturable
        g = graph
        if g is None or not g.fits(state.params, target):
            return None, uniforms
        with torch.enable_grad():
            if not g.captured:
                try:
                    g.capture(state.opt)
                except _PlanChanged:
                    graph = None
                    return None, uniforms
                except Exception:
                    graph, capturable = None, False
                    return None, uniforms
            with profiling.span("train.replay"):
                drawn = g.fill(uniforms, frame_idx, target)
                if drawn is not None:
                    graph = None
                    return None, _Handed(drawn, uniforms)
                return g.replay(state.opt), uniforms

    def train_step(state: TrainState, uniforms: Uniforms, frame_idx: int,
                   target: torch.Tensor):
        with profiling.unit("train.step"):
            loss, uniforms = replayed(state, uniforms, frame_idx, target)
            if loss is None:
                loss = eager(state, uniforms, frame_idx, target)
            with profiling.span("train.optimizer"):
                state.opt.step()
        return TrainState(state.params, state.opt, state.step + 1), loss

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
