"""Faults planted in the program's timed path, to show that the check
catches them (`perfbench/tests/test_faults.py`) and to read the training
cell's numbers under each (`calibrate.py --fault`):

- "unchanged": a frame or step returns its state as it came (the frame's
  accumulation, the optimizer's update left out);
- "half": half of the batch left out: a frame traces the first half of
  its pixels (the rest stay black), a training step's loss is the mean
  over the first half of the pixels;
- "scale": the answer altered where it is produced: the radiance of a
  frame, or of a training step's frame, times 1.1.

`loop` names the cell's loop ("progressive" or "fit"): the fault goes
into the Renderer's frame or into the training step, and the fitting
loop's target, rendered through the Renderer, stays sound.

A single card has no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib

import torch

KINDS = ("unchanged", "half", "scale")
SCALE = 1.1


@contextlib.contextmanager
def planted(kind: str, loop: str):
    import dataclasses

    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.integrator import wavefront
    from lumenrenderer_tpu_torch.parallel import train
    from lumenrenderer_tpu_torch.render import renderer, tonemap

    saved = [(wavefront, "render_wavefront"), (wavefront, "merge_channels"),
             (train, "make_train_step"), (renderer.Renderer, "_step")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in saved]
    render, merge = wavefront.render_wavefront, wavefront.merge_channels
    make_step, frame_step = train.make_train_step, renderer.Renderer._step
    frame = loop == "progressive"
    if kind == "unchanged" and frame:
        def step_unchanged(self, st, camera):
            return st, frame_step(self, st, camera)[1]
        renderer.Renderer._step = step_unchanged
    elif kind == "unchanged":
        def make_unchanged(*args, **kw):
            init, step = make_step(*args, **kw)

            def init_frozen(params=None):
                ts = init(params)
                ts.opt.step = lambda closure=None: None
                return ts
            return init_frozen, step
        train.make_train_step = make_unchanged
    elif kind == "half" and frame:
        def step_half(self, st, camera):
            n = self.config.num_pixels
            half = torch.arange(n // 2, device=self.device)
            with torch.no_grad():
                out = render(self.scene, self._isect, self._occl, camera,
                             sampling.generator_uniforms(st.generator),
                             st.frame_index, self.config, pixel_ids=half)
                img = torch.zeros_like(st.accum)
                img[:n // 2] = merge(out)
                accum = tonemap.blend_accumulate(st.accum, img,
                                                 st.blend_count)
            return (dataclasses.replace(st, accum=accum,
                                        blend_count=st.blend_count + 1,
                                        frame_index=st.frame_index + 1),
                    {"overflow": out["overflow"]})
        renderer.Renderer._step = step_half
    elif kind == "half":
        def make_half(scene, isect, occl, camera, cfg, optimizer):
            init, _ = make_step(scene, isect, occl, camera, cfg, optimizer)
            half = torch.arange(cfg.num_pixels // 2,
                                device=camera.eye.device)

            def step(state, uniforms, frame_idx, target):
                state.opt.zero_grad(set_to_none=True)
                with torch.enable_grad():
                    out = render(train.merge_params(scene, state.params),
                                 isect, occl, camera, uniforms, frame_idx,
                                 cfg, pixel_ids=half)
                    loss = ((merge(out) - target[half]) ** 2).mean()
                    loss.backward()
                state.opt.step()
                return (train.TrainState(state.params, state.opt,
                                         state.step + 1), loss.detach())
            return init, step
        train.make_train_step = make_half
    elif kind == "scale" and frame:
        wavefront.merge_channels = lambda out: merge(out) * SCALE
    elif kind == "scale":
        def make_scaled(scene, isect, occl, camera, cfg, optimizer):
            init, step = make_step(scene, isect, occl, camera, cfg, optimizer)

            def scaled(*args, **kw):
                wavefront.merge_channels = lambda out: merge(out) * SCALE
                try:
                    return step(*args, **kw)
                finally:
                    wavefront.merge_channels = merge
            return init, scaled
        train.make_train_step = make_scaled
    else:
        raise ValueError(f"unknown fault {kind!r}; one of {KINDS}")
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)
