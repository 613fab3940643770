"""Inverse rendering: the program's training step (`parallel.train`'s
`make_train_step`: one frame, the mean squared error against a target
image, backward, the optimizer) repeated, each step waited for.

Set-up renders the target (the running mean of `target_frames` frames at
the scene's own materials), scales each fitted material column by a
factor per material drawn from the seed (U[init_scale]), builds one
training state, and drives it through `checked_steps` steps, whose loss,
first gradient (from Adam's first moment) and parameter change are what
the reference holds. The same state then runs the window. Step i draws
from a generator seeded by (seed, i).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import port, trace
from perfbench.loops import Context, Result, closed_window, sync
from perfbench.reference import check


def run(ctx: Context) -> Result:
    tr, dev = ctx.traffic, ctx.device
    rcfg = ctx.config["renderer"]["render_config"]
    w, h = rcfg["width"], rcfg["height"]
    opt = tr["optimizer"]
    fitted = tr["fit"]
    from lumenrenderer_tpu_torch.parallel import train

    marks = {"scene": time.perf_counter() - ctx.t0}
    r = port.renderer(ctx.spec, ctx.config, dev, ctx.candidate_dtype)
    cam = port.camera(ctx.spec, w, h).to(dev)
    marks["renderer"] = time.perf_counter() - ctx.t0
    target_seed = ctx.sub_seed(1)
    st = r.init_state(target_seed)
    for _ in range(tr["target_frames"]):
        st, _ = r.render_frame(st, cam)
    target = st.accum.clone()
    del st
    marks["target"] = time.perf_counter() - ctx.t0
    rng = np.random.default_rng([ctx.seed, 2])
    lo, hi = tr["init_scale"]
    params, _ = train.split_params(r.scene)
    params = dict(params)
    for k in fitted:
        scale = torch.as_tensor(rng.uniform(lo, hi, params[k].shape[0]),
                                dtype=torch.float32, device=dev)
        params[k] = params[k] * scale[:, None]
    start = {k: params[k].detach().clone() for k in fitted}
    init, step = train.make_train_step(
        r.scene, r._isect, r._occl, cam, r.config,
        lambda ps: torch.optim.Adam([ps[k] for k in fitted], lr=opt["lr"],
                                    betas=tuple(opt["betas"]),
                                    eps=opt["eps"]))
    state = {"ts": init(params), "i": 0, "failed": 0, "losses": []}

    def one():
        i = state["i"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(ctx.sub_seed(4, i))
        state["ts"], loss = step(
            state["ts"],
            lambda *shape: torch.rand(shape, generator=gen, device=dev),
            i, target)
        state["losses"].append(loss)
        state["i"] += 1

    checked = tr["checked_steps"]
    first_grad = None
    for _ in range(checked):
        one()
        marks[f"step{state['i']}"] = time.perf_counter() - ctx.t0
        if first_grad is None:
            ts = state["ts"]
            moments = {k: ts.opt.state.get(ts.params[k], {}).get(
                "exp_avg", torch.zeros_like(ts.params[k])) for k in fitted}
            first_grad = {k: m.detach().clone() / (1.0 - opt["betas"][0])
                          for k, m in moments.items()}
    change = {k: state["ts"].params[k].detach() - start[k] for k in fitted}
    losses = [float(x) for x in state["losses"]]
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    peak0 = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    layers = None
    seconds = ctx.seconds
    if ctx.trace:
        undo = trace.install_ranges()
        traced_wall, events = trace.profile_units(one, tr["traced_steps"])
        undo()
        seconds -= traced_wall
    times, wall = closed_window(one, max(seconds, 0.0), dev)
    steps = state["i"] - checked
    window_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    failed = sum(int(not torch.isfinite(x)) for x in state["losses"][checked:])
    if ctx.trace:
        layers = trace.reduce(events, traced_wall, tr["traced_steps"])
        del events
    del state, r, init, step, params, target
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = check.fit(
        ctx.spec, rcfg, target_seed, tr["target_frames"],
        [ctx.sub_seed(4, i) for i in range(checked)], start, opt,
        {"losses": losses, "grad": first_grad, "change": change},
        tr["check"]["rays_per_block"])
    e2e = {"setup_s": setup_s}
    if not ctx.trace:
        e2e["grad_step_ms"] = wall / len(times) * 1e3
        e2e["peak_mem_gib"] = window_peak / 2 ** 30
    return Result(e2e=e2e, attempted=steps, failed=failed,
                  memory_peak_bytes=int(max(peak0, window_peak)),
                  numbers=numbers, layers=layers,
                  info={"steps": steps, "losses": losses, "setup": marks,
                        "ref_losses": numbers.pop("ref_losses"),
                        "reference_s": time.perf_counter() - t})
