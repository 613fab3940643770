"""A ReSTIR DI viewport under a camera that stands still: 1-spp frames
through `Renderer.render_frame` with `use_restir`, accumulated into the
running mean, each waited for, the next started when the last has
finished; the reservoir history rides the frame state from frame to frame.

ReSTIR couples pixels (a tile's shared candidates, spatial reuse across
`spatial_radius` pixels, each pixel's history), so the check replays whole
frames: the accumulated image is copied once, after `check.frames` frames
(the warm frames and the window's first), inside the window, with those
frames' primary-hit distances (the `depth` AOV), and the reference
(`reference/restir.py`) computes those frames whole, holds the primary
hits to the program's contract and compares every pixel. The window's
later frames are not replayed.

The configuration states every `RestirConfig` field under `"restir"`; the
Renderer is built with its defaults, and the loop refuses to run if they
differ from the file's.

Traffic parameters: warm_frames (rendered in set-up), traced_frames (the
traced run profiles the window's first ones), check {"frames": the frames
the snapshot holds, "rays_per_block": the reference's block of rays}.
"""
from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from perfbench import port, trace
from perfbench.loops import Context, Result, closed_window, sync
from perfbench.reference import restir as reference


def run(ctx: Context) -> Result:
    tr, dev = ctx.traffic, ctx.device
    rcfg = ctx.config["renderer"]["render_config"]
    stated = ctx.config["restir"]
    w, h = rcfg["width"], rcfg["height"]
    marks = {"scene": time.perf_counter() - ctx.t0}
    r = port.renderer(ctx.spec, ctx.config, dev, ctx.candidate_dtype)
    held = dataclasses.asdict(r._restir_fn.cfg)
    if held != stated:
        raise ValueError(f"the Renderer's ReSTIR config {held} is not the "
                         f"configuration's {stated}")
    cam = port.camera(ctx.spec, w, h).to(dev)
    marks["renderer"] = time.perf_counter() - ctx.t0
    checked = tr["check"]["frames"]
    state = {"st": r.init_state(ctx.seed), "frames": 0, "failed": 0,
             "snapshot": None, "depths": []}

    def frame():
        state["st"], aux = r.render_frame(state["st"], cam)
        state["frames"] += 1
        state["failed"] += int(r.frame_stats["overflow"])
        if state["frames"] <= checked:
            state["depths"].append(aux["depth"].clone())
        if state["frames"] == checked:
            state["snapshot"] = state["st"].accum.clone()

    for i in range(tr["warm_frames"]):
        frame()
        sync(dev)
        marks[f"frame{i}"] = time.perf_counter() - ctx.t0
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    warm = state["frames"]
    state["failed"] = 0
    setup_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    layers = None
    seconds = ctx.seconds
    if ctx.trace:
        undo = trace.install_ranges()
        traced_wall, events = trace.profile_units(frame, tr["traced_frames"])
        undo()
        seconds -= traced_wall
    times, wall = closed_window(frame, max(seconds, 0.0), dev)
    frames = state["frames"] - warm
    window_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    while state["snapshot"] is None:
        frame()         # a window too short to reach the snapshot
    if ctx.trace:
        layers = trace.reduce(events, traced_wall, tr["traced_frames"])
        del events
    final, snapshot = state["st"].accum, state["snapshot"]
    del state["st"], r
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = reference.compare(ctx.spec, rcfg, stated, ctx.seed, snapshot,
                                state["depths"], final,
                                tr["check"]["rays_per_block"])
    e2e = {"setup_s": setup_s}
    if not ctx.trace:
        e2e["frame_ms"] = wall / len(times) * 1e3
        e2e["frame_ms_p90"] = statistics.quantiles(times, n=10)[8] * 1e3 \
            if len(times) > 1 else times[0] * 1e3
        e2e["peak_mem_gib"] = window_peak / 2 ** 30
    return Result(e2e=e2e, attempted=frames, failed=state["failed"],
                  memory_peak_bytes=int(max(setup_peak, window_peak)),
                  numbers=numbers, layers=layers,
                  info={"setup": marks, "frames": state["frames"],
                        "window_frames": frames,
                        "reference_s": time.perf_counter() - t})
