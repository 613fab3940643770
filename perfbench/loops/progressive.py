"""A viewport under a camera that stands still: 1-spp frames through
`Renderer.render_frame`, accumulated into the running mean, each waited
for, the next started when the last has finished.

Traffic parameters: warm_frames (rendered in set-up), traced_frames (the
traced run profiles the window's first ones), check {"pixels": pixels of
the accumulated image held against the reference, "rays_per_block"}.
"""
from __future__ import annotations

import statistics
import time

import torch

from perfbench import port, roofline, trace
from perfbench.loops import Context, Result, closed_window, sync
from perfbench.reference import check


def run(ctx: Context) -> Result:
    tr, dev = ctx.traffic, ctx.device
    rcfg = ctx.config["renderer"]["render_config"]
    w, h = rcfg["width"], rcfg["height"]
    marks = {"scene": time.perf_counter() - ctx.t0}
    r = port.renderer(ctx.spec, ctx.config, dev, ctx.candidate_dtype)
    cam = port.camera(ctx.spec, w, h).to(dev)
    marks["renderer"] = time.perf_counter() - ctx.t0
    state = {"st": r.init_state(ctx.seed), "frames": 0, "failed": 0}

    def frame():
        state["st"], _ = r.render_frame(state["st"], cam)
        state["frames"] += 1
        state["failed"] += int(r.frame_stats["overflow"])

    for i in range(tr["warm_frames"]):
        frame()
        sync(dev)
        marks[f"frame{i}"] = time.perf_counter() - ctx.t0
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    warm = state["frames"]
    state["failed"] = 0
    layers = None
    seconds = ctx.seconds
    if ctx.trace:
        undo = trace.install_ranges()
        traced_wall, events = trace.profile_units(frame, tr["traced_frames"])
        undo()
        seconds -= traced_wall
    times, wall = closed_window(frame, max(seconds, 0.0), dev)
    frames = state["frames"] - warm
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if ctx.trace:
        layers = trace.reduce(events, traced_wall, tr["traced_frames"])
        del events
        if dev.type == "cuda":
            layers["k1"] = k1_passes(r, cam, ctx.sub_seed(3))
    accum = state["st"].accum
    del state["st"], r
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    pixels = check.sample_pixels(ctx.seed, w * h, tr["check"]["pixels"])
    numbers = check.progressive(ctx.spec, rcfg, ctx.seed, state["frames"],
                                accum, pixels, tr["check"]["rays_per_block"])
    e2e = {"setup_s": setup_s}
    if not ctx.trace:
        e2e["frame_ms"] = wall / len(times) * 1e3
        e2e["frame_ms_p90"] = statistics.quantiles(times, n=10)[8] * 1e3 \
            if len(times) > 1 else times[0] * 1e3
    return Result(e2e=e2e, attempted=frames, failed=state["failed"],
                  memory_peak_bytes=int(peak), numbers=numbers,
                  layers=layers,
                  info={"setup": marks, "frames": state["frames"],
                        "window_frames": frames,
                        "reference_s": time.perf_counter() - t})


def k1_passes(r, cam, seed: int):
    """K1 on this cell's primary, sorted bounce and sorted shadow passes
    (captured from one more frame from a fresh state), each timed with CUDA
    events: {"flop", "bytes", "bound_s", "time_s", "visits_checked"}, or
    None where the visit counter disagrees with the replay of its vote on
    the tiles checked."""
    from lumenrenderer_tpu_torch.accel import tiled
    from lumenrenderer_tpu_torch.integrator import wavefront
    from lumenrenderer_tpu_torch.ops import visit_scan as vs

    dev = r.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def uniforms(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def render(isect, occl):
        with torch.no_grad():
            wavefront.render_wavefront(r.scene, isect, occl, cam, uniforms,
                                       0, r.config)

    passes = trace.capture_passes(render, r._isect, r._occl)
    total = {"flop": 0.0, "bytes": 0.0, "bound_s": 0.0, "time_s": 0.0,
             "visits_checked": 0}
    for name, ((o, d, tn, tx), closest) in passes.items():
        q = tiled.scan_inputs(r.clusters, o, d, tn, tx, r.max_visits,
                              r.culling)
        args, kw = q["args"], dict(q["kw"], closest=closest)
        visits = torch.empty(args[0].shape[0], dtype=torch.int32, device=dev)

        def call():
            vs.visit_scan(*args, **kw, layout=q["layout"], visits=visits)

        call()
        reps = 5
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        torch.cuda.synchronize()
        t = start.elapsed_time(end) / reps * 1e-3
        rf_t, feats, sel, nv, tnb = args
        g = torch.Generator().manual_seed(seed)
        sub = torch.randperm(rf_t.shape[0], generator=g)[:32].to(dev)
        replay = roofline.replay_visits(rf_t[sub], feats, sel[sub], nv[sub],
                                        tnb[sub], **kw)
        if not torch.equal(replay, visits[sub]):
            return None
        flop = roofline.visit_flop(rf_t, feats, sel, visits, kw["k"])
        nb = roofline.visit_bytes(rf_t, feats, sel, nv, tnb)
        total["flop"] += flop
        total["bytes"] += nb
        total["bound_s"] += roofline.bound_s(flop, nb)[0]
        total["time_s"] += t
        total["visits_checked"] += int(sub.numel())
    return total
