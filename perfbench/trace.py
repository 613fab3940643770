"""The traced run's instruments: layer ranges around the program's
intersector calls, a `torch.profiler` capture of a few frames or steps, and
the reduction of its device events to per-layer times and the breakdown.

Ranges are `torch.profiler.record_function` ranges, with no sync, installed
only in a traced run by replacing two module attributes of the program:
`integrator.wavefront.render_wavefront` (its intersector and occluder
arguments are wrapped) and `accel.sorting.sorted_intersectors` (the sorted
callables it returns are wrapped). Both the Renderer and the training step
reach the frame through the module, so the replacement sees every call.
Each device operation goes to the innermost range open on the launching
thread when it was launched; the autograd engine's own ranges mark the
backward.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

ACCEL = "perfbench.accel"
BACKWARD = "autograd::engine::evaluate_function"
K1_KERNEL = "visit_scan_kernel"


def install_ranges() -> Callable[[], None]:
    """Wrap the program's intersectors in ACCEL ranges; returns the undo."""
    from torch.profiler import record_function

    from lumenrenderer_tpu_torch.accel import sorting
    from lumenrenderer_tpu_torch.integrator import wavefront

    render, sort = wavefront.render_wavefront, sorting.sorted_intersectors

    def ranged(fn):
        def call(*args, **kw):
            with record_function(ACCEL):
                return fn(*args, **kw)
        return call

    def render_ranged(scene, isect, occl, *args, **kw):
        return render(scene, ranged(isect), ranged(occl), *args, **kw)

    def sort_ranged(isect, occl, *args, **kw):
        s_isect, s_occl = sort(isect, occl, *args, **kw)
        return ranged(s_isect), ranged(s_occl)

    wavefront.render_wavefront = render_ranged
    sorting.sorted_intersectors = sort_ranged

    def undo():
        wavefront.render_wavefront = render
        sorting.sorted_intersectors = sort

    return undo


def profile(fn: Callable[[], None]):
    """fn() under torch.profiler (CPU and CUDA activity): (wall seconds
    from a synchronised start to a synchronised end, the events)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with prof_ctx(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    return wall, list(prof.events())


def _is_device(e) -> bool:
    return e.device_type != torch.autograd.DeviceType.CPU


def _union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _timelines(events):
    """Per thread, the innermost host event open at each time, as a step
    function: {thread: (times, values)}, values[i] = (start, name) of the
    innermost event open from times[i] on, or None. Events of one thread
    nest."""
    by_thread = defaultdict(list)
    for e in events:
        by_thread[e.thread].append((e.time_range.start, e.time_range.end,
                                    e.name))
    out = {}
    for th, evs in by_thread.items():
        evs.sort(key=lambda x: (x[0], -x[1]))
        times, values, stack = [], [], []

        def mark(t):
            top = stack[-1] if stack else None
            times.append(t)
            values.append(None if top is None else (top[0], top[2]))

        for ev in evs:
            while stack and stack[-1][1] < ev[0]:
                mark(stack.pop()[1])
            stack.append(ev)
            mark(ev[0])
        while stack:
            mark(stack.pop()[1])
        out[th] = (times, values)
    return out


def _at(timelines, thread, t):
    """(start, name) of the innermost event open on `thread` at time t, or
    None."""
    times, values = timelines.get(thread, ((), ()))
    i = bisect.bisect_right(times, t) - 1
    return values[i] if i >= 0 else None


def reduce(events: List, wall_s: float, units: int) -> Dict:
    """Per-layer device times and counts of a profiled stretch of `units`
    frames or steps: {"units", "wall_s", "busy_s", "launches", "ms":
    {"accel", "k1", "integrator", "backward", "forward"} (device ms per
    unit), "attributed": the share of device time the profiler linked to
    the host operation that launched it, "breakdown": {"device_ops",
    "idle_gaps"}}. A host operation's kernels are those the profiler lists
    under it (`FunctionEvent.kernels`); its layer is the innermost range
    open on its thread when it began."""
    # a range also shows on the device's timeline as an annotation that
    # spans its kernels: it is no device operation
    dev = [e for e in events if _is_device(e) and e.name != ACCEL
           and not e.name.startswith(BACKWARD)
           and not getattr(e, "is_user_annotation", False)]
    cpu = [e for e in events if not _is_device(e) and not e.is_async]
    ranges = _timelines(e for e in cpu if e.name == ACCEL)
    backward = _timelines(e for e in cpu if e.name.startswith(BACKWARD))
    ms = defaultdict(float)
    by_name = defaultdict(float)
    total_us = 0.0
    for k in dev:
        us = k.time_range.end - k.time_range.start
        total_us += us
        by_name[k.name] += us
        if K1_KERNEL in k.name:
            ms["k1"] += us
    # K1 is launched through ctypes, under no operation: it is named, and
    # belongs to the accel ranges and to the forward frame
    found_us = ms["k1"]
    for op in cpu:
        if not op.kernels:
            continue
        t, th = op.time_range.start, op.thread
        in_accel = op.name == ACCEL or _at(ranges, th, t) is not None
        in_backward = (op.name.startswith(BACKWARD)
                       or _at(backward, th, t) is not None)
        for k in op.kernels:
            if K1_KERNEL in k.name:
                continue
            found_us += k.duration
            ms["accel" if in_accel else "integrator"] += k.duration
            if in_backward:
                ms["backward"] += k.duration
    ms["forward"] = total_us - ms["backward"]
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in dev)
    # idle gaps between device operations, named by the innermost host
    # operation running at the gap's middle (the latest begun, any thread)
    ops = _timelines(e for e in cpu if not e.name.startswith("ProfilerStep"))
    gaps = defaultdict(float)
    end = None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if end is not None and a > end:
            mid = 0.5 * (a + end)
            open_ops = [v for v in (_at(ops, th, mid) for th in ops) if v]
            gaps[max(open_ops)[1] if open_ops else "idle"] += (a - end) * 1e-6
        end = b if end is None else max(end, b)
    top = lambda d, n: [[k, v] for k, v in
                        sorted(d.items(), key=lambda kv: -kv[1])[:n]]
    return {
        "units": units, "wall_s": wall_s, "busy_s": busy_us * 1e-6,
        "launches": len(dev),
        "ms": {k: v * 1e-3 / units for k, v in ms.items()},
        "attributed": found_us / total_us if total_us else 0.0,
        "breakdown": {"device_ops": top({k: v * 1e-6
                                         for k, v in by_name.items()}, 10),
                      "idle_gaps": top(gaps, 10)},
    }


def profile_units(step: Callable[[], None], units: int):
    """`units` calls of step() under the profiler: (wall seconds, events);
    `reduce` them once the window has closed."""
    def run():
        for _ in range(units):
            step()
    return profile(run)


def capture_passes(render: Callable, isect, occl) -> Dict:
    """The inputs (o, d, t_min, t_max) of one frame's primary pass (the
    first closest query), sorted bounce pass (the second) and sorted shadow
    pass (the first occlusion query): render(isect', occl') runs the frame
    with recording intersectors."""
    calls: Dict[str, list] = {"closest": [], "any": []}

    def rec(kind, fn):
        def call(o, d, tn, tx):
            calls[kind].append((o.clone(), d.clone(), tn,
                                tx.clone() if torch.is_tensor(tx) else tx))
            return fn(o, d, tn, tx)
        return call

    render(rec("closest", isect), rec("any", occl))
    out: Dict[str, Optional[tuple]] = {}
    for name, kind, i in (("primary", "closest", 0), ("bounce", "closest", 1),
                          ("shadow", "any", 0)):
        if len(calls[kind]) > i:
            out[name] = (calls[kind][i], kind == "closest")
    return out
