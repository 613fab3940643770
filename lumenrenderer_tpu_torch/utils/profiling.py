"""Frame statistics, profiling and the program's spans: port of
`lumenrenderer_tpu/utils/profiling.py`, with spans and counters of its own.

`Timer` is a stopwatch, `FrameStats` one frame's named stage times,
`Profiler` a rolling window of them. A stage that names a CUDA tensor
(`block_on`) synchronises its device before the clock stops: PyTorch
returns before the card finishes. `device_trace` records a
`torch.profiler` trace and writes it as a Chrome trace.

Spans. `span(name, **attrs)` marks a stage of the program and `unit(name)`
a unit of work (a frame, a training step) that its spans belong to. They
record only while someone records: while a `torch.profiler` session runs
(`device_trace`, the benchmark's traced run), and inside a `recording()`
block. Otherwise each returns one shared no-op object after a check of the
recording flags. A recorded span keeps its name and attributes, its
parent span on the same thread, its unit, its thread, its phase
("backward" when opened while autograd runs a backward pass, as remat's
recompute is, else "forward"), its host start and end
(`time.perf_counter_ns`) and, where CUDA is in use, a pair of CUDA events
on the current stream; it also opens a `torch.profiler.record_function`
range of its name, so a profiler trace shows the stage on the device
activity's clock. Spans nest strictly (`with` blocks).

Counters, taken while recording and charged to the innermost open span
of the calling thread (the open unit where the thread has none):
`host_syncs`, each time the host waits for the device (inside a unit,
PyTorch's sync debug mode reports the implicit waits: a CUDA tensor read
on the host, `.cpu()`, `bool()`, a copy from pageable host memory; the
program's own waits go through `synchronize`, which also times them as
`host_wait_ms`); `device_allocs`, the caching allocator's device
allocations and retries over each unit (`device_memory_stats`); K1's
visits run and listed (`count_visits`); the row scatter-add's entries
scattered and global row updates issued (`count_row_scatter`, the backward
of `ops/row_gather.py`); and ReSTIR's visibility rays sent and live
(`count_restir_rays`, `restir/di.py`). The last two are device tensors,
kept until `span_table()` resolves them. `graph_replays`, the replays of
a captured training step (`count_graph_replay`, `parallel/train.py`), is
charged to the open unit. `bsdf_rays` and `bsdf_fused_rays`, the rays of
each call of the Disney BSDF's `sample` or `evaluate` and those of the
calls kernel D ran (`count_bsdf`, `bsdf/disney.py`), are host counts read
from the shape. Inside a `paused()` block nothing records: a
CUDA graph's capture holds no span's events and no counter's tensors.
The outermost open unit switches sync debug mode to warn and counts its
warnings; a mode the caller set to warn still warns, and one set to
raise is left alone (and not counted).

`span_table()` synchronises once, resolves what was recorded and returns
each span name's calls, host and device ms (inclusive and self: less what
its child spans cover), counters, and the units recorded;
`span_table(unit)` takes one closed unit's spans into those totals and
returns that unit's table alone; `per_unit(field, match)` is a field of
the totals a unit; `reset()` forgets it all. Recording launches no
kernel: the events and the counter tensors are kept until `span_table()`
resolves them, except that past `HELD_UNITS` units held (a profiler
session whose spans nobody reads) a unit's close resolves the oldest,
and past `HELD_LOOSE_SPANS` spans outside units a span's close resolves
them.
A span's device ms is the CUDA events' window on the device clock, from
its start to its end, idle time inside included; its host ms holds the
host's waits inside it.

    with profiling.recording():
        for _ in range(8):
            st, aux = renderer.render_frame(st, cam)
            print(renderer.frame_stats["spans"])   # this frame's table
    print(profiling.span_table())                   # all eight frames

The CLI's `--spans` records every frame and prints each span's mean self
device and host ms through `Profiler.summary()`.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from collections import deque
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


class Timer:
    """Stopwatch on the host clock."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    def measure_s(self) -> float:
        return time.perf_counter() - self._t0

    def measure_ms(self) -> float:
        return self.measure_s() * 1e3


def block_until_ready(x) -> None:
    """Wait for the devices of the CUDA tensors in x (a tensor, or a list,
    tuple or dict of them)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            block_until_ready(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            block_until_ready(v)


class FrameStats:
    """Named stage times (ms) of one frame."""

    def __init__(self, frame_id: int = 0):
        self.frame_id = frame_id
        self.times_ms: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t = Timer()
        yield
        if block_on is not None:
            block_until_ready(block_on)
        self.times_ms[name] = self.times_ms.get(name, 0.0) + t.measure_ms()

    def add_spans(self, table: Dict) -> None:
        """Each span's self host ms, and self device ms where CUDA events
        timed it, from a `span_table()`, as stages "<span> self host" and
        "<span> self device"."""
        for key, row in table["spans"].items():
            self.times_ms[f"{key} self host"] = row["host_self_ms"]
            if row["device_self_ms"] is not None:
                self.times_ms[f"{key} self device"] = row["device_self_ms"]


class Profiler:
    """Rolling per-stage history of the last `window` frames."""

    def __init__(self, window: int = 1024):
        self.window = window
        self.history: deque = deque(maxlen=window)

    def add(self, stats: FrameStats):
        self.history.append(stats)

    def mean_ms(self, stage: str) -> float:
        vals = [s.times_ms[stage] for s in self.history if stage in s.times_ms]
        return sum(vals) / len(vals) if vals else 0.0

    def summary(self) -> Dict[str, float]:
        stages = {k for s in self.history for k in s.times_ms}
        return {k: self.mean_ms(k) for k in sorted(stages)}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record the enclosed work with `torch.profiler` (host and, where there
    is one, CUDA activity) and write `log_dir/trace.json`, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats(device: Optional[object] = None) -> Dict[str, int]:
    """`torch.cuda.memory_stats` of a CUDA device (default: the current
    one); {} without CUDA or for a CPU device."""
    if not torch.cuda.is_available():
        return {}
    d = torch.device("cuda") if device is None else torch.device(device)
    if d.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(d))


# -- spans and counters -------------------------------------------------------

# the start of the warning PyTorch's sync debug mode gives for each wait,
# and of its notice that the mode does not see every wait (distributed
# and sparse operations), said once a process
SYNC_WARNING = "called a synchronizing CUDA operation"
SYNC_PROTOTYPE = "Synchronization debug mode is a prototype feature"
# closed units whose CUDA events and visit tensors are held unresolved; past
# this many (a profiler session whose spans nobody reads) the oldest are
# resolved into the totals at a unit's close, which waits for the device
HELD_UNITS = 64
HELD_LOOSE_SPANS = 4096     # the same for spans outside any unit

_recording_blocks = 0       # open recording() blocks
_paused_blocks = 0          # open paused() blocks


class _Off:
    """The span handed out while nothing records: it records nothing."""

    unit = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Log:
    """What was recorded since the last `reset()`: the closed spans not yet
    taken into the totals, by unit id (None: outside any unit), and the
    totals by span key."""

    def __init__(self):
        self.held: Dict[Optional[int], List["_Span"]] = {}
        self.rows: Dict[str, Dict] = {}
        self.units_taken = 0
        self.units = 0                      # unit ids handed out
        self.open_unit: Optional["_Span"] = None
        self.local = threading.local()      # .stack: the thread's open spans

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def innermost(self) -> Optional["_Span"]:
        """The innermost open span of the calling thread, else the open
        unit, else None."""
        st = self.stack()
        return st[-1] if st else self.open_unit


_LOG = _Log()


def _device_allocs() -> Optional[int]:
    """The caching allocator's device allocations and retries so far (None
    without CUDA in use)."""
    st = device_memory_stats()
    if not st:
        return None
    return st.get("num_device_alloc", 0) + st.get("num_alloc_retries", 0)


def _sync_hook(show, pass_on: bool):
    """A `warnings.showwarning` that counts sync debug mode's warnings as
    host syncs, passes them on to `show` too where `pass_on` (the mode was
    already set to warn), and passes every other warning to `show`."""

    def hook(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_WARNING):
            s = _LOG.innermost()
            if s is not None:
                s.counts["host_syncs"] += 1
            if not pass_on:
                return
        show(message, category, filename, lineno, file, line)

    return hook


class _Span:
    """One recorded span (module docstring)."""

    def __init__(self, name: str, attrs: Dict, is_unit: bool):
        self.name, self.attrs, self.is_unit = name, attrs, is_unit
        self.counts = {"host_syncs": 0, "host_wait_ms": 0.0,
                       "device_allocs": None, "graph_replays": 0,
                       "bsdf_rays": 0, "bsdf_fused_rays": 0}
        self.visits: List = []              # K1 launches' (visits, nv)
        self.device_counts: List = []       # (fields, (len(fields),) tensor)
        self.events = None
        self.child_host_ms = self.child_device_ms = 0.0

    def __enter__(self):
        stack = _LOG.stack()
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_ident()
        self.phase = ("backward" if torch._C._current_graph_task_id() != -1
                      else "forward")
        cuda = torch.cuda.is_initialized()
        if self.is_unit:
            _LOG.units += 1
            self.unit = _LOG.units
            self._outer_unit, _LOG.open_unit = _LOG.open_unit, self
            self._allocs0 = _device_allocs()
            self._watch = None
            mode = torch.cuda.get_sync_debug_mode() if cuda else None
            # the outermost unit counts the implicit waits, which warn while
            # it is open; a mode set to raise is left to raise
            if self._outer_unit is None and mode in (0, 1):
                self._watch = (mode, warnings.catch_warnings())
                self._watch[1].__enter__()
                warnings.filterwarnings("always", message=SYNC_WARNING)
                warnings.filterwarnings("ignore", message=SYNC_PROTOTYPE)
                warnings.showwarning = _sync_hook(warnings.showwarning,
                                                  pass_on=mode == 1)
                torch.cuda.set_sync_debug_mode(1)
        else:
            u = _LOG.open_unit
            self.unit = None if u is None else u.unit
        self.range = _autograd_profiler.record_function(self.name)
        self.range.__enter__()
        stack.append(self)
        if cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        _LOG.stack().pop()
        self.range.__exit__(*exc)
        self.range = None
        held = _LOG.held.setdefault(self.unit, [])
        held.append(self)
        if self.unit is None and len(held) > HELD_LOOSE_SPANS:
            _take([None])
        if self.is_unit:
            if self._watch is not None:
                torch.cuda.set_sync_debug_mode(self._watch[0])
                self._watch[1].__exit__(None, None, None)
            allocs = _device_allocs()
            if allocs is not None and self._allocs0 is not None:
                self.counts["device_allocs"] = allocs - self._allocs0
            _LOG.open_unit = self._outer_unit
            held = [u for u in _LOG.held if u is not None]
            if len(held) > HELD_UNITS:
                _take(held[:len(held) - HELD_UNITS])
        return False


def _records() -> bool:
    return not _paused_blocks and (
        bool(_recording_blocks) or _autograd_profiler._is_profiler_enabled)


def is_recording() -> bool:
    """True while spans record: inside a `recording()` block or while a
    `torch.profiler` session records, outside any `paused()` block. The
    counters ask this; `span` and `unit` ask the same of `_records`, so
    that patching this alone switches the counters off and keeps the
    spans."""
    return _records()


def in_recording_block() -> bool:
    """True inside a `recording()` block."""
    return bool(_recording_blocks)


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block (the operator's switch;
    a `torch.profiler` session records them too)."""
    global _recording_blocks
    _recording_blocks += 1
    try:
        yield
    finally:
        _recording_blocks -= 1


@contextlib.contextmanager
def paused():
    """Record nothing inside the block, even while someone records (a CUDA
    graph's capture: its kernels run later, on replay)."""
    global _paused_blocks
    _paused_blocks += 1
    try:
        yield
    finally:
        _paused_blocks -= 1


def span(name: str, **attrs):
    """A span of the program's stage `name` (module docstring), with
    attributes such as depth=; a shared no-op while nothing records."""
    if not _records():
        return _OFF
    return _Span(name, attrs, False)


def unit(name: str):
    """A span that opens a unit of work (a frame, a training step): the
    spans inside share its id (`.unit`, None while nothing records), the
    implicit host syncs inside are counted, and the allocator's device
    allocations across it."""
    if not _records():
        return _OFF
    return _Span(name, {}, True)


def synchronize(device=None) -> None:
    """`torch.cuda.synchronize(device)`, the program's own wait for the
    device; while recording, a host sync of the innermost span, and its
    host ms blocked there that span's `host_wait_ms`."""
    s = _LOG.innermost()
    if s is None:
        torch.cuda.synchronize(device)
        return
    t0 = time.perf_counter_ns()
    torch.cuda.synchronize(device)
    s.counts["host_wait_ms"] += (time.perf_counter_ns() - t0) * 1e-6
    s.counts["host_syncs"] += 1


def count_visits(visits: torch.Tensor, nv: torch.Tensor) -> None:
    """Charge one K1 launch's visit counter to the innermost span: visits
    (T,) the visits each tile ran, nv (T,) the visits listed. Kept as they
    are; `span_table()` sums them."""
    s = _LOG.innermost()
    if s is not None:
        s.visits.append((visits, nv))


# the device counters: each count charges a tensor of these fields, in
# order, to the innermost span
ROW_SCATTER = ("row_scatter_rows", "row_scatter_updates")
RESTIR_RAYS = ("restir_rays_sent", "restir_rays_live")
DEVICE_COUNTERS = ROW_SCATTER + RESTIR_RAYS


def _count_device(fields, counter: torch.Tensor) -> None:
    s = _LOG.innermost()
    if s is not None:
        s.device_counts.append((fields, counter))


def count_row_scatter(counter: torch.Tensor) -> None:
    """Charge one row scatter-add to the innermost span: counter (2,) the
    entries it scattered and the global row updates it issued. Kept as it
    is; `span_table()` sums them."""
    _count_device(ROW_SCATTER, counter)


def count_restir_rays(counter: torch.Tensor) -> None:
    """Charge one ReSTIR visibility pass to the innermost span: counter (2,)
    the rays it sent to the occluder and those of pixels that hit something
    and hold a nonzero reservoir weight. Kept as it is; `span_table()` sums
    them."""
    _count_device(RESTIR_RAYS, counter)


def count_graph_replay() -> None:
    """Charge one replay of a captured CUDA graph to the open unit."""
    u = _LOG.open_unit
    if u is not None:
        u.counts["graph_replays"] += 1


def count_bsdf(rays: int, fused: bool) -> None:
    """Charge one call of the Disney BSDF's `sample` or `evaluate` to the
    innermost span while recording: `rays` to `bsdf_rays`, and to
    `bsdf_fused_rays` where kernel D ran it."""
    s = _LOG.innermost() if _records() else None
    if s is not None:
        s.counts["bsdf_rays"] += rays
        if fused:
            s.counts["bsdf_fused_rays"] += rays


def reset() -> None:
    """Forget every recorded span and the totals (call it outside any open
    span)."""
    _LOG.held.clear()
    _LOG.rows.clear()
    _LOG.units_taken = 0


def _row() -> Dict:
    return {"calls": 0, "host_ms": 0.0, "host_self_ms": 0.0,
            "device_ms": None, "device_self_ms": None, "host_syncs": 0,
            "host_wait_ms": 0.0, "device_allocs": None, "graph_replays": 0,
            "bsdf_rays": 0, "bsdf_fused_rays": 0,
            "k1_visits_run": 0, "k1_visits_listed": 0,
            **{field: 0 for field in DEVICE_COUNTERS}}


def _add(a, b):
    """a + b where either may be None (nothing recorded)."""
    return a if b is None else b if a is None else a + b


def _merge(rows: Dict[str, Dict], more: Dict[str, Dict]) -> None:
    for key, m in more.items():
        r = rows.setdefault(key, _row())
        for field, v in m.items():
            r[field] = _add(r[field], v)


def _take(units) -> Dict:
    """Resolve the held spans of `units` after one sync (their events and
    counter tensors; each child's times go to its parent), take them into the
    totals and return their own table."""
    spans = [s for u in units for s in _LOG.held.pop(u, ())]
    if any(s.events is not None for s in spans):
        torch.cuda.synchronize()
    pairs = [p for s in spans for p in s.visits]
    sums = (torch.stack([t.sum() for p in pairs for t in p]).tolist()
            if pairs else [])
    at = 0
    for s in spans:
        s.host_ms = (s.t1 - s.t0) * 1e-6
        s.device_ms = (None if s.events is None
                       else s.events[0].elapsed_time(s.events[1]))
        n = len(s.visits)
        s.k1_visits_run = int(sum(sums[at:at + 2 * n:2]))
        s.k1_visits_listed = int(sum(sums[at + 1:at + 2 * n:2]))
        at += 2 * n
        s.device_totals = dict.fromkeys(DEVICE_COUNTERS, 0)
        for fields, counter in s.device_counts:
            for field, v in zip(fields, counter.tolist()):
                s.device_totals[field] += int(v)
        s.events, s.visits, s.device_counts = None, [], []
        if s.parent is not None:
            s.parent.child_host_ms += s.host_ms
            if s.device_ms is not None:
                s.parent.child_device_ms += s.device_ms
    rows: Dict[str, Dict] = {}
    n_units = 0
    for s in spans:
        n_units += s.is_unit
        key = s.name if s.phase == "forward" else f"{s.name}/backward"
        r = rows.setdefault(key, _row())
        r["calls"] += 1
        r["host_ms"] += s.host_ms
        r["host_self_ms"] += max(s.host_ms - s.child_host_ms, 0.0)
        if s.device_ms is not None:
            r["device_ms"] = _add(r["device_ms"], s.device_ms)
            r["device_self_ms"] = _add(
                r["device_self_ms"], max(s.device_ms - s.child_device_ms, 0.0))
        for field, v in s.counts.items():
            r[field] = _add(r[field], v)
        r["k1_visits_run"] += s.k1_visits_run
        r["k1_visits_listed"] += s.k1_visits_listed
        for field, v in s.device_totals.items():
            r[field] += v
    _merge(_LOG.rows, rows)
    _LOG.units_taken += n_units
    return {"units": n_units, "spans": rows}


def span_table(unit: Optional[int] = None) -> Dict:
    """The recorded spans by name, since `reset()`, or the closed spans of
    unit id `unit` alone, which this takes into the totals (a later call for
    that unit finds none): {"units": the units, "spans": {key: {"calls",
    "host_ms", "host_self_ms", "device_ms", "device_self_ms" (None without
    CUDA events), "host_syncs", "host_wait_ms" (host ms blocked in
    `synchronize`), "device_allocs" (units only; None without CUDA),
    "graph_replays" (units only), "bsdf_rays", "bsdf_fused_rays",
    "k1_visits_run", "k1_visits_listed",
    and each of DEVICE_COUNTERS: "row_scatter_rows",
    "row_scatter_updates", "restir_rays_sent", "restir_rays_live"}}}.
    Totals over the units, in ms; the key is the span's name, with
    "/backward" after it for spans opened in a backward pass. Self = inclusive less what the span's children
    cover. Synchronises once where CUDA events are held."""
    if unit is not None:
        return _take([unit])
    _take(list(_LOG.held))
    return {"units": _LOG.units_taken,
            "spans": {k: dict(r) for k, r in _LOG.rows.items()}}


def per_unit(field: str, match=None) -> Optional[float]:
    """`field` of `span_table()`'s rows summed over the rows whose key is
    `match` (a key, or a test of the key; every row where None), a unit;
    None where no unit was recorded, no row matches, or a matching row has
    no value (device ms without CUDA events, allocations without CUDA)."""
    table = span_table()
    rows = [r for k, r in table["spans"].items()
            if match is None or (match(k) if callable(match) else k == match)]
    if not table["units"] or not rows or any(r[field] is None for r in rows):
        return None
    return sum(r[field] for r in rows) / table["units"]
