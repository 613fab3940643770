"""Frame statistics and profiling: port of
`lumenrenderer_tpu/utils/profiling.py`.

`Timer` is a stopwatch, `FrameStats` one frame's named stage times,
`Profiler` a rolling window of them. A stage that names a CUDA tensor
(`block_on`) synchronises its device before the clock stops: PyTorch
returns before the card finishes. `device_trace` records a
`torch.profiler` trace and writes it as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Dict, Optional

import torch


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
            torch.cuda.synchronize(x.device)
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
