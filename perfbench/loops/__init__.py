"""The general generators that traffic files drive, found by name: a mix's
`"loop"` names `perfbench/loops/<loop>.py`, whose `run(ctx)` sets up the
cell, measures its window and checks what the window produced.

Both loops are closed: the next frame or step starts once the last has
finished, as a viewport or a fitting loop does.
"""
from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Context:
    config: Dict          # the configuration file
    traffic: Dict         # the traffic file
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float             # process start, perf_counter seconds
    spec: object = None   # the scene (perfbench.scenes.SceneSpec)
    candidate_dtype: Optional[str] = None   # the control's override

    def sub_seed(self, *keys: int) -> int:
        """A 63-bit seed of (seed, *keys), for the generators the cell
        draws from besides the frame state's own."""
        return int(np.random.SeedSequence([self.seed, *keys])
                   .generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclasses.dataclass
class Result:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    numbers: Dict[str, float]            # what the correctness check read
    layers: Optional[Dict] = None         # the traced run's reduction
    info: Dict = dataclasses.field(default_factory=dict)


def load(name: str):
    return importlib.import_module(f"perfbench.loops.{name}")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_window(step, seconds: float, device):
    """step() repeated, each waited for, until `seconds` have passed since
    the first began: (the duration of each, the window's wall time), in
    seconds."""
    times: List[float] = []
    sync(device)
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        step()
        sync(device)
        end = time.perf_counter()
        times.append(end - t)
        if end - start >= seconds:
            return times, end - start
