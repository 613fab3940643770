"""Renderer frame state: port of `lumenrenderer_tpu/render/state.py`.

The JAX PRNG key becomes a `torch.Generator` on the render device. The state
also carries the pose of the camera it accumulated, so a camera move is
detected by value, per state, and the ReSTIR reservoir history.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass
class FrameState:
    accum: torch.Tensor          # (N,3) running-average radiance
    blend_count: int             # frames in accum
    frame_index: int             # monotonically increasing
    generator: torch.Generator   # the frame's random numbers
    camera_sig: Optional[bytes] = None  # pose that accum was rendered from
    restir: Optional[Any] = None  # ReSTIR reservoir state (restir.di)


def init_state(num_pixels: int, seed: int = 0, *,
               device: torch.device | str,
               restir: Optional[Any] = None) -> FrameState:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return FrameState(
        accum=torch.zeros((num_pixels, 3), dtype=torch.float32,
                          device=device),
        blend_count=0, frame_index=0, generator=gen, restir=restir)


def reset_accumulation(state: FrameState) -> FrameState:
    """Restart the running average (on a camera move). The ReSTIR history
    stays: it reprojects through the motion vectors."""
    return dataclasses.replace(state, accum=torch.zeros_like(state.accum),
                               blend_count=0)
