"""Checkpoint and resume of a render: port of
`lumenrenderer_tpu/render/checkpoint.py`.

One compressed `.npz`, as JAX writes, holding every part of the port's
`FrameState`: the accumulation, the blend count, the frame index, the
generator's state (`torch.Generator.get_state()`), the camera signature and
each ReSTIR reservoir tensor. Resuming from it renders what the run would
have rendered. A JAX checkpoint holds a threefry key, which no Philox
generator can continue, so it is refused. Orbax (`save_orbax`,
`load_orbax`) has no torch counterpart and is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .state import FrameState

FORMAT = "lumenrenderer_tpu_torch.FrameState/1"


def _leaves(obj, prefix: str, out: Dict[str, torch.Tensor]):
    """The tensors of a dataclass of tensors (nested), by dotted name."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            _leaves(v, f"{prefix}{f.name}.", out)
        elif isinstance(v, torch.Tensor):
            out[prefix + f.name] = v
    return out


def _rebuild(like, prefix: str, z):
    """`like` with every tensor read from z, on its device, in its dtype
    and shape."""
    changes = {}
    for f in dataclasses.fields(like):
        v = getattr(like, f.name)
        if dataclasses.is_dataclass(v):
            changes[f.name] = _rebuild(v, f"{prefix}{f.name}.", z)
        elif isinstance(v, torch.Tensor):
            a = torch.from_numpy(np.array(z[prefix + f.name]))
            changes[f.name] = a.to(v.device, v.dtype).reshape(v.shape)
    return dataclasses.replace(like, **changes)


def save_state(path: str, state: FrameState) -> None:
    leaves = {"format": np.array(FORMAT),
              "accum": state.accum.detach().cpu().numpy(),
              "blend_count": np.int64(state.blend_count),
              "frame_index": np.int64(state.frame_index),
              "generator": state.generator.get_state().numpy()}
    if state.camera_sig is not None:
        leaves["camera_sig"] = np.frombuffer(state.camera_sig, np.uint8)
    if state.restir is not None:
        leaves.update({k: v.detach().cpu().numpy() for k, v in
                       _leaves(state.restir, "restir.", {}).items()})
    np.savez_compressed(path, **leaves)


def load_state(path: str, like: FrameState) -> FrameState:
    """Restore into the structure, devices and dtypes of `like` (a freshly
    initialised state)."""
    with np.load(path) as z:
        if "format" not in z.files or str(z["format"]) != FORMAT:
            raise ValueError(
                f"{path} is not a checkpoint of lumenrenderer_tpu_torch "
                "(a JAX checkpoint holds a threefry key, which the port's "
                "Philox generator cannot continue)")
        has_restir = any(k.startswith("restir.") for k in z.files)
        if has_restir != (like.restir is not None):
            raise ValueError(f"{path} and the state to restore into differ "
                             "in whether they carry ReSTIR reservoirs")
        gen = torch.Generator(device=like.generator.device)
        gen.set_state(torch.from_numpy(np.array(z["generator"])))
        accum = torch.from_numpy(np.array(z["accum"]))
        return dataclasses.replace(
            like,
            accum=accum.to(like.accum.device, like.accum.dtype).reshape(
                like.accum.shape),
            blend_count=int(z["blend_count"]),
            frame_index=int(z["frame_index"]),
            generator=gen,
            camera_sig=(z["camera_sig"].tobytes() if "camera_sig" in z.files
                        else None),
            restir=(_rebuild(like.restir, "restir.", z) if has_restir
                    else None))
