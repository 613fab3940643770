"""Plain dataclasses of tensors, the port's counterpart of JAX pytrees."""
from __future__ import annotations

import dataclasses

import torch


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, TensorStruct):
        return x.to(device)
    return x


class TensorStruct:
    """Mixin for dataclasses whose fields are tensors (or nested structs)."""

    def to(self, device):
        """Copy with every tensor field moved to `device`."""
        return dataclasses.replace(
            self, **{f.name: _to(getattr(self, f.name), device)
                     for f in dataclasses.fields(self)})

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)
