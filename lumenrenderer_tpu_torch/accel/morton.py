"""30-bit Morton (Z-order) codes, 10 bits per axis.

Port of `lumenrenderer_tpu/accel/morton.py`. The JAX package computes in
uint32; the port computes in int64, which holds the same values.
"""
from __future__ import annotations

import torch


def expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v with two zero bits between each."""
    v = v.to(torch.int64) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3d(p: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
             ) -> torch.Tensor:
    """Morton codes (int64, < 2^30) of points p (...,3) in the box [lo, hi]."""
    extent = (hi - lo).clamp_min(1e-12)
    q = ((p - lo) / extent).clamp(0.0, 1.0 - 1e-7)
    cell = (q * 1024.0).to(torch.int64)
    x = expand_bits_10(cell[..., 0])
    y = expand_bits_10(cell[..., 1])
    z = expand_bits_10(cell[..., 2])
    return (x << 2) | (y << 1) | z
