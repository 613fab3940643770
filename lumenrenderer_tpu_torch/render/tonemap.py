"""Blend, tonemap, quantize and write PNG: port of
`lumenrenderer_tpu/render/tonemap.py` (the PNG writer uses only the standard
library)."""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def blend_accumulate(accum: torch.Tensor, frame: torch.Tensor,
                     blend_count: int) -> torch.Tensor:
    """Running mean: accum holds `blend_count` frames; add `frame`."""
    n = float(blend_count)
    return (accum * n + frame) / (n + 1.0)


def tonemap_gamma(rgb: torch.Tensor, gamma: float = 2.2,
                  exposure: float = 1.0) -> torch.Tensor:
    x = (rgb * exposure).clamp_min(0.0)
    return (x ** (1.0 / gamma)).clamp(0.0, 1.0)


def tonemap_aces(rgb: torch.Tensor, exposure: float = 1.0) -> torch.Tensor:
    """Narkowicz's fit of the ACES filmic curve, then gamma 2.2."""
    x = (rgb * exposure).clamp_min(0.0)
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return ((x * (a * x + b)) / (x * (c * x + d) + e)).clamp(0.0, 1.0) ** (
        1 / 2.2)


def to_uint8(rgb01: torch.Tensor) -> torch.Tensor:
    return (rgb01.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def save_png(path: str, img_uint8) -> None:
    """Write an (H,W,3) uint8 image as an 8-bit RGB PNG."""
    a = np.ascontiguousarray(np.asarray(img_uint8, np.uint8))
    h, w, _ = a.shape
    raw = b"".join(b"\x00" + a[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
