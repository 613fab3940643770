"""Texture atlas with gather-based bilinear and trilinear (mipmapped)
sampling: port of `lumenrenderer_tpu/scene/textures.py`.

Every texture and its full mip chain (2x2 box filter) is one run of rows of
a flat (P,4) float32 RGBA pool, with per-texture, per-level offsets. Slot 0
is a 1x1 white texture, which texture id -1 (none) samples. Wrap mode is
REPEAT. A sample gathers a level's four corner texels with one
element-wise gather (`take_rows`).

A sample of slot 0 is texels[0] itself, not a gather: most rays have no
texture in some of their material's four slots, and the gather's backward
would pile millions of duplicates onto that one row, where the
accumulation serializes (measured with a row gather, whose backward walks
a row's duplicates in turn: 3,212 ms of a 640x360 texel gradient's
backward on the H100 before, 322 ms after; PERF.md). The JAX package
gathers it; the values differ by float rounding of the bilinear weights.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..core.struct import TensorStruct

MAX_MIPS = 14  # enough for 8192x8192


@dataclasses.dataclass(frozen=True)
class TextureAtlas(TensorStruct):
    """Texel pool with per-texture offsets and mip levels (the JAX atlas's
    leaves)."""

    texels: torch.Tensor      # (P,4) float32 RGBA, P >= 1
    offset: torch.Tensor      # (K,) int32 flat offset of texture k, level 0
    width: torch.Tensor       # (K,) int32 level-0 width
    height: torch.Tensor      # (K,) int32 level-0 height
    mip_offset: torch.Tensor  # (K,MAX_MIPS) int32 per-level offsets, the
                              # last real level's repeated past n_mips
    n_mips: torch.Tensor      # (K,) int32 real levels (>= 1)

    @property
    def count(self) -> int:
        return self.offset.shape[0]


def _downsample2(a: np.ndarray) -> np.ndarray:
    """2x2 box filter to max(1, d // 2) in each dimension (width >> level,
    as sampling computes it); odd trailing texels are cropped."""
    h, w = a.shape[:2]
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    a = a[: nh * 2 if h > 1 else 1, : nw * 2 if w > 1 else 1]
    if h == 1:
        return a.reshape(1, nw, 2, -1).mean(axis=2)
    if w == 1:
        return a.reshape(nh, 2, 1, -1).mean(axis=1)
    return a.reshape(nh, 2, nw, 2, -1).mean(axis=(1, 3))


def build_texture_atlas(images: List[np.ndarray],
                        mips: bool = True) -> TextureAtlas:
    """Pack images ((H,W), (H,W,1|3|4); uint8, taken as value / 255, or
    float) into a flat atlas with full mip chains (CPU tensors). Slot 0 is
    the 1x1 white texture; image i is slot i + 1."""
    blobs = [np.ones((1, 1, 4), np.float32)]
    for img in images:
        a = np.asarray(img)
        if a.dtype == np.uint8:
            a = a.astype(np.float32) / 255.0
        a = a.astype(np.float32)
        if a.ndim == 2:
            a = a[..., None]
        if a.shape[-1] == 1:
            a = np.concatenate([a, a, a, np.ones_like(a[..., :1])], axis=-1)
        elif a.shape[-1] == 3:
            a = np.concatenate([a, np.ones_like(a[..., :1])], axis=-1)
        blobs.append(a[..., :4])
    offs, ws, hs, flat, mip_offs, nmips = [], [], [], [], [], []
    cursor = 0
    for b in blobs:
        h, w = b.shape[:2]
        offs.append(cursor)
        ws.append(w)
        hs.append(h)
        levels = [b]
        if mips:
            while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
                levels.append(_downsample2(levels[-1]))
        row = []
        for lv in levels:
            row.append(cursor)
            flat.append(lv.reshape(-1, 4))
            cursor += lv.shape[0] * lv.shape[1]
        nmips.append(len(levels))
        row += [row[-1]] * (MAX_MIPS - len(row))
        mip_offs.append(row[:MAX_MIPS])
    i32 = lambda x: torch.from_numpy(np.array(x, np.int32))
    return TextureAtlas(
        texels=torch.from_numpy(np.concatenate(flat, axis=0)),
        offset=i32(offs), width=i32(ws), height=i32(hs),
        mip_offset=i32(mip_offs), n_mips=i32(nmips))


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a (N,C) table of narrow rows: (...,) -> (...,C), by an
    element-wise gather. PyTorch's row gathers (indexing, index_select,
    gather, embedding) launch a block per row: 35.5 ms for the 59M 16-byte
    rows of one 2560x1440 sampler level on the H100, against 2.4 ms here
    (PERF.md)."""
    c = table.shape[-1]
    cols = torch.arange(c, device=idx.device)
    return table.take(idx[..., None].long() * c + cols)


def _slot(atlas: TextureAtlas, tex_id: torch.Tensor) -> torch.Tensor:
    """Builder texture ids (-1 = none) -> atlas slots (int64)."""
    return (tex_id.long() + 1).clamp(0, atlas.count - 1)


def _bilinear_level(atlas: TextureAtlas, slot, level, uv) -> torch.Tensor:
    """Bilinear REPEAT-wrapped sample at an integer mip level (clamped):
    slot and level (...,), uv (...,2) -> (...,4). The four corners are one
    gather; slot 0's read rows spread over the pool (see _white)."""
    level = torch.minimum(level.clamp_min(0), atlas.n_mips[slot] - 1).long()
    off = atlas.mip_offset.reshape(-1)[slot * atlas.mip_offset.shape[1]
                                       + level]
    spread = torch.arange(slot.numel(), device=slot.device).view(slot.shape)
    off = torch.where(slot == 0, spread % atlas.texels.shape[0], off)
    iw = (atlas.width[slot] >> level).clamp_min(1)
    ih = (atlas.height[slot] >> level).clamp_min(1)
    x = uv[..., 0] * iw.float() - 0.5
    y = uv[..., 1] * ih.float() - 0.5
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - x0.float())[..., None]
    fy = (y - y0.float())[..., None]
    step = torch.arange(2, dtype=torch.int32, device=uv.device)
    # corner (j, i) of the 2x2 footprint at [..., j, i]: row y0 + j, column
    # x0 + i, both wrapped
    xw = torch.remainder(x0[..., None] + step, iw[..., None])
    yw = torch.remainder(y0[..., None] + step, ih[..., None])
    idx = (off[..., None, None] + yw[..., :, None] * iw[..., None, None]
           + xw[..., None, :])
    c = take_rows(atlas.texels, idx)                   # (...,2,2,4)
    top = c[..., 0, 0, :] * (1.0 - fx) + c[..., 0, 1, :] * fx
    bot = c[..., 1, 0, :] * (1.0 - fx) + c[..., 1, 1, :] * fx
    return top * (1.0 - fy) + bot * fy


def _white(atlas: TextureAtlas, slot, sample) -> torch.Tensor:
    """`sample` with slot 0's entries replaced by texels[0]."""
    return torch.where((slot == 0)[..., None], atlas.texels[0], sample)


def sample_bilinear(atlas: TextureAtlas, tex_id: torch.Tensor,
                    uv: torch.Tensor) -> torch.Tensor:
    """Bilinear REPEAT-wrapped level-0 sample. tex_id (...,) builder ids
    (-1 = none, white); uv (...,2) broadcast against it. -> (...,4)."""
    slot = _slot(atlas, tex_id)
    return _white(atlas, slot,
                  _bilinear_level(atlas, slot, torch.zeros_like(slot), uv))


def sample_trilinear(atlas: TextureAtlas, tex_id: torch.Tensor,
                     uv: torch.Tensor, lod_uv: torch.Tensor) -> torch.Tensor:
    """Trilinearly filtered mipmapped sample. lod_uv (...,): log2 of the
    sampling footprint in UV space; the texel-space LOD adds
    0.5 * log2(W * H) of each texture. uv and lod_uv broadcast against
    tex_id. -> (...,4)."""
    slot = _slot(atlas, tex_id)
    wh = (atlas.width[slot] * atlas.height[slot]).float()
    lod = lod_uv + 0.5 * torch.log2(wh.clamp_min(1.0))
    lod = torch.minimum(lod.clamp_min(0.0), (atlas.n_mips[slot] - 1).float())
    l0 = torch.floor(lod).to(torch.int32)
    fl = (lod - l0.float())[..., None]
    c0 = _bilinear_level(atlas, slot, l0, uv)
    c1 = _bilinear_level(atlas, slot, l0 + 1, uv)
    return _white(atlas, slot, c0 * (1.0 - fl) + c1 * fl)
