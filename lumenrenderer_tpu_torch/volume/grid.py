"""Density-grid volumes, dense and sparse: port of
`lumenrenderer_tpu/volume/grid.py`.

A volume is a float32 density field sampled trilinearly, differentiable
with respect to its density. Two layouts share `sample_density`:

- `VolumeSet`: one dense (X,Y,Z) grid per volume.
- `SparseVolumeSet`: an int32 index of 8³ cells per volume and a stack of
  occupied 9³ bricks (one voxel of apron, so a trilinear sample reads one
  brick); slot 0 is the shared all-zero brick of empty space.

A sample gathers its eight corners with one element-wise `torch.take` of
flat indices (sparse: one more for the cell's slot). PyTorch's indexed
gathers launch a block per row, and their backward is a sort-based
accumulation; `take`'s backward is an atomic `put_` (PERF.md).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.struct import TensorStruct

BRICK = 8  # sparse cell edge; a brick holds BRICK + 1 samples an axis


@dataclasses.dataclass(frozen=True)
class VolumeSet(TensorStruct):
    """V dense grids of one shared resolution: density (V,X,Y,Z), world box
    aabb_lo/aabb_hi (V,3), extinction scale sigma_t (V,) and single-scatter
    albedo (V,)."""

    density: torch.Tensor
    aabb_lo: torch.Tensor
    aabb_hi: torch.Tensor
    sigma_t: torch.Tensor
    albedo: torch.Tensor

    @property
    def count(self) -> int:
        return self.density.shape[0]


@dataclasses.dataclass(frozen=True)
class SparseVolumeSet(TensorStruct):
    """V sparse grids sharing one brick stack: index (V,NX,NY,NZ) int32 slot
    per 8³ cell (0 = empty), bricks (S,9,9,9). res is the sample grid's
    resolution; the world box spans sample indices [0, res - 1], as a dense
    grid's does."""

    index: torch.Tensor
    bricks: torch.Tensor
    aabb_lo: torch.Tensor
    aabb_hi: torch.Tensor
    sigma_t: torch.Tensor
    albedo: torch.Tensor
    res: Tuple[int, int, int] = (0, 0, 0)

    @property
    def count(self) -> int:
        return self.index.shape[0]


def _per_volume(values, v: int, default: float) -> torch.Tensor:
    return torch.from_numpy(
        np.full(v, default, np.float32) if values is None
        else np.asarray(values, np.float32).reshape(v))


def _boxes(aabb_lo, aabb_hi, v: int):
    return (torch.from_numpy(np.asarray(aabb_lo, np.float32).reshape(v, 3)),
            torch.from_numpy(np.asarray(aabb_hi, np.float32).reshape(v, 3)))


def make_volume_set(densities, aabb_lo, aabb_hi, sigma_t=None,
                    albedo=None) -> VolumeSet:
    """Stack host density grids (a list of (X,Y,Z) arrays of one shape) into
    a VolumeSet of CPU tensors; sigma_t defaults to 1, albedo to 0.9."""
    d = torch.from_numpy(np.stack(densities).astype(np.float32))
    v = d.shape[0]
    lo, hi = _boxes(aabb_lo, aabb_hi, v)
    return VolumeSet(density=d, aabb_lo=lo, aabb_hi=hi,
                     sigma_t=_per_volume(sigma_t, v, 1.0),
                     albedo=_per_volume(albedo, v, 0.9))


def build_sparse(densities, aabb_lo, aabb_hi, sigma_t=None, albedo=None,
                 threshold: float = 0.0) -> SparseVolumeSet:
    """A SparseVolumeSet of CPU tensors from host dense grids (a list of
    (X,Y,Z) arrays of one shape). A cell whose 9³ apron view (the grid
    edge-padded) is everywhere <= threshold reads the zero brick; the others
    get a slot each, volume by volume in x-major cell order."""
    densities = [np.asarray(d, np.float32) for d in densities]
    v = len(densities)
    shp = densities[0].shape
    if any(d.shape != shp for d in densities):
        raise ValueError("build_sparse: every grid needs the same shape")
    nb = [max(1, -(-(s - 1) // BRICK)) for s in shp]
    index = np.zeros((v,) + tuple(nb), np.int32)
    bricks = [np.zeros((1,) + (BRICK + 1,) * 3, np.float32)]  # slot 0
    n_slots = 1
    for vi, d in enumerate(densities):
        pad = [(0, nbk * BRICK + 1 - s) for nbk, s in zip(nb, shp)]
        dp = np.pad(d, pad, mode="edge")
        views = np.lib.stride_tricks.sliding_window_view(
            dp, (BRICK + 1,) * 3)[::BRICK, ::BRICK, ::BRICK]
        occupied = (views > threshold).any(axis=(3, 4, 5))
        index[vi][occupied] = n_slots + np.arange(int(occupied.sum()),
                                                  dtype=np.int32)
        n_slots += int(occupied.sum())
        bricks.append(views[occupied])
    lo, hi = _boxes(aabb_lo, aabb_hi, v)
    return SparseVolumeSet(
        index=torch.from_numpy(index),
        bricks=torch.from_numpy(np.concatenate(bricks)),
        aabb_lo=lo, aabb_hi=hi, sigma_t=_per_volume(sigma_t, v, 1.0),
        albedo=_per_volume(albedo, v, 0.9),
        res=tuple(int(s) for s in shp))


@functools.lru_cache(maxsize=64)
def _lattice(res: Tuple[int, int, int], device: torch.device):
    """Constants of a trilinear lookup on a res-sample grid: res - 1 (3,)
    float32, and the least and largest base corner, 0 and res - 2 (3,)
    int64."""
    return (torch.tensor([s - 1.0 for s in res], device=device),
            torch.zeros(3, dtype=torch.int64, device=device),
            torch.tensor([s - 2 for s in res], device=device))


@functools.lru_cache(maxsize=64)
def _int3(values: Tuple[int, int, int], device: torch.device):
    return torch.tensor(values, device=device)


@functools.lru_cache(maxsize=64)
def _corner_offsets(strides: Tuple[int, int, int], device: torch.device):
    """(8,) int64 flat offsets of a cell's corners, x fastest."""
    sx, sy, sz = strides
    return torch.tensor([dx * sx + dy * sy + dz * sz for dz in (0, 1)
                         for dy in (0, 1) for dx in (0, 1)], device=device)


def _grid_coords(vol, v_idx, pos, res):
    """(inside (...,), base corner (...,3) int64 clamped to [0, res - 2],
    fractions (...,3)) of world positions in volume v_idx's sample grid."""
    lo = vol.aabb_lo[v_idx]
    hi = vol.aabb_hi[v_idx]
    res_m1, bottom, top = _lattice(tuple(res), pos.device)
    q = (pos - lo) / (hi - lo).clamp_min(1e-12)
    inside = ((q >= 0.0) & (q <= 1.0)).all(-1)
    g = q * res_m1
    g0 = torch.floor(g)
    f = g - g0
    return inside, torch.clamp(g0.long(), min=bottom, max=top), f


def _trilinear(table: torch.Tensor, base: torch.Tensor, strides, f,
               inside) -> torch.Tensor:
    """Trilinear blend of the corners table.flatten()[base + offsets], 0
    outside; the clamp at 0 splits a tie's gradient, as jnp.maximum does."""
    c = table.take(base[..., None] + _corner_offsets(strides, base.device))
    c = torch.lerp(c[..., 0::2], c[..., 1::2], f[..., 0:1])   # over x
    c = torch.lerp(c[..., 0::2], c[..., 1::2], f[..., 1:2])   # over y
    d = torch.lerp(c[..., 0], c[..., 1], f[..., 2])           # over z
    return torch.where(inside, torch.maximum(d, d.new_zeros(())), 0.0)


def _flat(cells: torch.Tensor, strides: Tuple[int, int, int], v_idx,
          volume_size: int) -> torch.Tensor:
    """Flat int64 offset of (...,3) int64 coordinates under the given
    strides, in volume v_idx of volume_size elements."""
    v = v_idx.long() if isinstance(v_idx, torch.Tensor) else v_idx
    return (cells * _int3(strides, cells.device)).sum(-1) + v * volume_size


def sample_density(vol, v_idx, pos: torch.Tensor) -> torch.Tensor:
    """Trilinear density at world positions pos (...,3) in volume v_idx (an
    int or a (...,) integer tensor); 0 outside the volume's box."""
    if isinstance(vol, SparseVolumeSet):
        return _sample_sparse(vol, v_idx, pos)
    x, y, z = vol.density.shape[1:]
    inside, g0, f = _grid_coords(vol, v_idx, pos, (x, y, z))
    strides = (y * z, z, 1)
    base = _flat(g0, strides, v_idx, x * y * z)
    return _trilinear(vol.density, base, strides, f, inside)


def _sample_sparse(vol: SparseVolumeSet, v_idx, pos) -> torch.Tensor:
    """Trilinear density by an index gather, then a brick gather."""
    nx, ny, nz = vol.index.shape[1:]
    inside, g0, f = _grid_coords(vol, v_idx, pos, vol.res)
    b = torch.minimum(torch.div(g0, BRICK, rounding_mode="floor"),
                      _int3((nx - 1, ny - 1, nz - 1), pos.device))
    slot = vol.index.take(_flat(b, (ny * nz, nz, 1), v_idx, nx * ny * nz))
    e = BRICK + 1
    strides = (e * e, e, 1)
    base = _flat(g0 - b * BRICK, strides, slot, e * e * e)
    return _trilinear(vol.bricks, base, strides, f, inside)


def density_majorant(vol) -> torch.Tensor:
    """(V,) largest density of each volume (ratio tracking's majorant)."""
    if isinstance(vol, SparseVolumeSet):
        m = vol.bricks.reshape(vol.bricks.shape[0], -1).amax(1)
        return m.take(vol.index.reshape(vol.count, -1).long()).amax(1)
    return vol.density.reshape(vol.count, -1).amax(1)


# ---------------------------------------------------------------------------
# host-side grids and loaders (numpy)
# ---------------------------------------------------------------------------

def sphere_density(res: int = 32, radius: float = 0.4,
                   soft: float = 0.15) -> np.ndarray:
    """Soft sphere blob on a res³ grid (a procedural stand-in for smoke);
    equal to the JAX package's, without its (3,res,res,res) coordinate
    array."""
    a = (np.arange(res, dtype=np.float32) + 0.5) / res - 0.5
    r = np.sqrt(a[:, None, None] ** 2 + a[None, :, None] ** 2
                + a[None, None, :] ** 2)
    return np.clip((radius - r) / soft, 0.0, 1.0).astype(np.float32)


def noise_density(res: int = 32, seed: int = 0,
                  octaves: int = 3) -> np.ndarray:
    """Value-noise fog on a res³ grid from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = np.zeros((res, res, res), np.float32)
    for o in range(octaves):
        r = max(2, res >> (octaves - 1 - o))
        coarse = rng.random((r, r, r)).astype(np.float32)
        zoom = res // r
        out += np.kron(coarse, np.ones((zoom, zoom, zoom), np.float32))[
            :res, :res, :res] * (0.5 ** o)
    out -= out.mean() * 0.7
    return np.clip(out, 0.0, None)


def load_npz(path: str) -> np.ndarray:
    """A density grid from .npy, or the first array of a .npz."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return np.asarray(z[list(z.files)[0]], np.float32)
    return np.asarray(np.load(path), np.float32)


def load_vdb(path: str, target_res: Optional[int] = None) -> np.ndarray:
    """OpenVDB loader: needs pyopenvdb, and reads nothing even then, as in
    the JAX package. Convert the grid to .npz (`load_npz`) or .nvdb
    (`volume.nvdb`)."""
    try:
        import pyopenvdb  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "pyopenvdb is not available in this environment; convert the "
            ".vdb to a dense .npz brick offline and use load_npz()") from e
    raise NotImplementedError("reading .vdb grids is not implemented")
