"""Reader for serialized NanoVDB (.nvdb) float grids: the port's own copy
of `lumenrenderer_tpu/volume/nvdb.py` (numpy and `struct` only).

It reads the NanoVDB v29.3 serialization directly, with no OpenVDB or
NanoVDB dependency, and returns the leaf-level data in the shape
`grid.SparseVolumeSet` wants: occupied 8³ bricks and their integer origins.

Struct offsets are ABI facts of the v29.x format (probed with
`sizeof`/`offsetof` from the NanoVDB headers): file Header 16B + per-grid
MetaData 160B + name; grid buffer = GridData 672B, TreeData 64B (mBytes[4]
level offsets relative to the tree, mCount[4]), level arrays of LeafData
2144B / lower InternalData 17472B / upper InternalData 139328B; value masks
are little-endian bitfields; internal value tiles (constant regions with no
child) are rasterized into constant bricks so fog interiors survive.
`_GD_VERSION` is kept as the JAX package has it, and never read.

Only uncompressed files (Codec::NONE) and float grids are supported.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

MAGIC = 0x304244566F6E614E  # "NanoVDB0"

# GridData field offsets (672-byte struct, probed from the NanoVDB header)
_GD_VERSION = 16
_GD_GRIDSIZE = 24
_GD_GRIDNAME = 32
_GD_WORLDBBOX = 552
_GD_VOXELSIZE = 600
_GD_GRIDCLASS = 624
_GD_GRIDTYPE = 628
_GD_SIZE = 672

_TREE_SIZE = 64

# LeafData<float> (2144B)
_LEAF_BBOXMIN = 0
_LEAF_VMASK = 16        # 64B = 512-bit mask
_LEAF_VALUES = 96       # 512 float32
_LEAF_SIZE = 2144

# lower InternalData (LOG2DIM=4, 17472B): 16³ table, children are leaves
_LO_BBOX = 0
_LO_VMASK = 32          # 512B
_LO_CMASK = 544         # 512B
_LO_TABLE = 1088        # 4096 × 4B (float value | uint32 childID union)
_LO_SIZE = 17472
_LO_LOG2 = 4            # 16 children per axis, child span 8 → node span 128

# upper InternalData (LOG2DIM=5, 139328B): 32³ table, children are lower
_UP_BBOX = 0
_UP_VMASK = 32          # 4096B
_UP_CMASK = 4128        # 4096B
_UP_TABLE = 8256        # 32768 × 4B
_UP_SIZE = 139328
_UP_LOG2 = 5            # 32 children per axis, child span 128 → span 4096

GRID_TYPE_FLOAT = 1     # nanovdb::GridType::Float


@dataclass
class NvdbGrid:
    """One parsed float grid: leaf bricks + world transform."""

    name: str
    voxel_size: Tuple[float, float, float]
    world_bbox: Tuple[Tuple[float, float, float], Tuple[float, float, float]]
    index_bbox_min: Tuple[int, int, int]
    index_bbox_max: Tuple[int, int, int]
    # brick origin (index-space, multiple of 8) -> (8,8,8) float32 values
    bricks: Dict[Tuple[int, int, int], np.ndarray] = field(default_factory=dict)
    voxel_count: int = 0

    def resolution(self) -> Tuple[int, int, int]:
        lo, hi = self.index_bbox_min, self.index_bbox_max
        return tuple(int(hi[i] - lo[i] + 1) for i in range(3))

    def to_dense(self) -> np.ndarray:
        """Rasterize the active bricks into a dense array over the index
        bbox (small grids / tests; production path is SparseVolumeSet)."""
        res = self.resolution()
        out = np.zeros(res, np.float32)
        lo = np.asarray(self.index_bbox_min)
        for origin, vals in self.bricks.items():
            o = np.asarray(origin) - lo
            s = np.maximum(-o, 0)
            e = np.minimum(np.asarray(res) - o, 8)
            if np.any(s >= e):
                continue
            out[o[0] + s[0]:o[0] + e[0], o[1] + s[1]:o[1] + e[1],
                o[2] + s[2]:o[2] + e[2]] = vals[s[0]:e[0], s[1]:e[1],
                                                s[2]:e[2]]
        return out


def _mask_bits(buf: memoryview, off: int, nbits: int) -> np.ndarray:
    """Little-endian bitfield → bool array of nbits."""
    nbytes = nbits // 8
    raw = np.frombuffer(buf[off:off + nbytes], np.uint8)
    return np.unpackbits(raw, bitorder="little").astype(bool)


def _read_grid(buf: memoryview) -> NvdbGrid:
    (magic,) = struct.unpack_from("<Q", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"not a NanoVDB grid buffer (magic {magic:#x})")
    (gtype,) = struct.unpack_from("<I", buf, _GD_GRIDTYPE)
    if gtype != GRID_TYPE_FLOAT:
        raise ValueError(f"only float grids supported (GridType {gtype})")
    name = bytes(buf[_GD_GRIDNAME:_GD_GRIDNAME + 256]).split(b"\0", 1)[0]
    wb = struct.unpack_from("<6d", buf, _GD_WORLDBBOX)
    vs = struct.unpack_from("<3d", buf, _GD_VOXELSIZE)

    tree_off = _GD_SIZE
    mbytes = struct.unpack_from("<4Q", buf, tree_off)
    mcount = struct.unpack_from("<4I", buf, tree_off + 32)
    n_leaf, n_lower, n_upper, _ = mcount
    leaf_base = tree_off + mbytes[0]
    lower_base = tree_off + mbytes[1]
    upper_base = tree_off + mbytes[2]

    grid = NvdbGrid(
        name=name.decode("utf-8", "replace"),
        voxel_size=tuple(vs),
        world_bbox=(tuple(wb[:3]), tuple(wb[3:])),
        index_bbox_min=(0, 0, 0),
        index_bbox_max=(0, 0, 0),
    )

    # ---- leaves: active values, inactive voxels read as 0 (background
    # of fog grids; value-tile interiors are handled below) ----
    bb_lo = np.array([2**31 - 1] * 3, np.int64)
    bb_hi = np.array([-(2**31)] * 3, np.int64)
    total_active = 0
    for i in range(n_leaf):
        off = leaf_base + i * _LEAF_SIZE
        ox, oy, oz = struct.unpack_from("<3i", buf, off + _LEAF_BBOXMIN)
        origin = (ox & ~7, oy & ~7, oz & ~7)
        mask = _mask_bits(buf, off + _LEAF_VMASK, 512)
        vals = np.frombuffer(
            buf[off + _LEAF_VALUES:off + _LEAF_VALUES + 2048], np.float32
        ).copy()
        vals[~mask] = 0.0
        grid.bricks[origin] = vals.reshape(8, 8, 8)
        total_active += int(mask.sum())
        o = np.asarray(origin, np.int64)
        bb_lo = np.minimum(bb_lo, o)
        bb_hi = np.maximum(bb_hi, o + 7)

    # ---- internal value tiles (constant fills with no child) ----
    def tiles(base, count, size, vmask_off, cmask_off, table_off, log2,
              child_span):
        nonlocal total_active
        n3 = 1 << (3 * log2)
        for i in range(count):
            off = base + i * size
            vmask = _mask_bits(buf, off + vmask_off, n3)
            cmask = _mask_bits(buf, off + cmask_off, n3)
            fill = vmask & ~cmask
            if not fill.any():
                continue
            bx, by, bz = struct.unpack_from("<3i", buf, off)
            span = child_span << log2
            node_o = np.array([bx & ~(span - 1), by & ~(span - 1),
                               bz & ~(span - 1)], np.int64)
            vals = np.frombuffer(buf[off + table_off:off + table_off + 4 * n3],
                                 np.float32)
            for t in np.nonzero(fill)[0]:
                # table is x-major: t = x*2^(2*log2) + y*2^log2 + z
                tz = t & ((1 << log2) - 1)
                ty = (t >> log2) & ((1 << log2) - 1)
                tx = t >> (2 * log2)
                lo = node_o + np.array([tx, ty, tz]) * child_span
                v = float(vals[t])
                total_active += child_span ** 3
                for cx in range(0, child_span, 8):
                    for cy in range(0, child_span, 8):
                        for cz in range(0, child_span, 8):
                            origin = (int(lo[0] + cx), int(lo[1] + cy),
                                      int(lo[2] + cz))
                            grid.bricks.setdefault(
                                origin, np.full((8, 8, 8), v, np.float32))
                bb_lo[:] = np.minimum(bb_lo, lo)
                bb_hi[:] = np.maximum(bb_hi, lo + child_span - 1)

    tiles(lower_base, n_lower, _LO_SIZE, _LO_VMASK, _LO_CMASK, _LO_TABLE,
          _LO_LOG2, 8)
    tiles(upper_base, n_upper, _UP_SIZE, _UP_VMASK, _UP_CMASK, _UP_TABLE,
          _UP_LOG2, 128)

    if grid.bricks:
        grid.index_bbox_min = tuple(int(x) for x in bb_lo)
        grid.index_bbox_max = tuple(int(x) for x in bb_hi)
    grid.voxel_count = total_active
    return grid


def load_nvdb(path: str) -> List[NvdbGrid]:
    """Parse every float grid in an uncompressed .nvdb file."""
    with open(path, "rb") as f:
        data = f.read()
    buf = memoryview(data)
    magic, _version, grid_count, codec = struct.unpack_from("<QIHH", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not a .nvdb file (magic {magic:#x})")
    if codec != 0:
        raise ValueError(f"{path}: compressed .nvdb (codec {codec}) not "
                         "supported; rewrite with Codec::NONE")
    pos = 16
    metas = []
    for _ in range(grid_count):
        (grid_size, file_size) = struct.unpack_from("<2Q", buf, pos)
        # MetaData: 4×u64 (32) + gridType/gridClass (8) + worldBBox (48)
        # + indexBBox (24) + voxelSize (24) = 136 → nameSize
        (name_size,) = struct.unpack_from("<I", buf, pos + 136)
        metas.append((grid_size, file_size))
        pos += 160 + name_size
    grids = []
    for grid_size, _file_size in metas:
        grids.append(_read_grid(buf[pos:pos + grid_size]))
        pos += grid_size
    return grids


def sparse_from_nvdb(path: str, sigma_t=1.0, albedo=0.9,
                     world_override=None):
    """The first float grid of a .nvdb file as a SparseVolumeSet of CPU
    tensors. The world box defaults to the grid's own world bbox; pass
    world_override=(lo, hi) to re-seat it."""
    import torch

    from . import grid as grid_mod

    g = load_nvdb(path)[0]
    res = g.resolution()
    lo_i = np.asarray(g.index_bbox_min)
    nb = [max(1, -(-(s - 1) // grid_mod.BRICK)) for s in res]
    index = np.zeros((1,) + tuple(nb), np.int32)
    bricks = [np.zeros((grid_mod.BRICK + 1,) * 3, np.float32)]
    # stitch 9³ aprons from the 8³ leaf dict (neighbour faces/edges/corner)
    for bx in range(nb[0]):
        for by in range(nb[1]):
            for bz in range(nb[2]):
                blk = np.zeros((9, 9, 9), np.float32)
                base = lo_i + np.array([bx, by, bz]) * 8
                any_data = False
                for dx, dy, dz in ((0, 0, 0), (1, 0, 0), (0, 1, 0),
                                   (0, 0, 1), (1, 1, 0), (1, 0, 1),
                                   (0, 1, 1), (1, 1, 1)):
                    src = g.bricks.get(
                        (int(base[0] + 8 * dx), int(base[1] + 8 * dy),
                         int(base[2] + 8 * dz)))
                    if src is None:
                        continue
                    any_data = True
                    dst = tuple(slice(8, 9) if o else slice(0, 8)
                                for o in (dx, dy, dz))
                    srcs = tuple(slice(0, 1) if o else slice(0, 8)
                                 for o in (dx, dy, dz))
                    blk[dst] = src[srcs]
                if any_data:
                    index[0, bx, by, bz] = len(bricks)
                    bricks.append(blk)
    wlo, whi = world_override if world_override is not None else g.world_bbox
    t_ = torch.from_numpy
    return grid_mod.SparseVolumeSet(
        index=t_(index), bricks=t_(np.stack(bricks)),
        aabb_lo=t_(np.asarray(wlo, np.float32).reshape(1, 3)),
        aabb_hi=t_(np.asarray(whi, np.float32).reshape(1, 3)),
        sigma_t=t_(np.full(1, sigma_t, np.float32)),
        albedo=t_(np.full(1, albedo, np.float32)),
        res=tuple(int(s) for s in res))
