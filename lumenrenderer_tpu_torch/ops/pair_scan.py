"""Kernel K3: the pair scan of the pair-admission intersector, on Hopper.

Replaces the Pallas TPU kernel `pair_scan` (`_make_pair_kernel_resident` and
`_make_pair_kernel_stream`) in `lumenrenderer_tpu/ops/pallas/pair_intersect.py`.

Contract. `rf_pairs (S, 12)` holds one row per (ray, cluster) pair: the ray's
features [o×d, d, o, 1] and its window t_min, t_max; S is a multiple of 128.
The pairs come sorted by cluster in runs padded to 128, so each 128-pair tile
refers to one cluster, `tile_cluster[S / 128]` of `feats (C, 10, 4K)`. Per
pair, the Möller–Trumbore test of K1 (`ops/visit_scan.py`) against the K
triangles of that cluster; closest mode returns the minimum key
`(t_bits & ~((1 << k_bits) - 1)) | slot` (no visit field), 0x7F000000 for a
miss; any mode returns 1 where any triangle hits. Padding pairs have
t_max < t_min and so never hit: they return the miss key or 0, with no
special case.

What bounds it on an H100: per live tile 128 pairs x the cluster's live
triangles x 40 fp32 FMAs, on a slab of at most 20 KB read from L2: fp32
issue, as K1 (in bf16 the product goes to the tensor cores and the pairs'
epilogue on the CUDA cores sets the pace). The fp32 design is K1's, on the
loop the three kernels share (`csrc/cluster_scan.cuh`): a block of four
warps per pair tile, each warp
testing an interleaved quarter of the cluster's live slots and each lane
four pairs, so one broadcast float4 of the slab feeds 16 FMAs; the table in
the kernels' order (`visit_scan.slab_layout`, carried by the ClusterSet,
else made per call), so one TMA
bulk copy brings a tile's live slots into shared memory while the lanes
load their pairs. Before the copy the block votes on whether any of its
pairs is live: the run-padded tail of the stream (about a third of its
tiles on a bounce pass) writes the miss key or 0 without touching the
table. K is a template parameter (32, 64 or 128; any other K raises). One
CUDA kernel replaces both Pallas variants (the table resident in VMEM, or
streamed by DMA): the table stays in device memory behind the 50 MB L2.

Precision as K1's (`visit_scan`): "highest" and "high" test in float32,
"default" (the TPU's one bf16 pass) rounds the pairs' ten features and the
table to bfloat16 and forms the product on the tensor cores, with K1's
bf16 design for one visit: four warps of 32 pairs each in A fragments,
every warp walking all live slots of the tile's cluster in groups of four
triangles of the table in fragment order (`visit_scan.mma_layout`), one
mma.sync m16n8k16 per m16 tile and n8 tile, the fp32 epilogue on the
accumulators. The twin sums as the tensor cores do
(`visit_scan.mma_product`).

Not carried over: the grid of G = 8 tiles per program (S only needs to be a
multiple of 128 here), and the FR = 16 feature-row padding.

On a CPU tensor the wrapper runs `pair_scan_ref`, the plain PyTorch twin; on
a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .visit_scan import (KERNEL_K, KEY_MISS, RAY_TILE, check_scalars,
                         count_launch, is_bf16, layout_expect, mma_layout,
                         mma_product, round_bf16, slab_hits, slab_layout)

# launches of the CUDA kernel per mode, fp32 and bf16 (the CPU twin does not
# count)
LAUNCHES = {"closest": 0, "any": 0}
LAUNCHES_BF16 = {"closest": 0, "any": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BF16):
        for key in counts:
            counts[key] = 0


def pair_scan_ref(rf_pairs, feats, tile_cluster, *, k: int, k_bits: int,
                  closest: bool, layout=None, precision: str = "highest"
                  ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: one (128, 10)·(10, 4K) product per
    pair tile. Memory is (S / 128, 128, 4K) float32."""
    del layout  # only the kernel reads it
    rf = rf_pairs.reshape(-1, RAY_TILE, 12)
    rfm, product = rf[..., :10].contiguous(), torch.bmm
    if is_bf16(precision):
        rfm, feats = round_bf16(rfm), round_bf16(feats)
        product = mma_product
    hit, tb = slab_hits(rfm, feats[tile_cluster.long()],
                        rf[..., 10:11], rf[..., 11:12], k, closest, product)
    if not closest:
        return hit.any(-1).to(torch.int32).reshape(-1)
    kid = torch.arange(k, dtype=torch.int32, device=rf.device)
    key = (tb & ~((1 << k_bits) - 1)) | kid
    key = torch.where(hit, key, torch.full_like(key, KEY_MISS))
    return key.amin(-1).reshape(-1)


def pair_scan(rf_pairs, feats, tile_cluster, *, k: int, k_bits: int,
              closest: bool, layout=None, precision: str = "highest"
              ) -> torch.Tensor:
    """Run the pair scan (contract in the module docstring): (S,) int32 keys
    (closest) or occlusion bits (any). `layout`: as for
    `visit_scan.visit_scan`."""
    s = rf_pairs.shape[0]
    if s % RAY_TILE:
        raise ValueError(f"{s} pairs: not a multiple of {RAY_TILE}")
    tiles = s // RAY_TILE
    bf16 = is_bf16(precision)
    build.check_tensors(rf_pairs.device, {
        "rf_pairs": (rf_pairs, torch.float32, (s, 12)),
        "feats": (feats, torch.float32, (feats.shape[0], 10, 4 * k)),
        "tile_cluster": (tile_cluster, torch.int32, (tiles,)),
        **layout_expect(feats, k, layout, mma=bf16),
    })
    check_scalars(k, 1, k_bits, k_bits)   # one visit, no visit field
    if rf_pairs.device.type == "cpu":
        return pair_scan_ref(rf_pairs, feats, tile_cluster, k=k,
                             k_bits=k_bits, closest=closest,
                             precision=precision)
    if rf_pairs.device.type != "cuda":
        raise ValueError(f"pair_scan runs on cpu or cuda, not "
                         f"{rf_pairs.device}")
    if k not in KERNEL_K:
        raise ValueError(f"the pair scan kernel takes K in {KERNEL_K}, not "
                         f"{k}")
    fn = build.load_function(
        "pair_scan", "pair_scan_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    # made here, they are freed on return, but the caching allocator hands
    # their memory only to work queued after the kernel on this stream
    if layout is None:
        layout = mma_layout(feats, k) if bf16 else slab_layout(feats, k)
    slabs, nlive = layout
    out = torch.empty((s,), dtype=torch.int32, device=rf_pairs.device)
    build.launch(fn, rf_pairs.device, rf_pairs.data_ptr(), slabs.data_ptr(),
                 nlive.data_ptr(), tile_cluster.data_ptr(), out.data_ptr(),
                 tiles, feats.shape[0], k, k_bits, int(closest), int(bf16))
    count_launch(LAUNCHES, LAUNCHES_BF16, closest, bf16)
    return out
