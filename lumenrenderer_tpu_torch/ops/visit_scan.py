"""Kernel K1: the visit scan of the tiled intersector, on Hopper.

Replaces the Pallas TPU kernel `visit_scan` (`_visit_scan_impl`, with its
VMEM-resident and DMA-streamed variants sharing `_make_compute`) in
`lumenrenderer_tpu/ops/pallas/intersect.py`.

Contract. Rays come in tiles of 128. For tile t the caller gives its visit
list: `nv[t]` clusters `sel[t, :nv[t]]`, ordered by conservative entry t whose
float bits are `tnb[t, i]`. For each visit, each ray runs the Möller–Trumbore
test against the cluster's K triangles as the bilinear product
f (10) · tri_feat (10, 4K) -> det, u·det, v·det, t·det, with the hit test
|det| > 1e-12, u >= 0, v >= 0, u+v <= |det|, tmin·|det| < t <= tmax·|det|
(signs normalised by det). Closest mode returns per ray the minimum packed
key `(t_bits & ~low_mask) | (visit << k_bits) | slot`, 0x7F000000 for a
miss; any mode returns 1 where any triangle hits. Dead lanes (tmax < tmin)
return 0 in closest mode and 1 in any mode; callers mask them.

What bounds it on an H100. Each tile visit is 128 rays x K triangles x 40
fp32 FMAs plus the test: about 1 MFLOP per visit at K = 128, on a 20 KB
coefficient slab read from L2 (the whole table, 2.75 MB for the interior
scene, stays in the 50 MB L2). So it is bound by fp32 issue and by shared
memory reads, not by device memory. The design: one block per tile and one
thread per ray, so a ray's running key stays in a register; the slab is
loaded once per visit into shared memory, transposed so that every thread
reads the same float4 (a broadcast, no bank conflicts) for 4 FMAs; t is
formed only for hits, by one exact division. The early-out is a block-wide
vote (`__syncthreads_and`) after every visit: it is conservative, so the
result equals a full scan, as on the TPU where it ran every 4 visits. One
kernel replaces both Pallas variants: the TPU streamed the table when it did
not fit VMEM, while here the table stays in device memory behind L2.

Not carried over: the (T/8, 8, 128) output blocks and 8-tile padding (a TPU
layout; this returns (T, 128)), the feature-row padding to 16, and the
unused `tri_id` argument.

On a CPU tensor the wrapper runs `visit_scan_ref`, the plain PyTorch twin; on
a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

KEY_MISS = 0x7F000000
RAY_TILE = 128
# launches of the CUDA kernel per mode (the CPU twin does not count)
LAUNCHES = {"closest": 0, "any": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def slab_hits(rf, slab, tmin, tmax, k: int, closest: bool):
    """The kernels' test (`test_slab` in csrc/cluster_scan.cuh) of ray
    features rf (T,128,10) against one coefficient slab per tile
    (T,10,4K) within [tmin, tmax] (T,128,1): hit (T,128,K) bool and, in
    closest mode, t's float bits (T,128,K) int32 (else None)."""
    res = torch.bmm(rf, slab)                               # (T, 128, 4K)
    det, un, vn, tn = res.split(k, dim=-1)
    s = torch.sign(det)
    ad = det * s
    us, vs, ts = un * s, vn * s, tn * s
    hit = ((ad > 1e-12) & (us >= 0.0) & (vs >= 0.0) & (us + vs <= ad)
           & (ts > tmin * ad) & (ts <= tmax * ad))
    if not closest:
        return hit, None
    ad_safe = torch.where(ad > 1e-12, ad, torch.ones_like(ad))
    return hit, (ts / ad_safe).clamp_min(0.0).view(torch.int32)


def scan_visits_ref(rays, feats, sel, nv, tmin, tmax, dead, *, k: int,
                    k_bits: int, low_bits: int, closest: bool
                    ) -> torch.Tensor:
    """Plain twin of the kernels' visit loop (`scan_visits` in
    csrc/cluster_scan.cuh) without its early-out, which is conservative, so
    the results are equal. `rays(i)` gives the (T,128,10) features of visit
    i. Runs every tile for max(nv) visits; memory is (T,128,4K) float32 per
    visit."""
    tiles = sel.shape[0]
    dev = sel.device
    kid = torch.arange(k, dtype=torch.int32, device=dev)
    low_mask = ~((1 << low_bits) - 1)
    best = torch.full((tiles, RAY_TILE), KEY_MISS, dtype=torch.int32,
                      device=dev)
    occ = dead.clone()
    n_max = int(nv.max()) if tiles else 0
    for i in range(n_max):
        hit, tb = slab_hits(rays(i), feats[sel[:, i].long()], tmin, tmax, k,
                            closest)
        hit &= (i < nv)[:, None, None]
        if closest:
            key = (tb & low_mask) | (i << k_bits) | kid
            key = torch.where(hit, key, torch.full_like(key, KEY_MISS))
            best = torch.minimum(best, key.amin(-1))
        else:
            occ |= hit.any(-1)
    if closest:
        return torch.where(dead, torch.zeros_like(best), best)
    return occ.to(torch.int32)


def visit_scan_ref(rf_t, feats, sel, nv, tnb, *, k: int, mv: int,
                   k_bits: int, low_bits: int, closest: bool
                   ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (same contract, no early-out)."""
    del tnb, mv  # only the kernel's early-out reads them
    rfm = rf_t[..., :10]
    return scan_visits_ref(lambda i: rfm, feats, sel, nv, rf_t[..., 10:11],
                           rf_t[..., 11:12], rf_t[..., 11] < rf_t[..., 10],
                           k=k, k_bits=k_bits, low_bits=low_bits,
                           closest=closest)


def check_scalars(k: int, mv: int, k_bits: int, low_bits: int) -> None:
    """Raise ValueError on a visit count, key layout or cluster size the
    kernels do not take (shared by K1, K2 and K3)."""
    if not 1 <= mv <= 128:
        raise ValueError(f"mv={mv} outside 1..128")
    if (k - 1).bit_length() > k_bits or (mv - 1).bit_length() + k_bits > low_bits:
        raise ValueError(f"key fields too narrow: {k=} {mv=} {k_bits=} "
                         f"{low_bits=}")
    if low_bits > 15:
        raise ValueError(f"packed-key layout overflow: {low_bits=} > 15")
    if 10 * 4 * k * 4 > build.MAX_STATIC_SMEM:
        raise ValueError(f"cluster size {k} needs more than 48 KB of shared "
                         "memory")


def _check(rf_t, feats, sel, nv, tnb, k, mv, k_bits, low_bits):
    tiles = rf_t.shape[0]
    build.check_tensors(rf_t.device, {
        "rf_t": (rf_t, torch.float32, (tiles, RAY_TILE, 12)),
        "feats": (feats, torch.float32, (feats.shape[0], 10, 4 * k)),
        "sel": (sel, torch.int32, (tiles, mv)),
        "nv": (nv, torch.int32, (tiles,)),
        "tnb": (tnb, torch.int32, (tiles, mv)),
    })
    check_scalars(k, mv, k_bits, low_bits)


def visit_scan(rf_t, feats, sel, nv, tnb, *, k: int, mv: int, k_bits: int,
               low_bits: int, closest: bool) -> torch.Tensor:
    """Run the visit scan (contract in the module docstring): (T, 128) int32
    keys (closest) or occlusion bits (any)."""
    _check(rf_t, feats, sel, nv, tnb, k, mv, k_bits, low_bits)
    if rf_t.device.type == "cpu":
        return visit_scan_ref(rf_t, feats, sel, nv, tnb, k=k, mv=mv,
                              k_bits=k_bits, low_bits=low_bits,
                              closest=closest)
    if rf_t.device.type != "cuda":
        raise ValueError(f"visit_scan runs on cpu or cuda, not {rf_t.device}")
    fn = build.load_function("visit_scan", "visit_scan_launch",
                             [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                             + [ctypes.c_void_p])
    tiles = rf_t.shape[0]
    out = torch.empty((tiles, RAY_TILE), dtype=torch.int32,
                      device=rf_t.device)
    build.launch(fn, rf_t.device, rf_t.data_ptr(), feats.data_ptr(),
                 sel.data_ptr(), nv.data_ptr(), tnb.data_ptr(),
                 out.data_ptr(), tiles, feats.shape[0], k, mv, k_bits,
                 low_bits, int(closest))
    LAUNCHES["closest" if closest else "any"] += 1
    return out
