"""Kernel K2: the instanced visit scan of the two-level intersector, on Hopper.

Replaces the Pallas TPU kernel `visit_scan_instanced` (`_make_kernel`) in
`lumenrenderer_tpu/ops/pallas/instanced.py`.

Contract (as the JAX kernel's, with its input layouts). Rays come in tiles of
128: `rayblk (T, 8, 128)` holds the tile's world rays transposed (rows o, d,
then two of padding) and `wnd (T, 128, 8)` their windows (cols t_min, t_max,
then padding); t_max < t_min marks a dead lane. Tile t visits `nv[t]`
(instance, cluster) units in order of conservative world entry t (bits
`tnb[t, i]`): for visit i, `sel_cl[t, i]` is the cluster of the object-space
table `feats (C, 10, 4K)` and `minv12[t, i]` the instance's world->object
3x4 affine, row-major. Each visit maps the rays into object space,
O = M·o + m, D = M·d, in the order of `instanced.py:81-89`; the map keeps the
ray's world t, so the window test and the key are K1's (`ops/visit_scan.py`):
closest mode returns the minimum key `(t_bits & ~low_mask) | (visit <<
k_bits) | slot`, 0x7F000000 for a miss, any mode 1 where any triangle hits.
Dead lanes return 0 in closest mode and 1 in any mode.

What bounds it on an H100: K1's slab test (fp32 issue, the table behind
L2), plus per visit 12 affine floats and about 30 flops per ray for the
affine and the cross product. The fp32 design is K1's, on the loop the
three kernels share (`csrc/cluster_scan.cuh`): four warps per tile, each on
an interleaved quarter of the unit's live slots (`visit_scan.slab_layout`,
carried by the InstancedClusterSet, else made per call; 12 of 128 for a
box), each lane holding four rays' world origin
and direction; per visit
one TMA bulk copy brings the unit's live slots and its affine into one of
two shared buffers while the previous visit is tested, and each lane forms
its rays' object-space features from the affine (a broadcast). The affine
and the cross product use round-to-nearest intrinsics in the twin's order,
so the features equal the twin's bit for bit and only the slab product's
summation order could differ, as in K1. t is formed by one exact division,
where the TPU used an approximate reciprocal and a Newton step. K1's vote
runs before every visit; an optional int32 counter receives the visits each
tile ran, and `executed_visits_instanced_ref` replays the same vote from
the twin. K is a template parameter (32, 64 or 128; any other K raises).

Precision as K1's (`visit_scan`): "highest" and "high" test in float32;
"default" (the TPU's one bf16 pass) forms each visit's ten features in
float32, rounds them to bfloat16, and tests them against the bfloat16
table in fragment order (`mma_layout`) on the tensor cores: exact products
summed as one m16n8k16 product sums them (`mma_product`, as K1's twin),
and K1's bf16 vote. Its own kernel does it: K1's tensor-core loop, whose A
fragments K2 forms per visit, each quad of lanes forming its four rays'
features once (lane q ray q) and trading the bf16 words by shuffles.

Not carried over: the T % 8 padding and (T/8, 8, 128) blocks, the FR = 16
feature-row padding, and the `RESIDENT_BYTES` limit (a VMEM limit; here the
table stays in device memory behind L2).

On a CPU tensor the wrapper runs `visit_scan_instanced_ref`, the plain
PyTorch twin; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .visit_scan import (KERNEL_K, RAY_TILE, check_scalars, count_launch,
                         is_bf16, layout_expect, mma_layout, mma_product,
                         replay_visits_ref, round_bf16, scan_visits_ref,
                         slab_layout)

# launches of the CUDA kernel per mode, fp32 and bf16 (the CPU twin does not
# count)
LAUNCHES = {"closest": 0, "any": 0}
LAUNCHES_BF16 = {"closest": 0, "any": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BF16):
        for key in counts:
            counts[key] = 0


def object_space_features(rayblk: torch.Tensor, m: torch.Tensor
                          ) -> torch.Tensor:
    """(T, 128, 10) features [O×D, D, O, 1] of the rays `rayblk (T, 8, 128)`
    under the per-tile affines `m (T, 12)`, each product and sum rounded in
    the kernel's order."""
    ox, oy, oz, dx, dy, dz = (rayblk[:, f] for f in range(6))
    c = [m[:, j:j + 1] for j in range(12)]
    oox = c[0] * ox + c[1] * oy + c[2] * oz + c[3]
    ooy = c[4] * ox + c[5] * oy + c[6] * oz + c[7]
    ooz = c[8] * ox + c[9] * oy + c[10] * oz + c[11]
    ddx = c[0] * dx + c[1] * dy + c[2] * dz
    ddy = c[4] * dx + c[5] * dy + c[6] * dz
    ddz = c[8] * dx + c[9] * dy + c[10] * dz
    mx = ooy * ddz - ooz * ddy
    my = ooz * ddx - oox * ddz
    mz = oox * ddy - ooy * ddx
    return torch.stack([mx, my, mz, ddx, ddy, ddz, oox, ooy, ooz,
                        torch.ones_like(oox)], dim=-1)


def _mode_rays(rayblk, minv12, feats, precision: str) -> dict:
    """The mode's rays(i) (visit i's features, rounded to bfloat16 after
    they are formed in the bf16 mode), table and product (`visit_scan`'s
    `_mode_inputs`)."""
    if is_bf16(precision):
        return {"rays": lambda i: round_bf16(object_space_features(
            rayblk, minv12[:, i])), "feats": round_bf16(feats),
            "product": mma_product}
    return {"rays": lambda i: object_space_features(rayblk, minv12[:, i]),
            "feats": feats, "product": torch.bmm}


def visit_scan_instanced_ref(rayblk, wnd, feats, sel_cl, minv12, nv, tnb, *,
                             k: int, mv: int, k_bits: int, low_bits: int,
                             closest: bool, layout=None,
                             precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch twin of the kernel (same contract, no early-out): K1's
    twin loop with the object-space features of each visit."""
    del tnb, mv, layout  # only the kernel reads them
    mode = _mode_rays(rayblk, minv12, feats, precision)
    return scan_visits_ref(mode["rays"], mode["feats"], sel_cl, nv,
                           wnd[..., 0:1], wnd[..., 1:2],
                           wnd[..., 1] < wnd[..., 0], k=k, k_bits=k_bits,
                           low_bits=low_bits, closest=closest,
                           product=mode["product"])


def executed_visits_instanced_ref(rayblk, wnd, feats, sel_cl, minv12, nv,
                                  tnb, *, k: int, mv: int, k_bits: int,
                                  low_bits: int, closest: bool,
                                  precision: str = "highest"
                                  ) -> torch.Tensor:
    """Plain twin of the kernel's visit counter: (T,) int32 visits each
    tile runs under the kernel's vote before every visit, replayed from the
    twin (`replay_visits_ref` with each visit's object-space features); a
    tile whose lanes are all dead runs none."""
    mode = _mode_rays(rayblk, minv12, feats, precision)
    return replay_visits_ref(
        mode["rays"], mode["feats"], sel_cl, nv, tnb, wnd[..., 0:1],
        wnd[..., 1:2], wnd[..., 1] < wnd[..., 0], k=k, mv=mv, k_bits=k_bits,
        low_bits=low_bits, closest=closest, product=mode["product"],
        bf16=is_bf16(precision))


def visit_scan_instanced(rayblk, wnd, feats, sel_cl, minv12, nv, tnb, *,
                         k: int, mv: int, k_bits: int, low_bits: int,
                         closest: bool, visits=None, layout=None,
                         precision: str = "highest") -> torch.Tensor:
    """Run the instanced visit scan (contract in the module docstring):
    (T, 128) int32 keys (closest) or occlusion bits (any). `visits`, an
    int32 (T,) tensor, receives the number of visits each tile ran (on the
    CPU, from `executed_visits_instanced_ref`). `layout`: as for
    `visit_scan.visit_scan` (the InstancedClusterSet carries the fp32 one
    and keeps the bf16 one from its first bf16 query)."""
    tiles = rayblk.shape[0]
    bf16 = is_bf16(precision)
    expect = {
        "rayblk": (rayblk, torch.float32, (tiles, 8, RAY_TILE)),
        "wnd": (wnd, torch.float32, (tiles, RAY_TILE, 8)),
        "feats": (feats, torch.float32, (feats.shape[0], 10, 4 * k)),
        "sel_cl": (sel_cl, torch.int32, (tiles, mv)),
        "minv12": (minv12, torch.float32, (tiles, mv, 12)),
        "nv": (nv, torch.int32, (tiles,)),
        "tnb": (tnb, torch.int32, (tiles, mv)),
        **layout_expect(feats, k, layout, mma=bf16),
    }
    if visits is not None:
        expect["visits"] = (visits, torch.int32, (tiles,))
    build.check_tensors(rayblk.device, expect)
    check_scalars(k, mv, k_bits, low_bits)
    args = (rayblk, wnd, feats, sel_cl, minv12, nv, tnb)
    kw = dict(k=k, mv=mv, k_bits=k_bits, low_bits=low_bits, closest=closest,
              precision=precision)
    if rayblk.device.type == "cpu":
        if visits is not None:
            visits.copy_(executed_visits_instanced_ref(*args, **kw))
        return visit_scan_instanced_ref(*args, **kw)
    if rayblk.device.type != "cuda":
        raise ValueError(f"visit_scan_instanced runs on cpu or cuda, not "
                         f"{rayblk.device}")
    if k not in KERNEL_K:
        raise ValueError(f"the instanced visit scan kernel takes K in "
                         f"{KERNEL_K}, not {k}")
    if minv12.data_ptr() % 16:
        raise ValueError("minv12 must be 16-byte aligned (TMA bulk copy)")
    fn = build.load_function(
        "visit_scan_instanced", "visit_scan_instanced_launch",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    # made here, they are freed on return, but the caching allocator hands
    # their memory only to work queued after the kernel on this stream
    if layout is None:
        layout = mma_layout(feats, k) if bf16 else slab_layout(feats, k)
    slabs, nlive = layout
    out = torch.empty((tiles, RAY_TILE), dtype=torch.int32,
                      device=rayblk.device)
    build.launch(fn, rayblk.device, rayblk.data_ptr(), wnd.data_ptr(),
                 slabs.data_ptr(), nlive.data_ptr(), sel_cl.data_ptr(),
                 minv12.data_ptr(), nv.data_ptr(), tnb.data_ptr(),
                 out.data_ptr(), None if visits is None else visits.data_ptr(),
                 tiles, feats.shape[0], k, mv, k_bits, low_bits, int(closest),
                 int(bf16))
    count_launch(LAUNCHES, LAUNCHES_BF16, closest, bf16)
    return out
