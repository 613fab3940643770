"""Kernel K1: the visit scan of the tiled intersector, on Hopper.

Replaces the Pallas TPU kernel `visit_scan`
(`lumenrenderer_tpu/ops/pallas/intersect.py:325`, `_visit_scan_impl` with
its VMEM-resident and DMA-streamed variants sharing `_make_compute`). One
kernel, `csrc/visit_scan.cu`, takes the place of both: here the table stays
in device memory behind the 50 MB L2.

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

Precision (`precision`, the TPU kernel's argument): "highest" (and "high",
a bf16 three-pass split on the TPU, which the port runs as exact fp32) tests
in float32; "default", the TPU's one bf16 MXU pass, rounds the ten ray
features and the coefficient table to bfloat16 (round to nearest even) and
forms the product on the tensor cores: exact products, summed as one
m16n8k16 bf16 product sums them (`mma_product`, the model that
`ops/mma_probe.py` found to match the card bit for bit: the ten products
aligned to the largest exponent sum, cut toward zero 25 bits below it,
summed, and the sum cut toward zero to float32); t_min, t_max and the hit
test stay float32. The bf16 twin is the fp32 twin on the rounded inputs
(`round_bf16`) with `mma_product` as its product. A rounded triangle may
lie nearer than its cluster's fp32 box, so in this mode the closest vote
ends a tile only when all its lanes are dead, and the result equals a full
scan (the TPU kernel keeps its entry-t check every 4 visits and can drop
such a hit: ROADMAP C-25).

What bounds it on an H100: in fp32, FMA issue. A visit costs
live rays × live triangles × 40 FMAs = 80 flop per ray-triangle pair; at
67 TFLOP/s (fp32, no tensor cores) that is the bound, since the bytes (ray
features, visit lists, at most a 20 KB slab per visit from L2) take a small
fraction of it at 3.35 TB/s. In bf16 the product goes to the tensor cores
(989 TFLOP/s dense), and the epilogue that every pair still runs on the
CUDA cores (the sign flip, six compares, the key) sets the pace.

The fp32 design (details in the source): a block of four warps per tile,
each warp testing an interleaved quarter of the cluster's triangles and
each lane 4 rays, so one broadcast float4 of the slab feeds 16 FMAs; only
the live slots of each cluster (`slab_layout`'s `nlive`) are copied and
tested; signs normalised by XOR with det's sign bit, t by one exact
division for hits only; K a template parameter (32, 64 or 128; any other K
raises); the slab table in the kernel's order (`slab_layout`, made once
per build or refit and carried by the ClusterSet, else per call) so that a
visit's slab is one contiguous block, copied by one TMA
bulk copy into one of two shared buffers while the previous visit is
tested; a conservative block-wide vote before every visit
(`__syncthreads_and`) that ends the tile when no live ray can still
improve (bf16 closest: when all its lanes are dead), so the result equals
a full scan. An optional int32 counter
receives the visits each tile ran; `executed_visits_ref` replays the same
vote from the twin.

The bf16 design: four warps per tile, warp w owning rays 32w ... 32w + 31
(two m16 tiles) in A fragments of their rounded features, made once; every
warp walks all live slots of each visit's cluster in groups of four
triangles, each group two n8 tiles (mma.sync m16n8k16, the ten features
padded to one k-step of 16) whose columns interleave (det, u) and (v, t),
so that each lane finds one triangle's four quantities for four rays in
its own accumulators and runs the fp32 epilogue on them; the table in
fragment order (`mma_layout`, 128 bytes a triangle, made at the first bf16
query of a ClusterSet and kept on it), one TMA bulk copy a visit; each quad
of lanes folds its keys (bits) with two shuffles.

Not carried over: the (T/8, 8, 128) output blocks and 8-tile padding (a TPU
layout; this returns (T, 128)), the feature-row padding to 16 (the fp32
mode's; the bf16 mode pads to 16 in its k-step), and the unused `tri_id`
argument.

On a CPU tensor the wrapper runs `visit_scan_ref`, the plain PyTorch twin; on
a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

KEY_MISS = 0x7F000000
RAY_TILE = 128
KERNEL_K = (32, 64, 128)     # cluster sizes the kernel is built for
PRECISIONS = {"highest": False, "high": False, "default": True}  # -> bf16
# launches of the CUDA kernel per mode, fp32 and bf16 (the CPU twin does not
# count)
LAUNCHES = {"closest": 0, "any": 0}
LAUNCHES_BF16 = {"closest": 0, "any": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BF16):
        for key in counts:
            counts[key] = 0


def is_bf16(precision: str) -> bool:
    """Whether `precision` ("highest", "high" or "default") is the bf16
    mode (shared by K1, K2 and K3); raise ValueError on another."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in "
                         f"{tuple(PRECISIONS)}")
    return PRECISIONS[precision]


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def count_launch(counts_fp32: dict, counts_bf16: dict, closest: bool,
                 bf16: bool) -> None:
    (counts_bf16 if bf16 else counts_fp32)[
        "closest" if closest else "any"] += 1


def ordered_product(rf, slab):
    """rf (T,128,10) times slab (T,10,4K), summed over the ten features in
    order as a chain of float32 fused multiply-adds from +0 would sum them
    (each product of two bfloat16 values is exact in float32). The
    tensor-core probe's "chain" model (`ops/mma_probe.py`), which the card
    does not follow."""
    res = rf[..., 0:1] * slab[:, 0:1] + 0.0     # the chain starts at +0
    for f in range(1, rf.shape[-1]):
        res = res + rf[..., f:f + 1] * slab[:, f:f + 1]
    return res


# How one m16n8k16 bf16 product of the tensor cores sums its terms from a
# zero accumulator (`mma_product`): the k slots in blocks of `block`, the
# block's exact products and the running sum aligned to the largest
# exponent (`align`: "sum", the exponent of 1.x times 1.x, or "norm", the
# product's own), each cut to `frac_bits` bits below it (`term`: "rz"
# toward zero, "rd" toward -inf), their integer sum rounded to float32
# (`final`: "rn" nearest even, "rz" toward zero).
MMA_MODEL = {"block": 16, "align": "sum", "frac_bits": 25, "term": "rz",
             "final": "rz"}


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e exactly as float64, for integer e in [-1022, 1023]."""
    return ((e.long() + 1023) << 52).view(torch.float64)


def _round_f32(x: torch.Tensor, final: str) -> torch.Tensor:
    """float64 x to float32, to nearest even or toward zero."""
    f = x.float()
    if final == "rz":
        over = f.double().abs() > x.abs()
        f = torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)
    return f


def mma_product(rf, slab, model=None):
    """rf (T,M,F) times slab (T,F,N), both bfloat16 values in float32, with
    feature f in k slot f of m16n8k16 tensor-core products (F <= 16; the
    kernels' F = 10, slots 10-15 zero), summed as `model` (MMA_MODEL, the
    card's, by default) says: exactly, in float64 holding integers of at
    most 53 bits, then rounded once a block. The bf16 twins' product."""
    m = MMA_MODEL if model is None else model
    nf = rf.shape[-1]
    none, valid = -(1 << 20), -(1 << 19)      # a zero's exponent
    ea = torch.where(rf != 0, torch.frexp(rf)[1] - 1, none)   # of 1.x
    eb = torch.where(slab != 0, torch.frexp(slab)[1] - 1, none)
    rf, slab = rf.double(), slab.double()
    acc = torch.zeros(rf.shape[:-1] + slab.shape[-1:], dtype=torch.float64,
                      device=rf.device)
    cut = torch.trunc if m["term"] == "rz" else torch.floor
    for lo in range(0, nf, m["block"]):
        fs = range(lo, min(nf, lo + m["block"]))
        lead = torch.where(acc != 0, torch.frexp(acc)[1] - 1, none)
        for f in fs:
            if m["align"] == "sum":
                e = ea[..., f:f + 1] + eb[:, f:f + 1]
            else:
                p = rf[..., f:f + 1] * slab[:, f:f + 1]
                e = torch.where(p != 0, torch.frexp(p)[1] - 1, none)
            lead = torch.maximum(lead, e)
        q = torch.where(lead > valid, lead - m["frac_bits"], 0)
        scale = _pow2(-q)
        s = cut(acc * scale)
        for f in fs:
            s += cut((rf[..., f:f + 1] * slab[:, f:f + 1]).mul_(scale))
        acc = _round_f32(s.mul_(_pow2(q)), m["final"]).double()
    return acc.float()


def slab_hits(rf, slab, tmin, tmax, k: int, closest: bool,
              product=torch.bmm):
    """The kernels' test (`test_rays` in csrc/cluster_scan.cuh, shared by
    K1, K2 and K3) of ray features rf (T,128,10) against one
    coefficient slab per tile (T,10,4K) within [tmin, tmax] (T,128,1), the
    product formed by `product`: hit (T,128,K) bool and, in closest mode,
    t's float bits (T,128,K) int32 (else None)."""
    res = product(rf, slab)                                 # (T, 128, 4K)
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


def _running_ref(rays, feats, sel, nv, tmin, tmax, dead, *, k: int,
                 k_bits: int, low_bits: int, closest: bool,
                 product=torch.bmm):
    """Yield the twin's running (T,128) state before visit 0 and after each
    visit i < max(nv): the minimum key so far (closest, KEY_MISS for none)
    or the OR of hits so far (any, bool, dead lanes True)."""
    tiles = sel.shape[0]
    dev = sel.device
    kid = torch.arange(k, dtype=torch.int32, device=dev)
    low_mask = ~((1 << low_bits) - 1)
    state = (torch.full((tiles, RAY_TILE), KEY_MISS, dtype=torch.int32,
                        device=dev) if closest else dead.clone())
    yield state
    for i in range(int(nv.max()) if tiles else 0):
        hit, tb = slab_hits(rays(i), feats[sel[:, i].long()], tmin, tmax, k,
                            closest, product)
        hit &= (i < nv)[:, None, None]
        if closest:
            key = (tb & low_mask) | (i << k_bits) | kid
            key = torch.where(hit, key, torch.full_like(key, KEY_MISS))
            state = torch.minimum(state, key.amin(-1))
        else:
            state = state | hit.any(-1)
        yield state


def scan_visits_ref(rays, feats, sel, nv, tmin, tmax, dead, *, k: int,
                    k_bits: int, low_bits: int, closest: bool,
                    product=torch.bmm) -> torch.Tensor:
    """Plain twin of the kernels' visit loop without its early-out, which is
    conservative, so the results are equal. `rays(i)` gives the (T,128,10)
    features of visit i. Runs every tile for max(nv) visits; memory is
    (T,128,4K) float32 per visit."""
    for state in _running_ref(rays, feats, sel, nv, tmin, tmax, dead, k=k,
                              k_bits=k_bits, low_bits=low_bits,
                              closest=closest, product=product):
        pass
    if closest:
        return torch.where(dead, torch.zeros_like(state), state)
    return state.to(torch.int32)


def replay_visits_ref(rays, feats, sel, nv, tnb, tmin, tmax, dead, *, k: int,
                      mv: int, k_bits: int, low_bits: int, closest: bool,
                      product=torch.bmm, bf16: bool = False) -> torch.Tensor:
    """The number of visits each tile runs under the kernels' block-wide
    vote, replayed from the twin's running state: (T,) int32. Before visit i
    (i < min(nv, mv)) the tile stops when every lane is dead or, closest,
    holds a key whose t field lies below that of the entry t `tnb[:, i]`
    (later visits start no nearer; not in the bf16 mode, whose rounded
    triangles may lie nearer than their cluster's box), or, any, is
    occluded."""
    n = nv.clamp_max(mv)
    if closest and bf16:             # only dead lanes end a tile
        return torch.where(dead.all(1), 0, n).to(torch.int32)
    ran = n.clone()
    stopped = torch.zeros_like(n, dtype=torch.bool)
    states = _running_ref(rays, feats, sel, nv, tmin, tmax, dead, k=k,
                          k_bits=k_bits, low_bits=low_bits, closest=closest,
                          product=product)
    for i, state in enumerate(states):
        if closest and bf16:
            done = dead.all(1)
        elif closest:
            nxt = tnb[:, min(i, mv - 1)] >> low_bits
            done = (dead | ((state >> low_bits) < nxt[:, None])).all(1)
        else:
            done = state.all(1)
        stop = done & ~stopped & (i < n)
        ran = torch.where(stop, i, ran)
        stopped |= stop
    return ran.to(torch.int32)


def _mode_inputs(rf_t, feats, precision: str):
    """The ray features (T,128,10), the table and the product the mode
    tests them with."""
    if is_bf16(precision):
        return round_bf16(rf_t[..., :10]), round_bf16(feats), mma_product
    return rf_t[..., :10], feats, torch.bmm


def visit_scan_ref(rf_t, feats, sel, nv, tnb, *, k: int, mv: int,
                   k_bits: int, low_bits: int, closest: bool, layout=None,
                   precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch twin of the kernel (same contract, no early-out)."""
    del tnb, mv, layout  # only the kernel reads them
    rfm, feats, product = _mode_inputs(rf_t, feats, precision)
    return scan_visits_ref(lambda i: rfm, feats, sel, nv, rf_t[..., 10:11],
                           rf_t[..., 11:12], rf_t[..., 11] < rf_t[..., 10],
                           k=k, k_bits=k_bits, low_bits=low_bits,
                           closest=closest, product=product)


def executed_visits_ref(rf_t, feats, sel, nv, tnb, *, k: int, mv: int,
                        k_bits: int, low_bits: int, closest: bool,
                        precision: str = "highest") -> torch.Tensor:
    """Plain twin of the kernel's visit counter: (T,) int32 visits each tile
    runs (`replay_visits_ref` with the tile's fixed rays)."""
    rfm, feats, product = _mode_inputs(rf_t, feats, precision)
    return replay_visits_ref(lambda i: rfm, feats, sel, nv, tnb,
                             rf_t[..., 10:11], rf_t[..., 11:12],
                             rf_t[..., 11] < rf_t[..., 10], k=k, mv=mv,
                             k_bits=k_bits, low_bits=low_bits,
                             closest=closest, product=product,
                             bf16=is_bf16(precision))


def slab_layout(feats: torch.Tensor, k: int):
    """The kernel's order of the coefficient table and its live slots:
    (slabs (C,K,10,4), nlive (C,) int32). Global (f, q·K + j) goes to
    ((j·10 + f)·4 + q), so that each cluster's slab is one contiguous block
    of K·10 quadruples (triangle j's ten (det, u, v, t) in a row).
    nlive is one past the cluster's last slot with a nonzero coefficient
    (at least 1): the slots after it are padding, which never hits."""
    c = feats.shape[0]
    slabs = feats.view(c, 10, 4, k).permute(0, 3, 1, 2).contiguous()
    slot = torch.arange(1, k + 1, dtype=torch.int32, device=feats.device)
    nz = slabs.view(c, k, 40).ne(0).any(-1)
    nlive = (nz * slot).amax(-1).clamp_min(1) if c else slot[:0]
    return slabs, nlive.to(torch.int32)


def mma_layout(feats: torch.Tensor, k: int):
    """The bf16 kernels' table in tensor-core fragment order (K1-K3):
    (frags (C,K/4,32,8) bfloat16, nlive (C,) int32). Group j of a cluster
    holds triangles 4j ... 4j + 3 as two n8 tiles of B (k = feature, slots
    10-15 zero): column n of tile h is quantity 2h + n % 2 of [det|u|v|t]
    of triangle 4j + n // 2. Lane 4g + q's 8 values are its fragments of
    tile 0 then tile 1: rows 2q, 2q + 1, 2q + 8, 2q + 9 of column g. nlive
    is `slab_layout`'s of the rounded table, rounded up to a multiple of
    4: the padding slots it takes in have det = 0 and fail the test."""
    if k % 4:
        raise ValueError(f"mma_layout needs K divisible by 4, not {k}")
    c = feats.shape[0]
    dev = feats.device
    nlive = slab_layout(round_bf16(feats), k)[1]
    nlive = ((nlive + 3) // 4 * 4).clamp_max(k).to(torch.int32)
    table = torch.zeros((c, 16, 4 * k), dtype=torch.bfloat16, device=dev)
    table[:, :10] = feats.to(torch.bfloat16)
    lane = torch.arange(32, device=dev)
    g, q = lane // 4, lane % 4
    rows = torch.stack([2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9], -1)
    qty = 2 * torch.arange(2, device=dev)[None] + (g % 2)[:, None]
    tri = (4 * torch.arange(k // 4, device=dev)[:, None]
           + (g // 2)[None])                                  # (K/4, 32)
    cols = qty[None, :, :, None] * k + tri[:, :, None, None]  # (K/4,32,2,1)
    frags = table[:, rows[None, :, None, :], cols]        # (C,K/4,32,2,4)
    return frags.reshape(c, k // 4, 32, 8).contiguous(), nlive


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


def layout_expect(feats, k: int, layout, mma: bool = False) -> dict:
    """check_tensors entries of a (slabs, nlive) layout of `feats`, if any
    (shared by K1, K2 and K3): the fp32 mode's `slab_layout`, or with
    `mma` the bf16 mode's `mma_layout`."""
    if layout is None:
        return {}
    c = feats.shape[0]
    if mma:
        slabs = (layout[0], torch.bfloat16, (c, k // 4, 32, 8))
    else:
        slabs = (layout[0], torch.float32, (c, k, 10, 4))
    return {"slabs": slabs, "nlive": (layout[1], torch.int32, (c,))}


def _check(rf_t, feats, sel, nv, tnb, k, mv, k_bits, low_bits, visits,
           layout, bf16):
    tiles = rf_t.shape[0]
    expect = {
        "rf_t": (rf_t, torch.float32, (tiles, RAY_TILE, 12)),
        "feats": (feats, torch.float32, (feats.shape[0], 10, 4 * k)),
        "sel": (sel, torch.int32, (tiles, mv)),
        "nv": (nv, torch.int32, (tiles,)),
        "tnb": (tnb, torch.int32, (tiles, mv)),
        **layout_expect(feats, k, layout, mma=bf16),
    }
    if visits is not None:
        expect["visits"] = (visits, torch.int32, (tiles,))
    build.check_tensors(rf_t.device, expect)
    check_scalars(k, mv, k_bits, low_bits)


def visit_scan(rf_t, feats, sel, nv, tnb, *, k: int, mv: int, k_bits: int,
               low_bits: int, closest: bool, visits=None, layout=None,
               precision: str = "highest") -> torch.Tensor:
    """Run the visit scan (contract in the module docstring): (T, 128) int32
    keys (closest) or occlusion bits (any). `visits`, an int32 (T,) tensor,
    receives the number of visits each tile ran (on the CPU, from
    `executed_visits_ref`). `layout`, the (slabs, nlive) of `feats` from
    `slab_layout` (fp32) or `mma_layout` (bf16) (a ClusterSet carries the
    fp32 one and keeps the bf16 one from its first bf16 query), spares the
    kernel path laying the table out on every call."""
    bf16 = is_bf16(precision)
    _check(rf_t, feats, sel, nv, tnb, k, mv, k_bits, low_bits, visits,
           layout, bf16)
    kw = dict(k=k, mv=mv, k_bits=k_bits, low_bits=low_bits, closest=closest,
              precision=precision)
    if rf_t.device.type == "cpu":
        if visits is not None:
            visits.copy_(executed_visits_ref(rf_t, feats, sel, nv, tnb, **kw))
        return visit_scan_ref(rf_t, feats, sel, nv, tnb, **kw)
    if rf_t.device.type != "cuda":
        raise ValueError(f"visit_scan runs on cpu or cuda, not {rf_t.device}")
    if k not in KERNEL_K:
        raise ValueError(f"the visit scan kernel takes K in {KERNEL_K}, not "
                         f"{k}")
    fn = build.load_function("visit_scan", "visit_scan_launch",
                             [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                             + [ctypes.c_void_p])
    tiles = rf_t.shape[0]
    # made here, they are freed on return, but the caching allocator hands
    # their memory only to work queued after the kernel on this stream
    if layout is None:
        layout = mma_layout(feats, k) if bf16 else slab_layout(feats, k)
    slabs, nlive = layout
    out = torch.empty((tiles, RAY_TILE), dtype=torch.int32,
                      device=rf_t.device)
    build.launch(fn, rf_t.device, rf_t.data_ptr(), slabs.data_ptr(),
                 nlive.data_ptr(), sel.data_ptr(), nv.data_ptr(),
                 tnb.data_ptr(), out.data_ptr(),
                 None if visits is None else visits.data_ptr(), tiles,
                 feats.shape[0], k, mv, k_bits, low_bits, int(closest),
                 int(bf16))
    count_launch(LAUNCHES, LAUNCHES_BF16, closest, bf16)
    return out
