"""Host-side binned-SAH builder (numpy) and the triangle BVH built with it.

Port of `build_sah_arrays`, `build_sah_boxes` and `build_sah` from
`lumenrenderer_tpu/accel/sah.py`, line for line: the same splits give the same
leaf order. Binned SAH (16 bins, largest centroid axis, object-median
fallback) with an iterative DFS. The clusters of `accel/stream.py` always
use this numpy builder; `build_sah` (the BVH accels) tries the native
builder first, as the JAX package does, whose partition may differ
(ROADMAP C-8).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .format import BVH, make_bvh

_log = logging.getLogger(__name__)

_NBINS = 16


def build_sah_arrays(tri_pos: np.ndarray, leaf_size: int = 4):
    """Pure-numpy binned SAH over triangles. Returns (node_lo, node_hi,
    child0, child1, order (S,), max_depth) where order holds original tri
    ids per leaf slot (-1 padding) and child0<0 encodes leaf index."""
    return build_sah_boxes(
        tri_pos.min(axis=1), tri_pos.max(axis=1), leaf_size
    )


def build_sah_boxes(lo_t: np.ndarray, hi_t: np.ndarray, leaf_size: int = 4):
    """Binned SAH over arbitrary AABBs (used for the triangle BVH and for
    the second-level tree over pair-stream clusters)."""
    t = lo_t.shape[0]
    cent = 0.5 * (lo_t + hi_t)

    node_lo, node_hi, child0, child1 = [], [], [], []
    leaf_slots = []  # list of arrays of tri ids (padded later)
    max_depth = [1]

    # iterative DFS; each stack entry: (tri index array, depth, parent slot to fix)
    root_idx = np.arange(t)

    def new_node():
        node_lo.append(None)
        node_hi.append(None)
        child0.append(0)
        child1.append(0)
        return len(child0) - 1

    stack = [(root_idx, 1, None, 0)]  # (idx, depth, parent, which_child)
    while stack:
        idx, depth, parent, which = stack.pop()
        ni = new_node()
        if parent is not None:
            if which == 0:
                child0[parent] = ni
            else:
                child1[parent] = ni
        max_depth[0] = max(max_depth[0], depth)
        blo = lo_t[idx].min(axis=0)
        bhi = hi_t[idx].max(axis=0)
        node_lo[ni] = blo
        node_hi[ni] = bhi
        n = idx.shape[0]
        if n <= leaf_size:
            child0[ni] = -(len(leaf_slots) + 1)
            leaf_slots.append(idx)
            continue
        # --- binned SAH on largest centroid-extent axis ---
        c = cent[idx]
        clo = c.min(axis=0)
        chi = c.max(axis=0)
        ext = chi - clo
        axis = int(np.argmax(ext))
        split_done = False
        if ext[axis] > 1e-12:
            scale = _NBINS * (1.0 - 1e-6) / ext[axis]
            bins = ((c[:, axis] - clo[axis]) * scale).astype(np.int32)
            # bin bounds + counts
            counts = np.bincount(bins, minlength=_NBINS)
            binlo = np.full((_NBINS, 3), np.inf)
            binhi = np.full((_NBINS, 3), -np.inf)
            for b in range(_NBINS):
                m = bins == b
                if counts[b]:
                    binlo[b] = lo_t[idx][m].min(axis=0)
                    binhi[b] = hi_t[idx][m].max(axis=0)
            # prefix/suffix areas
            def areas(los, his):
                d = np.maximum(his - los, 0.0)
                return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 0] * d[:, 2])

            pl = np.minimum.accumulate(binlo, axis=0)
            ph = np.maximum.accumulate(binhi, axis=0)
            sl = np.minimum.accumulate(binlo[::-1], axis=0)[::-1]
            sh = np.maximum.accumulate(binhi[::-1], axis=0)[::-1]
            cl = np.cumsum(counts)
            cr = n - cl
            cost = np.full(_NBINS - 1, np.inf)
            for b in range(_NBINS - 1):
                if cl[b] > 0 and cr[b] > 0:
                    cost[b] = areas(pl[b : b + 1], ph[b : b + 1])[0] * cl[b] + areas(
                        sl[b + 1 : b + 2], sh[b + 1 : b + 2]
                    )[0] * cr[b]
            best = int(np.argmin(cost))
            if np.isfinite(cost[best]):
                left_mask = bins <= best
                li, ri = idx[left_mask], idx[~left_mask]
                if len(li) and len(ri):
                    split_done = True
        if not split_done:
            # object median fallback
            srt = idx[np.argsort(cent[idx, axis], kind="stable")]
            mid = n // 2
            li, ri = srt[:mid], srt[mid:]
        # push right first so left (= node+1 in DFS order) pops next
        stack.append((ri, depth + 1, ni, 1))
        stack.append((li, depth + 1, ni, 0))

    # pack leaves into fixed slots
    nl = len(leaf_slots)
    order = np.full((nl * leaf_size,), -1, np.int64)
    for i, s in enumerate(leaf_slots):
        order[i * leaf_size : i * leaf_size + len(s)] = s
    return (
        np.asarray(node_lo, np.float32),
        np.asarray(node_hi, np.float32),
        np.asarray(child0, np.int32),
        np.asarray(child1, np.int32),
        order,
        int(max_depth[0]),
    )


def bvh_from_arrays(tri_pos, arrays, leaf_size: int = 4) -> BVH:
    """The BVH of triangles tri_pos (T,3,3) (numpy or tensor) from a
    builder's (node_lo, node_hi, child0, child1, order, max_depth), on the
    CPU, with kernel T's records: padding slots get p0 = inf, e1 = e2 =
    0."""
    tri_pos = np.asarray(torch.as_tensor(tri_pos).cpu(), np.float32)
    nlo, nhi, c0, c1, order, md = arrays
    valid = order >= 0
    p = tri_pos[np.maximum(order, 0)]
    p0 = np.where(valid[:, None], p[:, 0], np.inf).astype(np.float32)
    e1 = np.where(valid[:, None], p[:, 1] - p[:, 0], 0.0).astype(np.float32)
    e2 = np.where(valid[:, None], p[:, 2] - p[:, 0], 0.0).astype(np.float32)
    return make_bvh(torch.from_numpy(np.asarray(nlo, np.float32)),
                    torch.from_numpy(np.asarray(nhi, np.float32)),
                    torch.from_numpy(np.asarray(c0, np.int32)),
                    torch.from_numpy(np.asarray(c1, np.int32)),
                    torch.from_numpy(p0), torch.from_numpy(e1),
                    torch.from_numpy(e2),
                    torch.from_numpy(order.astype(np.int32)),
                    leaf_size=leaf_size, max_depth=int(md))


def build_sah(tri_pos, leaf_size: int = 4) -> BVH:
    """Binned-SAH BVH of (T,3,3) triangles, built on the host (returned on
    the CPU): the native builder when it builds and runs, else, with one
    warning naming the reason, the numpy builder."""
    tri_np = np.asarray(torch.as_tensor(tri_pos).cpu(), np.float32)
    try:
        from ..native import bvh_native

        arrays = bvh_native.build_sah(tri_np, leaf_size)
    except Exception as e:      # host build only: numpy is the reference
        _log.warning("native SAH builder unavailable (%s: %s); using the "
                     "numpy builder", type(e).__name__, e)
        arrays = build_sah_arrays(tri_np, leaf_size)
    return bvh_from_arrays(tri_np, arrays, leaf_size)
