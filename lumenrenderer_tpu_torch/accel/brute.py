"""Brute-force ray/triangle intersector, the oracle of the other accels.

Port of `lumenrenderer_tpu/accel/brute.py`: Möller–Trumbore of every ray
against every triangle. JAX chunks the rays with `lax.map`; here a Python
loop over blocks of `chunk` rays bounds the (chunk, T) temporaries. A hit
needs t >= t_min (the stream intersector's test is t > t_min), as in the
JAX package.
"""
from __future__ import annotations

import torch

from ..core import vecmath as vm

#: triangle id of a miss
NO_HIT = -1


def moller_trumbore(o, d, p0, e1, e2, backface_cull: bool = False):
    """Vectorized Möller–Trumbore; o, d, p0, e1, e2 (...,3) broadcast.

    Returns (t, u, v, hit); misses get t = +inf."""
    pvec = vm.cross(d, e2)
    det = vm.dot(e1, pvec)
    det_ok = det > 1e-9 if backface_cull else det.abs() > 1e-9
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tvec = o - p0
    u = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, e1)
    v = vm.dot(d, qvec) * inv_det
    t = vm.dot(e2, qvec) * inv_det
    hit = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return torch.where(hit, t, torch.inf), u, v, hit


def intersect_closest(tri_pos, origins, dirs, t_min, t_max,
                      chunk: int = 4096):
    """Closest hits of rays (R,3) against every triangle of tri_pos
    (T,3,3); t_min, t_max scalars or (R,). Returns {"t", "tri", "u", "v"}
    (R,) with tri = -1 on a miss."""
    p0 = tri_pos[:, 0]
    e1 = tri_pos[:, 1] - p0
    e2 = tri_pos[:, 2] - p0
    r = origins.shape[0]
    tn = vm.per_ray(t_min, r, origins.device)
    tx = vm.per_ray(t_max, r, origins.device)
    out = {k: [] for k in ("t", "tri", "u", "v")}
    for a in range(0, r, chunk):
        b = min(a + chunk, r)
        t, u, v, _ = moller_trumbore(origins[a:b, None], dirs[a:b, None],
                                     p0[None], e1[None], e2[None])
        t = torch.where((t >= tn[a:b, None]) & (t <= tx[a:b, None]), t,
                        torch.inf)
        best = t.argmin(1, keepdim=True)
        bt = t.gather(1, best)[:, 0]
        out["t"].append(bt)
        out["tri"].append(torch.where(torch.isfinite(bt),
                                      best[:, 0].to(torch.int32), NO_HIT))
        out["u"].append(u.gather(1, best)[:, 0])
        out["v"].append(v.gather(1, best)[:, 0])
    return {k: torch.cat(v_) for k, v_ in out.items()}


def intersect_any(tri_pos, origins, dirs, t_min, t_max, chunk: int = 4096):
    """Occlusion (R,) bool: True where a triangle blocks [t_min, t_max]."""
    return intersect_closest(tri_pos, origins, dirs, t_min, t_max,
                             chunk)["tri"] >= 0
