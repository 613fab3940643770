"""Volumetric ray marching: port of `lumenrenderer_tpu/volume/march.py`.

Absorption and single scattering with an isotropic phase (1/4π). Along a
ray's segment through each volume's box, `volume_scatter` marches `steps`
jittered steps, each sampling one light (NEE) and casting a shadow ray to
it; transmittance is a jittered Riemann sum of the optical depth.
`transmittance_only` attenuates shadow segments, by that Riemann sum or by
ratio tracking. Everything is differentiable with respect to the density
grid; the sampling machinery (light pdfs, step lengths) is detached.

Random numbers come from the frame's `Uniforms` source, in the JAX
package's order: the march draws u0 (R,) per volume, then (R,3) per step;
the Riemann shadow transmittance draws one (R,) for all volumes; ratio
tracking draws (max_events, R) per volume.

A march light ray that cannot contribute (no segment, no valid light, a
dead path) is sent to the occluder as a dead lane (t_max < t_min), which
the intersectors skip and leave out of their tiles' bounds; the JAX
package casts it and masks its result.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..core import sampling
from ..integrator import nee as nee_mod
from . import grid as grid_mod

INV_4PI = 1.0 / (4.0 * math.pi)
LIGHT_RAY_EPS = 1e-3


def _aabb_segment(lo, hi, o, d, t_min, t_max):
    """Entry and exit of rays o, d (R,3) with one box lo, hi (3,), clipped
    to [t_min, t_max]: (t0, t1, hit)."""
    tiny = torch.where(d >= 0, 1e-20, -1e-20)
    inv = 1.0 / torch.where(d.abs() > 1e-20, d, tiny)
    ta = (lo - o) * inv
    tb = (hi - o) * inv
    t0 = torch.clamp(torch.minimum(ta, tb).amax(-1), min=t_min)
    t1 = torch.minimum(torch.maximum(ta, tb).amin(-1), torch.as_tensor(
        t_max, dtype=o.dtype, device=o.device))
    return t0, t1, t1 > t0


def march_single_volume(vols, v: int, light_table, o, d, t_min, t_max,
                        uniforms: sampling.Uniforms, occlude_fn: Callable,
                        steps: int = 5, light_samples: bool = True,
                        detach_sampling: bool = True,
                        alive: Optional[torch.Tensor] = None):
    """(in-scatter (R,3), transmittance (R,)) of volume v along o + t d,
    t in [t_min, t_max]. alive (R,) bool: rays of dead paths, whose result
    the caller drops, cast no light rays. light_samples=False draws no light
    samples and casts no light rays: the in-scatter is zero."""
    sg = (lambda x: x.detach()) if detach_sampling else (lambda x: x)
    r = o.shape[0]
    t0, t1, hit = _aabb_segment(vols.aabb_lo[v], vols.aabb_hi[v], o, d,
                                t_min, t_max)
    seg = torch.where(hit, t1 - t0, 0.0)
    dt = seg / steps
    u0 = uniforms(r)
    sigma_t = vols.sigma_t[v]
    albedo = vols.albedo[v]
    marching = hit & (seg > 0)
    if alive is not None:
        marching = marching & alive
    trans = torch.ones(r, dtype=o.dtype, device=o.device)
    scatter = torch.zeros((r, 3), dtype=o.dtype, device=o.device)
    for i in range(steps):
        t_i = t0 + (i + u0) * dt
        pos = o + t_i[:, None] * d
        sig = grid_mod.sample_density(vols, v, pos) * sigma_t
        step_tau = sig * dt
        # transmittance to the middle of this step
        t_here = trans * torch.exp(-0.5 * step_tau)
        if light_samples:
            ls = nee_mod.sample_light(light_table, uniforms(r, 3), pos)
            pdf_sa = nee_mod.pdf_solid_angle(ls)
            cast = marching & ls.valid & (pdf_sa > 1e-12)
            occluded = occlude_fn(pos, ls.wi, LIGHT_RAY_EPS, torch.where(
                cast, ls.dist - 2 * LIGHT_RAY_EPS, -1.0))
            ok = hit & ls.valid & ~occluded & (pdf_sa > 1e-12) & (seg > 0)
            scale = torch.where(ok, 1.0 / sg(pdf_sa).clamp_min(1e-12), 0.0)
            # sigma_s * phase * T_to_here * L * dt
            scatter = scatter + (albedo * sig * INV_4PI * t_here * sg(dt)
                                 * scale)[:, None] * ls.radiance
        trans = trans * torch.exp(-step_tau)
    return scatter, torch.where(hit, trans, 1.0)


def volume_scatter(vols, light_table, o, d, t_min, t_max,
                   uniforms: sampling.Uniforms, occlude_fn: Callable,
                   steps: int = 5, detach_sampling: bool = True,
                   alive: Optional[torch.Tensor] = None):
    """Every volume along the segment, composited as independent media:
    (in-scatter (R,3), transmittance (R,))."""
    r = o.shape[0]
    trans = torch.ones(r, dtype=o.dtype, device=o.device)
    scatter = torch.zeros((r, 3), dtype=o.dtype, device=o.device)
    for v in range(vols.count):
        s, t = march_single_volume(vols, v, light_table, o, d, t_min, t_max,
                                   uniforms, occlude_fn, steps=steps,
                                   detach_sampling=detach_sampling,
                                   alive=alive)
        scatter = scatter + trans[:, None] * s
        trans = trans * t
    return scatter, trans


def transmittance_only(vols, o, d, t_min, t_max, steps: int = 5,
                       uniforms: Optional[sampling.Uniforms] = None,
                       estimator: str = "riemann", max_events: int = 64):
    """Transmittance (R,) along the segments, for shadow rays.

    estimator "riemann": a jittered Riemann sum of the optical depth over
    `steps` steps (offset 0.5 without uniforms); biased on strongly
    heterogeneous grids. "ratio": ratio tracking, an unbiased
    null-collision estimator under each volume's density majorant, run for
    `max_events` events."""
    if estimator == "ratio":
        if uniforms is None:
            raise ValueError("ratio tracking needs a uniform source")
        return _transmittance_ratio(vols, o, d, t_min, t_max, uniforms,
                                    max_events)
    if estimator != "riemann":
        raise ValueError(f"unknown transmittance estimator {estimator!r}")
    r = o.shape[0]
    trans = torch.ones(r, dtype=o.dtype, device=o.device)
    u0 = 0.5 if uniforms is None else uniforms(r)
    for v in range(vols.count):
        t0, t1, hit = _aabb_segment(vols.aabb_lo[v], vols.aabb_hi[v], o, d,
                                    t_min, t_max)
        dt = torch.where(hit, t1 - t0, 0.0) / steps
        tau = torch.zeros(r, dtype=o.dtype, device=o.device)
        for i in range(steps):
            pos = o + (t0 + (i + u0) * dt)[:, None] * d
            tau = tau + (grid_mod.sample_density(vols, v, pos)
                         * vols.sigma_t[v] * dt)
        trans = trans * torch.exp(-tau)
    return trans


def _transmittance_ratio(vols, o, d, t_min, t_max, uniforms, max_events):
    """Ratio tracking: T = E[prod_i (1 - sigma(x_i) / sigma_maj)] over event
    distances ~ Exp(sigma_maj), a fixed `max_events` events a volume; an
    event past the segment's exit leaves the weight as it is."""
    r = o.shape[0]
    trans = torch.ones(r, dtype=o.dtype, device=o.device)
    maj_all = grid_mod.density_majorant(vols)
    for v in range(vols.count):
        t0, t1, hit = _aabb_segment(vols.aabb_lo[v], vols.aabb_hi[v], o, d,
                                    t_min, t_max)
        sigma_t = vols.sigma_t[v]
        maj = (maj_all[v] * sigma_t).clamp_min(1e-8)
        u = uniforms(max_events, r)
        t, w = t0, torch.ones(r, dtype=o.dtype, device=o.device)
        for i in range(max_events):
            t = t - torch.log((1.0 - u[i]).clamp_min(1e-12)) / maj
            dens = grid_mod.sample_density(vols, v, o + t[:, None] * d)
            w = torch.where(t < t1, w * (1.0 - dens * sigma_t / maj), w)
        trans = trans * torch.where(hit, w, 1.0)
    return trans
