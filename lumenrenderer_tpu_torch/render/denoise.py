"""Edge-avoiding À-Trous denoiser and temporal accumulation: port of
`lumenrenderer_tpu/render/denoise.py`.

À-Trous (Dammertz et al. 2010) with SVGF-style edge stops on normal, depth
and luminance: 5 dilated 5x5 passes over the albedo-demodulated radiance.
The temporal stage reprojects the history through the motion AOV, keeps it
where normal and depth agree, clamps it to the current frame's 3x3
mean +- k sigma and blends.

The filters work channel-first, (C,H,W). An edge-clamped shift is a slice
of the image padded once per pass with `F.pad(mode="replicate")`, which
copies the same texels as JAX's two row gathers a tap; the bilinear
reprojection gathers its four corners of every history channel with one
`torch.take`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..scene.textures import take_rows

_KERNEL = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
_LUM = (0.2126, 0.7152, 0.0722)


def _demod_albedo(albedo: torch.Tensor) -> torch.Tensor:
    """Albedo divisor for demodulation: near-black albedo (emitters,
    environment misses) passes through unmodulated."""
    return torch.where(albedo > 0.02, albedo, 1.0)


def _pad(img_chw: torch.Tensor, p: int) -> torch.Tensor:
    """(C,H,W) padded by p on each side with its edge texels."""
    return F.pad(img_chw[None], (p, p, p, p), mode="replicate")[0]


def _tap(padded: torch.Tensor, p: int, dy: int, dx: int, h: int, w: int):
    """The (C,h,w) shift by (dy, dx) of the image that `padded` pads by p."""
    return padded[:, p + dy:p + dy + h, p + dx:p + dx + w]


def _shift2(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped 2D shift of (H,W,C): out[y, x] = img[clamp(y + dy),
    clamp(x + dx)]."""
    h, w = img.shape[:2]
    p = max(abs(dy), abs(dx))
    return _tap(_pad(img.permute(2, 0, 1), p), p, dy, dx, h,
                w).permute(1, 2, 0)


def _lum(c: torch.Tensor) -> torch.Tensor:
    return c[0] * _LUM[0] + c[1] * _LUM[1] + c[2] * _LUM[2]


def atrous_denoise(color, albedo, normal, depth, iterations: int = 5,
                   sigma_color: float = 4.0, sigma_normal: float = 128.0,
                   sigma_depth: float = 1.0) -> torch.Tensor:
    """Denoised (H,W,3) of radiance `color` (H,W,3) with its albedo and
    normal (H,W,3) and depth (H,W) AOVs. Demodulates the albedo first and
    re-modulates after."""
    h, w = depth.shape
    alb_safe = _demod_albedo(albedo)
    out = (color / alb_safe).permute(2, 0, 1)
    nrm = normal.permute(2, 0, 1)
    d_den = sigma_depth * depth.clamp_min(1e-3)
    for it in range(iterations):
        step = 1 << it
        p = 2 * step
        c_pad = _pad(out, p)
        l_pad = _lum(c_pad)
        n_pad = _pad(nrm, p)
        d_pad = _pad(depth[None], p)[0]
        lum_c = _lum(out)
        acc = torch.zeros_like(out)
        wacc = torch.zeros_like(depth)
        for ky in range(5):
            for kx in range(5):
                dy, dx = (ky - 2) * step, (kx - 2) * step
                hk = float(_KERNEL[ky] * _KERNEL[kx])
                c_s = _tap(c_pad, p, dy, dx, h, w)
                n_s = _tap(n_pad, p, dy, dx, h, w)
                d_s = d_pad[p + dy:p + dy + h, p + dx:p + dx + w]
                l_s = l_pad[p + dy:p + dy + h, p + dx:p + dx + w]
                w_n = (n_s * nrm).sum(0).clamp_min(0.0) ** sigma_normal
                w_d = torch.exp(-(d_s - depth).abs() / d_den)
                w_l = torch.exp(-(l_s - lum_c).abs() / sigma_color)
                wt = hk * w_n * w_d * w_l
                acc = acc + c_s * wt
                wacc = wacc + wt
        out = acc / wacc.clamp_min(1e-8)
    return out.permute(1, 2, 0) * alb_safe


def denoise_frame(accum, aovs, width: int, height: int, **kw):
    """`atrous_denoise` over the Renderer's flat (N,.) outputs: (N,3)."""
    c = accum.reshape(height, width, 3)
    a = aovs["albedo"].reshape(height, width, 3)
    n = aovs["normal"].reshape(height, width, 3)
    d = aovs["depth"].reshape(height, width)
    return atrous_denoise(c, a, n, d, **kw).reshape(-1, 3)


# -- temporal accumulation (SVGF-style), in front of the À-Trous pass ------

@dataclasses.dataclass
class TemporalState:
    """History carried between the frames of a sequence."""

    hist: torch.Tensor     # (H,W,3) accumulated (demodulated) radiance
    depth: torch.Tensor    # (H,W) previous depth
    normal: torch.Tensor   # (H,W,3) previous shading normal
    count: torch.Tensor    # (H,W) history length (0 = no history)


def init_temporal_state(height: int, width: int, *,
                        device: torch.device | str) -> TemporalState:
    f32 = dict(dtype=torch.float32, device=device)
    return TemporalState(hist=torch.zeros((height, width, 3), **f32),
                         depth=torch.zeros((height, width), **f32),
                         normal=torch.zeros((height, width, 3), **f32),
                         count=torch.zeros((height, width), **f32))


def _bilinear(img: torch.Tensor, py: torch.Tensor, px: torch.Tensor):
    """Bilinear sample of (H,W,C) at float pixel coordinates (edge-clamped):
    the four corners are one element-wise gather."""
    h, w, c = img.shape
    y0 = py.floor().long().clamp(0, h - 1)
    x0 = px.floor().long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)
    fy = (py - y0).clamp(0.0, 1.0)[..., None]
    fx = (px - x0).clamp(0.0, 1.0)[..., None]
    idx = torch.stack([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1],
                      -1)
    a, b, cc, d = take_rows(img.reshape(-1, c), idx).unbind(-2)
    return (a * (1 - fx) + b * fx) * (1 - fy) + (cc * (1 - fx) + d * fx) * fy


def temporal_accumulate(state: TemporalState, color, normal, depth, motion,
                        alpha_min: float = 0.12, clamp_k: float = 1.25):
    """Reproject the history through `motion` (H,W,2: previous minus
    current pixel) and blend it with `color` (H,W,3). The history counts
    where it lies inside the image, its normal and depth agree with the
    current ones and it has been written; it is clamped to the current
    frame's 3x3 mean +- clamp_k sigma first. Returns (new state, blended
    (H,W,3))."""
    h, w = depth.shape
    dev = depth.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    px = xx + motion[..., 0]
    py = yy + motion[..., 1]
    in_b = (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)
    prev = _bilinear(torch.cat([state.hist, state.depth[..., None],
                                state.normal, state.count[..., None]], -1),
                     py, px)
    hist, p_depth = prev[..., 0:3], prev[..., 3]
    p_normal, p_count = prev[..., 4:7], prev[..., 7]

    n_ok = (p_normal * normal).sum(-1) > 0.85
    d_ok = (p_depth - depth).abs() < 0.1 * depth.clamp_min(1e-3) + 1e-2
    valid = in_b & n_ok & d_ok & (p_count > 0.5)

    # the current frame's 3x3 neighbourhood statistics (variance clamp)
    c_pad = _pad(color.permute(2, 0, 1), 1)
    mean = torch.zeros_like(color)
    m2 = torch.zeros_like(color)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = _tap(c_pad, 1, dy, dx, h, w).permute(1, 2, 0)
            mean = mean + s
            m2 = m2 + s * s
    mean = mean / 9.0
    sigma = (m2 / 9.0 - mean * mean).clamp_min(0.0).sqrt()
    hist_c = torch.clamp(hist, mean - clamp_k * sigma, mean + clamp_k * sigma)

    count = torch.where(valid, p_count + 1.0, 1.0)
    alpha = (1.0 / count).clamp_min(alpha_min)[..., None]
    blended = torch.where(valid[..., None],
                          hist_c + (color - hist_c) * alpha, color)
    return TemporalState(hist=blended, depth=depth, normal=normal,
                         count=count), blended


def temporal_denoise_frame(state: TemporalState, frame, aovs, width: int,
                           height: int, spatial: bool = True, **atrous_kw):
    """Temporal and then spatial denoising of the Renderer's flat (N,.)
    outputs; frame is the current frame's radiance. Returns (new state,
    denoised (N,3))."""
    c = frame.reshape(height, width, 3)
    a = aovs["albedo"].reshape(height, width, 3)
    n = aovs["normal"].reshape(height, width, 3)
    d = aovs["depth"].reshape(height, width)
    m = aovs["motion"].reshape(height, width, 2)
    alb = _demod_albedo(a)
    state, blended = temporal_accumulate(state, c / alb, n, d, m)
    out = blended * alb
    if spatial:
        out = atrous_denoise(out, a, n, d, **atrous_kw)
    return state, out.reshape(-1, 3)
