"""Render-to-output resolution: port of `lumenrenderer_tpu/render/upscale.py`.

JAX resizes with `jax.image.resize` (Lanczos3 or antialiased linear).
`torch.nn.functional.interpolate` has no Lanczos and its bilinear is not
antialiased, so this module builds the same per-axis weight matrices as
the installed JAX (`jax/_src/image/scale.py`: `compute_weight_mat`,
`_fill_lanczos_kernel`, `_fill_triangle_kernel`), in float32 as JAX does,
and applies them as two matmuls (TF32 off).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _fill_lanczos_kernel(radius: float, x: torch.Tensor) -> torch.Tensor:
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    out = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi ** 2 * x ** 2,
                                                1.0), 1.0)
    return torch.where(x > radius, 0.0, out)


def _fill_triangle_kernel(x: torch.Tensor) -> torch.Tensor:
    return (1.0 - x.abs()).clamp_min(0.0)


_KERNELS = {
    "linear": _fill_triangle_kernel,
    "bilinear": _fill_triangle_kernel,
    "triangle": _fill_triangle_kernel,
    "lanczos3": lambda x: _fill_lanczos_kernel(3.0, x),
    "lanczos5": lambda x: _fill_lanczos_kernel(5.0, x),
}


def compute_weight_mat(input_size: int, output_size: int, scale: float,
                       translation: float, kernel, antialias: bool, *,
                       dtype: torch.dtype = torch.float32,
                       device=None) -> torch.Tensor:
    """(input_size, output_size) resampling weights of one axis: output
    sample j reads input i with weight [i, j]. On a downscale with
    antialias the kernel widens by 1/scale (a low-pass filter)."""
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    ar = dict(dtype=dtype, device=device)
    sample_f = ((torch.arange(output_size, **ar) + 0.5) * inv_scale
                - translation * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(input_size, **ar)[:, None]).abs() \
        / kernel_scale
    weights = kernel(x)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, 1.0), 0.0)
    # the sample lies outside the input: no weight
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize(img: torch.Tensor, out_h: int, out_w: int,
           method: str = "lanczos3") -> torch.Tensor:
    """`jax.image.resize` of an (H,W,C) image to (out_h,out_w,C), with
    antialiasing: one matmul per axis whose size changes."""
    if method not in _KERNELS:
        raise ValueError(f"unknown resize method {method!r}")
    kernel = _KERNELS[method]
    h, w, c = img.shape
    out = img
    if out_h != h:
        wy = compute_weight_mat(h, out_h, out_h / h, 0.0, kernel, True,
                                dtype=img.dtype, device=img.device)
        out = (wy.T @ out.reshape(h, w * c)).reshape(out_h, w, c)
    if out_w != w:
        wx = compute_weight_mat(w, out_w, out_w / w, 0.0, kernel, True,
                                dtype=img.dtype, device=img.device)
        rows = out.shape[0]
        out = (out.permute(0, 2, 1).reshape(rows * c, w) @ wx).reshape(
            rows, c, out_w).permute(0, 2, 1)
    return out.contiguous()


def upscale(img: torch.Tensor, out_h: int, out_w: int,
            method: str = "lanczos3", sharpen: float = 0.0) -> torch.Tensor:
    """(H,W,3) -> (out_h,out_w,3); sharpen > 0 adds an unsharp mask against
    a half-size linear blur, clamped at 0."""
    out = resize(img, out_h, out_w, method)
    if sharpen > 0.0:
        blur = resize(resize(out, max(out_h // 2, 1), max(out_w // 2, 1),
                             "linear"), out_h, out_w, "linear")
        out = (out + sharpen * (out - blur)).clamp_min(0.0)
    return out
