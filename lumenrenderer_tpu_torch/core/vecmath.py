"""Vector math on tensors whose last axis holds the 3 vector components.

Port of `lumenrenderer_tpu/core/vecmath.py`.
"""
from __future__ import annotations

import numbers

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the last axis."""
    return (a * b).sum(-1)


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product keeping the last axis (size 1)."""
    return (a * b).sum(-1, keepdim=True)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(v, v).clamp_min(0.0))


def length_sq(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize: v/|v|; near-zero vectors map to 0."""
    vv = vdot(v, v)
    return v * torch.where(vv > eps, torch.rsqrt(vv.clamp_min(eps)),
                           torch.zeros_like(vv))


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reflect direction d about normal n (d points into the surface)."""
    return d - 2.0 * vdot(d, n) * n


def refract(d: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """Refract d at normal n with relative IOR eta.

    Returns (refracted_dir, total_internal_reflection_mask)."""
    cos_i = -vdot(d, n)
    e = eta[..., None]
    sin2_t = e ** 2 * (1.0 - cos_i ** 2).clamp_min(0.0)
    tir = sin2_t[..., 0] >= 1.0
    cos_t = torch.sqrt((1.0 - sin2_t).clamp_min(0.0))
    refr = e * d + (e * cos_i - cos_t) * n
    return torch.where(tir[..., None], reflect(d, n), refr), tir


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def build_onb(n: torch.Tensor):
    """Branchless orthonormal basis from a unit normal (Duff et al. 2017).

    Returns (tangent, bitangent)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + s * nx ** 2 * a, s * b, -s * nx], dim=-1)
    bt = torch.stack([b, s + ny ** 2 * a, -ny], dim=-1)
    return t, bt


def to_world(local: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Tangent-space direction (z up) to world space about n."""
    t, b = build_onb(n)
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


def to_local(world: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """World direction to the tangent frame about n."""
    t, b = build_onb(n)
    return to_local_frame(world, t, b, n)


def to_local_frame(world, t, b, n) -> torch.Tensor:
    return torch.stack([dot(world, t), dot(world, b), dot(world, n)], dim=-1)


def to_world_frame(local, t, b, n) -> torch.Tensor:
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


def face_forward(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """n flipped into the hemisphere opposite the incoming direction d."""
    return torch.where(vdot(n, d) > 0.0, -n, n)


def transform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A (...,4,4) row-major transform applied to points (...,3)."""
    return transform_dir(m, p) + m[..., :3, 3]


def transform_dir(m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The rotation and scale of a (...,4,4) transform applied to
    directions (...,3)."""
    return (d[..., None, :] @ m[..., :3, :3].transpose(-1, -2))[..., 0, :]


def transform_normal(m_inv: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Normals under the inverse transpose, n' = (M^-1)^T n: pass the
    inverse matrix."""
    return (n[..., None, :] @ m_inv[..., :3, :3])[..., 0, :]


def safe_rcp(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """1/x with a sign-preserving clamp away from zero (a ray's inverse
    direction): +-1/eps where |x| <= eps (+ for x >= 0)."""
    big = x.abs() > eps
    return torch.where(big, 1.0 / torch.where(big, x, 1.0),
                       torch.where(x >= 0.0, 1.0 / eps, -1.0 / eps))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The float32 fused multiply-add a b + c, rounded once (to nearest,
    ties to even), as CUDA's __fmaf_rn and XLA's CPU dot chains: a b is
    exact in float64; the float64 sum s and its exact error e (TwoSum) give
    s rounded to odd (one ulp toward e when e is not 0 and s's last bit is
    even), whose rounding to float32 is the rounding of the exact a b + c.
    A sum that is not finite is left as it is."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    z = s - p
    e = (p - (s - z)) + (c - z)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(s.dtype)
    odd = torch.where((e != 0) & even & s.isfinite(),
                      torch.nextafter(s, toward), s)
    return odd.float()


def lerp(a, b, t):
    return a + (b - a) * t


def saturate(x):
    return x.clamp(0.0, 1.0)


def per_ray(x, r: int, device) -> torch.Tensor:
    """x, a number or a () or (r,) tensor or array, as a float32 (r,)
    tensor on `device`. A number is filled in on the device, not uploaded:
    an upload from host memory makes the host wait, and a CUDA graph
    cannot hold it."""
    if isinstance(x, numbers.Number):
        return torch.full((), x, dtype=torch.float32,
                          device=device).expand(r)
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(r)
