"""Kernel D: the Disney BSDF's `evaluate` and `sample` as one CUDA kernel a
call (`csrc/disney_bsdf.cu`, which has the design and its bound).

`evaluate(sd, wo, wi)` and `sample(sd, wo, u)` return what
`bsdf/disney.py`'s eager functions of the same names return, from the same
inputs: that eager code is the kernel's twin, its gradient path and its
CPU path, and `bsdf/disney.py` decides which runs (a CUDA tensor and no
gradient asked for: the kernel). These wrappers take CUDA tensors only, of
float32 (R,k) (front_face bool (R,), mat_rows (R,25)), and raise
ValueError on anything else. They read the surface data's columns through their
own strides, so views of one gathered table are not copied, allocate the
outputs with `torch.empty`, launch on the current stream and read nothing
back from the device.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# launches by entry (a plain count: a run shows the frame went through D)
LAUNCHES = {"evaluate": 0, "sample": 0}
MAT_COLUMNS = 25              # the packed material row (scene/materials.py)

_PTRS = ctypes.c_void_p * 9
_STRIDES = ctypes.c_longlong * 18


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _inputs(sd, wo: torch.Tensor, second: torch.Tensor, width: int):
    """The kernel's nine inputs, checked: (device, R, pointer array, stride
    array). `second` is wi (R,3) or u (R,4). Dtypes and shapes are checked
    before the device, so the CPU can test them."""
    dev = wo.device
    r = wo.shape[0]
    f32 = torch.float32
    cols = (("wo", wo, f32, (r, 3)), ("wi/u", second, f32, (r, width)),
            ("normal", sd.normal, f32, (r, 3)),
            ("tangent", sd.tangent, f32, (r, 3)),
            ("base_color", sd.base_color, f32, (r, 3)),
            ("metallic", sd.metallic, f32, (r,)),
            ("roughness", sd.roughness, f32, (r,)),
            ("front_face", sd.front_face, torch.bool, (r,)),
            ("mat_rows", sd.mat_rows, f32, (r, MAT_COLUMNS)))
    for name, x, dtype, shape in cols:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    if dev.type != "cuda":
        raise ValueError(f"the Disney kernel runs on CUDA tensors, not {dev}")
    ptrs, strides = _PTRS(), _STRIDES()
    for k, (name, x, _, _) in enumerate(cols):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        ptrs[k] = x.data_ptr()
        strides[2 * k] = x.stride(0)
        strides[2 * k + 1] = x.stride(1) if x.dim() == 2 else 0
    return dev, r, ptrs, strides


def evaluate(sd, wo: torch.Tensor, wi: torch.Tensor):
    """(f (R,3), pdf (R,)) of `bsdf.disney.evaluate`, by the kernel."""
    dev, r, ptrs, strides = _inputs(sd, wo, wi, 3)
    f = torch.empty((r, 3), dtype=torch.float32, device=dev)
    pdf = torch.empty((r,), dtype=torch.float32, device=dev)
    fn = build.load_function(
        "disney_bsdf", "disney_evaluate",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_void_p])
    build.launch(fn, dev, ptrs, strides, f.data_ptr(), pdf.data_ptr(), r)
    LAUNCHES["evaluate"] += 1
    return f, pdf


def sample(sd, wo: torch.Tensor, u: torch.Tensor, with_lobe: bool = False):
    """(wi (R,3), f (R,3), pdf (R,), is_specular (R,) bool) of
    `bsdf.disney.sample`, by the kernel; with_lobe adds the lobe codes (R,)
    uint8 (`csrc/disney_bsdf.cu`: the lobe drawn, 0 diffuse to 3
    transmission, + 4 on total internal reflection, + 8 where the
    transmission lobe reflected)."""
    dev, r, ptrs, strides = _inputs(sd, wo, u, 4)
    wi = torch.empty((r, 3), dtype=torch.float32, device=dev)
    f = torch.empty((r, 3), dtype=torch.float32, device=dev)
    pdf = torch.empty((r,), dtype=torch.float32, device=dev)
    is_spec = torch.empty((r,), dtype=torch.bool, device=dev)
    lobe = (torch.empty((r,), dtype=torch.uint8, device=dev) if with_lobe
            else None)
    fn = build.load_function(
        "disney_bsdf", "disney_sample",
        [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_void_p] * 5
        + [ctypes.c_longlong, ctypes.c_void_p])
    build.launch(fn, dev, ptrs, strides, wi.data_ptr(), f.data_ptr(),
                 pdf.data_ptr(), is_spec.data_ptr(),
                 None if lobe is None else lobe.data_ptr(), r)
    LAUNCHES["sample"] += 1
    return (wi, f, pdf, is_spec) + ((lobe,) if with_lobe else ())
