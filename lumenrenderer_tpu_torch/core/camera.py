"""Pinhole camera, primary rays and motion vectors.

Port of `lumenrenderer_tpu/core/camera.py`. `pixel_ids` traces a slice of
the frame (a rank's rows under a device mesh) or the frame in another order
(`block_swizzle_map`'s): n follows it, and width and height stay the full
frame's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import sampling
from . import vecmath as vm
from .struct import TensorStruct

F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


@dataclasses.dataclass(frozen=True)
class Camera(TensorStruct):
    """eye (3,); u, v, w screen basis (u = right*tan(fov/2)*aspect,
    v = up*tan(fov/2), w = forward); prev_view_proj (4,4) for motion
    vectors; t_min, t_max () ray interval."""

    eye: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    prev_view_proj: torch.Tensor
    t_min: torch.Tensor
    t_max: torch.Tensor

    @staticmethod
    def look_at(eye, target, up=(0.0, 1.0, 0.0), fov_y_deg: float = 45.0,
                aspect: float = 1.0, t_min: float = 1e-3,
                t_max: float = 1e9) -> "Camera":
        eye, target, up = _f32(eye), _f32(target), _f32(up)
        w = vm.normalize(target - eye)
        u = vm.normalize(vm.cross(w, up))
        v = vm.cross(u, w)
        tan_half = torch.tan(torch.deg2rad(_f32(fov_y_deg)) * 0.5)
        cam = Camera(eye=eye, u=u * tan_half * aspect, v=v * tan_half, w=w,
                     prev_view_proj=torch.eye(4, dtype=F32),
                     t_min=_f32(t_min), t_max=_f32(t_max))
        return cam.replace(prev_view_proj=cam.view_proj(fov_y_deg, aspect))

    def view_proj(self, fov_y_deg: float = 45.0,
                  aspect: float = 1.0) -> torch.Tensor:
        """Row-major view-projection matrix."""
        rot = torch.stack([vm.normalize(self.u), vm.normalize(self.v),
                           vm.normalize(self.w)], dim=0)
        view = torch.eye(4, dtype=F32, device=self.eye.device)
        view[:3, :3] = rot
        view[:3, 3] = -(rot @ self.eye)
        f = 1.0 / torch.tan(torch.deg2rad(_f32(fov_y_deg)) * 0.5)
        f = float(f)
        near, far = 0.01, 1e6
        proj = torch.tensor(
            [[f / aspect, 0.0, 0.0, 0.0],
             [0.0, f, 0.0, 0.0],
             [0.0, 0.0, far / (far - near), -far * near / (far - near)],
             [0.0, 0.0, 1.0, 0.0]], dtype=F32, device=self.eye.device)
        return proj @ view

    def with_previous(self, prev: "Camera", fov_y_deg: float = 45.0,
                      aspect: float = 1.0) -> "Camera":
        return self.replace(prev_view_proj=prev.view_proj(fov_y_deg, aspect))

    def signature(self) -> bytes:
        """The pose's values as bytes, for camera-move detection."""
        return b"".join(x.detach().cpu().numpy().tobytes()
                        for x in (self.eye, self.u, self.v, self.w))


def block_swizzle_map(width: int, height: int, bw: int = 16, bh: int = 8
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Pixel permutation grouping bw x bh blocks consecutively, so that each
    128-ray intersector tile is a compact screen block instead of a thin
    scanline strip: (perm, inv) numpy int32, ray slot i handles pixel
    perm[i] and image[p] = result[inv[p]]. The identity when the blocks do
    not tile the frame."""
    n = width * height
    if width % bw or height % bh:
        ident = np.arange(n, dtype=np.int32)
        return ident, ident
    ys, xs = np.mgrid[0:height, 0:width]
    block = (ys // bh) * (width // bw) + (xs // bw)
    slot = block * (bw * bh) + (ys % bh) * bw + (xs % bw)
    inv = slot.reshape(-1).astype(np.int32)          # pixel -> slot
    perm = np.empty(n, np.int32)
    perm[inv] = np.arange(n, dtype=np.int32)         # slot -> pixel
    return perm, inv


def _ids(n: int, pixel_ids, device) -> torch.Tensor:
    if pixel_ids is None:
        return torch.arange(n, dtype=torch.int64, device=device)
    return pixel_ids.to(torch.int64)


def generate_primary_rays(camera: Camera, width: int, height: int,
                          frame_index: int | torch.Tensor,
                          uniforms: sampling.Uniforms | None = None,
                          jitter: str = "halton",
                          pixel_ids: torch.Tensor | None = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One jittered primary ray per pixel, row-major: (origins, dirs) (N,3),
    or one per entry of `pixel_ids` (N',), global pixel indices.

    jitter: "halton" (Halton(2,3) by frame), "random" (draws (N,2) from
    `uniforms`) or anything else for the pixel center. frame_index is an
    int or an integer () tensor (read on the device, as a CUDA graph's
    input is)."""
    dev = camera.eye.device
    n = width * height if pixel_ids is None else pixel_ids.shape[0]
    ids = _ids(n, pixel_ids, dev)
    px = ids % width
    py = ids // width
    if jitter == "halton":
        j = sampling.halton23(
            frame_index.to(device=dev, dtype=torch.int64).expand(n)
            if isinstance(frame_index, torch.Tensor)
            else torch.full((n,), int(frame_index), dtype=torch.int64,
                            device=dev))
    elif jitter == "random" and uniforms is not None:
        j = uniforms(n, 2)
    else:
        j = torch.full((n, 2), 0.5, dtype=F32, device=dev)
    sx = ((px.to(F32) + j[:, 0]) / width) * 2.0 - 1.0
    sy = 1.0 - ((py.to(F32) + j[:, 1]) / height) * 2.0
    d = vm.normalize(sx[:, None] * camera.u[None, :]
                     + sy[:, None] * camera.v[None, :] + camera.w[None, :])
    o = camera.eye[None, :].expand(n, 3)
    return o, d


def motion_vectors(world_pos: torch.Tensor, valid: torch.Tensor,
                   camera: Camera, width: int, height: int,
                   pixel_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Screen-space motion (prev - current pixel), (N,2); 0 where invalid.
    Row i is pixel i, or pixel_ids[i]."""
    n = world_pos.shape[0]
    hp = torch.cat([world_pos, torch.ones_like(world_pos[:, :1])], dim=-1)
    clip = hp @ camera.prev_view_proj.T
    w = clip[:, 3:4]
    ndc = clip[:, :2] / torch.where(w.abs() > 1e-8, w, torch.ones_like(w))
    prev_px = (ndc[:, 0] * 0.5 + 0.5) * width
    prev_py = (0.5 - ndc[:, 1] * 0.5) * height
    ids = _ids(n, pixel_ids, world_pos.device)
    cur_px = (ids % width).to(F32) + 0.5
    cur_py = (ids // width).to(F32) + 0.5
    mv = torch.stack([prev_px - cur_px, prev_py - cur_py], dim=-1)
    behind = clip[:, 3] <= 0.0
    return torch.where((valid & ~behind)[:, None], mv, torch.zeros_like(mv))
