"""Progressive renderer over a static scene: port of
`lumenrenderer_tpu/render/renderer.py` for `accel="tiled"`.

The scene and its SAH clusters live on `device`. On a CUDA device the tiled
intersector's visit scan is the hand-written kernel K1; on the CPU it is the
kernel's plain PyTorch twin.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

import torch

from ..accel import stream, tiled
from ..core import sampling
from ..core.camera import Camera
from ..integrator import wavefront
from ..scene.scene import SceneData
from . import state as state_mod
from . import tonemap

# visit-list caps for max_visits="auto": the kernel's early-out makes a long
# list cheap; the CPU twin scans every listed visit of every tile
KERNEL_VISIT_CAP = 128
TWIN_VISIT_CAP = 24


class Renderer:
    """Progressive wavefront renderer. Only accel="tiled" is ported."""

    def __init__(self, scene: SceneData, config: wavefront.RenderConfig,
                 accel: str = "tiled", cluster_size: int = 128,
                 max_visits: int | str = "auto", culling: str = "auto",
                 candidate_dtype: str = "high", device=None,
                 reset_on_camera_move: bool = True, mesh=None, dynamic=None):
        """candidate_dtype: "high" (the JAX default, a bf16 three-pass split
        there) and "float32" both run exact fp32 here; "bfloat16" is not
        ported. device: where the scene, state and frame live (default: the
        current CUDA device if there is one, else the CPU)."""
        if accel != "tiled":
            raise NotImplementedError(
                f"accel={accel!r} is not ported; the PyTorch port has "
                "accel='tiled' only")
        if mesh is not None:
            raise NotImplementedError("mesh (multi-device) is not ported")
        if dynamic is not None:
            raise NotImplementedError("dynamic scenes are not ported")
        if culling not in ("auto", "frustum"):
            raise NotImplementedError(
                f"culling={culling!r} is not ported; only 'frustum'")
        if candidate_dtype == "bfloat16":
            raise NotImplementedError("bfloat16 candidates are not ported")
        if candidate_dtype not in ("high", "float32"):
            raise ValueError(f"unknown candidate_dtype {candidate_dtype!r}")
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        # geometry runs in exact fp32: no TF32 anywhere on the frame's path
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        materials = scene.materials
        if config.extract_tangent and not bool(
                (materials.anisotropic != 0.0).any()
                or (materials.normal_tex >= 0).any()):
            # tangents feed only anisotropy and normal maps
            config = dataclasses.replace(config, extract_tangent=False)
        if not config.alpha_materials and bool(
                (materials.alpha_mode != 0.0).any()
                or (materials.double_sided < 0.5).any()):
            config = dataclasses.replace(config, alpha_materials=True)
        self.config = config
        self.scene = scene.to(self.device)
        self.clusters = stream.build_clusters(
            scene.tri_pos, cluster_size=cluster_size).to(self.device)
        if max_visits == "auto":
            cap = (KERNEL_VISIT_CAP if self.device.type == "cuda"
                   else TWIN_VISIT_CAP)
            max_visits = min(self.clusters.num_clusters, cap)
        self.max_visits = int(max_visits)
        self._isect, self._occl = tiled.tiled_intersectors(
            self.clusters, self.max_visits)
        self._reset_on_camera_move = bool(reset_on_camera_move)
        self.frame_stats: Dict[str, float] = {}
        self._frames_done = 0

    def init_state(self, seed: int = 0) -> state_mod.FrameState:
        return state_mod.init_state(self.config.num_pixels, seed, self.device)

    def render_frame(self, st: state_mod.FrameState, camera: Camera):
        """One progressive frame: (new_state, aux AOV dict). Accumulation
        restarts when the camera's pose differs in value from the one the
        state accumulated."""
        t0 = time.perf_counter()
        camera = camera.to(self.device)
        if self._reset_on_camera_move:
            sig = camera.signature()
            if st.camera_sig is not None and sig != st.camera_sig:
                st = state_mod.reset_accumulation(st)
            st = dataclasses.replace(st, camera_sig=sig)
        with torch.no_grad():
            out = wavefront.render_wavefront(
                self.scene, self._isect, self._occl, camera,
                sampling.generator_uniforms(st.generator), st.frame_index,
                self.config)
            accum = tonemap.blend_accumulate(
                st.accum, wavefront.merge_channels(out), st.blend_count)
        new_st = dataclasses.replace(
            st, accum=accum, blend_count=st.blend_count + 1,
            frame_index=st.frame_index + 1)
        aux = {k: out[k] for k in ("depth", "normal", "albedo", "motion",
                                   "overflow", "debug_first_bad")
               if k in out}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        overflow = bool(out["overflow"])
        if self.config.debug_checks:
            bad = wavefront.decode_debug_stage(int(out["debug_first_bad"]))
            if bad is not None:
                raise RuntimeError(f"debug_checks: non-finite value first "
                                   f"produced by stage {bad!r}")
        self._frames_done += 1
        self.frame_stats = {
            "Total Frame Time": (time.perf_counter() - t0) * 1e3,
            "Frame": self._frames_done,
            "overflow": overflow,
        }
        return new_st, aux

    def render(self, camera: Camera, spp: int = 16, seed: int = 0):
        """Render `spp` progressive frames; (H,W,3) float radiance."""
        st = self.init_state(seed)
        for _ in range(spp):
            st, _ = self.render_frame(st, camera)
        return st.accum.reshape(self.config.height, self.config.width,
                                3).cpu().numpy()

    def render_png(self, camera: Camera, path: str, spp: int = 16,
                   exposure: float = 1.0):
        img = self.render(camera, spp)
        u8 = tonemap.to_uint8(tonemap.tonemap_gamma(torch.from_numpy(img),
                                                    exposure=exposure))
        tonemap.save_png(path, u8.numpy())
        return img

    def get_last_frame_stats(self) -> Dict[str, float]:
        return dict(self.frame_stats)
