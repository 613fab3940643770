"""Command-line renderer: port of `lumenrenderer_tpu/app/cli.py`.

Reads a JSON config (`utils/config.py`, written with the defaults when
missing), builds the scene (a glTF file through the scene cache, or a
preset), renders progressively on the CUDA device, then denoises, upscales
and tonemaps the image and writes a PNG, with the AOVs beside it on request.

Usage:
  python -m lumenrenderer_tpu_torch.app.cli [config.json]
  python -m lumenrenderer_tpu_torch.app.cli --preset cornell --spp 64 -o out.png

`--cpu` renders on the CPU (the kernels' plain twins); without it and
without a CUDA device the Renderer raises and the command exits non-zero.

`--spans` records the program's spans in every frame (`utils/profiling.py`)
and prints, with the mean stage times at the end, each span's mean self
host ms and, on the card, self device ms a frame ("<span> self host",
"<span> self device").

`--distributed` joins the process group that torchrun describes
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK; NCCL, or gloo with `--cpu`),
and `--mesh` shards the frame's rows over its ranks (a one-rank group
without `--distributed`); rank 0 writes the PNGs and the log lines:
  torchrun --nproc_per_node 2 -m lumenrenderer_tpu_torch.app.cli \
      --mesh --distributed --cpu --preset cornell --size 32x32 -o out.png
"""
from __future__ import annotations

import argparse
import contextlib
import sys

import numpy as np


def build_scene(cfg):
    """(SceneData, Camera) of the config: its glTF file framed from a
    corner of its bounds, or its preset."""
    from ..core.camera import Camera
    from ..scene import presets

    w, h = cfg.render_resolution
    if cfg.scene_path:
        from ..scene.cache import load_or_build

        scene = load_or_build(cfg.scene_path)
        pts = scene.tri_pos.reshape(-1, 3).cpu().numpy()
        lo, hi = pts.min(0), pts.max(0)
        c = (lo + hi) / 2
        ext = float(np.linalg.norm(hi - lo))
        cam = Camera.look_at(eye=tuple(c + np.array([0.4, 0.3, 1.0]) * ext),
                             target=tuple(c), fov_y_deg=45.0, aspect=w / h)
        return scene, cam
    maker = {
        "cornell": lambda: presets.cornell_box(bsdf_extras=True),
        "interior": lambda: presets.interior_scene(),
        "furnace": lambda: presets.furnace_scene(),
    }[cfg.preset]
    builder, camf = maker()
    return builder.build(), camf(w / h)


def _size(text: str):
    w, h = text.lower().split("x")
    return int(w), int(h)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="lumenrenderer_tpu_torch headless renderer")
    p.add_argument("config", nargs="?",
                   help="JSON config path (written with defaults if missing)")
    p.add_argument("--preset", default=None)
    p.add_argument("--scene", default=None, help="glTF/GLB path")
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--size", default=None, help="WxH render resolution")
    p.add_argument("--out-size", default=None,
                   help="WxH output resolution (upscaled)")
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--restir", action="store_true")
    p.add_argument("--denoise", action="store_true")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--aovs", action="store_true", help="also dump AOV PNGs")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU instead of the CUDA device")
    p.add_argument("--debug-checks", action="store_true",
                   help="NaN/Inf guard: abort naming the first bad stage")
    p.add_argument("--no-mipmaps", action="store_true")
    p.add_argument("--transmittance", choices=("riemann", "ratio"),
                   default=None, help="volume shadow transmittance estimator")
    p.add_argument("--stats-every", type=int, default=0,
                   help="refresh per-stage FrameStats every N frames")
    p.add_argument("--spans", action="store_true",
                   help="record the program's spans every frame and print "
                        "each span's mean self host and device ms")
    p.add_argument("--mesh", action="store_true",
                   help="shard the frame's rows over the process group's "
                        "ranks")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process: join the torchrun process group "
                        "first")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError(
            "the CLI renders on a CUDA device and none was found; pass "
            "--cpu (device='cpu') to render on the CPU")
    if args.distributed:
        from ..parallel import distributed

        distributed.initialize(backend="gloo" if args.cpu else None)
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        return _render(args, rank)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _render(args, rank: int) -> int:
    import torch

    def log(text: str) -> None:
        if rank == 0:
            print(text, file=sys.stderr)

    if args.distributed:
        from ..parallel import distributed

        log(f"distributed: {distributed.process_info()}")

    from ..utils.config import AppConfig

    cfg = AppConfig.load(args.config) if args.config else AppConfig()
    if args.preset:
        cfg.preset = args.preset
    if args.scene:
        cfg.scene_path = args.scene
    if args.spp:
        cfg.spp = args.spp
    if args.size:
        cfg.render_resolution = _size(args.size)
    if args.out_size:
        cfg.output_resolution = _size(args.out_size)
    if args.depth:
        cfg.max_depth = args.depth
    if args.restir:
        cfg.use_restir = True
    if args.denoise:
        cfg.denoise = True
    if args.output:
        cfg.output_path = args.output

    from ..integrator.wavefront import RenderConfig
    from ..render import tonemap
    from ..render.renderer import Renderer
    from ..utils import profiling
    from ..utils.profiling import FrameStats, Profiler

    scene, cam = build_scene(cfg)
    w, h = cfg.render_resolution
    rc = RenderConfig(
        width=w, height=h, max_depth=cfg.max_depth, bsdf=cfg.bsdf,
        light_strategy=cfg.light_strategy, use_restir=cfg.use_restir,
        debug_checks=args.debug_checks, mipmaps=not args.no_mipmaps,
        volume_transmittance=args.transmittance or "riemann")
    mesh = None
    if args.mesh:
        from ..parallel import shard

        mesh = shard.make_mesh("cpu" if args.cpu else "cuda")
        log(f"mesh: {mesh}")
    renderer = Renderer(scene, rc, accel=cfg.accel, mesh=mesh,
                        stats_every=args.stats_every,
                        device="cpu" if args.cpu else None)
    log(f"scene: {scene.num_triangles} tris, {int(scene.lights.count)} "
        f"lights; {w}x{h} depth={cfg.max_depth} spp={cfg.spp} "
        f"restir={cfg.use_restir} accel={cfg.accel} "
        f"device={renderer.device}")
    st = renderer.init_state(cfg.seed)
    prof = Profiler()
    aux = {}
    with (profiling.recording() if args.spans
          else contextlib.nullcontext()):
        for i in range(cfg.spp):
            st, aux = renderer.render_frame(st, cam)
            stats = renderer.get_last_frame_stats()
            fs = FrameStats(i)
            fs.times_ms = {k: v for k, v in stats.items()
                           if isinstance(v, float)}
            if "spans" in stats:
                fs.add_spans(stats["spans"])
            prof.add(fs)
            if (i + 1) % 8 == 0 or i == 0:
                log(f"frame {i + 1}/{cfg.spp}  "
                    f"{stats['Total Frame Time']:.1f} ms")

    # under a mesh, every rank's rows
    img = renderer.full_frame(st.accum)
    aux = {k: (renderer.full_frame(v) if v.ndim else v)
           for k, v in aux.items()}
    if rank != 0:
        return 0
    if cfg.denoise:
        from ..render.denoise import denoise_frame

        img = denoise_frame(img, aux, w, h)
    hw_img = img.reshape(h, w, 3)
    ow, oh = cfg.output_resolution
    if (ow, oh) != (w, h):
        from ..render.upscale import upscale

        hw_img = upscale(hw_img, oh, ow)
    tm = (tonemap.tonemap_aces if cfg.tonemap == "aces"
          else tonemap.tonemap_gamma)
    u8 = tonemap.to_uint8(tm(hw_img, exposure=cfg.exposure))
    tonemap.save_png(cfg.output_path, u8.cpu().numpy())
    print(f"wrote {cfg.output_path}", file=sys.stderr)

    if args.aovs:
        base = cfg.output_path.rsplit(".", 1)[0]
        for name in ("albedo", "normal", "depth"):
            a = aux[name].cpu().numpy()
            if a.ndim == 1:
                a = a / max(a.max(), 1e-6)
                a = np.stack([a] * 3, -1)
            a = np.abs(a).reshape(h, w, 3)
            tonemap.save_png(f"{base}.{name}.png", tonemap.to_uint8(
                torch.from_numpy(np.clip(a, 0, 1))).numpy())
        print(f"wrote AOVs {base}.{{albedo,normal,depth}}.png",
              file=sys.stderr)
    print(f"mean stage times: {prof.summary()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
