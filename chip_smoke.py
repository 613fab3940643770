#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one line each (any failure raises, so the exit code is non-zero):
  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build kernel K1 (ops/csrc/visit_scan.cu) with nvcc from this checkout;
  3. K1 against its plain PyTorch twin on the card: 1,024 tiles each of a
     2560x1440 bounce pass and shadow pass of the interior scene, closest
     and any mode, with kernel and twin times per call;
  4. the slice at 320x180: one frame through the kernel and one through the
     twin from the same generator seed;
  5. the slice at full size: Renderer(accel="tiled") on the interior scene
     (600 boxes, 64 lights), 2560x1440, 1 spp, depth 5, Disney + MIS:
     1 warm-up and 5 timed frames; both K1 launch counters must be > 0.
Then a JSON line of per-kernel results, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}. Needs no network; exits
non-zero without a CUDA device or without the package next to it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
W, H = 2560, 1440
SMALL_W, SMALL_H = 320, 180
SUBSET_TILES = 1024
MATCH_FRACTION = 0.9999      # K1 vs twin: identical keys / bits
PIXEL_FRACTION = 0.999       # small slice: pixels within PIXEL_RTOL
PIXEL_RTOL, PIXEL_ATOL = 1e-3, 1e-4
TIMED_FRAMES = 5


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_environment():
    import torch

    from lumenrenderer_tpu_torch.ops.visit_scan import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    say("1 environment", torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=repr(nvcc[-1]), gpu=repr(smi_line()),
        devices=torch.cuda.device_count())


def phase_build():
    from lumenrenderer_tpu_torch.ops import visit_scan as vs

    seconds, log = vs.build_library(force=True)
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln
             or "spill" in ln]
    say("2 build", seconds=f"{seconds:.2f}", library=vs.library_path().name,
        ptxas=repr(" | ".join(ptxas)))
    return seconds


def _scene(dev):
    from lumenrenderer_tpu_torch.scene import presets

    builder, camf = presets.interior_scene(n_boxes=600, n_lights=64)
    return builder.build().to(dev), camf


def _secondary_passes(sc, cs, cam, dev, w, h, max_visits):
    """Scan inputs of one bounce pass and one shadow pass, each sorted as
    the frame sorts them (octant|morton, capsule)."""
    import torch

    from lumenrenderer_tpu_torch.accel import sorting, tiled
    from lumenrenderer_tpu_torch.bsdf import disney
    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.core.camera import generate_primary_rays
    from lumenrenderer_tpu_torch.integrator import nee
    from lumenrenderer_tpu_torch.integrator.surface import \
        extract_surface_data

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    uni = sampling.generator_uniforms(gen)
    o, d = generate_primary_rays(cam, w, h, 0, uni, "random")
    hits = tiled.intersect_closest(cs, o, d, 1e-3, 1e9, max_visits)
    sd = extract_surface_data(sc, o, d, hits["tri"], with_tangent=False)
    eps = 1e-3
    wi = disney.sample(sd, -d, uni(w * h, 4))[0]
    side = torch.sign((sd.geo_normal * wi).sum(-1))[:, None]
    bo = sd.position + sd.geo_normal * side * eps
    ls = nee.sample_light(nee.build_light_table(sc), uni(w * h, 3),
                          sd.position)
    so = sd.position + sd.geo_normal * eps

    # the frame's own sort, with the query replaced by a capture of its
    # visit-scan inputs
    passes = {}

    def capture(name):
        def query(o_, d_, tn, tx):
            passes[name] = tiled.scan_inputs(cs, o_, d_, tn, tx, max_visits)
            if name == "shadow":
                return torch.zeros(o_.shape[0], dtype=torch.bool, device=dev)
            return {"tri": torch.zeros(o_.shape[0], device=dev),
                    "overflow": passes[name]["overflow"]}
        return query

    pts = sc.tri_pos.reshape(-1, 3)
    s_isect, s_occl = sorting.sorted_intersectors(
        capture("bounce"), capture("shadow"), pts.amin(0), pts.amax(0))
    s_isect(bo, wi, eps, torch.where(sd.valid, 1e9, -1.0))
    s_occl(so, ls.wi, eps, torch.where(sd.valid & ls.valid,
                                       ls.dist - 2 * eps, -1.0))
    return passes


def _subset(q, n_tiles):
    import torch

    rf_t, feats, sel, nv, tnb = q["args"]
    idx = torch.linspace(0, rf_t.shape[0] - 1, n_tiles,
                         device=rf_t.device).long()
    return (rf_t[idx].contiguous(), feats, sel[idx].contiguous(),
            nv[idx].contiguous(), tnb[idx].contiguous())


def _compare(kern, twin, closest, low_bits):
    """(mismatches, non-tie mismatches, max |t| difference or bit diff)."""
    import torch

    from lumenrenderer_tpu_torch.ops.visit_scan import KEY_MISS

    diff = kern != twin
    if not closest:
        return int(diff.sum()), int(diff.sum()), float(diff.any())
    mask = ~((1 << low_bits) - 1)
    tk = (kern & mask).view(torch.float32)
    tt = (twin & mask).view(torch.float32)
    both = (kern < KEY_MISS) & (twin < KEY_MISS)
    quantum = torch.maximum(tk, tt) * 2.0 ** -(23 - low_bits)
    tie = both & ((tk - tt).abs() <= quantum)
    err = float((tk - tt).abs()[both].max()) if bool(both.any()) else 0.0
    return int(diff.sum()), int((diff & ~tie).sum()), err


def phase_kernel_vs_twin(dev, w=W, h=H, n_tiles=SUBSET_TILES):
    import torch

    from lumenrenderer_tpu_torch.accel import stream
    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.render.renderer import KERNEL_VISIT_CAP

    sc, camf = _scene(dev)
    cs = stream.build_clusters(sc.tri_pos, cluster_size=128).to(dev)
    mv = min(cs.num_clusters, KERNEL_VISIT_CAP)
    passes = _secondary_passes(sc, cs, camf(w / h).to(dev), dev, w, h, mv)
    results = {}
    for mode, closest in (("closest", True), ("any", False)):
        worst, total, timing = 0.0, 0, []
        for name, q in passes.items():
            args = _subset(q, n_tiles)
            kw = dict(q["kw"], closest=closest)
            kern = vs.visit_scan(*args, **kw)
            twin = vs.visit_scan_ref(*args, **kw)
            torch.cuda.synchronize()
            mism, bad, err = _compare(kern, twin, closest,
                                      kw["low_bits"])
            rays = kern.numel()
            if mism > (1 - MATCH_FRACTION) * rays or bad:
                raise AssertionError(
                    f"K1 {mode} vs twin on the {name} pass: {mism} of "
                    f"{rays} differ, {bad} not ties")
            ms = cuda_time_ms(lambda: vs.visit_scan(*args, **kw))
            plain_ms = cuda_time_ms(lambda: vs.visit_scan_ref(*args, **kw),
                                    reps=2)
            full_ms = cuda_time_ms(lambda: vs.visit_scan(*q["args"], **kw))
            say("3 kernel", mode=mode, rays=name, tiles=n_tiles, rays_n=rays,
                mismatches=mism, non_ties=bad, max_abs_err=err,
                kernel_ms=f"{ms:.4f}", twin_ms=f"{plain_ms:.4f}",
                full_frame_tiles=q["args"][0].shape[0],
                full_frame_kernel_ms=f"{full_ms:.4f}")
            worst = max(worst, err)
            total += mism
            timing.append((ms, plain_ms))
        results[mode] = {"max_abs_err": worst, "mismatches": total,
                         "ms": sum(a for a, _ in timing) / len(timing),
                         "plain_ms": sum(b for _, b in timing) / len(timing)}
    return results


def phase_small_slice(dev, w=SMALL_W, h=SMALL_H):
    import torch

    from lumenrenderer_tpu_torch.accel import stream, tiled
    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.integrator import wavefront as wf
    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.render.renderer import KERNEL_VISIT_CAP

    sc, camf = _scene(dev)
    cam = camf(w / h).to(dev)
    cs = stream.build_clusters(sc.tri_pos, cluster_size=128).to(dev)
    mv = min(cs.num_clusters, KERNEL_VISIT_CAP)
    cfg = wf.RenderConfig(width=w, height=h, max_depth=5, bsdf="disney",
                          light_strategy="mis", extract_tangent=False)
    imgs = []
    for scan in (vs.visit_scan, vs.visit_scan_ref):
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        isect, occl = tiled.tiled_intersectors(cs, mv, scan=scan)
        with torch.no_grad():
            out = wf.render_wavefront(sc, isect, occl, cam,
                                      sampling.generator_uniforms(gen), 0,
                                      cfg)
        imgs.append(wf.merge_channels(out))
    a, b = imgs
    ok = torch.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)
    frac = float(ok.float().mean())
    finite = bool(torch.isfinite(a).all())
    say("4 small slice", size=f"{w}x{h}", pixels_agree=f"{frac:.6f}",
        finite=finite, mean=f"{float(a.mean()):.6f}")
    if frac < PIXEL_FRACTION or not finite or float(a.mean()) <= 0:
        raise AssertionError(f"kernel and twin frames differ: {frac}")


def phase_full_slice(dev, w=W, h=H, frames=TIMED_FRAMES):
    import torch

    from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.render.renderer import Renderer
    from lumenrenderer_tpu_torch.scene import presets

    builder, camf = presets.interior_scene(n_boxes=600, n_lights=64)
    sc, cam = builder.build(), camf(w / h)
    cfg = RenderConfig(width=w, height=h, max_depth=5, bsdf="disney",
                       light_strategy="mis")
    r = Renderer(sc, cfg, accel="tiled", device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    vs.reset_launches()
    st = r.init_state(0)
    st, _ = r.render_frame(st, cam)
    warm_ms = r.frame_stats["Total Frame Time"]
    overflow = r.frame_stats["overflow"]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(frames):
        st, _ = r.render_frame(st, cam)
        overflow = overflow or r.frame_stats["overflow"]
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) / frames * 1e3
    launches = dict(vs.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    img = st.accum
    finite = bool(torch.isfinite(img).all())
    mean = float(img.mean())
    say("5 full slice", size=f"{w}x{h}", tris=sc.num_triangles,
        clusters=r.clusters.num_clusters, max_visits=r.max_visits,
        warmup_ms=f"{warm_ms:.1f}", ms_per_frame=f"{ms:.1f}",
        primary_rays_per_s=f"{w * h / ms * 1e3:.4g}",
        peak_mem_gib=f"{peak / 2**30:.2f}", overflow=overflow,
        mean=f"{mean:.5f}", finite=finite, launches=json.dumps(launches))
    if not finite or mean <= 0 or overflow:
        raise AssertionError(f"bad frame: finite={finite} mean={mean} "
                             f"overflow={overflow}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"K1 not launched on the main path: {launches}")
    return launches


def main() -> int:
    if not (REPO / "lumenrenderer_tpu_torch" / "ops" / "csrc"
            / "visit_scan.cu").is_file():
        print("chip_smoke: lumenrenderer_tpu_torch is not next to this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    phase_environment()
    phase_build()
    k1 = phase_kernel_vs_twin(dev)
    phase_small_slice(dev)
    launches = phase_full_slice(dev)

    src = "lumenrenderer_tpu_torch/ops/csrc/visit_scan.cu"
    kernels = [{"name": f"visit_scan[{mode}]", "route": "cuda", "source": src,
                "replaces": "lumenrenderer_tpu/ops/pallas/intersect.py:323",
                "launches": launches[mode],
                "max_abs_err": k1[mode]["max_abs_err"],
                "ms": k1[mode]["ms"], "plain_ms": k1[mode]["plain_ms"]}
               for mode in ("closest", "any")]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
