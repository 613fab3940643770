#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one line each or more (any failure raises, so the exit code is
non-zero), each with its seconds:
  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build kernels K1, K2, K3, W and T and the tensor-core probe
     (ops/csrc/*.cu) with nvcc from this checkout, one nvcc each, all at
     once; ptxas registers and spills;
  3. K1 against its plain PyTorch twin on the card: 1,024 tiles each of the
     interior scene's 2560x1440 primary pass and sorted bounce and shadow
     passes, closest and any mode, with kernel and twin times per call;
     K1's visit counter against `executed_visits_ref` on each subset; the
     kernel on every tile of each pass, with its executed visits per tile,
     flop, bound and share of the bound;
  4. the tiled slice at 320x180: one frame through the kernel and one
     through the twin from the same generator seed;
  4b. the same for a ReSTIR DI frame of the bench's restir scene (600
     boxes, 256 lights) at 320x180 (per-pixel RIS: 180 does not divide by
     16), depth 5, Disney, NEE elsewhere;
  5. the tiled slice at full size: Renderer(accel="tiled") on the interior
     scene (600 boxes, 64 lights), 2560x1440, 1 spp, depth 5, Disney + MIS:
     1 warm-up and 5 timed frames; K1 must launch 5 times per frame in each
     mode; then one more frame under torch.profiler (device kernel time,
     idle share, K1's share, the top kernels), as phases 7 and 9 do for
     theirs with K2 and K3;
  6. K2 against its twin: 1,024 tiles each of the 2560x1440 primary pass
     and sorted bounce and shadow passes of the instanced scene (120 box
     instances and a light: 121 units, 2 unique meshes), closest and any
     mode; K2's visit counter against `executed_visits_instanced_ref` on
     each subset; the kernel on every tile of each pass, with its executed
     visits per tile, flop, bound and share; and K1's full-pass times on the
     bounce and shadow passes through the flattened clusters;
  7. the two-level slice: Renderer(accel="two_level", dynamic=...) on that
     scene at 2560x1440, depth 5, Disney + MIS, 1 warm-up and 3 timed
     frames, held against Renderer(accel="tiled"); then instance 0 moves
     by +50 in x and the next frame is held against a fresh build;
  8. K3 against its twin: 1,024 pair tiles, evenly spaced over the live
     tiles, of the interior scene's 2560x1440 primary pass and sorted
     bounce and shadow passes, with the bound of the live pair tiles; the
     kernel on every tile of each pass, whose dead tiles (every pair dead,
     the run-padded tail) must hold the miss key or 0;
  9. the pair slice: render_wavefront with pair_intersectors on the
     interior scene at 2560x1440, depth 5, Disney + MIS, 1 warm-up and 3
     timed frames, held against the tiled frame from the same seed;
 10. the ReSTIR slice (the JAX bench's restir workload):
     Renderer(accel="tiled") with use_restir on the restir scene (7,722
     triangles, 512 emissive) at 2560x1440, 1 spp, depth 5, Disney, NEE,
     the default RestirConfig (tile-candidate RIS), 1 warm-up and 3 timed
     frames on one camera: ms/frame, peak memory, overflow, reservoir
     invariants, max M growing from frame 1 to 2, K1 launched 5 times
     closest and 6 any per frame (4 NEE shadow passes and ReSTIR's 2
     visibility passes); the 4-frame mean against 4 NEE frames of the same
     scene and seed, in (0.6, 1.05); one profiled frame; each ReSTIR pass
     timed with CUDA events on a frame's depth-0 surface; the round trip of
     light indices bit-cast through float32;
 11. the mega slice (the JAX bench's mega workload): mega_scene(1,000,000
     triangles, 256 lights), 11,670 clusters of 128, culled through the
     cluster tree by kernel W; host build seconds (scene, Renderer, tree);
     W against its twin on every tile of the 2560x1440 primary pass and
     sorted bounce and shadow passes (raw lists, entry t bits, counts, and
     the sorted visit lists sel, nv, tnb and overflow all identical), with
     its full-pass time, the twin's pops (the stopped one-node-a-step
     walk) beside the kernel's own, the admitted
     clusters per tile from one uncapped call, the share of tiles over the
     visit cap and the bound; K1 against its twin on 1,024 tiles of each
     pass and on every tile, as in phase 3; a
     320x180 depth-3 mega frame through K1 and W and through their twins; the
     2560x1440 frame through Renderer(accel="tiled") (1 warm-up and 3 timed
     frames: ms/frame, peak memory, overflow, K1 5 closest and 5 any
     launches and W 10 per frame), one profiled frame, and frames with and
     without the ClusterSet's cached kernel layout;
 11b. two-level past 2048 units: instanced_boxes(2,100) (2,101 units)
     at 2560x1440 through accel="two_level" (K2, W on the unit tree), its
     primary AOVs held against the tiled frame of the same scene with
     culling="tree" by phase 7's rule; W on the unit tree against its twin
     on every tile of the primary, bounce and shadow passes, as in phase
     11; then a 320x180 depth-3 frame through K2 and W and through their
     twins;
 12. the gradient slice (the JAX bench's BENCH_GRAD workload): the mean of
     the 2560x1440 interior frame (600 boxes, 64 lights, depth 5, Disney,
     MIS, remat on) differentiated with respect to every material's
     emissive through Renderer(accel="tiled")'s intersectors, each call
     from a fresh generator of one seed: the forward without and with a
     graph and the backward (ms, mean of 3 after a warm-up), bench.py's
     ratio (forward and backward over the forward), peak memory of each,
     K1's launches per forward and backward (5 closest, 5 any: the
     recompute launches none), a profile of the backward; the gradient
     finite, > 0 on the lights and >= 0 elsewhere, equal to the frame's
     mean through linearity and to a central difference at 1 +- 0.25
     (rtol 2e-3), and to the gradient without remat (rtol 1e-5, with its
     peak memory); a 320x180 gradient through K1 equal to one through its
     twin (rtol 1e-5); 3 Adam steps of `parallel.train.make_train_step` on
     the emissive toward a target rendered at twice the emission, each
     lowering the loss;
 13. the textured slice: presets.interior_scene(600, 64) given UVs (the
     room's quads 0-5, the boxes a box projection divided by 4) and 16
     textures made from a numpy seed (checker and value noise; base colour
     2 at 2048^2 and 6 at 1024^2, 4 normal and 4 metal-rough maps at
     1024^2), written as .gltf, .bin and PNGs in a temporary directory;
     13a: the scene cache built cold by `scene/cache.load_or_build` and
     loaded warm (host seconds, every leaf equal), then a 320x180 depth-3
     textured frame through K1 and through its twin as phase 11's small
     frames; 13b: Renderer(accel="tiled") at 2560x1440, 1 spp, depth 5,
     Disney, MIS, mipmaps on: 1 warm-up and 3 timed frames (ms/frame, peak
     memory, atlas bytes, overflow false, K1 5 closest and 5 any launches a
     frame), one profiled frame, the sampler's texel gather of one level at
     the primary hits timed as `take_rows` and as PyTorch's row gather
     (CUDA events, with its bytes bound), the 3-frame mean with mipmaps
     off within 5% of the mipmapped one, and the same scene without its
     textures timed beside it; 13c: the gradient of the mean of a 640x360 depth-5
     frame (remat on) with respect to the atlas texels and the emissive:
     forward and backward ms, peak memory, a profile of the backward, the
     gradient finite and non-zero on every sampled base-colour texture,
     linear in emission, and (Lambert, no Russian roulette, so no sampling
     decision depends on the base colour) against a central difference of
     the room's base-colour texture's scale at 1 +- 0.01 (rtol 2e-3);
 14. volumes: a 384^3 cloud (sphere_density(384, 0.4, 0.15) times
     noise_density(384, 11), sigma_t 0.5, albedo 0.9) in a box a third of
     the interior's room across; 14a: the port's .nvdb reader against the
     SDK's values for tests/data/sphere_fog.nvdb, the cloud's host seconds
     (grid, dense, sparse) and device bytes, its centre transmittance (in
     0.2-0.6), and 320x180 depth-3 frames with the .nvdb fog re-seated in
     the room and with the dense cloud, each through K1 and its twin as
     phase 11's; 14b: Renderer(accel="tiled") at 2560x1440, depth 5,
     Disney, MIS, volume_steps 5, volume_depths 2, Riemann: 1 warm-up and
     3 timed frames (ms/frame, peak, K1 5 closest and 15 any launches a
     frame: 5 NEE and 10 march light-ray passes), the volumetric channel
     non-zero, one profiled frame, and the room without the cloud timed
     beside it; 14c: the sparse cloud (its mean within 1e-5 of the dense
     frame's), then ratio tracking (ms/frame, launches, a profile, its mean
     within 10% of Riemann's); 14d: the restir workload of phase 10 in the
     cloud, timed against the same frame without it, and its mean below
     the same frame's (same draws) with the cloud's extinction at 0, its
     direct channel at most that frame's everywhere;
     14e: d mean / d density at 2560x1440, remat on (forward, backward,
     peak, K1 5 + 15 launches a forward and backward, a profile of the
     backward), d mean / d bricks of the sparse cloud, remat off within
     1e-5, a 320x180 gradient through K1 against its twin (1e-5), and on a
     BSDF-sampled frame without Russian roulette a central difference of
     the density's scale at 1 +- 0.01 (rtol 1e-2);
 15. the application on the interior at 2560x1440, depth 5, Disney + MIS:
     15a: Renderer(accel="stream") (24 pairs per ray), each query of one
     frame's live pairs, overflow, tiles and product blocks, 1 warm-up and
     3 timed frames (ms/frame, peak), held against the tiled frame of the
     same seed by phase 9's bar, one profiled frame, and a 320x180 depth-3
     stream frame whose closest queries are each held against brute force
     (triangles equal but for ties; primary t within 2e-4 relative + 1e-5,
     tests/test_stream.py's bar); 15b: `denoise_frame` and `upscale` to
     3840x2160 (Lanczos3, sharpen 0.3) of a 1-spp tiled frame (CUDA
     events, mean of 3; launches and device time from one profiled call;
     peak), the denoised frame nearer a 16-frame reference than the raw
     one, the upscaled image finite and >= 0, its weight matrices built on
     the card within 1e-5 of the CPU's (their distance from a float64
     build is printed); 15c: `render_sequence` over a 3-camera pan with
     temporal denoising (ms per camera), and on a static camera the
     temporal output's flicker below the raw frames'; 15d: a checkpoint
     after 2 frames loaded into init_state(999), the next frame equal to
     the uninterrupted one within 1e-6 (file bytes, save and load ms);
     15e: `profile_stages` of the interior frame, then the CLI in
     subprocesses on the card: a JSON config naming the tiled accel,
     `--preset interior --size 2560x1440 --out-size 3840x2160 --spp 4
     --depth 5 --denoise --aovs --stats-every 2` (its main called by
     `python -c`, which prints K1's launches after it: 48 closest and 44
     any), writing a 3840x2160 PNG and three AOV PNGs (wall seconds, its
     mean stage times), and `python -m lumenrenderer_tpu_torch.app.cli
     --preset cornell --spp 4` with the defaults (stream, 1280x720). The
     `kernels` line's K1 rows carry that CLI run's launches as
     `launches_app`;
 16. the BVH accels and the mesh on the interior at 2560x1440: the SAH
     BVH built by the native and the numpy builders (host seconds) and the
     LBVH on the card (ms), and kernel T's node and slot records made in
     those builds (ms: the SAH BVH's on the host, both on the card); 16a:
     kernel T against its twin on 65,536
     evenly spaced rays of the primary pass and the sorted bounce and
     shadow passes, through the SAH BVH and the LBVH, closest and any
     mode (triangles or hit bits identical on MATCH_FRACTION, t, u and v
     bit for bit where the triangle agrees, the walk counters identical),
     then T on every ray of each pass (its time, counter-derived
     operations, bound and share); 16b: Renderer(accel="sah") and
     Renderer(accel="lbvh"), depth 5, Disney + MIS, 1 warm-up and 3 timed
     frames (ms/frame, peak memory, T 5 closest and 5 any launches a
     frame), held against the tiled frames of the same seed by phase 9's
     bar, one profiled frame each; 16c: a one-rank NCCL mesh: the tiled
     frame through Renderer(mesh=), its accumulator equal to the plain
     one's element for element (K1 10 launches
     a frame), the ReSTIR frame with its halo, one sharded training step
     at 2560x1440 (remat) and its gradient all-reduce; then two ranks on
     the one card in subprocesses (`--rank-worker`; gloo, collectives
     staged through the host, as NCCL refuses two ranks on one device),
     720 rows each: the gathered 4-frame image's mean within MEAN_RTOL of
     the plain frames', its seam rows lit, two ReSTIR frames with the
     halo, a 320x180 training step whose parameters are equal on both
     ranks. The `kernels` line has T's rows for the SAH BVH and the LBVH;
 17. the options on the interior at 2560x1440, depth 5, Disney + MIS:
     17h (run first): the tensor cores: the probe (ops/mma_probe.py), one
     m16n8k16 bf16 product per case on crafted sums, compared bit for bit
     with candidate models of its rounding (its table; fails unless the
     bf16 twins' model, `visit_scan.MMA_MODEL`, fits every sum of the
     kernels' kind), and the SASS of K1's, K2's and K3's bf16 kernels
     (HMMA in their loops; the loop's other instructions on the no-hit
     path a pair, and K2's visit loop's instructions outside it a
     ray-visit, for the epilogue bound);
     17a: K1 in its bf16 mode (precision="default", on the tensor cores)
     against its twin (`mma_product`) on 1,024 tiles of each of the
     primary, sorted bounce and shadow passes, closest and any, keys, bits
     and visit counters torch.equal; every tile of each pass in bf16 and
     in fp32 (times in this call, flop, bound, the epilogue bound, shares)
     and the share of live rays whose winner or bit differs from fp32
     (printed, not barred: bf16 geometry is lossy by design); 17b: the
     same for K2 on 256 tiles of each of phase 6's passes (its twin's
     exact sum is slow) and K3 on phase 8's pair tiles, then a
     two-level bf16 frame (K2's bf16 launches) and a bf16 pair frame
     (K3's); 17c: Renderer(candidate_dtype="bfloat16"), 1
     warm-up and 3 timed frames beside the default frame's (ms/frame, K1
     bf16 launches, 5 closest and 5 any a frame, the mean beside fp32's);
     17d: culling="dense" at max_visits = C = 84 (ms/frame, peak memory,
     admitted clusters and visits run per primary tile against the
     frustum's), held against the frustum frame by phase 7's rule and
     MEAN_RTOL; 17e: swizzle=True (ms/frame, K1's visits per primary tile
     with and without the swizzle, the mean within MEAN_RTOL, primary
     AOVs by phase 7's rule on frames of pixel centres); 17f: decode=True
     on the sorted bounce pass (its extra ms; t within the key's
     resolution, and on 65,536 rays u, v within DECODE_UV_TOL of brute,
     plus DECODE_UV_ROUNDINGS float32 roundings of the two formulas'
     condition, on every ray whose triangle agrees); 17g: a bounce and
     a shadow pass through `blocked_sorted_intersectors` beside
     `sorted_intersectors` (pass ms, K1's visits per tile). The `kernels`
     line gains the bf16 rows of K1, K2 and K3 (their bytes count the
     table at 2 bytes a value, their flop go at the bf16 tensor-core rate;
     they also carry their design, the epilogue bound, its share and
     which bound sets their pace, and K2's its instructions a ray-visit).
Then a JSON line of per-kernel results, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}. Needs no network; exits
non-zero without a CUDA device or without the package next to it.

The epilogue bound of the bf16 modes: the live pairs (flop / 80, less
K2's affine flop) times the CUDA-core instructions a pair (17h's SASS
count), plus for K2 the live ray-visits times its instructions a ray-visit
(17h), over 132 SMs x 128 lanes at the card's maximum SM clock
(nvidia-smi). Bounds: a kernel's
least time is the larger of its flop over the H100's
67 TFLOP/s of fp32 (no tensor cores; the bf16 rows: 989 TFLOP/s, the
bf16 tensor-core rate, the peak for bf16 operands) and its bytes (each input read once,
each output written once) over 3.35 TB/s. The flop are those these inputs
need: 80 per (live ray, live triangle) pair of every visit a tile runs (K1
and K2: the kernel's counter) or of every live pair tile (K3), and K2's 42
per live ray and visit run for the object-space features; the bytes leave
out K2's padding rows of `rayblk`, which it never reads, and count K2's
per-visit inputs (cluster id, entry t, affine) for the visits run only.
Kernel W: BOX_TEST_OPS operations per box test, one for each tile's root
and two per internal node of the one-node-a-step walk stopped at mv + 1
leaves (the twin's pop counter less the leaves it counted: the kernel pops
other nodes); its bytes are the tiles' bounds, the tree, and the lists and
counts out. Kernel T: its own BOX_TEST_OPS (26) per box test (each ray's
root and two per internal node popped) and SLOT_TEST_OPS (54) per leaf slot
tested, from its counters; its bytes are the rays in, the results out and the BVH once. No
single PyTorch call computes any of the five functions, so library_ms is
null.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
W, H = 2560, 1440
SMALL_W, SMALL_H = 320, 180
SUBSET_TILES = 1024
MATCH_FRACTION = 0.9999      # kernel vs twin: identical keys / bits
PIXEL_FRACTION = 0.999       # small slice: pixels within PIXEL_RTOL
PIXEL_RTOL, PIXEL_ATOL = 1e-3, 1e-4
AOV_TOL = 1e-3               # full slices: primary depth and normal
MEAN_RTOL = 0.01             # full slices: image means
TIMED_FRAMES = 5
SLICE_FRAMES = 3             # timed frames of phases 7, 9 and 10
RESTIR_LIGHTS = 256          # the JAX bench's restir scene
RESTIR_RATIO = (0.6, 1.05)   # ReSTIR / NEE image mean (biased reuse)
N_INSTANCES = 120
PAIRS_PER_RAY = 8
KERNELS = ("visit_scan", "visit_scan_instanced", "pair_scan", "tree_walk",
           "bvh_traverse", "mma_probe")
MEGA_TRIS, MEGA_LIGHTS = 1_000_000, 256      # the JAX bench's mega scene
UNITS_INSTANCES = 2100       # phase 11b: 2,101 units
GRAD_RTOL = 2e-3             # phase 12: linearity, central difference
REMAT_RTOL = 1e-5            # phase 12: remat off, K1 against its twin
TRAIN_STEPS, TRAIN_LR = 3, 0.05
PEAK_FLOPS = 67e12           # H100 SXM, fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # H100 SXM, bf16 on the tensor cores, dense
PEAK_BYTES = 3.35e12         # H100 SXM, HBM3
SMS, LANES = 132, 128        # H100 SXM: SMs, lanes issued a cycle per SM
MMA_DESIGN = "mma.sync m16n8k16"
MMA_ENTRIES = {              # the bf16 tensor-core kernels at K = 128
    ("visit_scan", "closest"): "visit_scan_mma_kernelILi128ELb1E",
    ("visit_scan", "any"): "visit_scan_mma_kernelILi128ELb0E",
    ("visit_scan_instanced", "closest"):
        "visit_scan_instanced_mma_kernelILi128ELb1E",
    ("visit_scan_instanced", "any"):
        "visit_scan_instanced_mma_kernelILi128ELb0E",
    ("pair_scan", "closest"): "pair_scan_mma_kernelILi128ELb1E",
    ("pair_scan", "any"): "pair_scan_mma_kernelILi128ELb0E",
}
MMA_PAIRS_PER_LANE = 4       # a lane's pairs per group: 4 rays, 1 triangle
FLOP_PER_PAIR = 80           # 40 FMAs per ray-triangle test
AFFINE_FLOP = 42             # K2: a ray's object-space features per visit
REPLACES = {
    "visit_scan": "lumenrenderer_tpu/ops/pallas/intersect.py:325",
    "visit_scan_instanced": "lumenrenderer_tpu/ops/pallas/instanced.py:168",
    "pair_scan": "lumenrenderer_tpu/ops/pallas/pair_intersect.py:129",
    "tree_walk": "lumenrenderer_tpu/accel/tiled.py:113 (XLA while_loop, no "
                 "Pallas kernel)",
    "bvh_traverse": "lumenrenderer_tpu/accel/traverse.py:60 "
                    "_traverse_scalar (XLA while_loop under vmap, no Pallas "
                    "kernel)",
}


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


def timed_frames(render_one, frames: int) -> float:
    """ms per frame of `frames` calls of render_one(), on the host clock
    around work that ends in a device synchronisation."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        render_one()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / frames * 1e3


def phase_environment():
    import torch

    from lumenrenderer_tpu_torch.ops.build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    say("1 environment", torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=repr(nvcc[-1]), gpu=repr(smi_line()),
        devices=torch.cuda.device_count())


def phase_build():
    from lumenrenderer_tpu_torch.ops import build

    t0 = time.perf_counter()
    results = build.build_libraries(KERNELS, force=True)
    for name in KERNELS:
        seconds, log = results[name]
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln
                 or "spill" in ln]
        say("2 build", kernel=name, seconds=f"{seconds:.2f}",
            library=build.library_path(name).name,
            ptxas=repr(" | ".join(ptxas)))
    say("2 build", wall_seconds=f"{time.perf_counter() - t0:.2f}")


def _scene(dev):
    from lumenrenderer_tpu_torch.scene import presets

    builder, camf = presets.interior_scene(n_boxes=600, n_lights=64)
    return builder.build().to(dev), camf


def _secondary_passes(sc, cs, cam, dev, w, h, capture, primary=False,
                      sort=None):
    """capture(o, d, tn, tx) of one bounce pass and one shadow pass, each
    sorted as the frame sorts them (octant|morton, capsule; or by `sort`,
    a wrapper with `sorting.sorted_intersectors`' signature), and with
    `primary` of the (unsorted) primary pass first; primary hits come from
    the tiled intersector over the flattened clusters `cs`."""
    import torch

    from lumenrenderer_tpu_torch.accel import sorting, tiled
    from lumenrenderer_tpu_torch.bsdf import disney
    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.core.camera import generate_primary_rays
    from lumenrenderer_tpu_torch.integrator import nee
    from lumenrenderer_tpu_torch.integrator.surface import \
        extract_surface_data
    from lumenrenderer_tpu_torch.render.renderer import KERNEL_VISIT_CAP

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    uni = sampling.generator_uniforms(gen)
    o, d = generate_primary_rays(cam, w, h, 0, uni, "random")
    passes = {"primary": capture(o, d, 1e-3, 1e9)} if primary else {}
    hits = tiled.intersect_closest(cs, o, d, 1e-3, 1e9,
                                   min(cs.num_clusters, KERNEL_VISIT_CAP),
                                   decode=False)
    sd = extract_surface_data(sc, o, d, hits["tri"], with_tangent=False)
    eps = 1e-3
    wi = disney.sample(sd, -d, uni(w * h, 4))[0]
    side = torch.sign((sd.geo_normal * wi).sum(-1))[:, None]
    bo = sd.position + sd.geo_normal * side * eps
    ls = nee.sample_light(nee.build_light_table(sc), uni(w * h, 3),
                          sd.position)
    so = sd.position + sd.geo_normal * eps

    # the frame's own sort, with the query replaced by a capture of its
    # kernel's inputs

    def query(name):
        def fn(o_, d_, tn, tx):
            passes[name] = capture(o_, d_, tn, tx)
            if name == "shadow":
                return torch.zeros(o_.shape[0], dtype=torch.bool, device=dev)
            return {"tri": torch.zeros(o_.shape[0], device=dev),
                    "overflow": passes[name]["overflow"]}
        return fn

    pts = sc.tri_pos.reshape(-1, 3)
    s_isect, s_occl = (sort or sorting.sorted_intersectors)(
        query("bounce"), query("shadow"), pts.amin(0), pts.amax(0))
    s_isect(bo, wi, eps, torch.where(sd.valid, 1e9, -1.0))
    s_occl(so, ls.wi, eps, torch.where(sd.valid & ls.valid,
                                       ls.dist - 2 * eps, -1.0))
    return passes


def _tile_subset(args, shared, n_tiles):
    """Evenly spaced tiles of per-tile arguments; args[shared] (the cluster
    table) is taken whole."""
    import torch

    tiles = args[0].shape[0]
    idx = torch.linspace(0, tiles - 1, n_tiles, device=args[0].device).long()
    return tuple(a if i == shared else a[idx].contiguous()
                 for i, a in enumerate(args))


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


def bound_ms(flop, nbytes, peak=PEAK_FLOPS):
    """(least ms, what sets it) for `flop` operations at `peak` flop/s (fp32
    by default) and `nbytes`."""
    ops_ms = flop / peak * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def _nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def _live_tris(feats, k):
    """(C,) live triangles per cluster (or unit mesh cluster)."""
    from lumenrenderer_tpu_torch.ops.visit_scan import slab_layout

    return slab_layout(feats, k)[1].double()


def visit_flop(live_rays, live_tris, sel, ran):
    """Flop of the visits that tiles run: live_rays (T,) per tile, live_tris
    (C,) per cluster, sel (T, mv) cluster ids, ran (T,) visits run."""
    import torch

    sel = sel.long().clamp(0, live_tris.shape[0] - 1)
    mask = torch.arange(sel.shape[1], device=sel.device)[None] < ran[:, None]
    return FLOP_PER_PAIR * float((live_rays.double()[:, None]
                                  * live_tris[sel] * mask).sum())


def hold_against_twin(phase, label, passes, subset, kernel, twin, low_bits,
                      exact_bits, work):
    """Each pass's subset through kernel and twin, in both modes: raise
    unless at least MATCH_FRACTION of keys (bits) are identical and every
    other key is a tie (exact_bits: every bit identical); print times, and
    the bound of the subset and of the full pass from `work(q, args,
    closest, is_subset)` -> (flop, bytes, extra fields to print). Returns per
    mode max_abs_err, mismatches, and means over the passes of ms,
    plain_ms, bound_ms, full_pass_ms and full_pass_bound_ms, with
    bound_by."""
    import torch

    results = {}
    for mode, closest in (("closest", True), ("any", False)):
        worst, total, rows = 0.0, 0, []
        for name, q in passes.items():
            args = subset(q)
            kw = dict(q["kw"], closest=closest)
            kern = kernel(*args, **kw)
            ref = twin(*args, **kw)
            torch.cuda.synchronize()
            lb = low_bits(q)
            mism, bad, err = _compare(kern, ref, closest, lb)
            rays = kern.numel()
            if (mism > (1 - MATCH_FRACTION) * rays or (closest and bad)
                    or (exact_bits and not closest and mism)):
                raise AssertionError(
                    f"{label} {mode} vs twin on the {name} pass: {mism} of "
                    f"{rays} differ, {bad} not ties")
            ms = cuda_time_ms(lambda: kernel(*args, **kw))
            plain_ms = cuda_time_ms(lambda: twin(*args, **kw), reps=2)
            full_ms = cuda_time_ms(lambda: kernel(*q["args"], **kw))
            flop, nb, extra = work(q, args, closest, True)
            b_ms, b_by = bound_ms(flop, nb)
            f_flop, f_nb, f_extra = work(q, q["args"], closest, False)
            fb_ms, fb_by = bound_ms(f_flop, f_nb)
            say(phase, kernel=label, mode=mode, rays=name, scope="subset",
                rays_n=rays, mismatches=mism, non_ties=bad, max_abs_err=err,
                kernel_ms=f"{ms:.4f}", twin_ms=f"{plain_ms:.4f}",
                **extra, flop=f"{flop:.4g}", bound_ms=f"{b_ms:.4f}",
                bound_by=b_by, share=f"{b_ms / ms:.3f}")
            say(phase, kernel=label, mode=mode, rays=name, scope="full",
                full_pass_kernel_ms=f"{full_ms:.4f}", **f_extra,
                flop=f"{f_flop:.4g}", bytes=f_nb, bound_ms=f"{fb_ms:.4f}",
                bound_by=fb_by, share=f"{fb_ms / full_ms:.3f}")
            worst = max(worst, err)
            total += mism
            rows.append((ms, plain_ms, b_ms, full_ms, fb_ms, flop, nb))
        mean = [sum(r[i] for r in rows) / len(rows) for i in range(5)]
        results[mode] = {
            "max_abs_err": worst, "mismatches": total, "ms": mean[0],
            "plain_ms": mean[1], "bound_ms": mean[2],
            "bound_by": bound_ms(sum(r[5] for r in rows),
                                 sum(r[6] for r in rows))[1],
            "full_pass_ms": mean[3], "full_pass_bound_ms": mean[4]}
    return results


def phase_kernel_vs_twin(dev, w=W, h=H, n_tiles=SUBSET_TILES):
    from lumenrenderer_tpu_torch.accel import stream, tiled
    from lumenrenderer_tpu_torch.render.renderer import KERNEL_VISIT_CAP

    sc, camf = _scene(dev)
    cs = stream.build_clusters(sc.tri_pos, cluster_size=128).to(dev)
    mv = min(cs.num_clusters, KERNEL_VISIT_CAP)
    passes = _secondary_passes(
        sc, cs, camf(w / h).to(dev), dev, w, h,
        lambda o, d, tn, tx: tiled.scan_inputs(cs, o, d, tn, tx, mv),
        primary=True)
    live_tris = _live_tris(cs.tri_feat, 128)
    for name, q in passes.items():
        say("3 kernel", rays=name, full_pass_tiles=q["args"][0].shape[0],
            subset_tiles=n_tiles,
            listed_visits_per_tile=f"{float(q['args'][3].float().mean()):.3f}")

    return _hold_k1("3 kernel", passes, live_tris, n_tiles)


def _hold_k1(phase, passes, live_tris, n_tiles):
    """hold_against_twin for K1 on `passes` (each tiled.scan_inputs, all of
    one ClusterSet, whose cached kernel layout the kernel takes), with K1's
    flop from its own visit counter, checked against the replay of its vote
    on the subset."""
    import torch

    from lumenrenderer_tpu_torch.ops import visit_scan as vs

    layout = next(iter(passes.values()))["layout"]

    def kernel(*args, **kw):
        return vs.visit_scan(*args, **kw, layout=layout)

    def work(q, args, closest, is_subset):
        kw = dict(q["kw"], closest=closest)
        rf_t, feats, sel, nv, tnb = args
        visits = torch.empty(rf_t.shape[0], dtype=torch.int32,
                             device=rf_t.device)
        kernel(*args, **kw, visits=visits)
        if is_subset:
            ref = vs.executed_visits_ref(*args, **kw)
            if not torch.equal(visits, ref):
                raise AssertionError(
                    f"K1's visit counter differs from executed_visits_ref on "
                    f"{int((visits != ref).sum())} of {visits.numel()} tiles")
        live_rays = (rf_t[..., 11] >= rf_t[..., 10]).sum(1)
        flop = visit_flop(live_rays, live_tris, sel, visits)
        nb = _nbytes(rf_t, feats, sel, nv, tnb) + rf_t.shape[0] * 128 * 4
        return flop, nb, {
            "visits_per_tile": f"{float(visits.float().mean()):.3f}"}

    return hold_against_twin(
        phase, "visit_scan", passes,
        lambda q: _tile_subset(q["args"], 1, n_tiles), kernel,
        vs.visit_scan_ref, lambda q: q["kw"]["low_bits"], exact_bits=True,
        work=work)


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
        isect, occl = tiled.tiled_intersectors(cs, mv, scan=scan,
                                               decode=False)
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


def _restir_scene():
    from lumenrenderer_tpu_torch.scene import presets

    return presets.interior_scene(n_boxes=600, n_lights=RESTIR_LIGHTS)


def _restir_config(w, h, use_restir=True, **kw):
    from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig

    return RenderConfig(width=w, height=h, max_depth=5, bsdf="disney",
                        light_strategy="nee", use_restir=use_restir, **kw)


def phase_small_restir(dev, w=SMALL_W, h=SMALL_H):
    import torch

    from lumenrenderer_tpu_torch.accel import stream, tiled
    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.integrator import wavefront as wf
    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.render.renderer import KERNEL_VISIT_CAP
    from lumenrenderer_tpu_torch.restir import di

    builder, camf = _restir_scene()
    sc = builder.build().to(dev)
    cam = camf(w / h).to(dev)
    cs = stream.build_clusters(sc.tri_pos, cluster_size=128).to(dev)
    mv = min(cs.num_clusters, KERNEL_VISIT_CAP)
    cfg = _restir_config(w, h, extract_tangent=False)
    imgs = []
    for scan in (vs.visit_scan, vs.visit_scan_ref):
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        isect, occl = tiled.tiled_intersectors(cs, mv, scan=scan,
                                               decode=False)
        restir = di.RestirDI(
            occl, lambda sd, wo, wi: wf._bsdf_eval(cfg, sd, wo, wi),
            di.RestirConfig(), w, h)
        with torch.no_grad():
            out = wf.render_wavefront(
                sc, isect, occl, cam, sampling.generator_uniforms(gen), 0,
                cfg, restir_state=restir.init_state(w * h, device=dev),
                restir_fn=restir)
        imgs.append(wf.merge_channels(out))
    a, b = imgs
    ok = torch.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)
    frac = float(ok.float().mean())
    finite = bool(torch.isfinite(a).all())
    say("4b small restir", size=f"{w}x{h}", lights=int(sc.lights.count),
        ris="per-pixel", pixels_agree=f"{frac:.6f}", finite=finite,
        mean=f"{float(a.mean()):.6f}")
    if frac < PIXEL_FRACTION or not finite or float(a.mean()) <= 0:
        raise AssertionError(f"kernel and twin ReSTIR frames differ: {frac}")


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
    per_frame = {k: v / (frames + 1) for k, v in launches.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    img = st.accum
    finite = bool(torch.isfinite(img).all())
    mean = float(img.mean())
    say("5 full slice", size=f"{w}x{h}", tris=sc.num_triangles,
        clusters=r.clusters.num_clusters, max_visits=r.max_visits,
        warmup_ms=f"{warm_ms:.1f}", ms_per_frame=f"{ms:.1f}",
        primary_rays_per_s=f"{w * h / ms * 1e3:.4g}",
        peak_mem_gib=f"{peak / 2**30:.2f}", overflow=overflow,
        mean=f"{mean:.5f}", finite=finite, launches=json.dumps(launches),
        launches_per_frame=json.dumps(per_frame))
    if not finite or mean <= 0 or overflow:
        raise AssertionError(f"bad frame: finite={finite} mean={mean} "
                             f"overflow={overflow}")
    # primary + 4 bounces (closest) and a shadow query per depth (any)
    if per_frame != {"closest": cfg.max_depth, "any": cfg.max_depth}:
        raise AssertionError(f"K1 launches per frame {per_frame}, expected "
                             f"{cfg.max_depth} in each mode")
    _profile_frame("5 profile", lambda: r.render_frame(st, cam),
                   "visit_scan_kernel")
    return launches


def _device_kernels(fn):
    """fn() once under torch.profiler: (wall ms, [(device ms, kernel name,
    calls)] sorted by time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (us if us is not None else e.self_cuda_time_total) / 1e3

    # device-side events only: an aten op's row repeats its kernels' time,
    # and a range's annotation on the device timeline (the program's spans
    # record under the profiler) spans the kernels inside it
    return wall_ms, sorted(((dev_ms(e), e.key, e.count) for e in events
                            if e.device_type == torch.autograd.DeviceType.CUDA
                            and not getattr(e, "is_user_annotation", False)
                            and dev_ms(e) > 0), reverse=True)


def _profile_frame(phase, render_one, kernel, also=()):
    """One more frame, render_one(), under torch.profiler: device kernel
    time, idle share of the frame's wall time, the share of the kernel whose
    name contains `kernel` (and of each in `also`), the top kernels."""
    wall_ms, kernels = _device_kernels(render_one)
    device_ms = sum(k[0] for k in kernels)
    if device_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    k_ms = sum(k[0] for k in kernels if kernel in k[1])
    say(phase, profile=kernel, frame_wall_ms=f"{wall_ms:.1f}",
        device_kernel_ms=f"{device_ms:.1f}",
        idle_share=f"{1 - device_ms / wall_ms:.3f}",
        kernel_ms=f"{k_ms:.1f}",
        kernel_share_of_device=f"{k_ms / device_ms:.3f}",
        kernels=len(kernels), launches=sum(k[2] for k in kernels))
    for name in also:
        a_ms = sum(k[0] for k in kernels if name in k[1])
        say(phase, profile=name, kernel_ms=f"{a_ms:.2f}",
            kernel_share_of_device=f"{a_ms / device_ms:.4f}",
            calls=sum(k[2] for k in kernels if name in k[1]))
    for ms, key, count in kernels[:12]:
        say(phase, kernel=repr(key[:90]), ms=f"{ms:.2f}", calls=count)


def _instanced():
    from lumenrenderer_tpu_torch.scene import presets

    return presets.instanced_boxes(n_inst=N_INSTANCES, seed=5)


def phase_instanced_kernel_vs_twin(dev, w=W, h=H, n_tiles=SUBSET_TILES):
    import torch

    from lumenrenderer_tpu_torch.accel import stream, tiled, two_level
    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.ops import visit_scan_instanced as vsi
    from lumenrenderer_tpu_torch.render.renderer import KERNEL_VISIT_CAP

    builder, camf = _instanced()
    sc = builder.build().to(dev)
    cs = stream.build_clusters(sc.tri_pos, cluster_size=128).to(dev)
    ics = two_level.build_instanced(
        *two_level.instance_tables(builder.instances)).to(dev)
    mv = min(ics.num_clusters, KERNEL_VISIT_CAP)
    passes = _secondary_passes(
        sc, cs, camf(w / h).to(dev), dev, w, h,
        lambda o, d, tn, tx: two_level.scan_inputs(ics, o, d, tn, tx, mv),
        primary=True)
    for name, q in passes.items():
        nv = q["args"][5]
        say("6 instanced kernel", rays=name, units=ics.num_clusters,
            unique_meshes=ics.tri_feat.shape[0], max_visits=mv,
            full_pass_tiles=nv.shape[0], subset_tiles=n_tiles,
            mean_visits_live_tiles=f"{float(nv[nv > 0].float().mean()):.2f}",
            overflow=bool(q["overflow"]))
    live_tris = _live_tris(ics.tri_feat, ics.tri_id.shape[1])
    full_visits = {True: [], False: []}

    def work(q, args, closest, is_subset):
        """K2's flop from its own visit counter, checked against the replay
        of its vote on the subset."""
        kw = dict(q["kw"], closest=closest)
        tiles = args[0].shape[0]
        visits = torch.empty(tiles, dtype=torch.int32, device=dev)
        vsi.visit_scan_instanced(*args, **kw, visits=visits)
        if is_subset:
            ref = vsi.executed_visits_instanced_ref(*args, **kw)
            if not torch.equal(visits, ref):
                raise AssertionError(
                    f"K2's visit counter differs from "
                    f"executed_visits_instanced_ref on "
                    f"{int((visits != ref).sum())} of {tiles} tiles")
        else:
            full_visits[closest].append(float(visits.float().mean()))
        rayblk, wnd, feats, _, _, nv, _ = args
        live_rays = (wnd[..., 1] >= wnd[..., 0]).sum(1)
        flop = (visit_flop(live_rays, live_tris, args[3], visits)
                + AFFINE_FLOP * float((live_rays * visits).sum()))
        # the rays' o and d (not rayblk's two padding rows, which the kernel
        # never reads), their windows (each ray's 32 B row is one memory
        # sector), the table and, per visit run, its cluster id, entry t and
        # 12-float affine; keys (bits) and the counter out
        nb = (_nbytes(rayblk[:, :6], wnd, feats, nv)
              + int(visits.sum()) * 56 + tiles * (128 + 1) * 4)
        return flop, nb, {
            "visits_per_tile": f"{float(visits.float().mean()):.3f}"}

    results = hold_against_twin(
        "6 instanced kernel", "visit_scan_instanced", passes,
        lambda q: _tile_subset(q["args"], 2, n_tiles),
        vsi.visit_scan_instanced, vsi.visit_scan_instanced_ref,
        lambda q: q["kw"]["low_bits"], exact_bits=True, work=work)
    for mode, closest in (("closest", True), ("any", False)):
        runs = full_visits[closest]
        results[mode]["visits_per_tile"] = sum(runs) / len(runs)
    # K1 on the same passes through the flattened clusters, for scale
    flat = _secondary_passes(
        sc, cs, camf(w / h).to(dev), dev, w, h,
        lambda o, d, tn, tx: tiled.scan_inputs(
            cs, o, d, tn, tx, min(cs.num_clusters, KERNEL_VISIT_CAP)))
    for name, q in flat.items():
        for mode in ("closest", "any"):
            ms = cuda_time_ms(lambda: vs.visit_scan(
                *q["args"], **q["kw"], closest=mode == "closest"))
            say("6 instanced kernel", reference="visit_scan, flattened",
                clusters=cs.num_clusters, rays=name, mode=mode,
                full_pass_kernel_ms=f"{ms:.4f}")
    return results


def _aov_agreement(aux, ref, low_bits):
    """(fraction of pixels whose primary depth and normal agree within
    AOV_TOL (relative for depth beyond 1), fraction that agree or are key
    ties). A tie is a pixel where both frames hit, at depths within the
    coarser packed key's t resolution, 2^-(23 - low_bits): there the key
    cannot order the two surfaces and either may win (ROADMAP C-1)."""
    import torch

    da, db = aux["depth"], ref["depth"]
    scale = torch.maximum(da.abs(), db.abs()).clamp_min(1.0)
    ok = (da - db).abs() <= AOV_TOL * scale
    ok &= ((aux["normal"] - ref["normal"]).abs() <= AOV_TOL).all(-1)
    tie = ((da > 0) & (db > 0)
           & ((da - db).abs() <= torch.maximum(da, db)
              * 2.0 ** -(23 - low_bits)))
    return float(ok.float().mean()), float((ok | tie).float().mean())


def _hold_frames(phase, label, aux, ref_aux, mean, ref_mean, low_bits,
                 hold_mean=True):
    """Raise unless the primary AOVs agree (or tie) on PIXEL_FRACTION of the
    pixels and, with hold_mean, the image means lie within MEAN_RTOL."""
    strict, frac = _aov_agreement(aux, ref_aux, low_bits)
    rel = abs(mean - ref_mean) / max(abs(ref_mean), 1e-12)
    say(phase, against=label, aov_pixels_agree=f"{strict:.6f}",
        aov_pixels_agree_or_tie=f"{frac:.6f}", tie_key_low_bits=low_bits,
        mean=f"{mean:.6f}", ref_mean=f"{ref_mean:.6f}",
        mean_rel_diff=f"{rel:.2e}", mean_held=hold_mean)
    if frac < PIXEL_FRACTION or (hold_mean and rel > MEAN_RTOL):
        raise AssertionError(f"{phase}: frame differs from {label}: AOVs "
                             f"{frac}, means {mean} vs {ref_mean}")


def _key_low_bits(accel_units, k, max_visits):
    from lumenrenderer_tpu_torch.accel.tiled import key_bits

    return key_bits(k, min(max_visits, accel_units))[2]


def phase_two_level_slice(dev, w=W, h=H, frames=SLICE_FRAMES):
    import numpy as np
    import torch

    from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
    from lumenrenderer_tpu_torch.ops import visit_scan_instanced as vsi
    from lumenrenderer_tpu_torch.render.renderer import Renderer
    from lumenrenderer_tpu_torch.scene.dynamic import DynamicScene

    builder, camf = _instanced()
    cam = camf(w / h)
    cfg = RenderConfig(width=w, height=h, max_depth=5, bsdf="disney",
                       light_strategy="mis")
    dyn = DynamicScene(builder)
    r = Renderer(dyn.build(), cfg, accel="two_level", builder=builder,
                 dynamic=dyn, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    vsi.reset_launches()
    st, aux0 = r.render_frame(r.init_state(0), cam)
    warm_ms = r.frame_stats["Total Frame Time"]
    run = {"st": st, "overflow": r.frame_stats["overflow"]}

    def one():
        run["st"], _ = r.render_frame(run["st"], cam)
        run["overflow"] |= r.frame_stats["overflow"]

    ms = timed_frames(one, frames)
    overflow = run["overflow"]
    launches = dict(vsi.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    img = run["st"].accum
    finite = bool(torch.isfinite(img).all())
    mean = float(img.mean())
    say("7 two-level slice", size=f"{w}x{h}", tris=r.scene.num_triangles,
        units=r.instanced.num_clusters, max_visits=r.max_visits,
        warmup_ms=f"{warm_ms:.1f}", ms_per_frame=f"{ms:.1f}",
        peak_mem_gib=f"{peak / 2**30:.2f}", overflow=overflow,
        tri_feat_bytes=r.instanced.tri_feat.numel() * 4, mean=f"{mean:.5f}",
        finite=finite, launches=json.dumps(launches))
    if not finite or mean <= 0 or overflow:
        raise AssertionError(f"bad two-level frame: finite={finite} "
                             f"mean={mean} overflow={overflow}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"K2 not launched on the two-level path: "
                             f"{launches}")
    _profile_frame("7 profile", one, "visit_scan_instanced_kernel")

    # the same scene and seed through the flattened tiled accel
    rt = Renderer(builder.build(), cfg, accel="tiled", device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    st_t, aux_t = rt.render_frame(rt.init_state(0), cam)
    run_t = {"st": st_t}

    def one_t():
        run_t["st"], _ = rt.render_frame(run_t["st"], cam)

    ms_t = timed_frames(one_t, frames)
    say("7 two-level slice", reference="tiled", ms_per_frame=f"{ms_t:.1f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f}",
        clusters=rt.clusters.num_clusters,
        tri_feat_bytes=rt.clusters.tri_feat.numel() * 4,
        overflow=rt.frame_stats["overflow"])
    low_bits = max(
        _key_low_bits(r.instanced.num_clusters, 128, r.max_visits),
        _key_low_bits(rt.clusters.num_clusters, 128, rt.max_visits))
    _hold_frames("7 two-level slice", "tiled", aux0, aux_t, mean,
                 float(run_t["st"].accum.mean()), low_bits)

    # dynamic: move instance 0 out of view through its Transform
    st_before, _ = r.render_frame(r.init_state(1), cam)
    dyn.transform(0).translation = (50.0, 0.0, 0.0)
    st_moved, aux_moved = r.render_frame(r.init_state(1), cam)
    rebake_ms = r.frame_stats["Rebake Time"]
    changed = float((st_moved.accum - st_before.accum).abs().amax())
    moved = _instanced()[0]
    moved.instances[0].transform = (
        np.array([[1, 0, 0, 50], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                 np.float32) @ moved.instances[0].transform)
    rf = Renderer(moved.build(), cfg, accel="two_level", builder=moved,
                  device=dev)
    st_f, aux_f = rf.render_frame(rf.init_state(1), cam)
    say("7 two-level slice", dynamic="instance 0 +50 x",
        rebake_ms=f"{rebake_ms:.3f}", max_pixel_change=f"{changed:.4g}",
        overflow=r.frame_stats["overflow"])
    if changed <= 0.0 or r.frame_stats["overflow"]:
        raise AssertionError("moving instance 0 did not change the image")
    _hold_frames("7 two-level slice", "a fresh build at the new transform",
                 aux_moved, aux_f, float(st_moved.accum.mean()),
                 float(st_f.accum.mean()), low_bits)
    return launches


def phase_pair_kernel_vs_twin(dev, w=W, h=H, n_tiles=SUBSET_TILES):
    import torch

    from lumenrenderer_tpu_torch.accel import pairs, stream
    from lumenrenderer_tpu_torch.ops import pair_scan as ps
    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.render.renderer import KERNEL_VISIT_CAP

    sc, camf = _scene(dev)
    cs = stream.build_clusters(sc.tri_pos, cluster_size=128).to(dev)
    mv = min(cs.num_clusters, KERNEL_VISIT_CAP)
    passes = _secondary_passes(
        sc, cs, camf(w / h).to(dev), dev, w, h,
        lambda o, d, tn, tx: pairs.scan_inputs(cs, o, d, tn, tx, mv,
                                               PAIRS_PER_RAY),
        primary=True)

    def subset(q):
        rf_pairs, feats, tile_cluster = q["args"]
        rf = rf_pairs.reshape(-1, 128, 12)
        live = (rf[..., 11] >= rf[..., 10]).any(1).nonzero()[:, 0]
        idx = live[torch.linspace(0, live.numel() - 1, n_tiles,
                                  device=dev).long()]
        return (rf[idx].reshape(-1, 12).contiguous(), feats,
                tile_cluster[idx].contiguous())

    for name, q in passes.items():
        rf = q["args"][0].reshape(-1, 128, 12)
        live_tiles = int((rf[..., 11] >= rf[..., 10]).any(1).sum())
        live_rays = int(q["live"].sum())
        say("8 pair kernel", rays=name, pair_tiles=rf.shape[0],
            live_pair_tiles=live_tiles, subset_tiles=n_tiles,
            admitted_pairs=q["pairs"],
            pairs_per_live_ray=f"{q['pairs'] / max(live_rays, 1):.3f}",
            pairs_per_ray=f"{q['pairs'] / q['r']:.3f}",
            overflow=bool(q["overflow"]))
    live_tris = _live_tris(cs.tri_feat, 128)

    def work(q, args, closest, is_subset):
        """K3's flop over its live pair tiles (dead tiles do no work);
        bytes of the live tiles' rows and clusters, the dead tiles'
        windows, every output, and the table. On the full pass, every dead
        tile must hold the miss key (0)."""
        rf_pairs, feats, tile_cluster = args
        rf = rf_pairs.reshape(-1, 128, 12)
        live = (rf[..., 11] >= rf[..., 10]).sum(1)
        n_live = int((live > 0).sum())
        extra = {"live_pair_tiles": n_live}
        if not is_subset:
            out = ps.pair_scan(*args, **q["kw"], closest=closest)
            dead = out.reshape(-1, 128)[live == 0]
            miss = vs.KEY_MISS if closest else 0
            if not bool((dead == miss).all()):
                raise AssertionError(
                    f"K3 wrote a hit on {int((dead != miss).sum())} pairs "
                    f"of dead tiles")
            extra["dead_tiles_miss"] = dead.shape[0]
        flop = FLOP_PER_PAIR * float(
            (live.double() * live_tris[tile_cluster.long()]).sum())
        n_dead = rf.shape[0] - n_live
        nb = (n_live * (128 * 12 + 1) * 4 + n_dead * 128 * 2 * 4
              + rf.shape[0] * 128 * 4 + _nbytes(feats))
        return flop, nb, extra

    return hold_against_twin(
        "8 pair kernel", "pair_scan", passes, subset, ps.pair_scan,
        ps.pair_scan_ref, lambda q: q["kw"]["k_bits"], exact_bits=True,
        work=work)


def phase_pair_slice(dev, w=W, h=H, frames=SLICE_FRAMES):
    import torch

    from lumenrenderer_tpu_torch.accel import pairs, stream, tiled
    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.integrator import wavefront as wf
    from lumenrenderer_tpu_torch.ops import pair_scan as ps
    from lumenrenderer_tpu_torch.render.renderer import KERNEL_VISIT_CAP

    sc, camf = _scene(dev)
    cam = camf(w / h).to(dev)
    cs = stream.build_clusters(sc.tri_pos, cluster_size=128).to(dev)
    mv = min(cs.num_clusters, KERNEL_VISIT_CAP)
    cfg = wf.RenderConfig(width=w, height=h, max_depth=5, bsdf="disney",
                          light_strategy="mis", extract_tangent=False)

    def pair_fns(per_ray, flags):
        isect, _ = pairs.pair_intersectors(cs, max_visits=128,
                                           max_pairs_per_ray=per_ray,
                                           decode=False)

        def occl(o, d, tn, tx):
            # pair_intersectors' occlusion query, keeping its overflow flag
            res = pairs._query(cs, o, d, tn, tx, 128, per_ray, False, False)
            flags.append(res["overflow"])
            return res["occluded"]

        return isect, occl

    def frames_of(isect, occl, n, flags=()):
        """n frames from generator seed 0: (the first frame's outputs, the
        mean of the frames' image means, ms per frame after the first, any
        overflow of a closest or an occlusion query)."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        uni = sampling.generator_uniforms(gen)
        first, means, ovf = [], [], []

        def one():
            with torch.no_grad():
                out = wf.render_wavefront(sc, isect, occl, cam, uni,
                                          len(means), cfg)
            means.append(wf.merge_channels(out).mean())
            ovf.append(out["overflow"])
            if not first:
                first.append(out)

        one()
        ms = timed_frames(one, n - 1) if n > 1 else float("nan")
        return (first[0], float(torch.stack(means).mean()), ms,
                bool(torch.stack(ovf + list(flags)).any()))

    # the smallest pair cap, from PAIRS_PER_RAY up, whose first frame does
    # not overflow (JAX measured 5.28 admitted clusters per bounce ray)
    per_ray = PAIRS_PER_RAY
    while True:
        flags = []
        overflow = frames_of(*pair_fns(per_ray, flags), 1, flags)[3]
        say("9 pair slice", max_pairs_per_ray=per_ray,
            first_frame_overflow=overflow)
        if not overflow:
            break
        per_ray += 1
        if per_ray > 2 * PAIRS_PER_RAY:
            raise AssertionError("the pair frame overflows at "
                                 f"{2 * PAIRS_PER_RAY} pairs per ray")
    flags = []
    isect, occl = pair_fns(per_ray, flags)
    torch.cuda.reset_peak_memory_stats(dev)
    ps.reset_launches()
    out, mean, ms, overflow = frames_of(isect, occl, frames + 1, flags)
    launches = dict(ps.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    img = wf.merge_channels(out)
    finite = bool(torch.isfinite(img).all())
    say("9 pair slice", size=f"{w}x{h}", clusters=cs.num_clusters,
        max_visits=mv, max_pairs_per_ray=per_ray, ms_per_frame=f"{ms:.1f}",
        peak_mem_gib=f"{peak / 2**30:.2f}", overflow=overflow,
        mean=f"{mean:.5f}", finite=finite, launches=json.dumps(launches))
    if not finite or mean <= 0 or overflow:
        raise AssertionError(f"bad pair frame: finite={finite} mean={mean} "
                             f"overflow={overflow}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"K3 not launched on the pair path: "
                             f"{launches}")
    _profile_frame("9 profile", lambda: frames_of(isect, occl, 1, flags),
                   "pair_scan_kernel")
    t_isect, t_occl = tiled.tiled_intersectors(cs, mv, decode=False)
    torch.cuda.reset_peak_memory_stats(dev)
    out_t, mean_t, ms_t, ovf_t = frames_of(t_isect, t_occl, frames + 1)
    say("9 pair slice", reference="tiled", ms_per_frame=f"{ms_t:.1f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f}",
        overflow=ovf_t)
    # the pair key keeps more bits of t than the tiled key
    _hold_frames("9 pair slice", "tiled", out, out_t, mean, mean_t,
                 _key_low_bits(cs.num_clusters, 128, mv))
    return launches


def _restir_pass_times(r, st, cam, dev):
    """CUDA-event times of each ReSTIR pass (mean of 3 after a warm-up) on
    the depth-0 surface of one frame of Renderer r, with st's history; the
    visibility passes through the frame's sorted K1 occluder. Returns the
    RIS pass's peak device memory above what was allocated before it."""
    import torch

    from lumenrenderer_tpu_torch.accel import sorting, tiled
    from lumenrenderer_tpu_torch.core import camera as camera_mod
    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.integrator import nee
    from lumenrenderer_tpu_torch.integrator.surface import \
        extract_surface_data
    from lumenrenderer_tpu_torch.restir import di

    cfg, rd = r.config, r._restir_fn
    rcfg, sc = rd.cfg, r.scene
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    uni = sampling.generator_uniforms(gen)
    cam = cam.to(dev)
    w, h = cfg.width, cfg.height
    with torch.no_grad():
        o, d = camera_mod.generate_primary_rays(cam, w, h, 0, uni,
                                                cfg.jitter)
        t_max = torch.full((w * h,), float(cam.t_max), device=dev)
        sd = extract_surface_data(sc, o, d, r._isect(o, d, 1e-3, t_max)["tri"],
                                  with_tangent=cfg.extract_tangent)
        hit = sd.valid
        motion = camera_mod.motion_vectors(sd.position, hit, cam, w, h)
        pts = sc.tri_pos.reshape(-1, 3)
        _, occl = sorting.sorted_intersectors(r._isect, r._occl,
                                              pts.amin(0), pts.amax(0))
        rad_all = nee.all_light_radiance(sc)
        cdf, pdf = di.build_light_cdf(sc, rad_all)
        bags = di.fill_light_bags(cdf, rcfg, uni)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        res_ris = di.ris_primary(sc, sd, bags, pdf, rcfg, w, uni,
                                 rad_all=rad_all)
        torch.cuda.synchronize(dev)
        ris_peak = torch.cuda.max_memory_allocated(dev) - base
        res_vis = di.visibility_pass(sc, sd, res_ris, occl, hit,
                                     rad_all=rad_all)
        res_t = di.temporal_pass(sc, sd, res_vis, st.restir, motion, rcfg, w,
                                 h, uni, rad_all=rad_all)
        res_s = di.spatial_pass(sc, sd, res_t, hit, rcfg, w, h, uni,
                                rad_all=rad_all)
        res_f = di.visibility_pass(sc, sd, res_s, occl, hit,
                                   rad_all=rad_all)
        # K1 on the visibility passes' own rays, sorted as the frame sorts
        # them: held against its twin, timed, bounded
        captured = {}

        def capture(name):
            def fn(o_, d_, tn, tx):
                captured[name] = tiled.scan_inputs(r.clusters, o_, d_, tn, tx,
                                                   r.max_visits)
                return torch.zeros(o_.shape[0], dtype=torch.bool, device=dev)
            return sorting.sorted_intersectors(
                r._isect, fn, pts.amin(0), pts.amax(0))[1]

        di.visibility_pass(sc, sd, res_ris, capture("visibility_1"), hit,
                           rad_all=rad_all)
        di.visibility_pass(sc, sd, res_s, capture("visibility_2"), hit,
                           rad_all=rad_all)
        _hold_k1("10 restir K1", captured,
                 _live_tris(r.clusters.tri_feat, 128), SUBSET_TILES)

        def cdf_bags():
            c, _ = di.build_light_cdf(sc, nee.all_light_radiance(sc))
            di.fill_light_bags(c, rcfg, uni)

        passes = {
            "cdf_bags": cdf_bags,
            "ris": lambda: di.ris_primary(sc, sd, bags, pdf, rcfg, w, uni,
                                          rad_all=rad_all),
            "visibility_1": lambda: di.visibility_pass(
                sc, sd, res_ris, occl, hit, rad_all=rad_all),
            "temporal": lambda: di.temporal_pass(
                sc, sd, res_vis, st.restir, motion, rcfg, w, h, uni,
                rad_all=rad_all),
            "spatial": lambda: di.spatial_pass(sc, sd, res_t, hit, rcfg, w,
                                               h, uni, rad_all=rad_all),
            "visibility_2": lambda: di.visibility_pass(
                sc, sd, res_s, occl, hit, rad_all=rad_all),
            "shade": lambda: di.shade(sc, sd, -d, res_f, rd.eval_f, hit,
                                      rad_all=rad_all),
        }
        times = {k: cuda_time_ms(fn, reps=3) for k, fn in passes.items()}
        say("10 restir passes", **{f"{k}_ms": f"{v:.3f}"
                                   for k, v in times.items()},
            total_ms=f"{sum(times.values()):.3f}",
            ris_peak_gib=f"{ris_peak / 2**30:.2f}",
            hit_pixels=int(hit.sum()))
        for name in ("ris", "spatial", "shade"):
            _, kernels = _device_kernels(passes[name])
            for ms, key, count in kernels[:4]:
                say("10 restir passes", restir_pass=name,
                    kernel=repr(key[:90]), ms=f"{ms:.2f}", calls=count)


def phase_restir_slice(dev, w=W, h=H, frames=SLICE_FRAMES):
    import torch

    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.render.renderer import Renderer

    builder, camf = _restir_scene()
    sc, cam = builder.build(), camf(w / h)
    cfg = _restir_config(w, h)
    r = Renderer(sc, cfg, accel="tiled", device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    vs.reset_launches()
    st, _ = r.render_frame(r.init_state(0), cam)
    warm_ms = r.frame_stats["Total Frame Time"]
    run = {"st": st, "overflow": r.frame_stats["overflow"],
           "max_m": [float(st.restir.reservoir.m.max())]}

    def one():
        run["st"], _ = r.render_frame(run["st"], cam)
        run["overflow"] |= r.frame_stats["overflow"]
        run["max_m"].append(float(run["st"].restir.reservoir.m.max()))

    ms = timed_frames(one, frames)
    launches = dict(vs.LAUNCHES)
    per_frame = {k: v / (frames + 1) for k, v in launches.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    st = run["st"]
    img = st.accum
    finite = bool(torch.isfinite(img).all())
    mean = float(img.mean())
    res = st.restir.reservoir
    n_lights = int(r.scene.lights.count)
    fields_ok = all(bool(torch.isfinite(f).all() and (f >= 0).all())
                    for f in (res.w_sum, res.m, res.w_out, res.p_hat,
                              res.bary))
    idx_ok = bool(((res.light_idx >= 0) & (res.light_idx < n_lights)).all())
    say("10 restir slice", size=f"{w}x{h}", tris=sc.num_triangles,
        lights=n_lights, clusters=r.clusters.num_clusters,
        max_visits=r.max_visits, warmup_ms=f"{warm_ms:.1f}",
        ms_per_frame=f"{ms:.1f}",
        primary_rays_per_s=f"{w * h / ms * 1e3:.4g}",
        peak_mem_gib=f"{peak / 2**30:.2f}", overflow=run["overflow"],
        mean=f"{mean:.5f}", finite=finite, valid=bool(st.restir.valid),
        max_m=json.dumps(run["max_m"]), reservoir_ok=fields_ok,
        light_idx_ok=idx_ok, launches=json.dumps(launches),
        launches_per_frame=json.dumps(per_frame))
    if not finite or mean <= 0 or run["overflow"]:
        raise AssertionError(f"bad ReSTIR frame: finite={finite} mean={mean} "
                             f"overflow={run['overflow']}")
    if not (bool(st.restir.valid) and fields_ok and idx_ok
            and run["max_m"][1] > run["max_m"][0]):
        raise AssertionError(f"bad reservoirs: valid={st.restir.valid} "
                             f"fields_ok={fields_ok} idx_ok={idx_ok} "
                             f"max M per frame {run['max_m']}")
    # primary + 4 bounces closest; 4 NEE shadow + 2 ReSTIR visibility any
    expect = {"closest": cfg.max_depth, "any": cfg.max_depth + 1}
    if per_frame != expect:
        raise AssertionError(f"K1 launches per frame {per_frame}, expected "
                             f"{expect}")

    # light indices ride the spatial pass's packed rows bit-cast to float32
    li = torch.arange(n_lights, dtype=torch.int32, device=dev)
    rows = torch.cat([li.view(torch.float32)[:, None],
                      torch.rand(n_lights, 4, device=dev)], dim=1)
    perm = torch.randperm(n_lights, device=dev)
    back = rows[perm][..., 0].view(torch.int32)
    if not torch.equal(back, li[perm]):
        raise AssertionError("a light index did not survive its float32 "
                             "bit-cast round trip")

    # the same scene and seed with NEE at depth 0 instead
    rn = Renderer(sc, _restir_config(w, h, use_restir=False), accel="tiled",
                  device=dev)
    st_n, _ = rn.render_frame(rn.init_state(0), cam)
    run_n = {"st": st_n}

    def one_n():
        run_n["st"], _ = rn.render_frame(run_n["st"], cam)

    ms_n = timed_frames(one_n, frames)
    ratio = mean / float(run_n["st"].accum.mean())
    say("10 restir slice", reference="NEE, same scene and seed",
        ms_per_frame=f"{ms_n:.1f}", frames=frames + 1,
        mean_ratio=f"{ratio:.5f}", bound=json.dumps(RESTIR_RATIO))
    if not RESTIR_RATIO[0] < ratio < RESTIR_RATIO[1]:
        raise AssertionError(f"ReSTIR / NEE mean {ratio} outside "
                             f"{RESTIR_RATIO}")
    _profile_frame("10 profile", one, "visit_scan_kernel")
    _restir_pass_times(r, run["st"], cam, dev)
    return launches


def _walk_args(acc, o, d, tn, tx):
    """Kernel W's arguments for one pass over `acc`'s tree: the tile bounds
    of the rays padded to whole tiles, then the tree's five tensors."""
    from lumenrenderer_tpu_torch.accel import tiled

    po, pd, ptn, ptx = tiled.pad_rays(o, d, tn, tx, tiled.RAY_TILE)
    bounds = tiled._tile_bounds(po, pd, ptn, ptx,
                                po.shape[0] // tiled.RAY_TILE, tiled.RAY_TILE)
    return (*bounds, acc.tree_lo, acc.tree_hi, acc.tree_child0,
            acc.tree_child1, acc.tree_leaf_cluster)


def _max_abs_diff(pairs) -> float:
    """Largest |a - b| over the entries of the tensor pairs (0 where equal,
    infinities and NaNs included)."""
    import torch

    worst = 0.0
    for a, b in pairs:
        a, b = a.double(), b.double()
        same = (a == b) | (a.isnan() & b.isnan())
        gap = (a - b).abs().nan_to_num(torch.inf, torch.inf)
        diff = torch.where(same, 0.0, gap)
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst


def _hold_walk(phase, name, acc, rays, mv):
    """Kernel W against its twin on every tile of one pass: raw lists,
    entry t bits and counts identical, and so the sorted visit lists (sel,
    nv, tnb, overflow); its largest difference from the twin (0), its time,
    the work of the twin's stopped walk (its pops) and the bound; the
    admitted clusters per tile from one uncapped call."""
    import torch

    from lumenrenderer_tpu_torch.accel import tiled
    from lumenrenderer_tpu_torch.ops import tree_walk as tw

    args = _walk_args(acc, *rays)
    kw = dict(tree_depth=acc.tree_depth, mv=mv, nodes=acc.tree_nodes)
    tiles = args[0].shape[0]
    pops = torch.empty(tiles, dtype=torch.int32, device=args[0].device)
    pops_ref = torch.empty_like(pops)
    kern = tw.tile_tree_visits(*args, **kw, pops=pops)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = tw.tile_tree_visits_ref(*args, **kw, pops=pops_ref)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    same = (torch.equal(kern[0], ref[0]) and torch.equal(kern[2], ref[2])
            and torch.equal(kern[1].view(torch.int32),
                            ref[1].view(torch.int32)))
    po, pd, ptn, ptx = tiled.pad_rays(*rays, tiled.RAY_TILE)
    lists = [tiled.visit_lists(acc, po, pd, ptn, ptx, mv, "tree", walk)[:4]
             for walk in (tw.tile_tree_visits, lambda *a, **k: ref)]
    same_lists = all(torch.equal(a, b) for a, b in zip(*lists))
    err = _max_abs_diff([*zip(kern, ref), *zip(*lists)])
    if not (same and same_lists):
        raise AssertionError(f"W differs from its twin on the {name} pass: "
                             f"raw lists equal {same}, sorted {same_lists}, "
                             f"max_abs_err {err}")
    ms = cuda_time_ms(lambda: tw.tile_tree_visits(*args, **kw))
    count = ref[2].double()
    inner = float((pops_ref.double() - count).sum())
    ops = tw.BOX_TEST_OPS * (tiles + 2 * inner)
    nb = _nbytes(*args) + tiles * (mv * 8 + 4)
    b_ms, b_by = bound_ms(ops, nb)
    over = float((count > mv).double().mean())
    leaves = args[10].shape[0]
    admitted = tw.tile_tree_visits(*args, **dict(kw, mv=leaves))[2]
    admitted = admitted.double()
    say(phase, kernel="tree_walk", rays=name, tiles=tiles,
        tree_nodes=args[6].shape[0], tree_depth=acc.tree_depth, mv=mv,
        identical=True, max_abs_err=err, kernel_ms=f"{ms:.4f}",
        twin_ms=f"{plain_ms:.1f}",
        pops_mean=f"{float(pops_ref.double().mean()):.2f}",
        pops_max=int(pops_ref.max()),
        kernel_pops_mean=f"{float(pops.double().mean()):.2f}",
        kernel_pops_max=int(pops.max()),
        admitted_mean=f"{float(admitted.mean()):.2f}",
        admitted_p99=f"{float(admitted.quantile(0.99)):.1f}",
        admitted_max=int(admitted.max()), share_over_mv=f"{over:.5f}",
        overflow=bool(lists[0][3]), ops=f"{ops:.4g}", bytes=nb,
        bound_ms=f"{b_ms:.5f}", bound_by=b_by, share=f"{b_ms / ms:.4f}")
    if not torch.equal(admitted > mv, count > mv):
        raise AssertionError(f"W's uncapped and capped calls disagree on "
                             f"the overflowing tiles of the {name} pass")
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "ops": ops, "bytes": nb, "max_abs_err": err}


def _hold_small_frame(phase, scene, camf, dev, bind, scans,
                      extract_tangent=False):
    """A SMALL_W x SMALL_H depth-3 frame of `scene` through the kernels and
    through their twins from one generator seed, `bind(scan, walk)` giving
    the intersectors and `scans` the (kernel, twin) visit scans: raise
    unless PIXEL_FRACTION of the pixels agree within PIXEL_RTOL and the
    kernel frame is finite with a positive mean. extract_tangent: on for
    scenes with normal maps."""
    import torch

    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.integrator import wavefront as wf
    from lumenrenderer_tpu_torch.ops import tree_walk as tw

    sw, sh = SMALL_W, SMALL_H
    small = wf.RenderConfig(width=sw, height=sh, max_depth=3, bsdf="disney",
                            light_strategy="mis",
                            extract_tangent=extract_tangent)
    imgs = []
    for scan, walk in zip(scans, (tw.tile_tree_visits,
                                  tw.tile_tree_visits_ref)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        isect, occl = bind(scan, walk)
        with torch.no_grad():
            out = wf.render_wavefront(scene, isect, occl,
                                      camf(sw / sh).to(dev),
                                      sampling.generator_uniforms(gen), 0,
                                      small)
        imgs.append(wf.merge_channels(out))
    a, b = imgs
    frac = float(torch.isclose(a, b, rtol=PIXEL_RTOL,
                               atol=PIXEL_ATOL).all(-1).float().mean())
    finite = bool(torch.isfinite(a).all())
    say(phase, size=f"{sw}x{sh}", depth=small.max_depth,
        pixels_agree=f"{frac:.6f}", finite=finite,
        mean=f"{float(a.mean()):.6f}", twin_mean=f"{float(b.mean()):.6f}",
        overflow=bool(out["overflow"]))
    if frac < PIXEL_FRACTION or not finite or float(a.mean()) <= 0:
        raise AssertionError(f"{phase}: kernel and twin frames differ: "
                             f"{frac}")


def _mega_renderer(dev, w, h):
    """The mega scene (built once) and its Renderer on `dev`, with the host
    build seconds: the scene, the Renderer (clusters, their tree, the upload)
    and, timed inside that build, the tree."""
    from lumenrenderer_tpu_torch.accel import stream
    from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
    from lumenrenderer_tpu_torch.render.renderer import Renderer
    from lumenrenderer_tpu_torch.scene import presets

    t0 = time.perf_counter()
    builder, camf = presets.mega_scene(n_tris=MEGA_TRIS, n_lights=MEGA_LIGHTS)
    sc = builder.build()
    t1 = time.perf_counter()
    cfg = RenderConfig(width=w, height=h, max_depth=5, bsdf="disney",
                       light_strategy="mis")
    box_tree, tree_s = stream.box_tree, []

    def timed_tree(lo, hi):
        t = time.perf_counter()
        out = box_tree(lo, hi)
        tree_s.append(time.perf_counter() - t)
        return out

    stream.box_tree = timed_tree
    try:
        r = Renderer(sc, cfg, accel="tiled", device=dev)
    finally:
        stream.box_tree = box_tree
    t2 = time.perf_counter()
    cs = r.clusters
    say("11 mega build", tris=sc.num_triangles, lights=int(sc.lights.count),
        clusters=cs.num_clusters,
        live_tris_per_cluster=f"{float(cs.nlive.double().mean()):.2f}",
        tree_nodes=cs.tree_lo.shape[0], tree_depth=cs.tree_depth,
        tri_feat_bytes=cs.tri_feat.numel() * 4, max_visits=r.max_visits,
        culling=r.culling, scene_s=f"{t1 - t0:.2f}",
        renderer_s=f"{t2 - t1:.2f}", tree_s=f"{sum(tree_s):.2f}")
    return r, camf


def phase_mega(dev, w=W, h=H, frames=SLICE_FRAMES):
    import torch

    from lumenrenderer_tpu_torch.accel import tiled
    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.integrator import wavefront as wf
    from lumenrenderer_tpu_torch.ops import tree_walk as tw
    from lumenrenderer_tpu_torch.ops import visit_scan as vs

    r, camf = _mega_renderer(dev, w, h)
    cs, mv, cfg = r.clusters, r.max_visits, r.config
    cam = camf(w / h)

    # W and K1 against their twins on the passes of one frame
    def capture(o, d, tn, tx):
        q = tiled.scan_inputs(cs, o, d, tn, tx, mv)
        q["rays"] = (o, d, tn, tx)
        return q

    passes = _secondary_passes(r.scene, cs, cam.to(dev), dev, w, h, capture,
                               primary=True)
    walk = {name: _hold_walk("11 mega W", name, cs, q["rays"], mv)
            for name, q in passes.items()}
    for name, q in passes.items():
        nv = q["args"][3]
        say("11 mega K1", rays=name, full_pass_tiles=nv.shape[0],
            listed_visits_per_tile=f"{float(nv.float().mean()):.3f}",
            overflow=bool(q["overflow"]))
    k1 = _hold_k1("11 mega K1", passes, cs.nlive.double(), SUBSET_TILES)
    del passes

    # depth 3 keeps the twin frame short: the twin walk takes one step of
    # dozens of launches per node its longest stopped walk pops
    _hold_small_frame("11 mega small", r.scene, camf, dev,
                      lambda scan, walk: tiled.tiled_intersectors(
                          cs, mv, scan=scan, walk=walk, decode=False),
                      (vs.visit_scan, vs.visit_scan_ref))

    # the main path: the full frame through the Renderer
    torch.cuda.reset_peak_memory_stats(dev)
    vs.reset_launches()
    tw.reset_launches()
    st, _ = r.render_frame(r.init_state(0), cam)
    warm_ms = r.frame_stats["Total Frame Time"]
    run = {"st": st, "overflow": r.frame_stats["overflow"]}

    def one():
        run["st"], _ = r.render_frame(run["st"], cam)
        run["overflow"] |= r.frame_stats["overflow"]

    ms = timed_frames(one, frames)
    launches = dict(vs.LAUNCHES)
    walks = tw.LAUNCHES["walk"]
    peak = torch.cuda.max_memory_allocated(dev)
    img = run["st"].accum
    finite = bool(torch.isfinite(img).all())
    mean = float(img.mean())
    per_frame = {k: v / (frames + 1) for k, v in launches.items()}
    say("11 mega frame", size=f"{w}x{h}", tris=r.scene.num_triangles,
        clusters=cs.num_clusters, max_visits=mv, warmup_ms=f"{warm_ms:.1f}",
        ms_per_frame=f"{ms:.1f}",
        primary_rays_per_s=f"{w * h / ms * 1e3:.4g}",
        peak_mem_gib=f"{peak / 2**30:.2f}", overflow=run["overflow"],
        mean=f"{mean:.5f}", finite=finite, launches=json.dumps(launches),
        launches_per_frame=json.dumps(per_frame),
        walk_launches_per_frame=walks / (frames + 1))
    if not finite or mean <= 0:
        raise AssertionError(f"bad mega frame: finite={finite} mean={mean}")
    expect = {"closest": cfg.max_depth, "any": cfg.max_depth}
    if per_frame != expect or walks != 2 * cfg.max_depth * (frames + 1):
        raise AssertionError(f"K1 launches per frame {per_frame} (expected "
                             f"{expect}), W launches {walks}")
    _profile_frame("11 profile", one, "visit_scan_kernel",
                   also=("tree_walk_",))

    # the frame with the ClusterSet's cached kernel layout and without it
    def frame_with(scan):
        isect, occl = tiled.tiled_intersectors(cs, mv, scan=scan,
                                               decode=False)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            wf.render_wavefront(r.scene, isect, occl, cam.to(dev),
                                sampling.generator_uniforms(gen), 0, cfg)
        torch.cuda.synchronize(dev)
        return ((time.perf_counter() - t0) * 1e3,
                torch.cuda.max_memory_allocated(dev) / 2**30)

    def per_call(*args, layout=None, **kw):
        return vs.visit_scan(*args, **kw)

    order = (("cached", vs.visit_scan), ("per_call", per_call),
             ("per_call", per_call), ("cached", vs.visit_scan))
    got = {"cached": [], "per_call": []}
    for label, scan in order:
        got[label].append(frame_with(scan))
    say("11 mega cache", order="cached, per_call, per_call, cached",
        **{f"{k}_ms": json.dumps([round(x[0], 1) for x in v])
           for k, v in got.items()},
        **{f"{k}_peak_gib": json.dumps([round(x[1], 2) for x in v])
           for k, v in got.items()})
    mean_of = lambda key: sum(walk[p][key] for p in walk) / len(walk)
    return {"k1": k1, "launches": launches, "walk": {
        "ms": mean_of("ms"), "plain_ms": mean_of("plain_ms"), "bound_ms": mean_of("bound_ms"),
        "max_abs_err": max(walk[p]["max_abs_err"] for p in walk),
        "bound_by": bound_ms(sum(walk[p]["ops"] for p in walk),
                             sum(walk[p]["bytes"] for p in walk))[1],
        "launches": walks}}


def phase_units_past_2048(dev, w=W, h=H):
    import torch

    from lumenrenderer_tpu_torch.accel import two_level
    from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
    from lumenrenderer_tpu_torch.ops import tree_walk as tw
    from lumenrenderer_tpu_torch.ops import visit_scan_instanced as vsi
    from lumenrenderer_tpu_torch.render.renderer import Renderer
    from lumenrenderer_tpu_torch.scene import presets

    builder, camf = presets.instanced_boxes(n_inst=UNITS_INSTANCES)
    cam = camf(w / h)
    cfg = RenderConfig(width=w, height=h, max_depth=5, bsdf="disney",
                       light_strategy="mis")
    r = Renderer(builder.build(), cfg, accel="two_level", builder=builder,
                 device=dev)
    vsi.reset_launches()
    tw.reset_launches()
    st, aux = r.render_frame(r.init_state(0), cam)
    launches, walks = dict(vsi.LAUNCHES), tw.LAUNCHES["walk"]
    overflow = r.frame_stats["overflow"]
    ms = r.frame_stats["Total Frame Time"]
    rt = Renderer(builder.build(), cfg, accel="tiled", culling="tree",
                  device=dev)
    st_t, aux_t = rt.render_frame(rt.init_state(0), cam)
    say("11b two-level units", size=f"{w}x{h}",
        units=r.instanced.num_clusters, unit_tree_depth=r.instanced.tree_depth,
        max_visits=r.max_visits, first_frame_ms=f"{ms:.1f}",
        overflow=overflow, k2_launches=json.dumps(launches),
        walk_launches=walks, reference="tiled, culling=tree",
        clusters=rt.clusters.num_clusters,
        reference_ms=f"{rt.frame_stats['Total Frame Time']:.1f}",
        reference_overflow=rt.frame_stats["overflow"])
    if min(launches.values()) <= 0 or walks != 2 * cfg.max_depth:
        raise AssertionError(f"K2 {launches} or W ({walks}) not launched on "
                             "the unit tree")
    mean, mean_t = float(st.accum.mean()), float(st_t.accum.mean())
    if not bool(torch.isfinite(st.accum).all()) or mean <= 0:
        raise AssertionError(f"bad two-level frame: mean={mean}")
    low_bits = max(
        _key_low_bits(r.instanced.num_clusters, 128, r.max_visits),
        _key_low_bits(rt.clusters.num_clusters, 128, rt.max_visits))
    # a tile that admits more than 128 units keeps only the first 128 its
    # walk pops (ROADMAP C-12), and a unit is not a cluster, so the two
    # frames lose different occluders and bounce hits: only the primary
    # AOVs are held here, the means are printed; K2 and W are held against
    # their twins on the whole frame below
    _hold_frames("11b two-level units", "tiled", aux, aux_t, mean, mean_t,
                 low_bits, hold_mean=False)

    # W on the unit tree against its twin on every tile of one frame's
    # passes (their hits from the tiled frame's clusters)
    def capture(o, d, tn, tx):
        return {"rays": (o, d, tn, tx),
                "overflow": torch.zeros((), dtype=torch.bool, device=dev)}

    passes = _secondary_passes(rt.scene, rt.clusters, cam.to(dev), dev, w, h,
                               capture, primary=True)
    for name, q in passes.items():
        _hold_walk("11b two-level W", name, r.instanced, q["rays"],
                   r.max_visits)
    _hold_small_frame("11b two-level small", r.scene, camf, dev,
                      lambda scan, walk: two_level.instanced_intersectors(
                          r.instanced, r.max_visits, scan=scan, walk=walk),
                      (vsi.visit_scan_instanced,
                       vsi.visit_scan_instanced_ref))


def _emission_frame(scene, isect, occl, cam, cfg, seed: int = 0):
    """The JAX bench's BENCH_GRAD loss as a function of every material's
    emissive (M,3): the mean of the merged frame. Each call draws from a
    fresh generator of `seed`, as the bench reuses one key."""
    import torch

    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.integrator import wavefront as wf

    def frame(em):
        gen = torch.Generator(device=cam.eye.device)
        gen.manual_seed(seed)
        sc = scene.replace(materials=scene.materials.replace(emissive=em))
        out = wf.render_wavefront(sc, isect, occl, cam,
                                  sampling.generator_uniforms(gen), 0, cfg)
        return wf.merge_channels(out).mean()

    return frame


def _grad(frame, em):
    """(frame(em), d frame / d em) from one forward and backward."""
    leaf = em.detach().clone().requires_grad_(True)
    loss = frame(leaf)
    loss.backward()
    return float(loss.detach()), leaf.grad


def _rel_err(a, b) -> float:
    """Largest |a - b| / |b| over the entries where b is not 0 (a must be 0
    where b is)."""
    nz = b != 0
    if bool((a[~nz] != 0).any()):
        return float("inf")
    return float(((a - b).abs()[nz] / b.abs()[nz]).max())


def phase_gradients(dev, w=W, h=H, frames=SLICE_FRAMES):
    """The JAX bench's BENCH_GRAD workload (bench.py:100-148): the gradient
    of the interior frame's mean with respect to every material's emissive,
    remat on, through Renderer(accel="tiled")'s intersectors (K1)."""
    import dataclasses

    import torch

    from lumenrenderer_tpu_torch.accel import tiled
    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.integrator import wavefront as wf
    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.parallel import train
    from lumenrenderer_tpu_torch.render.renderer import Renderer
    from lumenrenderer_tpu_torch.scene import presets

    gib = 2.0 ** 30
    torch.cuda.empty_cache()       # earlier phases' cached blocks
    builder, camf = presets.interior_scene(n_boxes=600, n_lights=64)
    r = Renderer(builder.build(),
                 wf.RenderConfig(width=w, height=h, max_depth=5,
                                 bsdf="disney", light_strategy="mis",
                                 remat=True),
                 accel="tiled", device=dev)
    scene, cfg, cam = r.scene, r.config, camf(w / h).to(dev)
    em0 = scene.materials.emissive
    frame = _emission_frame(scene, r._isect, r._occl, cam, cfg)

    with torch.no_grad():
        frame(em0)
        torch.cuda.reset_peak_memory_stats(dev)
        fwd_ms = timed_frames(lambda: frame(em0), frames)
    peak_fwd = torch.cuda.max_memory_allocated(dev)

    _grad(frame, em0)                                  # warm
    graph_ms, bwd_ms, peak_graph, peak_bwd, held = [], [], 0, 0, 0
    for _ in range(frames):
        leaf = em0.clone().requires_grad_(True)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss = frame(leaf)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        peak_graph = max(peak_graph, torch.cuda.max_memory_allocated(dev))
        held = max(held, torch.cuda.memory_allocated(dev) - base)
        torch.cuda.reset_peak_memory_stats(dev)
        loss.backward()
        torch.cuda.synchronize(dev)
        bwd_ms.append((time.perf_counter() - t1) * 1e3)
        graph_ms.append((t1 - t0) * 1e3)
        peak_bwd = max(peak_bwd, torch.cuda.max_memory_allocated(dev))
    graph_ms, bwd_ms = sum(graph_ms) / frames, sum(bwd_ms) / frames

    # the main path: K1 launches of one forward and backward
    vs.reset_launches()
    mean, grad = _grad(frame, em0)
    launches = dict(vs.LAUNCHES)
    say("12 gradients", size=f"{w}x{h}", depth=cfg.max_depth,
        materials=em0.shape[0], lights=int(scene.lights.count),
        forward_ms=f"{fwd_ms:.1f}", forward_graph_ms=f"{graph_ms:.1f}",
        backward_ms=f"{bwd_ms:.1f}",
        ratio=f"{(graph_ms + bwd_ms) / fwd_ms:.3f}",
        backward_over_forward=f"{bwd_ms / fwd_ms:.3f}",
        peak_forward_gib=f"{peak_fwd / gib:.2f}",
        peak_forward_graph_gib=f"{peak_graph / gib:.2f}",
        graph_held_gib=f"{held / gib:.2f}",
        peak_backward_gib=f"{peak_bwd / gib:.2f}",
        k1_launches_fwd_bwd=json.dumps(launches))
    if launches != {"closest": cfg.max_depth, "any": cfg.max_depth}:
        raise AssertionError(f"K1 launches per forward and backward "
                             f"{launches}, expected {cfg.max_depth} in each "
                             "mode (the recompute launches none)")

    leaf = em0.clone().requires_grad_(True)
    loss = frame(leaf)
    torch.cuda.synchronize(dev)
    # the row gathers' backward: a sort of the rows' indices, then the
    # accumulation onto the attribute and light tables
    _profile_frame("12 profile backward", loss.backward, "visit_scan_kernel",
                   also=("indexing_backward", "RadixSort"))

    # once without remat
    frame_nr = _emission_frame(scene, r._isect, r._occl, cam,
                               dataclasses.replace(cfg, remat=False))
    del leaf, loss
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    mean_nr, grad_nr = _grad(frame_nr, em0)
    nr_ms = (time.perf_counter() - t0) * 1e3
    peak_nr = torch.cuda.max_memory_allocated(dev)

    light = em0.amax(-1) > 0
    slope = float((grad * em0).sum())     # d mean / d s of em0 * s at s = 1
    with torch.no_grad():
        fd = (float(frame(em0 * 1.25)) - float(frame(em0 * 0.75))) / 0.5
    remat_err = _rel_err(grad, grad_nr)
    say("12 gradients", finite=bool(torch.isfinite(grad).all()),
        light_rows_positive=bool((grad[light] > 0).all()),
        rows_nonnegative=bool((grad >= 0).all()), mean=f"{mean:.6f}",
        d_mean_d_scale=f"{slope:.6f}",
        linearity_rel_err=f"{abs(slope - mean) / mean:.3e}",
        central_difference=f"{fd:.6f}",
        central_rel_err=f"{abs(slope - fd) / abs(fd):.3e}",
        no_remat_ms=f"{nr_ms:.1f}",
        peak_no_remat_gib=f"{peak_nr / gib:.2f}",
        remat_vs_no_remat_rel_err=f"{remat_err:.3e}")
    if not (bool(torch.isfinite(grad).all()) and bool((grad[light] > 0).all())
            and bool((grad >= 0).all())):
        raise AssertionError("gradients not finite, or a light's not > 0, "
                             "or a row's < 0")
    if abs(slope - mean) > GRAD_RTOL * mean or \
            abs(slope - fd) > GRAD_RTOL * abs(fd):
        raise AssertionError(f"d mean / d s {slope} against the mean {mean} "
                             f"and the central difference {fd}")
    if abs(mean_nr - mean) > 1e-6 * mean or remat_err > REMAT_RTOL:
        raise AssertionError(f"remat changed the frame ({mean_nr} vs {mean}) "
                             f"or its gradient (rel err {remat_err})")

    # a 320x180 gradient through K1 and through its twin
    small = dataclasses.replace(cfg, width=SMALL_W, height=SMALL_H)
    scam = camf(SMALL_W / SMALL_H).to(dev)
    grads = [_grad(_emission_frame(scene, *tiled.tiled_intersectors(
        r.clusters, r.max_visits, scan=scan, decode=False), scam, small),
        em0)[1]
        for scan in (vs.visit_scan, vs.visit_scan_ref)]
    twin_err = _rel_err(*grads)
    say("12 gradients small", size=f"{SMALL_W}x{SMALL_H}",
        kernel_vs_twin_rel_err=f"{twin_err:.3e}", rtol=REMAT_RTOL)
    if twin_err > REMAT_RTOL:
        raise AssertionError(f"gradient through K1 and its twin differ: "
                             f"{twin_err}")

    # a few training steps toward a target rendered at twice the emission
    def draws():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return sampling.generator_uniforms(gen)

    params0, _ = train.split_params(scene)
    bright = train.merge_params(
        scene, {**params0, "emissive": params0["emissive"] * 2.0})
    with torch.no_grad():
        target = wf.merge_channels(wf.render_wavefront(
            bright, r._isect, r._occl, cam, draws(), 0, cfg))
    init, step = train.make_train_step(
        scene, r._isect, r._occl, cam, cfg,
        lambda ps: torch.optim.Adam([ps["emissive"]], lr=TRAIN_LR))
    run = {"st": init(), "losses": []}

    def one_step():
        run["st"], loss = step(run["st"], draws(), 0, target)
        run["losses"].append(float(loss))

    step_ms = timed_frames(one_step, TRAIN_STEPS)
    with torch.no_grad():
        img = wf.merge_channels(wf.render_wavefront(
            train.merge_params(scene, run["st"].params), r._isect, r._occl,
            cam, draws(), 0, cfg))
        after = float(((img - target) ** 2).mean())
    losses = run["losses"] + [after]
    say("12 train", steps=TRAIN_STEPS, params="emissive",
        optimizer=f"Adam(lr={TRAIN_LR})",
        ms_per_step=f"{step_ms:.1f}",
        losses=json.dumps([round(x, 6) for x in losses]))
    if not all(math.isfinite(x) for x in losses) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"the training loss did not fall: {losses}")


# -- phase 13: a textured glTF interior through the cache -------------------

TEX_SEED = 9
MIP_MEAN_RTOL = 0.05         # 13b: level-0 against mipmapped 3-frame mean
GRAD_W, GRAD_H = 640, 360    # 13c
TEX_FD_STEP = 0.01           # 13c: central difference of a texture's scale


def _texture_image(g, size, kind):
    """A (size, size, 3) uint8 texture from `g`: a checker of two random
    colours times value noise ("base"), a normal map from the noise's
    slopes ("normal"), or metal-rough with roughness (G) from the noise
    and metallic (B) patches ("mr")."""
    import numpy as np

    def noise(cells):
        grid = g.uniform(0, 1, (cells + 1, cells + 1))
        x = np.linspace(0, cells, size, endpoint=False)
        i = x.astype(np.int64)
        f = x - i
        rows = grid[i] * (1 - f)[:, None] + grid[i + 1] * f[:, None]
        return rows[:, i] * (1 - f) + rows[:, i + 1] * f

    n = 0.65 * noise(8) + 0.35 * noise(64)
    if kind == "base":
        yy, xx = np.mgrid[0:size, 0:size] // (size // 16)
        c0, c1 = g.uniform(0.15, 0.95, (2, 3))
        img = np.where(((xx + yy) % 2 == 0)[..., None], c0, c1) \
            * (0.55 + 0.45 * n)[..., None]
    elif kind == "normal":
        dy, dx = np.gradient(n * size / 24.0)
        v = np.stack([-dx, -dy, np.ones_like(n)], -1)
        img = v / np.linalg.norm(v, axis=-1, keepdims=True) * 0.5 + 0.5
    else:
        img = np.stack([np.zeros_like(n), 0.25 + 0.75 * n,
                        (noise(4) > 0.7).astype(np.float64)], -1)
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _box_uv(pos):
    """Per-vertex UVs of a box face's four vertices: the two coordinates in
    the face's plane, divided by 4."""
    import numpy as np

    uv = np.empty((pos.shape[0], 2), np.float32)
    for f in range(0, pos.shape[0], 4):
        quad = pos[f:f + 4]
        axis = int(np.argmin(quad.max(0) - quad.min(0)))
        uv[f:f + 4] = np.delete(quad, axis, axis=1) / 4.0
    return uv


def write_textured_interior(directory):
    """presets.interior_scene(600, 64) as a textured glTF in `directory`:
    asset.gltf, asset.bin and 16 PNGs (written with render/tonemap's
    save_png). Returns the path of the .gltf, its camera factory and the
    per-image sizes."""
    import numpy as np

    from lumenrenderer_tpu_torch.render.tonemap import save_png
    from lumenrenderer_tpu_torch.scene import presets

    builder, camf = presets.interior_scene(n_boxes=600, n_lights=64)
    g = np.random.default_rng(TEX_SEED)
    kinds = ["base"] * 8 + ["normal"] * 4 + ["mr"] * 4
    sizes = [2048, 2048] + [1024] * 14
    for i, (kind, size) in enumerate(zip(kinds, sizes)):
        save_png(str(Path(directory) / f"tex{i}.png"),
                 _texture_image(g, size, kind))
    # room (material 16): base 0, normal 8, metal-rough 12; box material i:
    # base i % 8, and for i < 7 normal 8 + i % 4 and metal-rough 12 + i % 4
    tex = {16: (0, 8, 12)}
    for i in range(16):
        tex[i] = (i % 8,) + ((8 + i % 4, 12 + i % 4) if i < 7 else ())
    materials = []
    for m, spec in enumerate(builder.materials):
        em = np.asarray(spec.emissive, np.float64)
        strength = float(em.max())
        pbr = {"baseColorFactor": list(spec.base_color) + [1.0],
               "metallicFactor": spec.metallic,
               "roughnessFactor": spec.roughness}
        mat = {"pbrMetallicRoughness": pbr, "doubleSided": True}
        if strength > 0:
            mat["emissiveFactor"] = list(em / strength)
            mat["extensions"] = {"KHR_materials_emissive_strength": {
                "emissiveStrength": strength}}
        ids = tex.get(m, ())
        if ids:
            pbr["baseColorTexture"] = {"index": ids[0]}
        if len(ids) == 3:
            mat["normalTexture"] = {"index": ids[1]}
            pbr["metallicRoughnessTexture"] = {"index": ids[2]}
        materials.append(mat)
    blob, views, accessors, meshes = [], [], [], []
    offset = 0

    def add(arr, ctype, kind):
        nonlocal offset
        raw = np.ascontiguousarray(arr).tobytes()
        views.append({"buffer": 0, "byteOffset": offset,
                      "byteLength": len(raw)})
        accessors.append({"bufferView": len(views) - 1,
                          "componentType": ctype, "count": int(arr.shape[0]),
                          "type": kind})
        blob.append(raw)
        offset += len(raw)
        return len(accessors) - 1

    n_walls = 5
    for k, inst in enumerate(builder.instances):
        mesh = inst.mesh
        attrs = {"POSITION": add(mesh.positions, 5126, "VEC3"),
                 "NORMAL": add(mesh.normals, 5126, "VEC3")}
        if k < n_walls:
            attrs["TEXCOORD_0"] = add(np.array(
                [(0, 0), (5, 0), (5, 5), (0, 5)], np.float32), 5126, "VEC2")
        elif int(mesh.material_ids[0]) < 16:
            attrs["TEXCOORD_0"] = add(_box_uv(mesh.positions), 5126, "VEC2")
        meshes.append({"primitives": [{
            "attributes": attrs,
            "indices": add(mesh.indices.reshape(-1).astype(np.uint32), 5125,
                           "SCALAR"),
            "material": int(mesh.material_ids[0])}]})
    doc = {"asset": {"version": "2.0"},
           "buffers": [{"uri": "asset.bin", "byteLength": offset}],
           "bufferViews": views, "accessors": accessors,
           "images": [{"uri": f"tex{i}.png"} for i in range(len(kinds))],
           "textures": [{"source": i} for i in range(len(kinds))],
           "materials": materials, "meshes": meshes,
           "nodes": [{"mesh": k} for k in range(len(meshes))],
           "scenes": [{"nodes": list(range(len(meshes)))}], "scene": 0}
    (Path(directory) / "asset.bin").write_bytes(b"".join(blob))
    path = Path(directory) / "asset.gltf"
    path.write_text(json.dumps(doc))
    return str(path), camf, sizes


def _strip_textures(scene):
    """The scene with no textures: the white atlas, every texture id -1."""
    import torch

    from lumenrenderer_tpu_torch.scene.textures import build_texture_atlas

    m = scene.materials
    none = {f: torch.full_like(getattr(m, f), -1) for f in (
        "base_color_tex", "emissive_tex", "normal_tex", "metal_rough_tex")}
    return scene.replace(
        textures=build_texture_atlas([]).to(scene.tri_pos.device),
        materials=m.replace(**none))


def _frames(r, cam, frames):
    """A warm-up frame and `frames` timed ones: (ms/frame, warm-up ms,
    state, overflow of any)."""
    st, _ = r.render_frame(r.init_state(0), cam)
    warm_ms = r.frame_stats["Total Frame Time"]
    run = {"st": st, "overflow": r.frame_stats["overflow"]}

    def one():
        run["st"], _ = r.render_frame(run["st"], cam)
        run["overflow"] |= r.frame_stats["overflow"]

    ms = timed_frames(one, frames)
    return ms, warm_ms, run["st"], run["overflow"]


def _texel_gather(sc, isect, cam, w, h):
    """The sampler's texel gather of one mip level at the primary hits
    (the indices `textures.take_rows` receives there), timed with CUDA
    events as take_rows and as PyTorch's row gather texels[idx]: (rows,
    take_rows ms, row gather ms, bound ms)."""
    import torch

    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.core.camera import generate_primary_rays
    from lumenrenderer_tpu_torch.integrator.surface import \
        extract_surface_data
    from lumenrenderer_tpu_torch.scene import textures

    seen, take = [], textures.take_rows

    def spy(table, idx):
        seen.append(idx)
        return take(table, idx)

    gen = torch.Generator(device=cam.eye.device)
    gen.manual_seed(1)
    o, d = generate_primary_rays(cam, w, h, 0,
                                 sampling.generator_uniforms(gen), "random")
    textures.take_rows = spy
    try:
        with torch.no_grad():
            extract_surface_data(sc, o, d, isect(o, d, 1e-3, 1e9)["tri"],
                                 mip_spread=2.0 * torch.linalg.norm(cam.v) / h)
    finally:
        textures.take_rows = take
    texels, idx = sc.textures.texels, seen[0]
    if not torch.equal(take(texels, idx), texels[idx]):
        raise AssertionError("take_rows differs from the row gather")
    # each index read once, each gathered row read once and written once
    nbytes = idx.numel() * (idx.element_size() + 2 * 16)
    return (idx.numel(), cuda_time_ms(lambda: take(texels, idx)),
            cuda_time_ms(lambda: texels[idx]), nbytes / PEAK_BYTES * 1e3)


def _texture_frame(scene, isect, occl, cam, cfg, seed: int = 0):
    """The mean of the merged frame as a function of (texels, emissive),
    each call from a fresh generator of `seed`."""
    import torch

    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.integrator import wavefront as wf

    def frame(texels, em):
        gen = torch.Generator(device=cam.eye.device)
        gen.manual_seed(seed)
        sc = scene.replace(
            textures=scene.textures.replace(texels=texels),
            materials=scene.materials.replace(emissive=em))
        out = wf.render_wavefront(sc, isect, occl, cam,
                                  sampling.generator_uniforms(gen), 0, cfg)
        return wf.merge_channels(out).mean()

    return frame


def phase_textured(dev, w=W, h=H, frames=SLICE_FRAMES):
    """Phase 13: the interior as a textured glTF asset, through the scene
    cache, at 2560x1440 (13b), and its texel gradient (13c)."""
    import dataclasses
    import tempfile

    import torch

    from lumenrenderer_tpu_torch.accel import stream, tiled
    from lumenrenderer_tpu_torch.integrator import wavefront as wf
    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.render.renderer import (KERNEL_VISIT_CAP,
                                                         Renderer)
    from lumenrenderer_tpu_torch.scene import cache

    gib = 2.0 ** 30
    torch.cuda.empty_cache()
    # 13a: write the asset, build its cache cold, load it warm
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path, camf, sizes = write_textured_interior(tmp)
        t1 = time.perf_counter()
        cold = cache.load_or_build(path)
        t2 = time.perf_counter()
        warm = cache.load_or_build(path)
        t3 = time.perf_counter()
        cache_bytes = Path(path + cache.CACHE_EXT).stat().st_size
        png_bytes = sum(p.stat().st_size for p in Path(tmp).glob("*.png"))
    for name in cache.LEAVES:
        a, b = cold, warm
        for part in name.split("."):
            a, b = getattr(a, part), getattr(b, part)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"the cached leaf {name} differs")
    atlas = cold.textures
    atlas_bytes = atlas.texels.numel() * atlas.texels.element_size()
    say("13a cache", tris=cold.num_triangles, textures=atlas.count - 1,
        sizes=json.dumps(sizes), texels=atlas.texels.shape[0],
        atlas_bytes=atlas_bytes, png_bytes=png_bytes,
        cache_file_bytes=cache_bytes, write_asset_s=f"{t1 - t0:.2f}",
        cold_build_s=f"{t2 - t1:.2f}", warm_load_s=f"{t3 - t2:.2f}",
        leaves_equal=len(cache.LEAVES))
    del warm
    sc = cold.to(dev)
    cs = stream.build_clusters(sc.tri_pos, cluster_size=128).to(dev)
    mv = min(cs.num_clusters, KERNEL_VISIT_CAP)
    _hold_small_frame(
        "13a textured small", sc, camf, dev,
        lambda scan, walk: tiled.tiled_intersectors(cs, mv, scan=scan,
                                                    walk=walk, decode=False),
        (vs.visit_scan, vs.visit_scan_ref), extract_tangent=True)
    del cs

    # 13b: the 2560x1440 frame, mipmapped, level 0, and without textures
    cam = camf(w / h)
    cfg = wf.RenderConfig(width=w, height=h, max_depth=5, bsdf="disney",
                          light_strategy="mis", mipmaps=True)
    r = Renderer(sc, cfg, accel="tiled", device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    vs.reset_launches()
    ms, warm_ms, st, overflow = _frames(r, cam, frames)
    launches = dict(vs.LAUNCHES)
    per_frame = {k: v / (frames + 1) for k, v in launches.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    img = st.accum
    finite, mean = bool(torch.isfinite(img).all()), float(img.mean())
    say("13b textured frame", size=f"{w}x{h}", tris=sc.num_triangles,
        clusters=r.clusters.num_clusters, extract_tangent=
        r.config.extract_tangent, alpha_materials=r.config.alpha_materials,
        warmup_ms=f"{warm_ms:.1f}", ms_per_frame=f"{ms:.1f}",
        primary_rays_per_s=f"{w * h / ms * 1e3:.4g}",
        peak_mem_gib=f"{peak / gib:.2f}", atlas_bytes=atlas_bytes,
        overflow=overflow, mean=f"{mean:.5f}", finite=finite,
        launches=json.dumps(launches),
        launches_per_frame=json.dumps(per_frame))
    if not finite or mean <= 0 or overflow:
        raise AssertionError(f"bad textured frame: finite={finite} "
                             f"mean={mean} overflow={overflow}")
    if per_frame != {"closest": cfg.max_depth, "any": cfg.max_depth}:
        raise AssertionError(f"K1 launches per textured frame {per_frame}, "
                             f"expected {cfg.max_depth} in each mode")
    _profile_frame("13b profile", lambda: r.render_frame(st, cam),
                   "visit_scan_kernel", also=("take_put", "index"))
    rows, take_ms, row_ms, gather_bound = _texel_gather(
        r.scene, r._isect, cam.to(dev), w, h)
    say("13b texel gather", level_rows=rows, take_rows_ms=f"{take_ms:.3f}",
        row_gather_ms=f"{row_ms:.3f}", bound_ms=f"{gather_bound:.3f}",
        bound_by="bytes")
    r_nomip = Renderer(sc, dataclasses.replace(cfg, mipmaps=False),
                       accel="tiled", device=dev)
    ms_nomip, _, st_nomip, _ = _frames(r_nomip, cam, frames - 1)
    del r_nomip
    r_plain = Renderer(_strip_textures(sc), cfg, accel="tiled", device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ms_plain, _, st_plain, _ = _frames(r_plain, cam, frames)
    peak_plain = torch.cuda.max_memory_allocated(dev)
    del r_plain
    # the same three frames' means: level 0 against mipmapped
    mean3 = float(st_nomip.accum.mean())
    _, _, st_mip3, _ = _frames(r, cam, frames - 1)
    mip3 = float(st_mip3.accum.mean())
    say("13b textured frame", mipmaps_off_ms=f"{ms_nomip:.1f}",
        mip_3_frame_mean=f"{mip3:.6f}", level0_3_frame_mean=f"{mean3:.6f}",
        ratio=f"{mean3 / mip3:.4f}", untextured_ms=f"{ms_plain:.1f}",
        untextured_peak_gib=f"{peak_plain / gib:.2f}",
        untextured_mean=f"{float(st_plain.accum.mean()):.5f}",
        textures_cost_ms=f"{ms - ms_plain:.1f}")
    if abs(mean3 / mip3 - 1.0) > MIP_MEAN_RTOL:
        raise AssertionError(f"level-0 and mipmapped frame means differ: "
                             f"{mean3} against {mip3}")
    del st, st_nomip, st_plain, st_mip3, r
    torch.cuda.empty_cache()
    _texture_gradients(sc, camf, dev)
    return launches


def _texture_gradients(sc, camf, dev, w=GRAD_W, h=GRAD_H):
    """13c: d mean / d (texels, emissive) of a w x h depth-5 frame, remat
    on, through Renderer(accel="tiled")'s intersectors."""
    import dataclasses

    import torch

    from lumenrenderer_tpu_torch.integrator import wavefront as wf
    from lumenrenderer_tpu_torch.render.renderer import Renderer

    gib = 2.0 ** 30
    cam = camf(w / h).to(dev)
    cfg = wf.RenderConfig(width=w, height=h, max_depth=5, bsdf="disney",
                          light_strategy="mis", remat=True)
    r = Renderer(sc, cfg, accel="tiled", device=dev)
    cfg = r.config
    frame = _texture_frame(r.scene, r._isect, r._occl, cam, cfg)
    tex0, em0 = r.scene.textures.texels, r.scene.materials.emissive
    with torch.no_grad():
        frame(tex0, em0)
        fwd_ms = timed_frames(lambda: frame(tex0, em0), 3)

    def grad_call():
        tex = tex0.clone().requires_grad_(True)
        em = em0.clone().requires_grad_(True)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss = frame(tex, em)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        return (float(loss.detach()), tex.grad, em.grad, (t1 - t0) * 1e3,
                (t2 - t1) * 1e3, torch.cuda.max_memory_allocated(dev))

    mean, g_tex, g_em, graph_ms, bwd_ms, peak = grad_call()
    atlas = r.scene.textures
    offs = atlas.offset.tolist() + [atlas.texels.shape[0]]
    base_ids = sorted({i for i in r.scene.materials.base_color_tex.tolist()
                       if i >= 0})
    nz = [int((g_tex[offs[i + 1]:offs[i + 2], :3] != 0).any(-1).sum())
          for i in base_ids]
    finite = bool(torch.isfinite(g_tex).all() and torch.isfinite(g_em).all())
    slope_em = float((g_em * em0).sum())
    say("13c texture gradients", size=f"{w}x{h}", depth=cfg.max_depth,
        remat=cfg.remat, forward_ms=f"{fwd_ms:.1f}",
        forward_graph_ms=f"{graph_ms:.1f}", backward_ms=f"{bwd_ms:.1f}",
        peak_backward_gib=f"{peak / gib:.2f}", finite=finite,
        base_color_texels_with_gradient=json.dumps(nz),
        mean=f"{mean:.6f}", d_mean_d_emission_scale=f"{slope_em:.6f}",
        emission_linearity_rel_err=f"{abs(slope_em - mean) / mean:.3e}")
    if not finite or min(nz) <= 0:
        raise AssertionError("texel gradients not finite, or zero on a "
                             "sampled base-colour texture")
    if abs(slope_em - mean) > GRAD_RTOL * mean:
        raise AssertionError(f"d mean / d emission scale {slope_em} against "
                             f"the mean {mean}")
    tex = tex0.clone().requires_grad_(True)
    em = em0.clone().requires_grad_(True)
    loss = frame(tex, em)
    torch.cuda.synchronize(dev)
    _profile_frame("13c profile backward", loss.backward, "visit_scan_kernel",
                   also=("indexing_backward", "take_put", "RadixSort"))
    del tex, em, loss, g_tex, g_em
    # a central difference on the scale of the room's base-colour texture
    # (id 0): with Lambert and no Russian roulette no sampling decision
    # depends on the base colour, so the frame is a polynomial in the scale
    lam = dataclasses.replace(cfg, bsdf="lambert",
                              rr_start_depth=cfg.max_depth)
    frame_l = _texture_frame(r.scene, r._isect, r._occl, cam, lam)
    lo, hi = offs[1], offs[2]
    tex = tex0.clone().requires_grad_(True)
    frame_l(tex, em0).backward()
    slope = float((tex.grad[lo:hi] * tex0[lo:hi]).sum())
    scaled = {}
    with torch.no_grad():
        for s in (1 + TEX_FD_STEP, 1 - TEX_FD_STEP):
            t_s = tex0.clone()
            t_s[lo:hi] *= s
            scaled[s] = float(frame_l(t_s, em0))
    fd = (scaled[1 + TEX_FD_STEP] - scaled[1 - TEX_FD_STEP]) / (
        2 * TEX_FD_STEP)
    say("13c texture gradients", check="lambert, no RR, texture 0 scale",
        d_mean_d_scale=f"{slope:.6f}", central_difference=f"{fd:.6f}",
        central_rel_err=f"{abs(slope - fd) / abs(fd):.3e}")
    if not abs(slope - fd) <= GRAD_RTOL * abs(fd) or fd <= 0:
        raise AssertionError(f"d mean / d texture scale {slope} against the "
                             f"central difference {fd}")


# -- phase 14: volumes -------------------------------------------------------

NVDB_ASSET = REPO / "tests" / "data" / "sphere_fog.nvdb"
CLOUD_RES, CLOUD_SEED = 384, 11
# a third of the 20 m room across, under its lights and in the camera's view
CLOUD_BOX = ((6.5, 3.5, 5.5), (13.5, 10.5, 12.5))
CLOUD_SIGMA_T, CLOUD_ALBEDO = 0.5, 0.9
CENTRE_T = (0.2, 0.6)        # 14a: transmittance through the cloud's centre
SPARSE_RTOL = 1e-5           # 14c: sparse against dense image mean
RATIO_RTOL = 0.10            # 14c: ratio tracking against Riemann
VOL_FD_STEP = 0.01           # 14e: central difference of the density scale
VOL_FD_RTOL = 1e-2


def _cloud_volumes():
    """The cloud, sphere_density(384, 0.4, 0.15) * noise_density(384, seed),
    as a dense and a sparse volume set on the host, with the host seconds
    of the grid and of each set."""
    from lumenrenderer_tpu_torch.volume import grid

    t0 = time.perf_counter()
    cloud = (grid.sphere_density(CLOUD_RES, 0.4, 0.15)
             * grid.noise_density(CLOUD_RES, CLOUD_SEED))
    t1 = time.perf_counter()
    args = ([cloud], [CLOUD_BOX[0]], [CLOUD_BOX[1]])
    kw = dict(sigma_t=[CLOUD_SIGMA_T], albedo=[CLOUD_ALBEDO])
    dense = grid.make_volume_set(*args, **kw)
    t2 = time.perf_counter()
    sparse = grid.build_sparse(*args, **kw)
    t3 = time.perf_counter()
    return dense, sparse, {"grid_s": t1 - t0,
                           "dense_s": t2 - t1, "sparse_s": t3 - t2}


def _volume_bytes(vols) -> int:
    return sum(getattr(vols, f).numel() * getattr(vols, f).element_size()
               for f in ("density", "index", "bricks", "aabb_lo", "aabb_hi",
                         "sigma_t", "albedo") if hasattr(vols, f))


def _check_nvdb():
    """The port's reader against the SDK's ground truth for the repo's
    sphere_fog.nvdb (the values tests/test_volume_sparse.py holds)."""
    from lumenrenderer_tpu_torch.volume import nvdb

    g = nvdb.load_nvdb(str(NVDB_ASSET))[0]
    dense = g.to_dense()
    lo = g.index_bbox_min
    probes = {ijk: float(dense[tuple(i - o for i, o in zip(ijk, lo))])
              for ijk in ((0, 0, 0), (4, 2, -4), (8, 4, -8), (12, 6, -12))}
    want = {(0, 0, 0): 1.0, (4, 2, -4): 1.0, (8, 4, -8): 0.266667,
            (12, 6, -12): 0.0}
    say("14a nvdb", name=g.name, voxel_size=g.voxel_size[0],
        voxels=g.voxel_count, leaves=len(g.bricks),
        probes=json.dumps({str(k): v for k, v in probes.items()}))
    if (g.name != "sphere_fog" or abs(g.voxel_size[0] - 1 / 16) > 1e-12
            or g.voxel_count != 8733
            or any(abs(probes[k] - v) > 1e-5 for k, v in want.items())):
        raise AssertionError("the .nvdb reader disagrees with the SDK")


def _volume_frame(scene, isect, occl, cam, cfg, leaf: str, seed: int = 0):
    """The mean of the merged frame as a function of the volume set's
    `leaf` (density or bricks), each call from a fresh generator of
    `seed`."""
    import torch

    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.integrator import wavefront as wf

    def frame(grid):
        gen = torch.Generator(device=cam.eye.device)
        gen.manual_seed(seed)
        sc = scene.replace(volumes=scene.volumes.replace(**{leaf: grid}))
        out = wf.render_wavefront(sc, isect, occl, cam,
                                  sampling.generator_uniforms(gen), 0, cfg)
        return wf.merge_channels(out).mean()

    return frame


def _frame_run(phase, r, cam, frames, expect_any, **fields):
    """A warm-up and `frames` timed frames of Renderer r with K1's counts
    set to 0 before and read after; raise on a bad image or on K1 launches
    other than 5 closest and expect_any any a frame. Returns (ms/frame,
    state, launches, mean)."""
    import torch

    from lumenrenderer_tpu_torch.ops import visit_scan as vs

    dev = r.device
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    vs.reset_launches()
    ms, warm_ms, st, overflow = _frames(r, cam, frames)
    launches = dict(vs.LAUNCHES)
    per_frame = {k: v / (frames + 1) for k, v in launches.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    img = st.accum
    finite, mean = bool(torch.isfinite(img).all()), float(img.mean())
    say(phase, size=f"{r.config.width}x{r.config.height}",
        warmup_ms=f"{warm_ms:.1f}", ms_per_frame=f"{ms:.1f}",
        peak_mem_gib=f"{peak / 2**30:.2f}", overflow=overflow,
        mean=f"{mean:.6f}", finite=finite, launches=json.dumps(launches),
        launches_per_frame=json.dumps(per_frame), **fields)
    if not finite or mean <= 0 or overflow:
        raise AssertionError(f"{phase}: bad frame: finite={finite} "
                             f"mean={mean} overflow={overflow}")
    want = {"closest": r.config.max_depth, "any": expect_any}
    if per_frame != want:
        raise AssertionError(f"{phase}: K1 launches per frame {per_frame}, "
                             f"expected {want}")
    return ms, st, launches, mean


def _one_frame(r, cam, scene=None, seed: int = 0):
    """One frame of Renderer r's intersectors and ReSTIR (and its scene, or
    `scene`) through render_wavefront, from a fresh state of `seed`: its
    output channels."""
    import torch

    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.integrator import wavefront as wf

    st = r.init_state(seed)
    with torch.no_grad():
        return wf.render_wavefront(
            r.scene if scene is None else scene, r._isect, r._occl,
            cam.to(r.device),
            sampling.generator_uniforms(st.generator), 0, r.config,
            restir_state=st.restir, restir_fn=r._restir_fn)


def _volumes_small(dev, plain, camf):
    """14a: the reader, the cloud on the host (dense and sparse sets, their
    bytes, the centre transmittance), and 320x180 frames with the .nvdb
    fog and with the dense cloud through K1 and its twin."""
    import torch

    from lumenrenderer_tpu_torch.accel import stream, tiled
    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.render.renderer import KERNEL_VISIT_CAP
    from lumenrenderer_tpu_torch.volume import march, nvdb

    _check_nvdb()
    dense, sparse, host_s = _cloud_volumes()
    vol = dense.to(dev)
    centre = torch.tensor([[(CLOUD_BOX[0][i] + CLOUD_BOX[1][i]) / 2
                            for i in range(2)] + [0.0]], device=dev)
    t_centre = float(march.transmittance_only(
        vol, centre, torch.tensor([[0.0, 0.0, 1.0]], device=dev), 1e-3,
        torch.tensor([20.0], device=dev), steps=1024)[0])
    say("14a cloud", res=CLOUD_RES, voxels=vol.density.numel(),
        dense_bytes=_volume_bytes(dense), sparse_bytes=_volume_bytes(sparse),
        sparse_bricks=sparse.bricks.shape[0],
        cells=sparse.index.numel(), grid_host_s=f"{host_s['grid_s']:.2f}",
        dense_host_s=f"{host_s['dense_s']:.2f}",
        sparse_host_s=f"{host_s['sparse_s']:.2f}",
        sigma_t=CLOUD_SIGMA_T, centre_transmittance=f"{t_centre:.4f}")
    if not CENTRE_T[0] <= t_centre <= CENTRE_T[1]:
        raise AssertionError(f"the cloud's centre transmittance {t_centre} "
                             f"is outside {CENTRE_T}")
    fog = nvdb.sparse_from_nvdb(str(NVDB_ASSET), sigma_t=2.0,
                                albedo=CLOUD_ALBEDO,
                                world_override=CLOUD_BOX)
    cs = stream.build_clusters(plain.tri_pos, cluster_size=128).to(dev)
    mv = min(cs.num_clusters, KERNEL_VISIT_CAP)
    for label, vols in (("nvdb", fog), ("dense cloud", dense)):
        _hold_small_frame(
            f"14a small {label}", plain.replace(volumes=vols).to(dev), camf,
            dev, lambda scan, walk: tiled.tiled_intersectors(
                cs, mv, scan=scan, walk=walk, decode=False),
            (vs.visit_scan, vs.visit_scan_ref))
    return dense, sparse


def _volume_frames(dev, plain, dense, sparse, cam, cfg, frames):
    """14b: the dense cloud at full size with Riemann, profiled, and the
    room without it; 14c: the sparse cloud (the dense frame's image), then
    ratio tracking. Returns 14b's K1 launches."""
    import dataclasses

    import torch

    from lumenrenderer_tpu_torch.render.renderer import Renderer

    march_any = cfg.volume_steps * cfg.volume_depths
    r = Renderer(plain.replace(volumes=dense), cfg, accel="tiled",
                 device=dev)
    ms, st, launches, mean = _frame_run(
        "14b dense cloud", r, cam, frames, cfg.max_depth + march_any,
        volume_bytes=_volume_bytes(dense), transmittance="riemann")
    v_ch = _one_frame(r, cam)["volumetric"]
    lit = int((v_ch.amax(-1) > 0).sum())
    finite = bool(torch.isfinite(v_ch).all())
    say("14b dense cloud", volumetric_pixels=lit,
        volumetric_mean=f"{float(v_ch.mean()):.6f}",
        volumetric_finite=finite)
    if lit == 0 or not finite:
        raise AssertionError("the volumetric channel is empty or not finite")
    del v_ch
    _profile_frame("14b profile", lambda: r.render_frame(st, cam),
                   "visit_scan_kernel", also=("take_put", "put_kernel"))
    del r, st
    r = Renderer(plain, cfg, accel="tiled", device=dev)
    ms_plain, _, _, mean_plain = _frame_run(
        "14b without the cloud", r, cam, frames, cfg.max_depth)
    say("14b dense cloud", cloud_cost_ms=f"{ms - ms_plain:.1f}",
        mean_over_plain=f"{mean / mean_plain:.4f}")
    del r

    r = Renderer(plain.replace(volumes=sparse), cfg, accel="tiled",
                 device=dev)
    ms_sp, _, _, mean_sp = _frame_run(
        "14c sparse cloud", r, cam, frames, cfg.max_depth + march_any,
        volume_bytes=_volume_bytes(sparse), transmittance="riemann")
    sp_err = abs(mean_sp - mean) / mean
    say("14c sparse cloud", dense_mean=f"{mean:.6f}",
        sparse_mean=f"{mean_sp:.6f}", rel_err=f"{sp_err:.3e}",
        rtol=SPARSE_RTOL)
    if sp_err > SPARSE_RTOL:
        raise AssertionError(f"sparse and dense cloud frames differ: "
                             f"{mean_sp} against {mean}")
    del r
    r = Renderer(plain.replace(volumes=sparse), dataclasses.replace(
        cfg, volume_transmittance="ratio"), accel="tiled", device=dev)
    ms_ratio, st, _, mean_ratio = _frame_run(
        "14c ratio tracking", r, cam, frames, cfg.max_depth + march_any,
        transmittance="ratio")
    ratio_err = abs(mean_ratio - mean_sp) / mean_sp
    say("14c ratio tracking", riemann_mean=f"{mean_sp:.6f}",
        ratio_mean=f"{mean_ratio:.6f}", rel_diff=f"{ratio_err:.4f}",
        rtol=RATIO_RTOL, ratio_over_riemann_ms=f"{ms_ratio / ms_sp:.3f}")
    if ratio_err > RATIO_RTOL:
        raise AssertionError(f"ratio tracking's mean {mean_ratio} is not "
                             f"within {RATIO_RTOL} of Riemann's {mean_sp}")
    _profile_frame("14c profile ratio", lambda: r.render_frame(st, cam),
                   "visit_scan_kernel", also=("take_put",))
    return launches


def _volume_restir(dev, dense, w, h, frames, march_any):
    """14d: the restir workload of phase 10 in the cloud, timed against
    the same frame without it, and held against the same frame and draws
    with the cloud's extinction at 0."""
    import torch

    from lumenrenderer_tpu_torch.integrator import wavefront as wf
    from lumenrenderer_tpu_torch.render.renderer import Renderer

    builder, camf = _restir_scene()
    plain = builder.build()
    cfg = _restir_config(w, h)
    cam = camf(w / h)
    r = Renderer(plain.replace(volumes=dense), cfg, accel="tiled",
                 device=dev)
    # NEE's 4 shadow passes, ReSTIR's 2 visibility passes, the march's
    ms_c, st, _, mean_c = _frame_run("14d restir cloud", r, cam, frames,
                                     cfg.max_depth + 1 + march_any)
    # the same frame without the cloud, paired: the cloud's extinction at 0
    # (transmittance 1 everywhere, no in-scattering) with the same draws,
    # which the unpaired frames do not share (the march draws first); at
    # depth 0 the reservoirs do not depend on the density, so the cloud's
    # direct light is at most the clear one's everywhere
    out = _one_frame(r, cam)
    clear = r.scene.volumes.replace(
        sigma_t=torch.zeros_like(r.scene.volumes.sigma_t))
    out0 = _one_frame(r, cam, r.scene.replace(volumes=clear))
    paired_ok = bool((out["direct"] <= out0["direct"] * (1 + 1e-5)
                      + 1e-7).all())
    d_c, d_0 = float(out["direct"].mean()), float(out0["direct"].mean())
    m_c = float(wf.merge_channels(out).mean())
    m_0 = float(wf.merge_channels(out0).mean())
    vol_c = float(out["volumetric"].mean())
    del r, st, out, out0
    r = Renderer(plain, cfg, accel="tiled", device=dev)
    ms_p, _, _, mean_p = _frame_run("14d restir without the cloud", r, cam,
                                    frames, cfg.max_depth + 1)
    say("14d restir cloud", cloud_cost_ms=f"{ms_c - ms_p:.1f}",
        unpaired_mean_over_plain=f"{mean_c / mean_p:.4f}",
        frame_mean=f"{m_c:.6f}", clear_frame_mean=f"{m_0:.6f}",
        mean_over_clear=f"{m_c / m_0:.4f}", direct_mean=f"{d_c:.6f}",
        clear_direct_mean=f"{d_0:.6f}", direct_over_clear=f"{d_c / d_0:.4f}",
        direct_at_most_clear_everywhere=paired_ok,
        volumetric_mean=f"{vol_c:.6f}")
    if not (m_c < m_0 and paired_ok and d_c < d_0):
        raise AssertionError(
            f"the ReSTIR frame in the cloud is not darker than the same "
            f"frame with its extinction at 0: mean {m_c} against {m_0}, "
            f"direct {d_c} against {d_0} (at most everywhere: "
            f"{paired_ok})")


def _grad_call(frame, grid, dev):
    """(frame(grid), d frame / d grid, forward ms, backward ms, peak bytes)
    of one forward with a graph and its backward."""
    import torch

    leaf = grid.clone().requires_grad_(True)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    loss = frame(leaf)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    return (float(loss.detach()), leaf.grad, (t1 - t0) * 1e3,
            (t2 - t1) * 1e3, torch.cuda.max_memory_allocated(dev))


def _profile_backward(phase, frame, grid, also):
    """One backward of frame(grid) under torch.profiler."""
    import torch

    loss = frame(grid.clone().requires_grad_(True))
    torch.cuda.synchronize()
    _profile_frame(phase, loss.backward, "visit_scan_kernel", also=also)


def _volume_gradients(dev, plain, dense, sparse, camf, cfg, frames):
    """14e: d mean / d density at full size, remat on (and d mean /
    d bricks of the sparse cloud), remat off, K1 against its twin at
    320x180, and a central difference of the density's scale."""
    import dataclasses

    import torch

    from lumenrenderer_tpu_torch.accel import tiled
    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.render.renderer import Renderer

    gib = 2.0 ** 30
    torch.cuda.empty_cache()
    r = Renderer(plain.replace(volumes=dense),
                 dataclasses.replace(cfg, remat=True), accel="tiled",
                 device=dev)
    gcfg, cam = r.config, camf(cfg.width / cfg.height).to(dev)
    d0 = r.scene.volumes.density
    frame = _volume_frame(r.scene, r._isect, r._occl, cam, gcfg, "density")
    with torch.no_grad():
        frame(d0)
        fwd_ms = timed_frames(lambda: frame(d0), frames)
    _grad_call(frame, d0, dev)                            # warm
    vs.reset_launches()
    mean_g, g, graph_ms, bwd_ms, peak = _grad_call(frame, d0, dev)
    g_launches = dict(vs.LAUNCHES)
    with_grad = int(g.ne(0).sum())
    finite = bool(torch.isfinite(g).all())
    say("14e density gradient", size=f"{cfg.width}x{cfg.height}",
        remat=gcfg.remat, voxels=g.numel(), forward_ms=f"{fwd_ms:.1f}",
        forward_graph_ms=f"{graph_ms:.1f}", backward_ms=f"{bwd_ms:.1f}",
        ratio=f"{(graph_ms + bwd_ms) / fwd_ms:.3f}",
        backward_over_forward=f"{bwd_ms / fwd_ms:.3f}",
        peak_gib=f"{peak / gib:.2f}", finite=finite,
        voxels_with_gradient=with_grad,
        d_mean_d_scale=f"{float((g * d0).sum()):.6e}",
        k1_launches_fwd_bwd=json.dumps(g_launches))
    if not finite or with_grad == 0:
        raise AssertionError("the density gradient is not finite, or zero")
    want = {"closest": gcfg.max_depth,
            "any": gcfg.max_depth + cfg.volume_steps * cfg.volume_depths}
    if g_launches != want:
        raise AssertionError(f"K1 launches per forward and backward "
                             f"{g_launches}, expected {want} (the recompute "
                             "launches none)")
    _profile_backward("14e profile backward", frame, d0,
                      ("take_put", "indexing_backward"))

    # the sparse bricks: every sample in empty space reads the shared zero
    # brick (slot 0), so its 729 floats take most of the atomic adds
    sp = plain.replace(volumes=sparse).to(dev)
    frame_b = _volume_frame(sp, r._isect, r._occl, cam, gcfg, "bricks")
    mean_b, g_b, graph_b, bwd_b, peak_b = _grad_call(
        frame_b, sp.volumes.bricks, dev)
    finite_b = bool(torch.isfinite(g_b).all())
    say("14e bricks gradient", bricks=g_b.shape[0],
        forward_graph_ms=f"{graph_b:.1f}", backward_ms=f"{bwd_b:.1f}",
        peak_gib=f"{peak_b / gib:.2f}", finite=finite_b,
        bricks_with_gradient=int(g_b.ne(0).flatten(1).any(1).sum()),
        zero_brick_gradient=f"{float(g_b[0].abs().sum()):.3e}",
        mean_rel_to_dense=f"{abs(mean_b - mean_g) / mean_g:.3e}")
    if not finite_b or not bool(g_b.ne(0).any()):
        raise AssertionError("the bricks' gradient is not finite, or zero")
    del g_b
    _profile_backward("14e profile bricks backward", frame_b,
                      sp.volumes.bricks, ("take_put",))
    del sp, frame_b

    # remat off: the march's replay changes nothing
    torch.cuda.empty_cache()
    frame_nr = _volume_frame(r.scene, r._isect, r._occl, cam,
                             dataclasses.replace(gcfg, remat=False),
                             "density")
    mean_nr, g_nr, _, bwd_nr, peak_nr = _grad_call(frame_nr, d0, dev)
    remat_err = float((g_nr - g).abs().max() / g.abs().max())
    say("14e density gradient", remat_off_backward_ms=f"{bwd_nr:.1f}",
        remat_off_peak_gib=f"{peak_nr / gib:.2f}",
        remat_vs_off_max_err=f"{remat_err:.3e}", rtol=REMAT_RTOL)
    if abs(mean_nr - mean_g) > 1e-6 * mean_g or remat_err > REMAT_RTOL:
        raise AssertionError(f"remat changed the frame ({mean_nr} vs "
                             f"{mean_g}) or its gradient ({remat_err})")
    del g_nr, frame_nr
    torch.cuda.empty_cache()

    # a 320x180 gradient through K1 and through its twin
    small = dataclasses.replace(gcfg, width=SMALL_W, height=SMALL_H)
    scam = camf(SMALL_W / SMALL_H).to(dev)
    grads = [_grad_call(_volume_frame(r.scene, *tiled.tiled_intersectors(
        r.clusters, r.max_visits, scan=scan, decode=False), scam, small,
        "density"),
        d0, dev)[1] for scan in (vs.visit_scan, vs.visit_scan_ref)]
    twin_err = float((grads[0] - grads[1]).abs().max()
                     / grads[1].abs().max())
    say("14e density gradient small", size=f"{SMALL_W}x{SMALL_H}",
        kernel_vs_twin_max_err=f"{twin_err:.3e}", rtol=REMAT_RTOL)
    if twin_err > REMAT_RTOL:
        raise AssertionError(f"density gradients through K1 and its twin "
                             f"differ: {twin_err}")
    del grads

    # a central difference of the density's scale, on a frame where no
    # sampling decision depends on the density: no Russian roulette, and
    # BSDF sampling only (NEE's shadow transmittance is detached)
    fd_cfg = dataclasses.replace(gcfg, light_strategy="bsdf",
                                 rr_start_depth=gcfg.max_depth)
    frame_fd = _volume_frame(r.scene, r._isect, r._occl, cam, fd_cfg,
                             "density")
    g_fd = _grad_call(frame_fd, d0, dev)[1]
    slope = float((g_fd * d0).sum())
    with torch.no_grad():
        f_hi = float(frame_fd(d0 * (1 + VOL_FD_STEP)))
        f_lo = float(frame_fd(d0 * (1 - VOL_FD_STEP)))
    fd = (f_hi - f_lo) / (2 * VOL_FD_STEP)
    say("14e density gradient", check="bsdf, no RR, density scale",
        d_mean_d_scale=f"{slope:.6e}", central_difference=f"{fd:.6e}",
        central_rel_err=f"{abs(slope - fd) / abs(fd):.3e}",
        rtol=VOL_FD_RTOL)
    if not abs(slope - fd) <= VOL_FD_RTOL * abs(fd):
        raise AssertionError(f"d mean / d density scale {slope} against the "
                             f"central difference {fd}")


def phase_volumes(dev, w=W, h=H, frames=SLICE_FRAMES):
    """Phase 14: a 384³ cloud in the 2560x1440 interior frame: the .nvdb
    reader and small frames through K1 and its twin (14a), the dense cloud
    (14b), the sparse one and ratio tracking (14c), ReSTIR in the cloud
    (14d), the density gradient (14e). Returns 14b's K1 launches."""
    import torch

    from lumenrenderer_tpu_torch.integrator import wavefront as wf
    from lumenrenderer_tpu_torch.scene import presets

    torch.cuda.empty_cache()
    builder, camf = presets.interior_scene(n_boxes=600, n_lights=64)
    plain = builder.build()
    dense, sparse = _volumes_small(dev, plain, camf)
    cfg = wf.RenderConfig(width=w, height=h, max_depth=5, bsdf="disney",
                          light_strategy="mis", volume_steps=5,
                          volume_depths=2)
    launches = _volume_frames(dev, plain, dense, sparse, camf(w / h), cfg,
                              frames)
    _volume_restir(dev, dense, w, h, frames,
                   cfg.volume_steps * cfg.volume_depths)
    _volume_gradients(dev, plain, dense, sparse, camf, cfg, frames)
    return launches

# -- phase 15: the application ------------------------------------------------

APP_FRAMES = 3               # 15a: timed stream frames
APP_REF_SPP = 16             # 15b: frames of the denoiser's reference
OUT_W, OUT_H = 3840, 2160    # 15b, 15e: the upscaled output
SHARPEN = 0.3
WEIGHT_TOL = 1e-5            # 15b: weight matrices against the CPU's
RESUME_TOL = 1e-6            # 15d: resumed frame against uninterrupted
CLI_SPP, CLI_STATS_EVERY = 4, 2
PAN_STEP = 0.05              # 15c: metres the camera moves a frame
STREAM_T_RTOL, STREAM_T_ATOL = 2e-4, 1e-5    # 15a: stream t against brute


def _interior_renderer(dev, accel, w=W, h=H, depth=5, **kw):
    from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
    from lumenrenderer_tpu_torch.render.renderer import Renderer
    from lumenrenderer_tpu_torch.scene import presets

    builder, camf = presets.interior_scene(n_boxes=600, n_lights=64)
    cfg = RenderConfig(width=w, height=h, max_depth=depth, bsdf="disney",
                       light_strategy="mis")
    return (Renderer(builder.build(), cfg, accel=accel, device=dev, **kw),
            camf(w / h))


def _frames_from(r, cam, seed, n):
    """n frames from init_state(seed): (state, the last frame's AOVs)."""
    st, aux = r.init_state(seed), None
    for _ in range(n):
        st, aux = r.render_frame(st, cam)
    return st, aux


def _stream_passes(r, cam):
    """One stream frame with every query's pair stream measured: [(mode,
    live rays, pairs, overflow, tiles, product blocks)]."""
    from lumenrenderer_tpu_torch.accel import stream

    rows = []
    isect0, occl0 = r._isect, r._occl

    def watch(fn, mode):
        def query(o, d, tn, tx):
            q = stream.pair_stream(r.clusters, o, d, tn, tx,
                                   r.max_pairs_per_ray)
            tiles = q["tile_cluster"].shape[0]
            rows.append((mode, int((q["t_max"] >= q["t_min"]).sum()),
                         q["pairs"], bool(q["overflow"]), tiles,
                         -(-tiles // stream.PAIR_BLOCK_TILES)))
            return fn(o, d, tn, tx)
        return query

    r._isect, r._occl = watch(isect0, "closest"), watch(occl0, "any")
    try:
        r.render_frame(r.init_state(0), cam)
    finally:
        r._isect, r._occl = isect0, occl0
    return rows


def _stream_vs_brute(dev):
    """15a: a SMALL_W x SMALL_H depth-3 stream frame whose closest queries
    are each held against brute force: the triangle equal except at ties
    (t within 1e-5 relative), and on the primary query t within
    STREAM_T_RTOL relative plus STREAM_T_ATOL (tests/test_stream.py's
    bar: the bilinear form's t is not Möller–Trumbore's; the share within
    1e-5 relative is printed)."""
    import torch

    from lumenrenderer_tpu_torch.accel import brute

    r, cam = _interior_renderer(dev, "stream", SMALL_W, SMALL_H, depth=3)
    isect0 = r._isect
    worst = []

    def held(o, d, tn, tx):
        res = isect0(o, d, tn, tx)
        ref = brute.intersect_closest(r.scene.tri_pos, o, d, tn, tx)
        same = res["tri"] == ref["tri"]
        both = torch.isfinite(ref["t"]) & torch.isfinite(res["t"])
        rel = ((res["t"] - ref["t"]).abs()
               / ref["t"].abs().clamp_min(1e-12))
        tie = both & (rel <= 1e-5)
        t_ok = torch.where(
            both, (res["t"] - ref["t"]).abs()
            <= STREAM_T_ATOL + STREAM_T_RTOL * ref["t"].abs(),
            torch.isinf(res["t"]) == torch.isinf(ref["t"]))
        worst.append((float(same.float().mean()),
                      float((same | tie).float().mean()),
                      float(t_ok.float().mean()),
                      float((both & (rel <= 1e-5)).float().sum()
                            / both.float().sum().clamp_min(1.0)),
                      float(torch.where(both, rel, 0.0).max())))
        return res

    r._isect = held
    r.render_frame(r.init_state(0), cam)
    for i, (same, same_or_tie, t_ok, t_1e5, rel) in enumerate(worst):
        say("15a stream", query=i, size=f"{SMALL_W}x{SMALL_H}",
            against="brute", tri_equal=f"{same:.6f}",
            tri_equal_or_tie=f"{same_or_tie:.6f}", t_within=f"{t_ok:.6f}",
            t_within_1e5_rel=f"{t_1e5:.6f}", t_max_rel_err=f"{rel:.3e}")
        if same_or_tie < 1.0 or (i == 0 and t_ok < 1.0):
            raise AssertionError(f"15a: stream query {i} differs from "
                                 f"brute: {same_or_tie}, {t_ok}")


def _app_stream(dev, frames=APP_FRAMES):
    """15a: the interior through Renderer(accel="stream"), held against
    the tiled frame of the same seed."""
    import torch

    rt, cam = _interior_renderer(dev, "tiled")
    st_t, aux_t = rt.render_frame(rt.init_state(0), cam)
    for _ in range(frames):
        st_t, _ = rt.render_frame(st_t, cam)
    r, _ = _interior_renderer(dev, "stream")
    rows = _stream_passes(r, cam)
    for mode, rays, pairs, ovf, tiles, blocks in rows:
        say("15a stream", mode=mode, live_rays=rays, live_pairs=pairs,
            pairs_per_live_ray=f"{pairs / max(rays, 1):.3f}",
            overflow=ovf, tiles=tiles, product_blocks=blocks)
    if any(row[3] for row in rows):
        raise AssertionError(f"15a: a stream query overflows at "
                             f"{r.max_pairs_per_ray} pairs per ray")
    torch.cuda.reset_peak_memory_stats(dev)
    st, aux = r.render_frame(r.init_state(0), cam)
    warm = r.frame_stats["Total Frame Time"]

    def one():
        nonlocal st
        st, _ = r.render_frame(st, cam)

    ms = timed_frames(one, frames)
    peak = torch.cuda.max_memory_allocated(dev)
    mean = float(st.accum.mean())
    finite = bool(torch.isfinite(st.accum).all())
    say("15a stream", size=f"{W}x{H}", max_pairs_per_ray=r.max_pairs_per_ray,
        warmup_ms=f"{warm:.1f}", ms_per_frame=f"{ms:.1f}",
        peak_mem_gib=f"{peak / 2**30:.2f}", mean=f"{mean:.6f}",
        finite=finite, overflow=r.frame_stats["overflow"])
    if not finite or mean <= 0 or r.frame_stats["overflow"]:
        raise AssertionError(f"15a: bad stream frame: {finite} {mean}")
    # the first frames' AOVs, and the means of frames + 1 frames
    _hold_frames("15a stream", "tiled", aux, aux_t, mean,
                 float(st_t.accum.mean()),
                 _key_low_bits(rt.clusters.num_clusters, 128, rt.max_visits))
    _profile_frame("15a profile", lambda: r.render_frame(st, cam), "gemm")
    _stream_vs_brute(dev)
    return rt, cam


def _app_post(dev, rt, cam):
    """15b: denoise and upscale of a 1-spp tiled frame and its AOVs."""
    import torch

    from lumenrenderer_tpu_torch.render import denoise, upscale

    st, aux = _frames_from(rt, cam, 0, 1)
    ref = _frames_from(rt, cam, 1, APP_REF_SPP)[0].accum
    raw = st.accum

    def den():
        return denoise.denoise_frame(raw, aux, W, H)

    def up():
        return upscale.upscale(out.reshape(H, W, 3), OUT_H, OUT_W,
                               "lanczos3", sharpen=SHARPEN)

    out = den()
    for name, fn in (("denoise_frame", den), ("upscale", up)):
        ms = cuda_time_ms(fn, reps=3)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        fn()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        _, kernels = _device_kernels(fn)
        say("15b post", stage=name, ms=f"{ms:.2f}",
            launches=sum(k[2] for k in kernels),
            device_ms=f"{sum(k[0] for k in kernels):.2f}",
            extra_peak_mem_gib=f"{peak / 2**30:.2f}")
    err_raw = float((raw - ref).abs().mean())
    err_den = float((out - ref).abs().mean())
    say("15b post", reference_spp=APP_REF_SPP, raw_mae=f"{err_raw:.6f}",
        denoised_mae=f"{err_den:.6f}", ratio=f"{err_den / err_raw:.4f}")
    if not err_den < err_raw:
        raise AssertionError(f"15b: denoising did not lower the error: "
                             f"{err_den} vs {err_raw}")
    img = up()
    finite = bool(torch.isfinite(img).all())
    low = float(img.min())
    worst, worst64 = 0.0, 0.0
    for n_in, n_out, kern in ((H, OUT_H, "lanczos3"), (W, OUT_W, "lanczos3"),
                              (OUT_H, OUT_H // 2, "linear"),
                              (OUT_W // 2, OUT_W, "linear")):
        k = upscale._KERNELS[kern]
        args = (n_in, n_out, n_out / n_in, 0.0, k, True)
        a = upscale.compute_weight_mat(*args, device=dev).cpu()
        worst = max(worst, float((a - upscale.compute_weight_mat(
            *args)).abs().max()))
        worst64 = max(worst64, float((a.double() - upscale.compute_weight_mat(
            *args, dtype=torch.float64)).abs().max()))
    say("15b post", upscaled=f"{OUT_W}x{OUT_H}", finite=finite,
        min=f"{low:.6f}", weights_max_abs_err_vs_cpu=f"{worst:.3e}",
        weights_max_abs_err_vs_float64=f"{worst64:.3e}")
    if not finite or low < 0 or worst > WEIGHT_TOL:
        raise AssertionError(f"15b: bad upscale: {finite} {low} {worst}")


def _pan(cam, n):
    """n cameras moving PAN_STEP in x a frame, each knowing the previous
    pose (for the motion vectors)."""
    from lumenrenderer_tpu_torch.core.camera import Camera

    eye = cam.eye.cpu().numpy()
    cams, prev = [], None
    for i in range(n):
        shift = (PAN_STEP * i, 0.0, 0.0)
        c = Camera.look_at(eye=tuple(eye + shift),
                           target=tuple(eye + cam.w.cpu().numpy() + shift),
                           fov_y_deg=60.0, aspect=W / H)
        cams.append(c.with_previous(prev or c, 60.0, W / H))
        prev = c
    return cams


def _app_sequence(rt, cam):
    """15c: render_sequence over a pan; flicker on a static camera."""
    import numpy as np

    t0 = time.perf_counter()
    imgs = rt.render_sequence(_pan(cam, 3), spp=1, denoise="temporal")
    ms = (time.perf_counter() - t0) / 3 * 1e3
    finite = all(np.isfinite(i).all() for i in imgs)
    raw = rt.render_sequence([cam] * 3, spp=1, denoise="off", seed=5)
    tmp = rt.render_sequence([cam] * 3, spp=1, denoise="temporal", seed=5)
    flick_r = float(np.abs(raw[2] - raw[1]).mean())
    flick_t = float(np.abs(tmp[2] - tmp[1]).mean())
    say("15c sequence", cameras=3, ms_per_camera=f"{ms:.1f}",
        finite=finite, flicker_raw=f"{flick_r:.6f}",
        flicker_temporal=f"{flick_t:.6f}",
        ratio=f"{flick_t / flick_r:.4f}")
    if not finite or not flick_t < flick_r:
        raise AssertionError(f"15c: sequence {finite}, flicker {flick_t} "
                             f"vs {flick_r}")


def _app_checkpoint(dev, rt, cam, directory):
    """15d: save after 2 frames, load into init_state(999), resume."""
    import os

    import torch

    from lumenrenderer_tpu_torch.render import checkpoint

    st, _ = _frames_from(rt, cam, 3, 2)
    path = os.path.join(directory, "state.npz")
    t0 = time.perf_counter()
    checkpoint.save_state(path, st)
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    resumed = checkpoint.load_state(path, rt.init_state(999))
    torch.cuda.synchronize(dev)
    load_ms = (time.perf_counter() - t0) * 1e3
    a, _ = rt.render_frame(st, cam)
    b, _ = rt.render_frame(resumed, cam)
    diff = float((a.accum - b.accum).abs().max())
    say("15d checkpoint", bytes=os.path.getsize(path),
        save_ms=f"{save_ms:.1f}", load_ms=f"{load_ms:.1f}",
        frame_index=resumed.frame_index, max_abs_diff=f"{diff:.3e}")
    if diff > RESUME_TOL or resumed.frame_index != 2:
        raise AssertionError(f"15d: resumed frame differs by {diff}")


def _png_size(path):
    import struct

    with open(path, "rb") as f:
        head = f.read(24)
    return struct.unpack(">II", head[16:24])


def _run_cli(args, directory, launches=False):
    """The CLI in a subprocess on the card: (seconds, stderr). With
    launches, the subprocess calls the CLI's main and prints K1's launch
    counts after it."""
    import os

    if launches:
        cmd = [sys.executable, "-c",
               "import json, sys; from lumenrenderer_tpu_torch.app import "
               "cli; from lumenrenderer_tpu_torch.ops import visit_scan as "
               "vs; rc = cli.main(sys.argv[1:]); "
               "print('K1_LAUNCHES', json.dumps(vs.LAUNCHES)); sys.exit(rc)"]
    else:
        cmd = [sys.executable, "-m", "lumenrenderer_tpu_torch.app.cli"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd + args, cwd=directory, env=env,
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"15e: the CLI exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return seconds, proc.stdout, proc.stderr


def _app_cli(directory):
    """15e: the CLI end to end on the interior (tiled, from a JSON config)
    and with its defaults on the Cornell box. Returns K1's launches in the
    interior run."""
    import os

    cfg_path = os.path.join(directory, "app.json")
    with open(cfg_path, "w") as f:
        json.dump({"accel": "tiled"}, f)
    out = os.path.join(directory, "interior.png")
    seconds, stdout, stderr = _run_cli(
        [cfg_path, "--preset", "interior", "--size", f"{W}x{H}",
         "--out-size", f"{OUT_W}x{OUT_H}", "--spp", str(CLI_SPP),
         "--depth", "5", "--denoise", "--aovs", "--stats-every",
         str(CLI_STATS_EVERY), "-o", out], directory, launches=True)
    size = _png_size(out)
    aovs = [os.path.exists(out.replace(".png", f".{n}.png"))
            for n in ("albedo", "normal", "depth")]
    stages = [ln for ln in stderr.splitlines() if "mean stage times" in ln]
    launches = json.loads(stdout.split("K1_LAUNCHES", 1)[1].strip())
    say("15e cli", run="interior", seconds=f"{seconds:.1f}",
        png=f"{size[0]}x{size[1]}", aovs=all(aovs),
        launches=json.dumps(launches))
    say("15e cli", run="interior", stage_times=repr(stages[-1][:600]))
    # 4 frames of 5 closest and 5 any; 2 probes of 2 frames, 2 primary and
    # 2 bounce closest queries and 2 occlusion queries
    probes = -(-CLI_SPP // CLI_STATS_EVERY)
    expect = {"closest": 5 * CLI_SPP + probes * (4 + 10),
              "any": 5 * CLI_SPP + probes * (2 + 10)}
    if size != (OUT_W, OUT_H) or not all(aovs) or launches != expect:
        raise AssertionError(f"15e: interior CLI wrote {size}, AOVs {aovs}, "
                             f"K1 {launches} (expected {expect})")
    seconds, _, stderr = _run_cli(
        ["--preset", "cornell", "--spp", "4", "-o",
         os.path.join(directory, "cornell.png")], directory)
    size = _png_size(os.path.join(directory, "cornell.png"))
    say("15e cli", run="cornell defaults", seconds=f"{seconds:.1f}",
        png=f"{size[0]}x{size[1]}",
        scene=repr([ln for ln in stderr.splitlines()
                    if ln.startswith("scene:")][0]))
    if size != (1280, 720):
        raise AssertionError(f"15e: the default CLI wrote {size}")
    return launches


def phase_app(dev):
    """Phase 15: the application (stream, denoise, upscale, sequence,
    checkpoint, the CLI). Returns K1's launches in the CLI's interior
    run."""
    import tempfile

    import torch

    torch.cuda.empty_cache()
    rt, cam = _app_stream(dev)
    _app_post(dev, rt, cam)
    _app_sequence(rt, cam)
    with tempfile.TemporaryDirectory() as directory:
        _app_checkpoint(dev, rt, cam, directory)
        stages = rt.profile_stages(cam, reps=3)
        say("15e profile_stages", **{k.replace(" ", "_"): f"{v:.2f}"
                                     for k, v in stages.items()})
        return _app_cli(directory)



# -- phase 16: the BVH accels (kernel T) and the mesh -------------------------

BVH_SUBSET = 65_536          # 16a: evenly spaced rays of each pass
MESH_FRAMES = SLICE_FRAMES + 1   # 16c: the 2-rank image's frames
RANK_TIMEOUT = 420           # 16c: seconds a rank subprocess may take
RANK_TRAIN_W, RANK_TRAIN_H = 320, 180    # 16c: the 2-rank training step


def _bvh_passes(dev, sc, cam):
    """The interior's 2560x1440 primary, sorted bounce and sorted shadow
    passes as T takes them: {name: (o, d, t_min, t_max)}."""
    import torch

    from lumenrenderer_tpu_torch.accel import stream

    cs = stream.build_clusters(sc.tri_pos, cluster_size=128).to(dev)

    def capture(o, d, tn, tx):
        r = o.shape[0]

        def per_ray(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev
                                   ).expand(r).contiguous()

        return {"rays": (o.contiguous(), d.contiguous(), per_ray(tn),
                         per_ray(tx)),
                "overflow": torch.tensor(False, device=dev)}

    passes = _secondary_passes(sc, cs, cam, dev, W, H, capture, primary=True)
    return {name: q["rays"] for name, q in passes.items()}


def _walk_work(bvh, rays, counts, closest):
    """(operations, bytes) of T's walk of `rays` from its counters: a box
    test for each root and two for each internal node popped, a
    Möller–Trumbore test for each slot of each leaf popped; the rays in,
    the results out and the BVH once."""
    from lumenrenderer_tpu_torch.ops import bvh_traverse as bt

    r = rays[0].shape[0]
    c = counts.double().sum(0)
    ops = (bt.BOX_TEST_OPS * (r + 2 * float(c[0]))
           + bt.SLOT_TEST_OPS * bvh.leaf_size * float(c[1]))
    bvh_bytes = _nbytes(bvh.node_lo, bvh.node_hi, bvh.child0, bvh.child1,
                        bvh.tri_p0, bvh.tri_e1, bvh.tri_e2, bvh.tri_id)
    return ops, _nbytes(*rays) + r * (16 if closest else 1) + bvh_bytes


def _hold_walk_pass(label, name, bvh, rays, closest):
    """T against its twin on BVH_SUBSET evenly spaced rays of one pass
    (triangles or hit bits identical on MATCH_FRACTION, t, u and v bit for
    bit where the triangle agrees, the counters identical), then T on
    every ray of it: its time, operations, bound and share."""
    import torch

    from lumenrenderer_tpu_torch.ops import bvh_traverse as bt

    dev = rays[0].device
    n = rays[0].shape[0]
    idx = torch.linspace(0, n - 1, min(BVH_SUBSET, n), device=dev).long()
    sub = tuple(x[idx].contiguous() for x in rays)
    mode = "closest" if closest else "any"
    ck = torch.zeros((sub[0].shape[0], 2), dtype=torch.int32, device=dev)
    ct = torch.zeros_like(ck)
    kern = bt.bvh_traverse(bvh, *sub, any_hit=not closest, counts=ck)
    twin = bt.bvh_traverse_ref(bvh, *sub, any_hit=not closest, counts=ct)
    torch.cuda.synchronize()
    bt.raise_on_error(dev)
    if closest:
        same = kern[1] == twin[1]
        bits_equal = all(torch.equal(a.view(torch.int32)[same],
                                     b.view(torch.int32)[same])
                         for a, b in zip((kern[0], kern[2], kern[3]),
                                         (twin[0], twin[2], twin[3])))
        both = same & (kern[1] >= 0)
        err = float((kern[0] - twin[0]).abs()[both].max()) if bool(
            both.any()) else 0.0
    else:
        same = kern == twin
        bits_equal, err = True, float((~same).any())
    match = float(same.float().mean())
    counters = float((ck == ct).all(1).float().mean())
    ms = cuda_time_ms(lambda: bt.bvh_traverse(bvh, *sub,
                                              any_hit=not closest))
    plain_ms = cuda_time_ms(lambda: bt.bvh_traverse_ref(
        bvh, *sub, any_hit=not closest), reps=1)
    ops, nb = _walk_work(bvh, sub, ck, closest)
    b_ms, b_by = bound_ms(ops, nb)
    say("16a walk", bvh=label, rays=name, mode=mode, scope="subset",
        rays_n=sub[0].shape[0], match=f"{match:.6f}",
        tuv_bits_equal=bits_equal, counters_equal=f"{counters:.6f}",
        max_abs_err=err, kernel_ms=f"{ms:.4f}", twin_ms=f"{plain_ms:.2f}",
        ops=f"{ops:.4g}", bound_ms=f"{b_ms:.5f}", bound_by=b_by,
        share=f"{b_ms / ms:.4f}")
    if match < MATCH_FRACTION or not bits_equal or counters < MATCH_FRACTION:
        raise AssertionError(f"16a: T differs from its twin on the {label} "
                             f"{name} pass ({mode}): match {match}, t/u/v "
                             f"bits {bits_equal}, counters {counters}")
    counts = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    bt.bvh_traverse(bvh, *rays, any_hit=not closest, counts=counts)
    full_ms = cuda_time_ms(lambda: bt.bvh_traverse(bvh, *rays,
                                                   any_hit=not closest))
    f_ops, f_nb = _walk_work(bvh, rays, counts, closest)
    fb_ms, fb_by = bound_ms(f_ops, f_nb)
    live = int((rays[3] >= rays[2]).sum())
    say("16a walk", bvh=label, rays=name, mode=mode, scope="full",
        rays_n=n, live_rays=live, full_pass_kernel_ms=f"{full_ms:.4f}",
        inner_per_ray=f"{float(counts[:, 0].double().mean()):.2f}",
        leaves_per_ray=f"{float(counts[:, 1].double().mean()):.2f}",
        ops=f"{f_ops:.4g}", bytes=f_nb, bound_ms=f"{fb_ms:.5f}",
        bound_by=fb_by, share=f"{fb_ms / full_ms:.4f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "ops": ops, "bytes": nb, "full_pass_ms": full_ms,
            "full_pass_bound_ms": fb_ms}


def _hold_walks(label, bvh, passes):
    """_hold_walk_pass over the passes in both modes: per mode the worst
    error and the passes' mean times and bounds, with bound_by."""
    out = {}
    for mode, closest in (("closest", True), ("any", False)):
        rows = [_hold_walk_pass(label, name, bvh, rays, closest)
                for name, rays in passes.items()]
        mean = {k: sum(r[k] for r in rows) / len(rows)
                for k in ("ms", "plain_ms", "bound_ms", "full_pass_ms",
                          "full_pass_bound_ms")}
        out[mode] = {"max_abs_err": max(r["max_abs_err"] for r in rows),
                     **mean, "bound_by": bound_ms(
                         sum(r["ops"] for r in rows),
                         sum(r["bytes"] for r in rows))[1]}
    return out


def _bvh_builds(dev, sc):
    """Host build seconds of the native and numpy SAH builders, the LBVH's
    device build ms; (sah BVH, lbvh BVH) on the card."""
    import torch

    from lumenrenderer_tpu_torch.accel import format as bvh_format
    from lumenrenderer_tpu_torch.accel import lbvh, sah
    from lumenrenderer_tpu_torch.native import bvh_native

    tri_np = sc.tri_pos.cpu().numpy()
    bvh_native.build_library()
    t0 = time.perf_counter()
    native = sah.bvh_from_arrays(tri_np, bvh_native.build_sah(tri_np, 4))
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = sah.bvh_from_arrays(tri_np, sah.build_sah_arrays(tri_np, 4))
    numpy_s = time.perf_counter() - t0
    lb = lbvh.build_lbvh(sc.tri_pos)
    lbvh_ms = cuda_time_ms(lambda: lbvh.build_lbvh(sc.tri_pos), reps=3)
    for label, b in (("sah native", native), ("sah numpy", plain),
                     ("lbvh", lb)):
        say("16 build", bvh=label, nodes=b.num_nodes, leaves=b.num_leaves,
            max_depth=b.max_depth, leaf_size=b.leaf_size)
    # kernel T's records, part of each build above (host for the SAH BVH)
    t0 = time.perf_counter()
    bvh_format.kernel_records(native)
    records_host_ms = (time.perf_counter() - t0) * 1e3
    sah_dev = native.to(dev)
    records_ms = {b: cuda_time_ms(lambda: bvh_format.kernel_records(x),
                                  reps=3)
                  for b, x in (("sah", sah_dev), ("lbvh", lb))}
    say("16 build", sah_native_host_s=f"{native_s:.3f}",
        sah_numpy_host_s=f"{numpy_s:.3f}", lbvh_device_ms=f"{lbvh_ms:.3f}",
        sah_records_host_ms=f"{records_host_ms:.3f}",
        sah_records_device_ms=f"{records_ms['sah']:.3f}",
        lbvh_records_device_ms=f"{records_ms['lbvh']:.3f}")
    torch.cuda.synchronize()
    return sah_dev, lb


def _bvh_frames(dev, accel, ref, frames=SLICE_FRAMES):
    """16b: Renderer(accel) on the interior at 2560x1440, 1 warm-up and
    `frames` timed frames, T launched 5 closest and 5 any a frame, held
    against the tiled frames `ref` of the same seed, one profiled frame.
    Returns T's launches."""
    import torch

    from lumenrenderer_tpu_torch.ops import bvh_traverse as bt

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r, cam = _interior_renderer(dev, accel)
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    bt.reset_launches()
    st, aux = r.render_frame(r.init_state(0), cam)
    warm = r.frame_stats["Total Frame Time"]

    def one():
        nonlocal st
        st, _ = r.render_frame(st, cam)

    ms = timed_frames(one, frames)
    launches = dict(bt.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    mean = float(st.accum.mean())
    finite = bool(torch.isfinite(st.accum).all())
    per_frame = {k: v / (frames + 1) for k, v in launches.items()}
    say("16b bvh frame", accel=accel, size=f"{W}x{H}",
        renderer_build_s=f"{build_s:.2f}", nodes=r.bvh.num_nodes,
        max_depth=r.bvh.max_depth, warmup_ms=f"{warm:.1f}",
        ms_per_frame=f"{ms:.1f}", peak_mem_gib=f"{peak / 2**30:.2f}",
        mean=f"{mean:.6f}", finite=finite,
        overflow=r.frame_stats["overflow"], launches=json.dumps(launches))
    if not finite or mean <= 0 or per_frame != {"closest": 5, "any": 5}:
        raise AssertionError(f"16b: bad {accel} frame: finite {finite}, "
                             f"mean {mean}, T launches {per_frame}")
    rt, aux_t, mean_t = ref
    _hold_frames("16b bvh frame", f"tiled ({accel})", aux, aux_t, mean,
                 mean_t, _key_low_bits(rt.clusters.num_clusters, 128,
                                       rt.max_visits))
    _profile_frame(f"16b profile {accel}", lambda: r.render_frame(st, cam),
                   "bvh_traverse_kernel")
    return launches


def _train_setup(r, cam, dev):
    """(target image at twice the emission, a draws() factory) of the
    Renderer's frame, for a training step on the emissive."""
    import torch

    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.integrator import wavefront as wf
    from lumenrenderer_tpu_torch.parallel import train

    def draws():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return sampling.generator_uniforms(gen)

    cam = cam.to(dev)
    params0, _ = train.split_params(r.scene)
    bright = train.merge_params(
        r.scene, {**params0, "emissive": params0["emissive"] * 2.0})
    with torch.no_grad():
        target = wf.merge_channels(wf.render_wavefront(
            bright, r._isect, r._occl, cam, draws(), 0, r.config))
    return target, draws


def _mesh_one_rank(dev):
    """16c: a one-rank NCCL mesh: the tiled frame through mesh= against the
    plain one (K1 10 launches a frame on the rank), the ReSTIR frame with
    its halo, and one sharded training step with its all-reduce time."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.parallel import shard, train
    from lumenrenderer_tpu_torch.render.renderer import Renderer

    mesh = shard.make_mesh("cuda")
    say("16c mesh", ranks=mesh.size(), backend=dist.get_backend())
    rows, accums = {}, {}
    for label, kw in (("plain", {}), ("mesh", {"mesh": mesh})):
        r, cam = _interior_renderer(dev, "tiled", **kw)
        st = r.render_frame(r.init_state(0), cam)[0]
        vs.reset_launches()

        def one():
            nonlocal st
            st, _ = r.render_frame(st, cam)

        ms = timed_frames(one, SLICE_FRAMES)
        rows[label] = (ms, float(st.accum.mean()))
        accums[label] = st.accum
        per_frame = {k: v / SLICE_FRAMES for k, v in vs.LAUNCHES.items()}
        say("16c mesh", frame=label, size=f"{W}x{H}",
            ms_per_frame=f"{ms:.1f}", mean=f"{rows[label][1]:.6f}",
            k1_launches_per_frame=json.dumps(per_frame))
        if per_frame != {"closest": 5, "any": 5}:
            raise AssertionError(f"16c: K1 launches {per_frame} a frame")
    equal = torch.equal(accums["mesh"], accums["plain"])
    say("16c mesh", accumulators_equal=equal)
    if not equal:
        raise AssertionError(f"16c: a one-rank mesh frame differs from the "
                             f"plain one: {rows}")
    del accums
    cfg = dataclasses.replace(r.config, light_strategy="nee",
                              use_restir=True)
    rr = Renderer(r.scene, cfg, accel="tiled", device=dev, mesh=mesh)
    st = rr.render_frame(rr.init_state(0), cam)[0]

    def one_restir():
        nonlocal st
        st, _ = rr.render_frame(st, cam)

    ms = timed_frames(one_restir, SLICE_FRAMES)
    mean = float(st.accum.mean())
    say("16c mesh restir", size=f"{W}x{H}", halo_rows=min(
        rr._restir_fn.cfg.spatial_radius, H), ms_per_frame=f"{ms:.1f}",
        mean=f"{mean:.6f}", valid=bool(st.restir.valid))
    if not bool(torch.isfinite(st.accum).all()) or mean <= 0:
        raise AssertionError(f"16c: bad ReSTIR mesh frame, mean {mean}")
    del rr, st
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(r.config, remat=True)
    r = Renderer(r.scene, cfg, accel="tiled", device=dev, mesh=mesh)
    cam = cam.to(dev)
    target, draws = _train_setup(r, cam, dev)
    init, step = train.make_sharded_train_step(
        r.scene, r._isect, r._occl, cam, cfg,
        lambda ps: torch.optim.Adam([ps["emissive"]], lr=TRAIN_LR), mesh)
    state = init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(state, draws(), 0, target)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    reduce_ms = cuda_time_ms(lambda: train.all_reduce_grads(state.params,
                                                            mesh))
    say("16c mesh train", size=f"{W}x{H}", remat=True,
        step_ms=f"{step_ms:.1f}", all_reduce_ms=f"{reduce_ms:.4f}",
        loss=f"{float(loss):.6g}")
    if not math.isfinite(float(loss)):
        raise AssertionError("16c: the sharded step's loss is not finite")
    dist.destroy_process_group()
    return rows["plain"][1]


def rank_worker(rank: int, world: int, port: int, out: str) -> int:
    """One rank of 16c's two on one card (`chip_smoke.py --rank-worker`):
    a gloo group (NCCL refuses two ranks on one device), collectives staged
    through the host. Writes its results as JSON to `out`."""
    import dataclasses
    import hashlib

    import torch
    import torch.distributed as dist

    from lumenrenderer_tpu_torch.parallel import shard, train
    from lumenrenderer_tpu_torch.render.renderer import Renderer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    mesh = shard.make_mesh("cuda")
    res = {"rank": rank, "backend": dist.get_backend()}
    r, cam = _interior_renderer(dev, "tiled", mesh=mesh)
    t0 = time.perf_counter()
    img = torch.from_numpy(r.render(cam, spp=MESH_FRAMES))
    res["render_s"] = time.perf_counter() - t0
    seam = img[H // world - 1:H // world + 1]
    res.update(mean=float(img.mean()), finite=bool(torch.isfinite(img).all()),
               seam_row_means=[float(x) for x in seam.mean((1, 2))])
    cfg = dataclasses.replace(r.config, light_strategy="nee",
                              use_restir=True)
    rr = Renderer(r.scene, cfg, accel="tiled", device=dev, mesh=mesh)
    st = rr.init_state(0)
    for _ in range(2):
        st, _ = rr.render_frame(st, cam)
    full = rr.full_frame(st.accum)
    res.update(restir_mean=float(full.mean()),
               restir_finite=bool(torch.isfinite(full).all()))
    del r, rr, st
    torch.cuda.empty_cache()
    rs, cam_s = _interior_renderer(dev, "tiled", w=RANK_TRAIN_W,
                                   h=RANK_TRAIN_H, mesh=mesh)
    cam_s = cam_s.to(dev)
    target, draws = _train_setup(rs, cam_s, dev)
    init, step = train.make_sharded_train_step(
        rs.scene, rs._isect, rs._occl, cam_s, rs.config,
        lambda ps: torch.optim.Adam([ps["emissive"]], lr=TRAIN_LR), mesh)
    state = init()
    state, loss = step(state, draws(), 0, target)
    res.update(loss=float(loss), emissive_sha256=hashlib.sha256(
        state.params["emissive"].detach().cpu().numpy().tobytes()
    ).hexdigest())
    with open(out, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def _mesh_two_ranks(plain_mean_4):
    """16c: two ranks in subprocesses on the one card, 720 rows each."""
    import os
    import tempfile

    from lumenrenderer_tpu_torch.parallel import shard

    port = shard.free_port()
    with tempfile.TemporaryDirectory() as directory:
        outs = [os.path.join(directory, f"rank{i}.json") for i in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--rank-worker",
             str(i), "2", str(port), outs[i]], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in range(2)]
        t0 = time.perf_counter()
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=max(
                    1.0, RANK_TIMEOUT - (time.perf_counter() - t0)))[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            raise AssertionError(f"16c: a rank ran past {RANK_TIMEOUT} s")
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise AssertionError(f"16c: a rank failed:\n{log[-3000:]}")
        res = []
        for path in outs:
            with open(path) as f:
                res.append(json.load(f))
    seconds = time.perf_counter() - t0
    mean = res[0]["mean"]
    rel = abs(mean - plain_mean_4) / plain_mean_4
    seam = res[0]["seam_row_means"]
    say("16c two ranks", ranks=2, backend=res[0]["backend"],
        staging="host (gloo)", rows_per_rank=H // 2,
        wall_s=f"{seconds:.1f}", render_s=f"{res[0]['render_s']:.2f}",
        mean=f"{mean:.6f}", plain_mean=f"{plain_mean_4:.6f}",
        mean_rel_diff=f"{rel:.2e}", seam_row_means=json.dumps(seam),
        restir_mean=f"{res[0]['restir_mean']:.6f}",
        train_loss=f"{res[0]['loss']:.6g}",
        params_equal=res[0]["emissive_sha256"] == res[1]["emissive_sha256"])
    if (not res[0]["finite"] or rel > MEAN_RTOL or min(seam) <= 0
            or not res[0]["restir_finite"] or res[0]["restir_mean"] <= 0
            or res[0]["emissive_sha256"] != res[1]["emissive_sha256"]
            or res[0]["loss"] != res[1]["loss"]):
        raise AssertionError(f"16c: the two-rank run failed its bars: {res}")


def phase_bvh(dev):
    """Phase 16: kernel T against its twin (16a), the BVH frames (16b),
    the mesh on the card (16c). Returns T's rows' inputs."""
    import torch

    torch.cuda.empty_cache()
    sc, camf = _scene(dev)
    cam = camf(W / H).to(dev)
    sah_bvh, lbvh_bvh = _bvh_builds(dev, sc)
    passes = _bvh_passes(dev, sc, cam)
    checks = {"sah": _hold_walks("sah", sah_bvh, passes),
              "lbvh": _hold_walks("lbvh", lbvh_bvh, passes)}
    del passes
    torch.cuda.empty_cache()
    rt, cam = _interior_renderer(dev, "tiled")
    st_t, aux_t = _frames_from(rt, cam, 0, 1)
    for _ in range(SLICE_FRAMES):
        st_t, _ = rt.render_frame(st_t, cam)
    ref = (rt, aux_t, float(st_t.accum.mean()))
    launches = {accel: _bvh_frames(dev, accel, ref)
                for accel in ("sah", "lbvh")}
    del rt, st_t
    plain_mean_4 = _mesh_one_rank(dev)
    _mesh_two_ranks(plain_mean_4)
    return checks, launches


def _bvh_rows(bvh_checks, bvh_launches):
    """The `kernels` line's rows of kernel T: the SAH BVH's and the LBVH's,
    closest and any."""
    rows = []
    for accel in ("sah", "lbvh"):
        for mode in ("closest", "any"):
            c = bvh_checks[accel][mode]
            rows.append({
                "name": f"bvh_traverse[{mode}, {accel}]", "route": "cuda",
                "source": "lumenrenderer_tpu_torch/ops/csrc/bvh_traverse.cu",
                "replaces": REPLACES["bvh_traverse"],
                "launches": bvh_launches[accel][mode],
                **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "full_pass_ms",
                                     "full_pass_bound_ms")},
                "library_ms": None})
    return rows


# -- phase 17: the options (bf16 candidates, dense culling, swizzle, decode,
# the blocked sort) -------------------------------------------------------------

DECODE_RAYS = 65_536         # 17f: evenly spaced rays of the bounce pass
DECODE_UV_TOL = 1e-5         # 17f: u, v against brute where tri agrees,
DECODE_UV_ROUNDINGS = 16     # plus this many float32 roundings (2^-24) of
                             # the two formulas' condition (_uv_condition):
                             # both cancel, the decode's bilinear form in
                             # world coordinates and Moller-Trumbore
OPTION_PAIRS_PER_RAY = 16    # 17b: the bf16 pair frame's pair cap
K2_BF16_SUBSET_TILES = 256   # 17b: K2's tiles held against its exact twin


def _bf16_disagreement(out32, out16, closest, low_bits, live):
    """Share of the live rays whose winner (miss, or visit and slot) or
    occlusion bit differs between the fp32 and the bf16 mode."""
    import torch

    from lumenrenderer_tpu_torch.ops.visit_scan import KEY_MISS

    if closest:
        field = (1 << low_bits) - 1
        out32 = torch.where(out32 < KEY_MISS, out32 & field, -1)
        out16 = torch.where(out16 < KEY_MISS, out16 & field, -1)
    return float((out32 != out16)[live].float().mean())


def _epilogue_ms(flop, per_pair, clock_mhz, ray_visits=0, per_visit=0):
    """The epilogue bound: the live pairs ((flop less K2's AFFINE_FLOP a
    live ray-visit) / FLOP_PER_PAIR) times the instructions a pair on the
    CUDA cores, plus the live ray-visits times K2's instructions a
    ray-visit (both from the SASS), over SMS x LANES lanes at the card's
    clock."""
    pairs = (flop - AFFINE_FLOP * ray_visits) / FLOP_PER_PAIR
    return ((pairs * per_pair + ray_visits * per_visit)
            / (SMS * LANES * clock_mhz * 1e6) * 1e3)


def _hold_bf16(phase, label, passes, subset, kernel, twin, counter, work,
               live_of, low_bits, epilogue=None):
    """Each pass's subset through `kernel` in its bf16 mode and through its
    twin, in both modes: raise unless keys (bits) and, where the kernel
    counts, visit counters (`counter(args, kw)`, which raises) are
    torch.equal. Times the subset (kernel, twin) and the full pass in bf16
    and in fp32 within this call, the bounds from `work(q, args, kw)` ->
    (flop, bytes, fields) at the bf16 tensor-core rate, the peak for these
    operands, and the share of the full pass's live rays
    (`live_of(q)`) whose winner or bit differs from fp32 (not barred).
    `epilogue` ({mode: instructions a pair}, the clock in MHz, and for K2
    {mode: instructions a live ray-visit}, whose count `work` gives as
    its field "ray_visits") adds the epilogue bound and says which bound
    sets the pace. Returns per mode the kernels line's numbers, means over
    the passes."""
    import torch

    results = {}
    for mode, closest in (("closest", True), ("any", False)):
        rows, epi = [], []
        for name, q in passes.items():
            args = subset(q)
            kw = dict(q["kw"], closest=closest, precision="default")
            kw32 = dict(kw, precision="highest")
            kern = kernel(*args, **kw)
            ref = twin(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(kern, ref):
                raise AssertionError(
                    f"{label} bf16 {mode} vs twin on the {name} pass: "
                    f"{int((kern != ref).sum())} of {kern.numel()} differ")
            counted = counter(args, kw)
            ms = cuda_time_ms(lambda: kernel(*args, **kw))
            plain_ms = cuda_time_ms(lambda: twin(*args, **kw), reps=1)
            full16 = cuda_time_ms(lambda: kernel(*q["args"], **kw))
            full32 = cuda_time_ms(lambda: kernel(*q["args"], **kw32))
            flop, nb, sub = work(q, args, kw)
            f_flop, f_nb, extra = work(q, q["args"], kw)
            b_ms, b_by = bound_ms(flop, nb, PEAK_BF16_FLOPS)
            fb_ms, fb_by = bound_ms(f_flop, f_nb, PEAK_BF16_FLOPS)
            share = _bf16_disagreement(
                kernel(*q["args"], **kw32), kernel(*q["args"], **kw),
                closest, low_bits(q), live_of(q))
            fields = {}
            if epilogue is not None:
                per_pair, clock = epilogue[0][mode], epilogue[1]
                per_visit = epilogue[2][mode] if len(epilogue) > 2 else 0
                e_ms = _epilogue_ms(flop, per_pair, clock,
                                    sub.get("ray_visits", 0), per_visit)
                fe_ms = _epilogue_ms(f_flop, per_pair, clock,
                                     extra.get("ray_visits", 0), per_visit)
                epi.append((e_ms, fe_ms))
                fields = dict(
                    design=repr(MMA_DESIGN), epilogue_bound_ms=f"{e_ms:.4f}",
                    epilogue_share=f"{e_ms / ms:.3f}",
                    full_epilogue_bound_ms=f"{fe_ms:.4f}",
                    full_epilogue_share=f"{fe_ms / full16:.3f}",
                    paced_by="epilogue" if fe_ms > fb_ms else fb_by)
            say(phase, kernel=label, precision="bf16", mode=mode, rays=name,
                subset_equal=True, **counted, kernel_ms=f"{ms:.4f}",
                twin_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}",
                bound_by=b_by, share=f"{b_ms / ms:.3f}",
                full_pass_ms=f"{full16:.4f}",
                full_pass_fp32_ms=f"{full32:.4f}", **extra,
                flop=f"{f_flop:.4g}", bytes=f_nb,
                full_pass_bound_ms=f"{fb_ms:.4f}", full_bound_by=fb_by,
                full_share=f"{fb_ms / full16:.3f}", **fields,
                differs_from_fp32=f"{share:.5f}")
            rows.append((ms, plain_ms, b_ms, full16, fb_ms, full32, share,
                         flop, nb))
        mean = [sum(r[i] for r in rows) / len(rows) for i in range(7)]
        results[mode] = {
            "max_abs_err": 0.0, "ms": mean[0], "plain_ms": mean[1],
            "bound_ms": mean[2],
            "bound_by": bound_ms(sum(r[7] for r in rows),
                                 sum(r[8] for r in rows),
                                 PEAK_BF16_FLOPS)[1],
            "full_pass_ms": mean[3], "full_pass_bound_ms": mean[4],
            "fp32_full_pass_ms": mean[5], "differs_from_fp32": mean[6]}
        if epilogue is not None:
            e_ms = sum(e[0] for e in epi) / len(epi)
            fe_ms = sum(e[1] for e in epi) / len(epi)
            results[mode].update({
                "design": MMA_DESIGN, "epilogue_bound_ms": e_ms,
                "epilogue_share": e_ms / mean[0],
                "full_pass_epilogue_bound_ms": fe_ms,
                "epilogue_instructions_per_pair": epilogue[0][mode],
                **({"instructions_per_ray_visit": epilogue[2][mode]}
                   if len(epilogue) > 2 else {}),
                "paced_by": ("epilogue" if fe_ms > mean[4]
                             else results[mode]["bound_by"])})
    return results


def _visits_equal(kernel, replay, args, kw):
    """The kernel's visit counter against its twin's replay: raise unless
    equal; returns the fields to print."""
    import torch

    visits = torch.empty(args[0].shape[0], dtype=torch.int32,
                         device=args[0].device)
    kernel(*args, **kw, visits=visits)
    ref = replay(*args, **{k: v for k, v in kw.items() if k != "layout"})
    if not torch.equal(visits, ref):
        raise AssertionError(f"bf16 visit counter differs from its replay on "
                             f"{int((visits != ref).sum())} tiles")
    return {"counter_equal": True,
            "subset_visits_per_tile": f"{float(visits.float().mean()):.3f}"}


def _with_layouts(fn, fp32_layout, feats, k):
    """fn with the table's kernel layout of each precision, made once (the
    bf16 one in fragment order)."""
    from lumenrenderer_tpu_torch.ops import visit_scan as vs

    layouts = {"highest": fp32_layout, "default": vs.mma_layout(feats, k)}
    return lambda *a, **kw: fn(*a, **kw, layout=layouts[kw["precision"]])


def _bra_target(text):
    """The target address of a SASS branch, else None."""
    m = re.match(r"(?:@!?U?P\w+\s+)?BRA(?:\.\S+)?\s+(?:`\()?0x([0-9a-f]+)",
                 text)
    return int(m.group(1), 16) if m else None


def _sass_functions(lib):
    """Per function of a built library, its SASS instructions [(address,
    text)], from cuobjdump."""
    from lumenrenderer_tpu_torch.ops import build

    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def _loop_around(instrs, first, last):
    """(head, end) of the innermost loop around the addresses first ...
    last: the nearest backward branch after them whose target is at or
    before first, and that target."""
    end, head = min((a, tgt) for a, t in instrs
                    for tgt in [_bra_target(t)]
                    if tgt is not None and a > last and tgt <= first)
    return head, end


def _loop_pass(instrs, head, end, skip=None):
    """(HMMAs, instructions) of one pass from head to the backward branch
    at end, every forward branch inside the loop taken (on the kernels'
    no-hit path they skip a pair's window test once an earlier test
    failed, the work of a hit, and thread 0's bulk copies) and backward
    ones not; the addresses of `skip` (head, end), an inner loop, jumped
    over."""
    index = {a: i for i, (a, _) in enumerate(instrs)}
    i, count, n_hmma = index[head], 0, 0
    while True:
        a, t = instrs[i]
        if skip is not None and skip[0] <= a <= skip[1]:
            i = index[skip[1]] + 1
            continue
        count += 1
        n_hmma += t.startswith("HMMA")
        tgt = _bra_target(t)
        if a == end:
            return n_hmma, count
        i = index[tgt] if tgt is not None and a < tgt <= end else i + 1


def mma_loop_count(instrs):
    """(HMMAs, instructions) of one pass through the loop around a
    kernel's HMMAs on its no-hit path (`_loop_pass`)."""
    hmma = [a for a, t in instrs if t.startswith("HMMA")]
    if not hmma:
        return 0, 0
    return _loop_pass(instrs, *_loop_around(instrs, hmma[0], hmma[-1]))


def mma_visit_count(instrs):
    """Instructions of one pass through the visit loop around the loop of
    a kernel's HMMAs, that loop left out, on the path of a thread that
    issues no bulk copy (`_loop_pass`): the vote, the wait and, in K2, the
    A fragments formed, traded and rounded."""
    hmma = [a for a, t in instrs if t.startswith("HMMA")]
    inner = _loop_around(instrs, hmma[0], hmma[-1])
    return _loop_pass(instrs, *_loop_around(instrs, *inner), skip=inner)[1]


def _options_tensor_cores(dev):
    """17h: the tensor cores. The probe (ops/mma_probe.py): one m16n8k16 per
    case on crafted sums, each result against the candidate models bit for
    bit; raise unless the bf16 twins' model (MMA_MODEL) fits every sum of
    the kernels' kind. Then the SASS of the bf16 kernels of K1, K2 and K3:
    raise unless their loops run HMMA; each loop's instructions on the
    no-hit path, less its HMMAs, over the lane's 4 pairs, are the
    epilogue's instructions a pair; K2's visit loop's other instructions
    (the vote, the wait, the A fragments formed and traded) are its
    instructions a ray and visit (a block's 128 lanes for its 128 rays).
    Returns ({kernel: {mode: instructions a pair}}, {mode: K2's
    instructions a ray-visit}, the clock in MHz)."""
    from lumenrenderer_tpu_torch.ops import build
    from lumenrenderer_tpu_torch.ops import mma_probe as mp
    from lumenrenderer_tpu_torch.ops.visit_scan import MMA_MODEL

    out = mp.run_probe(dev)
    fams = list(next(iter(out["table"].values())))
    ranked = sorted(out["table"].items(), key=lambda kv: sum(
        v[0] for f, v in kv[1].items() if f in mp.KERNEL_FAMILIES))
    say("17h probe", families=",".join(fams),
        sums_per_family=mp.CASES_PER_FAMILY * 128,
        columns="value mismatches/zero-sign mismatches")
    for name, row in ranked[:6] + [kv for kv in ranked
                                   if kv[0] in ("chain", "exact-rn")]:
        say("17h probe", model=name,
            mismatches=" ".join(f"{row[f][0]}/{row[f][1]}" for f in fams))
    say("17h probe", fits=json.dumps(out["fits"]),
        twins_model=mp.model_name(MMA_MODEL),
        pinned=json.dumps(out["pinned"]))
    if mp.model_name(MMA_MODEL) not in out["fits"]:
        raise AssertionError("17h: the twins' tensor-core model does not fit "
                             "the card")
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    per_pair, per_visit = {}, {}
    for name in ("visit_scan", "visit_scan_instanced", "pair_scan"):
        funcs = _sass_functions(build.library_path(name))
        for mode in ("closest", "any"):
            (fname, instrs), = [(f, i) for f, i in funcs.items()
                                if MMA_ENTRIES[name, mode] in f]
            n_hmma, count = mma_loop_count(instrs)
            total = sum(t.startswith("HMMA") for _, t in instrs)
            if n_hmma == 0:
                raise AssertionError(f"17h: no HMMA in {fname}'s loop")
            per = (count - n_hmma) / MMA_PAIRS_PER_LANE
            per_pair.setdefault(name, {})[mode] = per
            visit = {}
            if name == "visit_scan_instanced":
                per_visit[mode] = mma_visit_count(instrs)
                visit = {"instructions_per_ray_visit": per_visit[mode]}
            say("17h sass", kernel=name, mode=mode, k=128,
                hmma_in_function=total, hmma_in_loop=n_hmma,
                loop_instructions=count,
                epilogue_instructions_per_pair=per, **visit,
                clock_max_mhz=clock)
    return per_pair, per_visit, clock


def _options_k1(dev, epilogue, w=W, h=H, n_tiles=SUBSET_TILES):
    """17a: K1's bf16 mode (the tensor cores) against its twin on the
    primary, sorted bounce and shadow passes of the interior; `epilogue`:
    (its instructions a pair per mode, the clock in MHz)."""
    import torch

    from lumenrenderer_tpu_torch.accel import stream, tiled
    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.render.renderer import KERNEL_VISIT_CAP

    sc, camf = _scene(dev)
    cs = stream.build_clusters(sc.tri_pos, cluster_size=128).to(dev)
    mv = min(cs.num_clusters, KERNEL_VISIT_CAP)
    passes = _secondary_passes(
        sc, cs, camf(w / h).to(dev), dev, w, h,
        lambda o, d, tn, tx: tiled.scan_inputs(cs, o, d, tn, tx, mv),
        primary=True)
    kernel = _with_layouts(vs.visit_scan, (cs.slabs, cs.nlive), cs.tri_feat,
                           128)
    live_tris = vs.slab_layout(cs.tri_feat, 128, bf16=True)[1].double()

    def work(q, args, kw):
        rf_t, feats, sel, nv, tnb = args
        visits = torch.empty(rf_t.shape[0], dtype=torch.int32, device=dev)
        kernel(*args, **kw, visits=visits)
        live_rays = (rf_t[..., 11] >= rf_t[..., 10]).sum(1)
        flop = visit_flop(live_rays, live_tris, sel, visits)
        # the bf16 table at 2 bytes a value
        nb = (_nbytes(rf_t, sel, nv, tnb) + feats.numel() * 2
              + rf_t.shape[0] * 128 * 4)
        return flop, nb, {
            "visits_per_tile": f"{float(visits.float().mean()):.3f}"}

    return _hold_bf16(
        "17a bf16 K1", "visit_scan", passes,
        lambda q: _tile_subset(q["args"], 1, n_tiles), kernel,
        vs.visit_scan_ref,
        lambda args, kw: _visits_equal(kernel, vs.executed_visits_ref, args,
                                       kw),
        work, lambda q: q["args"][0][..., 11] >= q["args"][0][..., 10],
        lambda q: q["kw"]["low_bits"], epilogue)


def _options_k2(dev, epilogue, w=W, h=H, n_tiles=K2_BF16_SUBSET_TILES):
    """17b: K2's bf16 mode (the tensor cores) against its twin on the
    instanced scene's passes, then the two-level bf16 frame (K2's bf16
    launches); `epilogue`: (its instructions a pair per mode, the clock in
    MHz, its instructions a ray-visit per mode)."""
    import torch

    from lumenrenderer_tpu_torch.accel import stream, two_level
    from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.ops import visit_scan_instanced as vsi
    from lumenrenderer_tpu_torch.render.renderer import (KERNEL_VISIT_CAP,
                                                         Renderer)

    builder, camf = _instanced()
    sc = builder.build().to(dev)
    cs = stream.build_clusters(sc.tri_pos, cluster_size=128).to(dev)
    ics = two_level.build_instanced(
        *two_level.instance_tables(builder.instances)).to(dev)
    mv = min(ics.num_clusters, KERNEL_VISIT_CAP)
    passes = _secondary_passes(
        sc, cs, camf(w / h).to(dev), dev, w, h,
        lambda o, d, tn, tx: two_level.scan_inputs(ics, o, d, tn, tx, mv),
        primary=True)
    kernel = _with_layouts(vsi.visit_scan_instanced, (ics.slabs, ics.nlive),
                           ics.tri_feat, ics.tri_id.shape[1])
    live_tris = vs.slab_layout(ics.tri_feat, ics.tri_id.shape[1],
                               bf16=True)[1].double()

    def work(q, args, kw):
        rayblk, wnd, feats, sel_cl, _, nv, _ = args
        tiles = rayblk.shape[0]
        visits = torch.empty(tiles, dtype=torch.int32, device=dev)
        kernel(*args, **kw, visits=visits)
        live_rays = (wnd[..., 1] >= wnd[..., 0]).sum(1)
        ray_visits = float((live_rays * visits).sum())
        flop = (visit_flop(live_rays, live_tris, sel_cl, visits)
                + AFFINE_FLOP * ray_visits)
        nb = (_nbytes(rayblk[:, :6], wnd, nv) + feats.numel() * 2
              + int(visits.sum()) * 56 + tiles * (128 + 1) * 4)
        return flop, nb, {
            "visits_per_tile": f"{float(visits.float().mean()):.3f}",
            "ray_visits": ray_visits}

    checks = _hold_bf16(
        "17b bf16 K2", "visit_scan_instanced", passes,
        lambda q: _tile_subset(q["args"], 2, n_tiles), kernel,
        vsi.visit_scan_instanced_ref,
        lambda args, kw: _visits_equal(
            kernel, vsi.executed_visits_instanced_ref, args, kw),
        work, lambda q: q["args"][1][..., 1] >= q["args"][1][..., 0],
        lambda q: q["kw"]["low_bits"], epilogue)
    del passes
    cfg = RenderConfig(width=w, height=h, max_depth=5, bsdf="disney",
                       light_strategy="mis")
    cam = camf(w / h)
    r = Renderer(builder.build(), cfg, accel="two_level", builder=builder,
                 device=dev, candidate_dtype="bfloat16")
    vsi.reset_launches()
    ms, warm_ms, st, overflow = _frames(r, cam, SLICE_FRAMES)
    launches = dict(vsi.LAUNCHES_BF16)
    mean = float(st.accum.mean())
    finite = bool(torch.isfinite(st.accum).all())
    say("17b two-level bf16", size=f"{w}x{h}", units=ics.num_clusters,
        warmup_ms=f"{warm_ms:.1f}", ms_per_frame=f"{ms:.1f}",
        k2_bf16_launches=json.dumps(launches),
        k2_fp32_launches=json.dumps(vsi.LAUNCHES), mean=f"{mean:.6f}",
        finite=finite, overflow=overflow)
    per = SLICE_FRAMES + 1
    if (not finite or mean <= 0 or vsi.LAUNCHES != {"closest": 0, "any": 0}
            or launches != {"closest": 5 * per, "any": 5 * per}):
        raise AssertionError(f"17b: bad two-level bf16 frame: {launches}")
    return checks, launches


def _options_k3(dev, epilogue, w=W, h=H, n_tiles=SUBSET_TILES):
    """17b: K3's bf16 mode (the tensor cores) against its twin on the
    interior's pair tiles, then one bf16 pair frame (K3's bf16 launches);
    `epilogue` as for `_options_k1`."""
    import torch

    from lumenrenderer_tpu_torch.accel import pairs, stream
    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.integrator import wavefront as wf
    from lumenrenderer_tpu_torch.ops import pair_scan as ps
    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.render.renderer import KERNEL_VISIT_CAP

    sc, camf = _scene(dev)
    cs = stream.build_clusters(sc.tri_pos, cluster_size=128).to(dev)
    mv = min(cs.num_clusters, KERNEL_VISIT_CAP)
    passes = _secondary_passes(
        sc, cs, camf(w / h).to(dev), dev, w, h,
        lambda o, d, tn, tx: pairs.scan_inputs(cs, o, d, tn, tx, mv,
                                               PAIRS_PER_RAY),
        primary=True)

    def subset(q):
        rf_pairs, feats, tile_cluster = q["args"]
        rf = rf_pairs.reshape(-1, 128, 12)
        live = (rf[..., 11] >= rf[..., 10]).any(1).nonzero()[:, 0]
        idx = live[torch.linspace(0, live.numel() - 1, n_tiles,
                                  device=dev).long()]
        return (rf[idx].reshape(-1, 12).contiguous(), feats,
                tile_cluster[idx].contiguous())

    kernel = _with_layouts(ps.pair_scan, (cs.slabs, cs.nlive), cs.tri_feat,
                           128)
    live_tris = vs.slab_layout(cs.tri_feat, 128, bf16=True)[1].double()

    def work(q, args, kw):
        rf_pairs, feats, tile_cluster = args
        rf = rf_pairs.reshape(-1, 128, 12)
        live = (rf[..., 11] >= rf[..., 10]).sum(1)
        n_live = int((live > 0).sum())
        flop = FLOP_PER_PAIR * float(
            (live.double() * live_tris[tile_cluster.long()]).sum())
        nb = (n_live * (128 * 12 + 1) * 4
              + (rf.shape[0] - n_live) * 128 * 2 * 4
              + rf.shape[0] * 128 * 4 + feats.numel() * 2)
        return flop, nb, {"live_pair_tiles": n_live}

    checks = _hold_bf16(
        "17b bf16 K3", "pair_scan", passes, subset, kernel, ps.pair_scan_ref,
        lambda args, kw: {}, work,
        lambda q: q["args"][0][:, 11] >= q["args"][0][:, 10],
        lambda q: q["kw"]["k_bits"], epilogue)
    del passes
    cfg = wf.RenderConfig(width=w, height=h, max_depth=5, bsdf="disney",
                          light_strategy="mis")
    isect, occl = pairs.pair_intersectors(
        cs, max_visits=mv, max_pairs_per_ray=OPTION_PAIRS_PER_RAY,
        decode=False, precision="default")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ps.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = wf.render_wavefront(sc, isect, occl, camf(w / h).to(dev),
                                  sampling.generator_uniforms(gen), 0, cfg)
    img = wf.merge_channels(out)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(ps.LAUNCHES_BF16)
    finite = bool(torch.isfinite(img).all())
    say("17b pair bf16", size=f"{w}x{h}", max_pairs_per_ray=
        OPTION_PAIRS_PER_RAY, frame_ms=f"{ms:.1f}",
        k3_bf16_launches=json.dumps(launches),
        k3_fp32_launches=json.dumps(ps.LAUNCHES),
        mean=f"{float(img.mean()):.6f}", finite=finite,
        overflow=bool(out["overflow"]))
    if (not finite or launches != {"closest": 5, "any": 5}
            or ps.LAUNCHES != {"closest": 0, "any": 0}):
        raise AssertionError(f"17b: bad bf16 pair frame: {launches}")
    return checks, launches


def _option_frames(phase, r, cam, frames=SLICE_FRAMES):
    """A warm-up frame and `frames` timed ones from init_state(0): (ms per
    frame, warm-up ms, state, the last frame's AOVs, overflow, peak GiB)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    st, aux = r.render_frame(r.init_state(0), cam)
    warm_ms = r.frame_stats["Total Frame Time"]
    run = {"st": st, "aux": aux, "overflow": r.frame_stats["overflow"]}

    def one():
        run["st"], run["aux"] = r.render_frame(run["st"], cam)
        run["overflow"] |= r.frame_stats["overflow"]

    ms = timed_frames(one, frames)
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(torch.isfinite(run["st"].accum).all())
    if not finite or float(run["st"].accum.mean()) <= 0:
        raise AssertionError(f"{phase}: bad frame")
    return ms, warm_ms, run["st"], run["aux"], run["overflow"], peak


def _primary_visits(r, cam, w, h, perm=None):
    """K1's executed visits per tile on the frame's primary pass (rays in
    `perm` order when given) and the mean admitted clusters per tile."""
    import torch

    from lumenrenderer_tpu_torch.accel import tiled
    from lumenrenderer_tpu_torch.core import sampling
    from lumenrenderer_tpu_torch.core.camera import generate_primary_rays
    from lumenrenderer_tpu_torch.ops import visit_scan as vs

    gen = torch.Generator(device=r.device)
    gen.manual_seed(3)
    ids = None if perm is None else torch.from_numpy(perm).to(r.device)
    o, d = generate_primary_rays(cam.to(r.device), w, h, 0,
                                 sampling.generator_uniforms(gen), "random",
                                 pixel_ids=ids)
    q = tiled.scan_inputs(r.clusters, o, d, 1e-3, 1e9, r.max_visits,
                          r.culling)
    visits = torch.empty(q["args"][0].shape[0], dtype=torch.int32,
                         device=r.device)
    vs.visit_scan(*q["args"], **q["kw"], closest=True, layout=q["layout"],
                  visits=visits)
    return float(visits.float().mean()), float(q["args"][3].float().mean())


def _options_frames(dev, w=W, h=H):
    """17c-e: the interior through Renderer(accel="tiled") with
    candidate_dtype="bfloat16", culling="dense" and swizzle=True, each
    beside the default frame of the same seed. Returns K1's bf16
    launches of 17c's frames."""
    import dataclasses

    import torch

    from lumenrenderer_tpu_torch.core.camera import block_swizzle_map
    from lumenrenderer_tpu_torch.ops import visit_scan as vs

    base, cam = _interior_renderer(dev, "tiled", w, h)
    ms0, _, st0, aux0, _, peak0 = _option_frames("17 default", base, cam)
    mean0 = float(st0.accum.mean())
    low_bits = _key_low_bits(base.clusters.num_clusters, 128,
                             base.max_visits)
    say("17 default", size=f"{w}x{h}", ms_per_frame=f"{ms0:.1f}",
        peak_mem_gib=f"{peak0:.2f}", mean=f"{mean0:.6f}")

    # 17c: bf16 candidates (K1's bf16 mode on the main path)
    r, cam = _interior_renderer(dev, "tiled", w, h,
                                candidate_dtype="bfloat16")
    vs.reset_launches()
    ms, warm, st, aux, ovf, peak = _option_frames("17c bf16", r, cam)
    launches = dict(vs.LAUNCHES_BF16)
    per = {k: v / (SLICE_FRAMES + 1) for k, v in launches.items()}
    strict, _ = _aov_agreement(aux, aux0, low_bits)
    say("17c bf16", size=f"{w}x{h}", warmup_ms=f"{warm:.1f}",
        ms_per_frame=f"{ms:.1f}", fp32_ms_per_frame=f"{ms0:.1f}",
        peak_mem_gib=f"{peak:.2f}", k1_bf16_launches=json.dumps(launches),
        k1_bf16_launches_per_frame=json.dumps(per),
        k1_fp32_launches=json.dumps(vs.LAUNCHES),
        mean=f"{float(st.accum.mean()):.6f}", fp32_mean=f"{mean0:.6f}",
        aov_pixels_agree_with_fp32=f"{strict:.6f}", overflow=ovf)
    if (per != {"closest": 5, "any": 5}
            or vs.LAUNCHES != {"closest": 0, "any": 0}):
        raise AssertionError(f"17c: K1 bf16 launches per frame {per}")
    del r, st, aux
    torch.cuda.empty_cache()

    # 17d: dense culling, uncapped (max_visits = C)
    r, cam = _interior_renderer(dev, "tiled", w, h, culling="dense")
    ms, warm, st, aux, ovf, peak = _option_frames("17d dense", r, cam)
    dense_v, dense_adm = _primary_visits(r, cam, w, h)
    base_v, base_adm = _primary_visits(base, cam, w, h)
    say("17d dense", size=f"{w}x{h}", clusters=r.clusters.num_clusters,
        max_visits=r.max_visits, warmup_ms=f"{warm:.1f}",
        ms_per_frame=f"{ms:.1f}", frustum_ms_per_frame=f"{ms0:.1f}",
        peak_mem_gib=f"{peak:.2f}", frustum_peak_mem_gib=f"{peak0:.2f}",
        admitted_per_tile=f"{dense_adm:.3f}",
        frustum_admitted_per_tile=f"{base_adm:.3f}",
        visits_run_per_tile=f"{dense_v:.3f}",
        frustum_visits_run_per_tile=f"{base_v:.3f}", overflow=ovf)
    if ovf:
        raise AssertionError("17d: dense lists overflowed at max_visits = C")
    _hold_frames("17d dense", "the frustum frame", aux, aux0,
                 float(st.accum.mean()), mean0, low_bits)
    del r, st, aux
    torch.cuda.empty_cache()

    # 17e: swizzle; a slot draws what the row-major pixel of its index
    # draws, so the primary AOVs are held on a frame of pixel centres
    r, cam = _interior_renderer(dev, "tiled", w, h)
    r.config = dataclasses.replace(r.config, swizzle=True)
    ms, warm, st, aux, ovf, peak = _option_frames("17e swizzle", r, cam)
    perm, _ = block_swizzle_map(w, h)
    swz_v, swz_adm = _primary_visits(r, cam, w, h, perm)
    say("17e swizzle", size=f"{w}x{h}", warmup_ms=f"{warm:.1f}",
        ms_per_frame=f"{ms:.1f}", row_major_ms_per_frame=f"{ms0:.1f}",
        primary_visits_run_per_tile=f"{swz_v:.3f}",
        row_major_primary_visits_run_per_tile=f"{base_v:.3f}",
        primary_admitted_per_tile=f"{swz_adm:.3f}",
        row_major_primary_admitted_per_tile=f"{base_adm:.3f}",
        overflow=ovf)
    mean = float(st.accum.mean())
    rel = abs(mean - mean0) / mean0
    say("17e swizzle", mean=f"{mean:.6f}", row_major_mean=f"{mean0:.6f}",
        mean_rel_diff=f"{rel:.2e}")
    if rel > MEAN_RTOL:
        raise AssertionError(f"17e: swizzled mean {mean} vs {mean0}")
    centred = []
    for swizzle in (True, False):
        r.config = dataclasses.replace(r.config, swizzle=swizzle,
                                       jitter="center")
        st_c, aux_c = r.render_frame(r.init_state(0), cam)
        centred.append((aux_c, float(st_c.accum.mean())))
    _hold_frames("17e swizzle", "the row-major frame (pixel centres)",
                 centred[0][0], centred[1][0], centred[0][1], centred[1][1],
                 low_bits, hold_mean=False)
    return launches


def _raw_passes(dev, sc, cs, cam, w, h):
    """The interior's bounce and shadow passes, unsorted: {name: (o, d, tn,
    tx)}."""
    import torch

    def keep(o, d, tn, tx):
        r = o.shape[0]
        return {"rays": (o, d, torch.as_tensor(tn, device=dev).expand(r),
                         torch.as_tensor(tx, device=dev).expand(r)),
                "overflow": torch.tensor(False, device=dev)}

    passes = _secondary_passes(sc, cs, cam, dev, w, h, keep,
                               sort=lambda i, o, lo, hi: (i, o))
    return {k: v["rays"] for k, v in passes.items()}


def _uv_condition(sc, cs, o, d, tri, uv):
    """(r, 2) condition of u and v on rays o, d whose triangle is `tri`,
    `uv` their (r, 2) values: for the decode's bilinear form and for
    Moller-Trumbore each, the sum of its terms' magnitudes over |det|
    (the numerator's, and |value| times det's), summed over the two. An
    error of n roundings of each term is at most n 2^-24 times this."""
    import torch

    from lumenrenderer_tpu_torch.accel import stream

    c, k = cs.num_clusters, cs.tris_per_cluster
    ids = cs.tri_id.reshape(-1).long()
    at = torch.full((sc.tri_pos.shape[0],), -1, dtype=torch.long,
                    device=ids.device)
    at[ids[ids >= 0]] = torch.arange(ids.numel(), device=ids.device)[ids >= 0]
    pos = at[tri.long()]
    cols = cs.tri_feat.reshape(c, 10, 4, k)[pos // k, :, :, pos % k]
    terms = stream.ray_features(o, d).double()[:, :, None] * cols.double()
    mag, det = terms.abs().sum(1), terms.sum(1)[:, 0].abs()
    uv = uv.double().abs()
    cond = (mag[:, 1:3] + uv * mag[:, :1]) / det[:, None]
    v0, v1, v2 = (sc.tri_pos[tri.long(), i].double() for i in range(3))
    o, d = o.double(), d.double()
    e1, e2, sv = v1 - v0, v2 - v0, o - v0

    def cross_abs(a, b):                 # |a_y b_z| + |a_z b_y|, ...
        a, b = a.abs(), b.abs()
        return torch.stack([a[:, 1] * b[:, 2] + a[:, 2] * b[:, 1],
                            a[:, 2] * b[:, 0] + a[:, 0] * b[:, 2],
                            a[:, 0] * b[:, 1] + a[:, 1] * b[:, 0]], -1)

    def dot_abs(a, b, b_abs):            # |a| . (|b| + b's own terms)
        return (a.abs() * (b.abs() + b_abs)).sum(-1)

    p, q = torch.cross(d, e2, dim=-1), torch.cross(sv, e1, dim=-1)
    det_mt = (e1 * p).sum(-1).abs()
    det_abs = dot_abs(e1, p, cross_abs(d, e2))
    num = torch.stack([dot_abs(sv, p, cross_abs(d, e2)),
                       dot_abs(d, q, cross_abs(sv, e1))], -1)
    return cond + (num + uv * det_abs[:, None]) / det_mt[:, None]


def _options_decode(dev, raw, cs, sc):
    """17f: decode=True on the sorted bounce pass: its extra ms, and t, u,
    v against brute on DECODE_RAYS rays."""
    import torch

    from lumenrenderer_tpu_torch.accel import brute, sorting, tiled
    from lumenrenderer_tpu_torch.render.renderer import KERNEL_VISIT_CAP

    mv = min(cs.num_clusters, KERNEL_VISIT_CAP)
    pts = sc.tri_pos.reshape(-1, 3)
    calls = {}
    for decode in (False, True):
        isect, _ = tiled.tiled_intersectors(cs, mv, decode=decode)
        calls[decode] = sorting.sorted_intersectors(
            isect, None, pts.amin(0), pts.amax(0))[0]
    o, d, tn, tx = raw["bounce"]
    ms = {k: cuda_time_ms(lambda: fn(o, d, tn, tx), reps=3)
          for k, fn in calls.items()}
    key = calls[False](o, d, tn, tx)
    dec = calls[True](o, d, tn, tx)
    idx = torch.linspace(0, o.shape[0] - 1, DECODE_RAYS, device=dev).long()
    ref = brute.intersect_closest(sc.tri_pos, o[idx], d[idx], tn[idx],
                                  tx[idx])
    low_bits = _key_low_bits(cs.num_clusters, 128, mv)
    hit = dec["tri"][idx] >= 0
    same = hit & (dec["tri"][idx] == ref["tri"])
    t_key, t_dec = key["t"][idx], dec["t"][idx]
    t_ok = ((t_dec - t_key).abs() <= t_dec * 2.0 ** -(23 - low_bits))[hit]
    got_uv = torch.stack([dec["u"][idx], dec["v"][idx]], -1)[same]
    uv = (got_uv - torch.stack([ref["u"], ref["v"]], -1)[same]).abs()
    tol = DECODE_UV_TOL + DECODE_UV_ROUNDINGS * 2.0 ** -24 * _uv_condition(
        sc, cs, o[idx][same], d[idx][same], ref["tri"][same], got_uv)
    tri_agree = float((dec["tri"][idx] == ref["tri"]).float().mean())
    uv_ok = bool((uv <= tol).all())
    say("17f decode", rays=o.shape[0], decode_ms=f"{ms[True]:.3f}",
        key_only_ms=f"{ms[False]:.3f}",
        extra_ms=f"{ms[True] - ms[False]:.3f}", subset=DECODE_RAYS,
        hits=int(hit.sum()), tri_agree_with_brute=f"{tri_agree:.6f}",
        t_within_key=f"{float(t_ok.float().mean()):.6f}",
        uv_max_err_same_tri=f"{float(uv.max()):.3g}",
        uv_within_1e5=f"{float((uv <= DECODE_UV_TOL).float().mean()):.6f}",
        uv_max_err_over_tol=f"{float((uv / tol).max()):.3g}",
        t_max_rel_err_same_tri=f"""{float(((t_dec - ref['t']).abs()
                                         / ref['t'])[same].max()):.3g}""")
    if (not bool(t_ok.all()) or not uv_ok
            or int(same.sum()) < 0.99 * int(hit.sum())):
        raise AssertionError("17f: the exact decode disagrees with brute")


def _options_blocked(dev, raw, cs, sc):
    """17g: one bounce and one shadow pass through
    `blocked_sorted_intersectors` beside `sorted_intersectors`: time and
    K1's visits per tile."""
    import torch

    from lumenrenderer_tpu_torch.accel import sorting, tiled
    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.render.renderer import KERNEL_VISIT_CAP

    mv = min(cs.num_clusters, KERNEL_VISIT_CAP)
    pts = sc.tri_pos.reshape(-1, 3)
    isect, occl = tiled.tiled_intersectors(cs, mv, decode=False)
    seen = {}

    def counted(closest):
        def fn(o, d, tn, tx):
            q = tiled.scan_inputs(cs, o, d, tn, tx, mv)
            visits = torch.empty(q["args"][0].shape[0], dtype=torch.int32,
                                 device=dev)
            vs.visit_scan(*q["args"], **q["kw"], closest=closest,
                          layout=q["layout"], visits=visits)
            seen["visits"] = float(visits.float().mean())
            seen["admitted"] = float(q["args"][3].float().mean())
            n = o.shape[0]
            return ({"tri": torch.zeros(n, device=dev),
                     "overflow": q["overflow"]} if closest
                    else torch.zeros(n, dtype=torch.bool, device=dev))
        return fn

    for label, wrap in (("global sort", sorting.sorted_intersectors),
                        ("block partition",
                         sorting.blocked_sorted_intersectors)):
        timed = wrap(isect, occl, pts.amin(0), pts.amax(0))
        spies = wrap(counted(True), counted(False), pts.amin(0), pts.amax(0))
        for i, name in ((0, "bounce"), (1, "shadow")):
            rays = raw[name]
            ms = cuda_time_ms(lambda: timed[i](*rays), reps=3)
            spies[i](*rays)
            say("17g sort", wrapper=label, rays=name, pass_ms=f"{ms:.3f}",
                visits_run_per_tile=f"{seen['visits']:.3f}",
                admitted_per_tile=f"{seen['admitted']:.3f}")


def phase_options(dev, w=W, h=H):
    """Phase 17: returns the bf16 rows' checks and launches per kernel."""
    import torch

    from lumenrenderer_tpu_torch.accel import stream

    per_pair, per_visit, clock = _options_tensor_cores(dev)
    checks = {"visit_scan": _options_k1(
        dev, (per_pair["visit_scan"], clock), w, h)}
    torch.cuda.empty_cache()
    checks["visit_scan_instanced"], k2_launches = _options_k2(
        dev, (per_pair["visit_scan_instanced"], clock, per_visit), w, h)
    torch.cuda.empty_cache()
    checks["pair_scan"], k3_launches = _options_k3(
        dev, (per_pair["pair_scan"], clock), w, h)
    torch.cuda.empty_cache()
    launches = {"visit_scan": _options_frames(dev, w, h),
                "visit_scan_instanced": k2_launches,
                "pair_scan": k3_launches}
    torch.cuda.empty_cache()
    sc, camf = _scene(dev)
    cs = stream.build_clusters(sc.tri_pos, cluster_size=128).to(dev)
    raw = _raw_passes(dev, sc, cs, camf(w / h).to(dev), w, h)
    _options_decode(dev, raw, cs, sc)
    _options_blocked(dev, raw, cs, sc)
    return checks, launches


def main(argv=None) -> int:
    """No arguments: every phase. `--rank-worker RANK WORLD PORT OUT`: one
    rank of phase 16c's two."""
    argv = sys.argv[1:] if argv is None else argv
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
    if argv[:1] == ["--rank-worker"]:
        rank, world, port = (int(x) for x in argv[1:4])
        return rank_worker(rank, world, port, argv[4])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        say(name, seconds=f"{time.perf_counter() - t0:.1f}")
        return out

    run("1 environment", phase_environment)
    run("2 build", phase_build)
    checks = {"visit_scan": run("3 kernel", phase_kernel_vs_twin, dev)}
    run("4 small slice", phase_small_slice, dev)
    run("4b small restir", phase_small_restir, dev)
    launches = {"visit_scan": run("5 full slice", phase_full_slice, dev)}
    checks["visit_scan_instanced"] = run(
        "6 instanced kernel", phase_instanced_kernel_vs_twin, dev)
    launches["visit_scan_instanced"] = run(
        "7 two-level slice", phase_two_level_slice, dev)
    checks["pair_scan"] = run("8 pair kernel", phase_pair_kernel_vs_twin,
                              dev)
    launches["pair_scan"] = run("9 pair slice", phase_pair_slice, dev)
    run("10 restir slice", phase_restir_slice, dev)
    mega = run("11 mega slice", phase_mega, dev)
    run("11b two-level units", phase_units_past_2048, dev)
    run("12 gradients", phase_gradients, dev)
    textured = run("13 textured", phase_textured, dev)
    volume = run("14 volumes", phase_volumes, dev)
    app = run("15 application", phase_app, dev)
    bvh_checks, bvh_launches = run("16 bvh and mesh", phase_bvh, dev)
    bf16_checks, bf16_launches = run("17 options", phase_options, dev)

    kernels = []
    for name in KERNELS[:3]:
        for mode in ("closest", "any"):
            c = checks[name][mode]
            kernels.append({
                "name": f"{name}[{mode}]", "route": "cuda",
                "source": f"lumenrenderer_tpu_torch/ops/csrc/{name}.cu",
                "replaces": REPLACES[name],
                "launches": launches[name][mode],
                "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": None,
                "full_pass_ms": c["full_pass_ms"],
                "full_pass_bound_ms": c["full_pass_bound_ms"],
                **({"visits_per_tile": c["visits_per_tile"]}
                   if "visits_per_tile" in c else {}),
                **({"launches_textured": textured[mode],
                    "launches_volume": volume[mode],
                    "launches_app": app[mode]}
                   if name == "visit_scan" else {})})
    for mode in ("closest", "any"):
        c = mega["k1"][mode]
        kernels.append({
            "name": f"visit_scan[{mode}, mega]", "route": "cuda",
            "source": "lumenrenderer_tpu_torch/ops/csrc/visit_scan.cu",
            "replaces": REPLACES["visit_scan"],
            "launches": mega["launches"][mode],
            **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "full_pass_ms",
                                 "full_pass_bound_ms")},
            "library_ms": None})
    w_ = mega["walk"]
    kernels.append({
        "name": "tree_walk", "route": "cuda",
        "source": "lumenrenderer_tpu_torch/ops/csrc/tree_walk.cu",
        "replaces": REPLACES["tree_walk"], "launches": w_["launches"],
        "max_abs_err": w_["max_abs_err"], "ms": w_["ms"],
        "plain_ms": w_["plain_ms"],
        "bound_ms": w_["bound_ms"], "bound_by": w_["bound_by"],
        "library_ms": None})
    kernels += _bvh_rows(bvh_checks, bvh_launches)
    for name in KERNELS[:3]:
        for mode in ("closest", "any"):
            c = bf16_checks[name][mode]
            kernels.append({
                "name": f"{name}[{mode}, bf16]", "route": "cuda",
                "source": f"lumenrenderer_tpu_torch/ops/csrc/{name}.cu",
                "replaces": REPLACES[name] + " (precision=\"default\")",
                "launches": bf16_launches[name][mode],
                **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "full_pass_ms",
                                     "full_pass_bound_ms",
                                     "fp32_full_pass_ms",
                                     "differs_from_fp32")},
                "bound_peak": "bf16 tensor cores, 989 TFLOP/s",
                **{k: c[k] for k in ("design", "epilogue_bound_ms",
                                     "epilogue_share",
                                     "full_pass_epilogue_bound_ms",
                                     "epilogue_instructions_per_pair",
                                     "instructions_per_ray_visit",
                                     "paced_by") if k in c},
                "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
