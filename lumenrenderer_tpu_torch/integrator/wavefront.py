"""The wavefront path-tracing frame: port of
`lumenrenderer_tpu/integrator/wavefront.py`.

One 1-spp frame as a loop over depths of masked fixed-size ray batches, run
eagerly. Light channels: DIRECT gets primary-hit emission and primary NEE;
INDIRECT gets bounce NEE and, with MIS, weighted BSDF-sampled emission;
SPECULAR gets paths whose first bounce took a near-delta lobe. Strategies:
"nee", "bsdf", "mis".

The frame is differentiable with respect to the scene's shading parameters
(materials, emission, environment) under the JAX package's detached-sampling
discipline (`RenderConfig.detach_sampling`): hits, sampled directions,
pdfs, MIS and Russian-roulette weights carry no gradient, so the gradient is
that of the estimator along the sampled paths. The intersectors' inputs and
outputs are always detached: the kernels return integer keys and bits, and
no graph is built over the rays' features. With `RenderConfig.remat`,
depths >= 1 run under `torch.utils.checkpoint` and are recomputed in the
backward; their intersections and shadow-ray bits are kept from the forward,
so the recompute launches no intersector.

Random numbers come from a `Uniforms` source, drawn in a fixed order: the
(N,2) pixel jitter, then per depth the volume march's (`volume.march`, at
depths below `volume_depths` of a scene with volumes), the alpha (N,), NEE
(N,3) and NEE's shadow transmittance (with volumes), BSDF (N,4) and
Russian-roulette (N,) uniforms, each only where the JAX frame draws it.
A depth recomputed under remat replays the numbers its forward drew. With
use_restir, ReSTIR DI (`restir.di.RestirDI`) takes the NEE draw's place at
depth 0 and draws its own numbers from the same source.

Volumes (`SceneData.volumes`): at depths below `volume_depths` the segment
to the hit (or 1e8 on a miss) marches `volume_steps` steps through each
volume's box, adding in-scattered light (each step samples a light and
casts a ray to it through the frame's occluder) to the VOLUMETRIC channel
and attenuating the throughput; NEE's shadow rays are attenuated by the
transmittance `volume_transmittance` estimates ("riemann" or "ratio"),
detached.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import torch
import torch.utils.checkpoint

from ..bsdf import disney as disney_mod
from ..bsdf import lambert
from ..core import camera as camera_mod
from ..core import sampling
from ..core import vecmath as vm
from ..scene.materials import GatheredMaterial
from ..scene.scene import SceneData
from ..utils import profiling
from ..volume import march as vmarch
from . import nee as nee_mod
from .surface import SurfaceData, extract_surface_data

RAY_EPS = 1e-3

# stage names for debug_checks (encoded as depth * len + stage + 1)
DEBUG_STAGES = (
    "intersect",
    "extract_surface_data",
    "volumetric",
    "emissive/light channels",
    "nee/shade_direct",
    "bsdf_sample/throughput",
)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Frame configuration; same names and defaults as the JAX package's
    `RenderConfig`.

    detach_sampling: hits, sampled directions, pdfs, MIS and RR weights
    carry no gradient (keep True). mipmaps: a textured scene's textures are
    sampled trilinearly at the ray footprint's mip level (bilinear at level
    0 when off; no cost without textures). remat: depths >= 1 are
    recomputed in the backward instead of keeping their intermediates.
    volume_steps, volume_depths: march steps a segment, and how many depths
    march (a scene with volumes); volume_transmittance: NEE's shadow
    transmittance estimator, "riemann" (5 steps) or "ratio". swizzle: the
    frame's rays run in `camera.block_swizzle_map` order (16x8 pixel
    blocks: compact 128-ray tiles) and every per-pixel output returns in
    row-major order; it excludes use_restir and a caller's pixel_ids, as in
    JAX."""

    width: int = 128
    height: int = 128
    max_depth: int = 5
    bsdf: str = "disney"          # "lambert" | "disney"
    light_strategy: str = "mis"   # "nee" | "bsdf" | "mis"
    light_selection: str = "cdf"  # "cdf" | "uniform"
    rr_start_depth: int = 2
    rr_min_prob: float = 0.05
    use_restir: bool = False
    jitter: str = "random"        # "halton" | "random" | "center"
    alpha_test: bool = False      # treat OPAQUE materials as BLEND too
    alpha_materials: bool = False  # per-material alpha mode and sidedness
    detach_sampling: bool = True
    volume_steps: int = 5
    volume_depths: int = 2
    volume_transmittance: str = "riemann"   # "riemann" | "ratio"
    swizzle: bool = False
    sort_secondary: bool = True
    mipmaps: bool = True
    extract_tangent: bool = True
    remat: bool = False
    debug_checks: bool = False

    def __post_init__(self):
        if self.swizzle and self.use_restir:
            raise ValueError("swizzle and use_restir are exclusive")

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def _bsdf_sample(cfg: RenderConfig, sd: SurfaceData, wo, u):
    if cfg.bsdf == "lambert":
        wi, f, pdf = lambert.sample_brdf(sd.base_color, sd.normal, wo,
                                         u[..., :2])
        return wi, f, pdf, torch.zeros(wo.shape[:-1], dtype=torch.bool,
                                       device=wo.device)
    return disney_mod.sample(sd, wo, u)


def _bsdf_eval(cfg: RenderConfig, sd: SurfaceData, wo, wi):
    if cfg.bsdf == "lambert":
        return lambert.eval_brdf(sd.base_color, sd.normal, wo, wi)
    return disney_mod.evaluate(sd, wo, wi)


def _sel(mask, a, b):
    """torch.where of (N,3) rows (or scalars) by an (N,) per-ray mask."""
    return torch.where(mask[:, None], a, b)


def _detach(x):
    return x.detach() if isinstance(x, torch.Tensor) else x


def _detached(query: Callable) -> Callable:
    """An intersector (or occluder, or its sorted form) with no gradient in
    or out: t_max depends on `alive`, which depends on the throughput, and
    neither the sort nor a kernel's wrapper may build a graph over the
    rays."""

    def call(o, d, tn, tx):
        out = query(o.detach(), d.detach(), _detach(tn), _detach(tx))
        if isinstance(out, dict):
            return {k: _detach(v) for k, v in out.items()}
        return out.detach()

    return call


class _Replay:
    """A callable (a depth's uniform source, or its occluder) whose results
    are recorded on a checkpointed depth's forward and returned again, in
    order, when the depth is recomputed in the backward: the recompute sees
    the same numbers and shadow-ray bits (the shadow rays are detached) and
    launches no intersector. The body alone defines the order of calls."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.results = []
        self.pos = None  # None while recording, else the next to replay

    def __call__(self, *args):
        if self.pos is None:
            self.results.append(self.fn(*args))
            return self.results[-1]
        if self.pos == len(self.results):
            raise RuntimeError("recomputed depth asked for more than its "
                               "forward drew")
        self.pos += 1
        return self.results[self.pos - 1]


def _replayed(body: Callable, *sources: _Replay) -> Callable:
    """body(*args, *sources), with the sources replayed from their start on
    each pass after the first, and a pass that runs to its end checked to
    have consumed all that the first recorded. (A recompute that stops
    early once the backward has its tensors never reaches the check.)"""

    def run(*args):
        replay = sources[0].pos is not None
        for s in sources:
            s.pos = 0 if replay else None
        out = body(*args, *sources)
        for s in sources:
            if replay and s.pos != len(s.results):
                raise RuntimeError(
                    f"recomputed depth used {s.pos} of the {len(s.results)} "
                    "results its forward recorded")
            s.pos = 0
        return out

    return run


@functools.lru_cache(maxsize=4)
def _swizzle_ids(width: int, height: int, device: torch.device):
    """`block_swizzle_map`'s (perm, inv) as int64 tensors on `device`, made
    once a frame size (the map takes tens of ms on the host at 1440p); the
    frame only reads them."""
    return tuple(torch.from_numpy(a).to(device=device, dtype=torch.int64)
                 for a in camera_mod.block_swizzle_map(width, height))


def render_wavefront(scene: SceneData, intersect_fn: Callable,
                     occlude_fn: Callable, camera: camera_mod.Camera,
                     uniforms: sampling.Uniforms, frame_index: int,
                     cfg: RenderConfig,
                     restir_state=None,
                     restir_fn: Optional[Callable] = None,
                     pixel_ids: Optional[torch.Tensor] = None
                     ) -> Dict[str, Any]:
    """Trace one 1-spp frame. Returns direct/indirect/specular (N,3) light
    channels, volumetric (N,3) (None for a scene without volumes),
    primary-hit AOVs depth (N,), normal/albedo (N,3), motion (N,2), the
    scalars overflow (visit lists truncated) and, with debug_checks,
    debug_first_bad (0 = clean, else 1 + encoded stage), and restir_state
    (the new reservoir state, or restir_state itself without ReSTIR).

    intersect_fn(o, d, tmin, tmax) -> {"t", "tri", "overflow"};
    occlude_fn(o, d, tmin, tmax) -> (N,) bool. With cfg.use_restir,
    restir_fn(scene, sd, wo, hit_mask, motion, restir_state, uniforms,
    occlude_fn=) -> (color (N,3), new state) shades depth 0's direct light
    (a `restir.di.RestirDI`).

    Differentiable when run with gradients enabled: e.g. the mean of
    `merge_channels(out)` backpropagates into `scene.materials` and
    `scene.env_radiance` tensors that require grad.

    pixel_ids: optional (N',) global pixel indices: trace that slice of the
    frame (under a device mesh, the rank's rows); every per-pixel output
    and draw has N' rows in pixel_ids order, and cfg.width and cfg.height
    stay the full frame's for the camera. cfg.swizzle excludes it: the frame
    then traces `block_swizzle_map`'s order (slot i draws row i of each
    draw) and de-swizzles every per-pixel output."""
    dev = camera.eye.device
    inv_ids = None
    if cfg.swizzle:
        if pixel_ids is not None:
            raise ValueError("pixel_ids and swizzle are exclusive")
        pixel_ids, inv_ids = _swizzle_ids(cfg.width, cfg.height, dev)
    n = cfg.num_pixels if pixel_ids is None else pixel_ids.shape[0]
    f32 = torch.float32
    sg = _detach if cfg.detach_sampling else (lambda x: x)

    def zeros(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def chk(fb, stage: str, depth_i: int, *arrs):
        if not cfg.debug_checks:
            return fb
        idx = depth_i * len(DEBUG_STAGES) + DEBUG_STAGES.index(stage) + 1
        bad = zeros(dtype=torch.bool)
        for a in arrs:
            bad = bad | ~torch.isfinite(a).all()
        return torch.where((fb == 0) & bad, idx, fb).to(torch.int32)

    t_min = RAY_EPS
    with profiling.span("wavefront.primary"):
        ray_o, ray_d = camera_mod.generate_primary_rays(
            camera, cfg.width, cfg.height, frame_index, uniforms, cfg.jitter,
            pixel_ids=pixel_ids)
        # ray-footprint mip selection: the per-pixel angular spread (the
        # camera's half-screen vector v spans height / 2 pixels) and the
        # path length so far (bounce rays keep widening)
        use_mips = cfg.mipmaps and scene.textures.count > 1
        mip_spread = (2.0 * torch.linalg.norm(camera.v) / cfg.height
                      if use_mips else None)
        carry = (ray_o, ray_d,
                 torch.ones((n, 3), dtype=f32, device=dev),    # throughput
                 torch.ones(n, dtype=torch.bool, device=dev),  # alive
                 torch.full((n,), torch.inf, dtype=f32,
                            device=dev),                       # prev_pdf
                 torch.ones(n, dtype=torch.bool, device=dev),  # prev_specular
                 zeros(n, dtype=torch.bool),                   # first_specular
                 zeros(n, 3),                                  # beer_sigma
                 zeros(n, 3), zeros(n, 3), zeros(n, 3),  # direct, indir, spec
                 zeros(dtype=torch.int32),                     # first_bad
                 zeros(n) if use_mips else None,               # path_dist
                 None if scene.volumes is None else zeros(n, 3))  # volumetric
        overflow_any = zeros(dtype=torch.bool)
        aovs: Dict[str, torch.Tensor] = {}
        light_table = nee_mod.build_light_table(scene, cfg.light_selection)
        s_isect, occl = intersect_fn, occlude_fn
        if cfg.sort_secondary:
            from ..accel import sorting as sorting_mod

            pts = scene.tri_pos.reshape(-1, 3)
            s_isect, occl = sorting_mod.sorted_intersectors(
                intersect_fn, occlude_fn, pts.amin(0), pts.amax(0))
    isect, s_isect, occl = map(_detached, (intersect_fn, s_isect, occl))
    alpha_on = cfg.alpha_test or cfg.alpha_materials
    env = scene.env_radiance[None, :]

    def trace_depth(depth: int, carry, hits, uni, occl_d):
        """One depth after its intersection: shading, NEE, the next
        bounce. uni: the draw source; occl_d: the (sorted) occluder."""
        nonlocal restir_state
        (ray_o, ray_d, throughput, alive, prev_pdf, prev_specular,
         first_specular, beer_sigma, direct, indirect, specular_ch,
         first_bad, path_dist, volumetric) = carry
        with profiling.span("wavefront.surface", depth=depth):
            first_bad = chk(first_bad, "intersect", depth,
                            torch.where(torch.isinf(hits["t"]), 0.0,
                                        hits["t"]))
            sd = extract_surface_data(scene, ray_o, ray_d, hits["tri"],
                                      mip_spread=mip_spread,
                                      mip_dist0=path_dist,
                                      detach_geom=cfg.detach_sampling,
                                      with_tangent=cfg.extract_tangent)
            if use_mips:
                path_dist = path_dist + torch.where(sd.valid, sg(sd.t), 0.0)
            if cfg.detach_sampling:
                # geometry does not depend on the differentiated parameters;
                # detached here, no gradient meets t, u, v's 1 / det (about
                # 1e14 near the det guard)
                sd = sd.replace(position=sg(sd.position), normal=sg(sd.normal),
                                geo_normal=sg(sd.geo_normal),
                                tangent=sg(sd.tangent), t=sg(sd.t),
                                uv=sg(sd.uv))
            hit_mask = sd.valid & alive
            wo = -ray_d
            first_bad = chk(first_bad, "extract_surface_data", depth,
                            _sel(hit_mask, sd.position, 0.0),
                            _sel(hit_mask, sd.normal, 0.0),
                            _sel(hit_mask, sd.base_color, 0.0),
                            _sel(hit_mask, sd.emissive, 0.0),
                            torch.where(hit_mask, sd.roughness, 0.0))

            # Beer's-law absorption over the interior segment just traversed
            if cfg.bsdf == "disney" and depth > 0:
                seg = torch.where(sd.valid, sd.t.clamp_max(1e6), 0.0)
                throughput = throughput * torch.exp(-beer_sigma * seg[:, None])

        # volumetric segment: in-scattering and transmittance up to the hit
        if scene.volumes is not None and depth < cfg.volume_depths:
            v_scatter, v_trans = vmarch.volume_scatter(
                scene.volumes, light_table, ray_o, ray_d, t_min,
                torch.where(sd.valid, sd.t, 1e8), uni, occl_d,
                steps=cfg.volume_steps, detach_sampling=cfg.detach_sampling,
                alive=alive)
            volumetric = volumetric + _sel(alive, throughput * v_scatter,
                                           0.0)
            throughput = throughput * _sel(alive, v_trans[:, None], 1.0)
            first_bad = chk(first_bad, "volumetric", depth, volumetric,
                            throughput)

        with profiling.span("wavefront.emission", depth=depth):
            # miss: environment light
            env_contrib = _sel(alive & ~sd.valid, throughput * env, 0.0)
            if depth == 0:
                direct = direct + env_contrib
            else:
                specular_ch = specular_ch + _sel(first_specular,
                                                 env_contrib, 0.0)
                indirect = indirect + _sel(first_specular, 0.0, env_contrib)

            if depth == 0:
                aovs["depth"] = torch.where(hit_mask, sd.t, 0.0)
                aovs["normal"] = _sel(hit_mask, sd.normal, 0.0)
                aovs["albedo"] = _sel(hit_mask, sd.base_color, 0.0)
                aovs["motion"] = camera_mod.motion_vectors(
                    sd.position, hit_mask, camera, cfg.width, cfg.height,
                    pixel_ids=pixel_ids)

            # emissive surface hit
            em = throughput * sd.emissive
            if depth == 0:
                direct = direct + _sel(hit_mask, em, 0.0)
            elif cfg.light_strategy == "bsdf":
                indirect = indirect + _sel(hit_mask, em, 0.0)
            elif cfg.light_strategy == "mis":
                lpdf = nee_mod.light_pdf_solid_angle(light_table, ray_d, sd.t,
                                                     sd.light_row)
                w = torch.where(prev_specular, 1.0,
                                sg(sampling.power_heuristic(prev_pdf, lpdf)))
                # the mask goes into the scalar, before it meets a live value
                em_w = em * torch.where(hit_mask, w, 0.0)[:, None]
                specular_ch = specular_ch + _sel(first_specular, em_w, 0.0)
                indirect = indirect + _sel(first_specular, 0.0, em_w)
            first_bad = chk(first_bad, "emissive/light channels", depth,
                            direct, indirect, specular_ch)

        # per-material alpha and sidedness: pass through without shading
        if alpha_on:
            a_u = uni(n)
            gm = GatheredMaterial(sd.mat_rows)
            mode = gm.alpha_mode
            stochastic = mode == 2.0
            if cfg.alpha_test:
                stochastic = stochastic | (mode == 0.0)
            passthrough = hit_mask & (
                ((mode == 1.0) & (sd.alpha < gm.alpha_cutoff))
                | (stochastic & (sd.alpha < a_u))
                | ((gm.double_sided < 0.5) & ~sd.front_face))
            hit_mask = hit_mask & ~passthrough
        else:
            passthrough = zeros(n, dtype=torch.bool)

        with profiling.span("wavefront.nee", depth=depth):
            if cfg.use_restir and depth == 0 and restir_fn is not None:
                # the sorted occluder, as NEE's shadow rays use
                restir_out, restir_state = restir_fn(
                    scene, sd, wo, hit_mask, aovs["motion"], restir_state, uni,
                    occlude_fn=occl_d)
                direct = direct + throughput * restir_out
            elif cfg.light_strategy in ("nee", "mis"):
                ls = nee_mod.sample_light(light_table, uni(n, 3), sd.position)
                cos_s = vm.dot(sd.normal, ls.wi)
                f_val, bsdf_pdf = _bsdf_eval(cfg, sd, wo, ls.wi)
                pdf_sa = nee_mod.pdf_solid_angle(ls)
                contrib_valid = (hit_mask & ls.valid & (cos_s > 0.0)
                                 & (pdf_sa > 1e-12)
                                 & (vm.luminance(ls.radiance) > 0.0))
                mis_w = (sg(sampling.power_heuristic(pdf_sa, bsdf_pdf))
                         if cfg.light_strategy == "mis" else 1.0)
                so = sd.position + sd.geo_normal * RAY_EPS
                occluded = occl_d(so, ls.wi, RAY_EPS,
                                  torch.where(contrib_valid,
                                              ls.dist - 2.0 * RAY_EPS, -1.0))
                # validity and occlusion go into the detached scalar before
                # the product, so no inf or NaN meets a live gradient
                scale = torch.where(
                    contrib_valid & ~occluded,
                    sg(cos_s).clamp_min(0.0) * mis_w
                    / sg(pdf_sa).clamp_min(1e-12), 0.0)
                if scene.volumes is not None:
                    # participating media along the shadow segment (always 5
                    # steps with "riemann", as in the JAX package)
                    scale = scale * sg(vmarch.transmittance_only(
                        scene.volumes, so, ls.wi, RAY_EPS,
                        torch.where(contrib_valid,
                                    ls.dist - 2.0 * RAY_EPS, 0.0),
                        uniforms=uni, estimator=cfg.volume_transmittance))
                shadowed = throughput * f_val * ls.radiance * scale[:, None]
                first_bad = chk(first_bad, "nee/shade_direct", depth, shadowed)
                if depth == 0:
                    direct = direct + shadowed
                else:
                    specular_ch = specular_ch + _sel(first_specular, shadowed,
                                                     0.0)
                    indirect = indirect + _sel(first_specular, 0.0, shadowed)

        with profiling.span("wavefront.bounce", depth=depth):
            if depth + 1 < cfg.max_depth:
                wi, f_val, pdf, is_spec = _bsdf_sample(cfg, sd, wo, uni(n, 4))
                # the direction and its density are sampling machinery; f is
                # the integrand and stays live
                wi = sg(wi)
                cos_i = vm.dot(sd.normal, wi).abs()
                valid_bounce = (hit_mask & (pdf > 1e-9)
                                & torch.isfinite(wi).all(-1))
                new_tp = throughput * f_val * (
                    sg(cos_i) / sg(pdf).clamp_min(1e-9))[:, None]
                new_tp = _sel(valid_bounce, new_tp, 0.0)
                if depth >= cfg.rr_start_depth:
                    p_survive = sg(new_tp.amax(-1).clamp(cfg.rr_min_prob, 1.0))
                    survive = uni(n) < p_survive
                    new_tp = _sel(survive, new_tp / p_survive[:, None], 0.0)
                    valid_bounce = valid_bounce & survive
                side = torch.sign(vm.dot(sd.geo_normal, wi))[..., None]
                bounce_o = sd.position + sd.geo_normal * side * RAY_EPS
                next_o = _sel(passthrough, sd.position + ray_d * RAY_EPS,
                              bounce_o)
                next_d = _sel(passthrough, ray_d, wi)
                next_alive = valid_bounce | passthrough
                ray_o = _sel(next_alive, next_o, ray_o)
                ray_d = _sel(next_alive, next_d, ray_d)
                throughput = _sel(passthrough, throughput, new_tp)
                # the previous pdf feeds only the detached MIS weight
                prev_pdf = torch.where(passthrough, prev_pdf, sg(pdf))
                prev_specular = torch.where(passthrough, prev_specular,
                                            is_spec)
                if depth == 0:
                    first_specular = is_spec & valid_bounce & ~passthrough
                if cfg.bsdf == "disney":
                    # a refraction crossing the surface enters or leaves a
                    # medium
                    crossing = valid_bounce & (vm.dot(sd.geo_normal, wi) < 0.0)
                    sigma_mat = -torch.log(GatheredMaterial(sd.mat_rows)
                                           .transmittance.clamp(1e-6, 1.0))
                    beer_sigma = _sel(crossing & sd.front_face, sg(sigma_mat),
                                      beer_sigma)
                    beer_sigma = _sel(crossing & ~sd.front_face, 0.0,
                                      beer_sigma)
                alive = next_alive & (throughput.amax(-1) > 0.0)
                first_bad = chk(first_bad, "bsdf_sample/throughput", depth,
                                _sel(alive, throughput, 0.0),
                                _sel(alive, ray_d, 0.0))
            elif alpha_on:
                # passthrough at the depth horizon still sees the environment
                indirect = indirect + _sel(passthrough, throughput * env, 0.0)
        return (ray_o, ray_d, throughput, alive, prev_pdf, prev_specular,
                first_specular, beer_sigma, direct, indirect, specular_ch,
                first_bad, path_dist, volumetric)

    for depth in range(cfg.max_depth):
        ray_o, ray_d, alive = carry[0], carry[1], carry[3]
        with profiling.span("wavefront.intersect", depth=depth):
            # dead lanes get t_max < t_min: skipped and left out of tile
            # bounds
            t_max_ray = torch.where(alive, camera.t_max, -1.0)
            hits = (s_isect if depth > 0 else isect)(ray_o, ray_d, t_min,
                                                     t_max_ray)
            overflow_any = overflow_any | hits["overflow"]
        if depth > 0 and cfg.remat and torch.is_grad_enabled():
            # depth 0 stays live (its AOVs and ReSTIR state); deeper depths
            # keep only their inputs and are recomputed in the backward,
            # replaying their draws and shadow bits, so no RNG state is
            # restored
            body = _replayed(functools.partial(trace_depth, depth),
                             _Replay(uniforms), _Replay(occl))
            carry = torch.utils.checkpoint.checkpoint(
                body, carry, hits, use_reentrant=False,
                preserve_rng_state=False)
        else:
            carry = trace_depth(depth, carry, hits, uniforms, occl)

    out = {"direct": carry[8], "indirect": carry[9], "specular": carry[10],
           "volumetric": carry[13], **aovs}
    if inv_ids is not None:
        # every per-ray output back to row-major pixel order
        out = {k: (None if v is None else v[inv_ids]) for k, v in out.items()}
    out.update(overflow=overflow_any, restir_state=restir_state)
    if cfg.debug_checks:
        out["debug_first_bad"] = carry[11]
    return out


def decode_debug_stage(first_bad: int) -> Optional[str]:
    """Map out["debug_first_bad"] to "stage (depth d)"; None when clean."""
    if first_bad == 0:
        return None
    i = int(first_bad) - 1
    return f"{DEBUG_STAGES[i % len(DEBUG_STAGES)]} (depth {i // len(DEBUG_STAGES)})"


def merge_channels(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum the light channels into the radiance image (N,3)."""
    img = out["direct"] + out["indirect"] + out["specular"]
    if out.get("volumetric") is not None:
        img = img + out["volumetric"]
    return img
