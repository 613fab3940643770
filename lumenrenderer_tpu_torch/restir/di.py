"""ReSTIR direct illumination: port of `lumenrenderer_tpu/restir/di.py`.

Reservoir spatiotemporal resampling at the primary hit: a power CDF over the
lights and light bags drawn from it, RIS of `candidates` bag samples per pixel
(one candidate set per `bag_tile` pixel tile when the image divides by it),
visibility, temporal reuse through motion vectors with an M clamp, spatial
reuse of random neighbours behind depth and normal gates, and shading of the
winner. Every pass is dense masked tensor code, forward only.

Random numbers come from a draw source `draws` with `uniform(*shape)` (float32
U[0,1)) and `randint(high, *shape)` (int32 in [0, high)), drawn in this order:
the bags' uniforms; RIS's bag and slot integers, barycentric and pick
uniforms; the temporal combine's uniform (when there is a history); per
spatial iteration the angle, radius and pick uniforms; in a scene with
volumes, the shading's transmittance uniform last.

While spans record (`utils/profiling.py`), `RestirDI` opens one span a pass:
`restir.cdf` (the light radiance, the CDF and the bags), `restir.ris`,
`restir.visibility` (each of the two, holding the occluder's query),
`restir.temporal`, `restir.spatial` and `restir.shade` (shading, the
volumes' transmittance and the new state); each visibility pass charges
the rays it sent and the live ones among them (`count_restir_rays`) as a
device counter.
"""
from __future__ import annotations

import dataclasses
import math
import types

import torch

from ..core import vecmath as vm
from ..core.struct import TensorStruct
from ..integrator import nee as nee_mod
from ..utils import profiling

SHADOW_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class RestirConfig:
    """Same fields and defaults as the JAX package's `RestirConfig`."""

    candidates: int = 32          # primary samples per reservoir
    num_bags: int = 50
    bag_size: int = 1000
    # one candidate set per bag_tile x bag_tile pixel tile (each pixel still
    # runs its own pick); used when width and height divide by bag_tile
    tile_candidates: bool = True
    spatial_samples: int = 5
    spatial_radius: int = 30
    spatial_iterations: int = 2
    temporal_clamp: int = 20      # max M multiple kept from history
    biased: bool = True
    bag_tile: int = 16            # pixel tile sharing one light bag
    depth_gate: float = 0.1       # relative depth similarity (reuse gates)
    normal_gate: float = 0.906    # cos(25 deg), reuse normal gate


@dataclasses.dataclass(frozen=True)
class Reservoir(TensorStruct):
    """Per-pixel reservoir (one sample)."""

    light_idx: torch.Tensor  # (N,) int32 chosen light row
    bary: torch.Tensor       # (N,2) sample point (u,v on the light's edges)
    w_sum: torch.Tensor      # (N,) sum of RIS weights
    m: torch.Tensor          # (N,) float32 candidate count
    w_out: torch.Tensor      # (N,) unbiased contribution weight W
    p_hat: torch.Tensor      # (N,) target pdf of the chosen sample


@dataclasses.dataclass(frozen=True)
class RestirState(TensorStruct):
    """Temporal history: the previous reservoirs and the gbuffer the gates
    and the unbiased combine read."""

    reservoir: Reservoir
    prev_depth: torch.Tensor     # (N,)
    prev_normal: torch.Tensor    # (N,3)
    prev_position: torch.Tensor  # (N,3) world position (unbiased re-eval)
    prev_albedo: torch.Tensor    # (N,) albedo luminance (unbiased re-eval)
    valid: torch.Tensor          # () bool, False before the first frame


def _map(fn, res: Reservoir) -> Reservoir:
    """Reservoir with fn applied to every field."""
    return Reservoir(**{f.name: fn(getattr(res, f.name))
                        for f in dataclasses.fields(Reservoir)})


def empty_reservoir(n: int, *,
                    device: torch.device | str) -> Reservoir:
    f32 = dict(dtype=torch.float32, device=device)
    return Reservoir(
        light_idx=torch.zeros((n,), dtype=torch.int32, device=device),
        bary=torch.zeros((n, 2), **f32), w_sum=torch.zeros((n,), **f32),
        m=torch.zeros((n,), **f32), w_out=torch.zeros((n,), **f32),
        p_hat=torch.zeros((n,), **f32))


def init_state(n: int, *, device: torch.device | str) -> RestirState:
    f32 = dict(dtype=torch.float32, device=device)
    return RestirState(
        reservoir=empty_reservoir(n, device=device),
        prev_depth=torch.zeros((n,), **f32),
        prev_normal=torch.zeros((n, 3), **f32),
        prev_position=torch.zeros((n, 3), **f32),
        prev_albedo=torch.zeros((n,), **f32),
        valid=torch.tensor(False, device=device))


# ---------------------------------------------------------------------------
# CDF + light bags
# ---------------------------------------------------------------------------

def build_light_cdf(scene, rad_all=None):
    """Power-weighted (luminance * area) CDF over the lights: (cdf, pdf)."""
    return nee_mod.build_light_cdf(scene, rad_all)


def sample_cdf(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return torch.searchsorted(cdf, u.contiguous(), right=True).clamp(
        0, cdf.shape[0] - 1).to(torch.int32)


def fill_light_bags(cdf: torch.Tensor, cfg: RestirConfig,
                    draws) -> torch.Tensor:
    """(num_bags, bag_size) int32 light rows sampled from the CDF."""
    return sample_cdf(cdf, draws.uniform(cfg.num_bags, cfg.bag_size))


# ---------------------------------------------------------------------------
# target pdf
# ---------------------------------------------------------------------------

def _target_phat(scene, sd, light_idx, bary, rad_all=None, at_position=None,
                 at_normal=None, at_albedo_lum=None, prow=None):
    """Unshadowed target pdf in area measure at the pixel's surface,
    luminance(albedo/pi * L * cos_s * cos_l / d^2), with the direction and
    distance to the sample: (p_hat, wi, dist). at_*: evaluate at another
    surface than sd's; prow: the light rows, when the caller has them.
    p_hat is sampling machinery, so L carries no gradient.

    Sample axes broadcast against the surface by rank: a sample array one
    rank above the surface adds a sample axis (per-pixel candidates, the
    spatial pass's neighbours), two ranks above adds a tile's pixel axis
    before it (tile candidates)."""
    li = light_idx.clamp_min(0).long()
    if prow is None:
        prow = scene.lights.packed[li]
    p = (prow[..., 0:3] + bary[..., 0:1] * prow[..., 3:6]
         + bary[..., 1:2] * prow[..., 6:9])
    rad = (rad_all[li] if rad_all is not None
           else scene.light_radiance(li)).detach()
    pos = at_position if at_position is not None else sd.position
    nrm = at_normal if at_normal is not None else sd.normal
    alb = (at_albedo_lum if at_albedo_lum is not None
           else vm.luminance(sd.base_color))
    to_l = p - pos[..., None, :] if p.ndim == pos.ndim + 1 else p - pos
    dist = vm.length(to_l).clamp_min(1e-5)
    wi = to_l / dist[..., None]
    if p.ndim == nrm.ndim + 1:
        cos_s = vm.dot(nrm[..., None, :], wi).clamp_min(0.0)
    else:
        cos_s = vm.dot(nrm, wi).clamp_min(0.0)
    albedo_lum = alb / math.pi
    if p.ndim == albedo_lum.ndim + 2:
        albedo_lum = albedo_lum[..., None]
    cos_l = vm.dot(prow[..., 9:12], -wi).clamp_min(0.0)
    g = cos_s * cos_l / (dist * dist)
    return albedo_lum * vm.luminance(rad) * g, wi, dist


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------

def _running_sums(w: torch.Tensor):
    """w[..., 0] + ... + w[..., j], added in order, one (...,) tensor per j:
    a cumsum over the short last axis (torch's CUDA scan kernel is slow on
    millions of short rows)."""
    sums = [w[..., 0]]
    for j in range(1, w.shape[-1]):
        sums.append(sums[-1] + w[..., j])
    return sums


def _pick(sums, w_sum: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Categorical pick: #{j : sums[j] < u * w_sum}, clamped to the last
    index."""
    thr = u * w_sum
    pick = torch.zeros(thr.shape, dtype=torch.int64, device=thr.device)
    for s in sums:
        pick += s < thr
    return pick.clamp_max(len(sums) - 1)


def _ris_primary_tiled(scene, sd, bags, bag_pdf, cfg: RestirConfig, width,
                       draws, rad_all=None):
    """Tile-candidate RIS: one candidate set per bag_tile x bag_tile tile,
    pixels laid out tile-major so the candidates broadcast across the tile;
    every pixel evaluates its own target pdfs and runs its own pick."""
    n = sd.position.shape[0]
    c = cfg.candidates
    bt = cfg.bag_tile
    height = n // width
    ty, tx = height // bt, width // bt
    t = ty * tx
    p_tile = bt * bt
    bag_t = draws.randint(cfg.num_bags, t).long()
    slot_t = draws.randint(cfg.bag_size, t, c).long()
    cand_light = bags[bag_t[:, None], slot_t][:, None, :]       # (T,1,C)
    pdf_sel = bag_pdf[cand_light.long()]                        # (T,1,C)
    bs = draws.uniform(t, 1, c, 2)
    su = torch.sqrt(bs[..., 0])
    bary = torch.stack([1.0 - su, bs[..., 1] * su], dim=-1)     # (T,1,C,2)
    prow = scene.lights.packed[cand_light.clamp_min(0).long()]  # (T,1,C,13)
    p_cand = pdf_sel / prow[..., 12].clamp_min(1e-12)

    def to_tiles(x):
        img = x.reshape((ty, bt, tx, bt) + x.shape[1:])
        return img.movedim(2, 1).reshape((t, p_tile) + x.shape[1:])

    def from_tiles(x):
        img = x.reshape((ty, tx, bt, bt) + x.shape[2:])
        return img.movedim(1, 2).reshape((n,) + x.shape[2:])

    phat, _, _ = _target_phat(
        scene, None, cand_light, bary, rad_all=rad_all, prow=prow,
        at_position=to_tiles(sd.position), at_normal=to_tiles(sd.normal),
        at_albedo_lum=to_tiles(vm.luminance(sd.base_color)))    # (T,P,C)
    w = torch.where(p_cand > 0, phat / p_cand.clamp_min(1e-20), 0.0)
    w_sum = w.sum(-1)                                           # (T,P)
    pick = _pick(_running_sums(w), w_sum,
                 draws.uniform(t, p_tile, 1)[..., 0])           # (T,P)
    chosen_light = cand_light.expand(t, p_tile, c).gather(
        2, pick[..., None])[..., 0]
    chosen_bary = bary.expand(t, p_tile, c, 2).gather(
        2, pick[..., None, None].expand(t, p_tile, 1, 2))[:, :, 0]
    chosen_phat = phat.gather(-1, pick[..., None])[..., 0]
    w_out = torch.where(chosen_phat > 0,
                        w_sum / (c * chosen_phat.clamp_min(1e-20)), 0.0)
    return Reservoir(
        light_idx=from_tiles(chosen_light), bary=from_tiles(chosen_bary),
        w_sum=from_tiles(w_sum),
        m=torch.full((n,), float(c), dtype=torch.float32, device=w.device),
        w_out=from_tiles(w_out), p_hat=from_tiles(chosen_phat))


def ris_primary(scene, sd, bags, bag_pdf, cfg: RestirConfig, width, draws,
                rad_all=None):
    """RIS of `candidates` bag samples per pixel: the tile-candidate form
    when the image divides by bag_tile, else per-pixel candidates from the
    pixel's tile's bag."""
    n = sd.position.shape[0]
    c = cfg.candidates
    height = n // width
    if (cfg.tile_candidates and width % cfg.bag_tile == 0
            and height % cfg.bag_tile == 0 and n == width * height):
        return _ris_primary_tiled(scene, sd, bags, bag_pdf, cfg, width,
                                  draws, rad_all=rad_all)
    ids = torch.arange(n, dtype=torch.int32, device=sd.position.device)
    px, py = ids % width, ids // width
    # assumes width / bag_tile < 1024, as the JAX package does
    tile = (py // cfg.bag_tile) * 1024 + (px // cfg.bag_tile)
    bag_of_tile = draws.randint(cfg.num_bags, 1 << 16)
    bag_idx = bag_of_tile[(tile % bag_of_tile.shape[0]).long()].long()
    slot = draws.randint(cfg.bag_size, n, c).long()
    cand_light = bags[bag_idx[:, None], slot]                   # (N,C)
    cand_pdf_sel = bag_pdf[cand_light.long()]
    bs = draws.uniform(n, c, 2)
    su = torch.sqrt(bs[..., 0])
    bary = torch.stack([1.0 - su, bs[..., 1] * su], dim=-1)     # (N,C,2)
    prow_c = scene.lights.packed[cand_light.clamp_min(0).long()]
    p_cand = cand_pdf_sel / prow_c[..., 12].clamp_min(1e-12)
    phat, _, _ = _target_phat(scene, sd, cand_light, bary, rad_all=rad_all,
                              prow=prow_c)
    w = torch.where(p_cand > 0, phat / p_cand.clamp_min(1e-20), 0.0)
    w_sum = w.sum(1)
    pick = _pick(_running_sums(w), w_sum, draws.uniform(n, 1)[:, 0])
    chosen_light = cand_light.gather(1, pick[:, None])[:, 0]
    chosen_bary = bary.gather(1, pick[:, None, None].expand(n, 1, 2))[:, 0]
    chosen_phat = phat.gather(1, pick[:, None])[:, 0]
    w_out = torch.where(chosen_phat > 0,
                        w_sum / (c * chosen_phat.clamp_min(1e-20)), 0.0)
    return Reservoir(
        light_idx=chosen_light, bary=chosen_bary, w_sum=w_sum,
        m=torch.full((n,), float(c), dtype=torch.float32, device=w.device),
        w_out=w_out, p_hat=chosen_phat)


def visibility_pass(scene, sd, res: Reservoir, occlude_fn, hit_mask,
                    rad_all=None) -> Reservoir:
    """Zero the reservoirs whose chosen sample is occluded, and those of
    pixels that hit nothing. Every pixel's ray goes to the occluder, missed
    pixels included: the tiles' bounds and the sort see them all. While
    spans record, the rays sent and the live ones (a hit and a nonzero
    weight) are charged as a device counter, with no host wait."""
    if profiling.is_recording():
        live = hit_mask & (res.w_out > 0)
        profiling.count_restir_rays(torch.stack([
            torch.full((), live.numel(), dtype=torch.int64,
                       device=live.device), live.sum()]))
    _, wi, dist = _target_phat(scene, sd, res.light_idx, res.bary,
                               rad_all=rad_all)
    o = sd.position + sd.geo_normal * SHADOW_EPS
    occluded = occlude_fn(o, wi, SHADOW_EPS, dist - 2 * SHADOW_EPS)
    kill = occluded | ~hit_mask
    return res.replace(w_out=torch.where(kill, 0.0, res.w_out),
                       w_sum=torch.where(kill, 0.0, res.w_sum))


def volumetric_transmittance(scene, sd, res: Reservoir, volumes, draws,
                             hit_mask, rad_all=None) -> torch.Tensor:
    """(N,) Beer-Lambert transmittance of participating media along the
    winner's shadow segment, detached: applied once at shading, never
    folded into the reservoirs (it would compound through reuse). Always
    the 5-step Riemann estimator, one (N,) draw, as in the JAX package."""
    from ..volume import march as vmarch

    _, wi, dist = _target_phat(scene, sd, res.light_idx, res.bary,
                               rad_all=rad_all)
    o = sd.position + sd.geo_normal * SHADOW_EPS
    return vmarch.transmittance_only(
        volumes, o, wi, SHADOW_EPS,
        torch.where(hit_mask, dist - 2 * SHADOW_EPS, 0.0),
        uniforms=draws.uniform).detach()


def _combine(scene, sd, res_a: Reservoir, res_b: Reservoir, phat_b_here,
             draws, rad_all=None, unbiased_at=None) -> Reservoir:
    """Combine B into A at A's pixel. With unbiased_at=(pos_b, nrm_b, alb_b),
    B's own surface, the M denominator counts only the streams at whose
    surface the winner has a nonzero target pdf (the unbiased combine)."""
    w_a = res_a.p_hat * res_a.w_out * res_a.m
    w_b = phat_b_here * res_b.w_out * res_b.m
    w_sum = w_a + w_b
    u = draws.uniform(*w_sum.shape)
    pick_b = u * w_sum.clamp_min(1e-20) > w_a
    light = torch.where(pick_b, res_b.light_idx, res_a.light_idx)
    bary = torch.where(pick_b[:, None], res_b.bary, res_a.bary)
    phat = torch.where(pick_b, phat_b_here, res_a.p_hat)
    m = res_a.m + res_b.m
    if unbiased_at is None:
        denom_m = m
    else:
        pos_b, nrm_b, alb_b = unbiased_at
        phat_at_b, _, _ = _target_phat(
            scene, sd, light, bary, rad_all=rad_all, at_position=pos_b,
            at_normal=nrm_b, at_albedo_lum=alb_b)
        denom_m = res_a.m * (phat > 0) + res_b.m * (phat_at_b > 0)
    w_out = torch.where(
        phat > 0,
        w_sum / (denom_m.clamp_min(1e-6) * phat.clamp_min(1e-20)), 0.0)
    return Reservoir(light_idx=light, bary=bary, w_sum=w_sum, m=m,
                     w_out=w_out, p_hat=phat)


def sd_depth(sd) -> torch.Tensor:
    return vm.length(sd.position)  # radial depth proxy for similarity


def temporal_pass(scene, sd, res, state: RestirState, motion, cfg, width,
                  height, draws, rad_all=None) -> Reservoir:
    """Combine with the history reprojected through the motion vectors,
    behind the depth and normal gates, its M clamped to temporal_clamp
    times the current M."""
    n = res.m.shape[0]
    ids = torch.arange(n, device=res.m.device)
    px = (ids % width).to(torch.float32)
    py = (ids // width).to(torch.float32)
    # round half to even, as jnp.round
    prev_x = torch.round(px + motion[:, 0]).to(torch.int32)
    prev_y = torch.round(py + motion[:, 1]).to(torch.int32)
    inside = (prev_x >= 0) & (prev_x < width) & (prev_y >= 0) & (
        prev_y < height)
    prev_i = (prev_y * width + prev_x).clamp(0, n - 1).long()

    h = _map(lambda a: a[prev_i], state.reservoir)
    depth = sd_depth(sd)
    d_ok = ((state.prev_depth[prev_i] - depth).abs()
            <= cfg.depth_gate * depth.clamp_min(1e-3))
    n_ok = vm.dot(state.prev_normal[prev_i], sd.normal) >= cfg.normal_gate
    ok = inside & d_ok & n_ok & state.valid
    m_cap = cfg.temporal_clamp * res.m.clamp_min(1.0)
    scale = (m_cap / h.m.clamp_min(1e-6)).clamp_max(1.0)
    h = h.replace(m=h.m * scale, w_sum=h.w_sum * scale)
    h = _map(lambda a: torch.where(ok.reshape(ok.shape + (1,) * (a.ndim - 1)),
                                   a, torch.zeros_like(a)), h)
    phat_here, _, _ = _target_phat(scene, sd, h.light_idx, h.bary,
                                   rad_all=rad_all)
    phat_here = torch.where(ok, phat_here, 0.0)
    unbiased_at = None
    if not cfg.biased:
        unbiased_at = (state.prev_position[prev_i],
                       state.prev_normal[prev_i], state.prev_albedo[prev_i])
    return _combine(scene, sd, res, h, phat_here, draws, rad_all=rad_all,
                    unbiased_at=unbiased_at)


def spatial_pass(scene, sd, res, hit_mask, cfg, width, height, draws,
                 rad_all=None, halo=None) -> Reservoir:
    """spatial_iterations rounds of spatial_samples random neighbours within
    spatial_radius, combined behind the depth and normal gates; each round
    reads the previous round's reservoirs. Unbiased mode re-evaluates the
    winner at every contributing neighbour's surface.

    halo: a 1-D DeviceMesh (`parallel.shard`) whose ranks hold consecutive
    bands of `height` rows of one frame, this rank's given here. The
    gbuffer, and before every round the current reservoirs, are extended
    by band = min(spatial_radius, height) rows from each neighbour rank
    (`shard.exchange_rows`; zero rows with hit_mask False at the frame's
    edges, which the gates discard, as at the image border), and the
    round's draws are over that extended grid, width x (height + 2 band),
    as JAX's `ppermute` halo draws them. A neighbourhood reaches one rank
    only (ROADMAP C-19)."""
    if halo is not None and not hasattr(halo, "get_group"):
        raise TypeError("halo must be a torch DeviceMesh (parallel.shard."
                        f"make_mesh), not {type(halo).__name__}")
    s = cfg.spatial_samples
    if halo is not None:
        from ..parallel import shard

        band = min(cfg.spatial_radius, height)
        h_ext = height + 2 * band

        def ext(x):
            img = x.reshape((height, width) + x.shape[1:])
            top, bottom = shard.exchange_rows(img, band, halo)
            return torch.cat([top, img, bottom]).reshape(
                (-1,) + x.shape[1:])

        def interior(x):
            return x.reshape((h_ext, width) + x.shape[1:])[
                band:band + height].reshape((-1,) + x.shape[1:])

        pos, nrm, alb, hit = (ext(sd.position), ext(sd.normal),
                              ext(sd.base_color), ext(hit_mask))
    else:
        h_ext = height
        ext = interior = lambda x: x  # noqa: E731
        pos, nrm, alb, hit = sd.position, sd.normal, sd.base_color, hit_mask
    n = width * h_ext
    ids = torch.arange(n, dtype=torch.int32, device=pos.device)
    px, py = ids % width, ids // width
    depth_here = vm.length(pos)
    sd_here = types.SimpleNamespace(position=pos, normal=nrm, base_color=alb)
    # one packed row per neighbour gather: the reservoir's columns repack
    # each round, the gbuffer's once
    static_cols = [depth_here[:, None], nrm, hit.to(torch.float32)[:, None]]
    if not cfg.biased:
        static_cols += [pos, vm.luminance(alb)[:, None]]
    static_pack = torch.cat(static_cols, dim=1)

    for _ in range(cfg.spatial_iterations):
        # the neighbours' band is refreshed from their current reservoirs
        src = _map(ext, res)
        # light_idx rides bit-cast as float32 (small indices are denormals):
        # only copied and gathered, never computed on
        packed = torch.cat([
            src.light_idx.view(torch.float32)[:, None], src.bary,
            src.w_out[:, None], src.m[:, None], static_pack], dim=1)
        ang = draws.uniform(n, s) * 2 * math.pi
        rad = torch.sqrt(draws.uniform(n, s)) * cfg.spatial_radius
        # truncation toward zero, as astype(int32)
        nx = (px[:, None] + (torch.cos(ang) * rad).to(torch.int32)).clamp(
            0, width - 1)
        ny = (py[:, None] + (torch.sin(ang) * rad).to(torch.int32)).clamp(
            0, h_ext - 1)
        nbp = packed[(ny * width + nx).long()]                 # (N,S,K)
        nb_light = nbp[..., 0].view(torch.int32)
        nb_bary = nbp[..., 1:3]
        nb_w_out = nbp[..., 3]
        nb_m = nbp[..., 4]
        nrm_nb = nbp[..., 6:9]
        d_ok = (nbp[..., 5] - depth_here[:, None]).abs() <= (
            cfg.depth_gate * depth_here[:, None].clamp_min(1e-3))
        n_ok = vm.dot(nrm_nb, nrm[:, None, :]) >= cfg.normal_gate
        ok = d_ok & n_ok & hit[:, None] & (nbp[..., 9] > 0.5)   # (N,S)
        phat_nb, _, _ = _target_phat(scene, sd_here, nb_light, nb_bary,
                                     rad_all=rad_all)
        phat_nb = torch.where(ok, phat_nb, 0.0)
        w_nb = torch.where(ok, phat_nb * nb_w_out * nb_m, 0.0)
        m_nb = torch.where(ok, nb_m, 0.0)

        # categorical pick over {self} + S neighbours
        w_self = src.p_hat * src.w_out * src.m
        sums = _running_sums(torch.cat([w_self[:, None], w_nb], dim=1))
        w_sum = sums[-1]
        pick = _pick(sums, w_sum, draws.uniform(n, 1)[:, 0])
        best_light = torch.cat([src.light_idx[:, None], nb_light],
                               dim=1).gather(1, pick[:, None])[:, 0]
        best_bary = torch.cat([src.bary[:, None], nb_bary], dim=1).gather(
            1, pick[:, None, None].expand(n, 1, 2))[:, 0]
        best_phat = torch.cat([src.p_hat[:, None], phat_nb], dim=1).gather(
            1, pick[:, None])[:, 0]

        m_tot = src.m + m_nb.sum(1)
        if cfg.biased:
            denom_m = m_tot
        else:
            # the winner at the S neighbours' own surfaces
            phat_win_at_nb, _, _ = _target_phat(
                scene, sd_here, best_light[:, None].expand(n, s),
                best_bary[:, None, :].expand(n, s, 2), rad_all=rad_all,
                at_position=nbp[..., 10:13], at_normal=nrm_nb,
                at_albedo_lum=nbp[..., 13])
            denom_m = src.m * (best_phat > 0) + (
                m_nb * (torch.where(ok, phat_win_at_nb, 0.0) > 0)).sum(1)
        w_out = torch.where(
            best_phat > 0,
            w_sum / (denom_m.clamp_min(1e-6) * best_phat.clamp_min(1e-20)),
            0.0)
        res = _map(interior, Reservoir(
            light_idx=best_light, bary=best_bary, w_sum=w_sum, m=m_tot,
            w_out=w_out, p_hat=best_phat))
    return res


def shade(scene, sd, wo, res: Reservoir, eval_f, hit_mask, rad_all=None):
    """The reservoir's sample shaded into the DIRECT channel: f * L * G * W,
    (N,3). G and W carry no gradient; f and L do."""
    li = res.light_idx.clamp_min(0).long()
    prow = scene.lights.packed[li]
    p = (prow[:, 0:3] + res.bary[:, 0:1] * prow[:, 3:6]
         + res.bary[:, 1:2] * prow[:, 6:9])
    to_l = p - sd.position
    dist = vm.length(to_l).clamp_min(1e-5)
    wi = to_l / dist[:, None]
    cos_s = vm.dot(sd.normal, wi).clamp_min(0.0)
    cos_l = vm.dot(prow[:, 9:12], -wi).clamp_min(0.0)
    g = cos_s * cos_l / (dist * dist)
    rad = rad_all[li] if rad_all is not None else scene.light_radiance(li)
    f_val, _ = eval_f(sd, wo, wi)
    w = res.w_out.detach()
    scale = torch.where(hit_mask & (w > 0), g.detach() * w, 0.0)
    return f_val * rad * scale[:, None]


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------

class RestirDI:
    """Callable pipeline bound to (occlude_fn, eval_f, cfg, width, height),
    run by the wavefront frame at depth 0 into the DIRECT channel."""

    def __init__(self, occlude_fn, eval_f, cfg: RestirConfig, width: int,
                 height: int, halo=None):
        """halo: under a row-sharded mesh, the DeviceMesh (height is then
        this rank's rows); spatial reuse exchanges its seam bands
        (`spatial_pass`)."""
        self.occlude_fn = occlude_fn
        self.eval_f = eval_f
        self.cfg = cfg
        self.width = width
        self.height = height
        self.halo = halo

    def init_state(self, n: int, *,
                   device: torch.device | str) -> RestirState:
        return init_state(n, device=device)

    def __call__(self, scene, sd, wo, hit_mask, motion, state: RestirState,
                 draws, occlude_fn=None):
        """(color (N,3), new RestirState). occlude_fn overrides the bound
        occluder (the frame passes its own, sorted; dynamic scenes the
        current frame's)."""
        cfg = self.cfg
        occl = occlude_fn if occlude_fn is not None else self.occlude_fn
        with profiling.span("restir.cdf"):
            rad_all = nee_mod.all_light_radiance(scene)
            cdf, pdf = build_light_cdf(scene, rad_all)
            bags = fill_light_bags(cdf, cfg, draws)
        with profiling.span("restir.ris"):
            res = ris_primary(scene, sd, bags, pdf, cfg, self.width, draws,
                              rad_all=rad_all)
        if cfg.biased:
            # visibility reuse: occluded reservoirs are zeroed before reuse
            with profiling.span("restir.visibility"):
                res = visibility_pass(scene, sd, res, occl, hit_mask,
                                      rad_all=rad_all)
        if state is not None:
            with profiling.span("restir.temporal"):
                res = temporal_pass(scene, sd, res, state, motion, cfg,
                                    self.width, self.height, draws,
                                    rad_all=rad_all)
        with profiling.span("restir.spatial"):
            res = spatial_pass(scene, sd, res, hit_mask, cfg, self.width,
                               self.height, draws, rad_all=rad_all,
                               halo=self.halo)
        with profiling.span("restir.visibility"):
            res_final = visibility_pass(scene, sd, res, occl, hit_mask,
                                        rad_all=rad_all)
        with profiling.span("restir.shade"):
            color = shade(scene, sd, wo, res_final, self.eval_f, hit_mask,
                          rad_all=rad_all)
            if scene.volumes is not None:
                color = color * volumetric_transmittance(
                    scene, sd, res_final, scene.volumes, draws, hit_mask,
                    rad_all=rad_all)[:, None]
            new_state = RestirState(
                # biased mode carries the visibility-zeroed reservoirs
                # forward; unbiased keeps the pre-shading ones
                reservoir=res_final if cfg.biased else res,
                prev_depth=sd_depth(sd), prev_normal=sd.normal,
                prev_position=sd.position,
                prev_albedo=vm.luminance(sd.base_color),
                valid=torch.tensor(True, device=sd.position.device))
        return color, new_state
