"""The plain reference of ReSTIR DI: whole 1-spp frames at depth 1 (direct
light only), in plain PyTorch, float32, TF32 off, sharing no code with the
program.

It follows the published description: LumenRenderer's ReSTIR settings
(`LumenPT/src/Shaders/CppCommon/ReSTIRData.h`) and Bitterli et al.,
"Spatiotemporal reservoir resampling for real-time ray tracing with dynamic
direct lighting" (SIGGRAPH 2020). A frame is:

1. a jittered camera ray per pixel and its closest hit, every ray against
   every triangle; the emission seen there (the environment on a miss);
2. a CDF over the lights by power (luminance times area) and `num_bags`
   light bags of `bag_size` lights drawn from it;
3. resampled importance sampling (RIS) of `candidates` bag samples a pixel,
   each a uniform point on its light, weighted by the unshadowed target
   pdf p_hat = lum(albedo) / pi * lum(L) * cos_s * cos_l / d^2 over the
   source pdf (its bag selection pdf over the light's area), one pick a
   pixel; W = w_sum / (M p_hat);
4. the biased visibility pass: each pixel's shadow ray to its pick, every
   ray against every triangle; an occluded pick keeps its M and loses its
   weight;
5. temporal reuse: the history at the pixel the motion vector points to,
   behind the depth and normal gates, its M clamped to `temporal_clamp`
   times the new M, combined by one pick;
6. `spatial_iterations` rounds of spatial reuse: `spatial_samples`
   neighbours a round, uniform on the disk of `spatial_radius` pixels,
   behind the gates, combined with the pixel's own reservoir by one pick;
   M sums the streams combined (the biased combine);
7. the visibility pass again, then the winner shaded with Disney's f:
   f * L * cos_s * cos_l / d^2 * W. The history carries the reservoirs
   after this pass, and the gbuffer's depth and normal.

Departures from the published description, each the program's own:

- tile-candidate RIS: where the image divides by `bag_tile`, each
  `bag_tile` x `bag_tile` tile draws one bag and one set of candidates
  (slots and points), which all its pixels share; each pixel still weighs
  them at its own surface and makes its own pick. Elsewhere each pixel
  draws its own slots from its tile's bag (the bag of tile id
  ty * 1024 + tx, modulo 65536 draws).
- a point on a light is p0 + (1 - sqrt(u0)) e1 + u1 sqrt(u0) e2.
- missed pixels: their shadow rays go to the program's occluder too, but a
  miss's reservoir is zeroed whatever its ray meets, so they are not traced
  here; temporal reuse does not gate a miss (it reads the surface of
  triangle 0 at t = 1, as the program's gbuffer does), spatial reuse and
  shading do. Rays whose reservoir weight is already zero are not traced
  either: their outcome changes nothing.
- the depth gates compare distances from the world origin, |position|,
  within `depth_gate` of the pixel's own (at least 1e-3); the normal gates
  compare shading normals against `normal_gate`.
- neighbour offsets are truncated toward zero and clamped to the image.
- the motion vector is the hit's reprojection through the camera's
  view-projection matrix, less the pixel's centre, rounded half to even.

The primary hit is held to the program's documented contract rather than
taken from it: the program's closest hit is closest only to its visit
key's resolution (t's high bits, about 2^-9 of t), so where two surfaces
lie that close along a ray it may return the farther one, and a surface a
hair in front of a light panel then turns into a 1/d^2 firefly on one
side only. Given the program's primary-hit distances (its `depth` AOV),
every ray is still tested against every triangle: a pixel is off the
contract where one side misses and the other hits, where no triangle
lies at the program's distance (within ID_TOL of it), or where that
distance exceeds the closest hit's by more than KEY_RESOLUTION; the
frame then goes on from the triangle nearest the program's distance, so
the ReSTIR passes are compared on the same surfaces. Where a ray grazes
a triangle's edge the two tests round differently, so sound runs find a
few such pixels a frame, which the cell's limit allows. Without the
distances (`depths=None`) the closest hit is taken.

Random numbers replay the frame state's `torch.Generator`: seeded alike, on
the same device, `torch.rand` (float32) and `torch.randint` (int32) drawn
in the program's order and shapes: the (N,2) jitter; the bags' uniforms;
RIS's bag and slot integers, point uniforms and pick uniforms; the temporal
pick; per spatial round the angle, radius and pick uniforms.

Rays and pixels go in blocks of `rays_per_block`, so the reference fits
beside the program's freed state.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from perfbench.reference import pathtracer as pt

SHADOW_EPS = 1e-3
T_MAX = 1e9                  # the camera ray's reach
NEAR, FAR = 0.01, 1e6        # the view-projection's planes
TILE_IDS = 1 << 16           # per-pixel RIS: bag draws, one per tile id
KEY_RESOLUTION = 2.0 ** -8   # how far past the closest hit the program's
                             # may lie, relative (its key keeps ~2^-9)
ID_TOL = 1e-4                # a triangle lies at the program's distance


class Draws:
    """The frame state's generator, drawn as the program draws it."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def uniform(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.gen.device,
                          dtype=torch.float32)

    def randint(self, high: int, *shape):
        return torch.randint(0, high, shape, generator=self.gen,
                             device=self.gen.device, dtype=torch.int32)


def view_proj(spec, aspect: float) -> torch.Tensor:
    """The pinhole camera's row-major view-projection matrix (rows of the
    view: the unit right, up and forward axes; a perspective of the
    vertical field of view), formed in float32 on the host."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    eye = f32(spec.eye)
    _, cu, cv, cw = pt.camera_basis(spec.eye, spec.target, spec.fov_y_deg,
                                    aspect, "cpu")
    rot = torch.stack([pt.normalize(cu), pt.normalize(cv), pt.normalize(cw)])
    view = torch.eye(4, dtype=torch.float32)
    view[:3, :3] = rot
    view[:3, 3] = -(rot @ eye)
    f = float(1.0 / torch.tan(torch.deg2rad(f32(spec.fov_y_deg)) * 0.5))
    proj = torch.tensor(
        [[f / aspect, 0.0, 0.0, 0.0], [0.0, f, 0.0, 0.0],
         [0.0, 0.0, FAR / (FAR - NEAR), -FAR * NEAR / (FAR - NEAR)],
         [0.0, 0.0, 1.0, 0.0]], dtype=torch.float32)
    return proj @ view


class Lights:
    """The scene's emissive triangles, in triangle order, as sampling needs
    them: corner, edges, unit normal and area (formed in float32 on the
    host from the scene's arrays), radiance, and the power CDF and pdf."""

    def __init__(self, spec, scene: pt.Scene):
        tri = np.asarray(spec.tri_pos, np.float32)
        em = np.asarray(spec.materials["emissive"], np.float32)
        sel = np.nonzero(em[spec.tri_mat].max(-1) > 0.0)[0]
        p0, e1, e2 = tri[sel, 0], tri[sel, 1] - tri[sel, 0], \
            tri[sel, 2] - tri[sel, 0]
        cr = np.cross(e1, e2)
        area2 = np.linalg.norm(cr, axis=-1)
        f = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                      device=scene.device)
        self.p0, self.e1, self.e2 = f(p0), f(e1), f(e2)
        self.n = f(cr / np.maximum(area2[:, None], 1e-20))
        self.area = f(0.5 * area2)
        self.rad = scene.m["emissive"][torch.as_tensor(
            spec.tri_mat[sel], device=scene.device).long()]
        w = (pt.lum(self.rad) * self.area).clamp_min(0.0)
        if float(w.sum()) <= 0.0:
            w = torch.ones_like(w)
        cdf = torch.cumsum(w, 0)
        total = cdf[-1].clamp_min(1e-20)
        self.cdf, self.pdf = cdf / total, w / total

    @property
    def count(self) -> int:
        return self.area.shape[0]

    def point(self, li, bary):
        return (self.p0[li] + bary[..., 0:1] * self.e1[li]
                + bary[..., 1:2] * self.e2[li])


def target(lights: Lights, li, bary, pos, nrm, alb_lum):
    """Unshadowed target pdf of light samples (li, bary) at surfaces (pos,
    nrm, albedo luminance) broadcast against them (the samples' extra axes
    lead with the surfaces'), with the direction and distance: (p_hat, wi,
    dist)."""
    li = li.long()
    to_l = lights.point(li, bary) - pos
    dist = torch.sqrt(pt.dot(to_l, to_l).clamp_min(0.0)).clamp_min(1e-5)
    wi = to_l / dist[..., None]
    cos_s = pt.dot(nrm, wi).clamp_min(0.0)
    cos_l = pt.dot(lights.n[li], -wi).clamp_min(0.0)
    g = cos_s * cos_l / (dist * dist)
    return alb_lum / math.pi * pt.lum(lights.rad[li]) * g, wi, dist


def _running(w):
    """w[..., 0] + ... + w[..., j] for each j, added in order."""
    sums = [w[..., 0]]
    for j in range(1, w.shape[-1]):
        sums.append(sums[-1] + w[..., j])
    return sums


def _pick(sums, w_sum, u):
    """The first j whose running sum reaches u * w_sum (the last at most)."""
    thr = u * w_sum
    k = torch.zeros(thr.shape, dtype=torch.int64, device=thr.device)
    for s in sums:
        k += s < thr
    return k.clamp_max(len(sums) - 1)


class Frames:
    """Whole frames of the still camera, one a `next(draws)`, their history
    carried."""

    def __init__(self, spec, rcfg: Dict, restir: Dict, device,
                 rays_per_block: int):
        self.w, self.h = rcfg["width"], rcfg["height"]
        self.cfg = restir
        self.block = rays_per_block
        self.scene = pt.Scene(spec, device)
        self.lights = Lights(spec, self.scene)
        self.cam = pt.camera_basis(spec.eye, spec.target, spec.fov_y_deg,
                                   self.w / self.h, device)
        self.vp = view_proj(spec, self.w / self.h).to(device)
        self.device = device
        self.history = None
        self.off_contract = 0       # primary hits off the program's contract
        self.bsdf = pt.BSDFS[rcfg.get("bsdf", "disney")][0]

    # -- 1. primary hits --------------------------------------------------

    def _hits(self, o, d, depth):
        """Every ray against every triangle: (the closest hit's t, inf on a
        miss; the triangle whose t lies nearest `depth`, -1 on a miss; its
        distance from `depth`). The test is `pt.intersect`'s."""
        n, t = o.shape[0], self.scene.num_triangles
        closest = torch.full((n,), torch.inf, device=self.device)
        tri = torch.full((n,), -1, dtype=torch.long, device=self.device)
        gap = torch.full((n,), torch.inf, device=self.device)
        step = max(1, pt.PAIRS_PER_CHUNK // max(t, 1))
        for a in range(0, n, step):
            b = min(n, a + step)
            res = (pt._features(o[a:b], d[a:b]) @ self.scene.coef).view(
                -1, 4, t)
            det, un, vn, tn = res.unbind(1)
            sg = torch.sign(det)
            ad = det * sg
            us, vs, ts = un * sg, vn * sg, tn * sg
            hit = ((ad > 1e-12) & (us >= 0.0) & (vs >= 0.0)
                   & (us + vs <= ad) & (ts > pt.EPS * ad) & (ts <= T_MAX * ad))
            tt = torch.where(hit, ts / torch.where(hit, ad, 1.0), torch.inf)
            closest[a:b] = tt.amin(1)
            g, i = (tt - depth[a:b, None]).abs().min(1)
            tri[a:b] = torch.where(torch.isfinite(g), i, -1)
            gap[a:b] = g
        return closest, tri, gap

    def _primary(self, draws, depth=None):
        w, h, n = self.w, self.h, self.w * self.h
        eye, cu, cv, cw = self.cam
        j = draws.uniform(n, 2)
        pix = torch.arange(n, device=self.device)
        px = (pix % w).float()
        py = torch.div(pix, w, rounding_mode="floor").float()
        sx = ((px + j[:, 0]) / w) * 2.0 - 1.0
        sy = 1.0 - ((py + j[:, 1]) / h) * 2.0
        d = pt.normalize(sx[:, None] * cu[None] + sy[:, None] * cv[None]
                         + cw[None])
        o = eye[None].expand(n, 3)
        tri = torch.empty(n, dtype=torch.long, device=self.device)
        off = torch.zeros(n, dtype=torch.bool, device=self.device)
        for a in range(0, n, self.block):
            b = min(n, a + self.block)
            # without the program's distances, the hit nearest 0: the closest
            t_p = (torch.zeros(b - a, device=self.device) if depth is None
                   else depth[a:b])
            closest, near, gap = self._hits(o[a:b], d[a:b], t_p)
            tri[a:b] = near
            if depth is None:
                continue
            hit_p, hit_r = t_p > 0.0, torch.isfinite(closest)
            off[a:b] = (hit_p != hit_r) | (hit_p & hit_r & (
                (gap > ID_TOL * t_p) | (t_p > closest * (1 + KEY_RESOLUTION))))
            tri[a:b] = torch.where(hit_p, near, -1)
        self.off_contract += int(off.sum())
        s = pt.surface(self.scene, o, d, tri)
        s.alb_lum = pt.lum(s.p["base_color"])
        s.depth = torch.sqrt(pt.dot(s.position, s.position).clamp_min(0.0))
        return s, d

    def _motion(self, s):
        """Reprojection through the view-projection, less the pixel's
        centre; 0 where the hit is missing or behind the camera."""
        n = self.w * self.h
        hp = torch.cat([s.position, torch.ones_like(s.position[:, :1])], 1)
        clip = hp @ self.vp.T
        cw_ = clip[:, 3:4]
        ndc = clip[:, :2] / torch.where(cw_.abs() > 1e-8, cw_,
                                        torch.ones_like(cw_))
        prev_x = (ndc[:, 0] * 0.5 + 0.5) * self.w
        prev_y = (0.5 - ndc[:, 1] * 0.5) * self.h
        pix = torch.arange(n, device=self.device)
        mv = torch.stack([prev_x - ((pix % self.w).float() + 0.5),
                          prev_y - ((pix // self.w).float() + 0.5)], -1)
        ok = s.valid & (clip[:, 3] > 0.0)
        return torch.where(ok[:, None], mv, torch.zeros_like(mv))

    # -- 3. RIS ----------------------------------------------------------

    def _ris(self, s, bags, draws):
        c, bt, w, h = (self.cfg["candidates"], self.cfg["bag_tile"], self.w,
                       self.h)
        n = w * h
        L = self.lights
        if self.cfg["tile_candidates"] and w % bt == 0 and h % bt == 0:
            tx = w // bt
            t, p = (h // bt) * tx, bt * bt
            bag = draws.randint(self.cfg["num_bags"], t).long()
            slot = draws.randint(self.cfg["bag_size"], t, c).long()
            cand = bags[bag[:, None], slot][:, None, :]          # (T,1,C)
            u = draws.uniform(t, 1, c, 2)
            u_pick = draws.uniform(t, p, 1)[..., 0]              # (T,P)
            tiles = torch.arange(t, device=self.device)
            slots = torch.arange(p, device=self.device)
            # pixel of (tile, slot): tiles row-major, slots row-major
            pid = (((tiles // tx) * bt)[:, None] + (slots // bt)[None]) * w \
                + ((tiles % tx) * bt)[:, None] + (slots % bt)[None]
            rows = max(1, self.block // p)
        else:
            ids = torch.arange(n, device=self.device)
            tile = ((ids // w) // bt) * 1024 + (ids % w) // bt
            bag_of = draws.randint(self.cfg["num_bags"], TILE_IDS)
            bag = bag_of[tile % TILE_IDS].long()
            slot = draws.randint(self.cfg["bag_size"], n, c).long()
            cand = bags[bag[:, None], slot][:, None, :]          # (N,1,C)
            u = draws.uniform(n, c, 2)[:, None]                  # (N,1,C,2)
            u_pick = draws.uniform(n, 1)                          # (N,1)
            pid = ids[:, None]
            rows = self.block
        su = torch.sqrt(u[..., 0])
        bary = torch.stack([1.0 - su, u[..., 1] * su], -1)
        out = {k: torch.zeros(n, device=self.device)
               for k in ("w_sum", "w_out", "p_hat")}
        out["light"] = torch.zeros(n, dtype=torch.long, device=self.device)
        out["bary"] = torch.zeros((n, 2), device=self.device)
        for a in range(0, pid.shape[0], rows):
            b = min(pid.shape[0], a + rows)
            px = pid[a:b]                                          # (B,P)
            li, ba = cand[a:b], bary[a:b]                          # (B,1,C)
            p_src = L.pdf[li] / L.area[li].clamp_min(1e-12)
            phat, _, _ = target(L, li, ba, s.position[px][..., None, :],
                                s.normal[px][..., None, :],
                                s.alb_lum[px][..., None])        # (B,P,C)
            wgt = torch.where(p_src > 0, phat / p_src.clamp_min(1e-20), 0.0)
            w_sum = wgt.sum(-1)
            k = _pick(_running(wgt), w_sum, u_pick[a:b])[..., None]
            chosen = phat.gather(-1, k)[..., 0]
            out["light"][px] = li.expand(phat.shape).gather(-1, k)[..., 0]
            out["bary"][px] = ba.expand(phat.shape + (2,)).gather(
                2, k[..., None].expand(k.shape + (2,)))[:, :, 0]
            out["w_sum"][px] = w_sum
            out["p_hat"][px] = chosen
            out["w_out"][px] = torch.where(
                chosen > 0, w_sum / (c * chosen.clamp_min(1e-20)), 0.0)
        out["m"] = torch.full((n,), float(c), device=self.device)
        return out

    # -- 4, 7. visibility ------------------------------------------------

    def _visible(self, s, res):
        live = s.valid & (res["w_out"] > 0)
        rows = torch.nonzero(live)[:, 0]
        _, wi, dist = target(self.lights, res["light"][rows],
                             res["bary"][rows], s.position[rows],
                             s.normal[rows], s.alb_lum[rows])
        o = s.position[rows] + s.geo[rows] * SHADOW_EPS
        kill = ~s.valid
        for a in range(0, rows.shape[0], self.block):
            b = min(rows.shape[0], a + self.block)
            # any triangle within (SHADOW_EPS, dist - 2 SHADOW_EPS]
            occ = pt.intersect(self.scene, o[a:b], wi[a:b], SHADOW_EPS,
                               dist[a:b] - 2 * SHADOW_EPS, False)
            kill[rows[a:b][occ]] = True
        return dict(res, w_out=torch.where(kill, 0.0, res["w_out"]),
                    w_sum=torch.where(kill, 0.0, res["w_sum"]))

    # -- 5. temporal reuse -----------------------------------------------

    def _temporal(self, s, res, draws):
        n, w, h = self.w * self.h, self.w, self.h
        hist = self.history
        mv = self._motion(s)
        pix = torch.arange(n, device=self.device)
        qx = torch.round((pix % w).float() + mv[:, 0]).to(torch.int32)
        qy = torch.round((pix // w).float() + mv[:, 1]).to(torch.int32)
        inside = (qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
        q = (qy * w + qx).clamp(0, n - 1).long()
        if hist is None:
            ok = torch.zeros(n, dtype=torch.bool, device=self.device)
            prev = {k: torch.zeros_like(v) for k, v in res.items()}
        else:
            d_ok = ((hist["depth"][q] - s.depth).abs()
                    <= self.cfg["depth_gate"] * s.depth.clamp_min(1e-3))
            n_ok = (pt.dot(hist["normal"][q], s.normal)
                    >= self.cfg["normal_gate"])
            ok = inside & d_ok & n_ok
            prev = {k: hist["res"][k][q] for k in res}
        cap = self.cfg["temporal_clamp"] * res["m"].clamp_min(1.0)
        scale = (cap / prev["m"].clamp_min(1e-6)).clamp_max(1.0)
        prev["m"], prev["w_sum"] = prev["m"] * scale, prev["w_sum"] * scale
        prev = {k: torch.where(ok.view((-1,) + (1,) * (v.ndim - 1)), v,
                               torch.zeros_like(v)) for k, v in prev.items()}
        phat_b, _, _ = target(self.lights, prev["light"], prev["bary"],
                              s.position, s.normal, s.alb_lum)
        phat_b = torch.where(ok, phat_b, 0.0)
        w_a = res["p_hat"] * res["w_out"] * res["m"]
        w_b = phat_b * prev["w_out"] * prev["m"]
        w_sum = w_a + w_b
        take = draws.uniform(n) * w_sum.clamp_min(1e-20) > w_a
        phat = torch.where(take, phat_b, res["p_hat"])
        m = res["m"] + prev["m"]
        return {"light": torch.where(take, prev["light"], res["light"]),
                "bary": torch.where(take[:, None], prev["bary"],
                                    res["bary"]),
                "w_sum": w_sum, "m": m, "p_hat": phat,
                "w_out": torch.where(phat > 0, w_sum / (
                    m.clamp_min(1e-6) * phat.clamp_min(1e-20)), 0.0)}

    # -- 6. spatial reuse ------------------------------------------------

    def _spatial(self, s, res, draws):
        n, w, h = self.w * self.h, self.w, self.h
        k_s, radius = self.cfg["spatial_samples"], self.cfg["spatial_radius"]
        pix = torch.arange(n, dtype=torch.int32, device=self.device)
        px, py = pix % w, pix // w
        for _ in range(self.cfg["spatial_iterations"]):
            ang = draws.uniform(n, k_s) * 2 * math.pi
            rad = torch.sqrt(draws.uniform(n, k_s)) * radius
            u_pick = draws.uniform(n, 1)[:, 0]
            new = {k: torch.empty_like(v) for k, v in res.items()}
            for a in range(0, n, self.block):
                b = min(n, a + self.block)
                nx = (px[a:b, None] + (torch.cos(ang[a:b]) * rad[a:b])
                      .to(torch.int32)).clamp(0, w - 1)
                ny = (py[a:b, None] + (torch.sin(ang[a:b]) * rad[a:b])
                      .to(torch.int32)).clamp(0, h - 1)
                q = (ny * w + nx).long()                           # (B,S)
                dep = s.depth[a:b, None]
                ok = (((s.depth[q] - dep).abs()
                       <= self.cfg["depth_gate"] * dep.clamp_min(1e-3))
                      & (pt.dot(s.normal[q], s.normal[a:b, None])
                         >= self.cfg["normal_gate"])
                      & s.valid[a:b, None] & s.valid[q])
                nb = {k: v[q] for k, v in res.items()}
                phat_nb, _, _ = target(
                    self.lights, nb["light"], nb["bary"],
                    s.position[a:b, None], s.normal[a:b, None],
                    s.alb_lum[a:b, None])
                phat_nb = torch.where(ok, phat_nb, 0.0)
                w_nb = torch.where(ok, phat_nb * nb["w_out"] * nb["m"], 0.0)
                m_nb = torch.where(ok, nb["m"], 0.0)
                own = {k: v[a:b] for k, v in res.items()}
                w_own = own["p_hat"] * own["w_out"] * own["m"]
                sums = _running(torch.cat([w_own[:, None], w_nb], 1))
                k = _pick(sums, sums[-1], u_pick[a:b])[:, None]
                light = torch.cat([own["light"][:, None], nb["light"]], 1)
                bary = torch.cat([own["bary"][:, None], nb["bary"]], 1)
                phat = torch.cat([own["p_hat"][:, None], phat_nb], 1)
                best = phat.gather(1, k)[:, 0]
                m = own["m"] + m_nb.sum(1)
                new["light"][a:b] = light.gather(1, k)[:, 0]
                new["bary"][a:b] = bary.gather(
                    1, k[..., None].expand(-1, 1, 2))[:, 0]
                new["p_hat"][a:b] = best
                new["w_sum"][a:b] = sums[-1]
                new["m"][a:b] = m
                new["w_out"][a:b] = torch.where(best > 0, sums[-1] / (
                    m.clamp_min(1e-6) * best.clamp_min(1e-20)), 0.0)
            res = new
        return res

    # -- 7. shading ------------------------------------------------------

    def _shade(self, s, d, res):
        L = self.lights
        li = res["light"]
        to_l = L.point(li, res["bary"]) - s.position
        dist = torch.sqrt(pt.dot(to_l, to_l).clamp_min(0.0)).clamp_min(1e-5)
        wi = to_l / dist[:, None]
        g = (pt.dot(s.normal, wi).clamp_min(0.0)
             * pt.dot(L.n[li], -wi).clamp_min(0.0) / (dist * dist))
        f, _ = self.bsdf(s, -d, wi)
        scale = torch.where(s.valid & (res["w_out"] > 0), g * res["w_out"],
                            0.0)
        return f * L.rad[li] * scale[:, None]

    def next(self, draws: Draws, depth=None) -> torch.Tensor:
        """One frame's radiance (N,3) (from the program's primary-hit
        distances `depth` (N,), 0 on a miss, where given); the history moves
        on."""
        s, d = self._primary(draws, depth)
        out = (torch.where(~s.valid[:, None], self.scene.env[None], 0.0)
               + torch.where(s.valid[:, None], s.p["emissive"], 0.0))
        L = self.lights
        bags = torch.searchsorted(
            L.cdf, draws.uniform(self.cfg["num_bags"], self.cfg["bag_size"]),
            right=True).clamp(0, L.count - 1)
        res = self._ris(s, bags, draws)
        res = self._visible(s, res)
        res = self._temporal(s, res, draws)
        res = self._spatial(s, res, draws)
        res = self._visible(s, res)
        out = out + self._shade(s, d, res)
        self.history = {"res": res, "depth": s.depth, "normal": s.normal}
        return out


def accumulated(spec, rcfg: Dict, restir: Dict, seed: int, frames: int,
                device, rays_per_block: int, depths=None):
    """(The running mean (N,3) of `frames` frames from a state seeded with
    `seed`, the primary hits off the program's contract). `depths`: the
    program's primary-hit distances of each frame (its `depth` AOV), or
    None for the closest hits."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    draws = Draws(gen)
    run = Frames(spec, rcfg, restir, device, rays_per_block)
    acc = None
    with torch.no_grad():
        for f in range(frames):
            x = run.next(draws, None if depths is None else depths[f])
            acc = x if acc is None else (acc * float(f) + x) / (f + 1.0)
    return acc, run.off_contract


def compare(spec, rcfg: Dict, restir: Dict, seed: int, snapshot: torch.Tensor,
            depths, final: torch.Tensor,
            rays_per_block: int) -> Dict[str, float]:
    """The program's accumulated image after len(depths) frames
    (`snapshot`, (N,3)), whose primary-hit distances were `depths`, against
    the reference's: l1_rel, the sum of |program - reference| over the sum
    of |reference|, every channel of every pixel; hits_off_contract, the
    primary hits of those frames off the program's contract (module
    docstring); nonfinite, the values of the program's last accumulated
    image (`final`) that are not finite."""
    ref, off = accumulated(spec, rcfg, restir, seed, len(depths),
                           snapshot.device, rays_per_block, depths)
    gap = (snapshot - ref).abs().sum()
    return {"l1_rel": float(gap / ref.abs().sum().clamp_min(1e-30)),
            "hits_off_contract": float(off),
            "nonfinite": float((~torch.isfinite(final)).sum())}
