"""The plain reference: a path tracer in plain PyTorch, written from the
semantics the program's frame states and sharing no code with it.

One 1-spp sample per ray: camera ray with a random jitter, then per depth
the closest hit (every ray against every triangle), the surface at the hit,
emission (weighted by the power heuristic after a bounce), next-event
estimation with one light triangle picked by its luminance times area and
a shadow ray, and a Disney BSDF bounce (diffuse with retro-reflection and
subsurface, sheen, anisotropic GGX, GTR1 clearcoat, rough dielectric
transmission), Russian roulette from `rr_start_depth`. The random numbers
arrive in the frame's documented order: the (N,2) jitter, then per depth
NEE (N,3), BSDF (N,4) below the last depth and Russian roulette (N,) from
`rr_start_depth` below the last depth.

Gradients follow the estimator along the sampled paths: hits, directions,
pdfs, MIS and roulette weights carry none; the BSDF values, the emission
at hits and the lights' radiance carry them to the material table.

Float32 throughout, TF32 off.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

EPS = 1e-3                    # ray offset and t_min
PAIRS_PER_CHUNK = 1 << 25     # (ray, triangle) pairs a chunk of the test


# -- vectors (last axis holds xyz) -------------------------------------------

def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v):
    vv = (v * v).sum(-1, keepdim=True)
    return v * torch.where(vv > 1e-20, torch.rsqrt(vv.clamp_min(1e-20)),
                           torch.zeros_like(vv))


def lum(rgb):
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def lerp(a, b, t):
    return a + (b - a) * t


def reflect(d, n):
    return d - 2.0 * (d * n).sum(-1, keepdim=True) * n


def refract(d, n, eta):
    cos_i = -(d * n).sum(-1, keepdim=True)
    e = eta[..., None]
    sin2_t = e ** 2 * (1.0 - cos_i ** 2).clamp_min(0.0)
    tir = sin2_t[..., 0] >= 1.0
    cos_t = torch.sqrt((1.0 - sin2_t).clamp_min(0.0))
    refr = e * d + (e * cos_i - cos_t) * n
    return torch.where(tir[..., None], reflect(d, n), refr), tir


def power_heuristic(a, b):
    a2 = a * a
    return torch.where(a > 0.0, a2 / (a2 + b * b).clamp_min(1e-20),
                       torch.zeros_like(a2))


# -- the scene ---------------------------------------------------------------

class Scene:
    """Triangles, normals, materials and lights on `device`, from the
    benchmark's arrays. `params` replaces material columns (the fitted
    base_color and emissive, which may require grad)."""

    def __init__(self, spec, device, params: Dict[str, torch.Tensor] = None):
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                      device=device)
        self.device = device
        self.p0 = f(spec.tri_pos[:, 0])
        self.e1 = f(spec.tri_pos[:, 1]) - self.p0
        self.e2 = f(spec.tri_pos[:, 2]) - self.p0
        self.geo_n = normalize(cross(self.e1, self.e2))
        self.vn = f(spec.tri_normal)
        self.mat = torch.as_tensor(spec.tri_mat, device=device).long()
        self.m = {k: f(v) for k, v in spec.materials.items()}
        self.m.update(params or {})
        self.env = f(spec.env_radiance)
        n = cross(self.e1, self.e2)
        # the ray test's coefficients against features [d, o x d, o, 1]:
        # det = -d.N, u det = e2.(o x d) + d.(p0 x e2),
        # v det = -e1.(o x d) - d.(p0 x e1), t det = o.N - p0.N
        t = self.p0.shape[0]
        z3 = torch.zeros_like(n)
        cols = [
            torch.cat([-n, z3, z3, torch.zeros_like(n[:, :1])], 1),
            torch.cat([cross(self.p0, self.e2), self.e2, z3,
                       torch.zeros_like(n[:, :1])], 1),
            torch.cat([-cross(self.p0, self.e1), -self.e1, z3,
                       torch.zeros_like(n[:, :1])], 1),
            torch.cat([z3, z3, n, -dot(self.p0, n)[:, None]], 1),
        ]
        self.coef = torch.stack(cols, 1).permute(2, 1, 0).reshape(10, 4 * t)
        # lights: the triangles whose material the scene made emissive
        # (chosen once, at the scene's build, as the program does)
        em0 = f(spec.materials["emissive"])[self.mat]
        self.light_tri = torch.nonzero(em0.amax(-1) > 0.0)[:, 0]
        lt = self.light_tri
        cr = cross(self.e1[lt], self.e2[lt])
        a2 = torch.linalg.vector_norm(cr, dim=-1)
        self.l_n = cr / a2.clamp_min(1e-20)[:, None]
        self.l_area = 0.5 * a2
        self.tri_light = torch.full((t,), -1, dtype=torch.long, device=device)
        self.tri_light[lt] = torch.arange(lt.shape[0], device=device)

    @property
    def num_triangles(self) -> int:
        return self.p0.shape[0]

    def light_table(self):
        """(radiance (L,3) live, selection pdf (L,), cdf (L,))."""
        rad = self.m["emissive"][self.mat[self.light_tri]]
        w = (lum(rad.detach()) * self.l_area).clamp_min(0.0)
        if float(w.sum()) <= 0.0:
            w = torch.ones_like(w)
        cdf = torch.cumsum(w, 0)
        total = cdf[-1].clamp_min(1e-20)
        return rad, w / total, cdf / total


# -- the ray test ------------------------------------------------------------

def _features(o, d):
    return torch.cat([d, cross(o, d), o, torch.ones_like(o[:, :1])], 1)


def intersect(scene: Scene, o, d, t_min: float, t_max, closest: bool):
    """Every ray against every triangle, within (t_min, t_max] (t_max (R,);
    a ray with t_max < t_min is dead). closest: the nearest triangle's
    index (R,), -1 for none; else (R,) bool, any hit."""
    t = scene.num_triangles
    out = (torch.full(o.shape[:1], -1, dtype=torch.long, device=o.device)
           if closest else torch.zeros(o.shape[:1], dtype=torch.bool,
                                       device=o.device))
    live = torch.nonzero(t_max >= t_min)[:, 0]      # dead rays hit nothing
    step = max(1, PAIRS_PER_CHUNK // max(t, 1))
    for a in range(0, live.shape[0], step):
        rows = live[a:a + step]
        res = (_features(o[rows], d[rows]) @ scene.coef).view(-1, 4, t)
        det, un, vn, tn = res.unbind(1)
        s = torch.sign(det)
        ad = det * s
        us, vs, ts = un * s, vn * s, tn * s
        tx = t_max[rows, None]
        hit = ((ad > 1e-12) & (us >= 0.0) & (vs >= 0.0) & (us + vs <= ad)
               & (ts > t_min * ad) & (ts <= tx * ad))
        if closest:
            tt = torch.where(hit, ts / torch.where(hit, ad, 1.0), torch.inf)
            best, idx = tt.min(1)
            out[rows] = torch.where(torch.isfinite(best), idx, -1)
        else:
            out[rows] = hit.any(1)
    return out


# -- the surface at a hit ----------------------------------------------------

class Surface:
    pass


def surface(scene: Scene, o, d, tri):
    """The hit's exact t, barycentrics, position, normals, frame and
    material (Möller–Trumbore on the winning triangle)."""
    s = Surface()
    found = tri >= 0
    i = tri.clamp_min(0)
    p0, e1, e2 = scene.p0[i], scene.e1[i], scene.e2[i]
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    okd = det.abs() > 1e-14
    inv = torch.where(okd, 1.0 / torch.where(okd, det, 1.0), 0.0)
    tvec = o - p0
    qvec = cross(tvec, e1)
    u = dot(tvec, pvec) * inv
    v = dot(d, qvec) * inv
    t = dot(e2, qvec) * inv
    s.valid = found & okd
    s.t = torch.where(s.valid, t, torch.inf)
    u = torch.where(s.valid, u, 0.0)[:, None]
    v = torch.where(s.valid, v, 0.0)[:, None]
    s.position = o + torch.where(s.valid, t, 1.0)[:, None] * d
    vn = scene.vn[i]
    normal = normalize((1.0 - u - v) * vn[:, 0] + u * vn[:, 1] + v * vn[:, 2])
    geo = scene.geo_n[i]
    axis = torch.where(geo[:, 1:2].abs() < 0.9,
                       torch.tensor([[0.0, 1.0, 0.0]], device=o.device),
                       torch.tensor([[1.0, 0.0, 0.0]], device=o.device))
    s.tangent = normalize(cross(axis, geo))
    s.front = dot(geo, -d) >= 0.0
    s.geo = geo * torch.where(s.front, 1.0, -1.0)[:, None]
    s.normal = torch.where((dot(normal, s.geo) < 0.0)[:, None], -normal,
                           normal)
    mat = scene.mat[i]
    s.light_row = torch.where(s.valid, scene.tri_light[i], -1)
    s.p = {k: v[mat] for k, v in scene.m.items()}
    return s


# -- the Disney BSDF ---------------------------------------------------------

def _schlick(c):
    m = (1.0 - c).clamp(0.0, 1.0)
    return m * m * m * m * m


def _fresnel_dielectric(cos_i, eta):
    cos_i = cos_i.clamp(0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / (eta * eta).clamp_min(1e-8)
    cos_t = torch.sqrt((1.0 - sin2_t).clamp_min(0.0))
    r_par = (eta * cos_i - cos_t) / (eta * cos_i + cos_t).clamp_min(1e-8)
    r_perp = (cos_i - eta * cos_t) / (cos_i + eta * cos_t).clamp_min(1e-8)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(sin2_t >= 1.0, torch.ones_like(f), f)


def _d_aniso(h, ax, ay):
    e = (h[..., 0] / ax) ** 2 + (h[..., 1] / ay) ** 2 + h[..., 2] * h[..., 2]
    val = 1.0 / (math.pi * ax * ay * e * e).clamp_min(1e-12)
    return torch.where(h[..., 2] > 0.0, val, torch.zeros_like(val))


def _lambda_aniso(w, ax, ay):
    wz = w[..., 2].abs().clamp(1e-6, 1.0)
    a2t2 = ((ax * w[..., 0]) ** 2 + (ay * w[..., 1]) ** 2) / (wz * wz)
    return 0.5 * (-1.0 + torch.sqrt(1.0 + a2t2))


def _g2_aniso(wo, wi, ax, ay):
    return 1.0 / (1.0 + _lambda_aniso(wo, ax, ay) + _lambda_aniso(wi, ax, ay))


def _vndf_pdf(wo, h, ax, ay):
    g1 = 1.0 / (1.0 + _lambda_aniso(wo, ax, ay))
    val = (g1 * _d_aniso(h, ax, ay) * dot(wo, h).clamp_min(0.0)
           / wo[..., 2].clamp_min(1e-6))
    return torch.where(wo[..., 2] > 0.0, val, torch.zeros_like(val))


def _gtr1(nh, alpha):
    a2 = (alpha * alpha).clamp(1e-6, 1.0 - 1e-6)
    d = 1.0 + (a2 - 1.0) * nh * nh
    val = (a2 - 1.0) / (math.pi * torch.log(a2) * d).clamp_min(1e-12)
    return torch.where(nh > 0.0, val, torch.zeros_like(val))


def _g2_iso(cos_o, cos_i, alpha):
    def lam(c):
        c = c.abs().clamp(1e-6, 1.0)
        t2 = (1.0 - c * c).clamp_min(0.0) / (c * c)
        return 0.5 * (-1.0 + torch.sqrt(1.0 + alpha * alpha * t2))
    return 1.0 / (1.0 + lam(cos_o) + lam(cos_i))


def _f0(p):
    tint = p["base_color"] / lum(p["base_color"]).clamp_min(1e-8)[..., None]
    dielectric = 0.08 * p["specular"][..., None] * lerp(
        torch.ones_like(tint), tint, p["spec_tint"][..., None])
    return lerp(dielectric, p["base_color"], p["metallic"][..., None])


def _lobes(p):
    base = lum(p["base_color"]).clamp_min(1e-4)
    w_d = (1.0 - p["metallic"]) * (1.0 - p["spec_trans"]) * base
    w_s = lum(_f0(p)).clamp_min(0.08)
    w_c = 0.25 * p["clearcoat"]
    w_t = (1.0 - p["metallic"]) * p["spec_trans"] * base
    inv = 1.0 / (w_d + w_s + w_c + w_t).clamp_min(1e-8)
    return w_d * inv, w_s * inv, w_c * inv, w_t * inv


def _alphas(s):
    a = (s.p["roughness"] * s.p["roughness"]).clamp_min(1e-4)
    aspect = torch.sqrt(1.0 - 0.9 * s.p["anisotropic"].clamp(0.0, 1.0))
    return (a / aspect).clamp_min(1e-4), (a * aspect).clamp_min(1e-4)


def _frame(s):
    n = s.normal
    t_raw = s.tangent - n * dot(s.tangent, n)[..., None]
    len2 = dot(t_raw, t_raw)
    sg = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sg + n[..., 2])
    t_onb = torch.stack([1.0 + sg * n[..., 0] ** 2 * a,
                         sg * n[..., 0] * n[..., 1] * a, -sg * n[..., 0]], -1)
    t = torch.where((len2 > 1e-8)[..., None],
                    t_raw * torch.rsqrt(len2.clamp_min(1e-12))[..., None],
                    t_onb)
    return t, cross(n, t), n


def _local(w, f):
    return torch.stack([dot(w, f[0]), dot(w, f[1]), dot(w, f[2])], -1)


def _world(w, f):
    return w[..., 0:1] * f[0] + w[..., 1:2] * f[1] + w[..., 2:3] * f[2]


def _up(w):
    return torch.cat([w[..., :2], w[..., 2:].clamp_min(1e-6)], -1)


def _eta(s):
    return torch.where(s.front, 1.0 / s.p["ior"], s.p["ior"])


def _reflection(s, wo, wi):
    p = s.p
    cos_o = wo[..., 2].clamp_min(1e-6)
    side = wi[..., 2] > 1e-6
    cos_i = wi[..., 2].clamp_min(1e-6)
    h = normalize(wo + wi)
    h = torch.where(h[..., 2:3] < 0.0, -h, h)
    oh = dot(wo, h).clamp_min(0.0)
    nh = h[..., 2].clamp_min(0.0)
    ax, ay = _alphas(s)
    fl, fv = _schlick(cos_i), _schlick(cos_o)
    rr = 2.0 * p["roughness"] * oh * oh
    fd90 = 0.5 + rr
    f_d = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    fss = (1.0 + (rr - 1.0) * fl) * (1.0 + (rr - 1.0) * fv)
    ss = 1.25 * (fss * (1.0 / (cos_i + cos_o) - 0.5) + 0.5)
    dw = (1.0 - p["metallic"]) * (1.0 - p["spec_trans"])
    bc = p["base_color"]
    diffuse = bc / math.pi * (lerp(f_d, ss, p["subsurface"]) * dw)[..., None]
    tint = bc / lum(bc).clamp_min(1e-8)[..., None]
    sheen = ((p["sheen"] * dw)[..., None]
             * lerp(torch.ones_like(tint), tint, p["sheen_tint"][..., None])
             * _schlick(oh)[..., None])
    f0 = _f0(p)
    fres = f0 + (1.0 - f0) * _schlick(oh)[..., None]
    spec = fres * (_d_aniso(h, ax, ay) * _g2_aniso(wo, wi, ax, ay)
                   / (4.0 * cos_o * cos_i).clamp_min(1e-8))[..., None]
    cc_alpha = lerp(0.1, 0.001, p["clearcoat_gloss"])
    d_cc = _gtr1(nh, cc_alpha)
    g_cc = _g2_iso(cos_o, cos_i, torch.full_like(cc_alpha, 0.25))
    cc = ((0.25 * p["clearcoat"] * d_cc * g_cc
           * (0.04 + 0.96 * _schlick(oh))
           / (4.0 * cos_o * cos_i).clamp_min(1e-8))[..., None]
          * torch.ones_like(spec))
    zero = torch.zeros_like(cos_o)
    f = torch.where(side[..., None], diffuse + sheen + spec + cc,
                    torch.zeros_like(spec))
    pdfs = (torch.where(side, cos_i / math.pi, zero),
            torch.where(side, _vndf_pdf(wo, h, ax, ay)
                        / (4.0 * oh).clamp_min(1e-8), zero),
            torch.where(side, d_cc * nh / (4.0 * oh).clamp_min(1e-8), zero))
    return f, pdfs


def _transmission(s, wo, wi):
    p = s.p
    cos_o = wo[..., 2].clamp_min(1e-6)
    cos_i = wi[..., 2]
    side = cos_i < -1e-6
    eta = _eta(s)
    h = normalize(wo + wi * (1.0 / eta)[..., None])
    h = torch.where(h[..., 2:3] < 0.0, -h, h)
    oh, ih = dot(wo, h), dot(wi, h)
    ax, ay = _alphas(s)
    fr = _fresnel_dielectric(oh.abs(), 1.0 / eta)
    jac = (ih.abs() / ((oh + ih / eta) ** 2).clamp_min(1e-8)
           * (1.0 / (eta * eta)))
    ft = ((1.0 - fr) * _d_aniso(h, ax, ay) * _g2_aniso(wo, wi, ax, ay)
          * oh.abs() * jac / (cos_o * cos_i.abs()).clamp_min(1e-8))
    w = (1.0 - p["metallic"]) * p["spec_trans"]
    color = torch.sqrt(p["base_color"].clamp_min(1e-30))
    f = torch.where(side[..., None], (ft * w)[..., None] * color,
                    torch.zeros_like(color))
    pdf = torch.where(side, _vndf_pdf(wo, h, ax, ay) * jac * (1.0 - fr),
                      torch.zeros_like(ft))
    return f, pdf


def bsdf_eval(s, wo, wi):
    """(f (R,3) without the cosine, the sampling pdf (R,)), world space."""
    fr = _frame(s)
    wo_l, wi_l = _local(wo, fr), _local(wi, fr)
    ok = wo_l[..., 2] > 1e-6
    wo_l = _up(wo_l)
    f_r, (pd, ps, pc) = _reflection(s, wo_l, wi_l)
    f_t, pt = _transmission(s, wo_l, wi_l)
    ld, ls, lc, lt = _lobes(s.p)
    pdf = ld * pd + ls * ps + lc * pc + lt * pt
    return (torch.where(ok[..., None], f_r + f_t, torch.zeros_like(f_r)),
            torch.where(ok, pdf, torch.zeros_like(pdf)))


def _vndf_sample(wo, ax, ay, u):
    ax, ay = ax.clamp_min(1e-4)[..., None], ay.clamp_min(1e-4)[..., None]
    vh = normalize(wo * torch.cat([ax, ay, torch.ones_like(ax)], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1 = (torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(lensq)], -1)
          * torch.rsqrt(lensq.clamp_min(1e-7))[..., None])
    t1 = torch.where((lensq > 1e-7)[..., None], t1,
                     torch.tensor([1.0, 0.0, 0.0], device=wo.device)
                     .expand_as(vh))
    t2 = cross(vh, t1)
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    p1, p2 = r * torch.cos(phi), r * torch.sin(phi)
    sv = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - sv) * torch.sqrt((1.0 - p1 ** 2).clamp_min(0.0)) + sv * p2
    p3 = torch.sqrt((1.0 - p1 ** 2 - p2 ** 2).clamp_min(0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    return normalize(torch.stack([ax[..., 0] * nh[..., 0],
                                  ay[..., 0] * nh[..., 1],
                                  nh[..., 2].clamp_min(0.0)], -1))


def bsdf_sample(s, wo, u):
    """u (R,4): direction (2), lobe, Fresnel. (wi, f, pdf, is_specular)."""
    p = s.p
    fr = _frame(s)
    wo_l = _up(_local(wo, fr))
    ld, ls, lc, lt = _lobes(p)
    sel = u[..., 2]
    c1 = ld
    c2 = c1 + ls
    c3 = c2 + lc
    pick_d = sel < c1
    pick_s = (sel >= c1) & (sel < c2)
    pick_c = (sel >= c2) & (sel < c3)
    pick_t = sel >= c3
    u2 = u[..., :2]
    r = torch.sqrt(u2[..., 0])
    phi = 2.0 * math.pi * u2[..., 1]
    wi_d = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.sqrt((1.0 - u2[..., 0]).clamp_min(0.0))], -1)
    ax, ay = _alphas(s)
    m_s = _vndf_sample(wo_l, ax, ay, u2)
    wi_s = reflect(-wo_l, m_s)
    cc_alpha = lerp(0.1, 0.001, p["clearcoat_gloss"])
    a2 = (cc_alpha * cc_alpha).clamp(1e-6, 1.0 - 1e-6)
    cos2 = (1.0 - torch.pow(a2, 1.0 - u2[..., 0])) / (1.0 - a2)
    ct = torch.sqrt(cos2.clamp(0.0, 1.0))
    st = torch.sqrt((1.0 - cos2).clamp_min(0.0))
    m_c = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
    wi_c = reflect(-wo_l, m_c)
    eta = _eta(s)
    f_r = _fresnel_dielectric(dot(wo_l, m_s).abs(), 1.0 / eta)
    refr, tir = refract(-wo_l, m_s, eta)
    wi_t = torch.where(((u[..., 3] < f_r) | tir)[..., None],
                       reflect(-wo_l, m_s), normalize(refr))
    wi_l = torch.where(pick_d[..., None], wi_d,
                       torch.where(pick_s[..., None], wi_s,
                                   torch.where(pick_c[..., None], wi_c,
                                               wi_t))).detach()
    wi = _world(wi_l, fr)
    f, pdf = bsdf_eval(s, wo, wi)
    h = normalize(wo_l + wi_l)
    h = torch.where(h[..., 2:3] < 0.0, -h, h)
    oh = dot(wo_l, h).clamp_min(0.0)
    extra = _vndf_pdf(wo_l, h, ax, ay) / (4.0 * oh).clamp_min(1e-8)
    pdf = pdf + torch.where(wi_l[..., 2] > 0.0, lt * f_r * extra,
                            torch.zeros_like(pdf))
    spec = (pick_s | pick_c | pick_t) & (p["roughness"] < 0.08)
    return wi, f, pdf, spec


# -- the Lambert BRDF --------------------------------------------------------

def lambert_eval(s, wo, wi):
    cos_i = dot(s.normal, wi)
    ok = (cos_i > 0.0) & (dot(s.normal, wo) > 0.0)
    bc = s.p["base_color"]
    return (torch.where(ok[..., None], bc / math.pi, torch.zeros_like(bc)),
            torch.where(ok, cos_i.clamp_min(0.0) / math.pi,
                        torch.zeros_like(cos_i)))


def lambert_sample(s, wo, u):
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                         torch.sqrt((1.0 - u[..., 0]).clamp_min(0.0))], -1)
    n = s.normal
    sg = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sg + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sg * n[..., 0] ** 2 * a, sg * b, -sg * n[..., 0]],
                    -1)
    bt = torch.stack([b, sg + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    wi = _world(local, (t, bt, n))
    f, pdf = lambert_eval(s, wo, wi)
    return wi, f, pdf, torch.zeros_like(pdf, dtype=torch.bool)


BSDFS = {"disney": (bsdf_eval, bsdf_sample),
         "lambert": (lambert_eval, lambert_sample)}


# -- the frame ---------------------------------------------------------------

def draw_shapes(n: int, cfg: Dict) -> List[tuple]:
    """The shapes of one frame's draws, in the order it makes them."""
    max_depth = cfg["max_depth"]
    rr_start = cfg.get("rr_start_depth", 2)
    nee = cfg.get("light_strategy", "mis") in ("nee", "mis")
    shapes = [(n, 2)]
    for depth in range(max_depth):
        if nee:
            shapes.append((n, 3))
        if depth + 1 < max_depth:
            shapes.append((n, 4))
            if depth >= rr_start:
                shapes.append((n,))
    return shapes


def camera_basis(eye, target, fov_y_deg: float, aspect: float, device):
    """(eye, u, v, w) of a pinhole camera: u right * tan(fov/2) * aspect,
    v up * tan(fov/2), w forward."""
    f = lambda x: torch.as_tensor(x, dtype=torch.float32)
    eye, target = f(eye), f(target)
    w = normalize(target - eye)
    u = normalize(cross(w, f((0.0, 1.0, 0.0))))
    v = cross(u, w)
    th = torch.tan(torch.deg2rad(f(fov_y_deg)) * 0.5)
    return tuple(x.to(device) for x in (eye, u * th * aspect, v * th, w))


def _next_event(scene: Scene, s, hit, wo, u3, rad, sel_pdf, cdf, mis: bool,
                evaluate=bsdf_eval):
    """One light sample's contribution (R,3) before the throughput: a light
    picked from the CDF, a uniform point on it, the BSDF, the shadow ray."""
    lt = scene.light_tri
    li = torch.searchsorted(cdf, u3[:, 0].contiguous()).clamp(
        0, cdf.shape[0] - 1)
    su = torch.sqrt(u3[:, 1])
    b1 = u3[:, 2] * su
    b2 = 1.0 - (1.0 - su) - b1
    tri = lt[li]
    point = (scene.p0[tri] + b1[:, None] * scene.e1[tri]
             + b2[:, None] * scene.e2[tri])
    to_l = point - s.position
    dist = torch.sqrt(dot(to_l, to_l).clamp_min(0.0))
    wi = to_l / dist.clamp_min(1e-8)[:, None]
    cos_light = dot(scene.l_n[li], -wi)
    area = scene.l_area[li]
    l_ok = ((cos_light > 1e-6) & (area > 1e-12) & (dist > 1e-5)
            & (sel_pdf[li] > 0.0))
    pdf_sa = (sel_pdf[li] / area.clamp_min(1e-12) * dist * dist
              / cos_light.clamp_min(0.0).clamp_min(1e-6))
    cos_s = dot(s.normal, wi)
    f, bpdf = evaluate(s, wo, wi)
    ok = (hit & l_ok & (cos_s > 0.0) & (pdf_sa > 1e-12)
          & (lum(rad[li]) > 0.0))
    w = power_heuristic(pdf_sa, bpdf).detach() if mis else 1.0
    so = s.position + s.geo * EPS
    occ = intersect(scene, so.detach(), wi.detach(), EPS,
                    torch.where(ok, dist - 2.0 * EPS, -1.0).detach(), False)
    scale = torch.where(ok & ~occ, cos_s.clamp_min(0.0) * w
                        / pdf_sa.clamp_min(1e-12), 0.0).detach()
    return f * rad[li] * scale[:, None]


def radiance(scene: Scene, cam, width: int, height: int, pixels,
             draws: Sequence[torch.Tensor], cfg: Dict, t_max_cam=1e9):
    """One sample's radiance (R,3) for each entry of `pixels` (R,) (global
    pixel ids), with `draws` the frame's draws at those rows, in order."""
    it = iter(draws)
    dev = pixels.device
    n = pixels.shape[0]
    max_depth = cfg["max_depth"]
    rr_start, rr_min = cfg.get("rr_start_depth", 2), cfg.get("rr_min_prob",
                                                             0.05)
    strategy = cfg.get("light_strategy", "mis")
    disney = cfg.get("bsdf", "disney") == "disney"
    evaluate, sample = BSDFS[cfg.get("bsdf", "disney")]
    eye, cu, cv, cw = cam
    j = next(it)
    px = (pixels % width).float()
    py = torch.div(pixels, width, rounding_mode="floor").float()
    sx = ((px + j[:, 0]) / width) * 2.0 - 1.0
    sy = 1.0 - ((py + j[:, 1]) / height) * 2.0
    d = normalize(sx[:, None] * cu[None] + sy[:, None] * cv[None] + cw[None])
    o = eye[None].expand(n, 3)
    rad, sel_pdf, cdf = scene.light_table()
    thr = torch.ones((n, 3), device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.full((n,), torch.inf, device=dev)
    prev_spec = torch.ones(n, dtype=torch.bool, device=dev)
    beer = torch.zeros((n, 3), device=dev)
    out = torch.zeros((n, 3), device=dev)
    for depth in range(max_depth):
        t_max = torch.where(alive, torch.full_like(prev_pdf, t_max_cam), -1.0)
        tri = intersect(scene, o.detach(), d.detach(), EPS, t_max, True)
        s = surface(scene, o, d, tri)
        hit = s.valid & alive
        wo = -d
        if disney and depth > 0:
            seg = torch.where(s.valid, s.t.clamp_max(1e6), 0.0)
            thr = thr * torch.exp(-beer * seg[:, None])
        out = out + torch.where((alive & ~s.valid)[:, None],
                                thr * scene.env[None], 0.0)
        em = thr * s.p["emissive"]
        if depth == 0 or strategy == "bsdf":
            out = out + torch.where(hit[:, None], em, 0.0)
        elif strategy == "mis":
            row = s.light_row.clamp_min(0)
            cos_l = dot(scene.l_n[row], -d).clamp_min(0.0)
            lpdf = (sel_pdf[row] / scene.l_area[row].clamp_min(1e-12)
                    * s.t * s.t / cos_l.clamp_min(1e-6))
            lpdf = torch.where((s.light_row >= 0) & (cos_l > 1e-6), lpdf,
                               torch.zeros_like(lpdf))
            w = torch.where(prev_spec, 1.0, power_heuristic(prev_pdf, lpdf))
            out = out + em * torch.where(hit, w, 0.0)[:, None]
        if strategy in ("nee", "mis"):
            out = out + thr * _next_event(scene, s, hit, wo, next(it), rad,
                                          sel_pdf, cdf, strategy == "mis",
                                          evaluate)
        if depth + 1 >= max_depth:
            break
        wi, f, pdf, spec = sample(s, wo, next(it))
        cos_i = dot(s.normal, wi).abs()
        ok = hit & (pdf > 1e-9) & torch.isfinite(wi).all(-1)
        new = thr * f * (cos_i / pdf.clamp_min(1e-9)).detach()[:, None]
        new = torch.where(ok[:, None], new, 0.0)
        if depth >= rr_start:
            p_live = new.detach().amax(-1).clamp(rr_min, 1.0)
            live = next(it) < p_live
            new = torch.where(live[:, None], new / p_live[:, None], 0.0)
            ok = ok & live
        side = torch.sign(dot(s.geo, wi))[:, None]
        o = torch.where(ok[:, None], s.position + s.geo * side * EPS, o)
        d = torch.where(ok[:, None], wi, d)
        thr = new
        prev_pdf = pdf.detach()
        prev_spec = spec
        if disney:
            crossing = ok & (dot(s.geo, wi) < 0.0)
            sigma = -torch.log(s.p["transmittance"].clamp(1e-6, 1.0))
            beer = torch.where((crossing & s.front)[:, None], sigma.detach(),
                               beer)
            beer = torch.where((crossing & ~s.front)[:, None], 0.0, beer)
        alive = ok & (thr.detach().amax(-1) > 0.0)
    return out
