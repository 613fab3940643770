"""Hit -> SurfaceData extraction: port of
`lumenrenderer_tpu/integrator/surface.py`.

Per ray this is one row gather from a per-triangle attribute table, and an
exact elementwise Möller–Trumbore against the gathered vertices: the tiled
intersector's key gives the winning triangle and only a quantized t. A
textured scene (an atlas past the white slot 0) adds the UV and mip-LOD
columns and one sample of each material's four textures (base color,
emissive, metal-rough, normal), trilinear with a ray footprint or bilinear
at level 0 without one; an untextured scene skips both.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import vecmath as vm
from ..core.struct import TensorStruct
from ..ops.row_gather import gather_rows
from ..scene.materials import GatheredMaterial
from ..scene.scene import SceneData
from ..scene.textures import sample_bilinear, sample_trilinear, take_rows


@dataclasses.dataclass(frozen=True)
class SurfaceData(TensorStruct):
    """Per-ray shading inputs, all (R,...)."""

    position: torch.Tensor     # (R,3)
    normal: torch.Tensor       # (R,3) shading normal, facing the ray's side
    geo_normal: torch.Tensor   # (R,3) geometric normal, facing the ray
    uv: torch.Tensor           # (R,2) zeros in an untextured scene
    base_color: torch.Tensor   # (R,3) textured
    emissive: torch.Tensor     # (R,3) textured
    metallic: torch.Tensor     # (R,)
    roughness: torch.Tensor    # (R,)
    alpha: torch.Tensor        # (R,) factor x base-color texture alpha
    mat_idx: torch.Tensor      # (R,) int32
    mat_rows: torch.Tensor     # (R,25) packed material parameters
    light_row: torch.Tensor    # (R,) int32 triangle -> light row, -1 = none
    tri_idx: torch.Tensor      # (R,) -1 = miss
    tangent: torch.Tensor      # (R,3)
    t: torch.Tensor            # (R,) exact hit distance, inf on miss
    valid: torch.Tensor        # (R,) bool
    is_emissive: torch.Tensor  # (R,) bool
    front_face: torch.Tensor   # (R,) bool


def _attr_table(scene: SceneData, with_uv: bool, with_tangent: bool):
    """Per-triangle attribute table (T, C) and its column map; with_uv adds
    the UV (6) and mip-LOD base (1) columns."""
    n = scene.tri_pos.shape[0]
    p0 = scene.tri_pos[:, 0]
    e1 = scene.tri_pos[:, 1] - p0
    e2 = scene.tri_pos[:, 2] - p0
    inst = scene.tri_inst.long()
    parts, cols = [], {}
    cursor = 0

    def add(name, arr):
        nonlocal cursor
        parts.append(arr)
        cols[name] = (cursor, cursor + arr.shape[1])
        cursor += arr.shape[1]

    add("geo_n", vm.normalize(vm.cross(e1, e2)))
    add("normals", scene.tri_normal.reshape(n, 9))
    if with_uv:
        add("uv", scene.tri_uv.reshape(n, 6))
    if with_tangent:
        add("tangent", scene.tri_tangent.reshape(n, 12))
    add("material", gather_rows(scene.materials.packed(),
                                 scene.tri_mat.long()))
    add("em_mode", scene.inst_emission_mode[inst][:, None].float())
    add("em_override", scene.inst_emission_override[inst])
    add("mat_idx", scene.tri_mat[:, None].float())      # exact below 2^24
    add("light_row", scene.lights.tri_to_light[:, None].float())
    add("p0", p0)
    add("e1", e1)
    add("e2", e2)
    if with_uv:
        add("lod", _lod_base(scene)[:, None])
    return torch.cat(parts, dim=1), cols


def _lod_base(scene: SceneData) -> torch.Tensor:
    """Per-triangle 0.5 * log2(UV area / world area): the triangle's UV
    density term of the footprint's mip LOD (each texture adds its own
    0.5 * log2(W * H) at sample time)."""
    e1 = scene.tri_pos[:, 1] - scene.tri_pos[:, 0]
    e2 = scene.tri_pos[:, 2] - scene.tri_pos[:, 0]
    a_world = 0.5 * torch.linalg.norm(vm.cross(e1, e2), dim=-1)
    duv1 = scene.tri_uv[:, 1] - scene.tri_uv[:, 0]
    duv2 = scene.tri_uv[:, 2] - scene.tri_uv[:, 0]
    a_uv = 0.5 * (duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]).abs()
    return 0.5 * torch.log2(a_uv.clamp_min(1e-20) / a_world.clamp_min(1e-20))


def extract_surface_data(scene: SceneData, ray_o: torch.Tensor,
                         ray_d: torch.Tensor, hit_tri: torch.Tensor,
                         mip_spread=None, mip_dist0=None,
                         detach_geom: bool = False,
                         with_tangent: bool = True) -> SurfaceData:
    """Shading data for hits `hit_tri` (-1 = miss). t, u and v are
    re-derived exactly from the triangle; an intersector supplies only the
    triangle. with_tangent=False skips the tangent columns (callers that
    prove no material is anisotropic and none has a normal map) and builds
    a frame from the normal.

    mip_spread, mip_dist0: the ray footprint that picks the mip level of a
    textured scene, mip_spread * (mip_dist0 + t) / sqrt(max(|cos|, 0.02)) at
    the hit (mip_spread the per-ray angular pixel spread, a scalar tensor;
    mip_dist0 (R,) the path length before this segment, or None); without
    mip_spread the textures are sampled bilinearly at level 0.
    detach_geom: the texture coordinates (UV and LOD) carry no gradient
    (the frame's detached sampling): near the det guard 1 / det reaches
    about 1e14."""
    valid = hit_tri >= 0
    textured = scene.textures.count > 1
    table, col = _attr_table(scene, textured, with_tangent)
    att = gather_rows(table, hit_tri.clamp_min(0).long())

    def c(name, lo=0, hi=None):
        s0, s1 = col[name]
        return att[:, s0 + lo:(s1 if hi is None else s0 + hi)]

    p0, e1, e2 = c("p0"), c("e1"), c("e2")
    pvec = vm.cross(ray_d, e2)
    det = vm.dot(e1, pvec)
    okd = det.abs() > 1e-14
    inv_det = torch.where(okd, 1.0 / torch.where(okd, det, 1.0),
                          torch.zeros_like(det))
    tvec = ray_o - p0
    qvec = vm.cross(tvec, e1)
    hit_u = vm.dot(tvec, pvec) * inv_det
    hit_v = vm.dot(ray_d, qvec) * inv_det
    t_exact = vm.dot(e2, qvec) * inv_det
    valid = valid & okd
    zero = torch.zeros_like(t_exact)
    hit_t = torch.where(valid, t_exact, torch.inf)
    # misses were gathered from triangle 0: mask their barycentrics
    hit_u = torch.where(valid, hit_u, zero)
    hit_v = torch.where(valid, hit_v, zero)
    w = (1.0 - hit_u - hit_v)[..., None]
    u_ = hit_u[..., None]
    v_ = hit_v[..., None]
    position = ray_o + torch.where(valid, hit_t, 1.0)[..., None] * ray_d
    normal = vm.normalize(w * c("normals", 0, 3) + u_ * c("normals", 3, 6)
                          + v_ * c("normals", 6, 9))
    if textured:
        uv = w * c("uv", 0, 2) + u_ * c("uv", 2, 4) + v_ * c("uv", 4, 6)
    else:
        uv = torch.zeros(hit_t.shape + (2,), device=ray_d.device)
    geo_normal = c("geo_n")
    if with_tangent:
        tangent = vm.normalize(w * c("tangent", 0, 3)
                               + u_ * c("tangent", 4, 7)
                               + v_ * c("tangent", 8, 11))
        handed = torch.sign(c("tangent", 3, 4)[:, 0] + 1e-8)
    else:
        # made on the device: an upload would make the host wait
        axes = torch.eye(3, device=ray_d.device)
        a = torch.where(geo_normal[:, 1:2].abs() < 0.9, axes[1:2], axes[0:1])
        tangent = vm.normalize(vm.cross(a, geo_normal))
        handed = None                    # a frame of handedness +1
    front_face = vm.dot(geo_normal, -ray_d) >= 0.0
    geo_normal = geo_normal * torch.where(front_face, 1.0, -1.0)[..., None]
    normal = torch.where(vm.dot(normal, geo_normal)[..., None] < 0.0,
                         -normal, normal)

    rows = c("material")
    g = GatheredMaterial(rows)
    mat_idx = c("mat_idx")[:, 0].to(torch.int32)
    light_row = torch.where(valid, c("light_row")[:, 0].to(torch.int32), -1)
    base_color, emissive, alpha = g.base_color, g.emissive, g.alpha_factor
    metallic, roughness = g.metallic, g.roughness
    if textured:
        mats = scene.materials
        # the four texture ids of each ray's material, sampled in one call:
        # base color, emissive, metal-rough, normal
        ids = take_rows(torch.stack([mats.base_color_tex, mats.emissive_tex,
                                     mats.metal_rough_tex, mats.normal_tex],
                                    -1), mat_idx)
        tex_uv = uv.detach() if detach_geom else uv
        if mip_spread is not None:
            cos_d = vm.dot(geo_normal, ray_d).abs()
            dist = hit_t if mip_dist0 is None else mip_dist0 + hit_t
            fp = mip_spread * dist / torch.sqrt(cos_d.clamp_min(0.02))
            fp = torch.where(valid, fp, 1.0)
            lod_uv = torch.log2(fp.clamp_min(1e-20)) + c("lod")[:, 0]
            if detach_geom:
                lod_uv = lod_uv.detach()
            tex = sample_trilinear(scene.textures, ids, tex_uv[:, None],
                                   lod_uv[:, None])
        else:
            tex = sample_bilinear(scene.textures, ids, tex_uv[:, None])
        base_color = base_color * tex[:, 0, :3]
        alpha = tex[:, 0, 3] * alpha       # glTF: factor x texture alpha
        emissive = emissive * tex[:, 1, :3]
        # glTF metal-rough: G is roughness, B is metallic
        roughness = roughness * tex[:, 2, 1]
        metallic = metallic * tex[:, 2, 2]
        # normal mapping in the tangent frame, with its handedness sign
        nm = tex[:, 3, :3] * 2.0 - 1.0
        bitan = vm.cross(normal, tangent)
        if handed is not None:
            bitan = bitan * handed[..., None]
        mapped = vm.normalize(nm[:, 0:1] * tangent + nm[:, 1:2] * bitan
                              + nm[:, 2:3] * normal)
        normal = torch.where((ids[:, 3] >= 0)[..., None], mapped, normal)
    # instance emission override (modes ENABLED, OVERRIDE, DISABLED)
    mode = c("em_mode")[:, 0]
    emissive = torch.where((mode == 2.0)[..., None], c("em_override"),
                           emissive)
    emissive = torch.where((mode == 0.0)[..., None],
                           torch.zeros_like(emissive), emissive)
    return SurfaceData(
        position=position, normal=normal, geo_normal=geo_normal, uv=uv,
        base_color=base_color, emissive=emissive, metallic=metallic,
        roughness=roughness, alpha=alpha, mat_idx=mat_idx,
        mat_rows=rows, light_row=light_row, tri_idx=hit_tri,
        tangent=tangent, t=hit_t, valid=valid,
        is_emissive=vm.luminance(emissive) > 0.0, front_face=front_face)
