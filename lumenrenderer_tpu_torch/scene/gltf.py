"""glTF 2.0 scene loader: port of `lumenrenderer_tpu/scene/gltf.py`.

numpy only (json + struct): .gltf and .glb; external, embedded and
data-URI buffers and images; pbrMetallicRoughness materials with the
KHR_materials_emissive_strength, _ior and _transmission extensions,
alphaMode, alphaCutoff and doubleSided; the four texture slots; node TRS
and matrix hierarchies; index generation for unindexed primitives. It
fills a host `SceneBuilder`, which flattens the instances, extracts the
lights and packs the atlas.

PNG images (8-bit, not interlaced, colour types 0, 2, 3, 4 and 6) are
decoded here with zlib and numpy, to what Pillow's
`Image.open(...).convert("RGBA")` gives; other images need Pillow, and
without it the loader raises rather than drop the texture.
"""
from __future__ import annotations

import base64
import io
import json
import os
import struct
import zlib
from typing import Dict, List, Optional

import numpy as np

from .geometry import EmissionMode, InstanceHost, MeshHost
from .materials import MaterialSpec
from .scene import SceneBuilder

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# bytes per pixel of each 8-bit colour type: grey, RGB, palette, grey +
# alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _load_glb(data: bytes):
    magic, version, length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    offset = 12
    doc = None
    bin_chunk = b""
    while offset < length:
        clen, ctype = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset: offset + clen]
        offset += clen
        if ctype == 0x4E4F534A:  # JSON
            doc = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:  # BIN
            bin_chunk = chunk
    return doc, bin_chunk


def _read_uri(uri: str, base_dir: str) -> bytes:
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    with open(os.path.join(base_dir, uri), "rb") as f:
        return f.read()


def _read_buffer(buf: dict, base_dir: str, glb_bin: bytes) -> bytes:
    uri = buf.get("uri")
    return glb_bin if uri is None else _read_uri(uri, base_dir)


def _accessor(doc, buffers, idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    n = acc["count"]
    ncomp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    itemsize = np.dtype(dtype).itemsize
    if "bufferView" not in acc:
        out = np.zeros((n, ncomp), dtype)
    else:
        bv = doc["bufferViews"][acc["bufferView"]]
        data = buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride") or ncomp * itemsize
        raw = np.frombuffer(data, np.uint8)
        rows = np.empty((n, ncomp * itemsize), np.uint8)
        for i in range(ncomp * itemsize):
            rows[:, i] = raw[start + i: start + i + (n - 1) * stride + 1:
                             stride]
        out = rows.view(dtype).reshape(n, ncomp)
    sp = acc.get("sparse")
    if sp:
        out = out.copy()
        cnt = sp["count"]
        iv = sp["indices"]
        bv = doc["bufferViews"][iv["bufferView"]]
        ids = np.frombuffer(
            buffers[bv["buffer"]], _COMPONENT_DTYPES[iv["componentType"]],
            cnt, bv.get("byteOffset", 0) + iv.get("byteOffset", 0))
        vv = sp["values"]
        bv2 = doc["bufferViews"][vv["bufferView"]]
        vals = np.frombuffer(
            buffers[bv2["buffer"]], dtype, cnt * ncomp,
            bv2.get("byteOffset", 0) + vv.get("byteOffset", 0),
        ).reshape(cnt, ncomp)
        out[ids] = vals
    if acc.get("normalized") and dtype != np.float32:
        out = out.astype(np.float32) / np.iinfo(dtype).max
    return out


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        # column-major in the file
        return np.array(node["matrix"], np.float32).reshape(4, 4).T
    t = np.array(node.get("translation", [0, 0, 0]), np.float32)
    q = np.array(node.get("rotation", [0, 0, 0, 1]), np.float32)  # xyzw
    s = np.array(node.get("scale", [1, 1, 1]), np.float32)
    x, y, z, w = q
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = rot * s[None, :]
    m[:3, 3] = t
    return m


# -- images ------------------------------------------------------------------

def _paeth(a, b, c):
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo PNG's per-row filters. data (H,W,bpp) uint8 filtered bytes,
    filters (H,) the row filter types (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth) -> (H,W,bpp) uint8."""
    h, w, bpp = data.shape
    if (filters > 4).any():
        raise ValueError(f"bad PNG filter type {int(filters.max())}")
    if not (filters >= 3).any():
        # None, Sub and Up: a row at a time
        out = data.copy()
        for y in range(h):
            if filters[y] == 1:
                out[y] = np.cumsum(data[y], axis=0, dtype=np.uint8)
            elif filters[y] == 2 and y > 0:
                out[y] = data[y] + out[y - 1]
        return out
    # Average and Paeth need the pixel to the left: sweep the anti-diagonals
    # x + y = d, whose pixels depend only on earlier ones. `dec` has a zero
    # row and column in front, so dec[y + 1, x + 1] is pixel (y, x)
    dec = np.zeros((h + 1, w + 1, bpp), np.int32)
    raw = data.astype(np.int32)
    ftype = filters.astype(np.int32)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        f = ftype[ys][:, None]
        a = dec[ys + 1, xs]          # left
        b = dec[ys, xs + 1]          # up
        c = dec[ys, xs]              # up-left
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
        dec[ys + 1, xs + 1] = (raw[ys, xs] + pred) & 0xFF
    return dec[1:, 1:].astype(np.uint8)


def decode_png(raw: bytes) -> Optional[np.ndarray]:
    """An 8-bit, non-interlaced PNG of colour type 0, 2, 3, 4 or 6 as
    (H,W,4) uint8 RGBA, as Pillow's convert("RGBA") gives it (a tRNS chunk
    makes the grey or RGB key transparent, or gives palette entries their
    alpha). None for other PNGs (bit depths other than 8, interlacing)."""
    if raw[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, plte, trns, hdr = 8, [], None, None, None
    while pos + 8 <= len(raw):
        length, tag = struct.unpack_from(">I4s", raw, pos)
        body = raw[pos + 8: pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = body
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or ctype not in _PNG_CHANNELS:
        return None
    bpp = _PNG_CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[: h * (1 + w * bpp)].reshape(h, 1 + w * bpp)
    px = _unfilter(rows[:, 1:].reshape(h, w, bpp), rows[:, 0])
    if ctype == 3:
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        entries = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        pal[: len(entries), :3] = entries
        if trns is not None:
            pal[: len(trns), 3] = np.frombuffer(trns, np.uint8)
        return pal[px[..., 0]]
    grey = ctype in (0, 4)
    out = np.empty((h, w, 4), np.uint8)
    out[..., :3] = px[..., :1] if grey else px[..., :3]
    out[..., 3] = px[..., -1] if ctype in (4, 6) else 255
    if trns is not None and ctype in (0, 2):
        # the transparent colour: 16-bit samples, the low byte at 8 bits
        key = np.frombuffer(trns, ">u2").astype(np.uint8)
        out[..., 3] = np.where((px == key).all(-1), 0, 255)
    return out


def _image_format(raw: bytes) -> str:
    if raw[:8] == PNG_SIGNATURE:
        return "PNG"
    if raw[:3] == b"\xff\xd8\xff":
        return "JPEG"
    return f"unknown (first bytes {raw[:8]!r})"


def decode_image(raw: bytes) -> np.ndarray:
    """An encoded image as (H,W,4) uint8 RGBA: PNG decoded here, any other
    format by Pillow when it is installed; else NotImplementedError naming
    the format."""
    fmt = _image_format(raw)
    if fmt == "PNG":
        img = decode_png(raw)
        if img is not None:
            return img
        fmt = "PNG (16-bit, sub-byte or interlaced)"
    try:
        from PIL import Image
    except ImportError:
        raise NotImplementedError(
            f"image format {fmt} needs Pillow, which is not installed; the "
            "loader decodes 8-bit non-interlaced PNG itself") from None
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"), np.uint8)


def _load_image(doc, buffers, base_dir: str, img_idx: int) -> np.ndarray:
    img = doc["images"][img_idx]
    if "uri" in img:
        raw = _read_uri(img["uri"], base_dir)
    else:
        bv = doc["bufferViews"][img["bufferView"]]
        off = bv.get("byteOffset", 0)
        raw = buffers[bv["buffer"]][off: off + bv["byteLength"]]
    return decode_image(raw)


# -- the document ------------------------------------------------------------

def load_gltf(path: str,
              builder: Optional[SceneBuilder] = None) -> SceneBuilder:
    """Load a .gltf/.glb into a SceneBuilder, instancing the default scene's
    node hierarchy."""
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
        data = f.read()
    if path.endswith(".glb") or data[:4] == b"glTF":
        doc, glb_bin = _load_glb(data)
    else:
        doc, glb_bin = json.loads(data.decode("utf-8")), b""
    buffers = [_read_buffer(b, base_dir, glb_bin)
               for b in doc.get("buffers", [])]
    b = builder or SceneBuilder()

    # textures: texture -> image -> atlas id
    tex_ids: Dict[int, int] = {}
    for ti, tex in enumerate(doc.get("textures", [])):
        src = tex.get("source")
        if src is not None:
            tex_ids[ti] = b.add_texture(
                _load_image(doc, buffers, base_dir, src))

    def tid(info) -> int:
        if not info:
            return -1
        return tex_ids.get(info.get("index", -1), -1)

    # materials: pbrMetallicRoughness -> MaterialSpec
    mat_ids: List[int] = []
    for mat in doc.get("materials", [{}]):
        pbr = mat.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])
        em = mat.get("emissiveFactor", [0, 0, 0])
        ext = mat.get("extensions", {})
        strength = ext.get("KHR_materials_emissive_strength", {}).get(
            "emissiveStrength", 1.0)
        ior = ext.get("KHR_materials_ior", {}).get("ior", 1.5)
        trans = ext.get("KHR_materials_transmission", {}).get(
            "transmissionFactor", 0.0)
        amode = {"OPAQUE": 0, "MASK": 1, "BLEND": 2}.get(
            mat.get("alphaMode", "OPAQUE"), 0)
        mat_ids.append(b.add_material(MaterialSpec(
            base_color=tuple(base[:3]),
            metallic=pbr.get("metallicFactor", 1.0),
            roughness=pbr.get("roughnessFactor", 1.0),
            emissive=tuple(np.array(em) * strength),
            ior=ior,
            spec_trans=trans,
            alpha_mode=amode,
            alpha_cutoff=mat.get("alphaCutoff", 0.5),
            alpha_factor=float(base[3]) if len(base) > 3 else 1.0,
            double_sided=mat.get("doubleSided", False),
            base_color_tex=tid(pbr.get("baseColorTexture")),
            metal_rough_tex=tid(pbr.get("metallicRoughnessTexture")),
            emissive_tex=tid(mat.get("emissiveTexture")),
            normal_tex=tid(mat.get("normalTexture")),
        )))
    if not mat_ids:
        mat_ids = [b.add_material(MaterialSpec())]

    # meshes: primitive -> MeshHost (indices generated when absent)
    meshes: List[List[MeshHost]] = []
    for mesh in doc.get("meshes", []):
        prims = []
        for prim in mesh.get("primitives", []):
            attrs = prim["attributes"]
            pos = _accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
            if "indices" in prim:
                idx = _accessor(doc, buffers, prim["indices"]).reshape(
                    -1).astype(np.int32)
            else:
                idx = np.arange(pos.shape[0], dtype=np.int32)

            def attr(name):
                if name not in attrs:
                    return None
                return _accessor(doc, buffers, attrs[name]).astype(np.float32)

            prims.append(MeshHost(
                positions=pos, indices=idx.reshape(-1, 3),
                normals=attr("NORMAL"), uvs=attr("TEXCOORD_0"),
                tangents=attr("TANGENT"),
                material_ids=mat_ids[prim.get("material", 0)]))
        meshes.append(prims)

    # node hierarchy -> world transforms -> instances
    nodes = doc.get("nodes", [])
    scenes = doc.get("scenes", [{"nodes": list(range(len(nodes)))}])
    roots = scenes[doc.get("scene", 0)].get("nodes", [])

    def visit(ni: int, parent: np.ndarray):
        node = nodes[ni]
        world = parent @ _node_matrix(node)
        for mh in meshes[node["mesh"]] if "mesh" in node else ():
            b.add_instance(InstanceHost(mesh=mh, transform=world,
                                        emission_mode=EmissionMode.ENABLED))
        for ch in node.get("children", []):
            visit(ch, world)

    for r in roots:
        visit(r, np.eye(4, dtype=np.float32))
    return b
