"""PyTorch port, the asset path (`scene/gltf.py`, `scene/cache.py`), against
the JAX package.

- load_gltf(...).build() leaf for leaf equal to the JAX package's (integers
  and texels exact, floats rtol 1e-6) on the glTF of tests/test_assets.py,
  and on a textured asset written three ways (.gltf with an external .bin
  and PNG files, .glb with the images in buffer views, data URIs): PNGs
  that Pillow writes in modes RGB, RGBA, L, LA and P, the alpha fields of tests/test_alpha.py, the
  material extensions and a two-level node hierarchy (matrix and TRS);
- the port's PNG decoder equal to Pillow's convert("RGBA"), tRNS keys and
  palettes included, and on PNGs whose rows cycle through all five filters; JPEG (and a 1-bit PNG) decoded by Pillow, and without
  Pillow either raises instead of dropping the texture;
- the cache file in both directions: a port save_scene read by the JAX
  load_scene and a JAX file read by the port, every leaf equal (values,
  dtypes, shapes); load_or_build's freshness by mtime; a file with volumes
  raises.
"""
import base64
import io
import json
import os
import struct
import sys
import zlib

import jax
import numpy as np
import pytest
import torch
from _torch_port_helpers import n, to_numpy_tree
from test_assets import _write_test_gltf

from lumenrenderer_tpu.scene import cache as jcache
from lumenrenderer_tpu.scene import gltf as jgltf
from lumenrenderer_tpu.scene import presets as jpresets
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import cache as pcache
from lumenrenderer_tpu_torch.scene import gltf as pgltf
from lumenrenderer_tpu_torch.scene import presets as ppresets

Image = pytest.importorskip("PIL.Image", reason="the asset tests write "
                            "their PNG and JPEG files with Pillow")
MODES = ("RGB", "RGBA", "L", "LA", "P")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        elif v is not None:
            yield prefix + k, v


def _get(obj, name):
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def assert_scene_equal(port_scene, jax_scene, exact=False):
    """Every leaf of the JAX scene against the port's: shapes and dtypes
    equal; integers and texels exact, other floats rtol 1e-6 (or exact)."""
    ref = to_numpy_tree(jax_scene)
    assert ref.pop("volumes") is None
    names = []
    for name, want in _leaves(ref):
        have = n(_get(port_scene, name))
        assert have.shape == want.shape and have.dtype == want.dtype, name
        if exact or not np.issubdtype(want.dtype, np.floating) \
                or name == "textures.texels":
            np.testing.assert_array_equal(have, want, err_msg=name)
        else:
            np.testing.assert_allclose(have, want, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
        names.append(name)
    assert len(names) == len(pcache.LEAVES)


# ---------------------------------------------------------------------------
# a textured glTF asset
# ---------------------------------------------------------------------------

def _image(mode, seed, size=(24, 20)):
    """A Pillow image of `mode`: smooth gradients plus noise, so the
    encoder's adaptive filter picks every filter type somewhere."""
    g = np.random.default_rng(seed)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (w + h),
                     255 - xx * 200 / w], -1)
    rows = g.uniform(0, 1, (h, 1, 1)) < 0.5
    a = np.clip(base + rows * g.normal(0, 40, base.shape), 0, 255)
    a = a.astype(np.uint8)
    if mode == "P":
        return Image.fromarray(a[..., :3]).convert("P", palette=1,
                                                   colors=32)
    return Image.fromarray(a[..., 0] if mode == "L" else a[..., :len(mode)])


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _cycled_png(px: np.ndarray, ctype: int) -> bytes:
    """An 8-bit PNG of px (H,W,bpp) uint8 whose row y uses filter y % 5."""
    h, w, bpp = px.shape
    x = px.astype(np.int32).reshape(h, w * bpp)
    left = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    up = np.pad(x, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    preds = [np.zeros_like(x), left, up, (left + up) >> 1,
             _paeth(left, up, upleft)]
    rows = b"".join(bytes([y % 5]) + ((x[y] - preds[y % 5][y]) & 0xFF)
                    .astype(np.uint8).tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def _png(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _png_filters(raw: bytes):
    """The row filter types of an 8-bit PNG."""
    w, h, _, ctype, _, _, _ = struct.unpack(">IIBBBBB", raw[16:29])
    pos, idat = 8, b""
    while pos < len(raw):
        length, tag = struct.unpack_from(">I4s", raw, pos)
        if tag == b"IDAT":
            idat += raw[pos + 8: pos + 8 + length]
        pos += 12 + length
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * bpp)
    return set(rows[:, 0].tolist())


def _textured_doc(layout, tmp_path):
    """A textured glTF document (dict) and its binary buffer: a quad with
    normals, UVs and indices under a root node with a matrix and a child
    with TRS; a triangle without indices and with tangents; three materials
    over five PNG images (one per mode); layout "gltf" (external .bin and
    .png files), "glb" (images in buffer views) or "datauri"."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [2, 0], [2, 2], [0, 2]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    tri = np.array([[0, 0, 1], [1, 0, 1], [0, 1, 1]], np.float32)
    tan = np.array([[1, 0, 0, -1]] * 3, np.float32)
    blob, views = b"", []
    for p in (pos, nrm, uv, idx, tri, tan):      # each 4-byte aligned
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": p.nbytes})
        blob += p.tobytes()
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
        {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
        {"bufferView": 2, "componentType": 5126, "count": 4, "type": "VEC2"},
        {"bufferView": 3, "componentType": 5123, "count": 6,
         "type": "SCALAR"},
        {"bufferView": 4, "componentType": 5126, "count": 3, "type": "VEC3"},
        {"bufferView": 5, "componentType": 5126, "count": 3, "type": "VEC4"},
    ]
    pngs = [_png(_image(m, i)) for i, m in enumerate(MODES)]
    images = []
    for i, raw in enumerate(pngs):
        if layout == "gltf":
            (tmp_path / f"tex{i}.png").write_bytes(raw)
            images.append({"uri": f"tex{i}.png"})
        elif layout == "datauri":
            images.append({"uri": "data:image/png;base64,"
                           + base64.b64encode(raw).decode()})
        else:
            while len(blob) % 4:
                blob += b"\0"
            views.append({"buffer": 0, "byteOffset": len(blob),
                          "byteLength": len(raw)})
            images.append({"bufferView": len(views) - 1,
                           "mimeType": "image/png"})
            blob += raw
    doc = {
        "asset": {"version": "2.0"},
        "accessors": accessors, "bufferViews": views,
        "images": images,
        "textures": [{"source": i} for i in range(len(MODES))]
        + [{"sampler": 0}],                      # no source: ignored
        "materials": [
            {"pbrMetallicRoughness": {
                "baseColorFactor": [0.9, 0.8, 0.7, 0.6],
                "baseColorTexture": {"index": 1},
                "metallicFactor": 0.3, "roughnessFactor": 0.6,
                "metallicRoughnessTexture": {"index": 0}},
             "normalTexture": {"index": 0},
             "emissiveTexture": {"index": 4},
             "emissiveFactor": [0.5, 0.25, 1.0],
             "extensions": {
                 "KHR_materials_emissive_strength": {"emissiveStrength": 4},
                 "KHR_materials_ior": {"ior": 1.33},
                 "KHR_materials_transmission": {"transmissionFactor": 0.4}},
             "alphaMode": "BLEND", "doubleSided": True},
            {"pbrMetallicRoughness": {"baseColorFactor": [1, 1, 1, 0.7],
                                      "baseColorTexture": {"index": 3}},
             "alphaMode": "MASK", "alphaCutoff": 0.25},
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 2}},
             "emissiveTexture": {"index": 5}},
        ],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                            "TEXCOORD_0": 2},
                             "indices": 3, "material": 0}]},
            {"primitives": [{"attributes": {"POSITION": 4, "TANGENT": 5},
                             "material": 1},
                            {"attributes": {"POSITION": 0, "TEXCOORD_0": 2},
                             "indices": 3, "material": 2}]},
        ],
        "nodes": [
            {"matrix": [0, 0, -1, 0, 0, 1, 0, 0, 1, 0, 0, 0, 2, 0, 1, 1],
             "children": [1, 2]},
            {"mesh": 0, "translation": [0, 1, 0],
             "rotation": [0, 0, 0.38268343, 0.92387953],
             "scale": [2, 1, 1]},
            {"mesh": 1, "children": [3]},
            {"mesh": 0, "translation": [0, 0, -3]},
        ],
        "scenes": [{"nodes": [0]}], "scene": 0,
    }
    return doc, blob


def write_textured(tmp_path, layout):
    doc, blob = _textured_doc(layout, tmp_path)
    if layout == "gltf":
        (tmp_path / "asset.bin").write_bytes(blob)
        doc["buffers"] = [{"uri": "asset.bin", "byteLength": len(blob)}]
    elif layout == "datauri":
        doc["buffers"] = [{"uri": "data:application/octet-stream;base64,"
                           + base64.b64encode(blob).decode(),
                           "byteLength": len(blob)}]
    else:
        doc["buffers"] = [{"byteLength": len(blob)}]
    if layout == "glb":
        js = json.dumps(doc).encode()
        js += b" " * (-len(js) % 4)
        blob += b"\0" * (-len(blob) % 4)
        body = (struct.pack("<II", len(js), 0x4E4F534A) + js
                + struct.pack("<II", len(blob), 0x004E4942) + blob)
        path = tmp_path / "asset.glb"
        path.write_bytes(struct.pack("<III", 0x46546C67, 2, 12 + len(body))
                         + body)
    else:
        path = tmp_path / "asset.gltf"
        path.write_text(json.dumps(doc))
    return str(path)


@pytest.mark.parametrize("layout", ["gltf", "glb", "datauri"])
def test_textured_gltf_builds_as_jax(tmp_path, layout):
    path = write_textured(tmp_path, layout)
    pb = pgltf.load_gltf(path)
    jb = jgltf.load_gltf(path)
    assert len(pb.texture_images) == len(jb.texture_images) == len(MODES)
    for mine, ref in zip(pb.texture_images, jb.texture_images):
        np.testing.assert_array_equal(mine, ref)
    sc = pb.build()
    assert_scene_equal(sc, jb.build())
    specs = pb.materials
    assert specs[0].alpha_mode == 2 and specs[0].spec_trans == 0.4
    assert specs[1].alpha_mode == 1 and specs[1].alpha_cutoff == 0.25
    assert specs[1].double_sided is False
    assert abs(specs[1].alpha_factor - 0.7) < 1e-6
    assert specs[2].emissive_tex == -1          # a texture without a source
    # the quad, the triangle and the quad of mesh 1, and the child's quad
    assert len(pb.instances) == 4 and sc.num_triangles == 7


def test_gltf_of_the_jax_asset_tests(tmp_path):
    for emissive in (False, True):
        p = str(tmp_path / f"quad{int(emissive)}.gltf")
        _write_test_gltf(p, emissive=emissive)
        sc = pgltf.load_gltf(p).build()
        assert_scene_equal(sc, jgltf.load_gltf(p).build())
        assert int(sc.lights.count) == (2 if emissive else 0)


def test_gltf_textured_frame_on_cpu(tmp_path):
    """The README's path: a glTF through the cache into a Renderer."""
    path = write_textured(tmp_path, "gltf")
    sc = pcache.load_or_build(path)
    assert sc.textures.count == len(MODES) + 1
    r = Renderer(sc, RenderConfig(width=16, height=16, max_depth=2),
                 device="cpu", cluster_size=32)
    assert r.config.alpha_materials and r.config.extract_tangent
    st, _ = r.render_frame(r.init_state(0), _camera())
    assert torch.isfinite(st.accum).all()


def _camera():
    from lumenrenderer_tpu_torch.core.camera import Camera

    return Camera.look_at(eye=(0.5, 1.0, 6.0), target=(0.5, 1.0, 0.0),
                          fov_y_deg=60.0)


# ---------------------------------------------------------------------------
# the PNG decoder
# ---------------------------------------------------------------------------

def _pngs():
    out = {m: _png(_image(m, 10 + i, (33, 17))) for i, m in
           enumerate(MODES)}
    out["L_trns"] = _png(_image("L", 20), transparency=128)
    out["RGB_trns"] = _png(Image.fromarray(np.array(
        [[[10, 20, 30], [1, 2, 3]], [[10, 20, 30], [4, 5, 6]]], np.uint8)),
        transparency=(10, 20, 30))
    pal = _image("P", 21)
    out["P_trns"] = _png(pal, transparency=bytes(range(0, 250, 10)))
    out["P_trns1"] = _png(pal, transparency=3)
    out["one_pixel"] = _png(Image.new("RGBA", (1, 1), (9, 8, 7, 6)))
    g = np.random.default_rng(22)
    for ctype, bpp in ((0, 1), (2, 3), (4, 2), (6, 4)):
        out[f"all_filters_{ctype}"] = _cycled_png(
            g.integers(0, 256, (11, 9, bpp), dtype=np.uint8), ctype)
    return out


@pytest.mark.parametrize("name", ["RGB", "RGBA", "L", "LA", "P", "L_trns",
                                  "RGB_trns", "P_trns", "P_trns1",
                                  "one_pixel", "all_filters_0",
                                  "all_filters_2", "all_filters_4",
                                  "all_filters_6"])
def test_png_decoder_matches_pillow(name):
    raw = _pngs()[name]
    if name.startswith("all_filters"):
        assert _png_filters(raw) == {0, 1, 2, 3, 4}
    want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"), np.uint8)
    got = pgltf.decode_png(raw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _jpeg() -> bytes:
    buf = io.BytesIO()
    _image("RGB", 30).save(buf, format="JPEG")
    return buf.getvalue()


def test_other_formats_need_pillow(tmp_path, monkeypatch):
    jpeg = _jpeg()
    want = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGBA"))
    np.testing.assert_array_equal(pgltf.decode_image(jpeg), want)
    png1 = _png(Image.fromarray(np.eye(3, dtype=bool)))     # 1-bit grey
    assert pgltf.decode_png(png1) is None
    np.testing.assert_array_equal(
        pgltf.decode_image(png1),
        np.asarray(Image.open(io.BytesIO(png1)).convert("RGBA")))
    # a glTF whose base color is a JPEG
    path = write_textured(tmp_path, "gltf")
    (tmp_path / "tex1.png").write_bytes(jpeg)
    np.testing.assert_array_equal(pgltf.load_gltf(path).texture_images[1],
                                  want)
    rgba = _png(_image("RGBA", 1))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    for raw, fmt in ((jpeg, "JPEG"), (png1, "PNG")):
        with pytest.raises(NotImplementedError, match=fmt):
            pgltf.decode_image(raw)
    with pytest.raises(NotImplementedError, match="JPEG"):
        pgltf.load_gltf(path)
    # 8-bit PNGs still load without Pillow
    (tmp_path / "tex1.png").write_bytes(rgba)
    assert len(pgltf.load_gltf(path).texture_images) == len(MODES)


# ---------------------------------------------------------------------------
# the scene cache
# ---------------------------------------------------------------------------

def test_cache_leaf_order_is_jax_flattening():
    sc = jpresets.cornell_box()[0].build()
    paths, _ = jax.tree_util.tree_flatten_with_path(sc)
    names = tuple(jax.tree_util.keystr(p).lstrip(".") for p, _ in paths)
    assert names == pcache.LEAVES


def test_cache_files_cross_both_packages(tmp_path):
    path = write_textured(tmp_path, "glb")
    jsc = jgltf.load_gltf(path).build()
    psc = pgltf.load_gltf(path).build()
    # port -> JAX
    pcache.save_scene(str(tmp_path / "port.npz"), psc)
    back = jcache.load_scene(str(tmp_path / "port.npz"))
    assert_scene_equal(psc, back, exact=True)
    assert back.volumes is None
    # JAX -> port
    jcache.save_scene(str(tmp_path / "jax.npz"), jsc)
    got = pcache.load_scene(str(tmp_path / "jax.npz"))
    assert_scene_equal(got, jsc, exact=True)
    assert got.textures.count == len(MODES) + 1


def test_load_or_build_by_mtime(tmp_path):
    p = str(tmp_path / "quad.gltf")
    _write_test_gltf(p)
    cache = p + pcache.CACHE_EXT
    sc1 = pcache.load_or_build(p)
    assert os.path.exists(cache)
    x1 = float(sc1.tri_pos[..., 0].min())
    # the source changes: older than the cache, the cache is used
    doc = json.loads(open(p).read())
    doc["nodes"][0]["translation"] = [5.0, 0.0, 0.0]
    with open(p, "w") as f:
        json.dump(doc, f)
    t_cache = os.path.getmtime(cache)
    os.utime(p, (t_cache - 10, t_cache - 10))
    assert float(pcache.load_or_build(p).tri_pos[..., 0].min()) == x1
    # newer than the cache: rebuilt and cached again
    os.utime(p, (t_cache + 10, t_cache + 10))
    sc3 = pcache.load_or_build(p)
    assert float(sc3.tri_pos[..., 0].min()) == x1 + 4.0
    assert os.path.getmtime(cache) >= t_cache
    assert_scene_equal(pcache.load_scene(cache), jcache.load_scene(cache),
                       exact=True)
    # an explicit cache path
    other = str(tmp_path / "elsewhere.npz")
    pcache.load_or_build(p, other)
    assert os.path.exists(other)


def _volume_cornell(package, sparse=False):
    """The Cornell box with two dense (or sparse) volumes."""
    b, _ = package.cornell_box()
    g = np.random.default_rng(8)
    for i in range(2):
        b.add_volume(g.uniform(0, 2, (6, 9, 5)).astype(np.float32),
                     (0.1, 0.1 * i, 0.2), (0.6, 0.5, 0.9), sigma_t=2.0 + i,
                     albedo=0.7, sparse=sparse)
    return b.build()


def _assert_volumes_equal(port_vols, jax_vols):
    for name, want in to_numpy_tree(jax_vols).items():
        have = n(getattr(port_vols, name))
        assert have.dtype == want.dtype, name
        np.testing.assert_array_equal(have, want, err_msg=name)


def test_cache_with_volumes_raises(tmp_path):
    """Dense volumes round-trip through the cache in JAX's format and each
    package reads the other's file; a scene with sparse volumes raises on
    save, and JAX's file of one (which JAX reads back wrong) on load
    (ROADMAP C-17)."""
    psc, jsc = _volume_cornell(ppresets), _volume_cornell(jpresets)
    f = str(tmp_path / "port.npz")
    pcache.save_scene(f, psc)
    for got in (jcache.load_scene(f), pcache.load_scene(f)):
        assert_scene_equal(psc, got.replace(volumes=None), exact=True)
        _assert_volumes_equal(psc.volumes, got.volumes)
    f = str(tmp_path / "jax.npz")
    jcache.save_scene(f, jsc)
    got = pcache.load_scene(f)
    assert_scene_equal(got, jsc.replace(volumes=None), exact=True)
    _assert_volumes_equal(got.volumes, jsc.volumes)
    f = str(tmp_path / "sparse.npz")
    with pytest.raises(NotImplementedError, match="C-17"):
        pcache.save_scene(f, _volume_cornell(ppresets, sparse=True))
    assert not os.path.exists(f)
    jcache.save_scene(f, _volume_cornell(jpresets, sparse=True))
    with pytest.raises(NotImplementedError, match="C-17"):
        pcache.load_scene(f)
