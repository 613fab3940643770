"""PyTorch port, scene build, against the JAX package.

Every SceneData leaf of each preset: integers exact, floats to 1e-6
(relative and absolute; both packages run the same numpy host code).
"""
import numpy as np
import pytest
import torch
from _torch_port_helpers import n, to_numpy_tree

from lumenrenderer_tpu.scene import presets as jpresets
from lumenrenderer_tpu.scene.materials import GatheredMaterial as JGathered
from lumenrenderer_tpu_torch.scene import presets as ppresets
from lumenrenderer_tpu_torch.scene.materials import (GatheredMaterial,
                                                     MaterialSpec)
from lumenrenderer_tpu_torch.scene.scene import SceneBuilder

PRESETS = {
    "interior": lambda m: m.interior_scene(40, 8),
    "cornell": lambda m: m.cornell_box(),
    "cornell_extras": lambda m: m.cornell_box(bsdf_extras=True),
    "furnace": lambda m: m.furnace_scene(),
}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        elif v is not None:
            yield prefix + k, v


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_scene_leaves_match_jax(preset):
    jb, jcamf = PRESETS[preset](jpresets)
    pb, pcamf = PRESETS[preset](ppresets)
    ref = to_numpy_tree(jb.build())
    ref.pop("volumes")
    got = pb.build()
    for name, want in _leaves(ref):
        obj = got
        for part in name.split("."):
            obj = getattr(obj, part)
        have = n(obj)
        assert have.shape == want.shape, name
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(have, want, err_msg=name)
        else:
            np.testing.assert_allclose(have, want, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    jc, pc = jcamf(1.5), pcamf(1.5)
    for f in ("eye", "u", "v", "w", "prev_view_proj"):
        np.testing.assert_allclose(n(getattr(pc, f)), np.asarray(getattr(jc, f)),
                                   rtol=1e-5, atol=1e-6)


def test_packed_material_rows_match_jax():
    jb, _ = jpresets.cornell_box(bsdf_extras=True)
    pb, _ = ppresets.cornell_box(bsdf_extras=True)
    ref = np.asarray(jb.build().materials.packed())
    got = pb.build().materials.packed()
    assert got.shape == (5, 25)
    np.testing.assert_allclose(n(got), ref, rtol=1e-6)
    jg, pg = JGathered(ref), GatheredMaterial(got)
    for col in ("base_color", "roughness", "transmittance", "alpha_mode",
                "double_sided", "alpha_factor"):
        np.testing.assert_allclose(n(getattr(pg, col)),
                                   np.asarray(getattr(jg, col)), rtol=1e-6)


def test_scene_moves_to_device_and_back():
    sc = ppresets.cornell_box()[0].build()
    moved = sc.to("cpu")
    assert moved.materials.base_color.device.type == "cpu"
    assert moved.lights.count.dtype == torch.int32
    assert int(moved.lights.count) == 2


@pytest.mark.parametrize("sparse", [False, True])
def test_textures_and_volumes_refused(sparse):
    """Textures and volumes are accepted (both were refused before the port
    had them): add_texture returns ids, and a textured material builds an
    atlas with the white slot 0 and one slot per image; add_volume builds
    the JAX package's VolumeSet, or its SparseVolumeSet when the first
    volume asks for one, leaf for leaf."""
    b = SceneBuilder()
    assert b.add_texture(np.ones((2, 2, 4), np.float32)) == 0
    assert b.add_texture(np.zeros((3, 5, 3), np.uint8)) == 1
    b.add_material(MaterialSpec(base_color_tex=0, normal_tex=1))
    g = np.random.default_rng(4)
    grids = [g.uniform(0, 2, (20, 11, 9)) * (g.uniform(size=(20, 11, 9))
                                           < 0.1) for _ in range(2)]
    jb, _ = jpresets.cornell_box()
    for i, d in enumerate(grids):
        args = (d, (i, 0, 0), (i + 1, 1, 2), 1.5 + i, 0.3 * i,
                sparse if i == 0 else not sparse)
        assert b.add_volume(*args) == i
        jb.add_volume(*args)
    sc = b.build()
    assert sc.textures.count == 3
    assert n(sc.textures.width).tolist() == [1, 2, 5]
    assert int(sc.materials.base_color_tex[0]) == 0
    ref = jb.build().volumes
    assert type(sc.volumes).__name__ == type(ref).__name__
    for name, want in to_numpy_tree(ref).items():
        if name == "res":
            assert sc.volumes.res == tuple(ref.res) == (20, 11, 9)
            continue
        have = n(getattr(sc.volumes, name))
        assert have.dtype == want.dtype, name
        np.testing.assert_array_equal(have, want, err_msg=name)
