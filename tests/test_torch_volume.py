"""PyTorch port, volumes (`lumenrenderer_tpu_torch/volume/`), against the
JAX package (`lumenrenderer_tpu/volume/`, the checks of tests/test_volume.py
and tests/test_volume_sparse.py).

Grids are made with numpy from a seed and handed to both packages; JAX's
random draws are injected into the port through `ListUniforms`. Held:
the dense and sparse volume sets and the generators exactly; trilinear
sampling (points outside the box included) and the majorant to 1e-6; the
.nvdb reader on tests/data/sphere_fog.nvdb exactly; the march's
in-scattering and transmittance and both shadow-transmittance estimators
to rtol 1e-5, under a deterministic occluder shared by both packages, the
port's dead light rays included; 24x24 frames of the Cornell box with a
dense and a sparse volume (Disney MIS with Riemann, Lambert NEE with ratio
tracking) and a 32x32 ReSTIR frame of the interior in fog through the
port's K1 twin, within the frame test's tolerance (99% of pixels within
rtol 1e-3, atol 1e-4); the gradients of a frame's mean with respect to
density, bricks and sigma_t against jax.grad (rtol 1e-3), and remat on
against remat off.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import (ListUniforms, jax_frame_uniforms,
                                 jax_march_draws, jax_transmittance_draws, n,
                                 port_camera, port_clusters, port_scene, rng,
                                 t, to_numpy_tree)

from lumenrenderer_tpu.accel import stream as jstream
from lumenrenderer_tpu.accel import tiled as jtiled
from lumenrenderer_tpu.integrator import nee as jnee
from lumenrenderer_tpu.integrator import wavefront as jwf
from lumenrenderer_tpu.restir import di as jdi
from lumenrenderer_tpu.scene import presets as jpresets
from lumenrenderer_tpu.volume import grid as jgrid
from lumenrenderer_tpu.volume import march as jmarch
from lumenrenderer_tpu.volume import nvdb as jnvdb
from lumenrenderer_tpu_torch.accel import tiled as ptiled
from lumenrenderer_tpu_torch.integrator import nee as pnee
from lumenrenderer_tpu_torch.integrator import wavefront as pwf
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.restir import di as pdi
from lumenrenderer_tpu_torch.scene import presets as ppresets
from lumenrenderer_tpu_torch.utils import convert
from lumenrenderer_tpu_torch.volume import grid as pgrid
from lumenrenderer_tpu_torch.volume import march as pmarch
from lumenrenderer_tpu_torch.volume import nvdb as pnvdb

ASSET = os.path.join(os.path.dirname(__file__), "data", "sphere_fog.nvdb")
BOX = ((0.2, 0.1, 0.2), (0.8, 0.7, 0.8))   # inside the Cornell box


def _grids(seed=0, shape=(33, 20, 26), count=2):
    """Grids with empty regions (whole zero cells) and a dense blob."""
    g = rng(seed)
    out = []
    for _ in range(count):
        d = g.uniform(0.0, 3.0, shape).astype(np.float32)
        d[:17] = 0.0
        d[:, -3:] *= g.uniform(size=(shape[0], 3, shape[2])) < 0.2
        out.append(d)
    return out


def _sets(sparse, seed=0):
    """(JAX set, port set) of two volumes in different boxes."""
    grids = _grids(seed)
    lo = [(-1.0, -1.0, -1.0), (0.0, -0.5, 0.2)]
    hi = [(1.0, 0.5, 1.0), (1.5, 1.0, 1.0)]
    kw = dict(sigma_t=[1.5, 0.7], albedo=[0.9, 0.4])
    make_j = jgrid.build_sparse if sparse else jgrid.make_volume_set
    make_p = pgrid.build_sparse if sparse else pgrid.make_volume_set
    return make_j(grids, lo, hi, **kw), make_p(grids, lo, hi, **kw)


def _same_set(got, ref):
    """Every leaf of a port volume set equals the JAX set's, exactly."""
    for name, leaf in to_numpy_tree(ref).items():
        if name == "res":
            assert got.res == tuple(ref.res)
            continue
        a = n(getattr(got, name))
        assert a.dtype == leaf.dtype, name
        np.testing.assert_array_equal(a, leaf, err_msg=name)


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_volume_sets_match_jax(threshold):
    grids = _grids(1)
    lo, hi = [(0, 0, 0), (1, 1, 1)], [(1, 2, 3), (2, 2, 2)]
    _same_set(pgrid.make_volume_set(grids, lo, hi),
              jgrid.make_volume_set(grids, lo, hi))
    ref = jgrid.build_sparse(grids, lo, hi, sigma_t=[2.0, 3.0],
                             threshold=threshold)
    got = pgrid.build_sparse(grids, lo, hi, sigma_t=[2.0, 3.0],
                             threshold=threshold)
    _same_set(got, ref)
    assert 1 < got.bricks.shape[0] < got.index.numel() + 1


def test_density_generators_match_jax(tmp_path):
    for args in ((24,), (33, 0.3, 0.1)):
        np.testing.assert_array_equal(pgrid.sphere_density(*args),
                                      jgrid.sphere_density(*args))
    np.testing.assert_array_equal(pgrid.noise_density(32, 5),
                                  jgrid.noise_density(32, 5))
    d = pgrid.noise_density(16, 2)
    np.savez(tmp_path / "d.npz", grid=d)
    np.save(tmp_path / "d.npy", d)
    for p in ("d.npz", "d.npy"):
        np.testing.assert_array_equal(pgrid.load_npz(str(tmp_path / p)),
                                      jgrid.load_npz(str(tmp_path / p)))
    with pytest.raises(RuntimeError, match="pyopenvdb"):
        pgrid.load_vdb("cloud.vdb")


@pytest.mark.parametrize("sparse", [False, True])
def test_sample_density_matches_jax(sparse):
    jset, pset = _sets(sparse)
    g = rng(3)
    r = 2000
    pos = g.uniform(-1.1, 1.6, (r, 3)).astype(np.float32)
    pos[:10] = [1.0, 0.5, 1.0]                # the upper corner
    vid = g.integers(0, 2, r).astype(np.int32)
    ref = np.asarray(jgrid.sample_density(jset, jnp.asarray(vid),
                                          jnp.asarray(pos)))
    got = n(pgrid.sample_density(pset, t(vid), t(pos)))
    assert (ref == 0).mean() > 0.2 and (ref > 0).mean() > 0.05
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # a constant volume id (the march's form)
    one = n(pgrid.sample_density(pset, 1, t(pos)))
    ref1 = np.asarray(jgrid.sample_density(
        jset, jnp.ones(r, jnp.int32), jnp.asarray(pos)))
    np.testing.assert_allclose(one, ref1, atol=1e-6)
    np.testing.assert_allclose(n(pgrid.density_majorant(pset)),
                               np.asarray(jgrid.density_majorant(jset)),
                               atol=1e-6)


def test_dense_and_sparse_sampling_agree():
    """The same grid sampled through both layouts: equal, as JAX's
    test_sparse_matches_dense holds, and bit for bit here."""
    (_, dense), (_, sparse) = _sets(False), _sets(True)
    pos = t(rng(4).uniform(-1.2, 1.6, (3000, 3)).astype(np.float32))
    for v in (0, 1):
        np.testing.assert_array_equal(
            n(pgrid.sample_density(dense, v, pos)),
            n(pgrid.sample_density(sparse, v, pos)))


def test_nvdb_reader_matches_jax():
    ref, got = jnvdb.load_nvdb(ASSET), pnvdb.load_nvdb(ASSET)
    assert len(got) == len(ref) == 1
    g, jg = got[0], ref[0]
    # the SDK's ground truth (tests/test_volume_sparse.py)
    assert g.name == "sphere_fog" and g.voxel_count == 8733
    assert g.voxel_size[0] == pytest.approx(1.0 / 16.0)
    for f in ("name", "voxel_size", "world_bbox", "index_bbox_min",
              "index_bbox_max", "voxel_count"):
        assert getattr(g, f) == getattr(jg, f), f
    assert g.bricks.keys() == jg.bricks.keys()
    for k in g.bricks:
        np.testing.assert_array_equal(g.bricks[k], jg.bricks[k])
    dense = g.to_dense()
    np.testing.assert_array_equal(dense, jg.to_dense())
    lo = np.asarray(g.index_bbox_min)
    for ijk, val in (((0, 0, 0), 1.0), ((4, 2, -4), 1.0),
                     ((8, 4, -8), 0.266667), ((12, 6, -12), 0.0)):
        assert dense[tuple(np.asarray(ijk) - lo)] == pytest.approx(
            val, abs=1e-5)
    for override in (None, ((-1.0, 0.0, 2.0), (1.0, 2.0, 4.0))):
        kw = dict(sigma_t=2.0, albedo=0.5, world_override=override)
        _same_set(pnvdb.sparse_from_nvdb(ASSET, **kw),
                  jnvdb.sparse_from_nvdb(ASSET, **kw))


# ---------------------------------------------------------------------------
# the march
# ---------------------------------------------------------------------------

class PlaneOccluder:
    """A deterministic occluder both packages can call: a segment is
    occluded where it crosses the plane y = 0.45 inside [tn, tx]. Counts
    the rays it is given and the live ones (tx > tn)."""

    def __init__(self):
        self.rays = self.live = 0

    def __call__(self, o, d, tn, tx):
        xp = torch if isinstance(o, torch.Tensor) else jnp
        th = (0.45 - o[:, 1]) / xp.where(xp.abs(d[:, 1]) > 1e-9, d[:, 1],
                                          1e-9)
        self.rays += o.shape[0]
        self.live += int((tx > tn).sum())
        return (th > tn) & (th < tx)


@functools.lru_cache(maxsize=None)
def _cornell():
    jb, camf = jpresets.cornell_box(with_blocks=True)
    return jb, camf


def _light_tables():
    jb, _ = _cornell()
    sc = jb.build()
    return jnee.build_light_table(sc), pnee.build_light_table(port_scene(sc))


def _box_rays(r, seed):
    """Rays from around the unit cube toward the volume box, some missing
    it; t_max cut short on a share of them."""
    g = rng(seed)
    o = g.uniform(-0.5, 1.5, (r, 3)).astype(np.float32)
    aim = g.uniform(0.1, 0.9, (r, 3)).astype(np.float32)
    aim[::5] += 3.0                                   # misses the box
    d = aim - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(g.uniform(size=r) < 0.3, g.uniform(0.1, 1.5, r),
                    1e8).astype(np.float32)
    return o, d, tmax


def _volume_pair(sparse):
    grid = (pgrid.sphere_density(12) * (0.3 + pgrid.noise_density(12, 1)))
    make_j = jgrid.build_sparse if sparse else jgrid.make_volume_set
    make_p = pgrid.build_sparse if sparse else pgrid.make_volume_set
    args = ([grid, grid[::-1]], [BOX[0], (0.1, 0.3, 0.3)],
            [BOX[1], (0.6, 0.9, 0.7)])
    kw = dict(sigma_t=[4.0, 2.0], albedo=[0.9, 0.6])
    return make_j(*args, **kw), make_p(*args, **kw)


@pytest.mark.parametrize("sparse", [False, True])
def test_march_matches_jax(sparse):
    """volume_scatter: in-scattering and transmittance through two volumes
    against JAX's, which casts every light ray; the port's dead lanes (and a
    dead-path mask) change nothing where the frame keeps the result."""
    jvol, pvol = _volume_pair(sparse)
    jlt, plt = _light_tables()
    r = 600
    o, d, tmax = _box_rays(r, 5)
    key = jax.random.PRNGKey(3)
    jocc, pocc = PlaneOccluder(), PlaneOccluder()
    js, jt = jmarch.volume_scatter(jvol, jlt, jnp.asarray(o), jnp.asarray(d),
                                   jnp.float32(1e-3), jnp.asarray(tmax), key,
                                   jocc, steps=4)
    src = ListUniforms(jax_march_draws(key, 2, 4, r))
    ps, pt = pmarch.volume_scatter(pvol, plt, t(o), t(d), 1e-3, t(tmax),
                                   src, pocc, steps=4)
    assert src.arrays == []
    js, jt = np.asarray(js), np.asarray(jt)
    assert js.max() > 0 and 0.05 < jt.min() < jt.max() == 1.0
    np.testing.assert_allclose(n(ps), js, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(n(pt), jt, rtol=1e-5, atol=1e-7)
    assert jocc.live == jocc.rays == 2 * 4 * r
    assert 0 < pocc.live < pocc.rays == 2 * 4 * r
    # dead paths cast no light rays; their lanes are dropped by the frame
    alive = rng(6).uniform(size=r) < 0.6
    pocc2 = PlaneOccluder()
    ps2, pt2 = pmarch.volume_scatter(
        pvol, plt, t(o), t(d), 1e-3, t(tmax),
        ListUniforms(jax_march_draws(key, 2, 4, r)), pocc2, steps=4,
        alive=t(alive))
    assert pocc2.live < pocc.live
    np.testing.assert_allclose(n(ps2)[alive], js[alive], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(n(pt2), jt, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("sparse", [False, True])
def test_march_without_light_samples_matches_jax(sparse):
    """march_single_volume(light_samples=False): transmittance as JAX's,
    zero in-scattering, and no light draw (only u0) and no light ray."""
    jvol, pvol = _volume_pair(sparse)
    jlt, plt = _light_tables()
    r = 400
    o, d, tmax = _box_rays(r, 8)
    key = jax.random.fold_in(jax.random.PRNGKey(4), 1)
    jocc, pocc = PlaneOccluder(), PlaneOccluder()
    js, jt = jmarch.march_single_volume(
        jvol, 1, jlt, jnp.asarray(o), jnp.asarray(d), jnp.float32(1e-3),
        jnp.asarray(tmax), key, jocc, steps=4, light_samples=False)
    src = ListUniforms([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, 7), (r,)))])
    ps, pt = pmarch.march_single_volume(
        pvol, 1, plt, t(o), t(d), 1e-3, t(tmax), src, pocc, steps=4,
        light_samples=False)
    assert src.arrays == []
    assert jocc.rays == pocc.rays == 0
    jt = np.asarray(jt)
    assert 0.05 < jt.min() < jt.max() == 1.0
    np.testing.assert_array_equal(n(ps), np.asarray(js))
    assert not n(ps).any()
    np.testing.assert_allclose(n(pt), jt, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("estimator", ["riemann", "ratio"])
def test_transmittance_matches_jax(estimator, sparse):
    jvol, pvol = _volume_pair(sparse)
    r = 500
    o, d, tmax = _box_rays(r, 7)
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jmarch.transmittance_only(
        jvol, jnp.asarray(o), jnp.asarray(d), jnp.float32(1e-3),
        jnp.asarray(tmax), key=key, estimator=estimator))
    src = ListUniforms(jax_transmittance_draws(key, 2, estimator, r))
    got = n(pmarch.transmittance_only(pvol, t(o), t(d), 1e-3, t(tmax),
                                      uniforms=src, estimator=estimator))
    assert src.arrays == []
    assert ref.min() < 0.9 and ref.max() == 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    if estimator == "riemann":
        # no key: every step at its middle
        ref = jmarch.transmittance_only(jvol, jnp.asarray(o), jnp.asarray(d),
                                        jnp.float32(1e-3), jnp.asarray(tmax),
                                        steps=7)
        got = pmarch.transmittance_only(pvol, t(o), t(d), 1e-3, t(tmax),
                                        steps=7)
        np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-5,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def _fog_grid():
    return pgrid.sphere_density(16) * (0.5 + pgrid.noise_density(16, 3))


@functools.lru_cache(maxsize=None)
def _fog_cornell(sparse):
    """(JAX scene, port scene, JAX and port cameras, JAX and port tiled
    intersectors over the same clusters) of the Cornell box with a cloud."""
    jb, camf = jpresets.cornell_box(with_blocks=True)
    jb.add_volume(_fog_grid(), *BOX, sigma_t=4.0, albedo=0.9, sparse=sparse)
    sc, cam = jb.build(), camf(1.0)
    cs = jstream.build_clusters(sc.tri_pos, cluster_size=16)
    mv = cs.num_clusters
    jq = jtiled.tiled_intersectors(cs, max_visits=mv,
                                   candidate_dtype="float32",
                                   culling="frustum", decode=False)
    pq = ptiled.tiled_intersectors(port_clusters(cs), mv)
    return sc, port_scene(sc), cam, port_camera(cam), jq, pq


def _held_image(img_p, img_j):
    assert img_j.mean() > 0.01
    ok = np.isclose(img_p, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert ok.mean() >= 0.99, ok.mean()


@pytest.mark.parametrize("sparse,bsdf,strategy,estimator", [
    (False, "disney", "mis", "riemann"), (True, "lambert", "nee", "ratio")])
def test_frame_with_volume_matches_jax(sparse, bsdf, strategy, estimator):
    sc, psc, cam, pcam, (ji, jo), (pi, po) = _fog_cornell(sparse)
    w = h = 24
    kw = dict(width=w, height=h, max_depth=3, bsdf=bsdf,
              light_strategy=strategy, rr_start_depth=1,
              volume_transmittance=estimator)
    jcfg = jwf.RenderConfig(**kw)
    key = jax.random.PRNGKey(11)
    ref = jwf.render_wavefront(sc, ji, jo, cam, key, jnp.uint32(0), jcfg)
    src = ListUniforms(jax_frame_uniforms(key, jcfg, w * h, n_volumes=1))
    got = pwf.render_wavefront(psc, pi, po, pcam, src, 0,
                               pwf.RenderConfig(**kw))
    assert src.arrays == []
    _held_image(n(pwf.merge_channels(got)),
                np.asarray(jwf.merge_channels(ref)))
    vol_j = np.asarray(ref["volumetric"])
    assert vol_j.max() > 0
    ok = np.isclose(n(got["volumetric"]), vol_j, rtol=1e-3,
                    atol=1e-4).all(-1)
    assert ok.mean() >= 0.99, ok.mean()


def test_restir_frame_with_fog_matches_jax():
    """A 32x32 ReSTIR frame (tile-candidate RIS) of the interior with a
    cloud: ReSTIR's shading transmittance and NEE's at depth 1."""
    jb, camf = jpresets.interior_scene(n_boxes=15, n_lights=12, seed=3)
    jb.add_volume(_fog_grid(), (5.0, 3.0, 5.0), (15.0, 11.0, 14.0),
                  sigma_t=0.6, albedo=0.8)
    sc, cam = jb.build(), camf(1.0)
    w = h = 32
    kw = dict(width=w, height=h, max_depth=2, bsdf="disney",
              light_strategy="nee", use_restir=True)
    jcfg = jwf.RenderConfig(**kw)
    cs = jstream.build_clusters(sc.tri_pos, cluster_size=16)
    mv = cs.num_clusters
    ji, jo = jtiled.tiled_intersectors(cs, max_visits=mv,
                                       candidate_dtype="float32",
                                       culling="frustum", decode=False)
    jeval = jwf.RenderConfig(bsdf="disney")
    key = jax.random.PRNGKey(23)
    rcfg = jdi.RestirConfig()
    ref = jwf.render_wavefront(
        sc, ji, jo, cam, key, jnp.uint32(0), jcfg,
        restir_state=jdi.init_state(w * h),
        restir_fn=jdi.RestirDI(jo, lambda sd, wo, wi: jwf._bsdf_eval(
            jeval, sd, sc.materials, wo, wi), rcfg, w, h))
    pi, po = ptiled.tiled_intersectors(port_clusters(cs), mv)
    peval = pwf.RenderConfig(bsdf="disney")
    src = ListUniforms(jax_frame_uniforms(key, jcfg, w * h, restir_cfg=rcfg,
                                          n_volumes=1))
    got = pwf.render_wavefront(
        port_scene(sc), pi, po, port_camera(cam), src, 0,
        pwf.RenderConfig(**kw),
        restir_state=pdi.init_state(w * h, device="cpu"),
        restir_fn=pdi.RestirDI(po, lambda sd, wo, wi: pwf._bsdf_eval(
            peval, sd, wo, wi), pdi.RestirConfig(), w, h))
    assert src.arrays == []
    _held_image(n(pwf.merge_channels(got)),
                np.asarray(jwf.merge_channels(ref)))
    # the fog darkens ReSTIR's direct light
    no_fog = pwf.render_wavefront(
        port_scene(sc).replace(volumes=None), pi, po, port_camera(cam),
        ListUniforms(jax_frame_uniforms(key, jcfg, w * h, restir_cfg=rcfg)),
        0, pwf.RenderConfig(**kw),
        restir_state=pdi.init_state(w * h, device="cpu"),
        restir_fn=pdi.RestirDI(po, lambda sd, wo, wi: pwf._bsdf_eval(
            peval, sd, wo, wi), pdi.RestirConfig(), w, h))
    assert float(got["direct"].mean()) < float(no_fog["direct"].mean())


# ---------------------------------------------------------------------------
# density gradients
# ---------------------------------------------------------------------------

GRAD_W = GRAD_H = 12
GRAD_CFG = dict(width=GRAD_W, height=GRAD_H, max_depth=3, bsdf="lambert",
                light_strategy="mis", rr_start_depth=99)


def _leaf(sparse):
    return "bricks" if sparse else "density"


@functools.lru_cache(maxsize=None)
def _jax_density_grads(sparse):
    sc, _, cam, _, (ji, jo), _ = _fog_cornell(sparse)
    cfg = jwf.RenderConfig(**GRAD_CFG)

    def loss(grid, sigma_t):
        vols = sc.volumes.replace(**{_leaf(sparse): grid}, sigma_t=sigma_t)
        out = jwf.render_wavefront(sc.replace(volumes=vols), ji, jo, cam,
                                   jax.random.PRNGKey(5), jnp.uint32(0), cfg)
        return jwf.merge_channels(out).mean()

    v, g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        getattr(sc.volumes, _leaf(sparse)), sc.volumes.sigma_t)
    return float(v), [np.asarray(x) for x in g]


def _port_density_grads(sparse, remat):
    sc, psc, _, pcam, _, (pi, po) = _fog_cornell(sparse)
    jcfg = jwf.RenderConfig(**GRAD_CFG)
    grid = getattr(psc.volumes, _leaf(sparse)).clone().requires_grad_()
    sigma_t = psc.volumes.sigma_t.clone().requires_grad_()
    vols = psc.volumes.replace(**{_leaf(sparse): grid}, sigma_t=sigma_t)
    src = ListUniforms(jax_frame_uniforms(jax.random.PRNGKey(5), jcfg,
                                          GRAD_W * GRAD_H, n_volumes=1))
    out = pwf.render_wavefront(psc.replace(volumes=vols), pi, po, pcam, src,
                               0, pwf.RenderConfig(**GRAD_CFG, remat=remat))
    v = pwf.merge_channels(out).mean()
    v.backward()
    assert src.arrays == []
    return float(v.detach()), [n(grid.grad), n(sigma_t.grad)]


@pytest.mark.parametrize("sparse", [False, True])
def test_density_gradients_match_jax(sparse):
    jv, (jg, js) = _jax_density_grads(sparse)
    pv, (pg, ps) = _port_density_grads(sparse, remat=False)
    np.testing.assert_allclose(pv, jv, rtol=1e-5)
    assert np.isfinite(pg).all() and (pg != 0).sum() > 100
    assert js[0] != 0
    np.testing.assert_allclose(ps, js, rtol=1e-3)
    np.testing.assert_allclose(pg, jg, rtol=1e-3, atol=1e-3 * np.abs(jg).max())
    # remat replays the march's draws and light rays: the same numbers
    rv, (rg, rs) = _port_density_grads(sparse, remat=True)
    assert rv == pv
    np.testing.assert_allclose(rg, pg, rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(rs, ps, rtol=1e-5)


def test_scene_and_volumes_convert():
    for sparse in (False, True):
        sc = _fog_cornell(sparse)[0]
        got = convert.scene_from_numpy(to_numpy_tree(sc)).volumes
        assert isinstance(got, pgrid.SparseVolumeSet if sparse
                          else pgrid.VolumeSet)
        _same_set(got, sc.volumes)


@pytest.mark.parametrize("sparse", [False, True])
def test_renderer_renders_volume_scene(sparse):
    """Renderer moves the scene and its volumes to its device together
    (the sparse set keeps its resolution) and accumulates finite frames
    whose volumetric channel is lit."""
    b, camf = ppresets.cornell_box(with_blocks=True)
    b.add_volume(_fog_grid(), *BOX, sigma_t=4.0, albedo=0.9, sparse=sparse)
    sc = b.build()
    cfg = pwf.RenderConfig(width=16, height=16, max_depth=2)
    r = Renderer(sc, cfg, device="cpu")
    assert type(r.scene.volumes) is type(sc.volumes)
    if sparse:
        assert r.scene.volumes.res == sc.volumes.res == (16, 16, 16)
    st = r.init_state(0)
    for _ in range(2):
        st, _ = r.render_frame(st, camf(1.0))
    assert bool(torch.isfinite(st.accum).all()) and float(st.accum.mean()) > 0
    out = pwf.render_wavefront(
        r.scene, r._isect, r._occl, camf(1.0),
        pwf.sampling.generator_uniforms(torch.Generator().manual_seed(0)), 0,
        cfg)
    assert float(out["volumetric"].amax()) > 0
    assert out["volumetric"].device.type == "cpu"
