"""PyTorch port: kernel K1's slab layout, its visit counter's replay, and the
Renderer's device default, on the CPU.

- `slab_layout` against the index map global (f, q·K + j) -> slab
  ((j·10 + f)·4 + q): exactly equal; `nlive` one past each cluster's last
  live triangle: exactly equal to the membership's count.
- `executed_visits_ref` (the kernel's early-out vote replayed from the twin)
  against a brute per-tile loop of prefix scans: exactly equal; at most
  min(nv, mv); 0 for tiles with no visits and for tiles whose lanes are all
  dead.
- the twin's scans over the first i visits (the replay's running keys)
  against the Pallas kernel over the same prefixes in interpret mode at
  precision="highest": the same key, or t within rtol 1e-3, on every ray
  (the bar of test_torch_accel.py).
- `Renderer` with no `device` raises where there is no CUDA device;
  `device="cpu"` renders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import n, port_clusters, rng, t

from lumenrenderer_tpu.accel import stream as jstream
from lumenrenderer_tpu.ops.pallas import intersect as jpk
from lumenrenderer_tpu_torch.accel import stream, tiled
from lumenrenderer_tpu_torch.core import sampling
from lumenrenderer_tpu_torch.core.camera import generate_primary_rays
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.ops import visit_scan as vs
from lumenrenderer_tpu_torch.render import state as pstate
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets


@pytest.mark.parametrize("k", [32, 64, 128])
def test_slab_layout_is_the_index_map(k):
    g = rng(10 + k)
    c = 3
    feats = torch.from_numpy(g.normal(size=(c, 10, 4 * k)).astype(np.float32))
    live = np.array([k, 1, k // 2 + 3])
    for ci, m in enumerate(live):
        feats[ci, :, :][:, torch.arange(4 * k) % k >= int(m)] = 0.0
    slabs, nlive = vs.slab_layout(feats, k)
    assert slabs.shape == (c, k, 10, 4) and slabs.is_contiguous()
    flat, src = n(slabs).reshape(c, -1), n(feats)
    for f in range(10):
        for q in range(4):
            j = np.arange(k)
            np.testing.assert_array_equal(flat[:, (j * 10 + f) * 4 + q],
                                          src[:, f, q * k + j])
    np.testing.assert_array_equal(n(nlive), live)


def test_nlive_counts_cluster_members():
    g = rng(11)
    tris = (g.uniform(-2, 2, (300, 1, 3))
            + g.normal(size=(300, 3, 3)) * 0.2).astype(np.float32)
    for k in (32, 64):
        cs = stream.build_clusters(torch.from_numpy(tris), cluster_size=k)
        _, nlive = vs.slab_layout(cs.tri_feat, k)
        # SAH leaves put their padding at the tail
        np.testing.assert_array_equal(n(nlive),
                                      n((cs.tri_id >= 0).sum(1)))


def _primary_inputs():
    """16 tiles of coherent primary rays into a small interior scene, with
    tile 3 given no visits and tile 5's lanes all dead (K = 32, 40
    clusters): the vote ends tiles early in both modes."""
    b, camf = presets.interior_scene(n_boxes=60, n_lights=4)
    sc = b.build()
    cs = stream.build_clusters(sc.tri_pos, cluster_size=32)
    gen = torch.Generator().manual_seed(0)
    o, d = generate_primary_rays(camf(2.0), 64, 32, 0,
                                 sampling.generator_uniforms(gen), "random")
    q = tiled.scan_inputs(cs, o, d, 1e-3, 1e9, min(cs.num_clusters, 128))
    rf_t, feats, sel, nv, tnb = q["args"]
    nv = nv.clone()
    nv[3] = 0
    rf_t = rf_t.clone()
    rf_t[5, :, 11] = -1.0
    return (rf_t, feats, sel, nv, tnb), q["kw"]


def _brute_visits(args, kw):
    """Per tile: the kernel's vote before each visit i, on the twin's result
    over the first i visits."""
    rf_t, feats, sel, nv, tnb = args
    lb = kw["low_bits"]
    counts = []
    for ti in range(rf_t.shape[0]):
        dead = rf_t[ti, :, 11] < rf_t[ti, :, 10]
        ran = min(int(nv[ti]), kw["mv"])
        for i in range(ran):
            st = vs.visit_scan_ref(rf_t[ti:ti + 1], feats, sel[ti:ti + 1],
                                   torch.tensor([i], dtype=torch.int32),
                                   tnb[ti:ti + 1], **kw)[0]
            if kw["closest"]:
                done = (dead | ((st >> lb) < (int(tnb[ti, i]) >> lb))).all()
            else:
                done = st.bool().all()
            if bool(done):
                ran = i
                break
        counts.append(ran)
    return np.array(counts, np.int32)


@pytest.mark.parametrize("closest", [True, False])
def test_executed_visits_ref_matches_brute_vote(closest):
    args, kw = _primary_inputs()
    kw = dict(kw, closest=closest)
    got = n(vs.executed_visits_ref(*args, **kw))
    np.testing.assert_array_equal(got, _brute_visits(args, kw))
    nv = n(args[3])
    assert (got <= np.minimum(nv, kw["mv"])).all()
    assert got[3] == 0 and got[5] == 0
    assert (got < nv).sum() >= 3          # the vote ended tiles early


@pytest.mark.parametrize("closest", [True, False])
def test_cpu_wrapper_fills_the_counter_from_the_replay(closest):
    args, kw = _primary_inputs()
    kw = dict(kw, closest=closest)
    visits = torch.full((args[0].shape[0],), -1, dtype=torch.int32)
    vs.reset_launches()
    out = vs.visit_scan(*args, **kw, visits=visits)
    assert torch.equal(out, vs.visit_scan_ref(*args, **kw))
    assert torch.equal(visits, vs.executed_visits_ref(*args, **kw))
    assert vs.LAUNCHES == {"closest": 0, "any": 0}
    with pytest.raises(ValueError):      # the counter is (T,) int32
        vs.visit_scan(*args, **kw, visits=visits[:-1])


def test_running_state_matches_pallas_prefix_scans():
    """The replay's running keys after i visits equal the Pallas kernel's
    keys over the first i visits (interpret mode, precision="highest")."""
    g = rng(12)
    tris = (g.uniform(-2, 2, (200, 1, 3))
            + g.normal(size=(200, 3, 3)) * 0.15).astype(np.float32)
    cs = jstream.build_clusters(jnp.asarray(tris), cluster_size=32)
    r = 1024
    o = g.uniform(-3, 3, (r, 3)).astype(np.float32)
    d = (g.uniform(-1, 1, (r, 3)) - o).astype(np.float32)   # into the cloud
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pcs = port_clusters(cs)
    q = tiled.scan_inputs(pcs, t(o), t(d), 1e-4, torch.full((r,), 1e9), 8)
    rf_t, feats, sel, nv, tnb = q["args"]
    kw = dict(q["kw"], closest=True)
    hits = 0
    for i in (1, 3, 8):
        pre = nv.clamp_max(i)
        ref = np.asarray(jpk.visit_scan(
            jnp.asarray(n(rf_t)), cs.tri_feat, cs.tri_id, jnp.asarray(n(sel)),
            jnp.asarray(n(pre)), jnp.asarray(n(tnb)), interpret=True,
            precision="highest", **kw))
        got = n(vs.visit_scan_ref(rf_t, feats, sel, pre, tnb, **kw))
        low_mask = ~((1 << kw["low_bits"]) - 1)
        t_of = lambda key: (key & low_mask).astype(np.int32).view(np.float32)
        both = (ref < jpk.KEY_MISS) & (got < jpk.KEY_MISS)
        assert ((got == ref) | (both & np.isclose(t_of(got), t_of(ref),
                                                  rtol=1e-3))).all()
        hits += int((ref < jpk.KEY_MISS).sum())
    assert hits > 100


def test_renderer_needs_a_device_off_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: Renderer() runs on it")
    b, camf = presets.cornell_box()
    cfg = RenderConfig(width=16, height=16, max_depth=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Renderer(b.build(), cfg)
    r = Renderer(b.build(), cfg, device="cpu")
    img = r.render(camf(1.0), spp=1)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.0
    with pytest.raises(TypeError):       # the state's device is explicit
        pstate.init_state(4)
