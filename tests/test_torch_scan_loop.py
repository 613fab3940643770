"""PyTorch port: what kernels K2 (instanced visit scan) and K3 (pair scan)
take from the loop they share with K1, on the CPU.

- `slab_layout` on the instanced table and on the pair path's table: `nlive`
  exactly equal to each unit mesh's triangle count (12 for a box) and to
  each cluster's member count.
- `executed_visits_instanced_ref` (K2's vote before every visit, replayed
  from the twin with object-space features) against a brute per-tile loop
  of prefix scans: exactly equal; 0 for a tile with no visits and for a
  tile whose lanes are all dead.
- K2's wrapper on CPU tensors fills its visit counter from that replay.
- `pair_scan_ref` on a stream whose tail is dead and with one dead tile of a
  nonzero cluster inside it: the miss key or 0 on every dead tile, and
  against the Pallas `pair_scan` in interpret mode at precision="highest" on
  the same numpy inputs: bits equal, keys equal or a tie within the key's t
  quantum plus the Pallas t's 2^-16 error (the bar of
  test_torch_pairs.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import n, port_clusters, rng, t

from lumenrenderer_tpu.accel import stream as jstream
from lumenrenderer_tpu.ops.pallas import pair_intersect as jpk
from lumenrenderer_tpu_torch.accel import pairs, stream, two_level
from lumenrenderer_tpu_torch.core import sampling
from lumenrenderer_tpu_torch.core.camera import generate_primary_rays
from lumenrenderer_tpu_torch.ops import pair_scan as ps
from lumenrenderer_tpu_torch.ops import visit_scan as vs
from lumenrenderer_tpu_torch.ops import visit_scan_instanced as vsi
from lumenrenderer_tpu_torch.scene import presets

KEY_MISS = vs.KEY_MISS


def _instanced(k, n_inst=20):
    b, camf = presets.instanced_boxes(n_inst=n_inst)
    ics = two_level.build_instanced(*two_level.instance_tables(b.instances),
                                    cluster_size=k)
    return b, camf, ics


@pytest.mark.parametrize("k", [32, 128])
def test_instanced_nlive_is_the_mesh_triangle_count(k):
    b, _, ics = _instanced(k)
    _, nlive = vs.slab_layout(ics.tri_feat, k)
    meshes = two_level.instance_tables(b.instances)[0]
    np.testing.assert_array_equal(n(nlive), [len(m) for m in meshes])
    assert n(nlive).tolist() == [12, 12]          # two box meshes


def test_pair_table_nlive_is_the_member_count():
    b, camf = presets.interior_scene(n_boxes=40, n_lights=4)
    sc = b.build()
    cs = stream.build_clusters(sc.tri_pos, cluster_size=64)
    gen = torch.Generator().manual_seed(0)
    o, d = generate_primary_rays(camf(2.0), 64, 32, 0,
                                 sampling.generator_uniforms(gen), "random")
    q = pairs.scan_inputs(cs, o, d, 1e-3, torch.full((o.shape[0],), 1e9),
                          128, 8)
    feats = q["args"][1]
    _, nlive = vs.slab_layout(feats, q["kw"]["k"])
    np.testing.assert_array_equal(n(nlive), n((cs.tri_id >= 0).sum(1)))
    assert int(nlive.min()) < q["kw"]["k"]        # some clusters are short


def _k2_inputs():
    """16 tiles of rays into the instanced scene (K = 32, 21 units), tile i
    aimed from 4 units away at instance i's box, so that the vote ends most
    tiles early in both modes; tile 3 is given no visits and tile 5's lanes
    are all dead."""
    b, _, ics = _instanced(32)
    g = rng(22)
    o, d = [], []
    for i in range(16):
        c = b.instances[i].transform[:3, 3]
        u = g.normal(size=3)
        src = c + 4.0 * u / np.linalg.norm(u)
        o.append(src + 0.02 * g.normal(size=(128, 3)))
        aim = c + 0.1 * g.normal(size=(128, 3)) - o[-1]
        d.append(aim / np.linalg.norm(aim, axis=1, keepdims=True))
    o, d = t(np.concatenate(o).astype(np.float32)), t(np.concatenate(
        d).astype(np.float32))
    q = two_level.scan_inputs(ics, o, d, 1e-3, torch.full((o.shape[0],), 1e9),
                              min(ics.num_clusters, 128))
    rayblk, wnd, feats, sel_cl, minv12, nv, tnb = q["args"]
    nv = nv.clone()
    nv[3] = 0
    wnd = wnd.clone()
    wnd[5, :, 1] = -1.0
    return (rayblk, wnd, feats, sel_cl, minv12, nv, tnb), q["kw"]


def _brute_visits(args, kw):
    """Per tile: the kernel's vote before each visit i, on the twin's keys
    (bits) over the first i visits."""
    rayblk, wnd, feats, sel_cl, minv12, nv, tnb = args
    lb = kw["low_bits"]
    counts = []
    for ti in range(rayblk.shape[0]):
        one = lambda a: a[ti:ti + 1]
        dead = wnd[ti, :, 1] < wnd[ti, :, 0]
        ran = min(int(nv[ti]), kw["mv"])
        for i in range(ran):
            st = vsi.visit_scan_instanced_ref(
                one(rayblk), one(wnd), feats, one(sel_cl), one(minv12),
                torch.tensor([i], dtype=torch.int32), one(tnb), **kw)[0]
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
def test_executed_visits_instanced_ref_matches_brute_vote(closest):
    args, kw = _k2_inputs()
    kw = dict(kw, closest=closest)
    got = n(vsi.executed_visits_instanced_ref(*args, **kw))
    np.testing.assert_array_equal(got, _brute_visits(args, kw))
    nv = n(args[5])
    assert (got <= np.minimum(nv, kw["mv"])).all()
    assert got[3] == 0 and got[5] == 0
    assert (got < nv).sum() >= 3          # the vote ended tiles early
    assert got.sum() > 0


@pytest.mark.parametrize("closest", [True, False])
def test_k2_cpu_wrapper_fills_the_counter_from_the_replay(closest):
    args, kw = _k2_inputs()
    kw = dict(kw, closest=closest)
    visits = torch.full((args[0].shape[0],), -1, dtype=torch.int32)
    vsi.reset_launches()
    out = vsi.visit_scan_instanced(*args, **kw, visits=visits)
    assert torch.equal(out, vsi.visit_scan_instanced_ref(*args, **kw))
    assert torch.equal(visits, vsi.executed_visits_instanced_ref(*args, **kw))
    assert vsi.LAUNCHES == {"closest": 0, "any": 0}
    with pytest.raises(ValueError):      # the counter is (T,) int32
        vsi.visit_scan_instanced(*args, **kw, visits=visits.long())


@pytest.mark.parametrize("closest", [True, False])
def test_pair_scan_ref_dead_tail_and_pallas(closest):
    g = rng(21)
    count = 500
    tri = g.uniform(-1, 1, (count, 3, 3)).astype(np.float32)
    tri[:, 1:] = tri[:, :1] + 0.3 * g.uniform(-1, 1, (count, 2, 3)).astype(
        np.float32)
    r = 700
    o = g.uniform(-2, 2, (r, 3)).astype(np.float32)
    d = g.uniform(-1, 1, (r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tx = np.where(g.uniform(size=r) < 0.2, -1.0,
                  1e8 if closest else 1.2).astype(np.float32)
    cs = jstream.build_clusters(jnp.asarray(tri), cluster_size=32)
    q = pairs.scan_inputs(port_clusters(cs), t(o), t(d), 1e-3, t(tx), 128, 16)
    rf_pairs, feats, tile_cluster = (a.clone() for a in q["args"])
    rows = rf_pairs.view(-1, 128, 12)
    live = (rows[..., 11] >= rows[..., 10]).any(1)
    # a live tile of a nonzero cluster made dead: the vote must read the
    # windows, not the tile's cluster
    inner = int(((tile_cluster > 0) & live).nonzero()[0, 0])
    rows[inner, :, 10] = 1.0
    rows[inner, :, 11] = 0.0
    live[inner] = False
    dead = ~live
    assert int(dead.sum()) >= 2 and bool(dead[-1])     # a dead tail
    assert bool((tile_cluster[dead] == 0).sum() >= 1)  # padding: cluster 0
    kw = dict(q["kw"], closest=closest)
    got = n(ps.pair_scan_ref(rf_pairs, feats, tile_cluster, **kw)).reshape(
        -1, 128)
    miss = KEY_MISS if closest else 0
    assert (got[n(dead)] == miss).all()
    ref = np.asarray(jpk.pair_scan(
        jnp.asarray(n(rf_pairs)), cs.tri_feat, jnp.asarray(n(tile_cluster)),
        interpret=True, precision="highest", **kw)).reshape(-1, 128)
    assert (ref[n(dead)] == miss).all()
    if not closest:
        np.testing.assert_array_equal(got, ref)
        assert ref.sum() > 20
        return
    low_mask = ~((1 << kw["k_bits"]) - 1)
    t_of = lambda key: (key & low_mask).astype(np.int32).view(np.float32)
    both = (ref < KEY_MISS) & (got < KEY_MISS)
    rel = 2.0 ** -(23 - kw["k_bits"]) + 2.0 ** -16
    quantum = np.maximum(t_of(got), t_of(ref)) * rel
    tie = both & (np.abs(t_of(got) - t_of(ref)) <= quantum)
    assert ((got == ref) | tie).all()
    assert (ref < KEY_MISS).sum() > 20
