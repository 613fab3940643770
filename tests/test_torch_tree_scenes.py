"""PyTorch port, tree culling in a two-level scene, against the JAX package.

A two-level scene past 2048 units culls through the unit tree: hit mask and
occlusion equal to JAX's `two_level._query`, the triangle equal on 99.5% of
hits (tests/test_two_level.py's bar); the port's own unit tree equal to
JAX's. tests/test_torch_tree_frame.py holds the mega frame.
"""
import _torch_port_helpers as helpers
import numpy as np
import torch
from _torch_port_helpers import coherent_rays, n, port_instanced, rng, t

from lumenrenderer_tpu.accel import two_level as jtwo
from lumenrenderer_tpu_torch.accel import tiled as ptiled, two_level as ptwo
from lumenrenderer_tpu_torch.scene import presets


def test_two_level_unit_tree_past_2048_units():
    b = helpers.jax_instanced_builder(n_inst=2100)
    ics = jtwo.build_instanced(*ptwo.instance_tables(b.instances),
                               cluster_size=32)
    assert ics.num_clusters > ptiled.MAX_FRUSTUM_CLUSTERS
    g = rng(6)
    o, d = coherent_rays(g, 4, spread=3.0, cone=0.1)
    r = o.shape[0]
    tx = np.full(r, 1e8, np.float32)
    mv = 64
    ref = jtwo._query(ics, o, d, 1e-3, tx, mv, True, precision="highest",
                      culling="auto", decode=False)
    pics = port_instanced(ics)
    got = ptwo._query(pics, t(o), t(d), 1e-3, t(tx), mv, True)
    tri, tri_j = n(got["tri"]), np.asarray(ref["tri"])
    assert bool(got["overflow"]) == bool(ref["overflow"])
    np.testing.assert_array_equal(tri >= 0, tri_j >= 0)
    assert ((tri == tri_j) | (tri < 0)).mean() > 0.995 and (tri >= 0).sum() > 50
    occ_j = np.asarray(jtwo._query(ics, o, d, 1e-3, np.full(r, 3.0, np.float32),
                                   mv, False, precision="highest")["occluded"])
    occ = n(ptwo._query(pics, t(o), t(d), 1e-3, torch.full((r,), 3.0), mv,
                        False)["occluded"])
    np.testing.assert_array_equal(occ, occ_j)
    # the port's own build gives the same unit tree
    own = ptwo.build_instanced(*ptwo.instance_tables(
        presets.instanced_boxes(n_inst=2100)[0].instances), cluster_size=32)
    assert own.tree_depth == ics.tree_depth
    np.testing.assert_array_equal(n(own.tree_child0),
                                  np.asarray(ics.tree_child0))


def test_instanced_intersectors_run_the_scan_and_walk_given():
    """`scan` and `walk` reach every query of the unit tree: the twins
    passed in explicitly are what runs, with the default query's answer."""
    from lumenrenderer_tpu_torch.ops import tree_walk as tw
    from lumenrenderer_tpu_torch.ops import visit_scan_instanced as vsi

    ics = ptwo.build_instanced(*ptwo.instance_tables(
        presets.instanced_boxes(n_inst=2100)[0].instances), cluster_size=32)
    calls = {"scan": 0, "walk": 0}

    def counted(key, fn):
        def run(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return run

    isect, occl = ptwo.instanced_intersectors(
        ics, 64, scan=counted("scan", vsi.visit_scan_instanced_ref),
        walk=counted("walk", tw.tile_tree_visits_ref))
    o, d = coherent_rays(rng(6), 4, spread=3.0, cone=0.1)
    r = o.shape[0]
    tn, tx = torch.full((r,), 1e-3), torch.full((r,), 1e8)
    hit = isect(t(o), t(d), tn, tx)
    occ = occl(t(o), t(d), tn, torch.full((r,), 3.0))
    assert calls == {"scan": 2, "walk": 2}
    ref = ptwo._query(ics, t(o), t(d), tn, tx, 64, True)
    torch.testing.assert_close(hit["tri"], ref["tri"], rtol=0, atol=0)
    torch.testing.assert_close(hit["t"], ref["t"], rtol=0, atol=0)
    ref_occ = ptwo._query(ics, t(o), t(d), tn, torch.full((r,), 3.0), 64,
                          False)["occluded"]
    assert torch.equal(occ, ref_occ) and int(hit["tri"].ge(0).sum()) > 20
