"""Kernels K1 (ops/csrc/visit_scan.cu), K2 (visit_scan_instanced.cu), K3
(pair_scan.cu), W (tree_walk.cu) and T (bvh_traverse.cu) on the card
against their plain twins.

Marked `cuda`: these need an NVIDIA GPU with nvcc (Hopper, sm_90a) and skip
where torch.cuda.is_available() is False. Run them on the card with
`python -m pytest --noconftest tests/test_torch_kernels.py -q`.
Tolerance: keys identical on at least 99.99% of rays, every differing key a
tie within the key's t resolution (the bf16 mode, precision="default":
keys identical, also where a rounded triangle lies nearer than its
cluster's box; K1, K2 and K3 form its product on the tensor cores and
their twins sum as the tensor-core probe found the card to, bit for bit,
and the probe's results equal that model's on every crafted sum);
occlusion bits identical; K1's and K2's
visit counters identical to `executed_visits_ref` and
`executed_visits_instanced_ref`; K3's dead tiles the miss key (0); W's
lists, entry t (bit for bit) and counts identical to its twin's; T's
triangles, hit bits, counters and t, u, v (bit for bit) identical to its
twin's.
"""
import numpy as np
import pytest
import torch

from lumenrenderer_tpu_torch.accel import (lbvh, pairs, sah, stream, tiled,
                                           two_level)
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.ops import bvh_traverse as bt
from lumenrenderer_tpu_torch.ops import mma_probe as mp
from lumenrenderer_tpu_torch.ops import pair_scan as ps
from lumenrenderer_tpu_torch.ops import tree_walk as tw
from lumenrenderer_tpu_torch.ops import visit_scan as vs
from lumenrenderer_tpu_torch.ops import visit_scan_instanced as vsi
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, n_tris=2000, r=8192, k=64, seed=0):
    g = np.random.default_rng(seed)
    c = g.uniform(-3, 3, (n_tris, 1, 3))
    tris = (c + g.normal(size=(n_tris, 3, 3)) * 0.2).astype(np.float32)
    cs = stream.build_clusters(torch.from_numpy(tris), cluster_size=k).to(dev)
    o = torch.from_numpy(g.uniform(-4, 4, (r, 3)).astype(np.float32)).to(dev)
    d = torch.nn.functional.normalize(
        torch.from_numpy(g.normal(size=(r, 3)).astype(np.float32)), dim=-1
    ).to(dev)
    tx = torch.where(torch.arange(r, device=dev) % 9 == 0, -1.0, 6.0)
    return tiled.scan_inputs(cs, o, d, 1e-4, tx, min(cs.num_clusters, 128))


def _check_against_twin(mod, kernel, twin, q, closest, low_bits,
                        precision="highest"):
    kw = dict(q["kw"], closest=closest, precision=precision)
    mod.reset_launches()
    kern = kernel(*q["args"], **kw)
    ref = twin(*q["args"], **kw)
    torch.cuda.synchronize()
    bf16 = precision == "default"
    counts = mod.LAUNCHES_BF16 if bf16 else mod.LAUNCHES
    assert counts["closest" if closest else "any"] == 1
    diff = kern != ref
    if bf16:
        assert torch.equal(kern, ref)
    if not closest:
        assert not bool(diff.any())
        return
    assert float(diff.float().mean()) <= 1e-4
    mask = ~((1 << low_bits) - 1)
    tk = (kern & mask).view(torch.float32)
    tt = (ref & mask).view(torch.float32)
    quantum = torch.maximum(tk, tt) * 2.0 ** -(23 - low_bits)
    assert bool(((tk - tt).abs() <= quantum)[diff].all())
    assert int((kern < vs.KEY_MISS).sum()) > 1000


def _check_counter(args, kw):
    """K1's visit counter against the replay of its vote on the twin (kw
    may carry the precision)."""
    visits = torch.full((args[0].shape[0],), -1, dtype=torch.int32,
                        device=args[0].device)
    vs.visit_scan(*args, **kw, visits=visits)
    ref = vs.executed_visits_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(visits, ref)
    return visits


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("k", [32, 64, 128])
@pytest.mark.parametrize("closest", [True, False])
def test_kernel_matches_twin(dev, closest, k, precision):
    q = _inputs(dev, n_tris=4000, k=k)
    _check_against_twin(vs, vs.visit_scan, vs.visit_scan_ref, q, closest,
                        q["kw"]["low_bits"], precision)
    visits = _check_counter(q["args"], dict(q["kw"], closest=closest,
                                            precision=precision))
    assert int(visits.sum()) > 0


@pytest.mark.parametrize("closest", [True, False])
def test_bf16_kernel_keeps_hits_nearer_than_their_box(dev, closest):
    """Rays head-on into a stack of triangles 1e-3 apart: many bf16-rounded
    winners lie nearer than their cluster's fp32 entry t. The bf16 kernel
    equals its twin (the full scan), and in closest mode every tile runs
    all its visits."""
    g = np.random.default_rng(44)
    m, r = 256, 2048
    tris = np.zeros((m, 3, 3), np.float32)
    tris[:, :, 0] = (1.0 + 1e-3 * np.arange(m))[:, None]
    tris[:, :, 1:] = np.float32([[-3, -3], [3, -3], [0, 4]])
    tris[:, :, 1:] += g.uniform(-0.9, 0.9, size=(m, 3, 2))
    tris[:, :, 0] += g.normal(size=(m, 3)) * 1e-4
    cs = stream.build_clusters(torch.from_numpy(tris), cluster_size=32)
    o = np.zeros((r, 3), np.float32)
    o[:, 1:] = g.uniform(-1, 1, (r, 2))
    d = torch.tensor([1.0, 0.0, 0.0]).expand(r, 3)
    q = tiled.scan_inputs(cs.to(dev), torch.from_numpy(o).to(dev),
                          d.to(dev), 1e-4, 1e9, cs.num_clusters)
    _check_against_twin(vs, vs.visit_scan, vs.visit_scan_ref, q, closest,
                        q["kw"]["low_bits"], "default")
    visits = _check_counter(q["args"], dict(q["kw"], closest=closest,
                                            precision="default"))
    if closest:
        assert torch.equal(visits, q["args"][3])


@pytest.mark.parametrize("closest", [True, False])
def test_kernel_edge_tiles(dev, closest):
    """A tile with nv = mv = 128 visits, one with none, one whose lanes are
    all dead: keys and bits equal the twin's, the counter the replay's."""
    q = _inputs(dev, n_tris=5000, k=32)
    rf_t, feats, sel, nv, tnb = (a.clone() for a in q["args"])
    kw = dict(q["kw"], closest=closest)
    assert kw["mv"] == 128 and feats.shape[0] >= 128
    sel[0] = torch.arange(128, device=dev, dtype=torch.int32)
    nv[0] = 128
    tnb[0] = 0            # every entry at t = 0: no early end in closest mode
    nv[1] = 0
    rf_t[2, :, 11] = -1.0
    args = (rf_t, feats, sel, nv, tnb)
    kern = vs.visit_scan(*args, **kw)
    ref = vs.visit_scan_ref(*args, **kw)
    torch.cuda.synchronize()
    if closest:
        diff = kern != ref
        assert float(diff.float().mean()) <= 1e-4
    else:
        assert torch.equal(kern, ref)
    live1 = rf_t[1, :, 11] >= rf_t[1, :, 10]
    miss = vs.KEY_MISS if closest else 0
    assert bool((kern[1][live1] == miss).all())
    assert torch.equal(kern[2], torch.full_like(kern[2], 0 if closest else 1))
    visits = _check_counter(args, kw)
    assert int(visits[1]) == 0 and int(visits[2]) == 0
    if closest:
        assert int(visits[0]) == 128


def test_mma_probe_equals_the_twins_model(dev):
    """One m16n8k16 bf16 product per crafted case on the card equals
    `mma_product` under MMA_MODEL bit for bit, every family (full16 too)."""
    mp.LAUNCHES = 0
    for fam, (a, b) in mp.probe_cases(seed=3).items():
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        got = mp.mma_probe(ta.to(dev), tb.to(dev)).cpu()
        want = vs.mma_product(ta, tb)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), fam
    assert mp.LAUNCHES == len(mp.probe_cases(seed=3, n=1))


@pytest.mark.parametrize("closest", [True, False])
def test_bf16_kernel_edge_tiles(dev, closest):
    """K1's tensor-core mode: a tile with nv = mv = 128 visits, one with
    none, one whose lanes are all dead, one with a single live ray, and
    clusters cut to 1, 3 and 5 live slots (nlive rounded up to 4): keys
    and bits equal the twin's, the counter the replay's."""
    q = _inputs(dev, n_tris=5000, k=32)
    rf_t, feats, sel, nv, tnb = (a.clone() for a in q["args"])
    kw = dict(q["kw"], closest=closest, precision="default")
    sel[0] = torch.arange(128, device=dev, dtype=torch.int32)
    nv[0] = 128
    nv[1] = 0
    rf_t[2, :, 11] = -1.0
    rf_t[3, 1:, 11] = -1.0
    for cl, live in ((0, 1), (1, 3), (2, 5)):
        feats.view(-1, 10, 4, 32)[cl, :, :, live:] = 0.0
    nl = vs.mma_layout(feats, 32)[1]
    assert bool((nl % 4 == 0).all()) and int(nl[0]) == 4
    args = (rf_t, feats, sel, nv, tnb)
    kern = vs.visit_scan(*args, **kw)
    ref = vs.visit_scan_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kern, ref)
    assert torch.equal(kern[2], torch.full_like(kern[2], 0 if closest else 1))
    visits = _check_counter(args, kw)
    assert int(visits[1]) == 0 and int(visits[2]) == 0
    if closest:                 # only dead lanes end a bf16 closest tile
        assert int(visits[0]) == 128


@pytest.mark.parametrize("closest", [True, False])
def test_bf16_pair_kernel_dead_tail_and_short_clusters(dev, closest):
    """K3's tensor-core mode on the stream's dead tail, a tile with one
    live pair and clusters cut to 1 and 6 live slots: equal to the twin,
    dead tiles the miss key (0)."""
    q = _pair_inputs(dev)
    rf_pairs, feats, tile_cluster = (a.clone() for a in q["args"])
    rows = rf_pairs.view(-1, 128, 12)
    live = (rows[..., 11] >= rows[..., 10]).any(1)
    first = int((live & (tile_cluster > 0)).nonzero()[0, 0])
    rows[first, 1:, 10], rows[first, 1:, 11] = 1.0, 0.0
    for cl, cut in ((int(tile_cluster[first]), 1), (0, 6)):
        feats.view(-1, 10, 4, 64)[cl, :, :, cut:] = 0.0
    args = (rf_pairs, feats, tile_cluster)
    _check_against_twin(ps, ps.pair_scan, ps.pair_scan_ref,
                        {"args": args, "kw": q["kw"]}, closest,
                        q["kw"]["k_bits"], "default")
    kern = ps.pair_scan(*args, **q["kw"], closest=closest,
                        precision="default").view(-1, 128)
    torch.cuda.synchronize()
    dead = (rows[..., 11] < rows[..., 10]).all(1)
    miss = vs.KEY_MISS if closest else 0
    assert bool((kern[dead] == miss).all()) and int(dead.sum()) > 1


def test_kernel_rejects_unsupported_cluster_size(dev):
    q = _inputs(dev, n_tris=300, r=512, k=16)
    with pytest.raises(ValueError):
        vs.visit_scan(*q["args"], **q["kw"], closest=True)


def _instanced_inputs(dev, k=32, seed=1):
    b, _ = presets.instanced_boxes(n_inst=120)
    ics = two_level.build_instanced(*two_level.instance_tables(b.instances),
                                    cluster_size=k).to(dev)
    g = np.random.default_rng(seed)
    r = 8192
    o = torch.from_numpy(g.uniform(-4, 4, (r, 3)).astype(np.float32)).to(dev)
    d = torch.nn.functional.normalize(
        torch.from_numpy(g.normal(size=(r, 3)).astype(np.float32)), dim=-1
    ).to(dev)
    tx = torch.where(torch.arange(r, device=dev) % 9 == 0, -1.0, 8.0)
    return two_level.scan_inputs(ics, o, d, 1e-3, tx, 128)


def _check_instanced_counter(args, kw):
    """K2's visit counter against the replay of its vote on the twin (kw
    may carry the precision)."""
    visits = torch.full((args[0].shape[0],), -1, dtype=torch.int32,
                        device=args[0].device)
    vsi.visit_scan_instanced(*args, **kw, visits=visits)
    ref = vsi.executed_visits_instanced_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(visits, ref)
    return visits


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("k", [32, 64, 128])
@pytest.mark.parametrize("closest", [True, False])
def test_instanced_kernel_matches_twin(dev, closest, k, precision):
    q = _instanced_inputs(dev, k)
    _check_against_twin(vsi, vsi.visit_scan_instanced,
                        vsi.visit_scan_instanced_ref, q, closest,
                        q["kw"]["low_bits"], precision)
    visits = _check_instanced_counter(q["args"], dict(
        q["kw"], closest=closest, precision=precision))
    assert int(visits.sum()) > 0


@pytest.mark.parametrize("closest", [True, False])
def test_instanced_kernel_edge_tiles(dev, closest):
    """A tile with no visits, one whose lanes are all dead (0 visits), and
    a unit mesh cut to one live slot: keys and bits equal the twin's, the
    counter the replay's."""
    q = _instanced_inputs(dev)
    rayblk, wnd, feats, sel_cl, minv12, nv, tnb = (a.clone()
                                                   for a in q["args"])
    feats.view(-1, 10, 4, 32)[1, :, :, 1:] = 0.0   # the light: one slot
    assert int(vs.slab_layout(feats, 32)[1][1]) == 1
    nv[1] = 0
    wnd[2, :, 1] = -1.0
    args = (rayblk, wnd, feats, sel_cl, minv12, nv, tnb)
    kw = dict(q["kw"], closest=closest)
    _check_against_twin(vsi, vsi.visit_scan_instanced,
                        vsi.visit_scan_instanced_ref,
                        {"args": args, "kw": q["kw"]}, closest,
                        q["kw"]["low_bits"])
    visits = _check_instanced_counter(args, kw)
    assert int(visits[1]) == 0 and int(visits[2]) == 0


@pytest.mark.parametrize("k", [32, 64, 128])
@pytest.mark.parametrize("closest", [True, False])
def test_bf16_instanced_kernel_edge_tiles(dev, closest, k):
    """K2's tensor-core mode: a tile with no visits, one whose lanes are
    all dead (0 visits), one with a single live ray, and the two unit
    meshes cut to 5 and 1 live slots (nlive rounded up to 8 and 4): keys
    and bits equal the twin's, the counter the replay's."""
    q = _instanced_inputs(dev, k)
    rayblk, wnd, feats, sel_cl, minv12, nv, tnb = (a.clone()
                                                   for a in q["args"])
    for cl, live in ((0, 5), (1, 1)):
        feats.view(-1, 10, 4, k)[cl, :, :, live:] = 0.0
    assert vs.mma_layout(feats, k)[1].tolist() == [8, 4]
    nv[1] = 0
    wnd[2, :, 1] = -1.0
    wnd[3, 1:, 1] = -1.0
    args = (rayblk, wnd, feats, sel_cl, minv12, nv, tnb)
    kw = dict(q["kw"], closest=closest, precision="default")
    _check_against_twin(vsi, vsi.visit_scan_instanced,
                        vsi.visit_scan_instanced_ref,
                        {"args": args, "kw": q["kw"]}, closest,
                        q["kw"]["low_bits"], "default")
    kern = vsi.visit_scan_instanced(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kern[2], torch.full_like(kern[2], 0 if closest else 1))
    visits = _check_instanced_counter(args, kw)
    assert int(visits[1]) == 0 and int(visits[2]) == 0
    if closest:                 # only dead lanes end a bf16 closest tile
        ran = torch.where(wnd[..., 1].ge(wnd[..., 0]).any(1),
                          nv.clamp_max(q["kw"]["mv"]), 0)
        assert torch.equal(visits, ran.to(torch.int32))


@pytest.mark.parametrize("closest", [True, False])
def test_bf16_instanced_kernel_keeps_hits_nearer_than_their_box(dev,
                                                                closest):
    """K2's version of K1's stack: 128 triangles 1e-3 apart as one unit
    mesh, under two scaled and moved instances, rays head-on: many
    bf16-rounded winners lie nearer than their unit's fp32 entry t. The
    kernel equals its twin (the full scan), and in closest mode every tile
    runs all its listed visits."""
    g = np.random.default_rng(46)
    m, r = 128, 2048
    tris = np.zeros((m, 3, 3), np.float32)
    tris[:, :, 0] = (1.0 + 1e-3 * np.arange(m))[:, None]
    tris[:, :, 1:] = np.float32([[-3, -3], [3, -3], [0, 4]])
    tris[:, :, 1:] += g.uniform(-0.9, 0.9, size=(m, 3, 2))
    tris[:, :, 0] += g.normal(size=(m, 3)) * 1e-4
    mats = []
    for shift, scale in ((0.5, 1.1), (3.0, 0.9)):
        m4 = np.eye(4, dtype=np.float32)
        m4[:3, :3] *= scale
        m4[:3, 3] = (shift, 0.2, -0.1)
        mats.append(m4)
    ics = two_level.build_instanced([tris], [0, 0], mats,
                                    cluster_size=128).to(dev)
    o = np.zeros((r, 3), np.float32)
    o[:, 1:] = g.uniform(-1, 1, (r, 2))
    d = torch.tensor([1.0, 0.0, 0.0]).expand(r, 3)
    q = two_level.scan_inputs(ics, torch.from_numpy(o).to(dev), d.to(dev),
                              1e-4, 1e9, 2)
    _check_against_twin(vsi, vsi.visit_scan_instanced,
                        vsi.visit_scan_instanced_ref, q, closest,
                        q["kw"]["low_bits"], "default")
    visits = _check_instanced_counter(q["args"], dict(
        q["kw"], closest=closest, precision="default"))
    if closest:
        assert torch.equal(visits, q["args"][5])
        assert int(q["args"][5].sum()) == 2 * visits.shape[0]


def _pair_inputs(dev, k=64, seed=2):
    g = np.random.default_rng(seed)
    c = g.uniform(-3, 3, (2000, 1, 3))
    tris = (c + g.normal(size=(2000, 3, 3)) * 0.2).astype(np.float32)
    cs = stream.build_clusters(torch.from_numpy(tris), cluster_size=k).to(dev)
    r = 8192
    o = torch.from_numpy(g.uniform(-4, 4, (r, 3)).astype(np.float32)).to(dev)
    d = torch.nn.functional.normalize(
        torch.from_numpy(g.normal(size=(r, 3)).astype(np.float32)), dim=-1
    ).to(dev)
    tx = torch.where(torch.arange(r, device=dev) % 9 == 0, -1.0, 6.0)
    return pairs.scan_inputs(cs, o, d, 1e-4, tx, 128, 16)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("k", [32, 64, 128])
@pytest.mark.parametrize("closest", [True, False])
def test_pair_kernel_matches_twin(dev, closest, k, precision):
    q = _pair_inputs(dev, k)
    _check_against_twin(ps, ps.pair_scan, ps.pair_scan_ref, q, closest,
                        q["kw"]["k_bits"], precision)


@pytest.mark.parametrize("closest", [True, False])
def test_pair_kernel_dead_tail_and_edge_tiles(dev, closest):
    """The stream's run-padded dead tail, a tile of a nonzero cluster made
    dead, a tile with one live pair, and a cluster cut to one live slot:
    equal to the twin, dead tiles the miss key (0)."""
    q = _pair_inputs(dev)
    rf_pairs, feats, tile_cluster = (a.clone() for a in q["args"])
    rows = rf_pairs.view(-1, 128, 12)
    live = (rows[..., 11] >= rows[..., 10]).any(1)
    assert bool(~live[-1])                          # a dead tail
    first, second = (live & (tile_cluster > 0)).nonzero()[:2, 0].tolist()
    rows[first, :, 10], rows[first, :, 11] = 1.0, 0.0
    rows[second, 1:, 10], rows[second, 1:, 11] = 1.0, 0.0
    assert bool(rows[second, 0, 11] >= rows[second, 0, 10])
    cl = int(tile_cluster[second])
    feats.view(-1, 10, 4, 64)[cl, :, :, 1:] = 0.0  # one live slot
    assert int(vs.slab_layout(feats, 64)[1][cl]) == 1
    args = (rf_pairs, feats, tile_cluster)
    _check_against_twin(ps, ps.pair_scan, ps.pair_scan_ref,
                        {"args": args, "kw": q["kw"]}, closest,
                        q["kw"]["k_bits"])
    kern = ps.pair_scan(*args, **q["kw"], closest=closest).view(-1, 128)
    torch.cuda.synchronize()
    dead = (rows[..., 11] < rows[..., 10]).all(1)
    miss = vs.KEY_MISS if closest else 0
    assert bool((kern[dead] == miss).all()) and int(dead.sum()) > 1


def test_pair_and_instanced_kernels_reject_unsupported_k(dev):
    q = _pair_inputs(dev, k=16)
    with pytest.raises(ValueError):
        ps.pair_scan(*q["args"], **q["kw"], closest=True)
    q = _instanced_inputs(dev, k=16)
    with pytest.raises(ValueError):
        vsi.visit_scan_instanced(*q["args"], **q["kw"], closest=True)


def test_kernel_rejects_mixed_devices(dev):
    q = _inputs(dev, n_tris=300, r=512)
    rf_t, feats, sel, nv, tnb = q["args"]
    with pytest.raises(ValueError):
        vs.visit_scan(rf_t, feats.cpu(), sel, nv, tnb, **q["kw"],
                      closest=True)


def test_renderer_frame_launches_both_modes(dev):
    b, camf = presets.cornell_box(bsdf_extras=True)
    r = Renderer(b.build(), RenderConfig(width=64, height=48, max_depth=3),
                 device=dev)
    vs.reset_launches()
    img = r.render(camf(64 / 48), spp=2)
    assert np.isfinite(img).all() and img.mean() > 0.01
    assert vs.LAUNCHES["closest"] == 6 and vs.LAUNCHES["any"] == 6


def test_two_level_frame_launches_both_modes(dev):
    b, camf = presets.instanced_boxes(n_inst=40)
    r = Renderer(b.build(), RenderConfig(width=64, height=48, max_depth=3),
                 accel="two_level", builder=b, device=dev)
    vsi.reset_launches()
    img = r.render(camf(64 / 48), spp=2)
    assert np.isfinite(img).all() and img.mean() > 0.0
    assert vsi.LAUNCHES["closest"] == 6 and vsi.LAUNCHES["any"] == 6


def _walk_inputs(dev, n_tris=3000, k=32, tiles=256, seed=3, refit=False):
    """Tile bounds of coherent 128-ray tiles (every seventh ray dead, tile 3
    all dead) and the cluster tree of random triangles, on the card; with
    `refit`, the tree of a refit, every node the global box."""
    g = np.random.default_rng(seed)
    c = g.uniform(-3, 3, (n_tris, 1, 3))
    tris = torch.from_numpy((c + g.normal(size=(n_tris, 3, 3)) * 0.15)
                            .astype(np.float32))
    cs = stream.build_clusters(tris, cluster_size=k)
    if refit:
        cs = stream.refit_clusters(cs, tris + 0.05)
    cs = cs.to(dev)
    o = np.repeat(g.uniform(-4, 4, (tiles, 1, 3)), 128, 1)
    base = g.normal(size=(tiles, 1, 3))
    d = base / np.linalg.norm(base, axis=-1, keepdims=True) + g.normal(
        size=(tiles, 128, 3)) * 0.15
    to = lambda a: torch.from_numpy(a.reshape(-1, 3).astype(np.float32)).to(
        dev)
    r = tiles * 128
    tx = torch.where(torch.arange(r, device=dev) % 7 == 0, -1.0, 1e9)
    tx[3 * 128:4 * 128] = -1.0
    tn = torch.full((r,), 1e-4, device=dev)
    bounds = tiled._tile_bounds(to(o), torch.nn.functional.normalize(
        to(d), dim=-1), tn, tx, tiles, 128)
    tree = (cs.tree_lo, cs.tree_hi, cs.tree_child0, cs.tree_child1,
            cs.tree_leaf_cluster)
    return bounds, tree, cs


def _check_walk(bounds, tree, nodes, depth, mv):
    """W against its twin: lists, entry t bits and counts identical; the
    same tiles walk at all (the kernel pops other nodes than the twin)."""
    tiles = bounds[0].shape[0]
    dev = bounds[0].device
    pops = torch.full((tiles,), -1, dtype=torch.int32, device=dev)
    pops_ref = torch.full_like(pops, -1)
    tw.reset_launches()
    kern = tw.tile_tree_visits(*bounds, *tree, tree_depth=depth, mv=mv,
                               nodes=nodes, pops=pops)
    ref = tw.tile_tree_visits_ref(*bounds, *tree, tree_depth=depth, mv=mv,
                                  pops=pops_ref)
    torch.cuda.synchronize()
    assert tw.LAUNCHES["walk"] == 1
    visits, vtn, count = kern
    assert torch.equal(visits, ref[0]) and torch.equal(count, ref[2])
    assert torch.equal(vtn.view(torch.int32), ref[1].view(torch.int32))
    assert bool(((pops > 0) == (pops_ref > 0)).all())
    return kern, pops_ref


@pytest.mark.parametrize("refit", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("mv", [128, 4, 1])
def test_tree_walk_matches_twin(dev, mv, seed, refit):
    bounds, tree, cs = _walk_inputs(dev, seed=seed, refit=refit)
    (_, _, count), pops = _check_walk(bounds, tree, cs.tree_nodes,
                                      cs.tree_depth, mv)
    assert int(count[3]) == 0 and int(pops[3]) == 0
    assert int(count.max()) == mv + 1 and int(pops.sum()) > 1000


def test_tree_walk_one_leaf_tree_and_dead_tiles(dev):
    bounds, tree, cs = _walk_inputs(dev, n_tris=20, k=32)
    assert cs.num_clusters == 1 and tree[0].shape[0] == 1
    (visits, vtn, count), _ = _check_walk(bounds, tree, cs.tree_nodes,
                                          cs.tree_depth, 4)
    assert int(count.max()) == 1 and bool((visits == 0).all())
    bounds, tree, cs = _walk_inputs(dev)
    dead = tuple(bounds[:5]) + (torch.zeros_like(bounds[5]),)
    (visits, vtn, count), pops = _check_walk(dead, tree, cs.tree_nodes,
                                             cs.tree_depth, 8)
    assert int(count.sum()) == 0 and int(pops.sum()) == 0
    assert bool((vtn == torch.inf).all()) and bool((visits == 0).all())


def test_tree_walk_rejects_a_deeper_tree_than_its_stack(dev):
    bounds, tree, cs = _walk_inputs(dev, n_tris=300)
    deep = next(d for d in range(64, 1024)
                if 8 * tw.stack_entries(d) > tw.SHARED_BYTES)
    tw.tile_tree_visits(*bounds, *tree, tree_depth=deep - 1, mv=8,
                        nodes=cs.tree_nodes)
    with pytest.raises(ValueError):
        tw.tile_tree_visits(*bounds, *tree, tree_depth=deep, mv=8,
                            nodes=cs.tree_nodes)


def test_tree_walk_raises_where_a_walk_outgrows_its_stack(dev):
    """The kernel checks each step's stack size against the one it was
    given: a stack sized for a one-level tree cannot hold the walk of a
    deeper one, and the wrapper raises rather than clip."""
    bounds, tree, cs = _walk_inputs(dev, seed=3, refit=True)
    assert tw.stack_entries(1) == tw.WARP < tw.stack_entries(cs.tree_depth)
    with pytest.raises(RuntimeError, match="outgrew"):
        tw.tile_tree_visits(*bounds, *tree, tree_depth=1, mv=128,
                            nodes=cs.tree_nodes)


def test_mega_frame_launches_the_walk_per_query(dev):
    b, camf = presets.mega_scene(n_tris=24_000, n_lights=8)
    r = Renderer(b.build(), RenderConfig(width=64, height=48, max_depth=3),
                 culling="tree", device=dev)
    vs.reset_launches()
    tw.reset_launches()
    img = r.render(camf(64 / 48), spp=2)
    assert np.isfinite(img).all() and img.mean() > 0.0
    assert vs.LAUNCHES["closest"] == 6 and vs.LAUNCHES["any"] == 6
    assert tw.LAUNCHES["walk"] == 12


def _walk_rays(dev, n_tris=3000, r=20000, seed=0):
    g = np.random.default_rng(seed)
    c = g.uniform(-3, 3, (n_tris, 1, 3))
    tris = (c + g.normal(size=(n_tris, 3, 3)) * 0.2).astype(np.float32)
    o = torch.from_numpy(g.uniform(-4, 4, (r, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        g.normal(size=(r, 3)).astype(np.float32)), dim=-1)
    tn = torch.full((r,), 1e-4)
    tx = torch.where(torch.arange(r) % 7 == 0, -1.0, 5.0)   # dead lanes
    return tris, tuple(x.to(dev) for x in (o, d, tn, tx))


@pytest.mark.parametrize("builder,leaf_size,n_tris,r", [
    *[(b, k, 3000, 20000) for b in ("sah", "lbvh") for k in (1, 4, 8)],
    ("sah", 4, 3, 4099), ("lbvh", 4, 3, 4099),      # the root is a leaf
    ("sah", 2, 3000, 20001), ("lbvh", 8, 3000, 4131),   # not 32 | rays
    ("lbvh", 4, 3000, 1 << 20)])    # a full-size pass: 8,192 blocks
def test_bvh_walk_matches_twin(dev, builder, leaf_size, n_tris, r):
    tris, rays = _walk_rays(dev, n_tris=n_tris, r=r, seed=leaf_size)
    b = (sah.build_sah(tris, leaf_size).to(dev) if builder == "sah"
         else lbvh.build_lbvh(torch.from_numpy(tris).to(dev), leaf_size))
    assert (b.num_nodes == 1) == (n_tris <= leaf_size)
    for any_hit in (False, True):
        ck = torch.zeros((rays[0].shape[0], 2), dtype=torch.int32,
                         device=dev)
        ct = torch.zeros_like(ck)
        bt.reset_launches()
        kern = bt.bvh_traverse(b, *rays, any_hit=any_hit, counts=ck)
        twin = bt.bvh_traverse_ref(b, *rays, any_hit=any_hit, counts=ct)
        torch.cuda.synchronize()
        assert bt.LAUNCHES == {"closest": int(not any_hit),
                               "any": int(any_hit)}
        assert torch.equal(ck, ct)
        if any_hit:
            assert torch.equal(kern, twin)
            continue
        assert torch.equal(kern[1], twin[1])
        for a, c in zip(kern[::2] + (kern[3],), twin[::2] + (twin[3],)):
            assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    bt.raise_on_error(dev)


def test_bvh_walk_refuses_deep_trees_and_flags_wrong_depths(dev):
    tris, rays = _walk_rays(dev, n_tris=500, r=4096)
    b = sah.build_sah(tris, 1).to(dev)
    with pytest.raises(ValueError):
        bt.bvh_traverse(b.replace(max_depth=bt.STACK_CAP - 1), *rays,
                        any_hit=False)
    bt.bvh_traverse(b.replace(max_depth=2), *rays, any_hit=False)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="outgrew"):
        bt.raise_on_error(dev)
    bt.raise_on_error(dev)          # the word was cleared


def test_bvh_frame_on_the_default_device_flags_wrong_depths(dev):
    # device "cuda" has no index, the kernel's tensors lie on cuda:0: the
    # frame's own check must still read the error word they set
    b, camf = presets.cornell_box(bsdf_extras=True)
    r = Renderer(b.build(), RenderConfig(width=64, height=64, max_depth=3),
                 accel="sah", device="cuda")
    r.bvh = r.bvh.replace(max_depth=0)
    r._bind_accel()
    with pytest.raises(RuntimeError, match="outgrew"):
        r.render_frame(r.init_state(0), camf(1.0))
    bt.raise_on_error(dev)          # the word was cleared


@pytest.mark.parametrize("accel", ["sah", "lbvh"])
def test_bvh_frame_launches_both_modes(dev, accel):
    b, camf = presets.cornell_box(bsdf_extras=True)
    r = Renderer(b.build(), RenderConfig(width=64, height=64, max_depth=3),
                 accel=accel, device=dev)
    bt.reset_launches()
    img = r.render(camf(1.0), spp=2)
    assert np.isfinite(img).all() and img.mean() > 0.0
    assert bt.LAUNCHES == {"closest": 6, "any": 6}
