"""The roofline arithmetic on a hand-counted tile, and the frozen replay of
K1's vote against the program's own twin."""
import pytest
import torch

from perfbench import roofline, scenes, trace
from perfbench import port


def _tile(k=4):
    """One tile of 128 rays, 100 live; two clusters of K = 4 slots: cluster
    0 with 3 live triangles (slot 2 padding between), cluster 1 with 1."""
    feats = torch.zeros((2, 10, 4 * k))
    for slot in (0, 2):                       # cluster 0: slots 0 and 2
        feats[0, 0, slot] = 1.0               # ... so nlive = 3
    feats[1, 3, k + 0] = 2.0                  # cluster 1: slot 0
    rf_t = torch.zeros((1, 128, 12))
    rf_t[0, :, 10] = 1e-3
    rf_t[0, :100, 11] = 1e9                   # live: t_max >= t_min
    rf_t[0, 100:, 11] = -1.0
    sel = torch.tensor([[0, 1]], dtype=torch.int32)
    nv = torch.tensor([2], dtype=torch.int32)
    tnb = torch.zeros((1, 2), dtype=torch.int32)
    return rf_t, feats, sel, nv, tnb


def test_live_triangles_count_to_the_last_live_slot():
    _, feats, *_ = _tile()
    assert roofline.live_triangles(feats, 4).tolist() == [3.0, 1.0]


@pytest.mark.parametrize("ran,pairs", [(2, 100 * (3 + 1)), (1, 100 * 3),
                                       (0, 0)])
def test_flop_counts_live_pairs_of_the_visits_run(ran, pairs):
    rf_t, feats, sel, nv, tnb = _tile()
    visits = torch.tensor([ran], dtype=torch.int32)
    assert roofline.visit_flop(rf_t, feats, sel, visits, 4) == 80 * pairs


def test_bytes_and_bound():
    rf_t, feats, sel, nv, tnb = _tile()
    nb = roofline.visit_bytes(rf_t, feats, sel, nv, tnb)
    assert nb == (128 * 12 * 4 + 2 * 10 * 16 * 4 + 2 * 4 + 4 + 2 * 4
                  + 128 * 4)
    s, what = roofline.bound_s(80 * 400, nb)
    assert what == "bytes" and s == pytest.approx(nb / 3.35e12)
    s, what = roofline.bound_s(67e12, 1.0)
    assert what == "operations" and s == pytest.approx(1.0)


@pytest.fixture(scope="module")
def passes():
    """The primary, sorted bounce and sorted shadow passes of a small frame,
    through the tiled accel's scan inputs."""
    from lumenrenderer_tpu_torch.accel import tiled
    from lumenrenderer_tpu_torch.integrator import wavefront
    from lumenrenderer_tpu_torch.render.renderer import Renderer

    spec = scenes.make("interior", {"n_boxes": 60, "n_lights": 8})
    r = Renderer(port.build_scene(spec),
                 port.render_config(dict(width=64, height=36, max_depth=3)),
                 device="cpu", max_visits=64)
    cam = port.camera(spec, 64, 36)
    g = torch.Generator().manual_seed(5)

    def render(isect, occl):
        wavefront.render_wavefront(
            r.scene, isect, occl, cam,
            lambda *shape: torch.rand(shape, generator=g), 0, r.config)

    got = trace.capture_passes(render, r._isect, r._occl)
    assert set(got) == {"primary", "bounce", "shadow"}
    return [(tiled.scan_inputs(r.clusters, *rays, r.max_visits), closest)
            for rays, closest in got.values()]


def test_frozen_replay_equals_the_programs_twin(passes):
    from lumenrenderer_tpu_torch.ops import visit_scan as vs

    for q, closest in passes:
        kw = dict(q["kw"], closest=closest)
        ours = roofline.replay_visits(*q["args"], **kw)
        theirs = vs.executed_visits_ref(*q["args"], **kw)
        assert torch.equal(ours, theirs)
        assert int(ours.sum()) > 0
