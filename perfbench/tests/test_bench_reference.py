"""The reference at a tiny size: its ray test against a float64
Möller–Trumbore, and its frames and gradients against the program's on the
CPU (the kernels' plain twins), on the same draws."""
import numpy as np
import pytest
import torch

from perfbench import port, scenes
from perfbench.reference import check
from perfbench.reference import pathtracer as pt

W, H = 48, 27
CFG = dict(width=W, height=H, max_depth=5, bsdf="disney",
           light_strategy="mis", jitter="random", remat=True)


@pytest.fixture(scope="module")
def spec():
    return scenes.make("interior", {"n_boxes": 60, "n_lights": 8})


def test_scene_is_the_presets(spec):
    from lumenrenderer_tpu_torch.scene import presets

    b, camf = presets.interior_scene(n_boxes=60, n_lights=8)
    sc = b.build()
    assert np.array_equal(sc.tri_pos.numpy(), spec.tri_pos)
    assert np.array_equal(sc.tri_mat.numpy(), spec.tri_mat)
    assert torch.equal(camf(16 / 9).eye,
                       port.camera(spec, 16, 9).eye)
    full = scenes.make("interior", {"n_boxes": 600, "n_lights": 64})
    assert full.num_triangles == 7338
    assert int((full.materials["emissive"][full.tri_mat].max(-1) > 0)
               .sum()) == 128


def test_ray_test_against_float64(spec):
    sc = pt.Scene(spec, "cpu")
    g = torch.Generator().manual_seed(0)
    o = torch.rand((400, 3), generator=g) * 18 + 1
    d = pt.normalize(torch.randn((400, 3), generator=g))
    tmax = torch.full((400,), 1e9)
    got = pt.intersect(sc, o, d, 1e-3, tmax, True)
    p = torch.as_tensor(spec.tri_pos, dtype=torch.float64)
    p0, e1, e2 = p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    od, dd = o.double()[:, None], d.double()[:, None]
    pv = torch.linalg.cross(dd.expand(-1, len(p), -1),
                            e2[None].expand(400, -1, -1))
    det = (e1[None] * pv).sum(-1)
    tv = od - p0[None]
    u = (tv * pv).sum(-1) / det
    qv = torch.linalg.cross(tv, e1[None].expand(400, -1, -1))
    v = (dd * qv).sum(-1) / det
    t = (e2[None] * qv).sum(-1) / det
    hit = (det.abs() > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-3)
    want = torch.where(hit, t, torch.inf).min(1)
    ok = torch.where(torch.isfinite(want.values), want.indices, -1)
    assert (got == ok).float().mean() > 0.99
    occ = pt.intersect(sc, o, d, 1e-3, tmax, False)
    assert torch.equal(occ, got >= 0)


def test_frames_equal_the_programs(spec):
    r = port.renderer(spec, {"renderer": {"accel": "tiled",
                                          "candidate_dtype": "high",
                                          "render_config": CFG}}, "cpu")
    cam = port.camera(spec, W, H)
    st = r.init_state(7)
    for _ in range(3):
        st, _ = r.render_frame(st, cam)
    got = check.progressive(spec, CFG, 7, 3, st.accum,
                            np.arange(W * H), 4096)
    assert got["l1_rel"] < 1e-5 and got["nonfinite"] == 0


def test_gradients_equal_the_programs(spec):
    from lumenrenderer_tpu_torch.parallel import train

    r = port.renderer(spec, {"renderer": {"accel": "tiled",
                                          "candidate_dtype": "high",
                                          "render_config": CFG}}, "cpu")
    cam = port.camera(spec, W, H)
    target = torch.full((W * H, 3), 0.1)
    init, step = train.make_train_step(
        r.scene, r._isect, r._occl, cam, r.config,
        lambda ps: torch.optim.Adam([ps["base_color"], ps["emissive"]],
                                    lr=0.01))
    ts = init()
    g = torch.Generator().manual_seed(3)
    ts, loss = step(ts, lambda *shape: torch.rand(shape, generator=g), 0,
                    target)
    bc = torch.tensor(spec.materials["base_color"]).requires_grad_()
    em = torch.tensor(spec.materials["emissive"]).requires_grad_()
    sc = pt.Scene(spec, "cpu", {"base_color": bc, "emissive": em})
    cam_r = pt.camera_basis(spec.eye, spec.target, spec.fov_y_deg, W / H,
                            "cpu")
    g = torch.Generator().manual_seed(3)
    draws = [torch.rand(s, generator=g) for s in pt.draw_shapes(W * H, CFG)]
    img = pt.radiance(sc, cam_r, W, H, torch.arange(W * H), draws, CFG)
    ref = ((img - target) ** 2).mean()
    ref.backward()
    assert float(loss) == pytest.approx(float(ref.detach()), rel=1e-6)
    for k, x in (("base_color", bc), ("emissive", em)):
        moment = ts.opt.state[ts.params[k]]["exp_avg"] / 0.1
        assert torch.allclose(moment, x.grad, rtol=1e-4, atol=1e-7)
