"""Kernel K1 (ops/csrc/visit_scan.cu) on the card against its plain twin.

Marked `cuda`: these need an NVIDIA GPU with nvcc (Hopper, sm_90a) and skip
where torch.cuda.is_available() is False. Run them on the card with
`python -m pytest tests/test_torch_kernels.py -q`.
Tolerance: keys identical on at least 99.99% of rays, every differing key a
tie within the key's t resolution; occlusion bits identical.
"""
import numpy as np
import pytest
import torch

from lumenrenderer_tpu_torch.accel import stream, tiled
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.ops import visit_scan as vs
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K1 has no CPU mode)")
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


@pytest.mark.parametrize("closest", [True, False])
def test_kernel_matches_twin(dev, closest):
    q = _inputs(dev)
    kw = dict(q["kw"], closest=closest)
    vs.reset_launches()
    kern = vs.visit_scan(*q["args"], **kw)
    twin = vs.visit_scan_ref(*q["args"], **kw)
    torch.cuda.synchronize()
    assert vs.LAUNCHES["closest" if closest else "any"] == 1
    diff = kern != twin
    if not closest:
        assert not bool(diff.any())
        return
    assert float(diff.float().mean()) <= 1e-4
    mask = ~((1 << kw["low_bits"]) - 1)
    tk = (kern & mask).view(torch.float32)
    tt = (twin & mask).view(torch.float32)
    quantum = torch.maximum(tk, tt) * 2.0 ** -(23 - kw["low_bits"])
    assert bool(((tk - tt).abs() <= quantum)[diff].all())
    assert int((kern < vs.KEY_MISS).sum()) > 1000


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
