"""PyTorch port, the bf16 mode of kernel K2 on the tensor cores, on the CPU.

K2's bf16 mode runs K1's tensor-core loop, but its A fragments change with
every visit: each quad of lanes forms its four rays' object-space features
from the visit's affine, lane q its own ray q, rounds them to bfloat16
pairs and trades them by shuffles (`quad_fragments` in
ops/csrc/visit_scan_instanced.cu). Held here:

- (a) A plain emulation of that data flow (per visit, each lane's five
  bf16x2 words, the quad's two shuffle stages and selects and the
  broadcast of word 4, the A fragments read back into rows, then
  `test_torch_bf16_mma._emulate`: B tiles from `mma_layout`, `mma_product`
  per m16n8k16, slot 4j + q) equals the new twin bit for bit on keys and
  bits, closest and any, K = 32, 64 and 128, with a unit mesh of 13
  triangles (nlive not a multiple of 4) and dead lanes.
- (b) The twin against the jnp reference of `test_torch_options_bf16.py`
  (instanced.py's features rounded to bfloat16, times the rounded table by
  an einsum): bits equal; keys equal or a tie within the key's t quantum,
  the winner's visit and slot fields equal on >= 99% of the rays that both
  hit; visit lists uncapped and capped.
- (c) The instanced set's fragment-order table is made at its first bf16
  query and kept; a refit or a move makes a new set, which makes its own,
  and the fp32 slabs stay shared.
"""
import numpy as np
import pytest
import torch
from _torch_port_helpers import jax_instanced_builder, n, rng, t
from test_torch_bf16_mma import _emulate
from test_torch_options_bf16 import _k2_bf16_reference, _k2_inputs

from lumenrenderer_tpu.accel import two_level as jtwo
from lumenrenderer_tpu_torch.accel import stream as pstream
from lumenrenderer_tpu_torch.accel import tiled as ptiled
from lumenrenderer_tpu_torch.accel import two_level as ptwo
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.ops import visit_scan as pvs
from lumenrenderer_tpu_torch.ops import visit_scan_instanced as pvsi
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets

KEY_MISS = pvs.KEY_MISS


def random_mesh(g, count, size=0.6):
    return (g.normal(size=(count, 1, 3)) * size
            + g.normal(size=(count, 3, 3)) * 0.3).astype(np.float32)


def random_scene(g, k, n_inst=10):
    """Two meshes, 13 and 40 triangles (the first one unit whose nlive is
    not a multiple of 4), under rotated, scaled and moved instances."""
    meshes = [random_mesh(g, 13), random_mesh(g, 40)]
    mats = []
    for _ in range(n_inst):
        m4 = np.eye(4, dtype=np.float32)
        q, _ = np.linalg.qr(g.normal(size=(3, 3)))
        m4[:3, :3] = q * g.uniform(0.5, 1.5)
        m4[:3, 3] = g.uniform(-3, 3, 3)
        mats.append(m4)
    return ptwo.build_instanced(meshes, [i % 2 for i in range(n_inst)],
                                mats, cluster_size=k)


def boxes_scene(k):
    b, _ = presets.instanced_boxes(n_inst=24)
    return ptwo.build_instanced(*ptwo.instance_tables(b.instances),
                                cluster_size=k)


def aimed_inputs(g, ics, closest, r=512, mv=12):
    """K2's inputs for r rays aimed at the units' boxes, every 9th dead."""
    lo, hi = ics.aabb_lo.numpy(), ics.aabb_hi.numpy()
    o = g.uniform(-5, 5, (r, 3)).astype(np.float32)
    u = g.integers(0, lo.shape[0], r)
    aim = lo[u] + (hi[u] - lo[u]) * g.uniform(0, 1, (r, 3))
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tx = np.where(np.arange(r) % 9 == 0, -1.0,
                  1e8 if closest else 4.0).astype(np.float32)
    return ptwo.scan_inputs(ics, t(o), t(d.astype(np.float32)), 1e-3, t(tx),
                            mv)


# -- (a) the tensor-core data flow, emulated -----------------------------------


def _words(f):
    """(..., 10) float32 -> (..., 5) int64 bf16x2 words: features 2j (low
    half) and 2j + 1, rounded to nearest even, as `lumen::bf16x2`."""
    b = f.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    return b[..., 0::2] | (b[..., 1::2] << 16)


def _quad_fragments(words):
    """`quad_fragments` over every lane: words (T, 4 warps, 8 g, 4 q, 5),
    lane (w, g, q)'s own ray's words, -> its registers a[mt][h'] as
    {(mt, h'): (T, 4, 8, 4)}. xor(v, m) is __shfl_xor_sync, a lane's
    value of lane r of its quad is __shfl_sync from quad + r."""
    q = torch.arange(4)
    q0, q1 = (q & 1).bool(), (q & 2).bool()
    sel = torch.where
    xor = lambda v, m: v[..., q ^ m]
    w0, w1, w2, w3, w4 = words.unbind(-1)
    k0, k1 = sel(q0, w1, w0), sel(q0, w3, w2)
    r0, r1 = xor(sel(q0, w0, w1), 1), xor(sel(q0, w2, w3), 1)
    ka, kb = sel(q1, k1, k0), sel(q1, r1, r0)
    ra, rb = xor(sel(q1, k0, k1), 2), xor(sel(q1, r0, r1), 2)
    e0, e1 = sel(q0, kb, ka), sel(q0, ka, kb)
    o0, o1 = sel(q0, rb, ra), sel(q0, ra, rb)
    lane0 = q == 0
    from_lane = lambda v, r: sel(lane0, v[..., r:r + 1].expand_as(v), 0)
    return {(0, 0): sel(q1, o0, e0), (0, 1): sel(q1, o1, e1),
            (1, 0): sel(q1, e0, o0), (1, 1): sel(q1, e1, o1),
            (0, 2): from_lane(w4, 0), (0, 3): from_lane(w4, 1),
            (1, 2): from_lane(w4, 2), (1, 3): from_lane(w4, 3)}


def _halves(x):
    """int64 bf16x2 words -> (low, high) float32 values."""
    f = lambda b: (b << 16).to(torch.int32).view(torch.float32)
    return f(x & 0xFFFF), f(x >> 16)


def emulated_features(rayblk, m):
    """The A operand (T, 128, 16) the quads hold for one visit under the
    per-tile affines m (T, 12): each lane's ray formed once, the words
    traded, the registers read back into rows 32 w + 16 mt + 8 h + g
    (k 2q, 2q + 1 from a[mt][h], 2q + 8, 2q + 9 from a[mt][2 + h])."""
    tiles = rayblk.shape[0]
    f = pvsi.object_space_features(rayblk, m)                 # (T, 128, 10)
    # lane (w, g, q)'s own ray is row 32 w + 16 (q >> 1) + 8 (q & 1) + g
    own = f.view(tiles, 4, 2, 2, 8, 10).permute(0, 1, 4, 2, 3, 5)
    regs = _quad_fragments(_words(own.reshape(tiles, 4, 8, 4, 10)))
    a = torch.full((tiles, 4, 2, 2, 8, 16), float("nan"))
    for (mt, h2), reg in regs.items():
        lo, hi = _halves(reg)
        k0 = 8 * (h2 >> 1)
        a[:, :, mt, h2 & 1, :, k0:k0 + 8:2] = lo
        a[:, :, mt, h2 & 1, :, k0 + 1:k0 + 8:2] = hi
    return a.view(tiles, 128, 16)


def emulated_scan(args, kw):
    """K2's bf16 kernel emulated: per visit the quads' A fragments, then
    the tensor-core product and epilogue of `_emulate`; keys (bits) with
    the visit field, dead lanes 0 (closest) or 1 (any)."""
    rayblk, wnd, feats, sel_cl, minv12, nv, _ = args
    k, closest = kw["k"], kw["closest"]
    frags, nlive = pvs.mma_layout(feats, k)
    tmin, tmax = wnd[..., 0:1], wnd[..., 1:2]
    dead = wnd[..., 1] < wnd[..., 0]
    low_mask = ~((1 << kw["low_bits"]) - 1)
    state = (torch.full(dead.shape, KEY_MISS, dtype=torch.int32) if closest
             else dead.clone())
    for i in range(int(nv.max())):
        a = emulated_features(rayblk, minv12[:, i])
        want = pvs.round_bf16(pvsi.object_space_features(rayblk,
                                                         minv12[:, i]))
        assert torch.equal(a[..., :10], want)
        assert not bool(a[..., 10:].any())
        got = _emulate(a[..., :10], frags, nlive, sel_cl[:, i].long(), tmin,
                       tmax, k, closest, low_mask, i << kw["k_bits"])
        live = (i < nv)[:, None]
        if closest:
            state = torch.where(live, torch.minimum(state, got), state)
        else:
            state = state | (live & (got > 0))
    if closest:
        return torch.where(dead, 0, state)
    return state.to(torch.int32)


def _hold_emulation(ics, k, closest, seed):
    q = aimed_inputs(rng(seed), ics, closest)
    kw = dict(q["kw"], closest=closest)
    got = emulated_scan(q["args"], kw)
    want = pvsi.visit_scan_instanced(*q["args"], **kw, precision="default")
    assert torch.equal(got, want)
    live = q["args"][1][..., 1] >= q["args"][1][..., 0]
    if closest:
        hits = (want < KEY_MISS) & live
        assert int(hits.sum()) > 100
        field = want[hits] & ((1 << kw["low_bits"]) - 1)
        slots = field & ((1 << kw["k_bits"]) - 1)
        assert bool((slots % 4 != 0).any())
        assert bool(((field >> kw["k_bits"]) > 0).any())  # later visits win
    else:
        assert 50 < int(want[live].sum()) < int(live.sum())


@pytest.mark.parametrize("k", [32, 64, 128])
@pytest.mark.parametrize("closest", [True, False])
def test_emulated_quad_fragments_give_the_twins_keys(closest, k):
    ics = random_scene(rng(70 + k), k)
    nl = pvs.mma_layout(ics.tri_feat, k)[1]
    assert 13 in pvs.slab_layout(ics.tri_feat, k)[1].tolist()
    assert bool((nl % 4 == 0).all())
    _hold_emulation(ics, k, closest, 71 + k)


@pytest.mark.parametrize("closest", [True, False])
def test_emulated_quad_fragments_on_the_box_scene(closest):
    _hold_emulation(boxes_scene(128), 128, closest, 75)


# -- (b) the twin against the jnp reference ------------------------------------


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("closest", [True, False])
def test_k2_mma_twin_matches_jnp_reference(closest, capped):
    jb = jax_instanced_builder(n_inst=16)
    ics = jtwo.build_instanced(*ptwo.instance_tables(jb.instances),
                               cluster_size=64)
    g = rng(76)
    r = 1024
    o = g.uniform(-4, 4, (r, 3)).astype(np.float32)
    aim = g.uniform(-3, 3, (r, 3)).astype(np.float32)
    d = ((aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
         ).astype(np.float32)
    tn = np.full(r, 1e-3, np.float32)
    tx = np.where(np.arange(r) % 7 == 0, -1.0,
                  1e8 if closest else 5.0).astype(np.float32)
    mv = 5 if capped else ics.num_clusters
    args = _k2_inputs(ics, o, d, tn, tx, mv)
    k_bits, _, low_bits = ptiled.key_bits(64, mv)
    kw = dict(k=64, mv=mv, k_bits=k_bits, low_bits=low_bits, closest=closest)
    ref = _k2_bf16_reference(*args[:6], **kw)
    got = n(pvsi.visit_scan_instanced_ref(*map(t, args), **kw,
                                          precision="default"))
    if not closest:
        np.testing.assert_array_equal(got, ref)
        assert 100 < ref.sum() < r
        return
    low_mask = ~((1 << low_bits) - 1)
    t_of = lambda key: (key & low_mask).astype(np.int32).view(np.float32)
    both = (ref > 0) & (ref < KEY_MISS) & (got < KEY_MISS)
    quantum = np.maximum(t_of(got), t_of(ref)) * 2.0 ** -(23 - low_bits)
    tie = both & (np.abs(t_of(got) - t_of(ref)) <= quantum)
    assert ((got == ref) | tie).all()
    assert ((got & ~low_mask) == (ref & ~low_mask))[both].mean() >= 0.99
    assert both.sum() > 50


# -- (c) the table made once per instanced set --------------------------------


def test_instanced_bf16_layout_is_made_once_per_set(monkeypatch):
    made = []
    real = pstream.mma_layout

    def spy(*a, **kw):
        made.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(pstream, "mma_layout", spy)
    b, camf = presets.instanced_boxes(n_inst=20)
    r = Renderer(b.build(), RenderConfig(width=16, height=16, max_depth=3),
                 accel="two_level", builder=b, device="cpu",
                 candidate_dtype="bfloat16")
    st, _ = r.render_frame(r.init_state(0), camf(1.0))
    st, _ = r.render_frame(st, camf(1.0))
    assert len(made) == 1 and bool(torch.isfinite(st.accum).all())
    ics = r.instanced
    assert pstream.mma_kernel_layout(ics) is pstream.mma_kernel_layout(ics)
    assert len(made) == 1
    # a refit and a move make new sets, each its own; the fp32 one stays
    eye = torch.eye(4).expand(ics.inst_minv.shape[0], 4, 4).clone()
    eye[0, 0, 3] = 0.5
    for other in (ptwo.refit_instances(ics, eye), ics.to("cpu")):
        frags, nlive = pstream.mma_kernel_layout(other)
        assert other.slabs is ics.slabs
        assert torch.equal(frags, pvs.mma_layout(ics.tri_feat, 128)[0])
        assert torch.equal(nlive, pstream.mma_kernel_layout(ics)[1])
    assert len(made) == 3
    o = torch.tensor([[0.0, 1.0, 9.0]]).expand(256, 3).contiguous()
    dirs = torch.nn.functional.normalize(
        torch.from_numpy(rng(77).normal(size=(256, 3)).astype(np.float32)
                         * 0.2) + torch.tensor([0.0, -0.1, -1.0]), dim=-1)
    out = ptwo._query(ics, o, dirs, 1e-3, 1e9, 16, True, precision="default")
    ptwo._query(ics, o, dirs, 1e-3, 1e9, 16, False, precision="default")
    assert len(made) == 3 and int((out["tri"] >= 0).sum()) > 20
