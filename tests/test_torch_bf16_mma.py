"""PyTorch port, the bf16 mode of kernels K1 and K3 on the tensor cores, on
the CPU: the table in fragment order (`visit_scan.mma_layout`), the
tensor cores' sum (`visit_scan.mma_product`, the model that
`ops/mma_probe.py` fitted to the card), and the twins built on it.

- `mma_layout` un-permuted equals the rounded table; padding groups are
  zero and nlive is rounded up to 4.
- A plain emulation of the kernels' data flow (B tiles read back from the
  fragments, each lane's accumulators, the slot 4j + q) gives the twins'
  keys and bits bit for bit.
- `mma_product` equals an independent rational (`fractions.Fraction`)
  evaluation of the model on random sums, equals the exact sum cut toward
  zero where no term is cut, and reproduces the card's results on the
  probe's pinned cases (copied from an H100's probe output).
- K1's and K3's bf16 twins against the Pallas kernels in interpret mode at
  precision="highest" on bf16-rounded inputs (on the CPU JAX's DEFAULT is
  exact float32), at `test_torch_options_bf16.py`'s tolerances: bits
  equal; keys equal or a tie within the key's t quantum plus the Pallas
  kernel's 2^-16 reciprocal error, winners equal on >= 99% of rays.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_helpers import n, port_clusters, rng, t

from lumenrenderer_tpu.accel import stream as jstream, tiled as jtiled
from lumenrenderer_tpu.ops.pallas import intersect as jpk
from lumenrenderer_tpu.ops.pallas import pair_intersect as jppk
from lumenrenderer_tpu_torch.accel import pairs as ppairs
from lumenrenderer_tpu_torch.accel import stream as pstream
from lumenrenderer_tpu_torch.accel import tiled as ptiled
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig
from lumenrenderer_tpu_torch.ops import mma_probe as mp
from lumenrenderer_tpu_torch.ops import pair_scan as pps
from lumenrenderer_tpu_torch.ops import visit_scan as pvs
from lumenrenderer_tpu_torch.render.renderer import Renderer
from lumenrenderer_tpu_torch.scene import presets

KEY_MISS = pvs.KEY_MISS

# One H100's probe results (NVIDIA H100 80GB HBM3, 700.00 W): a's row and
# b's column over k slots 0-9 (10-15 zero), and the float32 result's bits.
PINNED = [
    ("spread", [-116.5, -3623878656.0, 15.4375, 2.2964741219766438e-11,
                -4.887580871582031e-05, 2944.0, 2.1100277081131935e-10,
                1.4495071809506044e-11, -203423744.0, 1.0231815394945443e-11],
     [-0.10400390625, 0.93359375, 13.3125, 23.5, -7.5625, 0.0791015625,
      -6.65625, 21.875, -0.40234375, 0.64453125], 0xcf44c71e),
    ("spread", [-102.5, -0.003448486328125, -3129344.0, -0.00543212890625,
                -2352.0, 52613349376.0, -12386304.0, 484.0,
                -148176371712.0, 106496.0],
     [0.08642578125, -2.984375, -0.115234375, -4.75, 9.6875, -15.125,
      0.0810546875, 1.484375, 0.478515625, -2.859375], 0xd349ca4e),
    ("spread", [2.0804691303055733e-11, -103424.0, -254803968.0,
                1.0251998901367188e-05, 19529728.0, -0.042724609375,
                0.0498046875, 7.53125, -4.3213367462158203e-07,
                -1494648619008.0],
     [3.21875, -6.8125, -0.2431640625, 0.1611328125, -4.875, 0.2109375,
      5.90625, -0.302734375, -0.478515625, 0.1181640625], 0xd22483c2),
    ("spread", [0.043212890625, 7.450580596923828e-08, -0.000621795654296875,
                -6.6875, 2.0372681319713593e-09, 2320.0,
                9.298324584960938e-06, -3866624.0, 5.820766091346741e-09,
                1256.0],
     [0.494140625, 0.1298828125, 0.23046875, 11.125, -0.16796875, 17.625,
      -17.0, 1.2421875, 5.1875, -0.439453125], 0xca915970),
    ("cancel", [37888.0, 37888.0, -4.649162292480469e-06,
                -2.16066837310791e-06, -0.169921875, -1.0207295417785645e-06,
                -2.041459083557129e-06, -0.0005340576171875,
                0.00010776519775390625, 8.392333984375e-05],
     [2.03125, -2.03125, 5.0625, -19.125, -29.625, 1.84375, -27.0, 30.5,
      -0.3671875, 7.0], 0x40a09000),
    ("cancel", [2031616.0, 2031616.0, -0.000244140625, 0.6015625,
                -0.00836181640625, 6.580352783203125e-05,
                1.3096723705530167e-08, -0.003936767578125,
                -8.288770914077759e-08, 0.0001125335693359375],
     [25.5, -25.5, -11.0, 0.2041015625, -0.376953125, 1.859375, 3.46875,
      -8.375, -22.625, -4.59375], 0x00000000),
    ("cancel", [1908736.0, 1908736.0, -0.006591796875,
                -4.330649971961975e-08, 0.005767822265625, -0.015625,
                0.00019931793212890625, -0.0002593994140625,
                -7.776543498039246e-08, 2.1696090698242188e-05],
     [-3.859375, 3.859375, 0.125, 0.2431640625, 2.046875, 11.6875,
      -3.78125, 16.875, 22.625, -0.86328125], 0xbe000000),
    ("cancel", [63232.0, 63232.0, 2.5727786123752594e-08,
                -5.8906152844429016e-08, 0.1396484375, 2.3632310330867767e-08,
                0.00762939453125, -8.249282836914062e-05, -0.265625,
                -2.7418136596679688e-06],
     [-0.064453125, 0.064453125, 0.134765625, 4.375, 0.8984375, -0.25,
      -0.427734375, -1.515625, -0.58203125, 0.2041015625], 0x3e8dc800),
    ("ties", [-1.671875, 0.0, 0.0, -1.1920928955078125e-07, 0.0, 0.0, 0.0,
              -5.960464477539063e-08, 0.0, 0.0], [1.0] * 10, 0xbfd60001),
    ("ties", [1.8984375, 0.0, 0.0, 1.1920928955078125e-07, 0.0, 0.0, 0.0,
              5.960464477539063e-08, 0.0, 0.0], [0.5] * 10, 0x3f730001),
]


def bf16(x):
    return pvs.round_bf16(torch.tensor(np.asarray(x, np.float32))).numpy()


def random_tris(g, count, spread=2.5):
    c = g.uniform(-spread, spread, size=(count, 1, 3))
    return (c + g.normal(size=(count, 3, 3)) * 0.2).astype(np.float32)


def aimed_rays(g, tris, count, spread=4.0):
    o = g.uniform(-spread, spread, size=(count, 3)).astype(np.float32)
    aim = tris[g.integers(0, len(tris), count)].mean(1)
    d = aim + g.normal(size=(count, 3)) * 0.1 - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


# -- the table in fragment order ---------------------------------------------


@pytest.mark.parametrize("k", [32, 64, 128])
def test_mma_layout_unpermutes_to_the_rounded_table(k):
    g = rng(60 + k)
    c = 6
    feats = torch.from_numpy(g.normal(size=(c, 10, 4 * k)).astype(
        np.float32))
    cut = [k, 1, k // 2 + 1, 3, k - 1, 4]        # live slots per cluster
    for cl, live in enumerate(cut):
        feats.view(c, 10, 4, k)[cl, :, :, live:] = 0.0
    frags, nlive = pvs.mma_layout(feats, k)
    assert frags.dtype == torch.bfloat16 and frags.shape == (c, k // 4, 32, 8)
    assert torch.equal(nlive, torch.tensor(
        [min(k, (x + 3) // 4 * 4) for x in cut], dtype=torch.int32))
    assert torch.equal(pvs.slab_layout(pvs.round_bf16(feats), k)[1],
                       torch.tensor(cut, dtype=torch.int32))
    # lane 4g + q, tile h, value i: row kk of column g of tile h, column g
    # being quantity 2h + g % 2 of triangle 4j + g // 2
    lane = torch.arange(32)
    gg, qq = lane // 4, lane % 4
    rows = torch.stack([2 * qq, 2 * qq + 1, 2 * qq + 8, 2 * qq + 9], -1)
    table = torch.zeros((c, 16, 4 * k))
    v = frags.float().view(c, k // 4, 32, 2, 4)
    for j in range(k // 4):
        for h in range(2):
            col = (2 * h + gg % 2) * k + 4 * j + gg // 2          # (32,)
            table[:, rows, col[:, None].expand(32, 4)] = v[:, j, :, h]
    assert torch.equal(table[:, :10], pvs.round_bf16(feats))
    assert not bool(table[:, 10:].any())
    # the groups past nlive are padding: zero
    for cl in range(c):
        assert not bool(frags[cl, int(nlive[cl]) // 4:].float().any())
    with pytest.raises(ValueError):
        pvs.mma_layout(torch.zeros((1, 10, 4 * 6)), 6)


def _emulate(rf, frags, nlive, cl_of_tile, tmin, tmax, k, closest,
             low_mask, visit_field):
    """The kernels' data flow for one visit per tile, in plain PyTorch: the
    B tiles read back from each group's fragments, the product per m16n8k16
    (`mma_product`), lane q's columns 2q, 2q + 1 of each tile as det, u and
    v, t of triangle 4j + q, the epilogue, the key with slot 4j + q.
    rf (T,128,10) rounded, tmin/tmax (T,128,1): (T,128) keys or bits."""
    tiles = rf.shape[0]
    a = torch.zeros((tiles, 128, 16))
    a[..., :10] = rf
    fr = frags.float()[cl_of_tile]                     # (T, K/4, 32, 8)
    lane = torch.arange(32)
    gg, qq = lane // 4, lane % 4
    rows = torch.stack([2 * qq, 2 * qq + 1, 2 * qq + 8, 2 * qq + 9], -1)
    best = torch.full((tiles, 128), KEY_MISS, dtype=torch.int32)
    occ = torch.zeros((tiles, 128), dtype=torch.bool)
    ng = nlive[cl_of_tile] // 4
    for j in range(k // 4):
        d = []
        for h in range(2):
            b = torch.zeros((tiles, 16, 8))
            b[:, rows, gg[:, None].expand(32, 4)] = fr[:, j, :, 4 * h:4 * h + 4]
            d.append(pvs.mma_product(a, b))            # (T, 128, 8)
        for q in range(4):
            det, un = d[0][..., 2 * q], d[0][..., 2 * q + 1]
            vn, tn = d[1][..., 2 * q], d[1][..., 2 * q + 1]
            s = torch.where(det < 0, -1.0, 1.0)
            ad, us, vs, ts = det.abs(), un * s, vn * s, tn * s
            hit = ((ad > 1e-12) & (us >= 0) & (vs >= 0) & (us + vs <= ad)
                   & (ts > tmin[..., 0] * ad) & (ts <= tmax[..., 0] * ad)
                   & (j < ng)[:, None])
            if closest:
                tb = (ts / torch.where(ad > 1e-12, ad, 1.0)).clamp_min(
                    0.0).view(torch.int32)
                key = (tb & low_mask) | visit_field | (4 * j + q)
                best = torch.where(hit, torch.minimum(best, key), best)
            else:
                occ |= hit
    return best if closest else occ.to(torch.int32)


@pytest.mark.parametrize("closest", [True, False])
def test_fragment_order_gives_the_twins_keys(closest):
    """K3's bf16 twin against the emulated kernel on the same pair tiles:
    the key's slot field found through the fragment order is the twin's
    slot, and every key (bit) is equal."""
    g = rng(61)
    tris = random_tris(g, 500)
    cs = port_clusters(jstream.build_clusters(jnp.asarray(tris),
                                              cluster_size=32))
    o, d = aimed_rays(g, tris, 1200)
    q = ppairs.scan_inputs(cs, t(o), t(d), 1e-3, 1e8 if closest else 3.0,
                           128, 16)
    rf_pairs, feats, tile_cluster = q["args"]
    kw = dict(q["kw"], closest=closest)
    want = pps.pair_scan(*q["args"], **kw, precision="default")
    rf = rf_pairs.view(-1, 128, 12)
    frags, nlive = pvs.mma_layout(feats, 32)
    got = _emulate(pvs.round_bf16(rf[..., :10]), frags, nlive,
                   tile_cluster.long(), rf[..., 10:11], rf[..., 11:12], 32,
                   closest, ~((1 << kw["k_bits"]) - 1), 0)
    assert torch.equal(got.reshape(-1), want)
    if closest:
        hits = want < KEY_MISS
        assert int(hits.sum()) > 200
        slots = want[hits] & ((1 << kw["k_bits"]) - 1)
        assert int(slots.max()) > 20 and bool((slots % 4 != 0).any())
    else:
        assert int(want.sum()) > 200


# -- the tensor cores' sum -----------------------------------------------------


def _parts(x: float):
    """(sign, 8-bit significand, exponent of the significand's lsb)."""
    if x == 0:
        return 1, 0, 0
    m, e = np.frexp(abs(float(x)))
    return (-1 if x < 0 else 1), int(m * 256), int(e) - 8


def _rz_f32(s: Fraction) -> Fraction:
    """A fraction cut toward zero to float32 (normal range)."""
    if s == 0:
        return s
    sign = -1 if s < 0 else 1
    s = abs(s)
    e = s.numerator.bit_length() - s.denominator.bit_length()
    if Fraction(2) ** e > s:
        e -= 1
    m = int(s / Fraction(2) ** (e - 23))
    return sign * m * Fraction(2) ** (e - 23)


def _model_fraction(a, b):
    """MMA_MODEL over one sum, in rationals: the products aligned to the
    largest exponent sum of 1.x times 1.x, each cut toward zero 25 bits
    below it, summed, the sum cut toward zero to float32."""
    m = pvs.MMA_MODEL
    assert (m["block"], m["align"], m["term"], m["final"]) == (
        16, "sum", "rz", "rz")
    terms, lead = [], None
    for x, y in zip(a, b):
        sx, mx, ex = _parts(x)
        sy, my, ey = _parts(y)
        if mx and my:
            terms.append((sx * sy, mx * my, ex + ey))
            es = ex + 7 + ey + 7
            lead = es if lead is None else max(lead, es)
    if lead is None:
        return Fraction(0)
    quantum = Fraction(2) ** (lead - m["frac_bits"])
    total = Fraction(0)
    for sg, mag, e in terms:
        total += sg * int(mag * Fraction(2) ** e / quantum) * quantum
    return _rz_f32(total)


def _random_sums(g, count, lo, hi, slots=10):
    sig = 1.0 + g.integers(0, 128, (2, count, slots)) / 128.0
    sgn = np.where(g.random((2, count, slots)) < 0.5, -1.0, 1.0)
    ex = g.integers(lo, hi + 1, (2, count, slots))
    v = (sgn * np.ldexp(sig, ex)).astype(np.float32)
    v[g.random(v.shape) < 0.1] = 0.0
    return v[0], v[1]


@pytest.mark.parametrize("lo,hi", [(-3, 3), (-30, 30)])
def test_mma_product_equals_the_model_in_rationals(lo, hi):
    g = rng(62 + hi)
    a, b = _random_sums(g, 600, lo, hi)
    got = pvs.mma_product(torch.from_numpy(a)[:, None],
                          torch.from_numpy(b)[..., None])[:, 0, 0].numpy()
    want = np.array([float(_model_fraction(x, y)) for x, y in zip(a, b)],
                    np.float32)
    np.testing.assert_array_equal(got, want)


def test_mma_product_is_the_exact_sum_where_no_term_is_cut():
    """Products within 11 binades of the largest lose no bit to the
    alignment (16-bit significands, 25 bits kept): the result is the exact
    sum cut toward zero to float32, and the exact sum itself where it fits
    in 24 bits."""
    g = rng(63)
    a, b = _random_sums(g, 800, -2, 2)
    exact_fits = 0
    for x, y in zip(a, b):
        s = sum(Fraction(float(p)) * Fraction(float(q))
                for p, q in zip(x, y))
        got = pvs.mma_product(torch.from_numpy(x)[None, None],
                              torch.from_numpy(y)[None, :, None])
        assert Fraction(float(got)) == _rz_f32(s)
        if _rz_f32(s) == s:
            exact_fits += 1
            assert Fraction(float(got)) == s
    assert exact_fits > 50
    # the chain of float32 FMAs is another model: it differs somewhere
    a, b = _random_sums(g, 2000, -20, 20)
    ta, tb = torch.from_numpy(a)[:, None], torch.from_numpy(b)[..., None]
    assert not torch.equal(pvs.mma_product(ta, tb),
                           pvs.ordered_product(ta, tb))


def test_mma_product_gives_the_cards_pinned_results():
    for family, a, b, bits in PINNED:
        got = pvs.mma_product(torch.tensor(a)[None, None],
                              torch.tensor(b)[None, :, None])
        assert int(got.view(torch.int32)) & 0xFFFFFFFF == bits, family
        assert float(got) == float(_model_fraction(a, b))


def test_probe_twin_and_model_family_on_the_cpu():
    """The probe's wrapper on CPU tensors is its twin, `mma_product`; its
    families keep slots 10-15 zero but full16; `compare` finds the model
    the results came from and rules out the chain and the exact sum."""
    cases = mp.probe_cases(seed=1, n=4)
    for fam, (a, b) in cases.items():
        assert a.shape == (4, 16, 16) and b.shape == (4, 16, 8)
        assert torch.equal(t(a).to(torch.bfloat16).float(), t(a))
        assert bool((a[..., 10:] != 0).any()) == (fam == "full16")
    mp.LAUNCHES = 0
    results = {fam: mp.mma_probe(t(a), t(b)).numpy()
               for fam, (a, b) in cases.items()}
    assert mp.LAUNCHES == 0
    out = mp.compare(results, cases)
    assert mp.model_name(pvs.MMA_MODEL) in out["fits"]
    assert "chain" not in out["fits"] and "exact-rn" not in out["fits"]
    assert len(mp.model_family()) == 216


# -- the twins against the Pallas kernels on rounded inputs --------------------


def _same_or_tie(got, ref, low_bits):
    low_mask = ~((1 << low_bits) - 1)
    t_of = lambda key: (key & low_mask).astype(np.int32).view(np.float32)
    both = (ref < KEY_MISS) & (got < KEY_MISS)
    rel = 2.0 ** -(23 - low_bits) + 2.0 ** -16
    quantum = np.maximum(t_of(got), t_of(ref)) * rel
    tie = both & (np.abs(t_of(got) - t_of(ref)) <= quantum)
    assert ((got == ref) | tie).all()
    assert ((got & ~low_mask) == (ref & ~low_mask))[both].mean() >= 0.99
    assert both.sum() > 100


@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("closest", [True, False])
def test_k1_mma_twin_matches_rounded_pallas(closest, k):
    g = rng(64 + k)
    tris = random_tris(g, 700)
    cs = jstream.build_clusters(jnp.asarray(tris), cluster_size=k)
    r, mv = 1024, cs.num_clusters
    o, d = aimed_rays(g, tris, r)
    tn = np.full(r, 1e-4, np.float32)
    tx = np.where(np.arange(r) % 5 == 0, -1.0, 1e9).astype(np.float32)
    order, valid, tnear, _ = jtiled._frustum_visits(
        cs, *map(jnp.asarray, (o, d, tn, tx)), r // 128, mv)
    rf = np.asarray(jstream.ray_features(jnp.asarray(o), jnp.asarray(d)))
    rf_t = np.concatenate([rf, tn[:, None], tx[:, None]], 1).reshape(
        -1, 128, 12).astype(np.float32)
    bits = np.maximum(np.asarray(tnear), 0).astype(np.float32).view(np.int32)
    tnb = np.where(np.asarray(valid), np.minimum(bits, KEY_MISS - 1),
                   KEY_MISS).astype(np.int32)
    sel = np.asarray(order, np.int32)
    nv = np.asarray(valid).sum(1).astype(np.int32)
    k_bits, _, low_bits = ptiled.key_bits(k, mv)
    kw = dict(k=k, mv=mv, k_bits=k_bits, low_bits=low_bits, closest=closest)
    rf_r = rf_t.copy()
    rf_r[..., :10] = bf16(rf_t[..., :10])
    ref = np.asarray(jpk.visit_scan(
        jnp.asarray(rf_r), jnp.asarray(bf16(cs.tri_feat)), cs.tri_id,
        jnp.asarray(sel), jnp.asarray(nv), jnp.asarray(tnb), interpret=True,
        precision="highest", **kw))
    args = (t(rf_t), t(cs.tri_feat), t(sel), t(nv), t(tnb))
    got = n(pvs.visit_scan(*args, **kw, precision="default"))
    if closest:
        _same_or_tie(got, ref, low_bits)
    else:
        np.testing.assert_array_equal(got, ref)
        assert ref.sum() > 100


@pytest.mark.parametrize("closest", [True, False])
def test_k3_mma_twin_matches_rounded_pallas(closest):
    g = rng(66)
    tris = random_tris(g, 500, spread=2.0)
    cs = jstream.build_clusters(jnp.asarray(tris), cluster_size=64)
    o, d = aimed_rays(g, tris, 1300)
    tx = np.where(np.arange(1300) % 7 == 0, -1.0,
                  1e8 if closest else 1.5).astype(np.float32)
    q = ppairs.scan_inputs(port_clusters(cs), t(o), t(d), 1e-3, t(tx), 128,
                           16)
    rf_pairs, feats, tile_cluster = map(n, q["args"])
    kw = dict(q["kw"], closest=closest)
    rf_r = rf_pairs.copy()
    rf_r[:, :10] = bf16(rf_pairs[:, :10])
    ref = np.asarray(jppk.pair_scan(jnp.asarray(rf_r),
                                    jnp.asarray(bf16(feats)),
                                    jnp.asarray(tile_cluster), interpret=True,
                                    precision="highest", **kw))
    got = n(pps.pair_scan(*q["args"], **kw, precision="default"))
    if closest:
        _same_or_tie(got, ref, kw["k_bits"])
    else:
        np.testing.assert_array_equal(got, ref)
        assert ref.sum() > 100


# -- the layout made once per ClusterSet ---------------------------------------


def test_bf16_layout_is_made_once_per_cluster_set(monkeypatch):
    made = []
    real = pstream.mma_layout

    def spy(*a, **kw):
        made.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(pstream, "mma_layout", spy)
    b, camf = presets.cornell_box(with_blocks=True)
    r = Renderer(b.build(), RenderConfig(width=16, height=16, max_depth=3),
                 device="cpu", candidate_dtype="bfloat16")
    st, _ = r.render_frame(r.init_state(0), camf(1.0))
    st, _ = r.render_frame(st, camf(1.0))
    assert len(made) == 1 and bool(torch.isfinite(st.accum).all())
    cs = r.clusters
    assert pstream.mma_kernel_layout(cs) is pstream.mma_kernel_layout(cs)
    assert len(made) == 1
    # a set made anew (a move, a refit) makes its own; the fp32 one stays
    moved = cs.to("cpu")
    frags, nlive = pstream.mma_kernel_layout(moved)
    assert len(made) == 2 and moved.slabs is cs.slabs
    assert torch.equal(frags, pvs.mma_layout(cs.tri_feat, 128)[0])
    isect, occl = ppairs.pair_intersectors(cs, max_visits=8,
                                           max_pairs_per_ray=4,
                                           decode=False, precision="default")
    o = torch.tensor([[0.0, 1.0, 3.0]]).expand(128, 3).contiguous()
    dirs = torch.nn.functional.normalize(
        torch.from_numpy(rng(67).normal(size=(128, 3)).astype(np.float32))
        + torch.tensor([0.0, 0.0, -2.0]), dim=-1)
    isect(o, dirs, 1e-3, 1e9)
    occl(o, dirs, 1e-3, 1e9)
    assert len(made) == 2
