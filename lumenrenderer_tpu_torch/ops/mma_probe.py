"""The tensor-core probe: how one bf16 m16n8k16 product sums its terms.

Kernels K1, K2 and K3 form their bf16 mode's product (the TPU kernels'
precision="default") on the tensor cores, whose float32 accumulation is no
chain of round-to-nearest fused multiply-adds. Published measurements of
earlier cards (Fasi, Higham, Mikaitis and Pranesh, "Numerical behavior of
NVIDIA tensor cores", PeerJ Computer Science, 2021) find the products
exact, then aligned to the largest exponent and truncated. This module
runs one `mma.sync` m16n8k16 (`csrc/mma_probe.cu`, through the wrapper the
kernels use) per case on crafted inputs and compares each float32 result
bit for bit with candidate models: the sequential float32 chain
(`visit_scan.ordered_product`), the exact sum rounded once, and
`visit_scan.mma_product` over a family of block sizes, alignments, kept
bits and roundings. The model that matches every case of the kernels'
kind (features in k slots 0-9, slots 10-15 zero) is the one the bf16
twins use (`visit_scan.MMA_MODEL`).

    python -m lumenrenderer_tpu_torch.ops.mma_probe     # on the card

On a CPU tensor `mma_probe` returns `mma_product` under MMA_MODEL, the
probe's plain twin; on a CUDA tensor it launches the kernel or raises.
The sign of a zero result is compared apart from its value: it cannot
change the kernels' test (|det| > 1e-12 fails, and -0 equals +0).
"""
from __future__ import annotations

import ctypes
import itertools
import json
from fractions import Fraction
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import build
from .visit_scan import mma_product, ordered_product

LAUNCHES = 0
CASES_PER_FAMILY = 32        # m16n8k16 products, 128 sums each
KERNEL_SLOTS = 10            # the kernels' features: k slots 0-9
# the families whose sums are of the kernels' kind; "full16" fills slots
# 10-15 too and shows the block structure
KERNEL_FAMILIES = ("random", "spread", "cancel", "ties", "zeros", "perm",
                   "rays")


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _sig_exp(g, shape, lo, hi):
    """Random bf16 values: a random 8-bit significand, a sign and an
    exponent uniform in [lo, hi]."""
    sig = 1.0 + g.integers(0, 128, shape) / 128.0
    sign = np.where(g.random(shape) < 0.5, -1.0, 1.0)
    return (sign * np.ldexp(sig, g.integers(lo, hi + 1, shape))).astype(
        np.float32)


def _rays_family(g, n):
    """The kernels' own sums: rounded ray features [o x d, d, o, 1] of
    random rays against rounded Moller-Trumbore columns of random
    triangles, as `accel/stream.py` forms them."""
    rows = []
    for _ in range(n * 16):
        o = g.uniform(-8, 8, 3)
        d = g.normal(size=3)
        d /= np.linalg.norm(d)
        rows.append(np.concatenate([np.cross(o, d), d, o, [1.0]]))
    a = np.zeros((n, 16, 16), np.float32)
    a[..., :KERNEL_SLOTS] = np.asarray(rows).reshape(n, 16, KERNEL_SLOTS)
    p0 = g.uniform(-8, 8, (n, 8, 3))
    e1 = g.normal(size=(n, 8, 3))
    e2 = g.normal(size=(n, 8, 3))
    nrm = np.cross(e1, e2)
    # det = -d . n, u.det, v.det and t.det as bilinear forms of the
    # features: columns of 10 coefficients (an affine stand-in whose
    # magnitudes and cancellations are those of the scene's table)
    cols = np.concatenate([
        np.cross(e2, p0) * 0.5, -nrm, np.cross(p0, e1) * 0.5,
        np.ones((n, 8, 1)) * g.normal(size=(n, 8, 1))], -1)
    b = np.zeros((n, 16, 8), np.float32)
    b[:, :KERNEL_SLOTS] = cols.transpose(0, 2, 1)
    return a, b


def probe_cases(seed: int = 0, n: int = CASES_PER_FAMILY
                ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Per family, (a (n,16,16), b (n,16,8)) float32 holding bf16 values:
    random (exponents in [-8, 8]); spread (a's exponents in [-40, 40]);
    cancel (two equal large terms of opposite sign and small ones); ties
    (1 + j/128, 2^-23 and 2^-24 times random signs: exact sums halfway
    between two float32); zeros (products of +0 and -0); perm (random's
    sums with their ten slots permuted); rays (the kernels' own sums);
    full16 (random in all 16 slots)."""
    g = np.random.default_rng(seed)
    ks = KERNEL_SLOTS
    out = {}

    def pad(a, b):
        a2 = np.zeros((n, 16, 16), np.float32)
        b2 = np.zeros((n, 16, 8), np.float32)
        a2[..., :a.shape[-1]] = a
        b2[:, :b.shape[1]] = b
        return _bf16(a2), _bf16(b2)

    out["random"] = pad(_sig_exp(g, (n, 16, ks), -8, 8),
                        _sig_exp(g, (n, ks, 8), -8, 8))
    out["spread"] = pad(_sig_exp(g, (n, 16, ks), -40, 40),
                        _sig_exp(g, (n, ks, 8), -4, 4))
    a = _sig_exp(g, (n, 16, ks), -30, 0)
    b = _sig_exp(g, (n, ks, 8), -4, 4)
    big = _sig_exp(g, (n, 16, 1), 8, 20)
    a[..., 0:1] = big
    a[..., 1:2] = big
    b[:, 1] = -b[:, 0]
    out["cancel"] = pad(a, b)
    a = np.zeros((n, 16, ks), np.float32)
    sgn = np.where(g.random((n, 16, 3)) < 0.5, -1.0, 1.0)
    a[..., 0] = sgn[..., 0] * (1.0 + g.integers(0, 128, (n, 16)) / 128.0)
    a[..., 3] = sgn[..., 1] * 2.0 ** -23
    a[..., 7] = sgn[..., 2] * 2.0 ** -24
    b = np.ldexp(np.ones((n, ks, 8), np.float32),
                 g.integers(-2, 3, (n, 1, 8))).astype(np.float32)
    out["ties"] = pad(a, b)
    a = np.where(g.random((n, 16, ks)) < 0.5, -0.0, 0.0).astype(np.float32)
    b = _sig_exp(g, (n, ks, 8), -4, 4)
    out["zeros"] = pad(a, b)
    a, b = (x.copy() for x in out["random"])
    for c in range(n):
        perm = g.permutation(ks)
        a[c, :, :ks] = a[c, :, perm].T
        b[c, :ks] = b[c, perm]
    out["perm"] = (a, b)
    out["rays"] = pad(*_rays_family(g, n))
    out["full16"] = (_bf16(_sig_exp(g, (n, 16, 16), -8, 8)),
                     _bf16(_sig_exp(g, (n, 16, 8), -8, 8)))
    return out


def mma_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """d (N,16,8) float32 = a (N,16,16) · b (N,16,8), one m16n8k16 bf16
    product each (a and b hold bf16 values in float32). On the CPU: the
    twin, `mma_product` under MMA_MODEL."""
    global LAUNCHES
    n = a.shape[0]
    build.check_tensors(a.device, {
        "a": (a, torch.float32, (n, 16, 16)),
        "b": (b, torch.float32, (n, 16, 8))})
    if a.device.type == "cpu":
        return mma_product(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"mma_probe runs on cpu or cuda, not {a.device}")
    fn = build.load_function("mma_probe", "mma_probe_launch",
                             [ctypes.c_void_p] * 3 + [ctypes.c_int]
                             + [ctypes.c_void_p])
    a16 = a.to(torch.bfloat16)
    b16 = b.to(torch.bfloat16)
    if not (torch.equal(a16.float(), a) and torch.equal(b16.float(), b)):
        raise ValueError("mma_probe takes bfloat16 values")
    d = torch.empty((n, 16, 8), dtype=torch.float32, device=a.device)
    build.launch(fn, a.device, a16.data_ptr(), b16.data_ptr(), d.data_ptr(),
                 n)
    LAUNCHES += 1
    return d


def exact_rn(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The exact sums (fractions) rounded once to float32, nearest even."""
    n = a.shape[0]
    out = np.empty((n, 16, 8), np.float32)
    fa = [[[Fraction(float(x)) for x in row] for row in case] for case in a]
    fb = [[[Fraction(float(x)) for x in row] for row in case] for case in b]
    for c, i, j in itertools.product(range(n), range(16), range(8)):
        s = sum(fa[c][i][k] * fb[c][k][j] for k in range(16))
        out[c, i, j] = _fraction_to_f32(s)
    return out


def _fraction_to_f32(s: Fraction) -> np.float32:
    """A fraction rounded to float32, nearest even (normal range)."""
    if s == 0:
        return np.float32(0.0)
    sign = -1 if s < 0 else 1
    s = abs(s)
    e = s.numerator.bit_length() - s.denominator.bit_length()
    if Fraction(2) ** e > s:
        e -= 1
    scaled = s / Fraction(2) ** (e - 23)          # in [2^23, 2^24)
    m = scaled.numerator // scaled.denominator
    rem = scaled - m
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and m % 2):
        m += 1
    return np.float32(sign * float(m) * 2.0 ** (e - 23))


def model_family() -> List[dict]:
    """The candidate models of `mma_product`: every block size, alignment,
    number of kept bits, and rounding of the terms and of the sum."""
    return [{"block": blk, "align": al, "frac_bits": fb, "term": tm,
             "final": fn}
            for blk in (16, 8, 4) for al in ("sum", "norm")
            for fb in range(22, 31) for tm in ("rz", "rd")
            for fn in ("rz", "rn")]


def model_name(m: dict) -> str:
    return (f"b{m['block']}-{m['align']}-f{m['frac_bits']}-{m['term']}-"
            f"{m['final']}")


def _differ(got: np.ndarray, want: np.ndarray) -> Tuple[int, int]:
    """(sums whose value differs, sums whose only difference is the sign
    of a zero)."""
    gb = got.view(np.uint32)
    wb = want.view(np.uint32)
    value = got != want
    zero_sign = (~value) & (gb != wb)
    return int(value.sum()), int(zero_sign.sum())


def compare(results: Dict[str, np.ndarray],
            cases: Dict[str, Tuple[np.ndarray, np.ndarray]]) -> dict:
    """Per model, per family: (value mismatches, zero-sign mismatches) of
    the card's `results` against the model on `cases`. Also returns the
    names of the models that match every sum of the kernels' families."""
    models = {"chain": lambda a, b: ordered_product(a, b).numpy(),
              "exact-rn": lambda a, b: exact_rn(a.numpy(), b.numpy())}
    for m in model_family():
        models[model_name(m)] = (
            lambda a, b, m=m: mma_product(a, b, m).numpy())
    table = {}
    for name, fn in models.items():
        table[name] = {fam: _differ(results[fam],
                                    fn(torch.from_numpy(a),
                                       torch.from_numpy(b)))
                       for fam, (a, b) in cases.items()}
    fits = [name for name, row in table.items()
            if all(row[f][0] == 0 for f in KERNEL_FAMILIES)]
    return {"table": table, "fits": fits}


PINNED_CASES = 8             # crafted sums printed bit for bit


def pinned(cases, results) -> List[dict]:
    """A few crafted sums of the spread, cancel and ties families with the
    card's result bits: the terms (a's row, b's column over slots 0-9) and
    the float32 result as hex."""
    rows = []
    for fam in ("spread", "cancel", "ties"):
        a, b = cases[fam]
        for c in range(PINNED_CASES // 2 if fam != "ties" else 2):
            rows.append({
                "family": fam,
                "a": [float(x) for x in a[c, 0, :KERNEL_SLOTS]],
                "b": [float(x) for x in b[c, :KERNEL_SLOTS, 0]],
                "bits": f"{int(results[fam][c, 0, 0].view(np.uint32)):08x}"})
    return rows


def run_probe(dev) -> dict:
    """Run every family on `dev` and compare: the `compare` table, the
    fitting models and the pinned cases."""
    cases = probe_cases()
    results = {}
    for fam, (a, b) in cases.items():
        results[fam] = mma_probe(torch.from_numpy(a).to(dev),
                                 torch.from_numpy(b).to(dev)).cpu().numpy()
    out = compare(results, cases)
    out["pinned"] = pinned(cases, results)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_probe: no CUDA device")
        return 1
    out = run_probe(torch.device("cuda", 0))
    fams = list(next(iter(out["table"].values())))
    print("model " + " ".join(fams))
    best = sorted(out["table"].items(),
                  key=lambda kv: sum(v[0] for f, v in kv[1].items()
                                     if f in KERNEL_FAMILIES))
    for name, row in best[:24] + [kv for kv in best
                                  if kv[0] in ("chain", "exact-rn")]:
        print(name, " ".join(f"{row[f][0]}/{row[f][1]}" for f in fams))
    print("fits", json.dumps(out["fits"]))
    print("pinned", json.dumps(out["pinned"]))
    return 0 if out["fits"] else 3


if __name__ == "__main__":
    raise SystemExit(main())
