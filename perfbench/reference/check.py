"""What decides `correct`: the program's outputs against the reference's,
computed again from the benchmark's own inputs and seeds.

The frame state's draws are replayed from the seed the program was given:
a `torch.Generator` on the same device, seeded alike, drawn in the frame's
order and shapes, gives the same numbers, so both sides trace the same
samples.
"""
from __future__ import annotations

import statistics
from typing import Dict, Sequence

import numpy as np
import torch

from perfbench.reference import pathtracer as pt


def _frame_draws(gen, shapes, device, rows=None):
    out = []
    for shape in shapes:
        x = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32)
        out.append(x if rows is None else x[rows])
    return out


def _check_device(device):
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def sample_pixels(seed: int, n_pixels: int, count: int) -> np.ndarray:
    rng = np.random.default_rng([seed, 7])
    return np.sort(rng.choice(n_pixels, size=min(count, n_pixels),
                              replace=False))


def progressive(spec, rcfg: Dict, seed: int, frames: int, accum: torch.Tensor,
                pixels: np.ndarray, rays_per_block: int) -> Dict[str, float]:
    """The accumulated image of `frames` 1-spp frames from a state seeded
    with `seed`, at `pixels`, against the program's `accum` (N,3).

    Returns l1_rel (the sum of |program - reference| over the sum of
    |reference|, every channel of every pixel checked) and nonfinite
    (values of the whole accumulated image that are not finite)."""
    dev = accum.device
    _check_device(dev)
    w, h = rcfg["width"], rcfg["height"]
    n = w * h
    pix = torch.as_tensor(pixels, device=dev)
    s = pix.shape[0]
    scene = pt.Scene(spec, dev)
    cam = pt.camera_basis(spec.eye, spec.target, spec.fov_y_deg, w / h, dev)
    shapes = pt.draw_shapes(n, rcfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ref = torch.zeros((s, 3), device=dev)
    per = max(1, rays_per_block // s)
    with torch.no_grad():
        for f0 in range(0, frames, per):
            fs = min(frames, f0 + per) - f0
            cols = [[] for _ in shapes]
            for _ in range(fs):
                for c, x in zip(cols, _frame_draws(gen, shapes, dev, pix)):
                    c.append(x)
            img = pt.radiance(scene, cam, w, h, pix.repeat(fs),
                              [torch.cat(c) for c in cols], rcfg)
            for i, x in enumerate(img.view(fs, s, 3)):
                k = float(f0 + i)
                ref = (ref * k + x) / (k + 1.0)
        gap = (accum[pix] - ref).abs().sum()
        return {"l1_rel": float(gap / ref.abs().sum().clamp_min(1e-30)),
                "nonfinite": float((~torch.isfinite(accum)).sum())}


def _image(scene, cam, rcfg, draws, rays_per_block, grad_of=None):
    """The whole frame in blocks of rows; with grad_of=(target, scale), the
    summed squared error of each block times scale is differentiated
    block by block, and the loss is returned instead of the image."""
    w, h = rcfg["width"], rcfg["height"]
    n = w * h
    dev = draws[0].device
    out = None if grad_of else torch.empty((n, 3), device=dev)
    loss = 0.0
    for a in range(0, n, rays_per_block):
        b = min(n, a + rays_per_block)
        pix = torch.arange(a, b, device=dev)
        img = pt.radiance(scene, cam, w, h, pix, [x[a:b] for x in draws],
                          rcfg)
        if grad_of is None:
            out[a:b] = img
            continue
        target, scale = grad_of
        lb = ((img - target[a:b]) ** 2).sum() * scale
        lb.backward()
        loss += float(lb.detach().double())
    return out if grad_of is None else loss


def fit(spec, rcfg: Dict, target_seed: int, target_frames: int,
        step_seeds: Sequence[int], start: Dict[str, torch.Tensor], opt: Dict,
        program: Dict, rays_per_block: int) -> Dict[str, float]:
    """The reference's target (the running mean of `target_frames` frames
    from a state seeded `target_seed`, at the scene's own materials), then
    len(step_seeds) steps of the fit from `start` (name -> (M,3) fitted
    material column): the loss (mean squared error over every pixel and
    channel) of a frame drawn from each step seed, its gradient, and Adam.

    `program` holds the program's readings: "losses" of those steps, "grad"
    (name -> the first step's gradient, from Adam's first moment) and
    "change" (name -> the parameters' change after the steps). Returns
    loss_gap (the largest relative gap of a step's loss), grad_gap and
    change_gap (the worst leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's; leaves whose reference gradient is under a thousandth of
    the median leaf's are left out of the change) and nonfinite."""
    dev = next(iter(start.values())).device
    _check_device(dev)
    w, h = rcfg["width"], rcfg["height"]
    n = w * h
    cam = pt.camera_basis(spec.eye, spec.target, spec.fov_y_deg, w / h, dev)
    shapes = pt.draw_shapes(n, rcfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(target_seed)
    scene = pt.Scene(spec, dev)
    target = torch.zeros((n, 3), device=dev)
    with torch.no_grad():
        for f in range(target_frames):
            img = _image(scene, cam, rcfg, _frame_draws(gen, shapes, dev),
                         rays_per_block)
            target = (target * float(f) + img) / (f + 1.0)
    lr, (b1, b2), eps = opt["lr"], opt["betas"], opt["eps"]
    p = {k: v.detach().clone() for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad = [], None
    for i, s in enumerate(step_seeds):
        leaves = {k: x.clone().requires_grad_(True) for k, x in p.items()}
        gen = torch.Generator(device=dev)
        gen.manual_seed(s)
        draws = _frame_draws(gen, shapes, dev)
        losses.append(_image(pt.Scene(spec, dev, leaves), cam, rcfg, draws,
                             rays_per_block, (target, 1.0 / (3 * n))))
        grads = {k: x.grad for k, x in leaves.items()}
        if first_grad is None:
            first_grad = grads
        t = i + 1
        for k in p:
            m[k] = b1 * m[k] + (1.0 - b1) * grads[k]
            v2[k] = b2 * v2[k] + (1.0 - b2) * grads[k] * grads[k]
            denom = (v2[k].sqrt() / (1.0 - b2 ** t) ** 0.5) + eps
            p[k] = p[k] - (lr / (1.0 - b1 ** t)) * m[k] / denom
    change = {k: p[k] - start[k] for k in p}
    gnorm = {k: float(g.norm()) for k, g in first_grad.items()}
    med = statistics.median(gnorm.values())
    kept = [k for k in p if gnorm[k] >= 1e-3 * med]
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(program["losses"], losses)),
        "grad_gap": _worst_leaf(program["grad"], first_grad, list(p)),
        "change_gap": _worst_leaf(program["change"], change, kept),
        "nonfinite": float(
            sum(not np.isfinite(x) for x in program["losses"])
            + sum(int((~torch.isfinite(x)).sum())
                  for d in (program["grad"], program["change"])
                  for x in d.values())),
        "ref_losses": losses,
    }


def _worst_leaf(prog: Dict, ref: Dict, keys) -> float:
    norms = {k: float(ref[k].norm()) for k in ref}
    med = statistics.median(norms.values())
    return max(abs(float(prog[k].norm()) - norms[k]) / max(norms[k], med,
                                                           1e-30)
               for k in keys)
