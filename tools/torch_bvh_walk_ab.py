#!/usr/bin/env python3
"""Kernel T's full-pass times, tree against tree, on one NVIDIA GPU.

    python3 tools/torch_bvh_walk_ab.py TREE [TREE ...]

Each TREE is a checkout of this repository (for instance the parent commit
unpacked with `git archive` into a directory that .gitignore lists). The
script first captures the passes of `chip_smoke.py` phase 16a with this
checkout's code: the interior scene's 2560x1440 primary pass and its sorted
bounce and shadow passes (3,686,400 rays each), into a temporary file. Then,
one process per TREE in the order given (name a tree twice to alternate,
as in A B B A), it builds kernel T from that tree's sources (printing
ptxas's registers, stack frame and spills), builds the interior's SAH BVH
(native builder) and LBVH with that tree's code, holds T against the
tree's twin on 65,536 evenly spaced rays of each pass (on a tree's first
run only: triangles or hit bits, t, u, v bits and the walk counters, as
the share of equal rays), and times T on every ray of each pass in both
modes: CUDA events around 5 launches after one warm-up, as phase 16a does.
One line per tree, BVH, pass and mode, with the card's name and power
limit first. PERF.md's design steps of kernel T were timed so, each step a
tree.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SUBSET = 65_536
REPS = 5


def _say(**fields) -> None:
    print(" ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def capture(path: str) -> None:
    """Save phase 16a's three passes {name: (o, d, t_min, t_max)}."""
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    sc, camf = cs._scene(dev)
    passes = cs._bvh_passes(dev, sc, camf(cs.W / cs.H).to(dev))
    torch.save({k: tuple(x.cpu() for x in v) for k, v in passes.items()},
               path)


def _equal_share(kern, twin, closest):
    import torch

    if not closest:
        return float((kern == twin).float().mean()), True
    same = kern[1] == twin[1]
    bits = all(torch.equal(a.view(torch.int32)[same],
                           b.view(torch.int32)[same])
               for a, b in zip((kern[0], kern[2], kern[3]),
                               (twin[0], twin[2], twin[3])))
    return float(same.float().mean()), bits


def time_tree(tree: Path, path: str, label: str, check: bool) -> None:
    """Build T from `tree` and time it on the saved passes; with `check`,
    hold it against the tree's twin first."""
    sys.path.insert(0, str(tree))
    import torch

    from lumenrenderer_tpu_torch.accel import lbvh, sah
    from lumenrenderer_tpu_torch.ops import build
    from lumenrenderer_tpu_torch.ops import bvh_traverse as bt
    from lumenrenderer_tpu_torch.scene import presets

    log = build.build_libraries(["bvh_traverse"], force=True)[
        "bvh_traverse"][1]
    for line in log.splitlines():
        if "registers" in line or "stack frame" in line:
            _say(tree=label, ptxas=repr(line.strip()))
    dev = torch.device("cuda", 0)
    sc = presets.interior_scene(n_boxes=600, n_lights=64)[0].build()
    bvhs = {"sah": sah.build_sah(sc.tri_pos).to(dev),
            "lbvh": lbvh.build_lbvh(sc.tri_pos.to(dev))}
    passes = {k: tuple(x.to(dev) for x in v)
              for k, v in torch.load(path).items()}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for accel, bvh in bvhs.items():
        for name, rays in passes.items():
            n = rays[0].shape[0]
            idx = torch.linspace(0, n - 1, SUBSET, device=dev).long()
            sub = tuple(x[idx].contiguous() for x in rays)
            for mode, closest in (("closest", True), ("any", False)):
                fields = {}
                if check:
                    fields = _check(bt, bvh, sub, closest)

                def run():
                    return bt.bvh_traverse(bvh, *rays, any_hit=not closest)

                run()
                start.record()
                for _ in range(REPS):
                    run()
                end.record()
                torch.cuda.synchronize()
                _say(tree=label, bvh=accel, rays=name, mode=mode,
                     full_pass_ms=f"{start.elapsed_time(end) / REPS:.4f}",
                     **fields)


def _check(bt, bvh, sub, closest):
    """T against the twin on `sub`: the share of equal rays (triangles or
    hit bits), whether t, u, v are equal bit for bit where the triangles
    are, and the share of equal walk counters."""
    import torch

    dev = sub[0].device
    ck = torch.zeros((sub[0].shape[0], 2), dtype=torch.int32, device=dev)
    ct = torch.zeros_like(ck)
    kern = bt.bvh_traverse(bvh, *sub, any_hit=not closest, counts=ck)
    twin = bt.bvh_traverse_ref(bvh, *sub, any_hit=not closest, counts=ct)
    torch.cuda.synchronize()
    bt.raise_on_error(dev)
    match, bits = _equal_share(kern, twin, closest)
    counters = float((ck == ct).all(1).float().mean())
    return {"match": f"{match:.6f}", "tuv_bits_equal": bits,
            "counters_equal": f"{counters:.6f}"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--capture", help=argparse.SUPPRESS)
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--passes", help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.capture:
        capture(args.capture)
        return 0
    if args.tree:
        time_tree(args.tree.resolve(), args.passes, args.label, args.check)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.trees:
        print("torch_bvh_walk_ab: needs a CUDA device and at least one tree",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _say(gpu=repr(smi), torch=torch.__version__)
    me = [sys.executable, str(Path(__file__).resolve())]
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "passes.pt")
        subprocess.run(me + ["--capture", path], check=True, cwd=REPO)
        trees = [t.resolve() for t in args.trees]
        for i, tree in enumerate(trees):
            t0 = time.perf_counter()
            first = tree not in trees[:i]
            rc = subprocess.run(me + ["--tree", str(tree), "--passes", path,
                                      "--label", f"{i}:{tree.name}"]
                                + ["--check"] * first, cwd=tree).returncode
            _say(tree=f"{i}:{tree.name}", rc=rc,
                 seconds=f"{time.perf_counter() - t0:.1f}")
            failed += rc != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
