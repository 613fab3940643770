#!/usr/bin/env python3
"""Kernel K2's full-pass times in both modes, tree against tree, on one
NVIDIA GPU.

    python3 tools/torch_k2_bf16_ab.py TREE [TREE ...]

Each TREE is a checkout of this repository (for instance the parent commit
unpacked with `git archive` into a directory that .gitignore lists). The
script first captures K2's inputs for the passes of `chip_smoke.py` phases
6 and 17b with this checkout's code: the instanced scene's (121 units)
2560x1440 primary pass and its sorted bounce and shadow passes, into a
temporary file. Then, one process per TREE in the order given (name a tree
twice to alternate, as in A B B A), it builds K2 from that tree's sources
(printing ptxas's registers, stack frame and spills), holds the bf16 mode
against the tree's twin on 64 evenly spaced tiles of each pass (on a
tree's first run only: keys or bits torch.equal), and times K2 on every
tile of each pass in the bf16 mode (`precision="default"`) and in fp32:
CUDA events around 5 launches after one warm-up, as phase 17b does, each
mode with its table laid out once beforehand (the tree's fragment order,
or its bfloat16 slab order where the tree's kernel takes that). One line
per tree, pass, mode and precision, with the card's name and power limit
first.
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
CHECK_TILES = 64
REPS = 5


def _say(**fields) -> None:
    print(" ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def capture(path: str) -> None:
    """Save K2's inputs {pass: (args, kw)} of phase 17b's three passes."""
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as cs
    from lumenrenderer_tpu_torch.accel import stream, two_level
    from lumenrenderer_tpu_torch.render.renderer import KERNEL_VISIT_CAP

    dev = torch.device("cuda", 0)
    builder, camf = cs._instanced()
    sc = builder.build().to(dev)
    cl = stream.build_clusters(sc.tri_pos, cluster_size=128).to(dev)
    ics = two_level.build_instanced(
        *two_level.instance_tables(builder.instances)).to(dev)
    mv = min(ics.num_clusters, KERNEL_VISIT_CAP)
    passes = cs._secondary_passes(
        sc, cl, camf(cs.W / cs.H).to(dev), dev, cs.W, cs.H,
        lambda o, d, tn, tx: two_level.scan_inputs(ics, o, d, tn, tx, mv),
        primary=True)
    torch.save({k: (tuple(a.cpu() for a in q["args"]), q["kw"])
                for k, q in passes.items()}, path)


def _layouts(vs, vsi, args, kw):
    """{precision: layout} for the tree's K2: the fp32 slab order, and the
    bf16 fragment order where the tree's kernel takes it, else the
    bfloat16 slab order."""
    feats, k = args[2], kw["k"]
    bf16 = vs.mma_layout(feats, k)
    try:
        vsi.visit_scan_instanced(*args, **kw, closest=True, layout=bf16,
                                 precision="default")
    except ValueError:
        bf16 = vs.slab_layout(feats, k, bf16=True)
    return {"highest": vs.slab_layout(feats, k), "default": bf16}


def time_tree(tree: Path, path: str, label: str, check: bool) -> None:
    """Build K2 from `tree` and time it on the saved passes; with `check`,
    hold its bf16 mode against the tree's twin first."""
    sys.path.insert(0, str(tree))
    import torch

    from lumenrenderer_tpu_torch.ops import build
    from lumenrenderer_tpu_torch.ops import visit_scan as vs
    from lumenrenderer_tpu_torch.ops import visit_scan_instanced as vsi

    log = build.build_libraries(["visit_scan_instanced"], force=True)[
        "visit_scan_instanced"][1]
    for line in log.splitlines():
        if "registers" in line or "stack frame" in line:
            _say(tree=label, ptxas=repr(line.strip()))
    dev = torch.device("cuda", 0)
    passes = {k: (tuple(a.to(dev) for a in args), kw)
              for k, (args, kw) in torch.load(path).items()}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for name, (args, kw) in passes.items():
        layouts = _layouts(vs, vsi, args, kw)
        tiles = args[0].shape[0]
        idx = torch.linspace(0, tiles - 1, CHECK_TILES, device=dev).long()
        sub = tuple(a if i == 2 else a[idx].contiguous()
                    for i, a in enumerate(args))
        for mode, closest in (("closest", True), ("any", False)):
            for precision in ("default", "highest"):
                run_kw = dict(kw, closest=closest, precision=precision,
                              layout=layouts[precision])
                fields = {}
                if check and precision == "default":
                    kern = vsi.visit_scan_instanced(*sub, **run_kw)
                    twin = vsi.visit_scan_instanced_ref(
                        *sub, **dict(run_kw, layout=None))
                    torch.cuda.synchronize()
                    fields["subset_equal"] = bool(torch.equal(kern, twin))

                def run():
                    return vsi.visit_scan_instanced(*args, **run_kw)

                run()
                start.record()
                for _ in range(REPS):
                    run()
                end.record()
                torch.cuda.synchronize()
                _say(tree=label, rays=name, mode=mode,
                     precision="bf16" if precision == "default" else "fp32",
                     full_pass_ms=f"{start.elapsed_time(end) / REPS:.4f}",
                     **fields)


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
        print("torch_k2_bf16_ab: needs a CUDA device and at least one tree",
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
