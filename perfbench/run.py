"""Run one benchmark cell once on the card:

    python3 perfbench/run.py --workload <config>.<mix> --seed <n> \
        --seconds <s> --trace <0|1>

The cell's configuration, traffic mix, limits and per-layer readers are
found by name (`perfbench/spec.py`). Set-up builds the scene from the
configuration, the program's Renderer and whatever the mix warms; the
window then runs for `--seconds`; the reference checks what the window
produced. With `--trace 0` the result reports the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics (a few frames or steps of
the window under the profiler). The last line of standard output is one
JSON object; the numbers the check compared, each with its limit, are the
last lines of standard error and the result's last key.

Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result; if JAX or the JAX package was loaded, it exits 3.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every kernel cache in the checkout, at a fixed path
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "lumenrenderer_tpu")


def forbidden_modules(names=None):
    """Loaded modules (or `names`) whose top-level name, whole, is JAX's or
    the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def execute(name: str, seed: int, seconds: float, trace: bool, device,
            t0: float = None, overrides=None, candidate_dtype=None,
            root: Path = ROOT):
    """Run cell `name` of the checkout at `root` on `device`: (cell, Result,
    checks, correct). `overrides` merges into the configuration's render
    config, the scene's parameters and the traffic (tests run the harness
    small on the CPU)."""
    import torch

    from perfbench import loops, scenes, spec

    c = spec.cell(name, root)
    config, traffic = c["config"], c["traffic"]
    for key, part in (overrides or {}).items():
        if key == "render_config":
            config["renderer"]["render_config"].update(part)
        elif key == "scene":
            config["scene"]["params"].update(part)
        else:
            traffic[key] = (dict(traffic[key], **part)
                            if isinstance(part, dict) else part)
    ctx = loops.Context(
        config=config, traffic=traffic, seed=int(seed),
        seconds=float(seconds), trace=bool(trace),
        device=torch.device(device), t0=T0 if t0 is None else t0,
        spec=scenes.make(config["scene"]["generator"],
                         config["scene"]["params"]),
        candidate_dtype=candidate_dtype)
    res = loops.load(traffic["loop"]).run(ctx)
    checks = {k: {"value": res.numbers[k], "limit": lim}
              for k, lim in c["limits"].items()}
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                  for v in checks.values())
    return c, res, checks, correct


def result_line(c, res, checks, correct, trace: bool, device_info) -> dict:
    from perfbench import spec

    if trace:
        metrics = spec.per_layer(c["per_layer"], res.layers)
    else:
        metrics = {m["name"]: {"value": float(res.e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in c["end_to_end"]}
    out = {"correct": bool(correct), "attempted": int(res.attempted),
           "failed": int(res.failed), "metrics": metrics,
           "device": dict(device_info,
                          memory_peak_bytes=int(res.memory_peak_bytes))}
    if trace:
        out["device"]["busy_s"] = res.layers["busy_s"]
        out["device"]["window_s"] = res.layers["wall_s"]
        out["breakdown"] = res.layers["breakdown"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import spec

    chips = spec.cell(args.workload)["workload"]["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"needs {chips} CUDA device(s); found {cards}", file=sys.stderr)
        return 2
    c, res, checks, correct = execute(args.workload, args.seed, args.seconds,
                                      bool(args.trace), "cuda")
    print(f"card: {card_line()}", flush=True)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    line = result_line(c, res, checks, correct, bool(args.trace), info)
    print(json.dumps({"info": res.info, "layers": res.layers}
                     if args.trace else {"info": res.info}), flush=True)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
