"""The readings that the limits of `perfbench/limits/<cell>.json` are set
from: the numbers the correctness check compares, for sound runs of the
program on many seeds and for the control (the program with its bf16
candidate mode on, the nearest lower precision it has), in one process:

    python3 perfbench/calibrate.py --workload interior.preview \
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 45 \
        --out chiprun_out/calibrate.jsonl

Each run is the cell's own: its set-up, a window of `--seconds` at the
cell's load, its check. One JSON line per run, to standard output and to
`--out`.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CONTROL = "bfloat16"    # the program's own lower-precision candidate mode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None,
                    help="plant one of perfbench.faults.KINDS in every run")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from perfbench import faults, spec
    from perfbench import run as run_mod

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    plan = ([(int(s), None) for s in args.seeds.split(",") if s]
            + [(int(s), CONTROL)
               for s in args.control_seeds.split(",") if s])
    for seed, dtype in plan:
        t = time.perf_counter()
        loop = spec.cell(args.workload)["traffic"]["loop"]
        with (faults.planted(args.fault, loop) if args.fault
              else contextlib.nullcontext()):
            _, res, checks, correct = run_mod.execute(
                args.workload, seed, args.seconds, False, "cuda", t0=t,
                candidate_dtype=dtype)
        row = {"workload": args.workload, "seed": seed,
               "control": dtype, "fault": args.fault, "correct": correct,
               "numbers": {k: v["value"] for k, v in checks.items()},
               "e2e": res.e2e, "info": res.info,
               "seconds": time.perf_counter() - t}
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
