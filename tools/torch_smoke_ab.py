"""Compare `chip_smoke.py` logs of two trees run in one call (A/B).

    python tools/torch_smoke_ab.py OLD.log NEW.log [MORE.log ...]

Prints, for the first log against each other one, whether every mean
field of phases 1-16 (each field whose name contains `mean`, in order of
appearance) is equal as printed, and lists the ones that differ; then, per
log, the phase-17 lines of the bf16 kernels (17a, 17b) with their full-pass
times and bounds, and 17c's frame.
"""
from __future__ import annotations

import re
import sys

LINE = re.compile(r"^\[(\d+)([a-z]?) ([^\]]*)\] (.*)$")
FIELD = re.compile(r"(\w+)=(\{[^}]*\}|\S+)")
SHOWN = ("kernel", "mode", "rays", "full_pass_ms", "full_pass_fp32_ms",
         "full_pass_bound_ms", "full_epilogue_bound_ms", "full_share",
         "full_epilogue_share", "paced_by", "visits_per_tile")


def parse(path):
    """[(phase number, tag, {field: value})] of a log's phase lines."""
    rows = []
    with open(path, encoding="utf-8", errors="replace") as fh:
        for line in fh:
            m = LINE.match(line.rstrip("\n"))
            if m:
                fields = dict(FIELD.findall(m.group(4)))
                rows.append((int(m.group(1)), f"{m.group(1)}{m.group(2)} "
                             f"{m.group(3)}", fields))
    return rows


def means(rows):
    """[(tag, field, value)] of phases 1-16's mean fields."""
    return [(tag, k, v) for phase, tag, fields in rows if 1 <= phase <= 16
            for k, v in fields.items() if "mean" in k]


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__)
        return 2
    logs = {path: parse(path) for path in argv}
    ref = means(logs[argv[0]])
    status = 0
    for path in argv[1:]:
        other = means(logs[path])
        differ = [(a, b) for a, b in zip(ref, other) if a != b]
        same = len(ref) == len(other) and not differ
        print(f"{path} vs {argv[0]}: {len(other)} / {len(ref)} mean fields, "
              f"{'all equal' if same else f'{len(differ)} differ'}")
        for a, b in differ:
            print(f"  {a} != {b}")
        status |= not same
    for path, rows in logs.items():
        print(path)
        for phase, tag, fields in rows:
            if tag.startswith(("17a", "17b bf16")) and "full_pass_ms" in fields:
                print("  " + tag + " " + " ".join(
                    f"{k}={fields[k]}" for k in SHOWN if k in fields))
            elif tag.startswith(("17c", "17 default")):
                print("  " + tag + " " + " ".join(
                    f"{k}={v}" for k, v in fields.items()))
    return status


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
