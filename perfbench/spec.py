"""Finding a cell's pieces by name: `BENCHMARK.json` at the checkout's root
names the cell (`<config>.<mix>`), and the files are

- `perfbench/configs/<config>.json`: the configuration (its file in
  `BENCHMARK.json`'s `configs`);
- `perfbench/traffic/<mix>.json`: the traffic mix's parameters, whose
  `"loop"` names the generator (`perfbench/loops/<loop>.py`);
- `perfbench/limits/<cell>.json`: the limit of each number the
  correctness check compares;
- `perfbench/metrics/<metric>.py`: one reader per per-layer metric,
  `read(layers) -> float | None`.

Adding a configuration, a mix or a metric adds files and entries; nothing
here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[1]


def benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, root: Path = ROOT) -> Dict:
    """{"workload", "config", "traffic", "limits", "end_to_end",
    "per_layer"} of cell `name`: its entry, its files' contents, and the
    metric entries it reports."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    base = root / "perfbench"

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {
        "workload": w,
        "config": json.loads((root / cfg["file"]).read_text()),
        "traffic": json.loads((base / "traffic" / f"{w['traffic']}.json")
                              .read_text()),
        "limits": json.loads((base / "limits" / f"{name}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def reader(metric: str, root: Path = ROOT) -> Callable:
    """The `read` function of `perfbench/metrics/<metric>.py`."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def per_layer(entries: List[Dict], layers: Dict,
              root: Path = ROOT) -> Dict[str, Dict]:
    """Each per-layer metric its reader finds, with its unit; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in entries:
        v = reader(m["name"], root)(layers)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
