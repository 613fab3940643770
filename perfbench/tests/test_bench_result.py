"""The result's format: the last line of a run, and the exit without a
card."""
import json
import subprocess
import sys

import pytest

from perfbench import spec
from perfbench.loops import Result

from conftest import ROOT


def _result(trace: bool):
    layers = {"units": 3, "wall_s": 1.2, "busy_s": 1.08, "launches": 30000,
              "ms": {"k1": 80.0, "accel": 50.0, "integrator": 230.0,
                     "forward": 360.0},
              "attributed": 1.0, "k1": {"bound_s": 0.015, "time_s": 0.026},
              "breakdown": {"device_ops": [["k", 0.5]],
                            "idle_gaps": [["aten::mul", 0.01]]}}
    return Result(e2e={"frame_ms": 390.0, "frame_ms_p90": 392.0,
                       "setup_s": 9.0},
                  attempted=115, failed=0, memory_peak_bytes=4 << 30,
                  numbers={"l1_rel": 0.003, "nonfinite": 0.0},
                  layers=layers if trace else None)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(run_mod, trace):
    c = spec.cell("interior.preview")
    res = _result(trace)
    checks = {k: {"value": res.numbers[k], "limit": v}
              for k, v in c["limits"].items()}
    line = run_mod.result_line(c, res, checks, True, trace,
                               {"platform": "gpu", "kind": "H100",
                                "count": 1})
    text = json.dumps(line)
    back = json.loads(text)
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(back)[-1] == "checks"
    assert set(back["checks"]) == set(c["limits"])
    dev = back["device"]
    assert dev["platform"] == "gpu" and dev["memory_peak_bytes"] == 4 << 30
    if trace:
        assert set(back["metrics"]) == {m["name"] for m in c["per_layer"]}
        assert dev["busy_s"] == 1.08 and dev["window_s"] == 1.2
        assert len(back["breakdown"]["device_ops"]) <= 10
        assert back["metrics"]["k1_roofline"]["value"] == pytest.approx(
            100 * 0.015 / 0.026)
    else:
        assert set(back["metrics"]) == {m["name"] for m in c["end_to_end"]}
        assert "breakdown" not in back
    for m in back["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "interior.preview", "--seed", "3000000000",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
