"""Cells, configurations, mixes, limits and per-layer readers are found
by name; a new configuration, mix and metric are added as files and
entries alone."""
import json
import shutil
import time

import pytest

from perfbench import loops, spec

from conftest import ROOT, SMALL


def test_every_cell_finds_its_pieces():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert c["config"]["name"] == w["config"]
        assert hasattr(loops.load(c["traffic"]["loop"]), "run")
        assert any(m["name"] == "setup_s" for m in c["end_to_end"])
        assert len(c["end_to_end"]) >= 2 and c["per_layer"]
        assert c["limits"]
    for m in bench["per_layer"]:
        read = spec.reader(m["name"])
        assert read(None) is None and read({}) is None


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("interior.nonesuch")


def _add_entries(root):
    """A new configuration, mix, limits and per-layer metric, as files
    and entries of a copy of the benchmark."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    base = root / "perfbench"
    cfg = json.loads((base / "configs" / "interior.json").read_text())
    cfg.update(name="interior_lambert")
    cfg["renderer"]["render_config"]["bsdf"] = "lambert"
    (base / "configs" / "interior_lambert.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "preview.json").read_text())
    mix.update(warm_frames=1, why="one warm frame")
    (base / "traffic" / "preview_cold.json").write_text(json.dumps(mix))
    (base / "limits" / "interior_lambert.preview_cold.json").write_text(
        (base / "limits" / "interior.preview.json").read_text())
    (base / "metrics" / "launches_total.py").write_text(
        "def read(layers):\n"
        "    return layers['launches'] if layers else None\n")
    bench["configs"].append(dict(bench["configs"][0], name="interior_lambert",
                                 file="perfbench/configs/"
                                      "interior_lambert.json"))
    bench["workloads"].append({"name": "interior_lambert.preview_cold",
                               "config": "interior_lambert",
                               "traffic": "preview_cold", "chips": 1,
                               "why": "Lambert frames"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "interior.preview" in m["workloads"]:
            m["workloads"].append("interior_lambert.preview_cold")
    bench["per_layer"].append({
        "name": "launches_total", "unit": "count", "better": "lower",
        "source": "device_trace", "layer": "device: one H100 SXM",
        "moves": "frame_ms", "workloads": ["interior_lambert.preview_cold"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_config_mix_and_metric_are_files_and_entries(tmp_path, run_mod):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _add_entries(tmp_path)
    name = "interior_lambert.preview_cold"
    c = spec.cell(name, tmp_path)
    assert c["config"]["renderer"]["render_config"]["bsdf"] == "lambert"
    assert c["traffic"]["warm_frames"] == 1
    assert [m["name"] for m in c["per_layer"]] == ["launches_total"]
    assert spec.per_layer(c["per_layer"], {"launches": 7}, tmp_path) == {
        "launches_total": {"value": 7.0, "unit": "count"}}
    # the new cell runs through the unchanged harness
    _, res, checks, correct = run_mod.execute(
        name, 11, 0.5, False, "cpu", t0=time.perf_counter(),
        overrides=SMALL["interior.preview"], root=tmp_path)
    assert correct, checks
    assert res.info["frames"] == 1 + res.attempted
