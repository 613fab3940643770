"""The port's ReSTIR DI frames against the benchmark's plain reference
(`perfbench/reference/restir.py`), on the CPU.

The frames go through the normal path: the benchmark's interior scene
handed to the port, `Renderer(accel="tiled", use_restir=True)` with the
`restir` configuration's render settings (depth 1, Disney, NEE) and
`RestirConfig()`, `render_frame` on a still camera from a state seeded
with `seed`. The reference computes the same frames whole from the same
seed, replaying the frame state's generator, and holds the program's
primary hits (its `depth` AOV) to their contract. Three frames, so that
the history exists and temporal and spatial reuse both run.

Tolerance: on the CPU both sides compute every product in float32 in the
same order (K1's plain twin, the exact closest hit at this size), so the
accumulated images agree bit for bit; TOL leaves room for a pick or two
that an ulp flips at a boundary (one pixel's sample is a 3,072th of the
64x48 image) and none for a pass done differently: each mutation below
reads 0.2-0.3.
"""
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import port, scenes  # noqa: E402
from perfbench.reference import restir as reference  # noqa: E402

from lumenrenderer_tpu_torch.render.renderer import Renderer  # noqa: E402
from lumenrenderer_tpu_torch.restir import di  # noqa: E402

CONFIG = json.loads((ROOT / "perfbench" / "configs" / "restir.json")
                    .read_text())
SCENE = {"n_boxes": 40, "n_lights": 16, "seed": 0}
FRAMES = 3
TOL = 1e-3
TILED = (64, 48, 2147483659)        # divides by bag_tile 16: tile candidates
PER_PIXEL = (40, 24, 2147483677)    # does not: per-pixel candidates


@functools.lru_cache(maxsize=None)
def _spec():
    return scenes.make("interior", SCENE)


def _rcfg(w, h):
    return dict(CONFIG["renderer"]["render_config"], width=w, height=h)


def _program(w, h, seed, restir_config=None, candidate_dtype="high"):
    spec = _spec()
    r = Renderer(port.build_scene(spec), port.render_config(_rcfg(w, h)),
                 accel="tiled", device="cpu",
                 candidate_dtype=candidate_dtype,
                 restir_config=restir_config)
    cam = port.camera(spec, w, h)
    st = r.init_state(seed)
    depths = []
    for _ in range(FRAMES):
        st, aux = r.render_frame(st, cam)
        depths.append(aux["depth"])
    return st, depths


def _check(w, h, seed, st, depths):
    """(l1_rel of the program's image against the reference's, the primary
    hits off the program's contract)."""
    ref, off = reference.accumulated(_spec(), _rcfg(w, h), CONFIG["restir"],
                                     seed, FRAMES, torch.device("cpu"), 1024,
                                     depths)
    assert float(ref.abs().sum()) > 0.0
    return float((st.accum - ref).abs().sum() / ref.abs().sum()), off


def test_configuration_states_the_default_restir_config():
    assert dataclasses.asdict(di.RestirConfig()) == CONFIG["restir"]


@pytest.mark.parametrize("w,h,seed", [TILED, PER_PIXEL])
def test_port_frames_match_the_reference(w, h, seed):
    st, depths = _program(w, h, seed)
    assert bool(st.restir.valid)
    # reuse ran: M grew past the RIS candidates
    assert float(st.restir.reservoir.m.max()) > CONFIG["restir"]["candidates"]
    l1, off = _check(w, h, seed, st, depths)
    assert l1 <= TOL and off == 0
    # the closest hits alone give the same frames here
    ref, _ = reference.accumulated(_spec(), _rcfg(w, h), CONFIG["restir"],
                                   seed, FRAMES, torch.device("cpu"), 1024)
    assert float((st.accum - ref).abs().sum() / ref.abs().sum()) <= TOL


@pytest.mark.parametrize("mutation", ["temporal_skipped",
                                      "one_spatial_iteration",
                                      "bf16_candidates"])
def test_the_comparison_catches_a_changed_pass(monkeypatch, mutation):
    w, h, seed = TILED
    kw = {}
    if mutation == "temporal_skipped":
        # the history is ignored, the combine's draw still made
        temporal = di.temporal_pass

        def no_history(scene, sd, res, state, *args, **kwargs):
            return temporal(scene, sd, res, state.replace(
                valid=torch.zeros_like(state.valid)), *args, **kwargs)

        monkeypatch.setattr(di, "temporal_pass", no_history)
    elif mutation == "one_spatial_iteration":
        kw["restir_config"] = di.RestirConfig(spatial_iterations=1)
    else:
        kw["candidate_dtype"] = "bfloat16"
    st, depths = _program(w, h, seed, **kw)
    l1, _ = _check(w, h, seed, st, depths)
    assert l1 > 10 * TOL


def test_the_contract_catches_a_wrong_primary_hit():
    w, h, seed = TILED
    st, depths = _program(w, h, seed)
    wrong = [d.clone() for d in depths]
    wrong[1][::7] *= 1.01           # no triangle lies at that distance
    wrong[2][5] = 0.0               # a miss where the closest hit is
    _, off = _check(w, h, seed, st, wrong)
    assert off == wrong[1][::7].numel() + 1


def test_reference_imports_neither_jax_nor_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import perfbench.reference.restir; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'lumenrenderer_tpu', "
            "'lumenrenderer_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"
    src = (ROOT / "perfbench" / "reference" / "restir.py").read_text()
    assert "allow_tf32 = False" in src
