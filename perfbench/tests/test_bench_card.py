"""On the card (marked `cuda`; skips without one): each cell at a reduced
frame size with its trace, every per-layer metric read, the profiler's
device time linked to the operations that launched it.

    python -m pytest perfbench/tests -q -m cuda
"""
import time

import pytest

from perfbench import spec

pytestmark = pytest.mark.cuda

SIZES = {"interior.preview": {"render_config": {"width": 640, "height": 360},
                              "check": {"pixels": 2048}},
         "interior_inverse.fit": {"render_config": {"width": 320,
                                                    "height": 180}}}


@pytest.mark.parametrize("cell", list(SIZES))
def test_traced_cell_on_the_card(run_mod, cuda, cell):
    c, res, checks, correct = run_mod.execute(
        cell, 2147483661, 2.0, True, cuda, t0=time.perf_counter(),
        overrides=SIZES[cell])
    assert correct, checks
    layers = res.layers
    assert layers["attributed"] > 0.99
    assert 0 < layers["busy_s"] <= layers["wall_s"]
    got = spec.per_layer(c["per_layer"], layers)
    assert set(got) == {m["name"] for m in c["per_layer"]}
    if cell == "interior.preview":
        assert 0 < got["k1_roofline"]["value"] < 100
