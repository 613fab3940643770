"""Tests of the benchmark harness (CPU, small; those marked `cuda` need
the card and skip without it): `python -m pytest perfbench/tests -q`."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell cut to a size the CPU runs in seconds (the kernels' plain
# twins): a smaller room, a few pixels
SMALL = {
    "interior.preview": {"render_config": {"width": 64, "height": 36},
                         "scene": {"n_boxes": 60, "n_lights": 8},
                         "check": {"pixels": 512}},
    "interior_inverse.fit": {"render_config": {"width": 48, "height": 27},
                             "scene": {"n_boxes": 60, "n_lights": 8}},
}


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def run_mod():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "perfbench_run", ROOT / "perfbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
