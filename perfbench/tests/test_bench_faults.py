"""The harness, with its look for a card skipped, on each cell at a small
size on the CPU: a sound run comes out correct, and a run with the timed
path broken underneath (each fault the cell can have) or with the
program's lower precision on (the control, bf16 candidates) does not."""
import time

import pytest

from perfbench import faults

from conftest import SMALL

CELLS = {"interior.preview": "progressive", "interior_inverse.fit": "fit"}


def _run(run_mod, cell, **kw):
    return run_mod.execute(cell, 2147483651, 0.5, False, "cpu",
                           t0=time.perf_counter(), overrides=SMALL[cell],
                           **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(run_mod, cell):
    _, res, checks, correct = _run(run_mod, cell)
    assert correct, checks
    assert res.attempted >= 1 and res.failed == 0


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(run_mod, cell, kind):
    with faults.planted(kind, CELLS[cell]):
        _, _, checks, correct = _run(run_mod, cell)
    assert not correct, checks


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught(run_mod, cell):
    _, _, checks, correct = _run(run_mod, cell, candidate_dtype="bfloat16")
    assert not correct, checks
