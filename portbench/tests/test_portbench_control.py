"""The control: the reference in the precision below the configuration's,
put in the program's place, fails the comparison at a size the CPU runs.
The benchmark's runs never run it; ``portbench/control.py`` reads it on
the chip at the cells' own sizes."""

import pytest

from portbench.trace import Spans

from .small import small_cell

SEED = 2**31 + 9


def _readings(name):
    cell = small_cell(name)
    gen = cell.gen
    st = gen.setup(cell.config, cell.mix, SEED, "cpu", Spans())
    gen.warmup(st)
    for _ in range(2):
        gen.step(st)
    gen.release(st)
    return cell, gen.program_numbers(st), gen.control(st)


@pytest.mark.parametrize("name", ["pairs.sift640", "track.slam640", "sweep.slam640",
                                  "exhaustive.sift640"])
def test_control_fails_where_the_program_passes(name):
    """On the numbers the control reads (for the SLAM cell, the detector's
    features; its trajectory's reference is the scene's truth)."""
    cell, program, control = _readings(name)
    limits = {n: v for n, v in cell.mix["limits"].items() if n in control}
    assert limits
    assert all(program[n] <= limits[n] for n in limits), program
    assert any(control[n] > limits[n] for n in limits), control
